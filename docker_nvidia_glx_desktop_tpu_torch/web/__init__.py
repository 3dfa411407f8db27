"""Web-facing pieces of the port: input injection, the fMP4 muxer, and
the single- and multi-session serving core (``session``,
``multisession``)."""
