"""Web-facing pieces of the port (input injection so far)."""
