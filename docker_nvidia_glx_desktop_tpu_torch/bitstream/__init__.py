"""Bitstream construction: bit writer, H.264 syntax, CAVLC reference coder.

Host code copied from the reference package; the pure-Python coders are
the overflow fallback of the device entropy path and the tests' oracle.
"""

from .bitwriter import BitWriter  # noqa: F401
