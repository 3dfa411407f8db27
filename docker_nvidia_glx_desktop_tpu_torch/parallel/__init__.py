"""Multi-session batches on one card (the MJPEG session batch so far)."""

from .batch import assemble_session_jpeg, batch_encode_step  # noqa: F401
