"""Multi-session batches on one card: the MJPEG session batch and the
H.264 session steps (rows 15b-15d)."""

from .batch import assemble_session_jpeg, batch_encode_step  # noqa: F401
