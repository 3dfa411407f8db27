"""First-party RFB (VNC) stack: the ``x11vnc`` + ``websockify`` fallback
path (the upstream image's entrypoint.sh:120-125, ``NOVNC_ENABLE=true``),
serving Tight-JPEG rects from the port's MJPEG encoder on the card."""

from .source import FrameSource, SyntheticSource, NumpySource  # noqa: F401
