"""The X display's unix socket path (a copy of the reference's
``platform/xwait.py`` ``x_socket_path``)."""

from __future__ import annotations

__all__ = ["x_socket_path"]


def x_socket_path(display: str = ":0") -> str:
    """``:0`` -> ``/tmp/.X11-unix/X0`` (the socket entrypoint.sh:115 polls)."""
    num = display.split(":")[-1].split(".")[0] or "0"
    return f"/tmp/.X11-unix/X{num}"
