"""Frame sources: where pixels come from.

The reference scrapes the X display (x11vnc -snapfb over XSHM,
entrypoint.sh:123; GStreamer ximagesrc for WebRTC, SURVEY.md §3.2).  Here the
capture surface is an abstraction so every consumer (RFB server, MSE/WebRTC
streamer, batch encoder) is testable without an X server:

- :class:`SyntheticSource` — deterministic moving desktop-like test pattern.
- :class:`NumpySource`    — push frames from code (session manager, tests).
- :class:`XShmSource`     — real X display capture via a small C shim
  (``native/xcapture.cpp``, XGetImage/XShmGetImage), built with ``g++``
  at first use into the package's ``build/``, where the X11 headers and
  libraries exist (the container image).

All sources yield ``(H, W, 3) uint8`` RGB plus a monotonically increasing
damage sequence number so pull-based consumers can skip unchanged frames.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["FrameSource", "SyntheticSource", "NumpySource", "make_source"]


class FrameSource:
    """Interface: latest-frame semantics (lossy, like a framebuffer)."""

    width: int
    height: int

    def frame(self) -> Tuple[np.ndarray, int]:
        """Return (rgb, seq). seq increments whenever content changed."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyntheticSource(FrameSource):
    """Deterministic desktop-ish pattern with motion: gradient background,
    a 'window' rectangle and a scrolling 'text' band (matches the bench
    frame mix so measured numbers line up)."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 60.0):
        self.width, self.height = width, height
        self._fps = fps
        self._t0 = time.monotonic()
        yy, xx = np.mgrid[0:height, 0:width]
        self._base = np.stack(
            [(xx * 255 // max(width - 1, 1)).astype(np.uint8),
             (yy * 255 // max(height - 1, 1)).astype(np.uint8),
             ((xx + yy) * 255 // max(height + width - 2, 1)).astype(np.uint8)],
            axis=-1)
        rng = np.random.default_rng(0)
        self._band = (rng.integers(0, 2, size=(max(height // 8, 1), width, 3))
                      * 200).astype(np.uint8)

    def frame(self) -> Tuple[np.ndarray, int]:
        seq = int((time.monotonic() - self._t0) * self._fps)
        f = self._base.copy()
        h, w = self.height, self.width
        # moving window
        x0 = (seq * 4) % max(w // 2, 1)
        f[h // 4:h // 2, x0:min(x0 + w // 4, w)] = (240, 240, 235)
        # scrolling text band
        band = np.roll(self._band, seq * 2, axis=1)
        f[h // 2:h // 2 + band.shape[0]] = band
        return f, seq

    def resize(self, width: int, height: int) -> None:
        """Dynamic-resolution support (WEBRTC_ENABLE_RESIZE)."""
        self.__init__(width, height, fps=self._fps)


class NumpySource(FrameSource):
    """Thread-safe push source: ``push(frame)`` makes it the current frame."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self._lock = threading.Lock()
        self._frame = np.zeros((height, width, 3), np.uint8)
        self._seq = 0

    def push(self, rgb: np.ndarray) -> None:
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {rgb.shape} != "
                             f"({self.height}, {self.width}, 3)")
        with self._lock:
            self._frame = np.ascontiguousarray(rgb, dtype=np.uint8)
            self._seq += 1

    def frame(self) -> Tuple[np.ndarray, int]:
        with self._lock:
            return self._frame, self._seq


class XShmSource(FrameSource):
    """X display capture through the native shim (container runtime only)."""

    def __init__(self, display: str = ":0"):
        from ..native import lib as native_lib
        self._display = display
        self._cap = native_lib.open_xcapture(display)
        if self._cap is None:
            raise RuntimeError(
                f"cannot open X display {display!r} (no X server or the "
                "xcapture shim is unavailable on this host)")
        self.width, self.height = self._cap.size()
        self._seq = 0
        self._copy: Optional[np.ndarray] = None
        self._grab_t = 0.0

    # Minimum wall time between real grabs: bounds the damage-compare
    # cost no matter how fast pollers (encode loop + N RFB clients) spin.
    MIN_GRAB_INTERVAL_S = 0.008

    def frame(self) -> Tuple[np.ndarray, int]:
        # The shim returns its one shared XShm buffer, overwritten by the
        # next grab while up to PIPELINE_DEPTH frames may still be in
        # flight in the encoder — so changed frames are copied out, and
        # the damage seq only advances when content actually changed
        # (exact compare, ~2-3 ms at 1080p): an idle desktop is not
        # re-encoded at full rate.
        now = time.monotonic()
        if (self._copy is not None
                and now - self._grab_t < self.MIN_GRAB_INTERVAL_S):
            return self._copy, self._seq
        self._grab_t = now
        raw = self._cap.grab()
        if self._copy is None or not np.array_equal(raw, self._copy):
            self._seq += 1
            self._copy = raw.copy()
        return self._copy, self._seq

    def resize(self, width: int, height: int) -> None:
        """Resize the X display via xrandr (reference WEBRTC_ENABLE_RESIZE
        backend, Dockerfile:211/419-431) and re-open the capture."""
        import shutil
        import subprocess

        if shutil.which("xrandr") is None:
            raise RuntimeError("xrandr not installed")
        subprocess.run(["xrandr", "--fb", f"{width}x{height}"],
                       env={"DISPLAY": self._display}, timeout=10,
                       check=True, capture_output=True)
        self._cap.close()
        from ..native import lib as native_lib
        self._cap = native_lib.open_xcapture(self._display)
        if self._cap is None:
            raise RuntimeError("re-opening X capture after resize failed")
        self.width, self.height = self._cap.size()

    def close(self) -> None:
        self._cap.close()


def make_source(display: Optional[str], width: int, height: int) -> FrameSource:
    """Real X capture when a display exists, synthetic otherwise."""
    if display:
        import os

        from ..platform.xwait import x_socket_path
        if os.path.exists(x_socket_path(display)):
            try:
                return XShmSource(display)
            except Exception:
                pass
    return SyntheticSource(width, height)
