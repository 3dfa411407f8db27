"""First-party RFB 3.8 server — the ``x11vnc`` role (entrypoint.sh:123).

Implements the protocol subset every mainstream viewer (noVNC, TigerVNC,
RealVNC) negotiates:

- protocol 3.8 handshake, security None / VNC Authentication (DES challenge,
  ``rfb/des.py``), with x11vnc's ``-passwd``/``-viewpasswd`` semantics
  (full-control vs view-only password, entrypoint.sh:122);
- ServerInit with true-color RGB888; SetPixelFormat honored for 32/16 bpp
  true-color formats;
- FramebufferUpdate with **Raw** and **Tight-JPEG** rectangles.  Tight JPEG
  frames come from the MJPEG encoder on the card (``models/mjpeg.py``:
  the transform, histogram and pack kernels of ``csrc/jpeg.cu``); cv2's
  host JPEG runs only when the caller passes ``use_tpu_jpeg=False``.  A
  failure of the card's encoder is logged and counted, closes the client
  and propagates (:class:`JpegEncodeError`): no quiet fallback;
- KeyEvent / PointerEvent forwarded to an injectable input callback
  (``web/input.py`` backends); ClientCutText accepted.

Demand-driven updates per RFC 6143 §7.5.3: one FramebufferUpdate per
FramebufferUpdateRequest, throttled to ``max_fps``.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Callable, Optional

import numpy as np

from ..obs import metrics as obsm
from . import des
from .source import FrameSource, SyntheticSource

log = logging.getLogger(__name__)

__all__ = ["RfbServer", "PixelFormat", "JpegEncodeError"]

_M_UPDATES = obsm.counter(
    "dngd_rfb_updates_total",
    "FramebufferUpdate messages sent", ("encoding",))
_M_UPDATE_BYTES = obsm.counter(
    "dngd_rfb_update_bytes_total",
    "FramebufferUpdate bytes sent (all encodings)")
_M_UPDATES_TIGHT = _M_UPDATES.labels("tight")
_M_UPDATES_RAW = _M_UPDATES.labels("raw")
_M_CLIENTS = obsm.gauge("dngd_rfb_clients", "Connected RFB clients")
_M_JPEG_MS = obsm.histogram(
    "dngd_rfb_jpeg_encode_ms",
    "Tight-JPEG rect encode time (the card's MJPEG encoder, or cv2 when "
    "asked for)")
_M_JPEG = obsm.counter(
    "dngd_rfb_jpeg_total", "Tight-JPEG rects encoded, by route", ("route",))
_M_JPEG_DEVICE = _M_JPEG.labels("device")
_M_JPEG_CV2 = _M_JPEG.labels("cv2")
_M_JPEG_ERRORS = obsm.counter(
    "dngd_rfb_jpeg_errors_total",
    "Tight-JPEG encodes on the card that raised (each closes its client)")

class JpegEncodeError(RuntimeError):
    """The card's JPEG encoder failed on a Tight rect."""


ENC_RAW = 0
ENC_TIGHT = 7
ENC_DESKTOP_SIZE = -223


class PixelFormat:
    """Client pixel format (RFC 6143 §7.4)."""

    def __init__(self, bpp=32, depth=24, big_endian=0, true_color=1,
                 rmax=255, gmax=255, bmax=255, rshift=16, gshift=8, bshift=0):
        self.bpp, self.depth = bpp, depth
        self.big_endian, self.true_color = big_endian, true_color
        self.rmax, self.gmax, self.bmax = rmax, gmax, bmax
        self.rshift, self.gshift, self.bshift = rshift, gshift, bshift

    def pack(self) -> bytes:
        return struct.pack(">BBBBHHHBBB3x", self.bpp, self.depth,
                           self.big_endian, self.true_color,
                           self.rmax, self.gmax, self.bmax,
                           self.rshift, self.gshift, self.bshift)

    @classmethod
    def unpack(cls, raw: bytes) -> "PixelFormat":
        f = struct.unpack(">BBBBHHHBBB3x", raw)
        return cls(*f)

    def encode_rgb(self, rgb: np.ndarray) -> bytes:
        """(H, W, 3) uint8 -> raw bytes in this pixel format."""
        r = rgb[..., 0].astype(np.uint32)
        g = rgb[..., 1].astype(np.uint32)
        b = rgb[..., 2].astype(np.uint32)
        if self.true_color:
            r = (r * self.rmax // 255) << self.rshift
            g = (g * self.gmax // 255) << self.gshift
            b = (b * self.bmax // 255) << self.bshift
        px = r | g | b
        order = ">" if self.big_endian else "<"
        if self.bpp == 32:
            return px.astype(f"{order}u4").tobytes()
        if self.bpp == 16:
            return px.astype(f"{order}u2").tobytes()
        if self.bpp == 8:
            return px.astype(np.uint8).tobytes()
        raise ValueError(f"unsupported bpp {self.bpp}")


def _tight_compact_len(n: int) -> bytes:
    """Tight encoding's 1-3 byte compact length."""
    out = bytearray([n & 0x7F])
    n >>= 7
    if n:
        out[0] |= 0x80
        out.append(n & 0x7F)
        n >>= 7
        if n:
            out[1] |= 0x80
            out.append(n & 0xFF)
    return bytes(out)


class _Client:
    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer
        self.pixfmt = PixelFormat()
        self.encodings: list = []
        self.view_only = False
        self.pending_request: Optional[tuple] = None
        self.last_seq = -1

    @property
    def wants_tight(self) -> bool:
        return ENC_TIGHT in self.encodings and self.pixfmt.bpp in (16, 32)


class RfbServer:
    """Serve a :class:`FrameSource` over RFB."""

    def __init__(self, source: Optional[FrameSource] = None,
                 password: str = "", viewpass: str = "",
                 name: str = "tpu-desktop", max_fps: float = 30.0,
                 jpeg_quality: int = 75, use_tpu_jpeg: bool = True,
                 on_input: Optional[Callable[[dict], None]] = None,
                 device=None):
        """``use_tpu_jpeg``: Tight rects from the card's MJPEG encoder
        (default) or, when False, from cv2 on the host.  ``device``: the
        encoder's device, the card by default (``"cpu"`` runs its plain
        versions)."""
        self.source = source or SyntheticSource()
        self.password = password
        self.viewpass = viewpass
        self.name = name
        self.max_fps = max_fps
        self.jpeg_quality = jpeg_quality
        self.use_tpu_jpeg = use_tpu_jpeg
        self.on_input = on_input
        self.device = device
        self._jpeg_enc = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.clients: list = []

    # -- lifecycle -----------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 5900):
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    # -- handshake -----------------------------------------------------

    async def _handle(self, reader, writer):
        c = _Client(reader, writer)
        try:
            await self._handshake(c)
            self.clients.append(c)
            _M_CLIENTS.set(len(self.clients))
            await self._message_loop(c)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except JpegEncodeError:
            raise                       # the client closes below
        except Exception:
            log.exception("rfb client error")
        finally:
            if c in self.clients:
                self.clients.remove(c)
            _M_CLIENTS.set(len(self.clients))
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _handshake(self, c: _Client):
        c.writer.write(b"RFB 003.008\n")
        await c.writer.drain()
        ver = await c.reader.readexactly(12)
        if not ver.startswith(b"RFB "):
            raise ConnectionError("bad version string")

        if self.password:
            c.writer.write(bytes([1, 2]))          # one type: VNC auth
            await c.writer.drain()
            if (await c.reader.readexactly(1))[0] != 2:
                raise ConnectionError("client refused VNC auth")
            challenge = des.new_challenge()
            c.writer.write(challenge)
            await c.writer.drain()
            response = await c.reader.readexactly(16)
            if des.vnc_check_response(self.password, challenge, response):
                c.view_only = False
            elif self.viewpass and des.vnc_check_response(
                    self.viewpass, challenge, response):
                c.view_only = True                 # x11vnc -viewpasswd
            else:
                c.writer.write(struct.pack(">I", 1))
                reason = b"authentication failed"
                c.writer.write(struct.pack(">I", len(reason)) + reason)
                await c.writer.drain()
                raise ConnectionError("auth failed")
        else:
            c.writer.write(bytes([1, 1]))          # one type: None
            await c.writer.drain()
            if (await c.reader.readexactly(1))[0] != 1:
                raise ConnectionError("client refused security none")
        c.writer.write(struct.pack(">I", 0))       # SecurityResult OK
        await c.writer.drain()

        await c.reader.readexactly(1)              # ClientInit (shared flag)
        name = self.name.encode()
        c.writer.write(struct.pack(">HH", self.source.width,
                                   self.source.height)
                       + c.pixfmt.pack()
                       + struct.pack(">I", len(name)) + name)
        await c.writer.drain()

    # -- message loop --------------------------------------------------

    async def _message_loop(self, c: _Client):
        interval = 1.0 / self.max_fps
        while True:
            try:
                hdr = await asyncio.wait_for(c.reader.readexactly(1), interval)
            except asyncio.TimeoutError:
                await self._maybe_update(c)
                continue
            mtype = hdr[0]
            if mtype == 0:                          # SetPixelFormat
                raw = await c.reader.readexactly(19)
                fmt = PixelFormat.unpack(raw[3:])
                if not fmt.true_color:
                    # Palette (colour-map) formats would be silently
                    # mis-encoded through the true-color path; refuse
                    # explicitly rather than corrupt the display.
                    log.warning("client requested palette pixel format; "
                                "only true-color is served — disconnecting")
                    raise ConnectionError("non-true-color pixel format")
                c.pixfmt = fmt
            elif mtype == 2:                        # SetEncodings
                (n,) = struct.unpack(">xH", await c.reader.readexactly(3))
                raw = await c.reader.readexactly(4 * n)
                c.encodings = list(struct.unpack(f">{n}i", raw))
            elif mtype == 3:                        # FramebufferUpdateRequest
                inc, x, y, w, h = struct.unpack(
                    ">BHHHH", await c.reader.readexactly(9))
                c.pending_request = (inc, x, y, w, h)
                if not inc:
                    c.last_seq = -1                 # force a full send
                await self._maybe_update(c)
            elif mtype == 4:                        # KeyEvent
                down, _, key = struct.unpack(
                    ">BHI", await c.reader.readexactly(7))
                self._input(c, {"type": "key", "down": bool(down),
                                "keysym": key})
            elif mtype == 5:                        # PointerEvent
                mask, x, y = struct.unpack(
                    ">BHH", await c.reader.readexactly(5))
                self._input(c, {"type": "pointer", "buttons": mask,
                                "x": x, "y": y})
            elif mtype == 6:                        # ClientCutText
                (ln,) = struct.unpack(">3xI", await c.reader.readexactly(7))
                text = await c.reader.readexactly(ln)
                self._input(c, {"type": "cuttext",
                                "text": text.decode("latin-1")})
            else:
                raise ConnectionError(f"unknown client message {mtype}")

    def _input(self, c: _Client, event: dict) -> None:
        if c.view_only or self.on_input is None:
            return
        try:
            self.on_input(event)
        except Exception:
            log.exception("input callback failed")

    # -- framebuffer updates -------------------------------------------

    async def _maybe_update(self, c: _Client):
        if c.pending_request is None:
            return
        rgb, seq = self.source.frame()
        if seq == c.last_seq:
            return
        c.last_seq = seq
        _, x, y, w, h = c.pending_request
        c.pending_request = None
        await self._send_update(c, rgb, (x, y, w, h))

    async def _send_update(self, c: _Client, rgb: np.ndarray,
                           req: Optional[tuple] = None):
        fh, fw = rgb.shape[:2]
        x0, y0, rw, rh = req if req is not None else (0, 0, fw, fh)
        x0, y0 = min(x0, fw), min(y0, fh)
        rw, rh = min(rw, fw - x0), min(rh, fh - y0)
        if rw <= 0 or rh <= 0:                      # degenerate request
            x0, y0, rw, rh = 0, 0, fw, fh
        full = (x0, y0, rw, rh) == (0, 0, fw, fh)
        # Tight-JPEG stays full-frame (the JPEG encoder is built per
        # geometry, and noVNC always asks full-frame); a partial
        # request is honored with a Raw rect clamped to the asked area
        # (RFC 6143 §7.5.3).
        data = self._jpeg(rgb) if (full and c.wants_tight) else None
        if data is not None:
            rect = struct.pack(">HHHHi", 0, 0, fw, fh, ENC_TIGHT)
            payload = bytes([0x90]) + _tight_compact_len(len(data)) + data
            msg = struct.pack(">BxH", 0, 1) + rect + payload
            _M_UPDATES_TIGHT.inc()
        else:
            sub = rgb[y0:y0 + rh, x0:x0 + rw]
            rect = struct.pack(">HHHHi", x0, y0, rw, rh, ENC_RAW)
            msg = (struct.pack(">BxH", 0, 1) + rect
                   + c.pixfmt.encode_rgb(sub))
            _M_UPDATES_RAW.inc()
        _M_UPDATE_BYTES.inc(len(msg))
        c.writer.write(msg)
        await c.writer.drain()

    def _jpeg(self, rgb: np.ndarray) -> Optional[bytes]:
        """JPEG bytes for a Tight rect: the card's MJPEG encoder, or cv2
        when ``use_tpu_jpeg`` is False."""
        t0 = time.perf_counter()
        try:
            return self._jpeg_inner(rgb)
        finally:
            _M_JPEG_MS.observe((time.perf_counter() - t0) * 1e3)

    def _jpeg_inner(self, rgb: np.ndarray) -> Optional[bytes]:
        h, w = rgb.shape[:2]
        if not self.use_tpu_jpeg:
            import cv2
            ok, buf = cv2.imencode(
                ".jpg", rgb[:, :, ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality])
            if not ok:
                return None
            _M_JPEG_CV2.inc()
            return buf.tobytes()
        try:
            if (self._jpeg_enc is None or self._jpeg_enc.width != w
                    or self._jpeg_enc.height != h):
                from ..models.mjpeg import JpegEncoder
                self._jpeg_enc = JpegEncoder(w, h, quality=self.jpeg_quality,
                                             device=self.device)
            data = self._jpeg_enc.encode(rgb).data
        except Exception as e:
            _M_JPEG_ERRORS.inc()
            log.exception("JPEG encode on the card failed; closing the client")
            raise JpegEncodeError(str(e)) from e
        _M_JPEG_DEVICE.inc()
        return data
