"""The port's RFB server: handshake, VNC authentication (DES) and the view
password, Tight-JPEG rects equal to the port encoder's JPEGs, partial
requests served raw, cv2 only when asked for, and a failing encoder that
closes its client instead of falling back."""

import asyncio
import struct

import cv2
import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.rfb import des as j_des
from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import JpegEncoder
from docker_nvidia_glx_desktop_tpu_torch.obs import metrics as obsm
from docker_nvidia_glx_desktop_tpu_torch.rfb import des
from docker_nvidia_glx_desktop_tpu_torch.rfb.server import RfbServer
from docker_nvidia_glx_desktop_tpu_torch.rfb.source import (NumpySource,
                                                           SyntheticSource)

import conftest


def run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, 60))


def counter(name, *labels):
    for s in obsm.REGISTRY.snapshot().get(name, {}).get("series", []):
        if tuple(s["labels"].values()) == labels:
            return s["value"]
    return 0.0


async def connect(port, password=None, encodings=(7, 0)):
    """RFB 3.8 client: handshake, ClientInit, SetEncodings."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    assert (await reader.readexactly(12)).startswith(b"RFB 003.008")
    writer.write(b"RFB 003.008\n")
    types = await reader.readexactly((await reader.readexactly(1))[0])
    if password is None:
        assert types == b"\x01"
        writer.write(b"\x01")
    else:
        assert types == b"\x02"
        writer.write(b"\x02")
        challenge = await reader.readexactly(16)
        writer.write(des.vnc_encrypt_challenge(password, challenge))
    await writer.drain()
    (result,) = struct.unpack(">I", await reader.readexactly(4))
    if result:
        raise ConnectionError("auth failed")
    writer.write(b"\x01")
    w, h = struct.unpack(">HH", await reader.readexactly(4))
    await reader.readexactly(16)
    await reader.readexactly(struct.unpack(">I", await reader.readexactly(4))[0])
    writer.write(struct.pack(">BxH", 2, len(encodings))
                 + struct.pack(f">{len(encodings)}i", *encodings))
    await writer.drain()
    return reader, writer, w, h


async def update(reader, writer, rect, incremental=0):
    """One FramebufferUpdateRequest -> (encoding, (x, y, w, h), payload)."""
    writer.write(struct.pack(">BBHHHH", 3, incremental, *rect))
    await writer.drain()
    assert (await reader.readexactly(1))[0] == 0
    assert struct.unpack(">xH", await reader.readexactly(3))[0] == 1
    x, y, w, h, enc = struct.unpack(">HHHHi", await reader.readexactly(12))
    if enc == 7:
        assert (await reader.readexactly(1))[0] == 0x90
        n, shift = 0, 0
        for _ in range(3):
            b = (await reader.readexactly(1))[0]
            n |= (b & (0xFF if shift == 14 else 0x7F)) << shift
            shift += 7
            if not b & 0x80 or shift == 21:
                break
        return enc, (x, y, w, h), await reader.readexactly(n)
    return enc, (x, y, w, h), await reader.readexactly(w * h * 4)


def test_des_matches_the_reference_and_fips():
    key = bytes.fromhex("133457799BBCDFF1")
    ct = des._des_block(bytes.fromhex("0123456789ABCDEF"),
                        des._key_schedule(key))
    assert ct.hex().upper() == "85E813540F0AB405"
    ch = bytes(range(16))
    for pw in ("", "a", "sekrit", "longpassword"):
        assert des.vnc_encrypt_challenge(pw, ch) == \
            j_des.vnc_encrypt_challenge(pw, ch)


def test_vnc_auth_and_the_view_password():
    events = []
    server = RfbServer(source=NumpySource(16, 16), password="full",
                       viewpass="look", on_input=events.append, device="cpu")

    async def go():
        await server.start(port=0)
        try:
            r, w, *_ = await connect(server.port, password="look")
            w.write(struct.pack(">BBHH", 5, 1, 3, 4))       # dropped
            r2, w2, *_ = await connect(server.port, password="full")
            w2.write(struct.pack(">BBHH", 5, 1, 5, 6))
            await asyncio.gather(w.drain(), w2.drain())
            with pytest.raises((ConnectionError, asyncio.IncompleteReadError)):
                await connect(server.port, password="wrong")
            await asyncio.sleep(0.3)
            w.close()
            w2.close()
        finally:
            await server.close()

    run(go())
    assert events == [{"type": "pointer", "buttons": 1, "x": 5, "y": 6}]


def test_tight_rects_are_the_port_encoders_jpegs():
    """Full requests with Tight on: each rect is the JPEG a second encoder
    (quality 75, sticky tables) gives the same frames in the same order;
    a partial request is served raw, clamped to the asked area."""
    h, w = 50, 70
    frames = [np.roll(conftest.make_test_frame(h, w, seed=2), 5 * i, axis=1)
              for i in range(3)]
    src = NumpySource(w, h)
    server = RfbServer(source=src, device="cpu")
    before = counter("dngd_rfb_jpeg_total", "device")

    async def go():
        await server.start(port=0)
        try:
            r, wr, fw, fh = await connect(server.port)
            assert (fw, fh) == (w, h)
            got = []
            for i, f in enumerate(frames):
                src.push(f)
                got.append(await update(r, wr, (0, 0, w, h), i > 0))
            src.push(frames[0])
            partial = await update(r, wr, (8, 4, 30, 20))
            wr.close()
            return got, partial
        finally:
            await server.close()

    got, partial = run(go())
    twin = JpegEncoder(w, h, quality=75, device="cpu")
    for (enc, rect, data), f in zip(got, frames):
        assert (enc, rect) == (7, (0, 0, w, h))
        assert data == twin.encode(f).data
        dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert dec.shape == (h, w, 3)
    assert server._jpeg_enc.frame_index == len(frames)
    assert counter("dngd_rfb_jpeg_total", "device") - before == len(frames)
    enc, rect, raw = partial
    assert (enc, rect) == (0, (8, 4, 30, 20))
    px = np.frombuffer(raw, "<u4").reshape(20, 30)
    rgb = np.stack([(px >> 16) & 255, (px >> 8) & 255, px & 255], -1)
    np.testing.assert_array_equal(rgb, frames[0][4:24, 8:38])


def test_cv2_only_when_asked_for():
    src = SyntheticSource(64, 48)
    server = RfbServer(source=src, use_tpu_jpeg=False, device="cpu")
    before = (counter("dngd_rfb_jpeg_total", "cv2"),
              counter("dngd_rfb_jpeg_total", "device"))

    async def go():
        await server.start(port=0)
        try:
            r, wr, fw, fh = await connect(server.port)
            out = await update(r, wr, (0, 0, fw, fh))
            wr.close()
            return out
        finally:
            await server.close()

    enc, _, data = run(go())
    assert enc == 7 and server._jpeg_enc is None
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR).shape == (48, 64, 3)
    assert counter("dngd_rfb_jpeg_total", "cv2") == before[0] + 1
    assert counter("dngd_rfb_jpeg_total", "device") == before[1]


def test_a_failing_encoder_closes_the_client_without_fallback(monkeypatch):
    def boom(self, rgb):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(JpegEncoder, "encode", boom)
    src = NumpySource(32, 32)
    src.push(np.full((32, 32, 3), 99, np.uint8))
    server = RfbServer(source=src, device="cpu")
    errors = counter("dngd_rfb_jpeg_errors_total")
    cv2_before = counter("dngd_rfb_jpeg_total", "cv2")
    seen = []

    async def go():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, ctx: seen.append(ctx.get("exception")))
        await server.start(port=0)
        try:
            r, wr, fw, fh = await connect(server.port)
            wr.write(struct.pack(">BBHHHH", 3, 0, 0, 0, fw, fh))
            await wr.drain()
            assert await r.read() == b""                # closed, no rect
            await asyncio.sleep(0.1)
        finally:
            await server.close()

    run(go())
    assert counter("dngd_rfb_jpeg_errors_total") == errors + 1
    assert counter("dngd_rfb_jpeg_total", "cv2") == cv2_before
    assert server.use_tpu_jpeg and not server.clients
    assert any("kernel launch failed" in str(e) for e in seen)
