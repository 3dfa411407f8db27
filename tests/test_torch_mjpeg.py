"""The port's MJPEG encoder against the reference's: ``make_encoder`` with
``tpumjpegenc``, device and Python entropy, sticky / per-frame tables and
their refresh, headers and bytes equal on the reference's levels, decoded
quality against the reference's JPEG (PIL and cv2), a state exported by
the reference imported mid-stream, and the card by default."""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from docker_nvidia_glx_desktop_tpu.models.mjpeg import JpegEncoder as JEnc
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import JpegEncoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

import conftest

PSNR_TOL_DB = 0.05


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def stream(h, w, n, seed=0):
    """A desktop-like frame whose window moves and whose band scrolls."""
    base = conftest.make_test_frame(h, w, seed=seed)
    out = []
    for i in range(n):
        f = np.roll(base, 3 * i, axis=1).copy()
        f[h // 4:h // 4 + 12, 4 * i:4 * i + 20] = (240, 240, 235)
        out.append(f)
    return out


def levels_of(jenc, rgb):
    """The reference's levels of one frame, as port tensors (S = 1)."""
    return [torch.from_numpy(np.array(a))[None]
            for a in jenc.transform(rgb)]


def test_make_encoder_gives_the_ports_jpeg_encoder():
    cfg = from_env({"SIZEW": "64", "SIZEH": "48",
                    "WEBRTC_ENCODER": "tpumjpegenc"})
    enc, codec = make_encoder(cfg, 64, 48, device="cpu")
    assert codec == "mjpeg" and isinstance(enc, TEnc)
    assert (enc.quality, enc.entropy, enc.table_mode) == (85, "device",
                                                          "sticky")
    ef = enc.encode(stream(48, 64, 1)[0])
    assert ef.keyframe and ef.codec == "mjpeg"
    assert Image.open(io.BytesIO(ef.data)).size == (64, 48)


@pytest.mark.parametrize("h,w", [(48, 64), (50, 70), (160, 192)])
def test_device_and_python_entropy_give_the_same_bytes(h, w):
    """Per-frame tables on both routes are the frame's optimal tables."""
    dev = TEnc(w, h, table_mode="per_frame", device="cpu")
    py = TEnc(w, h, entropy="python", device="cpu")
    assert TEnc(w, h, use_native=False, device="cpu").entropy == "python"
    for f in stream(h, w, 3):
        assert dev.encode(f).data == py.encode(f).data


@pytest.mark.parametrize("mode,refresh", [("sticky", 300), ("sticky", 2),
                                          ("per_frame", 300)])
def test_entropy_on_the_reference_levels_gives_its_bytes(mode, refresh):
    """Headers (DQT, SOF, DHT) and scan byte for byte, over a stream that
    crosses a table refresh."""
    h, w = 50, 70
    jenc = JEnc(w, h, quality=75, entropy="device", table_mode=mode,
                table_refresh=refresh)
    tenc = TEnc(w, h, quality=75, table_mode=mode, table_refresh=refresh,
                device="cpu")
    for f in stream(h, w, 5):
        want = jenc.encode(f).data
        assert tenc.entropy_device(*levels_of(jenc, f)) == want
        assert tenc._headers(tenc._tables) == jenc._headers(jenc._tables)
    builds = {"sticky": 1 if refresh == 300 else 3, "per_frame": 5}[mode]
    assert tenc.table_builds == builds


@pytest.mark.parametrize("quality", [50, 85])
def test_decoded_quality_matches_the_reference(quality):
    h, w = 160, 192
    f = stream(h, w, 1, seed=3)[0]
    want = JEnc(w, h, quality=quality, entropy="device").encode(f).data
    got = TEnc(w, h, quality=quality, device="cpu").encode(f).data
    ref = np.asarray(Image.open(io.BytesIO(want)).convert("RGB"))
    pil = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
    cv = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    assert abs(psnr(f, pil) - psnr(f, ref)) < PSNR_TOL_DB
    assert abs(psnr(f, cv) - psnr(f, ref)) < PSNR_TOL_DB
    assert psnr(f, pil) > 15          # the test frame carries a noise band


def test_reference_state_imported_mid_stream():
    """A session the reference encoded two frames of continues on the
    port with the same DHT and no table rebuild, and its next frames are
    the reference's bytes given the reference's levels."""
    h, w = 48, 64
    frames = stream(h, w, 5, seed=1)
    jenc = JEnc(w, h, entropy="device")
    for f in frames[:2]:
        jenc.encode(f)
    tenc = TEnc(w, h, device="cpu")
    tenc.import_state(jenc.export_state())
    assert tenc.frame_index == 2 and tenc._frames_since_tables == 2
    for f in frames[2:]:
        want = jenc.encode(f).data
        assert tenc.entropy_device(*levels_of(jenc, f)) == want
    assert tenc.table_builds == 0
    own = TEnc(w, h, device="cpu")
    own.import_state(tenc.export_state())
    ef = own.encode(frames[4])
    assert ef.frame_index == 2 and own.table_builds == 0
    assert ef.data[:600].count(b"\xff\xc4") == 4
    assert cv2.imdecode(np.frombuffer(ef.data, np.uint8),
                        cv2.IMREAD_COLOR).shape == (h, w, 3)


def test_card_by_default_and_native_not_ported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEnc(64, 48)
    cfg = from_env({"SIZEW": "64", "SIZEH": "48",
                    "WEBRTC_ENCODER": "tpumjpegenc"})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_encoder(cfg, 64, 48)
    # the native coder serves now (tests/test_torch_host_entropy.py
    # holds its bytes against the reference's)
    assert TEnc(64, 48, entropy="native", device="cpu").use_native
    assert TEnc(64, 48, use_native=True, device="cpu").entropy == "native"
    with pytest.raises(ValueError):
        TEnc(64, 48, entropy="bogus", device="cpu")
