"""The encoder options that ride on K1's mode sets and the host coders:
``make_encoder`` with ``ENCODER_INTRA_MODES`` full / i16 and
``ENCODER_ENTROPY`` native / python, ``mode="pcm"`` and MJPEG's native
coder, each byte-equal to the reference encoder over two GOPs (64x48,
qp 26) and decoded by cv2."""

import os
import tempfile

import cv2
import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.models.mjpeg import JpegEncoder as JJpeg
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import JpegEncoder as TJpeg
from docker_nvidia_glx_desktop_tpu_torch.native import lib
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

import conftest

W, H, QP = 64, 48, 26


def frames(n=6, seed=2):
    """A moving window over a desktop-like frame: P frames with motion."""
    base = conftest.make_test_frame(H, W, seed=seed)
    out = []
    for i in range(n):
        f = np.roll(base, (i, 2 * i), axis=(0, 1)).copy()
        f[8:24, 4 * i:4 * i + 16] = (200 - 20 * i, 90, 40 + 30 * i)
        out.append(f)
    return out


def decoded(aus):
    """The frames cv2 decodes from an Annex-B stream."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.264")
        with open(path, "wb") as f:
            f.write(b"".join(aus))
        cap = cv2.VideoCapture(path)
        out = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            out.append(img)
        cap.release()
    return out


@pytest.mark.parametrize("knobs", [
    {"ENCODER_INTRA_MODES": "full"},
    {"ENCODER_INTRA_MODES": "i16"},
    {"ENCODER_ENTROPY": "native"},
    {"ENCODER_ENTROPY": "python"},
], ids=["full", "i16", "native", "python"])
def test_served_knobs_equal_the_reference_encoder(knobs):
    # rate control off: one qp, one reference compile a program (and the
    # C coder codes only IDRs at the slice qp)
    env = dict({"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": "3",
                "ENCODER_QP": str(QP), "ENCODER_BITRATE_KBPS": "0"}, **knobs)
    enc, codec = make_encoder(from_env(env), W, H, device="cpu")
    ref, _ = j_make(j_env(env), W, H)
    assert codec == "h264_cavlc"
    assert (enc.i16_modes, enc.deblock) == (ref.i16_modes, ref.deblock)
    calls = lib.calls["h264_encode_intra_picture"]
    aus, keys = [], []
    for f in frames():
        ef = enc.encode_collect(enc.encode_submit(f))
        assert ef.data == ref.encode(f).data, len(aus)
        aus.append(ef.data)
        keys.append(ef.keyframe)
    assert keys == [True, False, False] * 2
    native = lib.calls["h264_encode_intra_picture"] - calls
    # the C coder codes each IDR exactly where the reference's does
    assert native == (2 if knobs.get("ENCODER_ENTROPY") == "native" else 0)
    assert len(decoded(aus)) == len(aus)


def test_pcm_is_the_default_mode_and_equals_the_reference():
    enc, ref = TEnc(W, H, qp=QP, device="cpu"), JEnc(W, H, qp=QP)
    assert enc.mode == ref.mode == "pcm"
    fs = frames(3)
    aus = [enc.encode(f).data for f in fs]
    assert aus == [ref.encode(f).data for f in fs]
    # lossless: cv2 gives back the device-converted planes' luma
    cap_y = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pcm.264")
        with open(path, "wb") as fh:
            fh.write(b"".join(aus))
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        while True:
            ok, img = cap.read()
            if not ok:
                break
            cap_y.append(np.asarray(img).reshape(H, W))
        cap.release()
    assert len(cap_y) == len(fs)
    y0 = enc._device_colour(fs[0])[0].numpy()
    np.testing.assert_array_equal(cap_y[0], y0[:H, :W])
    with pytest.raises(ValueError, match="pcm"):
        TEnc(W, H, entropy="cabac", device="cpu")
    with pytest.raises(ValueError, match="entropy"):
        TEnc(W, H, mode="cavlc", entropy="huffman", device="cpu")
    with pytest.raises(ValueError, match="intra_modes"):
        TEnc(W, H, mode="cavlc", intra_modes="all", device="cpu")


def test_mjpeg_native_coder_equals_the_references_on_its_levels():
    jenc = JJpeg(W, H, entropy="native")
    tenc = TJpeg(W, H, entropy="native", device="cpu")
    f = frames(1)[0]
    lv = [np.asarray(a) for a in jenc.transform(f)]
    calls = lib.calls["jpeg_encode_scan"]
    got = tenc.entropy_encode(*lv)
    assert lib.calls["jpeg_encode_scan"] == calls + 1
    assert got == jenc.entropy_encode(*lv)
    assert got == TJpeg(W, H, entropy="python", device="cpu").entropy_encode(*lv)
    img = cv2.imdecode(np.frombuffer(tenc.encode(f).data, np.uint8),
                       cv2.IMREAD_COLOR)
    assert img.shape == (H, W, 3)
