"""The device colour conversion (K9): the plain version of
``ops/color.rgb_to_yuv420`` against the reference's ``_yuv_stage`` —
luma over every RGB triple, chroma on random, flat and edge frames and
the padded edge of an odd size, all exact — and the encoder's device
colour path (``host_color=False``, odd geometry, no cv2) giving the
reference encoder's bytes."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.models.h264 import _yuv_stage
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import color, h264_device
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

import conftest


def _both(rgb, pad_h, pad_w):
    want = [np.asarray(p) for p in _yuv_stage(rgb, pad_h, pad_w)]
    got = [p.numpy() for p in color.rgb_to_yuv420(torch.from_numpy(rgb),
                                                  pad_h, pad_w)]
    return want, got


def test_luma_equals_reference_over_every_rgb_triple():
    """All 2^24 triples, 1024 x 4096 pixels at a time (one compile)."""
    allv = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(allv >> 16) & 255, (allv >> 8) & 255, allv & 255],
                   axis=-1).astype(np.uint8).reshape(4, 1024, 4096, 3)
    for part in rgb:
        want, got = _both(part, 1024, 4096)
        for name, a, b in zip(("y", "cb", "cr"), want, got):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _edge_frame(h, w):
    """Hard vertical and horizontal colour edges on odd columns/rows."""
    f = np.zeros((h, w, 3), np.uint8)
    f[:, 1::2] = (255, 0, 128)
    f[1::4] = (0, 255, 255)
    f[:, w // 3] = (17, 250, 3)
    return f


@pytest.mark.parametrize("kind,h,w", [
    ("random", 96, 128), ("random", 95, 127), ("desktop", 96, 128),
    ("flat", 48, 64), ("edges", 48, 64), ("edges", 47, 63),
    ("random", 17, 33), ("random", 1, 1),
])
def test_planes_equal_reference(kind, h, w):
    rng = np.random.default_rng(h * 1000 + w)
    if kind == "random":
        rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    elif kind == "desktop":
        rgb = conftest.make_test_frame(h, w, seed=4)
    elif kind == "flat":
        rgb = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    else:
        rgb = _edge_frame(h, w)
    pad_h, pad_w = -(-h // 16) * 16, -(-w // 16) * 16
    want, got = _both(rgb, pad_h, pad_w)
    for name, a, b in zip(("y", "cb", "cr"), want, got):
        assert a.shape == b.shape and b.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_encode_intra_frame_is_colour_then_intra_core():
    from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_dev

    rgb = conftest.make_test_frame(40, 72, seed=2)
    want = j_dev.encode_intra_frame(rgb, 48, 80, 26)
    got = h264_device.encode_intra_frame(torch.from_numpy(rgb), 48, 80, 26)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(want[k]), v.numpy(),
                                      err_msg=k)


def test_rejects_bad_inputs():
    rgb = torch.zeros((40, 72, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        color.rgb_to_yuv420(rgb, 40, 80)            # not an MB multiple
    with pytest.raises(ValueError):
        color.rgb_to_yuv420(rgb, 32, 80)            # does not cover
    with pytest.raises(ValueError):
        color.rgb_to_yuv420(rgb.to(torch.int32), 48, 80)


def _frames(w, h, n, seed=0):
    base = conftest.make_test_frame(h, w, seed=seed)
    out = []
    for i in range(n):
        f = base.copy()
        f[h // 2:] = np.roll(base[h // 2:], 3 * i, axis=1)
        f[4:14, 2 + 5 * i:14 + 5 * i] = (20 * i, 200, 90)
        out.append(f)
    return out


def _same_stream(je, te, frames, depth=2):
    jt, tt, n = [], [], 0
    for f in frames + [None]:
        if f is not None:
            jt.append(je.encode_submit(f))
            tt.append(te.encode_submit(f))
        if len(jt) == depth or (f is None and jt):
            a, b = je.encode_collect(jt.pop(0)), te.encode_collect(tt.pop(0))
            assert a.data == b.data, f"frame {a.frame_index}"
            assert a.keyframe == b.keyframe
            n += 1
    for a, b in zip(je._ref, te._ref):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return n


def test_encoder_device_colour_gop_equals_reference():
    """``H264Encoder(..., host_color=False)``, the reference's default
    colour path: an IDR and P frames with deblock and rate control."""
    w, h = 72, 40
    kw = dict(qp=24, mode="cavlc", entropy="device", host_color=False,
              gop=8, bitrate_kbps=400, deblock=True)
    je, te = JEnc(w, h, **kw), TEnc(w, h, device="cpu", **kw)
    assert _same_stream(je, te, _frames(w, h, 5, seed=6)) == 5


def test_make_encoder_odd_geometry_takes_the_device_colour():
    """Odd frames resist host 4:2:0: both encoders convert on the device
    (the port used to raise here)."""
    w, h = 71, 39
    e = {"SIZEW": str(w), "SIZEH": str(h), "ENCODER_GOP": "4",
         "ENCODER_BITRATE_KBPS": "0", "ENCODER_QP": "26"}
    je, te = j_make(j_env(e), w, h)[0], t_make(t_env(e), w, h,
                                               device="cpu")[0]
    assert te.host_color and te._host_yuv420(np.zeros((h, w, 3),
                                                       np.uint8)) is None
    assert _same_stream(je, te, _frames(w, h, 3, seed=8), depth=1) == 3


def test_no_cv2_gives_no_host_planes_and_the_device_colour(monkeypatch):
    """Without cv2 the host converter gives no planes (no numpy float
    path): the device conversion codes the frame, as in the reference."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(TEnc, "_host_yuv_ok", None)
    monkeypatch.setattr(JEnc, "_host_yuv_ok", None)
    w, h = 64, 48
    kw = dict(qp=26, mode="cavlc", entropy="device", host_color=True)
    je, te = JEnc(w, h, **kw), TEnc(w, h, device="cpu", **kw)
    f = _frames(w, h, 1, seed=9)[0]
    assert te._host_yuv420(f) is None
    assert je.encode(f).data == te.encode(f).data
