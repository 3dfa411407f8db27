"""ENCODER_TUNE=hq's served tier end to end against the reference encoder:
``make_encoder`` with the loop filter on runs the kernel tier hq_noaq
(Lagrangian decisions at the slice qp), with device CAVLC (rate control
moving qp, two frames in flight, cv2 decoding the stream to the deblocked
references, a mid-GOP state import) and with CABAC's device
binarization, which the tier keeps; every access unit byte-equal."""

import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

from test_torch_tune import H, QP, W, _decoded_luma, _frames, _run_pair

import numpy as np

cv2 = pytest.importorskip("cv2")


def _noaq_pair(**env):
    e = dict({"SIZEW": str(W), "SIZEH": str(H), "ENCODER_TUNE": "hq"}, **env)
    je, te = j_make(j_env(e), W, H)[0], t_make(t_env(e), W, H,
                                                device="cpu")[0]
    assert je._ktune == te._ktune == "hq_noaq" and te.deblock
    assert not te._p_intra
    return je, te


def test_served_tier_stream_equals_reference_and_decodes(tmp_path):
    je, te = _noaq_pair(ENCODER_BITRATE_KBPS="500", ENCODER_QP=str(QP))
    frames = _frames(6, seed=3)
    toks, aus, _, refs = _run_pair(je, te, frames)
    assert len({t[4][0] if t[0] == "p" else t[4][2] for t in toks}) > 1
    assert je._rate._ema == te._rate._ema
    assert je.pop_content_stats()["tier"] == "hq_noaq"
    assert te.pop_content_stats()["tier"] == "hq_noaq"
    dec = _decoded_luma(aus, tmp_path, "noaq.264")
    for i, (d, r) in enumerate(zip(dec, refs)):
        np.testing.assert_array_equal(d, r[0][:H, :W], err_msg=f"frame {i}")


def test_cabac_device_binarize_stream_equals_reference(monkeypatch):
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")
    je, te = _noaq_pair(ENCODER_ENTROPY="cabac", ENCODER_QP=str(QP),
                        ENCODER_BITRATE_KBPS="0")
    assert te.cabac_device_binarize
    _run_pair(je, te, _frames(4, seed=7))


def test_served_tier_state_from_the_reference_mid_gop():
    env = dict(ENCODER_BITRATE_KBPS="500", ENCODER_QP=str(QP))
    frames = _frames(6, seed=3)
    je, _ = _noaq_pair(**env)
    for f in frames[:3]:
        je.encode(f)
    state = je.export_state()
    j2, te = _noaq_pair(**env)
    j2.import_state(state)
    te.import_state(state)
    for i, f in enumerate(frames[3:]):
        a, b = j2.encode(f), te.encode(f)
        assert a.data == b.data and a.keyframe == b.keyframe == (i == 0), i
