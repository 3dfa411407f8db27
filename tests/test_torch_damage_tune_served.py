"""ENCODER_TUNE=hq's served tier under the damage mask against the
reference encoder: ``make_encoder`` with ``ENCODER_TUNE=hq`` and
``DNGD_DAMAGE_MASK=true`` (GOP 60, the loop filter on, so the kernel tier
hq_noaq: Lagrangian decisions at the slice qp over the worklist, the
compacted stack loop-filtered), per frame with two frames in flight under
rate control and in the chunk ring; every access unit byte-equal, and
cv2 decodes the stream to the port's deblocked references."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

from test_torch_damage_tune_full import (H, QP, SCHEDULE, W, damage_frames,
                                         run_pair)

cv2 = pytest.importorskip("cv2")


def _served_pair(monkeypatch, **env):
    monkeypatch.setenv("DNGD_DAMAGE_MASK", "true")
    e = dict({"SIZEW": str(W), "SIZEH": str(H), "ENCODER_TUNE": "hq",
              "ENCODER_QP": str(QP), "ENCODER_BITRATE_KBPS": "500"}, **env)
    je, te = j_make(j_env(e), W, H)[0], t_make(t_env(e), W, H,
                                                device="cpu")[0]
    assert je._ktune == te._ktune == "hq_noaq" and te.deblock
    assert te.damage_mask and je.damage_mask and not te._p_intra
    return je, te


def test_masked_served_tier_equals_the_reference_and_decodes(monkeypatch,
                                                             tmp_path):
    je, te = _served_pair(monkeypatch)
    toks, aus, refs = run_pair(je, te, damage_frames(SCHEDULE, seed=3))
    assert [t[0] for t in toks] == ["intra"] + ["p_masked"] * len(SCHEDULE)
    assert je._rate._ema == te._rate._ema
    path = tmp_path / "served.264"
    path.write_bytes(b"".join(aus))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, ref in enumerate(refs):
        ok, img = cap.read()
        assert ok, f"cv2 stopped at frame {i}"
        np.testing.assert_array_equal(np.asarray(img).reshape(H, W),
                                      ref[0][:H, :W], f"frame {i}")
    cap.release()


def test_masked_served_tier_ring_equals_the_reference_ring(monkeypatch):
    je, te = _served_pair(monkeypatch, ENCODER_SUPERSTEP_CHUNK="4")
    assert te._ring_chunk == je._ring_chunk == 4
    toks, _, _ = run_pair(je, te, damage_frames(SCHEDULE, seed=3),
                          depth=te.pipeline_depth)
    assert toks[1][4][0].dmg is not None
    assert [k[2] for k in te._chunk_steps] == [4]
    assert je._rate._ema == te._rate._ema
