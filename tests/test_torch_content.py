"""Content stats (K4): the plain PyTorch version against the reference's
``frame_stats`` (float32) and ``frame_stats_np`` (float64 oracle): grid and
counts exact, activity percentiles within 1e-6 relative."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import content_stats as j_cs
from docker_nvidia_glx_desktop_tpu_torch.ops import content_stats as t_cs

REL = 1e-6   # float32 interpolation of float32-rounded activities


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (h, w), dtype=np.uint8)
    y = prev.copy()
    y[:16, :] = 255 - y[:16, :]                      # damaged band
    y[16:32, 16:32] = np.clip(y[16:32, 16:32].astype(int) + 3, 0, 255)
    y[-16:, -16:] = 128                              # flat MB: activity 0
    return y, prev


@pytest.mark.parametrize("h,w,thr", [(48, 64, 512), (64, 80, 300),
                                     (48, 64, 0)])
def test_plain_stats_equal_reference(h, w, thr):
    y, prev = _pair(h, w, seed=h + w + thr)
    vj, gj = j_cs.frame_stats(y, prev, None, None, None, None, thr)
    vn, gn = j_cs.frame_stats_np(y, prev, thr_sad=thr)
    before = t_cs.frame_stats.launches
    vt, gt = t_cs.frame_stats(torch.from_numpy(y), torch.from_numpy(prev), thr)
    assert t_cs.frame_stats.launches == before          # plain path on CPU
    vj, vt = np.asarray(vj), vt.numpy()
    assert vt.dtype == np.float32 and gt.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    np.testing.assert_array_equal(gn, gt.numpy())
    exact = [i for i in range(t_cs.VEC_LEN)
             if i not in (t_cs.IDX_ACT_P50, t_cs.IDX_ACT_P95)]
    np.testing.assert_array_equal(vj[exact], vt[exact])
    np.testing.assert_array_equal(vn[exact], vt[exact].astype(np.float64))
    pct = [t_cs.IDX_ACT_P50, t_cs.IDX_ACT_P95]
    np.testing.assert_allclose(vt[pct], vj[pct], rtol=REL)
    np.testing.assert_allclose(vt[pct], vn[pct], rtol=REL)
    assert vt[t_cs.IDX_DAMAGE] > 0


def test_self_diff_and_host_decoding():
    y, _ = _pair(48, 64, seed=9)
    vt, gt = t_cs.frame_stats(torch.from_numpy(y), torch.from_numpy(y), 512)
    assert vt[t_cs.IDX_DAMAGE] == 0 and not gt.any()
    a = j_cs.vec_to_stats(vt.numpy(), gt.numpy(), 48 * 64)
    b = t_cs.vec_to_stats(vt.numpy(), gt.numpy(), 48 * 64)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    for sse in (None, -1.0, 0.0, 1234.5):
        assert j_cs.psnr_from_sse(sse, 3072) == t_cs.psnr_from_sse(sse, 3072)
    assert (j_cs.mb_activity_np(y) == t_cs.mb_activity_np(y)).all()


def test_stats_reject_bad_planes():
    y = torch.zeros((32, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        t_cs.frame_stats(y.to(torch.int32), y, 512)
    with pytest.raises(ValueError):
        t_cs.frame_stats(y, y[:16].contiguous(), 512)
