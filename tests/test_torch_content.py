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
    before = t_cs.chunk_stats.launches
    vt, gt = t_cs.frame_stats(torch.from_numpy(y), torch.from_numpy(prev), thr)
    assert t_cs.chunk_stats.launches == before          # plain path on CPU
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


SSE_REL = 1e-5    # the reference sums the per-MB SSEs in float32
MV_REL = 1e-5     # ... and the |MV| mean and p95 in float32


def _p_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    r, c = h // 16, w // 16
    recon = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mv = rng.integers(-39, 40, (r, c, 2)).astype(np.int32)
    mv[rng.random((r, c)) < 0.4] = 0
    shapes = ((16, 16), (4,), (4, 15), (4,), (4, 15))
    resid = [np.where(rng.random((r, c) + s) < 0.01, 1, 0).astype(np.int32)
             for s in shapes]
    for t in resid:
        t[0] = 0                                   # row 0 skips where mv is 0
    return recon, mv, resid


@pytest.mark.parametrize("h,w,p_frame", [(48, 64, True), (64, 80, True),
                                         (48, 64, False)])
def test_plain_full_stats_equal_reference(h, w, p_frame):
    y, prev = _pair(h, w, seed=h + w)
    recon, mv, resid = _p_inputs(h, w, seed=h * w)
    if p_frame:
        vj, gj = j_cs.frame_stats(y, prev, recon, mv, tuple(resid), None, 512)
        vn, _ = j_cs.frame_stats_np(y, prev, recon, mv, resid, None, 512)
        args = (torch.from_numpy(mv), tuple(map(torch.from_numpy, resid)))
    else:                                          # the IDR of a GOP
        vj, gj = j_cs.frame_stats(y, prev, recon, None, None, None, 512)
        vn, _ = j_cs.frame_stats_np(y, prev, recon, thr_sad=512)
        args = ()
    before = t_cs.chunk_stats.launches
    vt, gt = t_cs.frame_stats_full(torch.from_numpy(y), torch.from_numpy(prev),
                                   512, torch.from_numpy(recon), *args)
    assert t_cs.chunk_stats.launches == before      # plain path
    vj, vt = np.asarray(vj), vt.numpy()
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    ints = [t_cs.IDX_DAMAGE, t_cs.IDX_SKIP, t_cs.IDX_INTER, t_cs.IDX_INTRA,
            t_cs.IDX_MBS]
    np.testing.assert_array_equal(vj[ints], vt[ints])
    np.testing.assert_array_equal(vn[ints], vt[ints].astype(np.float64))
    pct = [t_cs.IDX_ACT_P50, t_cs.IDX_ACT_P95]
    np.testing.assert_allclose(vt[pct], vj[pct], rtol=REL)
    mvs = [t_cs.IDX_MV_MEAN, t_cs.IDX_MV_P95]
    for got in (vj, vn):
        np.testing.assert_allclose(vt[t_cs.IDX_SSE], got[t_cs.IDX_SSE],
                                   rtol=SSE_REL)
        np.testing.assert_allclose(vt[mvs], got[mvs], rtol=MV_REL)
    npix = h * w
    pj = j_cs.psnr_from_sse(float(vj[t_cs.IDX_SSE]), npix)
    pt = t_cs.psnr_from_sse(float(vt[t_cs.IDX_SSE]), npix)
    assert abs(pj - pt) <= 0.01                          # the documented dB
    if p_frame:
        assert vt[t_cs.IDX_SKIP] > 0 and vt[t_cs.IDX_INTER] > 0
        assert vt[t_cs.IDX_MV_MEAN] > 0
    else:
        assert (vt[[t_cs.IDX_SKIP, t_cs.IDX_MV_MEAN]] == -1).all()
