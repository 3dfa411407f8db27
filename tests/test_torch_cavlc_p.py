"""P-slice CAVLC (K6 slots, K7 packer): the plain PyTorch versions against
the reference's ``p_frame_block_slots`` / ``p_mb_header_slots`` /
``pack_p_frame`` and the fused ``encode_p_cavlc_frame`` — slots, header
slots, trailing runs, nnz flags and the packed flat buffer exact."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cd
from docker_nvidia_glx_desktop_tpu.ops import cavlc_p_device as j_cp
from docker_nvidia_glx_desktop_tpu.ops.h264_device import LUMA_BLOCK_ORDER
from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge as t_bm
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device as t_cd
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_p_device as t_cp

import jax
import jax.numpy as jnp

R, C = 4, 6
# one compile each for all the seeded cases (eager dispatch compiles every
# primitive on its own)
_j_block_slots = jax.jit(j_cp.p_frame_block_slots)
_j_header_slots = jax.jit(j_cp.p_mb_header_slots)
_j_pack = jax.jit(j_cp.pack_p_frame)
_SHAPES = {"luma": (16, 16), "cb_dc": (4,), "cb_ac": (4, 15),
           "cr_dc": (4,), "cr_ac": (4, 15)}


def _levels(seed, density, big):
    """Seeded P levels: row 0 all skipped, row 1 ends in two skips, row 2
    starts with one, chroma-DC-only and zero-MV coded MBs on the way; with
    ``big`` above 1000 one MB of escape-coded levels overflows the
    packer's caps."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in _SHAPES.items():
        nz = rng.random((R, C) + shape) < density
        mag = np.where(rng.random((R, C) + shape) < 0.9, 1,
                       rng.integers(2, big + 1, (R, C) + shape))
        sign = np.where(rng.random((R, C) + shape) < 0.5, -1, 1)
        out[k] = (nz * mag * sign).astype(np.int32)
    mv = rng.integers(-39, 40, (R, C, 2)).astype(np.int32)
    mv[rng.random((R, C)) < 0.3] = 0
    for k in out:
        out[k][0] = 0
        out[k][1, -2:] = 0
        out[k][2, 0] = 0
    mv[0] = 0
    mv[1, -2:] = 0
    mv[2, 0] = 0
    out["cb_ac"][3, 1] = out["cr_ac"][3, 1] = out["luma"][3, 1] = 0
    out["cb_dc"][3, 1, 0] = 5                       # chroma DC only
    mv[3, 2] = 0                                    # zero MV, coded
    out["luma"][3, 2, 5, 0] = -2
    if big > 1000:                   # one MB past the 2048-bit cap
        out["luma"][3, 4] = np.where(out["luma"][3, 4] < 0, -big, big)
    out["mv"] = mv
    return out


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed,density,big", [(1, 0.08, 3), (2, 0.3, 40),
                                              (3, 0.6, 2000)])
def test_p_slots_and_pack_equal_reference(seed, density, big):
    lv = _levels(seed, density, big)
    jv, jl, jcbp, jmv = _j_block_slots(
        {k: jnp.asarray(v) for k, v in lv.items()})
    jhv, jhl, jtv, jtl, _ = _j_header_slots(jmv, jcbp)
    before = t_cp.p_frame_slots.launches
    got = t_cp.p_frame_slots({k: torch.from_numpy(v) for k, v in lv.items()})
    assert t_cp.p_frame_slots.launches == before          # plain path
    want = (jv, jl, jhv, jhl, jtv, jtl)
    for name, a, b in zip(("values", "lengths", "mbh_vals", "mbh_lens",
                           "run_vals", "run_lens"), want, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(_u32(a), _u32(b.numpy()), err_msg=name)
    nnz = np.zeros((R, C, 4, 4), bool)
    blk = LUMA_BLOCK_ORDER
    nnz[:, :, blk[:, 1], blk[:, 0]] = (lv["luma"] != 0).any(axis=-1)
    np.testing.assert_array_equal(nnz, got[6].numpy())
    # the rows the levels were built to have
    hl = got[3].numpy()
    assert (hl[0] == 0).all() and got[5][0] > 0          # all-skip row
    assert (hl[1, -2:] == 0).all() and got[5][1] > 0     # ends in skips
    assert got[2][2, 1, 0] == 2                          # skip run of 1

    hv, hl_ = j_cd.slice_header_slots(R, C, frame_num=3, qp_delta=-2,
                                      slice_type=5, idr=False,
                                      deblocking_idc=2)
    jflat, jovf = _j_pack(jv, jl, jhv, jhl, jtv, jtl, jnp.asarray(hv),
                          jnp.asarray(hl_))
    before = t_bm.pack_p_frame.launches
    tflat = t_bm.pack_p_frame(*got[:6], torch.from_numpy(hv.view(np.int32)),
                              torch.from_numpy(hl_))
    assert t_bm.pack_p_frame.launches == before
    jflat, tflat = np.asarray(jflat), tflat.numpy()
    meta = t_cd.FlatMeta(tflat, R)
    assert meta.overflow == bool(jovf) == (big == 2000)
    np.testing.assert_array_equal(jflat[:4096], tflat[:4096])    # META
    if not meta.overflow:
        n = 4096 + 4 * meta.total_words
        np.testing.assert_array_equal(jflat[:n], tflat[:n])
        assert not tflat[n:].any()


def test_fused_p_stage_equals_reference():
    rng = np.random.default_rng(5)
    h, w = 48, 64
    ref = [rng.integers(0, 256, s, np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    cur = [np.ascontiguousarray(np.roll(p, (2, -2), axis=(0, 1))) for p in ref]
    cur[0][:16] = ref[0][:16]
    cur[1][:8] = ref[1][:8]
    cur[2][:8] = ref[2][:8]
    qp = 28
    hv, hl = j_cd.slice_header_slots(h // 16, w // 16, frame_num=1,
                                     qp_delta=2, slice_type=5, idr=False,
                                     deblocking_idc=2)
    want = j_cp.encode_p_cavlc_frame(*cur, *ref, hv, hl, qp)
    got = t_cp.encode_p_cavlc_frame(*map(torch.from_numpy, cur),
                                    *map(torch.from_numpy, ref),
                                    torch.from_numpy(hv.view(np.int32)),
                                    torch.from_numpy(hl), qp)
    meta = t_cd.FlatMeta(got[0].numpy(), h // 16)
    n = 4096 + 4 * meta.total_words
    assert not meta.overflow
    np.testing.assert_array_equal(np.asarray(want[0])[:n], got[0].numpy()[:n])
    for i, name in enumerate(("recon_y", "recon_cb", "recon_cr", "mv", "nnz"),
                             start=1):
        np.testing.assert_array_equal(np.asarray(want[i]).astype(np.int64),
                                      got[i].numpy().astype(np.int64),
                                      err_msg=name)
    for k in _SHAPES:
        np.testing.assert_array_equal(np.asarray(want[6][k]), got[6][k].numpy(),
                                      err_msg=k)
    assert t_cp.P_MB_BLOCKS == j_cp.P_MB_BLOCKS
    assert t_cp.HDR_SLOT_COUNT == j_cp.HDR_SLOT_COUNT
    np.testing.assert_array_equal(t_cp._CBP_TO_CODENUM, j_cp._CBP_TO_CODENUM)


def test_ue_se_slots_equal_reference():
    v = np.arange(0, 2000, dtype=np.int32)
    for jf, tf, arg in ((j_cp._ue, t_cd.ue_slots, v),
                        (j_cp._se, t_cd.se_slots, v - 1000)):
        jv, jl = jf(jnp.asarray(arg))
        tv, tl = tf(torch.from_numpy(arg))
        np.testing.assert_array_equal(_u32(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
