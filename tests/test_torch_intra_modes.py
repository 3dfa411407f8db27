"""K1's other intra mode sets (``i16_modes`` "full", "i16", "dc") and
K5's ``refine="full"``: the plain PyTorch versions against the
reference's programs on the CPU, every output exact, at each tune tier,
and the timing loops at these forms against the reference's loops
(48x64, qp 26: each reference configuration is one compile)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.ops import devloop as j_loop
from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_intra
from docker_nvidia_glx_desktop_tpu.ops import h264_inter as j_inter
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import devloop as t_loop
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device as t_intra
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter as t_inter
from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
    rgb_to_yuv420_host)

import conftest

H, W, QP = 48, 64, 26
TIERS = ("off", "hq_noaq", "hq")


def _planes(seed=3):
    frame = conftest.make_test_frame(H, W, seed=seed)
    # sawtooth columns: vertical edges inside MBs, where I4 wins
    frame[:, :W // 2] = ((np.arange(W // 2) * 37) % 256)[None, :, None]
    return [np.ascontiguousarray(p) for p in rgb_to_yuv420_host(frame, H, W)]


def _mode_planes(seed=1):
    """Per MB a grating along one of the I4 modes' eight directions, or a
    flat patch: the full set picks the diagonal modes here."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    y = np.zeros((H, W))
    dirs = [(0, 1), (1, 0), (1, 1), (1, -1), (2, 1), (1, 2), (2, -1), (1, -2)]
    for r in range(H // 16):
        for c in range(W // 16):
            k = rng.integers(0, len(dirs) + 1)
            sl = (slice(r * 16, r * 16 + 16), slice(c * 16, c * 16 + 16))
            if k == len(dirs):
                y[sl] = rng.integers(40, 220)
                continue
            a, b = dirs[k]
            y[sl] = 128 + 90 * np.sin(rng.uniform(0.3, 1.2)
                                      * (a * xx[sl] + b * yy[sl])
                                      + rng.uniform(0, 6.3))
    c = np.full((H // 2, W // 2), 128, np.uint8)
    return [np.clip(np.round(y), 0, 255).astype(np.uint8), c, c.copy()]


def _same(ref, got, label, dtypes=True):
    """Every key's values equal (and, for K1, its dtype: the P core's
    levels are int32 in the port where the reference narrows some)."""
    assert set(got) == set(ref), label
    for k in ref:
        r = np.asarray(ref[k])
        if dtypes:
            assert got[k].dtype == torch.from_numpy(r.copy()).dtype, (label, k)
        np.testing.assert_array_equal(r, got[k].numpy(), err_msg=f"{label} {k}")


def _k1(planes, modes, tune):
    ref = j_intra.encode_intra_frame_yuv(*planes, QP, i16_modes=modes,
                                         tune=tune)
    before = (t_intra.encode_intra_frame_yuv.launches,
              getattr(t_intra.encode_intra_frame_yuv, modes).launches)
    got = t_intra.encode_intra_frame_yuv(
        *(torch.from_numpy(p) for p in planes), QP, tune=tune,
        i16_modes=modes)
    # the plain path: no kernel counted
    assert before == (t_intra.encode_intra_frame_yuv.launches,
                      getattr(t_intra.encode_intra_frame_yuv, modes).launches)
    return ref, got


@pytest.mark.parametrize("modes", ["full", "i16", "dc"])
@pytest.mark.parametrize("tune", TIERS)
def test_plain_mode_sets_equal_the_reference(modes, tune):
    ref, got = _k1(_planes(), modes, tune)
    _same(ref, got, f"{modes} {tune}")
    mb_i4 = np.asarray(ref["mb_i4"])
    if modes == "full":
        assert mb_i4.any() and not mb_i4.all()
    else:                        # the reference's constants: no I4
        assert not mb_i4.any() and (np.asarray(ref["i4_modes"]) == 2).all()
        assert not np.asarray(ref["luma_i4"]).any()
    pred = np.asarray(ref["pred_mode"])
    assert (pred == 2).all() if modes == "dc" else (pred == 1).any()


@pytest.mark.parametrize("tune", ["off", "hq"])
def test_full_set_picks_the_diagonal_modes_and_dc_from_the_top(tune):
    planes = _mode_planes()
    ref, got = _k1(planes, "full", tune)
    _same(ref, got, f"nine-mode frame {tune}")
    modes = np.asarray(ref["i4_modes"])
    mb_i4 = np.asarray(ref["mb_i4"])
    picked = set(modes[mb_i4].ravel().tolist())
    assert {4, 5, 6} <= picked, picked                # DDR, VR, HD
    # MB column 0 has no left neighbour: a DC block at bx = 0 of block
    # rows 1-3 predicts from the top alone (blkIdx 2, 8, 10)
    col0 = modes[:, 0][mb_i4[:, 0]][:, [2, 8, 10]]
    assert (col0 == 2).any(), col0


@pytest.mark.parametrize("tune,p_intra", [("off", False), ("hq_noaq", True),
                                          ("hq", True)])
def test_plain_p_core_refine_full_equals_the_reference(tune, p_intra):
    """K5 and K5p at ``refine="full"``: every output exact (MVs, levels,
    recon, the I16-in-P tensors and qp plane of the hq tiers); the
    refinement's choice differs from ``refine="alt"`` on this content."""
    f0 = conftest.make_test_frame(H, W, seed=3)
    f1 = np.roll(f0, (1, 2), axis=(0, 1)).copy()
    f1[10:20, 10:30] = np.random.default_rng(1).integers(0, 256, (10, 20, 3))
    ref = [np.ascontiguousarray(p) for p in rgb_to_yuv420_host(f0, H, W)]
    cur = [np.ascontiguousarray(p) for p in rgb_to_yuv420_host(f1, H, W)]
    want = j_inter.encode_p_frame(*cur, *ref, QP, refine="full", tune=tune,
                                  p_intra=p_intra)
    t = [torch.from_numpy(p) for p in cur + ref]
    got = t_inter.encode_p_frame(*t, QP, refine="full", tune=tune,
                                 p_intra=p_intra)
    _same(want, got, f"K5 full {tune}", dtypes=False)
    # K5p: the same core over references the caller padded (edge copies
    # here, which is what the reference's encode_p_frame pads with)
    pad = [t_inter._edge_pad(p.to(torch.int32), t_inter._PAD)
           .to(torch.uint8).contiguous() for p in t[3:]]
    got_p = t_inter.encode_p_frame_padded_ref(*t[:3], *pad, QP,
                                              refine="full", tune=tune,
                                              p_intra=p_intra)
    _same(want, got_p, f"K5p full {tune}", dtypes=False)
    alt = t_inter.encode_p_frame(*t, QP, tune=tune, p_intra=p_intra)
    assert not torch.equal(alt["mv"], got["mv"])


def test_margin_tables_at_both_scales_bit_for_bit():
    """The hq tiers' motion margins ``(int)(lam_mv * bits / scale)``: the
    alternate-line table (/2) and the full-line one (/1), against the
    reference's float32 arithmetic."""
    from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
    from docker_nvidia_glx_desktop_tpu_torch.ops import aq as t_aq

    q = jnp.arange(52, dtype=jnp.int32)
    for tune, lam_v in (("hq", np.asarray(j_aq.lam_mv(q), np.float32)),
                        ("hq_noaq", np.array([np.float32(j_aq.lam_mv(i))
                                              for i in range(52)]))):
        for scale in (1, 2):
            want = np.stack([np.asarray(
                (jnp.asarray(lam_v) * (b / scale)).astype(jnp.int32))
                for b in (j_inter._RATE_ZERO_BITS, j_inter._RATE_HALF_BITS,
                          j_inter._RATE_QUARTER_BITS)])
            np.testing.assert_array_equal(want,
                                          t_aq.margin_tables(tune, scale))
    with pytest.raises(ValueError, match="unknown refine"):
        t_inter._refine_scale("quarter")
    with pytest.raises(ValueError, match="unknown i16_modes"):
        t_intra.encode_intra_frame_yuv(*(torch.from_numpy(p)
                                         for p in _planes()), QP,
                                       i16_modes="nine")


def _noise(seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, s, np.uint8)
            for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]


@pytest.mark.parametrize("loop,opt", [("intra", "full"), ("intra", "dc"),
                                      ("cabac_intra", "full"),
                                      ("cabac_intra", "dc"),
                                      ("inter", "full")])
def test_loops_at_the_new_forms_equal_the_reference(loop, opt):
    cur, ref = _noise(7), _noise(8)
    jc, jr = [jnp.asarray(a) for a in cur], [jnp.asarray(a) for a in ref]
    tc = [torch.from_numpy(a.copy()) for a in cur]
    tr = [torch.from_numpy(a.copy()) for a in ref]
    je = JEnc(W, H, mode="cavlc", entropy="device")
    te = TEnc(W, H, mode="cavlc", entropy="device", device="cpu")
    for k in (1, 2):
        if loop == "intra":
            want = j_loop.intra_loop(*jc, *je._hdr_slots(0, 0), jnp.int32(k),
                                     QP, i16_modes=opt)
            got = t_loop.intra_loop(*tc, *te._hdr_slots(0, 0), k, QP,
                                    i16_modes=opt)
        elif loop == "cabac_intra":
            want = j_loop.cabac_intra_loop(*jc, jnp.int32(k), QP,
                                           i16_modes=opt)
            got = t_loop.cabac_intra_loop(*tc, k, QP, i16_modes=opt)
        else:
            want = j_loop.inter_loop(*jc, *jr, jnp.int32(k), QP, refine=opt)
            got = t_loop.inter_loop(*tc, *tr, k, QP, refine=opt)
        assert int(got) == int(np.asarray(want)), (loop, opt, k)
