"""tune=hq's kernels against the reference: the qp plane (K14 plain) on
activities swept across every breakpoint of the delta, the lambda and
margin tables bit for bit, the qp chain, the intra core (K1) and P core
(K5, with I16-in-P) at both kernel tiers on every output key, and the
slot coders (K2, K6) with the qp plane and the I16-in-P blocks."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cd
from docker_nvidia_glx_desktop_tpu.ops import cavlc_p_device as j_cp
from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_intra
from docker_nvidia_glx_desktop_tpu.ops import h264_inter as j_inter
from docker_nvidia_glx_desktop_tpu_torch.ops import aq as t_aq
from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge as t_bm
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device as t_cd
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_p_device as t_cp
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device as t_intra
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter as t_inter

import jax
import jax.numpy as jnp

# MBs at reachable activities on both sides of each of the default
# knobs' delta breakpoints (7937, 32512, 130817, 524033, 2096897): n
# pixels at level a, one at b, the rest at 0 give activity
# 256 * (n a^2 + b^2) - (n a + b)^2 (only activities whose negation is a
# square mod 256 exist)
_SWEEP = [(249, 1, 6), (7, 2, 2), (17, 1, 4), (4, 2, 4),
          (250, 5, 7), (252, 3, 13), (1, 8, 8), (37, 2, 1),
          (84, 3, 3), (251, 8, 24), (11, 5, 16), (177, 3, 7),
          (198, 6, 26), (248, 4, 48), (40, 7, 21), (91, 5, 26),
          (164, 1, 91), (23, 19, 27), (158, 8, 71), (102, 7, 75)]


def _sweep_planes(seed):
    """(y, next_y) uint8 planes of 8 x 8 MBs: the sweep MBs on grey
    bases, two-level MBs of varied counts and gaps, noise MBs; the next
    frame still, slightly, moderately or fully changed per MB."""
    rng = np.random.default_rng(seed)
    mbs = []
    for n, a, b in _SWEEP:
        base = int(rng.integers(0, 256 - a - b))
        m = np.full(256, base, np.int32)
        idx = rng.permutation(256)
        m[idx[:n]] += a
        m[idx[n]] += b
        mbs.append(m.reshape(16, 16))
    while len(mbs) < 48:
        lo, gap = int(rng.integers(0, 200)), int(rng.integers(1, 56))
        n = int(rng.integers(1, 256))
        m = np.full(256, lo, np.int32)
        m[rng.permutation(256)[:n]] += gap
        mbs.append(m.reshape(16, 16))
    while len(mbs) < 64:
        mbs.append(rng.integers(0, 256, (16, 16)))
    y = np.stack(mbs).reshape(8, 8, 16, 16).transpose(0, 2, 1, 3)
    y = y.reshape(128, 128).astype(np.uint8)
    step = rng.choice([0, 1, 3, 7, 40], size=(8, 8))
    nxt = np.clip(y.astype(np.int32) + np.kron(step, np.ones((16, 16), int))
                  * np.where(rng.random((128, 128)) < 0.5, -1, 1), 0, 255)
    return y, nxt.astype(np.uint8)


def test_default_knobs_breakpoints_equal_the_reference_formula():
    a = jnp.arange(0, 1 << 22, dtype=jnp.int32)
    f = jax.jit(lambda a: jnp.clip(jnp.round(
        j_aq.AQ_STRENGTH * 0.5 * (jnp.log2(a.astype(jnp.float32) / 256.0
                                           + 1.0) - 12.0)),
        -j_aq.AQ_MAX_DELTA, min(j_aq.AQ_MAX_UP, j_aq.AQ_MAX_DELTA)))
    d = np.asarray(f(a)).astype(np.int64)
    first, steps = t_aq.aq_steps()
    assert (first, steps) == t_aq.DEFAULT_AQ_STEPS
    assert d[0] == first and d[-1] == first + len(steps)
    np.testing.assert_array_equal(np.nonzero(np.diff(d))[0] + 1, steps)


@pytest.mark.parametrize("seed", [0, 1])
def test_qp_plane_plain_equals_reference_across_the_breakpoints(seed):
    y, nxt = _sweep_planes(seed)
    act = np.asarray(j_aq.mb_activity(y))
    for bp in t_aq.DEFAULT_AQ_STEPS[1]:          # both sides of each step
        assert (act < bp).any() and ((act >= bp) & (act < bp + 100)).any()
    yt, nt = torch.from_numpy(y), torch.from_numpy(nxt)
    np.testing.assert_array_equal(np.asarray(jax.jit(j_aq.aq_offsets)(y)),
                                  t_aq.aq_offsets(yt).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(j_aq.lookahead_bias)(y, nxt)),
        t_aq.lookahead_bias(yt, nt).numpy())
    for qp, n in ((26, None), (3, nxt), (50, nxt)):
        want = np.asarray(jax.jit(j_aq.qp_plane, static_argnums=1)(
            y, qp, n))
        got = t_aq.qp_plane(yt, qp, None if n is None else nt)
        np.testing.assert_array_equal(want, got.numpy(), err_msg=str(qp))
    # as the reference's intra core computes it, in its own program
    c = np.full((64, 64), 128, np.uint8)
    ref = j_intra.encode_intra_frame_yuv(y, c, c, 26, tune="hq", next_y=nxt)
    np.testing.assert_array_equal(np.asarray(ref["qp_map"]),
                                  t_aq.qp_plane(yt, 26, nt).numpy())


def test_lambda_and_margin_tables_bit_for_bit():
    q = jnp.arange(52, dtype=jnp.int32)
    bits = lambda a: np.asarray(a, np.float32).view(np.uint32)
    lm, lv, sig = t_aq.lam_tables("hq")
    np.testing.assert_array_equal(bits(jax.jit(j_aq.lam_mode)(q)), bits(lm))
    np.testing.assert_array_equal(bits(jax.jit(j_aq.lam_mv)(q)), bits(lv))
    assert sig is None
    lm, lv, sig = t_aq.lam_tables("hq_noaq")
    np.testing.assert_array_equal(
        bits([np.float32(j_aq.lam_mode(i)) for i in range(52)]), bits(lm))
    np.testing.assert_array_equal(
        bits([np.float32(j_aq.lam_mv(i)) for i in range(52)]), bits(lv))
    np.testing.assert_array_equal(
        bits([np.float32(j_aq.lam_mode(i) * 44) for i in range(52)]),
        bits(sig))
    # the P core's margins, computed as the reference does per tier
    for tune, lam_v in (("hq", jax.jit(j_aq.lam_mv)(q)),
                        ("hq_noaq", jnp.asarray(
                            [np.float32(j_aq.lam_mv(i)) for i in range(52)]))):
        want = np.stack([np.asarray((lam_v * b).astype(jnp.int32))
                         for b in (16.0 / 2, 4.0 / 2, 3.0 / 2)])
        np.testing.assert_array_equal(want, t_aq.margin_tables(tune))


def test_qp_chain_equals_reference():
    rng = np.random.default_rng(4)
    qp_map = rng.integers(1, 52, (5, 9)).astype(np.int32)
    codes = rng.random((5, 9)) < 0.5
    codes[0] = False
    codes[1] = True
    for slice_qp in (1, 30):
        eff, delta = jax.jit(j_aq.qp_chain, static_argnums=2)(
            qp_map, codes, slice_qp)
        t_eff, t_delta = t_aq.qp_chain(torch.from_numpy(qp_map),
                                       torch.from_numpy(codes), slice_qp)
        np.testing.assert_array_equal(np.asarray(eff), t_eff.numpy())
        np.testing.assert_array_equal(np.asarray(delta), t_delta.numpy())


# --- the cores at both tiers --------------------------------------------

H, W = 64, 96


def _content(seed, flat=False):
    """Gradients, noise and flat panels; with ``flat`` new flat panels
    that the reference frame's noise cannot predict (I16-in-P)."""
    rng = np.random.default_rng(seed)
    y = ((np.arange(W)[None, :] * 3 + np.arange(H)[:, None]) % 256)
    y = y.astype(np.int32)
    y[:32, :48] = rng.integers(0, 256, (32, 48))
    y[32:, 48:] = 128 + rng.integers(-6, 7, (32, 48))
    cb = rng.integers(100, 160, (H // 2, W // 2))
    cr = np.clip(cb + rng.integers(-20, 20, cb.shape), 0, 255)
    if flat:
        y[:32, :48] = 90 + (np.arange(48)[None, :] // 8)
        y[40:60, 8:40] = 200
        cb[:16, :24] = 128
    return [a.astype(np.uint8) for a in (y, cb, cr)]


def _t(planes):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]


def _same(ref: dict, got: dict, what: str):
    assert sorted(ref) == sorted(got), what
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]).astype(np.int64),
                                      got[k].numpy().astype(np.int64),
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("tune,qp", [("hq_noaq", 24), ("hq", 30)])
def test_plain_intra_core_equals_reference(tune, qp):
    y, cb, cr = _content(qp)
    nxt = np.roll(y, 1, axis=1) if tune == "hq" else None
    ref = j_intra.encode_intra_frame_yuv(y, cb, cr, qp, tune=tune,
                                         next_y=nxt)
    got = t_intra.encode_intra_frame_yuv(
        *_t((y, cb, cr)), qp, tune=tune,
        next_y=None if nxt is None else torch.from_numpy(nxt))
    _same(ref, got, f"K1 {tune}")
    assert got["mb_i4"].any() and (got["pred_mode"] == 1).any()


def test_plain_intra_core_full_tier_with_a_new_qp_at_every_mb():
    """tune=hq's per-MB qp: flat MBs against noise ones in a checkerboard
    (aq and the lookahead bias move the qp at every MB)."""
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:H, 0:W]
    flat = (yy // 16 + xx // 16) % 2 == 0
    y = np.where(flat, 40 + 9 * (xx // 16) + 17 * (yy // 16),
                 rng.integers(0, 256, (H, W))).astype(np.uint8)
    cb = rng.integers(100, 160, (H // 2, W // 2)).astype(np.uint8)
    cr = np.ascontiguousarray(cb[::-1])
    nxt = np.roll(y, 1, axis=1)
    ref = j_intra.encode_intra_frame_yuv(y, cb, cr, 30, tune="hq",
                                         next_y=nxt)
    got = t_intra.encode_intra_frame_yuv(*_t((y, cb, cr)), 30, tune="hq",
                                         next_y=torch.from_numpy(nxt))
    _same(ref, got, "K1 hq, a qp per MB")
    q = got["qp_map"]
    assert (q[:, 1:] != q[:, :-1]).all()


@pytest.fixture(scope="module")
def p_cases():
    """The P core's outputs at both tiers, with and without I16-in-P, for
    the reference and the port on the same planes."""
    ref_planes = _content(5)
    cur = _content(5, flat=True)
    cur[0] = np.roll(cur[0], (1, 2), (0, 1))
    # a still panel with a little noise: the forced skip's territory
    rng = np.random.default_rng(6)
    cur[0][32:, 48:] = np.clip(ref_planes[0][32:, 48:].astype(np.int32)
                               + rng.integers(-5, 6, (32, 48)), 0, 255)
    cur[1][16:, 24:] = ref_planes[1][16:, 24:]
    cur[2][16:, 24:] = ref_planes[2][16:, 24:]
    nxt = np.roll(cur[0], 1, 1)
    out = {}
    for tune, p_intra, qp in (("hq_noaq", False, 24), ("hq", False, 24),
                              ("hq", True, 24), ("hq_noaq", True, 24)):
        n = nxt if tune == "hq" else None
        ref = j_inter.encode_p_frame(*cur, *ref_planes, qp=qp, tune=tune,
                                     next_y=n, p_intra=p_intra)
        got = t_inter.encode_p_frame(
            *_t(cur), *_t(ref_planes), qp, tune=tune, p_intra=p_intra,
            next_y=None if n is None else torch.from_numpy(n))
        out[(tune, p_intra)] = (ref, got, qp)
    out["off"] = t_inter.encode_p_frame(*_t(cur), *_t(ref_planes), 24)
    return out


@pytest.mark.parametrize("tune,p_intra", [("hq_noaq", False),
                                          ("hq", False), ("hq", True),
                                          ("hq_noaq", True)])
def test_plain_p_core_equals_reference(p_cases, tune, p_intra):
    ref, got, _ = p_cases[(tune, p_intra)]
    _same(ref, got, f"K5 {tune} p_intra={p_intra}")
    if p_intra:
        assert got["mb_intra"].any()              # I16-in-P fired
        assert (got["mv"][got["mb_intra"]] == 0).all()
    # the forced skip fired: a zero-MV MB the off tier codes is skipped
    off = p_cases["off"]
    coded = lambda o: torch.stack([(o[k] != 0).flatten(2).any(-1) for k in
                                   ("luma", "cb_dc", "cb_ac", "cr_dc",
                                    "cr_ac")]).any(0)
    zero_off = (off["mv"] == 0).all(-1) & coded(off)
    assert (zero_off & (got["mv"] == 0).all(-1) & ~coded(got)).any()


def test_intra_slots_with_the_qp_chain_equal_reference():
    y, cb, cr = _content(7)
    qp = 28
    lv = t_intra.encode_intra_frame_yuv(*_t((y, cb, cr)), qp, tune="hq")
    jl = {k: jnp.asarray(v.numpy()) for k, v in lv.items()
          if not k.startswith("recon")}
    want = jax.jit(j_cd.frame_block_slots, static_argnums=1)(jl, qp)
    got = t_cd.frame_block_slots(lv, qp)
    assert len(got) == 5
    for i, (a, b) in enumerate(zip(want[:4], got[:4])):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int64) & 0xFFFFFFFF,
            b.numpy().astype(np.int64) & 0xFFFFFFFF, err_msg=str(i))
    assert int(np.asarray(want[4])) == int(got[4])
    hv, hl = t_cd.slice_header_slots(H // 16, W // 16, frame_num=0,
                                     qp_delta=qp - 26)
    flat = t_bm.pack_frame(*got[:4], torch.from_numpy(hv.view(np.int32)),
                           torch.from_numpy(hl), qp_sum=got[4]).numpy()
    jflat, _ = jax.jit(j_cd.pack_frame)(*want[:4], hv, hl, qp_sum=want[4])
    np.testing.assert_array_equal(np.asarray(jflat), flat)
    assert t_cd.FlatMeta(flat, H // 16).qp_sum == int(got[4]) > 0


@pytest.mark.parametrize("tune,p_intra", [("hq", True), ("hq", False),
                                          ("hq_noaq", True)])
def test_p_slots_with_qp_chain_and_i16_blocks_equal_reference(
        p_cases, tune, p_intra):
    _, got, qp = p_cases[(tune, p_intra)]
    jout = {k: jnp.asarray(v.numpy()) for k, v in got.items()}
    hv, hl = t_cd.slice_header_slots(H // 16, W // 16, frame_num=3,
                                     qp_delta=0, slice_type=5, idr=False)
    jflat = np.asarray(jax.jit(j_cp._finish_p, static_argnames="slice_qp")(
        jout, hv, hl, slice_qp=qp)[0])
    slots = t_cp.p_frame_slots(got, qp)
    assert slots[0].shape[2] == (27 if p_intra else 26)
    assert len(slots) == (8 if tune == "hq" else 7)
    flat = t_bm.pack_p_frame(
        *slots[:6], torch.from_numpy(hv.view(np.int32)), torch.from_numpy(hl),
        qp_sum=slots[7] if len(slots) > 7 else None).numpy()
    np.testing.assert_array_equal(jflat, flat)
    # the slot tensors themselves, against the reference's slot coders
    v, ln, cbp, _ = jax.jit(j_cp.p_frame_block_slots)(jout)
    np.testing.assert_array_equal(np.asarray(v).astype(np.int64)
                                  & 0xFFFFFFFF,
                                  slots[0].numpy().astype(np.int64)
                                  & 0xFFFFFFFF)
    np.testing.assert_array_equal(np.asarray(ln), slots[1].numpy())
