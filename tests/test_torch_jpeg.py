"""The JPEG device programs of the port against the reference: the plain
transform (K16a) to the float contract, the plain histograms (K16b) and
pack (K16c) exactly on the reference's levels, ``pack_bits``, the host's
trim and stuffing, and the Huffman table copy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from docker_nvidia_glx_desktop_tpu.bitstream import jpeg_huffman as j_jh
from docker_nvidia_glx_desktop_tpu.models import mjpeg as j_mjpeg
from docker_nvidia_glx_desktop_tpu.ops import bitpack as j_bitpack
from docker_nvidia_glx_desktop_tpu.ops import color as j_color
from docker_nvidia_glx_desktop_tpu.ops import dct as j_dct
from docker_nvidia_glx_desktop_tpu.ops import jpeg_device as j_jd
from docker_nvidia_glx_desktop_tpu_torch.bitstream import jpeg_huffman as t_jh
from docker_nvidia_glx_desktop_tpu_torch.models import mjpeg as t_mjpeg
from docker_nvidia_glx_desktop_tpu_torch.ops import bitpack as t_bitpack
from docker_nvidia_glx_desktop_tpu_torch.ops import color as t_color
from docker_nvidia_glx_desktop_tpu_torch.ops import dct as t_dct
from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as t_jd
from docker_nvidia_glx_desktop_tpu_torch.ops import quant as t_quant

# The contract: |coefficient - reference's| <= 1e-4 + 4 float32 ulps of
# the coefficient.  The reference sums in float32 in the compiler's order;
# a DC near +-1000 (dark or bright flat blocks) has a float32 ulp of 6.1e-5
# and the reference's sum errs there by a few of them, so a bare 1e-4
# holds only for coefficients below ~256.
COEF_TOL = 1e-4
COEF_ULPS = 4
TIE_TOL = 1e-4       # levels may differ (by 1) only this near a half-integer
SIZES = [(48, 64), (50, 70), (160, 192)]


def frames(h, w, seed):
    """Noise, a smooth gradient with glyph strokes, and a flat frame."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w, 1)], -1).astype(np.uint8)
    grad[h // 4:h // 2:3, 5:w - 5:2] = rng.integers(0, 60)
    flat = np.full((h, w, 3), 200, np.uint8)
    return [noise, grad, flat]


def _planes_ref(rgb, pad_h, pad_w):
    h, w = rgb.shape[:2]
    p = np.pad(rgb, ((0, pad_h - h), (0, pad_w - w), (0, 0)), mode="edge")
    return [np.asarray(a) for a in j_color.rgb_to_yuv420(p, matrix="full")], p


@pytest.mark.parametrize("h,w", SIZES)
def test_transform_plain_meets_the_float_contract(h, w):
    """Coefficients within 1e-4 (plus 4 float32 ulps) of the reference's
    (its colour and einsum DCT); levels equal except where the reference's c/q lies
    within 1e-4 of a half-integer, and there they differ by exactly 1;
    the whole transform stage's levels likewise, in the MCU layout."""
    pad_h, pad_w = -(-h // 16) * 16, -(-w // 16) * 16
    lq, cq = t_quant.jpeg_quality_tables(85)
    for seed, rgb in enumerate(frames(h, w, 7)):
        (jy, jcb, jcr), padded = _planes_ref(rgb, pad_h, pad_w)
        ty, tcb, tcr = t_color.rgb_to_yuv420_full(torch.from_numpy(padded))
        ties = []
        for jp, tp, q in ((jy, ty, lq), (jcb, tcb, cq), (jcr, tcr, cq)):
            want = np.asarray(j_dct.dct8x8(j_dct.to_blocks(jp - 128.0, 8, 8)))
            got = t_dct.dct8x8(t_dct.to_blocks(tp - 128.0, 8, 8)).numpy()
            tol = COEF_TOL + COEF_ULPS * np.spacing(np.abs(want))
            assert (np.abs(got - want) <= tol).all()
            ratio = want / q.astype(np.float32)
            lev_ref = np.round(ratio).astype(np.int32)
            lev = t_quant.jpeg_quantize(torch.from_numpy(got), q).numpy()
            tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < TIE_TOL
            assert (lev[~tie] == lev_ref[~tie]).all()
            assert (np.abs(lev - lev_ref)[tie] <= 1).all()
            ties.append(int(tie.sum()))
        want = j_mjpeg._transform_stage(
            jnp.asarray(rgb), jnp.asarray(lq, jnp.float32),
            jnp.asarray(cq, jnp.float32), pad_h, pad_w)
        got = t_jd.jpeg_transform(torch.from_numpy(rgb)[None], lq, cq,
                                  pad_h, pad_w)
        ndiff = sum(int((np.asarray(a) != b[0].numpy()).sum())
                    for a, b in zip(want, got))
        assert ndiff <= sum(ties), (seed, ndiff, ties)
        for a, b in zip(want, got):
            assert np.abs(np.asarray(a) - b[0].numpy()).max() <= 1


def test_full_range_colour_is_the_reference_rounded():
    """The float64 planes round to the reference's float32 planes to
    within the reference's own rounding (a few float32 ulps)."""
    rgb = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    want = [np.asarray(a) for a in j_color.rgb_to_yuv420(rgb, "full")]
    got = t_color.rgb_to_yuv420_full(torch.from_numpy(rgb))
    for a, b in zip(want, got):
        assert np.abs(a - b.numpy()).max() < 4e-5


def crafted_levels(nmcu, seed):
    """Levels of nmcu MCUs covering: DC differences of every size to 11,
    AC amplitudes of every size to 10, gaps needing 1, 2 and 3 ZRLs,
    all-zero blocks, a nonzero at position 63 (no EOB), and noise."""
    rng = np.random.default_rng(seed)
    nblk = nmcu * 6
    blocks = np.zeros((nblk, 64), np.int32)
    dc = 0
    for b in range(nblk):
        kind = b % 9
        size = b % 12
        dc = int(np.clip(dc + rng.choice([-1, 1]) * ((1 << size) - 1 if size
                                                     else 0), -1023, 1023))
        blocks[b, 0] = dc
        if kind == 1:
            blocks[b, 17] = 5                        # one ZRL before it
        elif kind == 2:
            blocks[b, 1] = -3
            blocks[b, 34] = 1                        # two ZRLs
        elif kind == 3:
            blocks[b, 49] = -700                     # three ZRLs, size 10
        elif kind == 4:
            blocks[b, 63] = 1                        # no EOB
            blocks[b, 1:63:7] = rng.integers(-40, 40, 9)
        elif kind == 5:
            blocks[b, 1:64] = rng.integers(-1023, 1024, 63)
        elif kind == 6:
            amp = [(1 << s) - 1 for s in range(1, 11)]
            blocks[b, 1:11] = np.array(amp) * rng.choice([-1, 1], 10)
        elif kind == 7:
            blocks[b, 0] = 0                         # all zero
        elif kind == 8:
            blocks[b, 1:64] = rng.integers(-2, 3, 63) * (rng.random(63) < .3)
    y = blocks.reshape(nmcu, 6, 64)
    return (np.ascontiguousarray(y[:, :4]), np.ascontiguousarray(y[:, 4]),
            np.ascontiguousarray(y[:, 5]))


def _ref_entropy(y, cb, cr, smooth):
    yf = jnp.asarray(y.reshape(-1, 64))
    hists = [np.asarray(a) for a in j_jd.jpeg_analyze(yf, jnp.asarray(cb),
                                                      jnp.asarray(cr))]
    tables = t_mjpeg._tables_from_hists(hists, smooth)
    arrays = t_jd.dense_tables(tables)
    packed, total = j_jd.jpeg_pack(yf, jnp.asarray(cb), jnp.asarray(cr),
                                   *[jnp.asarray(a) for a in arrays])
    n = (int(total) + 7) // 8
    return hists, arrays, np.asarray(packed)[:n], int(total)


@pytest.mark.parametrize("nmcu,seed,smooth", [(1, 0, False), (1, 1, True),
                                              (7, 2, False), (40, 3, True),
                                              (40, 4, False)])
def test_histograms_and_pack_equal_the_reference_on_its_levels(nmcu, seed,
                                                               smooth):
    y, cb, cr = crafted_levels(nmcu, seed)
    hists, arrays, want, total = _ref_entropy(y, cb, cr, smooth)
    args = [torch.from_numpy(a)[None] for a in (y, cb, cr)]
    got = t_jd.split_hists(t_jd.jpeg_analyze(*args))
    for a, b in zip(hists, got):
        np.testing.assert_array_equal(a, b[0].numpy())
    packed, totals = t_jd.jpeg_pack(*args, t_jd.table_tensor(arrays, "cpu"))
    assert packed.shape == (1, 1, 4 * t_jd.shard_words(nmcu * 6))
    assert int(totals[0, 0]) == total
    (strip,), = t_jd.strip_bytes(packed, totals)
    np.testing.assert_array_equal(strip[0], want)
    assert strip[1] == total


def test_dc_and_ac_sizes_cover_the_baseline_range():
    y, cb, cr = crafted_levels(40, 3)
    args = [torch.from_numpy(a)[None] for a in (y, cb, cr)]
    dc_y, ac_y, dc_c, ac_c = [h[0].numpy() for h in
                              t_jd.split_hists(t_jd.jpeg_analyze(*args))]
    assert (dc_y + dc_c)[11] > 0 and (dc_y + dc_c)[12:].sum() == 0
    sizes = {s & 15 for s in np.nonzero(ac_y + ac_c)[0]}
    assert set(range(1, 11)) <= sizes and ac_y[0xF0] + ac_c[0xF0] >= 3


def test_restart_strips_reset_the_dc_predictors():
    """Strips of a session: the histograms of the whole equal the sum of
    each strip's alone, and each strip packs as a frame of its own."""
    y, cb, cr = crafted_levels(12, 5)
    args = [torch.from_numpy(a)[None] for a in (y, cb, cr)]
    whole = t_jd.jpeg_analyze(*args, nx=3)
    alone = sum(t_jd.jpeg_analyze(*[a[:, 4 * k:4 * k + 4] for a in args])
                for k in range(3))
    assert torch.equal(whole, alone)
    _, arrays, _, _ = _ref_entropy(y, cb, cr, True)
    tab = t_jd.table_tensor(arrays, "cpu")
    packed, totals = t_jd.jpeg_pack(*args, tab, nx=3)
    strips = t_jd.strip_bytes(packed, totals)[0]
    for k in range(3):
        p, t = t_jd.jpeg_pack(*[a[:, 4 * k:4 * k + 4] for a in args], tab)
        assert int(t[0, 0]) == strips[k][1]
        assert p[0, 0, :len(strips[k][0])].numpy().tobytes() == \
            strips[k][0].tobytes()


def test_pack_bits_with_straddling_words():
    rng = np.random.default_rng(2)
    n = 3000
    lens = rng.integers(0, 33, n).astype(np.int32)
    lens[::7] = 32
    lens[5::11] = 0
    vals = np.array([rng.integers(0, 1 << int(ln)) if ln else 0
                     for ln in lens], np.uint64).astype(np.uint32)
    want, total = j_bitpack.pack_bits(jnp.asarray(vals), jnp.asarray(lens))
    got, gtotal = t_bitpack.pack_bits(torch.from_numpy(vals.astype(np.int64)),
                                      torch.from_numpy(lens))
    assert int(gtotal) == int(total)
    straddles = ((np.cumsum(lens) - lens) % 32 + lens > 32).sum()
    assert straddles > 100
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nbits", [0, 1, 7, 8, 9, 64, 203])
def test_finalize_and_stuffing_equal_the_reference(nbits):
    rng = np.random.default_rng(nbits)
    packed = rng.integers(0, 256, 40).astype(np.uint8)
    packed[::5] = 0xFF
    want = j_bitpack.finalize_bytes(packed, nbits, pad_bit=1)
    got = t_bitpack.finalize_bytes(torch.from_numpy(packed), nbits, pad_bit=1)
    assert got == want
    assert t_bitpack.jpeg_stuff_bytes(got) == j_bitpack.jpeg_stuff_bytes(want)


@pytest.mark.parametrize("kind", ["random", "zeros", "single", "skewed",
                                  "uniform"])
def test_huffman_copy_equals_the_reference(kind):
    rng = np.random.default_rng(11)
    freqs = {"random": rng.integers(0, 5000, 256),
             "zeros": np.zeros(12, np.int64),
             "single": np.eye(1, 12, 5, dtype=np.int64)[0] * 9,
             "skewed": (2.0 ** np.arange(40)).astype(np.int64)[::-1],
             "uniform": np.ones(256, np.int64)}[kind]
    a, b = j_jh.HuffmanTable(freqs), t_jh.HuffmanTable(freqs)
    for f in ("codes", "lengths", "bits", "huffval"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.dht_payload(1, 0) == b.dht_payload(1, 0)
    c = t_jh.HuffmanTable.from_fields(a.codes, a.lengths, a.bits, a.huffval)
    assert c.dht_payload(0, 1) == a.dht_payload(0, 1)
    if kind == "skewed":
        assert b.lengths.max() == 16


def test_frame_symbols_copy_equals_the_reference():
    y, cb, cr = crafted_levels(9, 6)
    comps = [y.reshape(-1, 64), cb, cr]
    ws, wdc, wac = j_jh.frame_symbols(comps, [0, 1, 1])
    gs, gdc, gac = t_jh.frame_symbols(comps, [0, 1, 1])
    assert ws == gs
    for a, b in zip(wdc + wac, gdc + gac):
        np.testing.assert_array_equal(a, b)
