"""NumPy models of the work split of K16a (the JPEG transform,
``csrc/jpeg.cu`` ``transform_kernel``) and of K14d's reduction (the SSE,
``csrc/aq.cu`` ``sse_kernel``), against the plain versions; the kernel's
float64 constants against the Python tables they stand for.

K16a: a CTA a tile of ``MT`` MCUs of one MCU row, luma threads a pixel
half line, chroma threads a Cb or Cr row, every thread a block column,
then the tile's levels out as 16-byte words; the quotient by the quant
step as a double product by the step's reciprocal, rounded to float32.  The model holds that every
pixel, row, column and output level of every shape is taken exactly once,
that the aligned-word loads give the frame's bytes at every alignment,
that every half-warp's 8-byte shared access hits 16 distinct bank pairs,
and that the product quotient is the IEEE float32 divide's.  K14d: a grid of at most ``SSE_CTAS_PER_SM`` CTAs an SM, ``SSE_U``
16-byte loads of each plane a thread, 32-bit batch sums, a CTA's partial
and arrival in one atomic add to one word, the last CTA to arrive writing
the sum and zeroing the word.  The tile and grid constants are read from
the sources."""

import math
import os
import re

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu_torch.ops import aq, color, dct, scan
from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "docker_nvidia_glx_desktop_tpu_torch", "csrc")


def cu_ints(name: str, keys) -> dict:
    """The ``constexpr int`` values of ``csrc/<name>.cu``, evaluated in
    the order they are declared (an expression may use earlier ones)."""
    text = open(os.path.join(CSRC, f"{name}.cu")).read()
    vals = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            k, expr = (p.strip() for p in part.split("=", 1))
            vals[k] = eval(expr, {}, dict(vals))
    return {k: vals[k] for k in keys}


def cu_array(name: str, var: str) -> list:
    """The initialiser of array ``var`` in ``csrc/<name>.cu`` as floats."""
    text = open(os.path.join(CSRC, f"{name}.cu")).read()
    body = re.search(var + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    vals = []
    for tok in re.sub(r"//[^\n]*", "", body).split(","):
        tok = tok.strip()
        if tok:
            vals.append(float.fromhex(tok) if "0x" in tok else float(tok))
    return vals


K = cu_ints("jpeg", ("MT", "NL", "NT", "RP", "RM", "RC", "TI", "TB", "TM", "LB"))
S = cu_ints("aq", ("SSE_NT", "SSE_U", "SSE_CTAS_PER_SM", "SSE_MAX_CTAS", "SUM_BITS"))
SMS = 132                               # the H100's SMs (the launcher asks the card)
SHAPES = [(1080, 1920), (2160, 3840), (1079, 1919), (16, 16), (17, 33)]


# -- K16a ----------------------------------------------------------------------

def tile_roles(nm: int) -> dict:
    """What each thread of a tile with ``nm`` MCUs in the frame takes, as
    the kernel's index arithmetic gives it."""
    mt, nl, nt = K["MT"], K["NL"], K["NT"]
    t = np.arange(nl)
    line, m, hf = t // (2 * mt), (t >> 1) % mt, t & 1
    luma = [(int(a), int(b), int(c)) for a, b, c in zip(m, line, hf) if a < nm]
    c = np.arange(nt - nl)
    cm, pl, ci = c >> 4, (c >> 3) & 1, c & 7
    chroma = [(int(a), int(b), int(d)) for a, b, d in zip(cm, pl, ci) if a < nm]
    t = np.arange(nt)
    km, kb, kv = t // 48, (t >> 3) % 6, t & 7
    cols = [(int(a), int(b), int(d)) for a, b, d in zip(km, kb, kv) if a < nm]
    words = []
    for tid in range(nt):
        for wd in range(tid, nm * 96, nt):
            if wd < nm * 64:
                words.append((wd >> 6, (wd >> 4) & 3, 4 * (wd & 15)))
            else:
                w2 = wd - nm * 64
                p = int(w2 >= nm * 16)
                w3 = w2 - p * nm * 16
                words.append((w3 >> 4, 4 + p, 4 * (w3 & 15)))
    return {"luma": luma, "chroma": chroma, "cols": cols, "words": words}


@pytest.mark.parametrize("nm", range(1, K["MT"] + 1))
def test_a_tile_takes_every_pixel_row_column_and_level_once(nm):
    r = tile_roles(nm)
    # luma: (MCU, line, half) -> 8 pixels of its line
    px = [(m, line, 8 * hf + k) for m, line, hf in r["luma"] for k in range(8)]
    assert sorted(px) == [(m, y, x) for m in range(nm) for y in range(16) for x in range(16)]
    # the row pass: luma rows (block (line >> 3) * 2 + half, row line & 7), chroma rows
    rows = [(m, (line >> 3) * 2 + hf, line & 7) for m, line, hf in r["luma"]]
    rows += [(m, 4 + pl, i) for m, pl, i in r["chroma"]]
    assert sorted(rows) == [(m, b, i) for m in range(nm) for b in range(6) for i in range(8)]
    # a chroma row reads lines 2i, 2i + 1 of its plane: every Cb / Cr sample once
    reads = [(m, pl, 2 * i + d, x) for m, pl, i in r["chroma"] for d in (0, 1)
             for x in range(16)]
    assert sorted(reads) == [(m, p, y, x) for m in range(nm) for p in (0, 1)
                             for y in range(16) for x in range(16)]
    # the column pass: block column v, levels u * 8 + v in natural order
    lev = [(m, b, u * 8 + v) for m, b, v in r["cols"] for u in range(8)]
    assert sorted(lev) == [(m, b, n) for m in range(nm) for b in range(6) for n in range(64)]
    # the stores: every zigzag position of every block once, 4 a word
    out = [(m, b, z + k) for m, b, z in r["words"] for k in range(4)]
    assert sorted(out) == [(m, b, z) for m in range(nm) for b in range(6) for z in range(64)]


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("h,w", SHAPES)
def test_the_grid_covers_every_output_level_once(h, w, s):
    """The tiles of a row (the last one ragged where the MCU count is no
    multiple of MT) and the rows and sessions of the grid put every level
    of y (S, nmcu, 4, 64), cb and cr (S, nmcu, 64) in exactly one word."""
    mt = K["MT"]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    nmx, nmy = pw // 16, ph // 16
    nmcu = nmx * nmy
    roles = {nm: tile_roles(nm)["words"] for nm in range(1, mt + 1)}
    y_idx, c_idx = [], []
    for bx in range(-(-nmx // mt)):        # one MCU row, relative to its first MCU
        nm = min(mt, nmx - bx * mt)
        for m, b, z in roles[nm]:
            mcu = bx * mt + m
            for k in range(4):
                if b < 4:
                    y_idx.append((mcu * 4 + b) * 64 + z + k)
                else:
                    c_idx.append((b - 4) * nmx * 64 + mcu * 64 + z + k)
    assert np.array_equal(np.sort(y_idx), np.arange(nmx * 256))
    assert np.array_equal(np.sort(c_idx), np.arange(2 * nmx * 64))
    # rows and sessions: the kernel's base (s * nmcu + my * nmx) a row, disjoint
    bases = np.array([si * nmcu + my * nmx for si in range(s) for my in range(nmy)])
    assert np.array_equal(np.sort(bases), np.arange(0, s * nmcu, nmx))
    # the levels match the plain version's layout: a session's MCUs in raster order
    rgbs = torch.zeros((s, h, w, 3), dtype=torch.uint8)
    if h * w <= 33 * 17:
        yz, cb, cr = jd.jpeg_transform_plain(rgbs, np.ones((8, 8)), np.ones((8, 8)), ph, pw)
        assert yz.shape == (s, nmcu, 4, 64) and cb.shape == cr.shape == (s, nmcu, 64)


def funnel_r(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> (sh & 31)) & 0xFFFFFFFF


@pytest.mark.parametrize("w", [1919, 1920, 17, 33])
def test_the_aligned_word_loads_give_the_half_lines_bytes(w):
    """A half line inside the frame: six (seven when the start is not
    word aligned) aligned 32-bit words joined by funnel shifts give its 24
    bytes; a half line that passes the right edge is read pixel by pixel
    with the columns clamped, as the plain version's edge pad."""
    rng = np.random.default_rng(w)
    rows = 3
    buf = rng.integers(0, 256, rows * w * 3 + 8, dtype=np.uint8)
    for lead in range(4):                  # the frame's first byte at each alignment
        frame = buf[lead:lead + rows * w * 3].reshape(rows, w, 3)
        for sy in range(rows):
            for x0 in range(0, -(-w // 8) * 8, 8):
                if x0 + 8 <= w:
                    p = lead + (sy * w + x0) * 3
                    base, sh = p - (p & 3), 8 * (p & 3)
                    wd = [int.from_bytes(buf[base + 4 * i:base + 4 * i + 4].tobytes(), "little")
                          for i in range(6)]
                    wd.append(int.from_bytes(buf[base + 24:base + 28].tobytes(), "little")
                              if sh else 0)
                    got = b"".join(funnel_r(wd[i], wd[i + 1], sh).to_bytes(4, "little")
                                   for i in range(6))
                    assert got == frame[sy, x0:x0 + 8].tobytes()
                    assert base + 4 * (7 if sh else 6) <= p + 24 + 3
                else:
                    cols = np.minimum(np.arange(x0, x0 + 8), w - 1)
                    pad = np.pad(frame, ((0, 0), (0, 8), (0, 0)), mode="edge")
                    assert np.array_equal(frame[sy, cols], pad[sy, x0:x0 + 8])


def half_warp_units(addr) -> bool:
    """True when 16 8-byte accesses (double indices) hit 16 distinct bank
    pairs."""
    return len({a % 16 for a in addr}) == len(addr) == 16


@pytest.mark.parametrize("access", ["craw_write", "craw_read", "tmp_write_luma",
                                    "tmp_write_chroma", "tmp_read"])
def test_every_half_warp_hits_distinct_bank_pairs(access):
    mt, nl, nt = K["MT"], K["NL"], K["NT"]
    rp, rm, rc, ti, tb, tm = (K[k] for k in ("RP", "RM", "RC", "TI", "TB", "TM"))
    if access in ("craw_write", "tmp_write_luma"):
        lanes = range(0, nl)
    elif access in ("craw_read", "tmp_write_chroma"):
        lanes = range(nl, nt)
    else:
        lanes = range(0, nt)
    lanes = list(lanes)
    for h0 in range(0, len(lanes), 16):
        half = lanes[h0:h0 + 16]
        for k in range(8):                 # each compile-time index of the access
            addr = []
            for t in half:
                if access in ("craw_write", "tmp_write_luma"):
                    line, m, hf = t // (2 * mt), (t >> 1) % mt, t & 1
                    if access == "craw_write":
                        addr.append(m * rm + line * rp + 8 * hf + k)
                    else:
                        addr.append(m * tm + ((line >> 3) * 2 + hf) * tb + (line & 7) * ti + k)
                elif access in ("craw_read", "tmp_write_chroma"):
                    c = t - nl
                    m, pl, i = c >> 4, (c >> 3) & 1, c & 7
                    if access == "craw_read":
                        addr.append(pl * rc + m * rm + 2 * i * rp + 2 * k)
                    else:
                        addr.append(m * tm + (4 + pl) * tb + i * ti + k)
                else:
                    m, b, v = t // 48, (t >> 3) % 6, t & 7
                    addr.append(m * tm + b * tb + v + k * ti)
            assert half_warp_units(addr), (access, h0, k, sorted(a % 16 for a in addr))


def kernel_levels(c32: np.ndarray, q32: np.ndarray):
    """K16a's quotient and level: RN32(RN64(c * RN64(1 / q))), then round
    half to even."""
    y = (c32.astype(np.float64) * (1.0 / q32.astype(np.float64))).astype(np.float32)
    return y, np.rint(y)


def test_the_product_quotient_is_the_float32_divide():
    """On coefficients of every magnitude, zeros, the quality tables' steps
    and random ones, exact and near half-integer quotients (c = q (k + 1/2)
    rounded, q = 2|c| and 2|c| / 3) and coefficients next to a float32
    midpoint of their quotient: the same float32 quotient as the divide,
    hence the same level."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import quant

    rng = np.random.default_rng(19)
    steps = np.concatenate([np.concatenate([np.ravel(t) for t in quant.jpeg_quality_tables(qq)])
                            for qq in (1, 10, 50, 75, 85, 95, 100)]).astype(np.float32)
    n = 400_000
    q = np.concatenate([rng.choice(steps, n),
                        (2.0 ** rng.uniform(-14, 8, n)).astype(np.float32)])
    mag = 2.0 ** rng.uniform(-40, 12, 2 * n)
    c = (rng.choice([-1.0, 1.0], 2 * n) * mag).astype(np.float32)
    c[::97] = 0
    k = rng.integers(-2048, 2048, 2 * n)
    near = (q.astype(np.float64) * (k + 0.5)).astype(np.float32)          # c / q near k + 1/2
    tie_q = np.concatenate([2 * np.abs(c[1::2]), (2 * np.abs(c[1::2]) / 3).astype(np.float32)])
    tie_c = np.concatenate([c[1::2], c[1::2]])
    ok = (tie_q > 2.0 ** -14) & np.isfinite(tie_q)
    # midpoints of float32 neighbours next to k + 1/2, times q, rounded: c / q
    # within an ulp or two of the midpoint
    h = (k + 0.5).astype(np.float32)
    mid = (h.astype(np.float64) + np.spacing(h).astype(np.float64) / 2)
    at_mid = (q.astype(np.float64) * mid).astype(np.float32)
    cs = np.concatenate([c, near, tie_c[ok], at_mid, np.nextafter(at_mid, np.float32(np.inf))])
    qs = np.concatenate([q, q, tie_q[ok], q, q]).astype(np.float32)
    with np.errstate(over="ignore"):
        want = cs / qs
    got, lev = kernel_levels(cs, qs)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(lev, np.rint(want))
    assert (np.abs(np.abs(want[2 * n:4 * n] % 1) - 0.5) < 1e-3).mean() > 0.5   # near ties


def test_the_kernels_constants_are_the_python_tables_widened():
    assert np.array_equal(np.array(cu_array("jpeg", "c_dct")),
                          dct.DCT8.astype(np.float64).ravel())
    assert np.array_equal(np.array(cu_array("jpeg", "c_mat")),
                          color._M_FULL.astype(np.float64).ravel())
    assert np.array_equal(np.array(cu_array("jpeg", "c_off")),
                          color.OFF_FULL.astype(np.float64))
    assert np.array_equal(np.array(cu_array("jpeg", "g_nat"), np.int64),
                          np.asarray(scan.ZIGZAG8, np.int64))


def test_consts_upload_the_quant_tables_only():
    lq = np.arange(1, 65, dtype=np.float32).reshape(8, 8) * 1.5
    cq = np.arange(64, 0, -1).astype(np.float32).reshape(8, 8)
    t = jd._consts(lq, cq, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.shape == (128,)
    assert np.array_equal(t.numpy(), np.concatenate([lq.ravel(), cq.ravel()]))


# -- K14d ----------------------------------------------------------------------

def sse_grid(n: int, vec: bool) -> int:
    """The launcher's CTA count (``sse_launch``)."""
    nvec = n // 16 if vec else 0
    work = -(-nvec // S["SSE_U"]) if vec else n
    cap = min(S["SSE_MAX_CTAS"], SMS * S["SSE_CTAS_PER_SM"])
    return max(1, min(-(-work // S["SSE_NT"]), cap))


def arrive(partials, word: int, rng) -> tuple:
    """The CTAs' single atomicAdd each, in a random order, of ``partial +
    2^SUM_BITS`` to the accumulator word: (the sum the CTA that finds every
    other CTA arrived writes, the word after the launch, that CTA zeroing
    it)."""
    ctas, bits = len(partials), S["SUM_BITS"]
    out = []
    for c in rng.permutation(ctas):
        old = word
        word = (word + int(partials[c]) + (1 << bits)) % (1 << 64)
        if old >> bits == ctas - 1:
            out.append((old & ((1 << bits) - 1)) + int(partials[c]))
            word = 0
    assert len(out) == 1
    return out[0], word


def sse_model(a: np.ndarray, b: np.ndarray, vec: bool, rng) -> int:
    """K14d's partials and ticket: each thread's 32-bit batch sums (each
    under 2^32) widened into its sum, a CTA's threads into its slot, the
    last CTA's sum of the slots."""
    n = a.size
    nt, u = S["SSE_NT"], S["SSE_U"]
    ctas = sse_grid(n, vec)
    stride = ctas * nt
    nvec = n // 16 if vec else 0
    d = a.astype(np.int64) - b.astype(np.int64)
    sq = d * d
    thread = np.zeros(stride, np.int64)
    if nvec:
        v = np.arange(nvec)
        per_vec = sq[:nvec * 16].reshape(nvec, 16).sum(1)
        key = (v // (u * stride)) * stride + v % stride      # (batch, thread)
        batch = np.bincount(key, weights=per_vec.astype(np.float64), minlength=1)
        assert batch.max(initial=0) < 2 ** 32
        thread += np.bincount(v % stride, per_vec, minlength=stride).astype(np.int64)
    k = np.arange(nvec * 16, n)
    thread += np.bincount((k - nvec * 16) % stride, sq[nvec * 16:],
                          minlength=stride).astype(np.int64)
    total, after = arrive(thread.reshape(ctas, nt).sum(1), 0, rng)
    assert after == 0
    return total


@pytest.mark.parametrize("n,off", [(0, 0), (1, 0), (15, 0), (16, 0), (17, 0), (4097, 0),
                                   (4097, 3), (1088 * 1920, 0), (1088 * 1920, 3)])
def test_partials_and_ticket_equal_the_plain_sse(n, off):
    rng = np.random.default_rng(n + off)
    a = rng.integers(0, 256, n, dtype=np.uint8)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    vec = off % 16 == 0
    want = int(aq.sse_planes_plain(torch.from_numpy(a), torch.from_numpy(b)))
    assert sse_model(a, b, vec, rng) == want
    assert int(aq.sse_planes(torch.from_numpy(a), torch.from_numpy(b))) == want


def test_the_full_scale_4k_pair_is_exact_past_int32():
    z = np.zeros(2160 * 3840, np.uint8)
    full = z + 255
    want = 2160 * 3840 * 255 ** 2
    assert want > 2 ** 31
    assert sse_model(z, full, True, np.random.default_rng(0)) == want
    assert int(aq.sse_planes_plain(torch.from_numpy(z), torch.from_numpy(full))) == want


def test_the_word_resets_for_the_next_launch():
    """Launches of different grids in a row (a graph's replays): each has
    one CTA find every other arrived, and leaves the word at 0; the largest
    grid's arrivals fit above the largest sum."""
    rng = np.random.default_rng(5)
    word = 0
    for n in (1088 * 1920, 17, 0, 2160 * 3840, 4097, 1088 * 1920):
        ctas = sse_grid(n, True)
        assert 1 <= ctas <= S["SSE_MAX_CTAS"]
        partials = rng.integers(0, 2 ** 40, ctas)
        total, word = arrive(partials, word, rng)
        assert total == int(partials.sum()) and word == 0
    assert (2 ** 31 - 1) * 255 ** 2 < 2 ** S["SUM_BITS"]
    assert S["SSE_MAX_CTAS"] <= 2 ** (64 - S["SUM_BITS"])
    assert math.ceil(1088 * 1920 / 16 / S["SSE_U"] / S["SSE_NT"]) == sse_grid(1088 * 1920, True)
