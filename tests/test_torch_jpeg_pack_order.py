"""A NumPy model of the JPEG bit pack K16c's schedule (``csrc/jpeg.cu``
``pack_seg_kernel``), held to the plain pack ``jpeg_pack_plain``: a warp
a block with lane l on zigzag positions l and l + 32 (the nonzero mask,
each nonzero's run from it, the lanes' offsets from one scan of two
16-bit halves), segments of SEGM MCUs that never cross a strip, the
decoupled look-back over a strip's segments whatever state each
predecessor has published, windows of the segment's words, the boundary
words (the last one plain-stored before the segment is DONE, the first
one ORed after the predecessor is DONE) in random orders over a buffer
of garbage, and the byte swap.  The crafted levels are
``tests/jpeg_levels.py``'s (``chip_smoke.py``'s k11k16 phase holds the
kernel to the plain pack on them too)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import _tables_from_hists
from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
from jpeg_levels import KINDS, edge_tables, k16c_levels

_SRC = (pathlib.Path(jd.__file__).parent.parent / "csrc" / "jpeg.cu").read_text()
SEGM = int(re.search(r"constexpr int SEGM = (\d+);", _SRC).group(1))
WIN_WORDS = int(re.search(r"constexpr int WIN_WORDS = (\d+);", _SRC).group(1))
OFF = np.cumsum((0,) + jd.TABLE_SIZES)        # dc_l, ac_l, dc_c, ac_c
AGG, INCL = 1, 2


def _bit_length(v):
    v = np.abs(v.astype(np.int64))
    out = np.zeros(v.shape, np.int64)
    while (v >> out).any():
        out += (v >> out) > 0
    return out


def _amplitude(v, size):
    v = v.astype(np.int64)
    return np.where(v >= 0, v, v + (1 << size) - 1) & ((1 << size) - 1)


def block_items(zz, prev_dc, luma, codes, lens):
    """One warp's work on blocks ``zz`` (n, 64): per zigzag position its
    ZRL count, value and length (position 0: the DC difference), the EOB
    length, each position's bit offset in its block as the lanes' scan
    gives it, and each block's bits."""
    n = zz.shape[0]
    dc_t, ac_t = (OFF[0], OFF[1]) if luma else (OFF[2], OFF[3])
    pos = np.arange(64)
    ac = zz != 0
    ac[:, 0] = False
    last_nz = np.maximum.accumulate(np.where(ac, pos, 0), axis=1)
    prev = np.concatenate([np.zeros((n, 1), np.int64), last_nz[:, :-1]], axis=1)
    run = pos - prev - 1
    size = _bit_length(zz)
    sym = (((run & 15) << 4) | size) & 0xFF
    zrl = np.where(ac, run >> 4, 0)
    val = np.where(ac, (codes[ac_t + sym] << size) | _amplitude(zz, size), 0)
    ln = np.where(ac, lens[ac_t + sym] + size, 0)
    diff = zz[:, 0].astype(np.int64) - prev_dc
    dsize = _bit_length(diff)
    dsym = np.minimum(dsize, 16)
    val[:, 0] = (codes[dc_t + dsym] << dsize) | _amplitude(diff, dsize)
    ln[:, 0] = lens[dc_t + dsym] + dsize
    eob = np.where(ac[:, 63], 0, lens[ac_t])
    zrl_len = lens[ac_t + 0xF0]
    bits = zrl * zrl_len + ln
    a, b = bits[:, :32], bits[:, 32:].copy()
    b[:, 31] += eob
    packed = a | (b << 16)
    assert (a.sum(1) < 1 << 16).all() and (b.sum(1) < 1 << 16).all()
    incl = np.cumsum(packed, axis=1)
    total, excl = incl[:, -1:], incl - packed
    off = np.concatenate([excl & 0xFFFF, (total & 0xFFFF) + (excl >> 16)], axis=1)
    return dict(zrl=zrl, val=val, len=ln, eob=eob, off=off, ac_t=ac_t,
                bits=((total & 0xFFFF) + (total >> 16))[:, 0])


def strip_blocks(y, cb, cr, i, mcus):
    """The blocks of session i's MCUs ``mcus`` in interleave order with
    their DC predictors (0 at the strip's first MCU) and luma flags."""
    blk = np.concatenate([y[i, mcus], cb[i, mcus, None], cr[i, mcus, None]], axis=1)
    zz = blk.reshape(-1, 64).astype(np.int64)
    prev = np.concatenate([[0], zz[:-1, 0]]).reshape(-1, 6)
    prev[:, 0] = np.concatenate([[0], zz[3::6, 0][:-1]])        # Y0 <- Y3 before
    prev[:, 4] = np.concatenate([[0], zz[4::6, 0][:-1]])        # Cb <- Cb before
    prev[:, 5] = np.concatenate([[0], zz[5::6, 0][:-1]])        # Cr <- Cr before
    return zz, prev.reshape(-1), np.tile([True] * 4 + [False] * 2, len(mcus))


def look_back(bits, i, state):
    """The kernel's walk over segments < i, 32 at a time, where segment q
    has published AGG (its bits) or INCL (the bits up to its end)."""
    incl = np.cumsum(bits)
    excl = 0
    for j in range(i - 1, -1, -32):
        q = np.arange(j, j - 32, -1)
        st = np.where(q >= 0, state[np.maximum(q, 0)], INCL)
        v = np.where(q < 0, 0, np.where(st == INCL, incl[np.maximum(q, 0)], bits[np.maximum(q, 0)]))
        hit = np.nonzero(st == INCL)[0]
        if len(hit):
            return excl + int(v[:hit[0] + 1].sum())
        excl += int(v.sum())
    return excl


def put_bits(win, p, v, ln):
    """OR each (p, v, ln) code (MSB first, up to 64 bits) into ``win``,
    dropping bits outside it, as bitsink.cuh RunSink does."""
    p, v, ln = (np.asarray(x, np.int64) for x in (p, v, ln))
    v = v & ((1 << ln) - 1)
    while (ln > 0).any():
        off = p & 31
        take = np.minimum(32 - off, ln)
        live = ln > 0
        bits = (v >> np.maximum(ln - take, 0)) & ((1 << take) - 1)
        w = p >> 5
        ok = live & (w >= 0) & (w < len(win))
        np.bitwise_or.at(win, w[ok], (bits[ok] << (32 - off[ok] - take[ok])).astype(np.uint64))
        p, ln = p + np.where(live, take, 0), ln - np.where(live, take, 0)


def segment_words(items, excl, seg_bits, win_words):
    """The segment's words as its windows build them."""
    lead = excl & 31
    nwords = (lead + seg_bits + 31) >> 5 if seg_bits else 0
    out = np.zeros(nwords, np.uint64)
    for lo in range(0, nwords, win_words):
        win = np.zeros(min(nwords - lo, win_words), np.uint64)
        for it, base in items:
            b = base + lead - 32 * lo
            p = b[:, None] + it["off"]
            zl = int(it["zrl_len"])
            for j in range(int(it["zrl"].max(initial=0))):
                m = it["zrl"] > j
                put_bits(win, (p + j * zl)[m], np.full(m.sum(), it["zrl_code"]), np.full(m.sum(), zl))
            m = it["len"] > 0
            q = p + it["zrl"] * zl
            put_bits(win, q[m], it["val"][m], it["len"][m])
            e = it["eob"] > 0
            end = q[:, 63] + it["len"][:, 63]
            put_bits(win, end[e], np.full(e.sum(), it["eob_code"]), it["eob"][e])
        out[lo:lo + len(win)] = win
    return out


def model_pack(y, cb, cr, tab, nx, seed, win_words=WIN_WORDS):
    """(strips' bytes (S, nx, 4 * shard_words) uint8, totals (S, nx)) as
    the kernel's schedule leaves them over a buffer of garbage."""
    rng = np.random.default_rng(seed)
    t = tab.numpy().astype(np.int64)
    codes, lens = t[:jd.HIST_SYMBOLS], t[jd.HIST_SYMBOLS:]
    s, nmcu = cb.shape[:2]
    mps = nmcu // nx
    nseg = -(-mps // SEGM)
    sw = jd.shard_words(mps * 6)
    words = rng.integers(0, 1 << 32, (s, nx, sw), dtype=np.uint64)
    totals = np.zeros((s, nx), np.int64)
    for i in range(s):
        for k in range(nx):
            segs = []
            for g in range(nseg):
                mcus = np.arange(k * mps + g * SEGM, min(k * mps + (g + 1) * SEGM, (k + 1) * mps))
                zz, prev, luma = strip_blocks(y, cb, cr, i, mcus)
                if g > 0:                              # predictors across the segment edge
                    before = strip_blocks(y, cb, cr, i, mcus[:1] - 1)[0]
                    prev[0], prev[4], prev[5] = before[-3, 0], before[-2, 0], before[-1, 0]
                parts, bits = [], np.zeros(len(zz), np.int64)
                for lm in (True, False):
                    sel = np.nonzero(luma == lm)[0]
                    it = block_items(zz[sel], prev[sel], lm, codes, lens)
                    it.update(zrl_len=lens[it["ac_t"] + 0xF0], zrl_code=codes[it["ac_t"] + 0xF0],
                              eob_code=codes[it["ac_t"]])
                    bits[sel] = it["bits"]
                    parts.append((it, sel))
                blk_off = np.cumsum(bits) - bits
                segs.append(([(it, blk_off[sel]) for it, sel in parts], int(bits.sum())))
            seg_bits = np.array([b for _, b in segs], np.int64)
            incl = np.cumsum(seg_bits)
            totals[i, k] = incl[-1]
            state = rng.choice([AGG, INCL], nseg)
            excl = [look_back(seg_bits, g, state) for g in range(nseg)]
            assert excl == list(incl - seg_bits)
            # stores: a segment's own words and its last word, then DONE; its
            # shared first word ORed once the predecessor is DONE
            buf = words[i, k]
            pending, done = [], [False] * nseg
            for g, (items, sb) in enumerate(segs):
                w = segment_words(items, excl[g], sb, win_words)
                pending.append(("store", g, w))
            while pending:
                ready = [e for e in pending if e[0] == "store" or done[e[1] - 1]]
                e = ready[rng.integers(len(ready))]
                pending.remove(e)
                kind, g, w = e
                w0, shared = excl[g] >> 5, (excl[g] & 31) != 0
                keep = [j for j in range(len(w)) if w0 + j < sw]
                if kind == "store":
                    own = [j for j in keep if not (j == 0 and shared)]
                    buf[[w0 + j for j in own]] = w[own]
                    if shared and keep and keep[0] == 0:
                        pending.append(("or", g, w))
                        if len(w) == 1:
                            continue                   # DONE after the OR
                    done[g] = True
                else:
                    buf[w0] |= w[0]
                    done[g] = True
    packed = words.astype(np.uint32).astype(">u4").view(np.uint8).reshape(s, nx, -1)
    return packed, totals


def _tables(kind, lv, nx):
    if kind == "edge":
        return jd.table_tensor(edge_tables(), "cpu")
    h = jd.split_hists(jd.jpeg_analyze_plain(*lv, nx))
    return jd.table_tensor(jd.dense_tables(_tables_from_hists(
        [x[0].numpy() for x in h], smooth=True)), "cpu")


def _held(lv, tab, nx, seed, **kw):
    got, tot = model_pack(*[t.numpy() for t in lv], tab, nx, seed, **kw)
    want, want_tot = jd.jpeg_pack_plain(*lv, tab, nx)
    np.testing.assert_array_equal(tot, want_tot.numpy())
    for i in range(tot.shape[0]):
        for k in range(nx):
            n = (int(tot[i, k]) + 7) // 8
            np.testing.assert_array_equal(got[i, k, :n], want[i, k, :n].numpy())


@pytest.mark.parametrize("nx", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_segment_schedule_equals_the_plain_pack(kind, nx):
    """S = 2 sessions of 40 MCUs: segments of SEGM MCUs, strips of 40,
    20 and 10 MCUs (segments that start inside strips, short last ones)."""
    lv = [torch.from_numpy(a) for a in k16c_levels(kind, 40, 2, seed=nx)]
    _held(lv, _tables(kind, lv, nx), nx, seed=nx)


@pytest.mark.parametrize("kind", ["noise", "rand"])
def test_windows_of_three_words_equal_the_plain_pack(kind):
    """A segment's words placed window by window (as where a segment
    passes WIN_WORDS), here windows of three words."""
    lv = [torch.from_numpy(a) for a in k16c_levels(kind, 24, 1, seed=5)]
    _held(lv, _tables(kind, lv, 2), 2, seed=6, win_words=3)


def test_a_1919x1079_frame_equals_the_plain_pack():
    """K16a's levels of a 1919x1079 desktop-like frame (8160 MCUs, 1020
    segments of one strip) with its own per-frame tables."""
    rng = np.random.default_rng(11)
    h, w = 1079, 1919
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1).astype(np.uint8)
    for _ in range(40):
        y0, x0 = rng.integers(0, h - 60), rng.integers(0, w - 200)
        rgb[y0:y0 + 60, x0:x0 + 200] = rng.integers(0, 256, 3)
        rgb[y0 + 20:y0 + 28, x0 + 10:x0 + 190:5] = 0
    from docker_nvidia_glx_desktop_tpu_torch.ops import quant
    lq, cq = quant.jpeg_quality_tables(85)
    lv = jd.jpeg_transform_plain(torch.from_numpy(rgb)[None], lq, cq, 1088, 1920)
    _held(lv, _tables("rand", lv, 1), 1, seed=3)
