"""Bit packers (K3, K7): a NumPy model of the kernel's schedule against the
reference's ``pack_frame`` / ``pack_p_frame`` and the port's plain
versions.

The kernel (``csrc/pack.cu``) cuts each MB row into segments of a few MBs,
a CTA each.  The model below does what each CTA does, segment by segment:

- the counts: a warp an MB, a lane a piece (MB syntax or header, then the
  blocks), the pieces' offsets by a scan, the caps' overflow by a vote;
- the look-back: each segment publishes its bits, each row's last segment
  its row's words; a segment reads the pair (words of the rows before its
  row, bits of its row before it: the slice header and the earlier
  segments).  The model also carries that pair along the stream order and
  holds the two equal;
- the segment's word buffer (in windows of the kernel's buffer size), its
  interior words stored and its two edge words OR-ed into the flat;
- the metadata: each row's last segment writes its row's two words, the
  last row's last segment the total (and the FLAT_CAP_WORDS flag), the
  first segment the qp sum.

Exact equality with the reference and with the plain version, at segment
sizes of 1, 3 and 8 MBs, shows that this schedule gives the same bytes.
The slots are ``tests/pack_slots.py``' crafted frames, the ones the
card's k3k7 phase holds the kernel to."""

import functools

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cd
from docker_nvidia_glx_desktop_tpu.ops import cavlc_p_device as j_cp
from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge as t_bm

import jax

from tests.pack_slots import K3K7_FLAT_ROWS, k3k7_slots


META_WORDS, MAX_ROWS = t_bm.META_WORDS, t_bm.MAX_META_ROWS
CAP_WORDS = t_bm.FLAT_CAP_WORDS
MB_CAP, BLOCK_CAP = t_bm.MB_CAP_BITS, t_bm.BLOCK_CAP_BITS
JAX_RC = (3, 10)                  # the one compiled reference shape per form
FORMS = {"K3": (27, False), "K7": (26, True), "K7-27": (27, True)}


def buf_words(seg: int) -> int:
    """The kernel's window: ``BUF_WORDS`` of csrc/pack.cu."""
    return seg * (MB_CAP // 32) + 6


def place(buf, lo, hi, pos, val, ln):
    """OR codewords (positions from the segment's first word, MSB first)
    into the window of words [lo, hi) held in ``buf`` (int64 words)."""
    live = ln > 0
    pos, val, ln = pos[live], val[live] & 0xFFFFFFFF, ln[live]
    w = pos >> 5
    end = (pos & 31) + ln
    cross = end > 32
    hi_part = np.where(cross, val >> np.clip(end - 32, 0, 31),
                       (val << np.clip(32 - end, 0, 31)) & 0xFFFFFFFF)
    lo_part = np.where(cross, (val << np.clip(64 - end, 0, 31)) & 0xFFFFFFFF, 0)
    for idx, part in ((w, hi_part), (w + 1, lo_part)):
        keep = (idx >= lo) & (idx < hi) & (part != 0)
        np.bitwise_or.at(buf, idx[keep] - lo, part[keep])


def model_pack(x: dict, seg: int, qp_sum=None):
    """One session's flat buffer (uint8) by csrc/pack.cu's schedule.
    ``x``: numpy slots of one session (``values``/``lengths`` (R, C, NB,
    34), ``syn_*`` (R, C, NS), ``hdr_*`` (R, 3), ``run_*`` (R,) or None).
    Returns (flat, the per-segment (words, bits) pairs)."""
    vals = x["values"].astype(np.int64) & 0xFFFFFFFF
    lens = x["lengths"].astype(np.int64)
    svals = x["syn_vals"].astype(np.int64) & 0xFFFFFFFF
    slens = x["syn_lens"].astype(np.int64)
    hvals = x["hdr_vals"].astype(np.int64) & 0xFFFFFFFF
    hlens = x["hdr_lens"].astype(np.int64)
    nr, nc, nb = lens.shape[:3]
    run_l = x.get("run_lens")
    run_l = np.zeros(nr, np.int64) if run_l is None else run_l.astype(np.int64)
    run_v = x.get("run_vals")
    run_v = np.zeros(nr, np.int64) if run_v is None else run_v.astype(np.int64) & 0xFFFFFFFF
    nseg = -(-nc // seg)
    meta = np.zeros(META_WORDS, np.int64)          # the memset
    words = np.zeros(CAP_WORDS, np.int64)
    owned = np.zeros(CAP_WORDS, bool)              # stored by one segment only
    seg_pub = np.full((nr, nseg), -1)
    row_pub = np.full(nr, -1)
    counts = {}

    # pass 1, every CTA: counts, then the segment's bits published
    for r in range(nr):
        for s in range(nseg):
            c0, c1 = s * seg, min(nc, s * seg + seg)
            piece = np.concatenate([slens[r, c0:c1].sum(-1)[:, None],
                                    lens[r, c0:c1].sum(-1)], axis=1)
            poff = np.cumsum(piece, axis=1) - piece  # the warp scan
            mbits = piece.sum(1)
            if (piece > BLOCK_CAP).any() or (mbits > MB_CAP).any():
                meta[0] |= 1                       # the vote's atomicOr
            mb_off = np.cumsum(mbits) - mbits      # warp 0's scan
            counts[r, s] = (poff, mb_off, int(mbits.sum()))
            seg_pub[r, s] = counts[r, s][2]
    # the row's last segment: its row's words, published before it waits
    # on other rows
    row_bits, pads = {}, {}
    for r in range(nr):
        assert (seg_pub[r] >= 0).all()             # only this row's counts
        bits = int(hlens[r].sum()) + int(seg_pub[r, :nseg - 1].sum())
        body = bits + seg_pub[r, -1] + int(run_l[r])
        pads[r] = (8 - ((body + 1) % 8)) % 8
        row_bits[r] = body
        row_pub[r] = ((body + pads[r] + 1) // 8 + 3) // 4

    # the look-back's pair read from the published values, and carried
    # along the stream order
    pairs, carry_w = {}, 0
    for r in range(nr):
        carry_b = int(hlens[r].sum())
        for s in range(nseg):
            w_read = int(row_pub[:r].sum())
            b_read = int(hlens[r].sum()) + int(seg_pub[r, :s].sum())
            assert (w_read, b_read) == (carry_w, carry_b)
            pairs[r, s] = (w_read, b_read)
            carry_b += seg_pub[r, s]
        carry_w += row_pub[r]

    # pass 2, every CTA: metadata, then its words
    for r in range(nr):
        for s in range(nseg):
            w0, bits = pairs[r, s]
            poff, mb_off, seg_bits = counts[r, s]
            first, last = s == 0, s == nseg - 1
            pad, run = pads[r], int(run_l[r])
            if last:
                row_bytes = (row_bits[r] + pad + 1) // 8
                meta[2 + r] = row_bytes
                meta[2 + MAX_ROWS + r] = w0
                if r == nr - 1:
                    meta[1] = w0 + row_pub[r]
                    if meta[1] > CAP_WORDS:
                        meta[0] |= 1
            if first and r == 0 and qp_sum is not None:
                meta[t_bm.META_QP_SUM_WORD] = int(qp_sum) & 0xFFFFFFFF
            lo_bit = 0 if first else bits
            hi_bit = bits + seg_bits + (run + pad + 1 if last else 0)
            if hi_bit <= lo_bit:
                continue
            base = lo_bit & ~31
            w_first = w0 + (lo_bit >> 5)
            nwords = ((hi_bit - 1) >> 5) - (lo_bit >> 5) + 1
            sh_first = (lo_bit & 31) != 0
            sh_last = not last and (hi_bit & 31) != 0
            c0, c1 = s * seg, min(nc, s * seg + seg)
            # every piece's slots in stream order, their offsets in the MB
            pl = np.concatenate([slens[r, c0:c1], lens[r, c0:c1].reshape(
                c1 - c0, -1)], axis=1)
            pv = np.concatenate([svals[r, c0:c1], vals[r, c0:c1].reshape(
                c1 - c0, -1)], axis=1)
            start = np.repeat(poff, [slens.shape[-1]] + [34] * nb, axis=1)
            within = np.concatenate(
                [np.cumsum(slens[r, c0:c1], -1) - slens[r, c0:c1],
                 (np.cumsum(lens[r, c0:c1], -1) - lens[r, c0:c1]).reshape(
                     c1 - c0, -1)], axis=1)
            pos = bits + mb_off[:, None] + start + within - base
            for lo in range(0, nwords, buf_words(seg)):
                hi = min(nwords, lo + buf_words(seg))
                buf = np.zeros(hi - lo, np.int64)
                place(buf, lo, hi, pos.ravel(), pv.ravel(), pl.ravel())
                if first:
                    hp = np.cumsum(hlens[r]) - hlens[r]
                    place(buf, lo, hi, hp, hvals[r], hlens[r])
                if last:
                    t = bits + seg_bits - base
                    place(buf, lo, hi, np.array([t, t + run]),
                          np.array([run_v[r], 1 << pad]),
                          np.array([run, pad + 1]))
                for i in range(lo, hi):
                    k = w_first + i
                    if k >= CAP_WORDS:
                        break
                    if (i == 0 and sh_first) or (i == nwords - 1 and sh_last):
                        words[k] |= buf[i - lo]     # the edge words' atomicOr
                    else:
                        assert not owned[k] and words[k] == 0
                        owned[k] = True
                        words[k] = buf[i - lo]
    allw = np.concatenate([meta, words]).astype(">u4")
    return allw.view(np.uint8), pairs


def session(x: dict, i: int = 0) -> dict:
    """One session's numpy slots out of ``k3k7_slots``' stacked ones."""
    return {k: (v[0] if k.startswith("hdr") and v.shape[0] == 1 else v[i])
            for k, v in x.items() if k != "qp_sum"}


I_KEYS = ("values", "lengths", "syn_vals", "syn_lens", "hdr_vals", "hdr_lens")
P_KEYS = ("values", "lengths", "syn_vals", "syn_lens", "run_vals", "run_lens",
          "hdr_vals", "hdr_lens")


def plain(xs: dict, p: bool, qp_sum=None):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in xs.items()}
    q = None if qp_sum is None else torch.tensor([qp_sum], dtype=torch.int32)
    if p:
        return t_bm.pack_p_frame_plain(*(t[k] for k in P_KEYS), qp_sum=q)
    return t_bm.pack_frame_plain(*(t[k] for k in I_KEYS), qp_sum=q)


@functools.lru_cache(maxsize=None)
def _jax_pack(p: bool):
    return jax.jit(j_cp.pack_p_frame if p else j_cd.pack_frame)


def reference(xs: dict, p: bool, qp_sum=None):
    q = None if qp_sum is None else np.uint32(qp_sum)
    flat, ovf = _jax_pack(p)(*(xs[k] for k in (P_KEYS if p else I_KEYS)),
                             qp_sum=q)
    return np.asarray(flat), bool(ovf)


def meta_words(flat):
    return flat[:4 * META_WORDS].view(">u4")


KINDS = ("rand", "zero", "wide32", "pad", "cap256", "cap257", "mb2049", "full")
OVERFLOWS = {"cap257", "mb2049", "full"}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("kind", KINDS)
def test_model_equals_reference_and_plain(form, kind):
    nb, p = FORMS[form]
    x = k3k7_slots(*JAX_RC, nb, kind, 11 + KINDS.index(kind), p=p)
    xs = session(x)
    qp = int(x["qp_sum"][0]) if form == "K7-27" else None
    want = plain(xs, p, qp).numpy()
    jflat, jovf = reference(xs, p, qp)
    m = meta_words(want)
    assert bool(m[0]) == jovf == (kind in OVERFLOWS)
    np.testing.assert_array_equal(meta_words(jflat), m)
    n = 4 * (META_WORDS + int(m[1]))
    if not jovf:                      # JAX's capped buffers differ past a cap
        np.testing.assert_array_equal(jflat, want)
        assert not want[n:].any()
    if kind == "pad":                 # the stop bit last (pad 0), or first (7)
        nr = JAX_RC[0]
        ends = [want[4 * (META_WORDS + int(m[2 + MAX_ROWS + r])) + int(m[2 + r]) - 1]
                for r in range(nr)]
        assert [e & 1 if r % 2 == 0 else e == 0x80 for r, e in enumerate(ends)] \
            == [True] * nr, ends
    for seg in (1, 3, 8):
        got, _ = model_pack(xs, seg, qp)
        np.testing.assert_array_equal(got, want, err_msg=f"segments of {seg}")


GEOMETRIES = [(1, 1, "rand"), (4, 1, "rand"), (4, 7, "rand"), (4, 9, "rand"),
              (2, 33, "rand"), (3, 8, "zero"), (5, 9, "pad"), (2, 17, "full")]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("nr,nc,kind", GEOMETRIES)
def test_model_equals_plain_at_segment_edges(form, nr, nc, kind):
    """Widths of one MB, a segment's +-1 and 33 (a partial last segment
    at every size), rows of pad 0 and 7, all-skip rows, overflowing MBs
    over several windows."""
    nb, p = FORMS[form]
    x = k3k7_slots(nr, nc, nb, kind, 40 + nr * nc, p=p)
    xs = session(x)
    want = plain(xs, p).numpy()
    for seg in (1, 3, 8):
        got, pairs = model_pack(xs, seg)
        np.testing.assert_array_equal(got, want, err_msg=f"segments of {seg}")
        assert len(pairs) == nr * -(-nc // seg)


@pytest.mark.parametrize("hdr_sess", [False, True])
def test_model_sessions_with_shared_and_own_headers(hdr_sess):
    """Stacked sessions pack one after another: each session's model flat
    equals the plain version of that session (its own header slots, or
    the shared ones)."""
    x = k3k7_slots(3, 9, 26, "rand", 70 + hdr_sess, ns=3,
                         hdr_sess=hdr_sess, p=True)
    assert x["hdr_lens"].shape[0] == (3 if hdr_sess else 1)
    for i in range(3):
        xs = session(x, i)
        if hdr_sess:
            xs["hdr_vals"], xs["hdr_lens"] = x["hdr_vals"][i], x["hdr_lens"][i]
        got, _ = model_pack(xs, 3)
        np.testing.assert_array_equal(got, plain(xs, True).numpy())


@pytest.mark.parametrize("kind", ["flat_cap", "flat_cap1"])
def test_model_at_the_flat_cap(kind):
    """A total of exactly FLAT_CAP_WORDS (no overflow) and one word over
    (the flag, the last word dropped), against the plain version."""
    x = k3k7_slots(*K3K7_FLAT_ROWS, 27, kind, 90)
    xs = session(x)
    want = plain(xs, False).numpy()
    m = meta_words(want)
    assert int(m[1]) == CAP_WORDS + (kind == "flat_cap1")
    assert bool(m[0]) == (kind == "flat_cap1")
    got, _ = model_pack(xs, 8)
    np.testing.assert_array_equal(got, want)


def test_plain_keeps_a_32_bit_codeword_with_bit_31_set_unsigned():
    """A 32-bit codeword with bit 31 set that straddles a word boundary
    (5 header bits before it) is placed as the unsigned pattern, as JAX
    and the kernel read it: the plain packer once sign-extended it into
    the next word."""
    nr, nc = JAX_RC
    xs = {"values": np.zeros((nr, nc, 27, 34), np.int32),
          "lengths": np.zeros((nr, nc, 27, 34), np.int32),
          "syn_vals": np.zeros((nr, nc, 20), np.int32),
          "syn_lens": np.zeros((nr, nc, 20), np.int32),
          "hdr_vals": np.zeros((nr, 3), np.int32),
          "hdr_lens": np.zeros((nr, 3), np.int32)}
    xs["hdr_vals"][0, 0], xs["hdr_lens"][0, 0] = 0b10110, 5
    xs["values"][0, 0, 0, 0] = np.uint32(0xDEADBEEF).view(np.int32)
    xs["lengths"][0, 0, 0, 0] = 32
    want = plain(xs, False).numpy()
    jflat, jovf = reference(xs, False)
    assert not jovf
    np.testing.assert_array_equal(want, jflat)
    rbsp = want[4 * META_WORDS:4 * META_WORDS + 8].view(">u4")
    assert list(rbsp) == [(0b10110 << 27) | (0xDEADBEEF >> 5),
                          ((0xDEADBEEF & 31) << 27) | (1 << 26)]
    got, _ = model_pack(xs, 8)
    np.testing.assert_array_equal(got, want)
