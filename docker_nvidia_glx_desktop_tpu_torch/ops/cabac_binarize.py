"""CABAC binarization and context-index derivation on the card (K11i for
I pictures, K11p for P pictures): a frame's levels -> the (bin, ctxIdx,
bypass) record stream the host's arithmetic engine replays.

Replaces the reference's ``ops/cabac_binarize.py`` ``binarize_intra``
and ``binarize_p``.  Under slice-per-MB-row every context depends only
on the MB itself and on its left MB's *inputs* (levels, mv, modes), so
each MB's records are a function of two MBs' levels: the kernel
(``csrc/cabac.cu``) gives each MB one thread that walks the syntax of
spec 9.3.2/9.3.3 serially and writes the MB's records as a bit string;
the packing then follows K10's (a scan along each row and over the
rows, each MB's bits copied into place).

Record wire format (MSB-first bits):

  DEC  ``0``   + ctx(9) + bin(1)             11 bits  one decision
  RUN  ``10``  + ctx(9) + cnt(4)             15 bits  cnt 1-bins on ctx
  BYP  ``110`` + cnt(4) + bits(cnt)        7+cnt bits bypass bins
  TRM  ``111`` + bin(1)                       4 bits  terminate

Transport layout (uint32 words, version 2):

  [0] version (2)   [1] overflow flag   [2] total payload words
  [3] rows R        [4] record slots per MB (padded to 8)   [5..7] 0
  [META_WORDS .. META_WORDS+R)   per-row payload BIT counts
  [META_WORDS+R ..)              row payloads, word-aligned

The overflow flag is set where the reference sets it: a level beyond
the suffix budget of its block category, an mvd beyond the bypass
budget, or an MB above the static per-MB cap of ``ceil(max_bits/32)``
words; the caller then codes the frame from the dense levels.  The
header and, without overflow, the payload prefix equal the reference's
word for word (with overflow the payload is not used).

The plain PyTorch versions below are the reference's vectorized
formulation carried over op by op: every MB's records as slot arrays
(value, length) over a static slot layout, then packed by
``level_pack.place_bits``.  The slot layout gives the header's slot
count and the static bit cap the kernel is launched with.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from .level_pack import place_bits, to_words

__all__ = ["META_WORDS", "binarize_p", "binarize_intra",
           "binarize_p_plain", "binarize_intra_plain", "split_rows",
           "header_words", "payload_words", "decode_records_py", "layout"]

META_WORDS = 8

# ctxBlockCat offsets (bitstream/cabac.py is the value source)
_CBF_OFF = {0: 0, 1: 4, 2: 8, 3: 12, 4: 16}
_SIG_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}
_ABS_OFF = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}

# luma4x4BlkIdx -> (bx, by) z-scan (bitstream/cabac._BLK_XY)
_BLK_XY = ((0, 0), (1, 0), (0, 1), (1, 1),
           (2, 0), (3, 0), (2, 1), (3, 1),
           (0, 2), (1, 2), (0, 3), (1, 3),
           (2, 2), (3, 2), (2, 3), (3, 3))

_I64 = torch.int64


def _t(x, like):
    return torch.as_tensor(x, dtype=_I64, device=like.device)


def _bc(*ts):
    return torch.broadcast_tensors(*ts)


def _dec(ctx, b, pres=None):
    """DEC record: tag 0 + ctx(9) + bin(1)."""
    ctx = torch.as_tensor(ctx, dtype=_I64)
    b = torch.as_tensor(b)
    val = (ctx << 1) | (b != 0).to(_I64)
    if pres is None:
        return val, torch.full_like(val, 11)
    val, pres = _bc(val, pres)
    return val, torch.where(pres, 11, 0)


def _run(ctx, cnt, pres):
    """RUN record: tag 10 + ctx(9) + cnt(4): cnt decisions of bin=1."""
    val = (2 << 13) | (torch.as_tensor(ctx, dtype=_I64) << 4) | cnt
    val, pres = _bc(val, pres)
    return val, torch.where(pres, 15, 0)


def _byp(bits, cnt, pres):
    """BYP record: tag 110 + cnt(4) + cnt literal bypass bins."""
    cnt = torch.as_tensor(cnt, dtype=_I64)
    val = (6 << (4 + cnt)) | (cnt << cnt) | bits
    val, pres, cnt = _bc(val, pres, cnt)
    return val, torch.where(pres, 7 + cnt, 0)


def _trm(b, pres=None):
    """TRM record: tag 111 + bin."""
    val = (7 << 1) | torch.as_tensor(b).to(_I64)
    if pres is None:
        return val, torch.full_like(val, 4)
    val, pres = _bc(val, pres)
    return val, torch.where(pres, 4, 0)


def _cat(a, b):
    """Concatenate two records into one slot (either may be absent)."""
    av, al, bv, bl = _bc(*a, *b)
    val = (torch.where(al > 0, av << bl, 0) | torch.where(bl > 0, bv, 0))
    return val, al + bl


def _merge(a, b):
    """Merge two mutually exclusive slot candidates into one slot."""
    av, al, bv, bl = _bc(*a, *b)
    return torch.where(bl > 0, bv, av), al + bl


class _Recs:
    """Slot accumulator over (R, C) MBs, plus the STATIC per-MB maximum
    bit total (the per-MB cap)."""

    def __init__(self, shape):
        self.shape = shape
        self.pieces = []
        self.max_bits = 0

    def add(self, rec, mx: int):
        v, ln = rec
        self.pieces.append((v.expand(self.shape)[..., None],
                            ln.expand(self.shape)[..., None]))
        self.max_bits += mx

    def add_batch(self, vals, lns, mx_total: int):
        self.pieces.append((vals, lns))
        self.max_bits += mx_total

    def stacked(self):
        return (torch.cat([p[0] for p in self.pieces], dim=-1),
                torch.cat([p[1] for p in self.pieces], dim=-1))


def _residual_slots(coeffs, cat: int, cbf_inc, emit):
    """Record slots for residual blocks (spec 9.3.3.1.3) over arbitrary
    leading dims: coeffs (..., n) zigzag, cbf_inc/emit (...,).  Returns
    (vals (..., S), lns (..., S), value_overflow (...,), max_bits) with
    S = 1 + (n-1) + (3 or 4)n: cbf, sig+last pairs, then per
    coefficient in reverse scan order its first prefix bin, its run and
    terminator, and its suffix and sign."""
    n = coeffs.shape[-1]
    nz = coeffs != 0
    cbf = nz.any(-1)
    idx = torch.arange(n, dtype=_I64, device=coeffs.device)
    last_nz = torch.where(nz, idx, -1).amax(-1)
    vals, lns = [], []
    maxb = 0

    def add(rec, mx):
        nonlocal maxb
        v, ln = _bc(*rec)
        vals.append(v)
        lns.append(ln)
        maxb += mx

    add(_dec(85 + _CBF_OFF[cat] + cbf_inc, cbf, emit), 11)
    sig_base = 105 + _SIG_OFF[cat]
    last_base = 166 + _SIG_OFF[cat]
    for i in range(n - 1):
        inc = min(i, 2) if cat == 3 else i
        pres = emit & cbf & (i <= last_nz)
        d_sig = _dec(sig_base + inc, nz[..., i], pres)
        d_last = _dec(last_base + inc, last_nz == i, pres & nz[..., i])
        add(_cat(d_sig, d_last), 22)

    a = coeffs.abs()
    lvl = a - 1

    def after(x):            # count over scan positions > i
        x = x.to(_I64)
        rev = x.flip(-1).cumsum(-1).flip(-1)
        return rev - x

    num_gt1 = after(nz & (a > 1))
    num_eq1 = after(a == 1)
    abs_base = 227 + _ABS_OFF[cat]
    capn = 3 if cat == 3 else 4
    c0 = abs_base + torch.where(num_gt1 > 0, 0,
                                torch.clamp(1 + num_eq1, max=4))
    cn = abs_base + 5 + torch.clamp(num_gt1, max=capn)
    prefix = torch.clamp(lvl, max=14)
    # UEG0 suffix (lvl >= 14) + sign as bypass runs: two slots of budget
    # for the DC categories (0, 3), one for the AC ones
    wide = cat in (0, 3)
    u_lim = 14 if wide else 6
    v = torch.clamp(lvl - 14, min=0)
    u = torch.zeros_like(v)
    for k in range(1, u_lim + 2):
        u = u + (v + 1 >= (1 << k)).to(_I64)
    u = torch.clamp(u, max=u_lim)
    r = v - ((1 << u) - 1)
    sign = (coeffs < 0).to(_I64)
    suf = (((1 << u) - 1) << (u + 1)) | r
    has_suf = lvl >= 14
    bits = torch.where(has_suf, (suf << 1) | sign, sign)
    cnt = torch.where(has_suf, 2 * u + 2, 1)
    if wide:
        hi_len = torch.clamp(cnt, max=15)
        lo_len = cnt - hi_len
        hi_bits = bits >> lo_len
        lo_bits = bits & ((1 << lo_len) - 1)
    zero = torch.zeros(coeffs.shape[:-1], dtype=torch.bool,
                       device=coeffs.device)

    for j in range(n - 1, -1, -1):            # reverse scan order
        nzj = emit & nz[..., j]
        add(_dec(c0[..., j], lvl[..., j] >= 1, nzj), 11)
        run = _run(cn[..., j], torch.clamp(prefix[..., j] - 1, 1, 14),
                   nzj & (prefix[..., j] >= 2))
        term = _dec(cn[..., j], zero,
                    nzj & (prefix[..., j] >= 1) & (prefix[..., j] < 14))
        add(_cat(run, term), 26)
        if wide:
            add(_byp(hi_bits[..., j], hi_len[..., j], nzj), 22)
            add(_byp(lo_bits[..., j], torch.clamp(lo_len[..., j], min=1),
                     nzj & (lo_len[..., j] > 0)), 22)
        else:
            add(_byp(bits[..., j], cnt[..., j], nzj), 22)
    ovf = (emit[..., None] & nz
           & (torch.clamp(lvl - 14, min=0) + 1 > (1 << (u_lim + 1)) - 1)
           ).any(-1)
    return torch.stack(vals, -1), torch.stack(lns, -1), ovf, maxb


def _left(x):
    """Left-MB shift along the column axis (column 0 gets zeros)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _chroma_cbp(cb_dc, cb_ac, cr_dc, cr_ac):
    c_dc = cb_dc.any(-1) | cr_dc.any(-1)
    c_ac = cb_ac.flatten(-2).any(-1) | cr_ac.flatten(-2).any(-1)
    return torch.where(c_ac, 2, torch.where(c_dc, 1, 0))


def _raster_grid(blk16):
    """(R, C, 16) per-blkIdx values -> (R, C, 4, 4) raster [by][bx]."""
    g = torch.zeros(blk16.shape[:2] + (4, 4), dtype=blk16.dtype,
                    device=blk16.device)
    for blk, (bx, by) in enumerate(_BLK_XY):
        g[..., by, bx] = blk16[..., blk]
    return g


def _luma_cbf_inc(cbf_r, left_skip, col0, intra: bool):
    """ctxIdxInc of coded_block_flag for the 16 luma blocks, stacked
    (R, C, 16) in blkIdx order.  cbf_r (R, C, 4, 4) raster grid."""
    una = 1 if intra else 0
    left_c3 = [_left(cbf_r[..., by, 3].to(_I64)) for by in range(4)]
    out = []
    for blk, (bx, by) in enumerate(_BLK_XY):
        if bx > 0:
            av = cbf_r[..., by, bx - 1].to(_I64)
        else:
            av = torch.where(col0, una,
                             torch.where(left_skip, 0, left_c3[by]))
        bv = (cbf_r[..., by - 1, bx].to(_I64) if by > 0
              else torch.full_like(av, una))
        out.append(av + 2 * bv)
    return torch.stack(out, -1)


def _chroma_slots(recs, cb_dc, cb_ac, cr_dc, cr_ac, cc, left_skip, col0,
                  emit_any, intra: bool):
    """Chroma DC (cat 3) then AC (cat 4) residual slots, coder order."""
    una = 1 if intra else 0
    emit_dc = emit_any & (cc > 0)
    emit_ac = emit_any & (cc == 2)
    nr, nc = cc.shape
    dc = torch.stack([cb_dc, cr_dc], dim=2)               # (R, C, 2, 4)
    dcnz = dc.any(-1).to(_I64)
    a = torch.where(col0[..., None], una,
                    torch.where(left_skip[..., None], 0, _left(dcnz)))
    v, ln, ovf_dc, mx = _residual_slots(dc, 3, a + 2 * una,
                                        emit_dc[..., None])
    recs.add_batch(v.reshape(nr, nc, -1), ln.reshape(nr, nc, -1), 2 * mx)
    ac = torch.cat([cb_ac, cr_ac], dim=2)                  # (R, C, 8, 15)
    acnz = ac.any(-1).to(_I64)
    incs = []
    for p in range(2):
        for b in range(4):
            by, bx = divmod(b, 2)
            cur = acnz[..., p * 4:p * 4 + 4]
            if bx > 0:
                av = cur[..., by * 2]
            else:
                av = torch.where(col0, una,
                                 torch.where(left_skip, 0,
                                             _left(cur[..., by * 2 + 1])))
            bv = cur[..., bx] if by > 0 else torch.full_like(av, una)
            incs.append(av + 2 * bv)
    v, ln, ovf_ac, mx = _residual_slots(ac, 4, torch.stack(incs, -1),
                                        emit_ac[..., None])
    recs.add_batch(v.reshape(nr, nc, -1), ln.reshape(nr, nc, -1), 8 * mx)
    return ovf_dc.any(-1) | ovf_ac.any(-1)


def _mvd_slots(recs, mvd_comp, s_left, base: int, pres):
    """mvd_l0 component: UEG3 uCoff=9 prefix (paired DECs) + suffix and
    sign bypass.  Returns the suffix-budget overflow mask."""
    inc = torch.where(s_left < 3, 0, torch.where(s_left <= 32, 1, 2))
    aa = mvd_comp.abs()
    prefix = torch.clamp(aa, max=9)
    ctxs = [base + inc, base + 3, base + 4, base + 5, base + 6]
    ds = []
    for k in range(9):
        pk = pres & ((k < prefix) | ((k == prefix) & (prefix < 9)))
        ds.append(_dec(_t(ctxs[min(k, 4)], aa), k < prefix, pk))
    for k in range(0, 8, 2):
        recs.add(_cat(ds[k], ds[k + 1]), 22)
    recs.add(ds[8], 11)
    v3 = torch.clamp(aa - 9, min=0)
    u3 = torch.zeros_like(v3)
    for j in range(1, 7):
        u3 = u3 + (v3 >= 8 * ((1 << j) - 1)).to(_I64)
    r3 = v3 - 8 * ((1 << u3) - 1)
    suf3 = (((1 << u3) - 1) << (u3 + 4)) | r3
    sign = (mvd_comp < 0).to(_I64)
    has_suf = aa >= 9
    bits = torch.where(has_suf, (suf3 << 1) | sign, sign)
    cnt = torch.where(has_suf, 2 * u3 + 5, 1)
    recs.add(_byp(bits, cnt, pres & (aa > 0)), 22)
    return pres & (2 * u3 + 5 > 15)


def _pack_stream(recs: _Recs, value_ovf):
    """Slot arrays -> the version-2 transport (int32 words)."""
    vals, lns = recs.stacked()
    r, c, s = vals.shape
    s += (-s) % 8                               # header slot count
    mb_cap = -(-recs.max_bits // 32)            # words per MB
    mb_bits = lns.sum(-1)
    overflow = bool(value_ovf.any() | (mb_bits > 32 * mb_cap).any())
    row_bits = mb_bits.sum(-1)
    row_words = (row_bits + 31) >> 5
    word_off = row_words.cumsum(0) - row_words
    hdr = torch.zeros(META_WORDS + r, dtype=_I64, device=vals.device)
    hdr[0], hdr[1], hdr[2], hdr[3], hdr[4] = 2, int(overflow), \
        row_words.sum(), r, s
    hdr[META_WORDS:] = row_bits
    payload = place_bits(vals.reshape(r, -1), lns.reshape(r, -1), word_off,
                         r * c * mb_cap)
    return to_words(torch.cat([hdr, payload]))


def _p_recs(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac):
    mv = mv.to(_I64)
    luma = luma.to(_I64)
    cb_dc, cb_ac = cb_dc.to(_I64), cb_ac.to(_I64)
    cr_dc, cr_ac = cr_dc.to(_I64), cr_ac.to(_I64)
    nr, nc = luma.shape[:2]
    dev = luma.device
    recs = _Recs((nr, nc))
    col0 = (torch.arange(nc, device=dev) == 0).expand(nr, nc)

    lnz = luma.any(-1)                                   # (R, C, 16)
    grp = lnz.reshape(nr, nc, 4, 4).any(-1)              # (R, C, 4) 8x8
    cbp_luma = (grp.to(_I64) << torch.arange(4, device=dev)).sum(-1)
    cc = _chroma_cbp(cb_dc, cb_ac, cr_dc, cr_ac)
    skip = (mv == 0).all(-1) & (cbp_luma == 0) & (cc == 0)
    left_skip = _left(skip)
    ns = ~skip

    mvp = _left(mv)                 # left MB's mv (a skip left's is 0)
    mvd = mv - mvp
    absmvd = mvd.abs()
    labs = _left(torch.where(skip[..., None], 0, absmvd))

    inc_skip = ((~col0) & (~left_skip)).to(_I64)
    recs.add(_dec(11 + inc_skip, skip), 11)
    f = torch.zeros((nr, nc), dtype=torch.bool, device=dev)
    recs.add(_cat(_dec(14, f, ns), _dec(15, f, ns)), 22)
    recs.add(_dec(16, f, ns), 11)
    ovf = _mvd_slots(recs, mvd[..., 1], labs[..., 1], 40, ns)
    ovf |= _mvd_slots(recs, mvd[..., 0], labs[..., 0], 47, ns)
    lcl = _left(torch.where(skip, 0, cbp_luma))
    lcc = _left(torch.where(skip, 0, cc))
    cbp_d = []
    for b in range(4):
        if b & 1:
            a_n = 1 - grp[..., b - 1].to(_I64)
        else:
            a_n = torch.where(col0, 0, 1 - ((lcl >> (b + 1)) & 1))
        b_n = (1 - grp[..., b - 2].to(_I64)) if b & 2 \
            else torch.zeros((nr, nc), dtype=_I64, device=dev)
        cbp_d.append(_dec(73 + a_n + 2 * b_n, grp[..., b], ns))
    recs.add(_cat(cbp_d[0], cbp_d[1]), 22)
    recs.add(_cat(cbp_d[2], cbp_d[3]), 22)
    d1 = _dec(77 + (lcc > 0).to(_I64), cc > 0, ns)
    d2 = _dec(81 + (lcc == 2).to(_I64), cc == 2, ns & (cc > 0))
    recs.add(_cat(d1, d2), 22)
    recs.add(_dec(_t(60, f), f, ns & ((cbp_luma > 0) | (cc > 0))), 11)
    incs = _luma_cbf_inc(_raster_grid(lnz), left_skip, col0, intra=False)
    emit16 = ns[..., None] & grp.repeat_interleave(4, dim=-1)
    v, ln, ov, mx = _residual_slots(luma, 2, incs, emit16)
    recs.add_batch(v.reshape(nr, nc, -1), ln.reshape(nr, nc, -1), 16 * mx)
    ovf |= ov.any(-1)
    ovf |= _chroma_slots(recs, cb_dc, cb_ac, cr_dc, cr_ac, cc, left_skip,
                         col0, ns, intra=False)
    recs.add(_trm((torch.arange(nc, device=dev) == nc - 1).expand(nr, nc)), 4)
    return recs, ovf


def _intra_recs(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                mb_i4, i4_modes, luma_i4):
    luma_dc, luma_ac = luma_dc.to(_I64), luma_ac.to(_I64)
    cb_dc, cb_ac = cb_dc.to(_I64), cb_ac.to(_I64)
    cr_dc, cr_ac = cr_dc.to(_I64), cr_ac.to(_I64)
    pred_mode = pred_mode.to(_I64)
    mb_i4 = mb_i4.to(torch.bool)
    i4_modes = i4_modes.to(_I64)
    luma_i4 = luma_i4.to(_I64)
    nr, nc = luma_dc.shape[:2]
    dev = luma_dc.device
    recs = _Recs((nr, nc))
    col0 = (torch.arange(nc, device=dev) == 0).expand(nr, nc)
    f = torch.zeros((nr, nc), dtype=torch.bool, device=dev)
    left_skip = f                                  # no skip in I slices

    cl16 = luma_ac.flatten(-2).any(-1)             # I16 AC coded flag
    i4nz = luma_i4.any(-1)                         # (R, C, 16)
    grp4 = i4nz.reshape(nr, nc, 4, 4).any(-1)      # (R, C, 4)
    cbp4 = (grp4.to(_I64) << torch.arange(4, device=dev)).sum(-1)
    cc = _chroma_cbp(cb_dc, cb_ac, cr_dc, cr_ac)
    i16 = ~mb_i4

    linc = ((~col0) & _left(i16)).to(_I64)
    recs.add(_dec(3 + linc, i16), 11)
    recs.add(_trm(f, i16), 4)
    recs.add(_cat(_dec(_t(6, f), cl16, i16), _dec(_t(7, f), cc > 0, i16)), 22)
    recs.add(_dec(_t(8, f), cc == 2, i16 & (cc > 0)), 11)
    recs.add(_cat(_dec(_t(9, f), (pred_mode >> 1) & 1, i16),
                  _dec(_t(10, f), pred_mode & 1, i16)), 22)
    modes_r = _raster_grid(torch.where(mb_i4[..., None], i4_modes, 2))
    left_m3 = [_left(modes_r[..., by, 3]) for by in range(4)]
    ones = torch.ones((nr, nc), dtype=torch.bool, device=dev)
    for blk, (bx, by) in enumerate(_BLK_XY):
        if bx > 0:
            ma, ava = modes_r[..., by, bx - 1], ones
        else:
            ma, ava = torch.where(col0, 2, left_m3[by]), ~col0
        if by > 0:
            mb_, avb = modes_r[..., by - 1, bx], ones
        else:
            mb_, avb = torch.full((nr, nc), 2, dtype=_I64, device=dev), f
        pred = torch.where(ava & avb, torch.minimum(ma, mb_), 2)
        mode = i4_modes[..., blk]
        eq = mode == pred
        rem = torch.where(mode > pred, mode - 1, mode)
        e4 = mb_i4
        recs.add(_cat(_dec(_t(68, f), eq, e4),
                      _dec(_t(69, f), rem & 1, e4 & ~eq)), 22)
        recs.add(_cat(_dec(_t(69, f), (rem >> 1) & 1, e4 & ~eq),
                      _dec(_t(69, f), (rem >> 2) & 1, e4 & ~eq)), 22)
    recs.add(_dec(_t(64, f), f), 11)
    lcl = _left(torch.where(mb_i4, cbp4, torch.where(cl16, 0xF, 0)))
    lcc = _left(cc)
    cbp_d = []
    for b in range(4):
        if b & 1:
            a_n = 1 - grp4[..., b - 1].to(_I64)
        else:
            a_n = torch.where(col0, 0, 1 - ((lcl >> (b + 1)) & 1))
        b_n = (1 - grp4[..., b - 2].to(_I64)) if b & 2 \
            else torch.zeros((nr, nc), dtype=_I64, device=dev)
        cbp_d.append(_dec(73 + a_n + 2 * b_n, grp4[..., b], mb_i4))
    recs.add(_cat(cbp_d[0], cbp_d[1]), 22)
    recs.add(_cat(cbp_d[2], cbp_d[3]), 22)
    d1 = _dec(77 + (lcc > 0).to(_I64), cc > 0, mb_i4)
    d2 = _dec(81 + (lcc == 2).to(_I64), cc == 2, mb_i4 & (cc > 0))
    recs.add(_cat(d1, d2), 22)
    recs.add(_dec(_t(60, f), f, i16 | ((cbp4 > 0) | (cc > 0))), 11)
    dcnz = luma_dc.any(-1).to(_I64)
    a = torch.where(col0, 1, torch.where(_left(i16), _left(dcnz), 0))
    v, ln, ov, mx = _residual_slots(luma_dc, 0, a + 2, i16)
    recs.add_batch(v, ln, mx)
    ovf = ov
    cbf_blk = torch.where(mb_i4[..., None], i4nz, luma_ac.any(-1))
    incs = _luma_cbf_inc(_raster_grid(cbf_blk), left_skip, col0, intra=True)
    v16, l16, ov16, _ = _residual_slots(luma_ac, 1, incs,
                                        (i16 & cl16)[..., None])
    v4, l4, ov4, mx4 = _residual_slots(
        luma_i4, 2, incs, mb_i4[..., None] & grp4.repeat_interleave(4, -1))
    padk = v4.shape[-1] - v16.shape[-1]               # cat 1 is 4 short
    v16 = torch.nn.functional.pad(v16, (0, padk))
    l16 = torch.nn.functional.pad(l16, (0, padk))
    vm, lm = _merge((v16, l16), (v4, l4))
    recs.add_batch(vm.reshape(nr, nc, -1), lm.reshape(nr, nc, -1), 16 * mx4)
    ovf |= ov16.any(-1) | ov4.any(-1)
    ovf |= _chroma_slots(recs, cb_dc, cb_ac, cr_dc, cr_ac, cc, left_skip,
                         col0, ones, intra=True)
    recs.add(_trm((torch.arange(nc, device=dev) == nc - 1).expand(nr, nc)), 4)
    return recs, ovf


def binarize_p_plain(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac):
    """Plain PyTorch version of K11p: same contract as :func:`binarize_p`."""
    return _pack_stream(*_p_recs(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac))


def binarize_intra_plain(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                         pred_mode, mb_i4, i4_modes, luma_i4):
    """Plain PyTorch version of K11i: same contract as
    :func:`binarize_intra`."""
    return _pack_stream(*_intra_recs(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc,
                                     cr_ac, pred_mode, mb_i4, i4_modes,
                                     luma_i4))


@functools.lru_cache(maxsize=None)
def layout(kind: str):
    """Static (slots per MB padded to 8, per-MB cap in words) of the
    record stream of ``kind`` ("intra" or "p"), from the slot layout of
    the plain version on one MB."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    if kind == "p":
        recs, _ = _p_recs(z(1, 1, 2), z(1, 1, 16, 16), z(1, 1, 4),
                          z(1, 1, 4, 15), z(1, 1, 4), z(1, 1, 4, 15))
    else:
        recs, _ = _intra_recs(z(1, 1, 16), z(1, 1, 16, 15), z(1, 1, 4),
                              z(1, 1, 4, 15), z(1, 1, 4), z(1, 1, 4, 15),
                              z(1, 1), z(1, 1).bool(), z(1, 1, 16),
                              z(1, 1, 16, 16))
    s = recs.stacked()[0].shape[-1]
    return s + (-s) % 8, -(-recs.max_bits // 32)


def buffer_words(kind: str, rows: int, cols: int) -> int:
    """Length of a transport buffer: header + the per-MB cap of every MB."""
    return META_WORDS + rows + rows * cols * layout(kind)[1]


def _check(named: dict, nr: int, nc: int, dev) -> None:
    for name, (t, shape, dtype) in named.items():
        want = (nr, nc) + shape
        if tuple(t.shape) != want or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {want} {dtype} on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def _launch(kind: str, fn_name: str, tensors, nr: int, nc: int, dev):
    s, cap = layout(kind)
    out = torch.empty(buffer_words(kind, nr, nc), dtype=torch.int32,
                      device=dev)
    scratch = torch.empty(nr * nc * cap + 2 * nr * nc + nr + 1,
                          dtype=torch.int32, device=dev)
    _cuda.launch("cabac", fn_name, list(tensors) + [out, scratch],
                 [nr, nc, s, cap], dev)
    return out


def binarize_p(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac):
    """Record stream of a P picture (P_L0_16x16 + P_Skip): mv (R, C, 2)
    quarter-pel (y, x) and the P levels (``ops/h264_inter``'s output),
    all int32.  Returns the version-2 transport as a 1-D int32 tensor of
    uint32 words.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    nr, nc = luma.shape[:2]
    dev = luma.device
    i32 = torch.int32
    _check({"mv": (mv, (2,), i32), "luma": (luma, (16, 16), i32),
            "cb_dc": (cb_dc, (4,), i32), "cb_ac": (cb_ac, (4, 15), i32),
            "cr_dc": (cr_dc, (4,), i32), "cr_ac": (cr_ac, (4, 15), i32)},
           nr, nc, dev)
    if dev.type == "cpu":
        return binarize_p_plain(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac)
    out = _launch("p", "binarize_p_launch",
                  (mv, luma, cb_dc, cb_ac, cr_dc, cr_ac), nr, nc, dev)
    binarize_p.launches += 1
    return out


binarize_p.launches = 0


def binarize_intra(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                   pred_mode, mb_i4, i4_modes, luma_i4):
    """Record stream of an I picture (I_16x16 + I_NxN): the intra core's
    output tensors (int32; ``mb_i4`` bool).  Returns the version-2
    transport as a 1-D int32 tensor of uint32 words.  CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    nr, nc = luma_dc.shape[:2]
    dev = luma_dc.device
    i32 = torch.int32
    _check({"luma_dc": (luma_dc, (16,), i32),
            "luma_ac": (luma_ac, (16, 15), i32),
            "cb_dc": (cb_dc, (4,), i32), "cb_ac": (cb_ac, (4, 15), i32),
            "cr_dc": (cr_dc, (4,), i32), "cr_ac": (cr_ac, (4, 15), i32),
            "pred_mode": (pred_mode, (), i32),
            "mb_i4": (mb_i4, (), torch.bool),
            "i4_modes": (i4_modes, (16,), i32),
            "luma_i4": (luma_i4, (16, 16), i32)}, nr, nc, dev)
    if dev.type == "cpu":
        return binarize_intra_plain(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc,
                                    cr_ac, pred_mode, mb_i4, i4_modes,
                                    luma_i4)
    out = _launch("intra", "binarize_intra_launch",
                  (luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                   mb_i4, i4_modes, luma_i4), nr, nc, dev)
    binarize_intra.launches += 1
    return out


binarize_intra.launches = 0


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def header_words(rows: int) -> int:
    return META_WORDS + rows


def payload_words(head: np.ndarray) -> int:
    return int(head[2])


def stitch_rows(bufs, rows_each) -> np.ndarray:
    """Per-shard transports (host uint32 words, each covering header and
    payload) -> one whole-frame transport, the spatial shards' CABAC
    collect.  Every cross-MB context is a left neighbour within a row
    (slice per MB row), so a shard of consecutive MB rows records exactly
    the rows a whole-frame binarize would: one header, the shards' row
    bit tables back to back, then their row payloads back to back.
    ``rows_each``: the MB rows of every shard (an int, or one per shard).
    A shard's overflow flag gives a flag-only header, so the caller takes
    the dense path without reading row tables."""
    heads = [np.asarray(b).view(np.uint32) for b in bufs]
    if isinstance(rows_each, int):
        rows_each = [rows_each] * len(heads)
    total_rows = int(sum(rows_each))
    out_head = np.zeros(META_WORDS, np.uint32)
    out_head[0] = 2
    out_head[3] = total_rows
    out_head[4] = heads[0][4]
    if any(int(h[1]) for h in heads):
        out_head[1] = 1
        return np.concatenate([out_head, np.zeros(total_rows, np.uint32)])
    bit_tables, payloads = [], []
    total_words = 0
    for h, r in zip(heads, rows_each):
        if int(h[0]) != 2 or int(h[3]) != r:
            raise ValueError("a shard's transport is not version 2 over "
                             f"{r} rows")
        row_bits = h[META_WORDS:META_WORDS + r]
        n = int(((row_bits.astype(np.int64) + 31) >> 5).sum())
        bit_tables.append(row_bits.astype(np.uint32))
        payloads.append(h[META_WORDS + r:META_WORDS + r + n].astype(np.uint32))
        total_words += n
    out_head[2] = total_words
    return np.concatenate([out_head] + bit_tables + payloads)


def split_rows(buf: np.ndarray, rows: int):
    """Transport buffer (host array covering header + payload) ->
    (payload uint32, row_off int64 (rows+1,), row_bits int64) or None
    on the overflow flag."""
    buf = np.asarray(buf).view(np.uint32)
    head = buf[:META_WORDS + rows]
    assert int(head[0]) == 2, "cabac_binarize version mismatch"
    if int(head[1]):
        return None
    row_bits = head[META_WORDS:META_WORDS + rows].astype(np.int64)
    row_words = (row_bits + 31) >> 5
    row_off = np.zeros(rows + 1, np.int64)
    np.cumsum(row_words, out=row_off[1:])
    payload = np.ascontiguousarray(
        buf[META_WORDS + rows:META_WORDS + rows + int(row_off[-1])],
        dtype=np.uint32)
    return payload, row_off, row_bits


def decode_records_py(words: np.ndarray, nbits: int):
    """Decode one row's record stream into [(kind, ...), ...] — the
    pure-Python engine's input and the wire-format test oracle.
    kinds: ("dec", ctx, b) ("run", ctx, cnt) ("byp", [bits]) ("trm", b).
    """
    out = []
    pos = 0

    def rd(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            w = int(words[pos >> 5])
            v = (v << 1) | ((w >> (31 - (pos & 31))) & 1)
            pos += 1
        return v

    while pos < nbits:
        if rd(1) == 0:
            out.append(("dec", rd(9), rd(1)))
        elif rd(1) == 0:
            out.append(("run", rd(9), rd(4)))
        elif rd(1) == 0:
            n = rd(4)
            out.append(("byp", [rd(1) for _ in range(n)]))
        else:
            out.append(("trm", rd(1)))
    assert pos == nbits, "record stream over-ran its bit count"
    return out
