"""H.264 intra core (K1): I-slice transform/quant/recon of one frame.

Replaces the reference's ``ops/h264_device.py`` ``encode_intra_frame_yuv``
(``i16_modes`` "auto", "full", "i16" and "dc"; ``tune`` "off",
"hq_noaq" and "hq").  Each
macroblock row is its own slice, so intra prediction only references the
MB to the left: the rows are independent and the left MB's reconstructed
right column is the carry along a row.  Per MB the core codes I16x16 DC
and Horizontal, the I4x4 fast mode sets (row 0 of blocks: H / HU /
DC-left, sequential along x; rows 1-3: V / DDL / VL, the four blocks of a
row in parallel; under ``i16_modes="full"`` rows 1-3 take all nine
modes, block by block), picks by estimated CAVLC bits
(``_level_bits_est``; I4 pays a 44-bit signalling bias), and codes chroma
with DC prediction.  "i16" drops the I4 candidate, "dc" also I16 H.
Under tune=hq every choice minimises the Lagrangian ``SSD + lam * bits``
in float32 instead, in the reference's order of operations (its
multiply-adds are fused, as XLA's CPU backend contracts them); full
``hq`` quantises each MB at its qp from the qp plane (K14, ``ops/aq``)
and outputs that plane as ``qp_map``.  Outputs are the reference's dict:
same keys, int32 levels, zigzag / luma4x4BlkIdx orders.

``encode_intra_frame_yuv`` runs the CUDA kernel (``csrc/intra.cu``) for
CUDA tensors and :func:`encode_intra_frame_yuv_plain` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, aq, quant
from .dct import fdct4x4 as _fwd4x4
from .dct import hadamard2x2 as _had2
from .dct import hadamard4x4 as _had4
from .dct import idct4x4 as _inv4x4
from .scan import ZIGZAG4

# luma4x4BlkIdx -> (bx, by) in 4-sample units (spec §6.4.3).
LUMA_BLOCK_ORDER = np.array(
    [(0, 0), (1, 0), (0, 1), (1, 1),
     (2, 0), (3, 0), (2, 1), (3, 1),
     (0, 2), (1, 2), (0, 3), (1, 3),
     (2, 2), (3, 2), (2, 3), (3, 3)], dtype=np.int32)

# TR availability per raster (by, bx), by >= 1: the above-right 4x4 block
# must precede the current one in luma4x4BlkIdx (z) coding order.
_BLKIDX_RASTER = np.zeros((4, 4), np.int32)          # [by][bx] -> blkIdx
for _i, (_bx, _by) in enumerate(LUMA_BLOCK_ORDER):
    _BLKIDX_RASTER[_by, _bx] = _i
_TR_AVAIL = np.zeros((4, 4), bool)
for _by in range(1, 4):
    for _bx in range(3):
        _TR_AVAIL[_by, _bx] = (_BLKIDX_RASTER[_by - 1, _bx + 1]
                               < _BLKIDX_RASTER[_by, _bx])
del _i, _bx, _by

# int32 words per MB that the CUDA pre-pass leaves for the chain pass
# (csrc/intra.cu PRE_WORDS).
PRE_WORDS = 352

# I4's extra signalling against the I16 combined mb_type: 16 mode
# elements (~1-4 b) + cbp ue, on the scale of _level_bits_est.
I4_SIG_BITS = 44

# The reference computes floor(log2(|l|)) in float32 on XLA's CPU
# backend, whose log2 lands just below the integer at exactly these two
# magnitudes (the only ones below 2^21); the bit estimate, and with it
# every mode decision, follows that value.
_FLOG2_LOW = (8192, 32768)


def _ilog2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for int32 a >= 1, as the reference computes it."""
    _, e = torch.frexp(a.to(torch.float64))
    low = (a == _FLOG2_LOW[0]) | (a == _FLOG2_LOW[1])
    return e.to(torch.int32) - 1 - low.to(torch.int32)


def _level_bits_est(lv: torch.Tensor, dims) -> torch.Tensor:
    """Crude CAVLC bit estimate: 3 bits per nonzero plus 2 per extra
    magnitude bit (the I16-vs-I4 and mode decisions compare coded size)."""
    a = lv.abs()
    nz = (a > 0).to(torch.int32)
    extra = _ilog2(torch.clamp(a, min=1))
    return (3 * nz + 2 * extra).sum(dim=dims, dtype=torch.int32)


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add): the
    product is exact in float64, the sum's error is recovered (TwoSum)
    and decides the one case float64 rounding could get wrong, a sum
    exactly halfway between two float32 values."""
    a64 = torch.as_tensor(a).to(torch.float64)
    b64 = torch.as_tensor(b).to(torch.float64)
    c64 = torch.as_tensor(c).to(torch.float64)
    p = a64 * b64
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    mid = (s != r64) & ((s - r64).abs() == (other.to(torch.float64) - s).abs())
    toward = (err > 0) == (other > r)
    return torch.where(mid & (err != 0) & toward, other, r)


def _blocks(mb: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4n, 4n) MB -> (..., by, bx, 4, 4)."""
    s = mb.shape
    return mb.reshape(s[:-2] + (n, 4, n, 4)).movedim(-2, -3)


def _unblocks(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_blocks`."""
    s = b.shape
    return b.movedim(-3, -2).reshape(s[:-4] + (s[-4] * 4, s[-3] * 4))


def _i16_candidate(ymb, pred, qp):
    """Transform/quant/recon one I16 prediction candidate.
    Returns (ac (R,4,4,4,4), dcl (R,4,4), recon (R,16,16), bits (R,))."""
    w = _fwd4x4(_blocks(ymb - pred, 4))                  # (R, by, bx, 4, 4)
    dc = w[..., 0, 0]
    ac = quant.h264_quantize_4x4(w, qp, intra=True)
    ac[..., 0, 0] = 0
    wd2 = _had4(dc)
    wd = torch.sign(wd2) * (wd2.abs() >> 1)              # /2, toward zero
    dcl = quant.h264_quantize_luma_dc(wd, qp)
    dcy = quant.h264_dequantize_luma_dc(_had4(dcl), qp)
    wr = quant.h264_dequantize_4x4(ac, qp)
    wr[..., 0, 0] = dcy
    recon = torch.clamp(pred + _unblocks(_inv4x4(wr)), 0, 255)
    bits = _level_bits_est(ac, (1, 2, 3, 4)) + _level_bits_est(dcl, (1, 2))
    return ac, dcl, recon, bits


def _ssd(recon, src, dims):
    d = recon - src
    return (d * d).sum(dim=dims, dtype=torch.int32)


def _luma_step(ymb, left_col, has_left, qp, lam=None, allow_h=True):
    """I16 DC and Horizontal for one MB column across all rows; keeps H
    only where it has a left MB and strictly fewer estimated bits, or
    (``lam``, tune=hq: float32 (R,)) a strictly lower SSD + lam * bits.
    Without ``allow_h`` (``i16_modes="dc"``) DC alone."""
    psum = (left_col.sum(dim=-1, dtype=torch.int32) + 8) >> 4
    pred_dc = (psum if has_left else torch.full_like(psum, 128))
    pred_dc = pred_dc[:, None, None].expand(ymb.shape)
    ac, dcl, recon, bits = _i16_candidate(ymb, pred_dc, qp)
    if lam is not None:
        bits = fma32(lam, bits.float(), _ssd(recon, ymb, (1, 2)).float())
    if not allow_h:
        mode = torch.full(bits.shape, 2, dtype=torch.int32, device=bits.device)
        return ac, dcl, recon, mode, bits
    pred_h = left_col[:, :, None].expand(ymb.shape)
    ac_h, dcl_h, recon_h, bits_h = _i16_candidate(ymb, pred_h, qp)
    if lam is not None:
        bits_h = fma32(lam, bits_h.float(),
                       _ssd(recon_h, ymb, (1, 2)).float())
    use_h = (bits_h < bits) & has_left
    score = torch.where(use_h, bits_h, bits)
    sel = lambda a, b: torch.where(
        use_h.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    mode = torch.where(use_h, 1, 2).to(torch.int32)
    return sel(ac_h, ac), sel(dcl_h, dcl), sel(recon_h, recon), mode, score


def _chroma_step(cmb, left_col, has_left, qp_c):
    """One MB column of one chroma plane: DC prediction per 4x4 quadrant
    from left rows 4*by..4*by+3 (or 128 with no left MB)."""
    pq = (left_col.reshape(-1, 2, 4).sum(dim=-1, dtype=torch.int32) + 2) >> 2
    if not has_left:
        pq = torch.full_like(pq, 128)
    pred_q = pq[:, :, None, None, None]                  # (R, by, 1, 1, 1)
    w = _fwd4x4(_blocks(cmb, 2) - pred_q)
    dc = w[..., 0, 0]                                    # (R, 2, 2)
    ac = quant.h264_quantize_4x4(w, qp_c, intra=True)
    ac[..., 0, 0] = 0
    dcl = quant.h264_quantize_chroma_dc(_had2(dc), qp_c)
    dcc = quant.h264_dequantize_chroma_dc(_had2(dcl), qp_c)
    wr = quant.h264_dequantize_4x4(ac, qp_c)
    wr[..., 0, 0] = dcc
    recon = torch.clamp(pred_q + _inv4x4(wr), 0, 255)
    return ac, dcl, _unblocks(recon)


def _grid(f):
    return torch.stack([torch.stack([f(y, x) for x in range(4)], dim=-1)
                        for y in range(4)], dim=-2)


def _hu_pred(left):
    """Horizontal-Up (mode 8) from left samples L0..L3: (..., 4) -> 4x4."""
    l0, l1, l2, l3 = left.unbind(-1)
    z = [(l0 + l1 + 1) >> 1, (l0 + 2 * l1 + l2 + 2) >> 2,
         (l1 + l2 + 1) >> 1, (l1 + 2 * l2 + l3 + 2) >> 2,
         (l2 + l3 + 1) >> 1, (l2 + 3 * l3 + 2) >> 2, l3, l3]
    return _grid(lambda y, x: z[min(x + 2 * y, 7)])


def _vert_preds(p8):
    """Vertical-family predictions (V, DDL, VL) from top samples
    p[0..7,-1]: (..., 8) -> three (..., 4, 4)."""
    p = p8.unbind(-1)

    def ddl(y, x):
        i = x + y
        if i == 6:
            return (p[6] + 3 * p[7] + 2) >> 2
        return (p[i] + 2 * p[i + 1] + p[i + 2] + 2) >> 2

    def vl(y, x):
        i = x + (y >> 1)
        if y % 2 == 0:
            return (p[i] + p[i + 1] + 1) >> 1
        return (p[i] + 2 * p[i + 1] + p[i + 2] + 2) >> 2

    return _grid(lambda y, x: p[x]), _grid(ddl), _grid(vl)


def _diag_preds(t8, l4, tl):
    """The both-neighbour diagonal modes (DDR, VR, HD) from top t8 (...,
    8), left l4 (..., 4) and top-left tl (...,), spec 8.3.1.2.4-6."""
    t, l_ = t8.unbind(-1), l4.unbind(-1)

    def tt(i):                       # index -1: the top-left sample
        return tl if i < 0 else t[i]

    def ll(i):
        return tl if i < 0 else l_[i]

    def ddr(y, x):
        d = x - y
        if d > 0:
            return (tt(d - 2) + 2 * tt(d - 1) + tt(d) + 2) >> 2
        if d < 0:
            return (ll(-d - 2) + 2 * ll(-d - 1) + ll(-d) + 2) >> 2
        return (t[0] + 2 * tl + l_[0] + 2) >> 2

    def vr(y, x):
        z = 2 * x - y
        if z >= 0:
            i = x - (y >> 1)
            if z % 2 == 0:
                return (tt(i - 1) + tt(i) + 1) >> 1
            return (tt(i - 2) + 2 * tt(i - 1) + tt(i) + 2) >> 2
        if z == -1:
            return (l_[0] + 2 * tl + t[0] + 2) >> 2
        return (ll(y - 2 * x - 1) + 2 * ll(y - 2 * x - 2)
                + ll(y - 2 * x - 3) + 2) >> 2

    def hd(y, x):
        z = 2 * y - x
        if z >= 0:
            i = y - (x >> 1)
            if z % 2 == 0:
                return (ll(i - 1) + ll(i) + 1) >> 1
            return (ll(i - 2) + 2 * ll(i - 1) + ll(i) + 2) >> 2
        if z == -1:
            return (l_[0] + 2 * tl + t[0] + 2) >> 2
        return (tt(x - 2 * y - 1) + 2 * tt(x - 2 * y - 2)
                + tt(x - 2 * y - 3) + 2) >> 2

    return _grid(ddr), _grid(vr), _grid(hd)


def _i4_code_block(blk, preds, modes, legal, qp, lam=None):
    """Code every candidate, keep the cheapest by estimated bits (first on
    ties), or (``lam``, tune=hq) by SSD + lam * bits, where an illegal
    candidate scores +inf.  The candidates run stacked on a leading axis
    (one pass of tensor ops for all of them).  Returns (mode, levels_zz
    (..., 16), recon (..., 4, 4), bits or score)."""
    dev = blk.device
    zz = torch.as_tensor(ZIGZAG4, dtype=torch.long, device=dev)
    p = torch.stack(torch.broadcast_tensors(*preds))          # (K, ..., 4, 4)
    batch = p.shape[1:-2]
    ok = torch.stack([torch.ones(batch, dtype=torch.bool, device=dev)
                      if lg is True else lg.expand(batch) for lg in legal])
    # a per-MB qp (or lambda) over the candidates' axis too
    qk = qp if not isinstance(qp, torch.Tensor) else \
        qp.reshape((1,) + qp.shape + (1,) * (blk.dim() - 2 - qp.dim()))
    lv = quant.h264_quantize_4x4(_fwd4x4(blk - p), qk, intra=True)
    pick = lambda t, k: torch.take_along_dim(            # noqa: E731
        t, k.reshape((1,) + k.shape + (1,) * (t.dim() - 1 - k.dim())),
        dim=0)[0]
    if lam is not None:
        lam_k = lam.reshape((1,) + lam.shape
                            + (1,) * (blk.dim() - 2 - lam.dim()))
        rec = torch.clamp(
            p + _inv4x4(quant.h264_dequantize_4x4(lv, qk)), 0, 255)
        c = fma32(lam_k, _level_bits_est(lv, (-2, -1)).float(),
                  _ssd(rec, blk, (-2, -1)).float())
        c = torch.where(ok, c, torch.full_like(c, float("inf")))
        k = torch.argmin(c, dim=0)
        score = c.min(dim=0).values
        lv, rec = pick(lv, k), pick(rec, k)
        mode = torch.as_tensor(modes, dtype=torch.int32, device=dev)[k]
        return mode, lv.reshape(lv.shape[:-2] + (16,))[..., zz], rec, score
    b = _level_bits_est(lv, (-2, -1))
    b = torch.where(ok, b, torch.full_like(b, 1 << 30))
    k = torch.argmin(b, dim=0)
    bits = b.min(dim=0).values
    lv, pred = pick(lv, k), pick(p, k)
    mode = torch.as_tensor(modes, dtype=torch.int32, device=dev)[k]
    rec = torch.clamp(pred + _inv4x4(quant.h264_dequantize_4x4(lv, qp)),
                      0, 255)
    lvz = lv.reshape(lv.shape[:-2] + (16,))[..., zz]
    return mode, lvz, rec, bits


def _acc_score(total, score, lam):
    """Add a block's bits (score under tune=hq) to the MB's, clamped as
    the reference clamps an illegal candidate's sentinel."""
    return total + torch.clamp(score, max=(1 << 24) if lam is None else 1e18)


def _i4_row0(ymb, left_col, has_left, qp, lam, rec, raster_mode, raster_lvz,
             bits_total):
    """Block row 0 (the top of the slice, nothing above): four blocks in
    order along x with the left family {H, HU, DC (left)}, shared by the
    fast and full I4 sets.  Writes ``rec`` and the raster dicts; returns
    the MB's bits (score) so far."""
    nr, dev = ymb.shape[0], ymb.device
    avail_left = torch.full((nr,), bool(has_left), device=dev)
    for bx in range(4):
        blk = ymb[:, 0:4, bx * 4:bx * 4 + 4]
        if bx == 0:
            left4, avail = left_col[:, 0:4], avail_left
        else:
            left4 = rec[:, 0:4, bx * 4 - 1]
            avail = torch.ones((nr,), dtype=torch.bool, device=dev)
        pred_h = left4[:, :, None].expand(nr, 4, 4)
        dc = torch.where(avail, (left4.sum(dim=1, dtype=torch.int32) + 2) >> 2,
                         128)
        pred_dc = dc[:, None, None].expand(nr, 4, 4)
        mode, lvz, rb, bits = _i4_code_block(
            blk, [pred_h, _hu_pred(left4), pred_dc], [1, 8, 2],
            [avail, avail, True], qp, lam)
        rec[:, 0:4, bx * 4:bx * 4 + 4] = rb
        raster_mode[(0, bx)] = mode
        raster_lvz[(0, bx)] = lvz
        bits_total = _acc_score(bits_total, bits, lam)
    return bits_total


def _i4_stack(raster_mode, raster_lvz):
    """Raster dicts -> (levels (R, 16 blkIdx, 16), modes (R, 16 blkIdx))."""
    modes = torch.stack([raster_mode[(by, bx)]
                         for (bx, by) in LUMA_BLOCK_ORDER], dim=1)
    levels = torch.stack([raster_lvz[(by, bx)]
                          for (bx, by) in LUMA_BLOCK_ORDER], dim=1)
    return levels, modes


def _i4_start(ymb, lam):
    return (torch.zeros_like(ymb), {}, {},
            torch.zeros((ymb.shape[0],), dtype=torch.int32 if lam is None
                        else torch.float32, device=ymb.device))


def _luma_step_i4(ymb, left_col, has_left, qp, lam=None):
    """I4x4 candidate for one MB column across all rows: (levels (R, 16
    blkIdx, 16 zigzag), modes (R, 16 blkIdx), recon (R, 16, 16), bits;
    under tune=hq the float32 score, summed in the reference's order)."""
    nr = ymb.shape[0]
    dev = ymb.device
    rec, raster_mode, raster_lvz, bits_total = _i4_start(ymb, lam)
    bits_total = _i4_row0(ymb, left_col, has_left, qp, lam, rec, raster_mode,
                          raster_lvz, bits_total)
    for by in range(1, 4):                     # rows 1-3: vertical family
        blks = ymb[:, by * 4:by * 4 + 4, :].reshape(nr, 4, 4, 4)
        blks = blks.permute(0, 2, 1, 3)                      # (R, bx, y, x)
        trow = rec[:, by * 4 - 1, :].reshape(nr, 4, 4)        # (R, bx, 4)
        tr = torch.cat([trow[:, 1:], trow[:, 3:, :]], dim=1)
        sub = trow[:, :, 3:4].expand(trow.shape)
        avail_tr = torch.as_tensor(_TR_AVAIL[by], device=dev)[None, :, None]
        p8 = torch.cat([trow, torch.where(avail_tr, tr, sub)], dim=2)
        mode, lvz, rb, bits = _i4_code_block(
            blks, list(_vert_preds(p8)), [0, 3, 7], [True, True, True], qp,
            lam)
        rec[:, by * 4:by * 4 + 4, :] = rb.permute(0, 2, 1, 3).reshape(nr, 4, 16)
        for bx in range(4):
            raster_mode[(by, bx)] = mode[:, bx]
            raster_lvz[(by, bx)] = lvz[:, bx]
        if lam is None:
            bits_total = bits_total + bits.sum(dim=1, dtype=torch.int32)
        else:       # XLA reduces the four scores in order
            bits_total = bits_total + (((bits[:, 0] + bits[:, 1])
                                        + bits[:, 2]) + bits[:, 3])
    levels, modes = _i4_stack(raster_mode, raster_lvz)
    return levels, modes, rec, bits_total


# i16_modes="full": block rows 1-3 choose among all nine modes, in the
# reference's candidate order (the first minimum in THIS order wins)
FULL_I4_MODES = (0, 3, 7, 2, 1, 8, 4, 5, 6)   # V DDL VL DC H HU DDR VR HD


def _luma_step_i4_full(ymb, left_col, has_left, qp, lam=None):
    """I4x4 with the nine-mode set on block rows 1-3 (``i16_modes=
    "full"``): H, HU, DDR, VR, HD and two-sided DC read the left block's
    reconstruction, so those rows run block by block along x (16 steps
    an MB against the fast set's 7).  Same contract as
    :func:`_luma_step_i4`; under hq the score is summed a block at a
    time in block order."""
    nr, dev = ymb.shape[0], ymb.device
    rec, raster_mode, raster_lvz, bits_total = _i4_start(ymb, lam)
    bits_total = _i4_row0(ymb, left_col, has_left, qp, lam, rec, raster_mode,
                          raster_lvz, bits_total)
    avail_left = torch.full((nr,), bool(has_left), device=dev)
    for by in range(1, 4):
        y0 = by * 4
        for bx in range(4):
            blk = ymb[:, y0:y0 + 4, bx * 4:bx * 4 + 4]
            trow = rec[:, y0 - 1, bx * 4:bx * 4 + 4]
            tr = (rec[:, y0 - 1, bx * 4 + 4:bx * 4 + 8]
                  if bx < 3 and _TR_AVAIL[by, bx]
                  else trow[:, 3:4].expand(nr, 4))
            t8 = torch.cat([trow, tr], dim=1)                   # (R, 8)
            if bx == 0:
                l4, tl, avail = left_col[:, y0:y0 + 4], left_col[:, y0 - 1], \
                    avail_left
            else:
                l4, tl = rec[:, y0:y0 + 4, bx * 4 - 1], rec[:, y0 - 1, bx * 4 - 1]
                avail = torch.ones((nr,), dtype=torch.bool, device=dev)
            top = t8[:, :4].sum(dim=1, dtype=torch.int32)
            # DC: top and left where the left is available, else top only
            dc = torch.where(avail,
                             (top + l4.sum(dim=1, dtype=torch.int32) + 4) >> 3,
                             (top + 2) >> 2)
            preds = (list(_vert_preds(t8))
                     + [dc[:, None, None].expand(nr, 4, 4),
                        l4[:, :, None].expand(nr, 4, 4), _hu_pred(l4)]
                     + list(_diag_preds(t8, l4, tl)))
            mode, lvz, rb, bits = _i4_code_block(
                blk, preds, list(FULL_I4_MODES), [True] * 4 + [avail] * 5, qp,
                lam)
            rec[:, y0:y0 + 4, bx * 4:bx * 4 + 4] = rb
            raster_mode[(by, bx)] = mode
            raster_lvz[(by, bx)] = lvz
            bits_total = _acc_score(bits_total, bits, lam)
    levels, modes = _i4_stack(raster_mode, raster_lvz)
    return levels, modes, rec, bits_total


def encode_intra_frame_yuv_plain(y: torch.Tensor, cb: torch.Tensor,
                                 cr: torch.Tensor, qp: int,
                                 tune: str = "off", qp_map=None,
                                 i16_modes: str = "auto") -> dict:
    """Plain PyTorch version of K1: a loop over MB columns, vectorized
    over MB rows.  Same contract as :func:`encode_intra_frame_yuv`, with
    the full tier's ``qp_map`` given."""
    _check_modes(i16_modes)
    allow_i4 = i16_modes in ("auto", "full")
    i4_step = _luma_step_i4_full if i16_modes == "full" else _luma_step_i4
    y = y.to(torch.int32)
    cb = cb.to(torch.int32)
    cr = cr.to(torch.int32)
    dev = y.device
    pad_h, pad_w = y.shape
    nr, nc = pad_h // 16, pad_w // 16
    qp_c = quant.chroma_qp(qp)
    lam = sig = None
    if tune != "off":
        lam_tab, _, sig_tab = aq.lam_tables(tune)
        lam_tab = torch.as_tensor(lam_tab, device=dev)
        if tune == "hq":
            qpm = qp_map.to(device=dev, dtype=torch.long)
            lam_map = lam_tab[qpm]
            qc_map = quant.chroma_qp_v(qp_map.to(dev))
        else:
            lam = lam_tab[int(qp)].expand(nr)
            sig = torch.tensor(float(sig_tab[int(qp)]), dtype=torch.float32)
    ymbs = y.reshape(nr, 16, nc, 16).permute(2, 0, 1, 3)     # (C, R, 16, 16)
    cbmbs = cb.reshape(nr, 8, nc, 8).permute(2, 0, 1, 3)
    crmbs = cr.reshape(nr, 8, nc, 8).permute(2, 0, 1, 3)
    yl = torch.zeros((nr, 16), dtype=torch.int32, device=dev)
    cbl = torch.zeros((nr, 8), dtype=torch.int32, device=dev)
    crl = torch.zeros((nr, 8), dtype=torch.int32, device=dev)
    outs = []
    for c in range(nc):
        has_left = c > 0
        ymb = ymbs[c]
        qp_s, qc_s = qp, qp_c
        if tune == "hq":
            qp_s, qc_s, lam = qp_map[:, c].to(dev), qc_map[:, c], lam_map[:, c]
        y_ac, y_dc, y_rec, y_mode, bits16 = _luma_step(
            ymb, yl, has_left, qp_s, lam, allow_h=i16_modes != "dc")
        if allow_i4:
            lv4, modes4, rec4, bits4 = i4_step(ymb, yl, has_left, qp_s, lam)
            if lam is None:
                use4 = bits4 + I4_SIG_BITS < bits16
            elif sig is None:
                use4 = fma32(lam, torch.tensor(float(I4_SIG_BITS)),
                             bits4) < bits16
            else:
                use4 = bits4 + sig < bits16
            y_rec = torch.where(use4[:, None, None], rec4, y_rec)
        else:                   # "i16" / "dc": no I4 candidate
            lv4 = torch.zeros((nr, 16, 16), dtype=torch.int32, device=dev)
            modes4 = torch.full((nr, 16), 2, dtype=torch.int32, device=dev)
            use4 = torch.zeros((nr,), dtype=torch.bool, device=dev)
        cb_ac, cb_dc, cb_rec = _chroma_step(cbmbs[c], cbl, has_left, qc_s)
        cr_ac, cr_dc, cr_rec = _chroma_step(crmbs[c], crl, has_left, qc_s)
        yl, cbl, crl = y_rec[:, :, 15], cb_rec[:, :, 7], cr_rec[:, :, 7]
        outs.append((y_ac, y_dc, cb_ac, cb_dc, cr_ac, cr_dc, y_rec, cb_rec,
                     cr_rec, y_mode, lv4, modes4, use4))
    # stack along MB columns, rows first: (R, C, ...)
    (y_ac, y_dc, cb_ac, cb_dc, cr_ac, cr_dc, y_rec, cb_rec, cr_rec,
     y_mode, y_lv4, y_modes4, y_use4) = (torch.stack(t, dim=1)
                                         for t in zip(*outs))
    zz = torch.as_tensor(ZIGZAG4, dtype=torch.long, device=dev)
    blk_y = torch.as_tensor(LUMA_BLOCK_ORDER[:, 1], dtype=torch.long,
                            device=dev)
    blk_x = torch.as_tensor(LUMA_BLOCK_ORDER[:, 0], dtype=torch.long,
                            device=dev)
    y_acf = y_ac.reshape(nr, nc, 4, 4, 16)[..., zz[1:]][:, :, blk_y, blk_x]

    def plane(rec, n):
        return rec.permute(0, 2, 1, 3).reshape(nr * n, nc * n).to(torch.uint8)

    out = {
        "luma_dc": y_dc.reshape(nr, nc, 16)[..., zz],        # (R, C, 16)
        "luma_ac": y_acf,                                    # (R, C, 16, 15)
        "cb_dc": cb_dc.reshape(nr, nc, 4),                   # (R, C, 4)
        "cb_ac": cb_ac.reshape(nr, nc, 4, 16)[..., zz[1:]],  # (R, C, 4, 15)
        "cr_dc": cr_dc.reshape(nr, nc, 4),
        "cr_ac": cr_ac.reshape(nr, nc, 4, 16)[..., zz[1:]],
        "pred_mode": y_mode,                                 # (R, C)
        "mb_i4": y_use4,                                     # (R, C) bool
        "i4_modes": y_modes4,                                # (R, C, 16)
        "luma_i4": y_lv4,                                    # (R, C, 16, 16)
        "recon_y": plane(y_rec, 16),
        "recon_cb": plane(cb_rec, 8),
        "recon_cr": plane(cr_rec, 8),
    }
    if tune == "hq":
        out["qp_map"] = qp_map.to(device=dev, dtype=torch.int32)
    return out


# the reference's intra mode sets (``ENCODER_INTRA_MODES``), in the order
# of the kernel's MODES template argument
I16_MODES = ("auto", "full", "i16", "dc")


def _check_modes(i16_modes: str) -> None:
    if i16_modes not in I16_MODES:
        raise ValueError(f"unknown i16_modes {i16_modes!r}")


def _check_planes(y, cb, cr, sessions: bool = False) -> int:
    """Check MB-padded uint8 4:2:0 planes, (H, W) or, where ``sessions``,
    also (S, H, W) stacks; returns S (0 for unstacked planes)."""
    if not (y.dtype == cb.dtype == cr.dtype == torch.uint8):
        raise TypeError("planes must be uint8")
    lead = y.dim() - 2
    if (lead not in ((0, 1) if sessions else (0,))
            or y.shape[-2] % 16 or y.shape[-1] % 16):
        raise ValueError(f"luma plane {tuple(y.shape)} is not MB-aligned")
    half = tuple(y.shape[:-2]) + (y.shape[-2] // 2, y.shape[-1] // 2)
    if tuple(cb.shape) != half or tuple(cr.shape) != half:
        raise ValueError("chroma planes must be half the luma size")
    if not (y.device == cb.device == cr.device):
        raise ValueError("planes must share one device")
    if not (y.is_contiguous() and cb.is_contiguous() and cr.is_contiguous()):
        raise ValueError("planes must be contiguous")
    return y.shape[0] if lead else 0


def stack_sessions(results):
    """Per-session results (dicts or tuples of tensors) -> one result of
    the same kind with a leading session axis: how the plain versions of
    the session-stacked kernels run, session by session."""
    first = results[0]
    if isinstance(first, dict):
        return {k: torch.stack([r[k] for r in results]) for k in first}
    return tuple(torch.stack(list(col)) for col in zip(*results))


def encode_intra_frame_yuv(y: torch.Tensor, cb: torch.Tensor,
                           cr: torch.Tensor, qp: int, tune: str = "off",
                           next_y=None, i16_modes: str = "auto") -> dict:
    """YUV 4:2:0 uint8 planes (padded to MB multiples) -> level tensors,
    modes and recon planes (the reference's output dict).

    ``tune``: the kernel tier, "off", "hq_noaq" (Lagrangian decisions at
    the slice qp) or "hq" (those at each MB's qp from the qp plane, K14,
    biased by the next frame's luma ``next_y`` where given; the plane is
    the output's ``qp_map``).

    ``i16_modes`` (``ENCODER_INTRA_MODES``): "auto", I16 DC/H and the I4
    fast sets; "full", the same with all nine I4 modes on block rows 1-3;
    "i16", I16 DC/H only; "dc", I16 DC only (the native CAVLC coder's
    set).  Each is a compile-time form of the chain pass, at every tier.

    Planes stacked (S, H, W) code S sessions' frames in one launch (tune
    "off"): every output gains the leading session axis.

    CUDA tensors launch the kernel: a parallel pre-pass (a warp per MB:
    source transforms and every level that does not depend on the left
    MB) into a scratch of ``PRE_WORDS`` a MB, then the chain pass (one
    CUDA block per MB row: the left MB's recon is the only dependency; an
    I4 warp, an I16 warp and a chroma warp).  The tiers are compile-time
    forms of both; sessions are the chain's second grid axis.  CPU
    tensors run the plain version, session by session.
    """
    ns = _check_planes(y, cb, cr, sessions=True)
    if not 0 <= int(qp) <= 51:
        raise ValueError(f"qp {qp} outside 0..51")
    if tune not in aq.TIERS:
        raise ValueError(f"unknown tune {tune!r}")
    _check_modes(i16_modes)
    if ns and tune != "off":
        raise ValueError("stacked sessions take tune='off'")
    qp_map = aq.qp_plane(y, qp, next_y) if tune == "hq" else None
    if y.device.type == "cpu":
        if ns:
            return stack_sessions([encode_intra_frame_yuv_plain(
                y[i], cb[i], cr[i], int(qp), i16_modes=i16_modes)
                for i in range(ns)])
        return encode_intra_frame_yuv_plain(y, cb, cr, int(qp), tune, qp_map,
                                            i16_modes)
    pad_h, pad_w = y.shape[-2:]
    nr, nc = pad_h // 16, pad_w // 16
    dev = y.device
    lead = tuple(y.shape[:-2])

    def i32(*shape):
        return torch.empty(lead + shape, dtype=torch.int32, device=dev)

    out = {
        "luma_dc": i32(nr, nc, 16), "luma_ac": i32(nr, nc, 16, 15),
        "cb_dc": i32(nr, nc, 4), "cb_ac": i32(nr, nc, 4, 15),
        "cr_dc": i32(nr, nc, 4), "cr_ac": i32(nr, nc, 4, 15),
        "pred_mode": i32(nr, nc),
        "mb_i4": torch.empty(lead + (nr, nc), dtype=torch.bool, device=dev),
        "i4_modes": i32(nr, nc, 16), "luma_i4": i32(nr, nc, 16, 16),
        "recon_y": torch.empty_like(y), "recon_cb": torch.empty_like(cb),
        "recon_cr": torch.empty_like(cr),
    }
    keys = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
            "pred_mode", "mb_i4", "i4_modes", "luma_i4",
            "recon_y", "recon_cb", "recon_cr")
    # the pre-pass's words per MB, read back by the chain pass
    scratch = torch.empty(((ns or 1) * nr * nc, PRE_WORDS),
                          dtype=torch.int32, device=dev)
    ints = [nr, nc, int(qp), quant.chroma_qp(int(qp)),
            I16_MODES.index(i16_modes)]
    # each mode set counts on its own counter (tier 0) and its .hq
    counter = (encode_intra_frame_yuv if i16_modes == "auto"
               else getattr(encode_intra_frame_yuv, i16_modes))
    if tune == "off":
        _cuda.launch("intra", "intra_frame_launch",
                     [y, cb, cr] + [out[k] for k in keys] + [scratch],
                     ints + [ns or 1], dev)
        counter.launches += 1
        return out
    lam, sig, _ = aq.device_tables(tune, dev)
    _cuda.launch("intra", "intra_frame_hq_launch",
                 [y, cb, cr] + [out[k] for k in keys]
                 + [scratch, qp_map, lam, sig],
                 ints + [aq.TIERS.index(tune)], dev)
    counter.hq.launches += 1
    if qp_map is not None:
        out["qp_map"] = qp_map
    return out


encode_intra_frame_yuv.launches = 0
encode_intra_frame_yuv.hq = _cuda.Counter()     # the tune=hq forms
for _m in I16_MODES[1:]:        # "full", "i16", "dc": tier 0, and .hq
    setattr(encode_intra_frame_yuv, _m, _cuda.Counter())
    getattr(encode_intra_frame_yuv, _m).hq = _cuda.Counter()
del _m


def encode_intra_frame(rgb: torch.Tensor, pad_h: int, pad_w: int,
                       qp: int) -> dict:
    """RGB frame -> the intra core's output dict: the colour conversion
    (K9, ``ops/color``) then K1 on its planes.  Replaces the reference's
    ``ops/h264_device.py`` ``encode_intra_frame`` (no fused kernel: two
    launches)."""
    from .color import rgb_to_yuv420

    return encode_intra_frame_yuv(*rgb_to_yuv420(rgb, pad_h, pad_w), qp)
