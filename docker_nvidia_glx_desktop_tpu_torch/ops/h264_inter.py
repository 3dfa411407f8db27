"""H.264 P core (K5): motion estimation, motion compensation, inter
residual transform/quant and the closed-loop reconstruction of one frame.

Replaces the reference's ``ops/h264_inter.py`` ``encode_p_frame`` /
``encode_p_frame_padded_ref`` for ``refine`` "alt" and "full", every
``tune`` tier and ``p_intra``.  Each MB row is its own slice, so the MV
predictor is the left MB's MV and motion search has no cross-MB
dependency.  Per MB:

- coarse integer search: the 81 shifts of a step-2 grid over +-SEARCH_R
  (dy outer, dx inner), SAD over the even luma lines, ZERO_MV_BIAS/2
  off the (0, 0) candidate, first minimum wins;
- +-1 integer re-rank around it (``[(0, 0)] + neighbours``), the zero
  bias /2 on the centre only when the coarse MV is zero;
- half-pel refinement over the normative 6-tap b/h/j planes, kept only
  when ``min + HALF_BIAS/2 < current``; then quarter-pel refinement from
  rounded averages of full/half samples (``QPEL``), kept only when
  ``min + QUARTER_BIAS/2 < current`` — both on even lines;
  ``refine="full"`` (the reference's round-5 refinement, which the bench
  times) scores the +-1, half- and quarter-pel stages on every line with
  the full biases (128 / 96 / 64, or the full-line lambda margins);
- the luma prediction at the final quarter-pel MV, chroma by the 1/8-pel
  bilinear filter, 16 inter 4x4 luma blocks (no DC Hadamard), chroma
  with the 2x2 DC Hadamard, inter rounding (f = 2^qbits / 6);
- under tune=hq (``_hq_decisions``): the margins above become
  ``(int)(lam_mv * bits)`` per qp (``aq.margin_tables``), the full tier
  quantises at each MB's qp, a zero-MV MB is forced to P_Skip where its
  skip SSD is at most its coded SSD + lam * (bits + 12), and with
  ``p_intra`` an MB becomes I16x16 (DC) where its SSD + lam * (bits + 11)
  is below the inter score, kept only at the even positions of each run
  of such MBs along a row (so no intra MB has an intra left neighbour).

The reference reads an edge-padded copy of the reference planes; every
read the MV range reaches stays inside that padding, so the port clamps
coordinates instead.  Outputs: ``mv`` (R, C, 2) quarter-pel (dy, dx),
``luma`` (R, C, 16 blkIdx, 16 zigzag), ``cb_dc``/``cr_dc`` (R, C, 4),
``cb_ac``/``cr_ac`` (R, C, 4, 15), all int32, and the uint8 recon
planes.  :func:`encode_p_frame` launches ``csrc/inter.cu`` for CUDA
tensors and runs :func:`encode_p_frame_plain` for CPU tensors.

K5r, :func:`encode_p_frame_rows`, is the same kernel over a worklist of
MB rows (damage-driven encode, the reference's ``ops/damage_mask.py``
``row_core``): compacted outputs of the listed rows, each row searched
against the whole reference exactly as the full frame's row is, at every
tier, with the qp plane of the listed rows and I16-in-P over the stack.

K5p, :func:`encode_p_frame_padded_ref`, is the reference's
``encode_p_frame_padded_ref``: the same kernel reading references that
the caller padded by ``_PAD`` (the spatial shards' halo pad, where a
shard's padding rows are its neighbour's rows), with the shards stacked
on the grid's second axis as sessions are, every tier included.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, aq, quant
from .dct import fdct4x4, hadamard2x2, idct4x4
from .h264_device import (LUMA_BLOCK_ORDER, _blocks, _check_planes,
                          _i16_candidate, _level_bits_est, _unblocks, fma32)
from .scan import ZIGZAG4

SEARCH_R = 8          # +-8 luma pels integer search -> 17x17 candidates
ZERO_MV_BIAS = 128    # SAD bonus for (0,0): prefer skip-able MBs
HALF_BIAS = 96        # half-pel refine must beat integer by this margin
QUARTER_BIAS = 64     # quarter-pel refine margin over the half-pel best
_PAD = SEARCH_R + 5   # MV range + 6-tap reach + quarter-pel +1 neighbor

# The refinement stages score every other luma line under refine="alt"
# (the default), so their SADs and biases are on half scale; "full" (the
# reference's round-5 refinement) scores every line at full biases.  The
# coarse stage is on even lines either way.
REFINES = {"alt": 2, "full": 1}


def _refine_scale(refine: str) -> int:
    if refine not in REFINES:
        raise ValueError(f"unknown refine {refine!r}")
    return REFINES[refine]

# tune=hq rate model (bits): the header bits a forced skip removes, and
# the I16-in-P header (mb_type ue + chroma mode + qp delta)
_RATE_SKIP_SIG_BITS = 12.0
_RATE_I16_HDR_BITS = 11.0

# neighbours of a refinement centre, dy outer, dx inner
NEIGHBORS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0)]

# Quarter-sample prediction per fraction (fy, fx): (plane, dy, dx) of one
# or two samples to average, planes 0 = full, 1 = b (horizontal half),
# 2 = h (vertical half), 3 = j (centre), offsets in integer pels.
QPEL = {
    (0, 0): ((0, 0, 0),),
    (0, 1): ((0, 0, 0), (1, 0, 0)),       # a = (G + b + 1) >> 1
    (0, 2): ((1, 0, 0),),                 # b
    (0, 3): ((1, 0, 0), (0, 0, 1)),       # c = (b + H) — H right full
    (1, 0): ((0, 0, 0), (2, 0, 0)),       # d
    (1, 1): ((1, 0, 0), (2, 0, 0)),       # e = (b + h)
    (1, 2): ((1, 0, 0), (3, 0, 0)),       # f = (b + j)
    (1, 3): ((1, 0, 0), (2, 0, 1)),       # g = (b + m) — m right h
    (2, 0): ((2, 0, 0),),                 # h
    (2, 1): ((2, 0, 0), (3, 0, 0)),       # i = (h + j)
    (2, 2): ((3, 0, 0),),                 # j
    (2, 3): ((3, 0, 0), (2, 0, 1)),       # k = (j + m)
    (3, 0): ((2, 0, 0), (0, 1, 0)),       # n = (h + M) — M below full
    (3, 1): ((2, 0, 0), (1, 1, 0)),       # p = (h + s) — s below b
    (3, 2): ((3, 0, 0), (1, 1, 0)),       # q = (j + s)
    (3, 3): ((2, 0, 1), (1, 1, 0)),       # r = (m + s)
}


def _candidate_shifts() -> np.ndarray:
    """Coarse stage: step-2 grid over the window, (81, 2) (dy, dx) with
    dy outer."""
    steps = np.arange(-SEARCH_R, SEARCH_R + 1, 2, dtype=np.int32)
    dy, dx = np.meshgrid(steps, steps, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=1)


def _tap6(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The 6-tap half-pel filter (1, -5, 20, 20, -5, 1) along ``dim``,
    unrounded (the b1/h1 intermediates); 5 samples shorter."""
    n = x.shape[dim] - 5
    s = lambda k: x.narrow(dim, k, n)
    return s(0) - 5 * s(1) + 20 * s(2) + 20 * s(3) - 5 * s(4) + s(5)


def _halfpel_planes(ref_pad: torch.Tensor):
    """(b, h, j) half-sample planes of an edge-padded int32 reference,
    aligned so index (y, x) of each is the half sample at (y + frac/2,
    x + frac/2) of ``ref_pad[2:-3, 2:-3]``.  j is the vertical 6-tap over
    the unrounded b1 intermediates."""
    b1 = _tap6(ref_pad, 1)
    b = torch.clamp((b1 + 16) >> 5, 0, 255)
    h1 = _tap6(ref_pad, 0)
    h = torch.clamp((h1 + 16) >> 5, 0, 255)
    j = torch.clamp((_tap6(b1, 0) + 512) >> 10, 0, 255)
    return b[2:-3, :], h[:, 2:-3], j


def _edge_pad(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate the edges of a 2-D plane by ``pad`` on every side."""
    h, w = plane.shape
    iy = torch.arange(-pad, h + pad, device=plane.device).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=plane.device).clamp(0, w - 1)
    return plane[iy][:, ix]


def _windows(plane: torch.Tensor, base_y: torch.Tensor, base_x: torch.Tensor,
             size: int) -> torch.Tensor:
    """(R, C, size, size) per-MB windows ``plane[base_y + i, base_x + j]``."""
    ar = torch.arange(size, device=plane.device)
    iy = base_y[:, :, None, None] + ar[:, None]
    ix = base_x[:, :, None, None] + ar[None, :]
    return plane[iy, ix]


def _first_argmin(sads: torch.Tensor):
    """(index, value) of the first minimum along dim 0."""
    idx = torch.argmin(sads, dim=0)
    return idx, torch.gather(sads, 0, idx[None])[0]


def _padded_refs(ref_y, ref_cb, ref_cr):
    return tuple(_edge_pad(p.to(torch.int32), _PAD)
                 for p in (ref_y, ref_cb, ref_cr))


def encode_p_frame_plain(y, cb, cr, ref_y, ref_cb, ref_cr, qp: int,
                         tune: str = "off", qp_map=None,
                         p_intra: bool = False, refine: str = "alt") -> dict:
    """Plain PyTorch version of K5 (whole-frame tensor ops, the
    reference's stage order).  Same contract as :func:`encode_p_frame`,
    with the full tier's ``qp_map`` given."""
    return _p_core_plain(y, cb, cr, *_padded_refs(ref_y, ref_cb, ref_cr), qp,
                         tune, qp_map, p_intra, refine)


def encode_p_frame_rows_plain(y, cb, cr, ref_y, ref_cb, ref_cr, rows,
                              qp: int, tune: str = "off", qp_map=None,
                              p_intra: bool = False) -> dict:
    """Plain PyTorch version of K5r, as the reference's ``row_core``
    computes it: the edge-padded reference cut into one band of
    ``16 + 2*_PAD`` lines per listed row, the P core run on each band at
    the kernel tier ``tune`` (the full tier quantising at the band's row
    of the worklist's (b, C) ``qp_map``; ``p_intra``: I16-in-P within the
    band), the outputs concatenated in worklist order."""
    pry, prcb, prcr = _padded_refs(ref_y, ref_cb, ref_cr)
    outs = []
    for i, r in enumerate(rows.tolist()):
        outs.append(_p_core_plain(
            y[r * 16:r * 16 + 16], cb[r * 8:r * 8 + 8], cr[r * 8:r * 8 + 8],
            pry[r * 16:r * 16 + 16 + 2 * _PAD],
            prcb[r * 8:r * 8 + 8 + 2 * _PAD],
            prcr[r * 8:r * 8 + 8 + 2 * _PAD], qp, tune,
            None if qp_map is None else qp_map[i:i + 1], p_intra))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _p_core_plain(y, cb, cr, ref_pad, ref_pad_cb, ref_pad_cr, qp: int,
                  tune: str = "off", qp_map=None,
                  p_intra: bool = False, refine: str = "alt") -> dict:
    """The P core over int32 references edge-padded by ``_PAD``."""
    y = y.to(torch.int32)
    cb = cb.to(torch.int32)
    cr = cr.to(torch.int32)
    dev = y.device
    pad_h, pad_w = y.shape
    nr, nc = pad_h // 16, pad_w // 16
    qp_q, qp_c = qp, quant.chroma_qp(qp)
    lam_d = None
    # the refinement stages' line step and SAD scale ("full": every line)
    srow = _refine_scale(refine)
    zbc = ZERO_MV_BIAS // 2                 # the coarse stage's, always /2
    zb, hb, qb = ZERO_MV_BIAS // srow, HALF_BIAS // srow, QUARTER_BIAS // srow
    if tune != "off":
        lam_tab = torch.as_tensor(aq.lam_tables(tune)[0], device=dev)
        marg = torch.as_tensor(aq.margin_tables(tune, srow), device=dev)
        qi = (qp_map.to(device=dev, dtype=torch.long) if tune == "hq"
              else torch.full((nr, nc), int(qp), dtype=torch.long,
                              device=dev))
        lam_d = lam_tab[qi]
        zb, hb, qb = (marg[i][qi] for i in range(3))
        zbc = torch.as_tensor(aq.margin_tables(tune), device=dev)[0][qi]
        if tune == "hq":
            qp_q = qp_map.to(device=dev, dtype=torch.int32)
            qp_c = quant.chroma_qp_v(qp_q)
    rows = torch.arange(nr, device=dev)[:, None].expand(nr, nc)
    cols = torch.arange(nc, device=dev)[None, :].expand(nr, nc)

    # --- coarse grid: 81 even-line SADs per MB --------------------------
    shifts = torch.as_tensor(_candidate_shifts(), device=dev)
    y_alt = y[0::2]
    sads = []
    for dy, dx in _candidate_shifts().tolist():
        sh = ref_pad[_PAD + dy:_PAD + dy + pad_h:2, _PAD + dx:_PAD + dx + pad_w]
        sads.append((y_alt - sh).abs().reshape(nr, 8, nc, 16).sum(
            dim=(1, 3), dtype=torch.int32))
    sads = torch.stack(sads)
    zero_idx = sads.shape[0] // 2
    sads[zero_idx] -= zbc
    best, _ = _first_argmin(sads)
    mv_coarse = shifts[best]                                # (R, C, 2)

    full_pl = ref_pad[2:-3, 2:-3]
    planes = (full_pl,) + _halfpel_planes(ref_pad)
    cur_y = y.reshape(nr, 16, nc, 16).permute(0, 2, 1, 3)
    cur_cmp = cur_y[:, :, 0::srow, :]

    def sad(pred):
        return (cur_cmp - pred).abs().sum(dim=(2, 3), dtype=torch.int32)

    # --- +-1 integer re-rank: window one pel above-left of mv_coarse ------
    # plane row r*16 + 10 + mv + i is luma row r*16 + mv - 1 + i
    w18 = _windows(full_pl, rows * 16 + 10 + mv_coarse[..., 0],
                   cols * 16 + 10 + mv_coarse[..., 1], 18)
    cands = [(0, 0)] + NEIGHBORS
    int_sads = torch.stack([sad(w18[:, :, 1 + oy:17 + oy:srow, 1 + ox:17 + ox])
                            for oy, ox in cands])
    is_zero = (mv_coarse == 0).all(dim=-1)
    int_sads[0] -= torch.where(is_zero, zb, 0).to(torch.int32)
    best_int, best_sad = _first_argmin(int_sads)
    mv_int = mv_coarse + torch.as_tensor(cands, device=dev)[best_int]

    # --- half-pel refinement over the b/h/j planes ------------------------
    w = [_windows(p, rows * 16 + 10 + mv_int[..., 0],
                  cols * 16 + 10 + mv_int[..., 1], 18) for p in planes]

    def wslice(p, ry, rx):
        return w[p][:, :, 1 + ry:17 + ry:srow, 1 + rx:17 + rx]

    nb = torch.as_tensor(NEIGHBORS, device=dev)
    half_sads = torch.stack([
        sad(wslice((oy & 1) * 2 + (ox & 1), oy >> 1, ox >> 1))
        for oy, ox in NEIGHBORS])
    best_half, half_min = _first_argmin(half_sads)
    use_half = half_min + hb < best_sad
    mv_h = mv_int * 2 + torch.where(use_half[..., None], nb[best_half], 0)
    sad_h = torch.where(use_half, half_min, best_sad)

    # --- quarter-pel refinement -------------------------------------------
    def qpred(ry, rx, fy, fx):
        parts = QPEL[(fy, fx)]
        p0, dy0, dx0 = parts[0]
        a = wslice(p0, ry + dy0, rx + dx0)
        if len(parts) == 1:
            return a
        p1, dy1, dx1 = parts[1]
        return (a + wslice(p1, ry + dy1, rx + dx1) + 1) >> 1

    hdy = mv_h[..., 0] - 2 * mv_int[..., 0]                 # in {-1, 0, 1}
    hdx = mv_h[..., 1] - 2 * mv_int[..., 1]
    q_sads = []
    for qy, qx in NEIGHBORS:
        pk = torch.zeros_like(cur_cmp)
        for hy in (-1, 0, 1):
            ey = 2 * hy + qy
            for hx in (-1, 0, 1):
                ex = 2 * hx + qx
                m = ((hdy == hy) & (hdx == hx))[..., None, None]
                pk = torch.where(m, qpred(ey >> 2, ex >> 2, ey & 3, ex & 3), pk)
        q_sads.append(sad(pk))
    best_q, q_min = _first_argmin(torch.stack(q_sads))
    use_q = q_min + qb < sad_h
    mv = mv_h * 2 + torch.where(use_q[..., None], nb[best_q], 0)

    # --- final luma prediction at the chosen quarter-pel MV ---------------
    e = mv - 4 * mv_int                                     # in [-3, 3]
    rel_y, rel_x = ((e[..., k] >> 2)[..., None, None] for k in (0, 1))
    frac_y, frac_x = ((e[..., k] & 3)[..., None, None] for k in (0, 1))
    nw = []
    for t in w:
        t = torch.where(rel_y == -1, t[:, :, 0:17, :], t[:, :, 1:18, :])
        t = torch.where(rel_x == -1, t[..., 0:17], t[..., 1:18])
        nw.append(t)
    pred_y = torch.zeros_like(cur_y)
    for fy in range(4):
        for fx in range(4):
            parts = QPEL[(fy, fx)]
            p0, dy0, dx0 = parts[0]
            a = nw[p0][:, :, dy0:dy0 + 16, dx0:dx0 + 16]
            if len(parts) == 2:
                p1, dy1, dx1 = parts[1]
                a = (a + nw[p1][:, :, dy1:dy1 + 16, dx1:dx1 + 16] + 1) >> 1
            pred_y = torch.where((frac_y == fy) & (frac_x == fx), a, pred_y)

    # --- chroma MC: 1/8-pel bilinear at mv (eighth-chroma units) ----------
    c_off = mv >> 3
    c_frac = mv & 7

    def mc_chroma(rp):
        wc = _windows(rp, rows * 8 + _PAD + c_off[..., 0],
                      cols * 8 + _PAD + c_off[..., 1], 9)
        yf = c_frac[..., 0][..., None, None]
        xf = c_frac[..., 1][..., None, None]
        return ((8 - xf) * (8 - yf) * wc[:, :, :8, :8]
                + xf * (8 - yf) * wc[:, :, :8, 1:9]
                + (8 - xf) * yf * wc[:, :, 1:9, :8]
                + xf * yf * wc[:, :, 1:9, 1:9] + 32) >> 6

    # --- luma residual: 16 inter 4x4 blocks -------------------------------
    lv = quant.h264_quantize_4x4(fdct4x4(_blocks(cur_y - pred_y, 4)), qp_q,
                                 intra=False)
    recon_y = torch.clamp(
        pred_y + _unblocks(idct4x4(quant.h264_dequantize_4x4(lv, qp_q))),
        0, 255)
    zz = torch.as_tensor(ZIGZAG4, dtype=torch.long, device=dev)
    blk_y = torch.as_tensor(LUMA_BLOCK_ORDER[:, 1], dtype=torch.long,
                            device=dev)
    blk_x = torch.as_tensor(LUMA_BLOCK_ORDER[:, 0], dtype=torch.long,
                            device=dev)
    luma = lv.reshape(nr, nc, 4, 4, 16)[..., zz][:, :, blk_y, blk_x]

    def chroma(cur, pred):
        w = fdct4x4(_blocks(cur - pred, 2))                 # (R,C,2,2,4,4)
        ac = quant.h264_quantize_4x4(w, qp_c, intra=False)
        ac[..., 0, 0] = 0
        dcl = quant.h264_quantize_chroma_dc(hadamard2x2(w[..., 0, 0]), qp_c,
                                            intra=False)
        wr = quant.h264_dequantize_4x4(ac, qp_c)
        wr[..., 0, 0] = quant.h264_dequantize_chroma_dc(hadamard2x2(dcl),
                                                        qp_c)
        rec = torch.clamp(pred + _unblocks(idct4x4(wr)), 0, 255)
        return (ac.reshape(nr, nc, 4, 16)[..., zz[1:]], dcl.reshape(nr, nc, 4),
                rec)

    def mbs(plane, n):
        return plane.reshape(nr, n, nc, n).permute(0, 2, 1, 3)

    cur_cb, cur_cr = mbs(cb, 8), mbs(cr, 8)
    pred_cb, pred_cr = mc_chroma(ref_pad_cb), mc_chroma(ref_pad_cr)
    cb_ac, cb_dc, rec_cb = chroma(cur_cb, pred_cb)
    cr_ac, cr_dc, rec_cr = chroma(cur_cr, pred_cr)
    extra = {}
    if lam_d is not None:
        luma, cb_ac, cb_dc, cr_ac, cr_dc, recon_y, rec_cb, rec_cr, extra = \
            _hq_decisions(mv, lv, luma, cb_ac, cb_dc, cr_ac, cr_dc, recon_y,
                          rec_cb, rec_cr, pred_y, pred_cb, pred_cr, cur_y,
                          cur_cb, cur_cr, lam_d, qp_q, p_intra)
        mv = extra.pop("mv")
        if tune == "hq":
            extra["qp_map"] = qp_q

    def plane(rec, n):
        return rec.permute(0, 2, 1, 3).reshape(nr * n, nc * n).to(torch.uint8)

    i32 = lambda a: a.to(torch.int32).contiguous()
    res = {
        "mv": i32(mv), "luma": i32(luma),
        "cb_dc": i32(cb_dc), "cb_ac": i32(cb_ac),
        "cr_dc": i32(cr_dc), "cr_ac": i32(cr_ac),
        "recon_y": plane(recon_y, 16), "recon_cb": plane(rec_cb, 8),
        "recon_cr": plane(rec_cr, 8),
    }
    res.update({k: i32(v) if v.dtype != torch.bool else v
                for k, v in extra.items()})
    return res


def _mb_ssd(a, b) -> torch.Tensor:
    d = a - b
    return (d * d).sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)


def _hq_decisions(mv, lv, luma, cb_ac, cb_dc, cr_ac, cr_dc, recon_y, rec_cb,
                  rec_cr, pred_y, pred_cb, pred_cr, cur_y, cur_cb, cur_cr,
                  lam_d, qp_q, p_intra: bool):
    """tune=hq's decisions after the residual, as the reference takes
    them: the Lagrangian forced skip of zero-MV MBs, then (``p_intra``)
    the I16-in-P candidate of every MB from its left neighbour's
    skip-merged recon, kept where it scores below the inter candidate and
    the run-parity gate lets it (no intra MB has an intra left
    neighbour).  MB-shaped (R, C, ...) tensors in and out; ``extra``
    holds the new ``mv`` and the I16-in-P outputs."""
    nr, nc = mv.shape[:2]
    dev = mv.device
    zero_mv = (mv == 0).all(dim=-1)
    bits_mb = (_level_bits_est(lv, (2, 3, 4, 5))
               + _level_bits_est(cb_ac, (2, 3)) + _level_bits_est(cb_dc, (2,))
               + _level_bits_est(cr_ac, (2, 3))
               + _level_bits_est(cr_dc, (2,))).to(torch.float32)
    d_coded = (_mb_ssd(recon_y, cur_y) + _mb_ssd(rec_cb, cur_cb)
               + _mb_ssd(rec_cr, cur_cr))
    d_skip = (_mb_ssd(pred_y, cur_y) + _mb_ssd(pred_cb, cur_cb)
              + _mb_ssd(pred_cr, cur_cr))
    coded_score = fma32(lam_d, bits_mb + _RATE_SKIP_SIG_BITS, d_coded)
    force = zero_mv & (d_skip <= coded_score)
    f2 = force[:, :, None, None]
    f1 = force[:, :, None]
    luma = torch.where(f2, 0, luma)
    cb_ac, cr_ac = torch.where(f2, 0, cb_ac), torch.where(f2, 0, cr_ac)
    cb_dc, cr_dc = torch.where(f1, 0, cb_dc), torch.where(f1, 0, cr_dc)
    recon_y = torch.where(f2, pred_y, recon_y)
    rec_cb = torch.where(f2, pred_cb, rec_cb)
    rec_cr = torch.where(f2, pred_cr, rec_cr)
    extra = {"mv": mv}
    if not p_intra:
        return (luma, cb_ac, cb_dc, cr_ac, cr_dc, recon_y, rec_cb, rec_cr,
                extra)

    # --- the I16 (DC) candidate of every MB -----------------------------
    n = nr * nc
    has_left = (torch.arange(nc, device=dev) > 0)[None, :].expand(nr, nc)
    hl = has_left.reshape(n)

    def left_col(rec, k):
        col = torch.zeros((nr, nc, k), dtype=rec.dtype, device=dev)
        col[:, 1:] = rec[:, :-1, :, k - 1]
        return col.reshape(n, k)

    qp_i = qp_q.reshape(n) if isinstance(qp_q, torch.Tensor) else qp_q
    qc_i = (quant.chroma_qp_v(qp_i) if isinstance(qp_i, torch.Tensor)
            else quant.chroma_qp(qp_i))
    psum = (left_col(recon_y, 16).sum(dim=-1, dtype=torch.int32) + 8) >> 4
    pred_dc = torch.where(hl, psum, 128)[:, None, None].expand(n, 16, 16)
    ymb = cur_y.reshape(n, 16, 16)
    ac_i, dc_i, rec_i, bits_y = _i16_candidate(ymb, pred_dc, qp_i)

    def chroma_i(cur, rec):
        lsum = left_col(rec, 8).reshape(n, 2, 4).sum(dim=-1,
                                                     dtype=torch.int32)
        pq = torch.where(hl[:, None], (lsum + 2) >> 2, 128)
        pred_q = pq[:, :, None, None, None]                # (n, by, 1, 1, 1)
        w = fdct4x4(_blocks(cur.reshape(n, 8, 8), 2) - pred_q)
        ac = quant.h264_quantize_4x4(w, qc_i, intra=True)
        ac[..., 0, 0] = 0
        dcl = quant.h264_quantize_chroma_dc(hadamard2x2(w[..., 0, 0]), qc_i)
        wr = quant.h264_dequantize_4x4(ac, qc_i)
        wr[..., 0, 0] = quant.h264_dequantize_chroma_dc(hadamard2x2(dcl),
                                                        qc_i)
        crec = torch.clamp(pred_q + idct4x4(wr), 0, 255)
        return ac, dcl, _unblocks(crec)

    cbi_ac, cbi_dc, cbi_rec = chroma_i(cur_cb, rec_cb)
    cri_ac, cri_dc, cri_rec = chroma_i(cur_cr, rec_cr)
    bits_i = (bits_y + _level_bits_est(cbi_ac, (1, 2, 3, 4))
              + _level_bits_est(cbi_dc, (1, 2))
              + _level_bits_est(cri_ac, (1, 2, 3, 4))
              + _level_bits_est(cri_dc, (1, 2))).to(torch.float32)
    d_intra = (_mb_ssd(rec_i, ymb) + _mb_ssd(cbi_rec, cur_cb.reshape(n, 8, 8))
               + _mb_ssd(cri_rec, cur_cr.reshape(n, 8, 8)))
    lam_f = lam_d.reshape(n)
    score_intra = fma32(lam_f, bits_i + _RATE_I16_HDR_BITS, d_intra)
    score_inter = torch.where(force, d_skip + lam_d, coded_score)
    want = score_intra.reshape(nr, nc) < score_inter

    # run-parity gate: keep the even positions of each run of wanting MBs
    idx = torch.arange(nc, device=dev)[None, :].expand(nr, nc)
    last_not = torch.cummax(torch.where(~want, idx, -1), dim=1).values
    is_intra = want & ((idx - last_not - 1) % 2 == 0)

    zz = torch.as_tensor(ZIGZAG4, dtype=torch.long, device=dev)
    blk_y = torch.as_tensor(LUMA_BLOCK_ORDER[:, 1], dtype=torch.long,
                            device=dev)
    blk_x = torch.as_tensor(LUMA_BLOCK_ORDER[:, 0], dtype=torch.long,
                            device=dev)
    i2 = is_intra[:, :, None, None]
    i1 = is_intra[:, :, None]
    chroma_ac = lambda a: a.reshape(n, 4, 16)[..., zz[1:]].reshape(nr, nc, 4,
                                                                   15)
    luma = torch.where(i2, 0, luma)
    extra["mv"] = torch.where(i1, 0, mv)
    cb_ac = torch.where(i2, chroma_ac(cbi_ac), cb_ac)
    cr_ac = torch.where(i2, chroma_ac(cri_ac), cr_ac)
    cb_dc = torch.where(i1, cbi_dc.reshape(nr, nc, 4), cb_dc)
    cr_dc = torch.where(i1, cri_dc.reshape(nr, nc, 4), cr_dc)
    recon_y = torch.where(i2, rec_i.reshape(nr, nc, 16, 16), recon_y)
    rec_cb = torch.where(i2, cbi_rec.reshape(nr, nc, 8, 8), rec_cb)
    rec_cr = torch.where(i2, cri_rec.reshape(nr, nc, 8, 8), rec_cr)
    i16_dc = dc_i.reshape(n, 16)[:, zz].reshape(nr, nc, 16)
    i16_ac = ac_i.reshape(n, 4, 4, 16)[..., zz[1:]][:, blk_y, blk_x]
    extra["mb_intra"] = is_intra
    extra["i16_dc"] = torch.where(i1, i16_dc, 0)
    extra["i16_ac"] = torch.where(i2, i16_ac.reshape(nr, nc, 16, 15), 0)
    return luma, cb_ac, cb_dc, cr_ac, cr_dc, recon_y, rec_cb, rec_cr, extra


_OUT_KEYS = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
             "recon_y", "recon_cb", "recon_cr")
_INTRA_KEYS = ("mb_intra", "i16_dc", "i16_ac")


def _out_tensors(nb: int, nc: int, like: torch.Tensor, out=None,
                 keys=_OUT_KEYS, lead: tuple = ()) -> dict:
    """The P core's output tensors for ``nb`` MB rows (with the leading
    session axis ``lead``): ``out``'s where the caller gives them (views
    of a chunk's stacks), checked, else new."""
    dev = like.device
    shapes = {"mv": (nb, nc, 2), "luma": (nb, nc, 16, 16),
              "cb_dc": (nb, nc, 4), "cb_ac": (nb, nc, 4, 15),
              "cr_dc": (nb, nc, 4), "cr_ac": (nb, nc, 4, 15),
              "recon_y": (nb * 16, nc * 16), "recon_cb": (nb * 8, nc * 8),
              "recon_cr": (nb * 8, nc * 8), "qp_map": (nb, nc),
              "mb_intra": (nb, nc), "i16_dc": (nb, nc, 16),
              "i16_ac": (nb, nc, 16, 15)}
    res = {}
    for k in keys:
        shape = lead + shapes[k]
        dt = (torch.uint8 if k.startswith("recon") else
              torch.bool if k == "mb_intra" else torch.int32)
        t = None if out is None else out.get(k)
        if t is None:
            t = torch.empty(shape, dtype=dt, device=dev)
        elif (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
              or not t.is_contiguous()):
            raise ValueError(f"out[{k!r}]: want contiguous {shape} {dt} on "
                             f"{dev}")
        res[k] = t
    return res


def _check_qp(qp, qp_dev, device) -> None:
    if not 0 <= int(qp) <= 51:
        raise ValueError(f"qp {qp} outside 0..51")
    if qp_dev is not None and (qp_dev.dtype != torch.int32
                               or qp_dev.numel() != 1
                               or qp_dev.device != device):
        raise ValueError("qp_dev must be one int32 on the planes' device")


def encode_p_frame(y, cb, cr, ref_y, ref_cb, ref_cr, qp: int,
                   refine: str = "alt", tune: str = "off",
                   p_intra: bool = False, qp_dev=None, out=None,
                   next_y=None, rows=None) -> dict:
    """P core for one frame: current and reference uint8 YUV 4:2:0
    planes (MB-padded) -> MVs, level tensors and recon planes.

    ``tune``: the kernel tier.  "hq_noaq" and "hq" scale the motion
    margins by lambda, take the Lagrangian forced skip, and (``p_intra``)
    code an MB I16x16 inside the P slice where that scores lower (the
    outputs gain ``mb_intra``, ``i16_dc`` and ``i16_ac``); "hq" also
    quantises at each MB's qp from the qp plane (K14, with the lookahead
    bias of ``next_y``), output as ``qp_map``.

    The reference planes are only read: the recon goes to new buffers
    (``out``'s, where given), so a pipelined caller may keep them.  CUDA
    tensors launch the kernel (one CUDA block per MB: every MB's search
    and residual is independent; under ``p_intra`` then a pass over every
    MB's I16 candidate, which reads its left neighbour's recon, and a
    pass per MB row that gates and merges them); CPU tensors run the
    plain version.  ``qp_dev`` (CUDA only: one int32 on the card) makes
    the kernels read the slice qp from device memory instead of ``qp``.

    Planes stacked (S, H, W), frames and references alike, code S
    sessions' P frames in one launch (tune "off"; the session the grid's
    second axis, each session searching its own reference): every output
    gains the leading session axis.  ``rows``: K5r's worklist, as
    :func:`encode_p_frame_rows` checks and documents it."""
    srow = _refine_scale(refine)
    if tune not in aq.TIERS:
        raise ValueError(f"unknown tune {tune!r}")
    if p_intra and tune == "off":
        raise ValueError("p_intra requires tune=hq/hq_noaq")
    ns = _check_planes(y, cb, cr, sessions=True)
    _check_planes(ref_y, ref_cb, ref_cr, sessions=True)
    if ref_y.shape != y.shape or ref_y.device != y.device:
        raise ValueError("reference planes must match the current frame")
    if ns and (tune != "off" or refine != "alt"):
        raise ValueError("stacked sessions take tune='off', refine='alt'")
    _check_qp(qp, qp_dev, y.device)
    lead = tuple(y.shape[:-2])
    nr, nc = y.shape[-2] // 16, y.shape[-1] // 16
    nb = nr if rows is None else rows.numel()
    keys = _OUT_KEYS + (("qp_map",) if tune == "hq" else ()) \
        + (_INTRA_KEYS if p_intra else ())
    qp_map = None
    if tune == "hq":
        qp_map = aq.qp_plane(y, qp, next_y, qp_dev,
                             None if out is None else out.get("qp_map"),
                             rows=rows)
    if y.device.type == "cpu":
        if rows is not None:
            plain = encode_p_frame_rows_plain(y, cb, cr, ref_y, ref_cb,
                                              ref_cr, rows, int(qp), tune,
                                              qp_map, p_intra)
        elif ns:
            from .h264_device import stack_sessions
            plain = stack_sessions([encode_p_frame_plain(
                y[i], cb[i], cr[i], ref_y[i], ref_cb[i], ref_cr[i], int(qp))
                for i in range(ns)])
        else:
            plain = encode_p_frame_plain(y, cb, cr, ref_y, ref_cb, ref_cr,
                                         int(qp), tune, qp_map, p_intra,
                                         refine)
        if out is None:
            return plain
        res = _out_tensors(nb, nc, y, out, keys, lead)
        return {k: res[k].copy_(plain[k]) for k in keys}
    res = _out_tensors(nb, nc, y, out, keys, lead)
    dev = y.device
    qpi = [int(qp), quant.chroma_qp(int(qp))]
    if tune == "off" and srow == 2:
        _cuda.launch("inter", "inter_frame_launch",
                     [y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev]
                     + [res[k] for k in _OUT_KEYS],
                     [nr, nc, nb] + qpi + [ns or 1], dev)
        (encode_p_frame if rows is None else encode_p_frame_rows).launches += 1
        return res
    lam = marg = None
    if tune != "off":
        lam, _, marg = aq.device_tables(tune, dev, srow)
    score = (torch.empty((nb, nc), dtype=torch.float32, device=dev)
             if p_intra else None)
    tier = aq.TIERS.index(tune)
    # refine="full": its own form of the kernel at every tier
    _cuda.launch("inter", "inter_frame_hq_launch",
                 [y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam,
                  marg] + [res[k] for k in _OUT_KEYS] + [score],
                 [nr, nc, nb] + qpi + [tier, int(srow == 1)], dev)
    (encode_p_frame_rows.hq if rows is not None else encode_p_frame.hq
     if srow == 2 else encode_p_frame.full.hq if tier
     else encode_p_frame.full).launches += 1
    if p_intra:
        _i16_passes(y, cb, cr, res, qp_dev, qp_map, lam, score, nb, nc, qpi,
                    tier, dev, rows=rows)
    if qp_map is not None:
        res["qp_map"] = qp_map
    return res


def _i16_passes(y, cb, cr, res, qp_dev, qp_map, lam, score, nr: int,
                nc: int, qpi, tier: int, dev, rows=None) -> None:
    """I16-in-P after the hq form of K5, K5p or K5r: every MB's I16
    candidate (pass 2), then per MB row the run-parity gate and the merge
    (pass 3), over the nr x nc MBs of ``res`` (frame-shaped memory, or
    the stack of the worklist ``rows``, whose current MBs lie at frame
    row ``rows[i]``)."""
    n = nr * nc
    cand = {"want": torch.empty((nr, nc), dtype=torch.uint8, device=dev),
            "ac": torch.empty((n, 16, 15), dtype=torch.int32, device=dev),
            "cac": torch.empty((n, 2, 4, 15), dtype=torch.int32, device=dev),
            "cdc": torch.empty((n, 2, 4), dtype=torch.int32, device=dev),
            "ry": torch.empty((n, 256), dtype=torch.uint8, device=dev),
            "rc": torch.empty((n, 2, 64), dtype=torch.uint8, device=dev)}
    # both passes in one host call (two kernels and the gate)
    _cuda.launch("inter", "inter_intra_launch",
                 [y, cb, cr, rows, qp_dev, qp_map, lam, score, cand["want"],
                  res["i16_dc"], cand["ac"], cand["cac"], cand["cdc"],
                  cand["ry"], cand["rc"]] + [res[k] for k in _OUT_KEYS]
                 + [res["mb_intra"], res["i16_ac"]],
                 [nr, nc] + list(qpi) + [tier], dev)
    if rows is None:
        encode_p_frame.i16.launches += 1
        encode_p_frame.merge.launches += 1
    else:
        encode_p_frame_rows.i16.launches += 1


encode_p_frame.launches = 0
encode_p_frame.hq = _cuda.Counter()      # the tune=hq form (pass 1)
encode_p_frame.i16 = _cuda.Counter()     # I16-in-P candidates (pass 2)
encode_p_frame.merge = _cuda.Counter()   # run-parity gate and merge (pass 3)
encode_p_frame.full = _cuda.Counter()    # refine="full" (pass 1), tier 0
encode_p_frame.full.hq = _cuda.Counter()  # ... tiers 1, 2


def encode_p_frame_rows(y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp: int,
                        tune: str = "off", next_y=None, p_intra: bool = False,
                        qp_dev=None) -> dict:
    """K5r: the P core over the MB rows ``rows`` (int32 (b,), each in
    0..R-1, duplicates allowed) of a frame -> compacted outputs: ``mv``
    (b, C, 2), the level tensors (b, C, ...) and recon planes (16b, W) /
    (8b, W/2), row i of each from frame row ``rows[i]``.  Every row's
    search reads the whole reference, clamped at the frame's edges.

    ``tune``, ``p_intra`` and ``next_y`` as :func:`encode_p_frame`'s, as
    the reference's ``row_core`` runs them band by band: the full tier's
    qp plane covers the listed rows (K14r, ``qp_map`` (b, C), the
    lookahead bias from the same rows of ``next_y``), and I16-in-P adds
    ``mb_intra``/``i16_dc``/``i16_ac`` (b, C, ...), each MB's candidate
    predicted from its left neighbour in its own stack row.

    CUDA tensors launch K5's kernel on b * C blocks (then, under
    ``p_intra``, the I16-in-P passes over the b rows); CPU tensors run
    :func:`encode_p_frame_rows_plain`."""
    _check_planes(y, cb, cr)
    nr = y.shape[0] // 16
    if (rows.dim() != 1 or rows.dtype != torch.int32 or rows.device != y.device
            or not 0 < rows.numel() <= nr):
        raise ValueError(f"rows must be 1 to {nr} int32 on {y.device}")
    if y.device.type == "cpu" and (bool((rows < 0).any())
                                   or bool((rows >= nr).any())):
        raise ValueError(f"rows outside 0..{nr - 1}")
    return encode_p_frame(y, cb, cr, ref_y, ref_cb, ref_cr, qp, tune=tune,
                          p_intra=p_intra, qp_dev=qp_dev, next_y=next_y,
                          rows=rows.contiguous())


encode_p_frame_rows.launches = 0
encode_p_frame_rows.hq = _cuda.Counter()    # tiers 1, 2 (pass 1)
encode_p_frame_rows.i16 = _cuda.Counter()   # I16-in-P passes 2, 3 over the rows


def encode_p_frame_padded_ref_plain(y, cb, cr, ref_y_pad, ref_cb_pad,
                                    ref_cr_pad, qp: int, tune: str = "off",
                                    qp_map=None, p_intra: bool = False,
                                    refine: str = "alt") -> dict:
    """Plain PyTorch version of K5p: the P core of one frame (H, W) over
    references padded by ``_PAD`` ((H + 26, W + 26) and the chroma's),
    with the full tier's ``qp_map`` given."""
    return _p_core_plain(y, cb, cr, *(p.to(torch.int32) for p in (
        ref_y_pad, ref_cb_pad, ref_cr_pad)), int(qp), tune, qp_map, p_intra,
        refine)


def encode_p_frame_padded_ref(y, cb, cr, ref_y_pad, ref_cb_pad, ref_cr_pad,
                              qp: int, refine: str = "alt",
                              tune: str = "off", next_y=None,
                              p_intra: bool = False, qp_dev=None,
                              out=None) -> dict:
    """K5p: the P core over references already padded by ``_PAD`` on
    every side (uint8: the spatial shards' halo pad, neighbour rows at
    the seams) instead of the clamped reads of :func:`encode_p_frame`.

    One frame: ``y`` (H, W) with ``ref_y_pad`` (H + 26, W + 26) and the
    chroma's (H/2 + 26, W/2 + 26).  S shards stacked: ``y`` (S, h, W)
    with pads (S, h + 26, W + 26), each shard searching its own padded
    reference, every output with the leading shard axis (``out``'s
    tensors likewise, where given).  ``tune``, ``p_intra``, ``qp_dev``
    and ``next_y`` as :func:`encode_p_frame`'s; under the full tier the
    qp plane (K14) and, with ``p_intra``, the I16-in-P passes run over
    the shards' rows as one frame's (each is a function of an MB and its
    left neighbour).  CUDA tensors launch the kernel, one CUDA block per
    MB, the shard the grid's second axis; CPU tensors run the plain
    version shard by shard."""
    srow = _refine_scale(refine)
    if tune not in aq.TIERS:
        raise ValueError(f"unknown tune {tune!r}")
    if p_intra and tune == "off":
        raise ValueError("p_intra requires tune=hq/hq_noaq")
    ns = _check_planes(y, cb, cr, sessions=True)
    lead = tuple(y.shape[:-2])
    h, w = y.shape[-2:]
    want = (lead + (h + 2 * _PAD, w + 2 * _PAD),
            lead + (h // 2 + 2 * _PAD, w // 2 + 2 * _PAD))
    for p, shape in zip((ref_y_pad, ref_cb_pad, ref_cr_pad),
                        (want[0], want[1], want[1])):
        if (tuple(p.shape) != shape or p.dtype != torch.uint8
                or p.device != y.device or not p.is_contiguous()):
            raise ValueError(f"padded reference {tuple(p.shape)}: want "
                             f"contiguous uint8 {shape} on {y.device}")
    _check_qp(qp, qp_dev, y.device)
    s = ns or 1
    nr, nc = h // 16, w // 16
    keys = _OUT_KEYS + (("qp_map",) if tune == "hq" else ()) \
        + (_INTRA_KEYS if p_intra else ())
    frame = lambda t: t.reshape((s * t.shape[-2],) + tuple(t.shape[-1:]))
    qp_map = None
    if tune == "hq":
        q_out = None if out is None else out.get("qp_map")
        qp_map = aq.qp_plane(frame(y), qp,
                             None if next_y is None else frame(next_y),
                             qp_dev, None if q_out is None
                             else q_out.view(s * nr, nc))
        qp_map = qp_map.view(lead + (nr, nc))
    if y.device.type == "cpu":
        one = lambda i: encode_p_frame_padded_ref_plain(
            *(t[i] if ns else t for t in (y, cb, cr, ref_y_pad, ref_cb_pad,
                                         ref_cr_pad)), int(qp), tune,
            None if qp_map is None else (qp_map[i] if ns else qp_map),
            p_intra, refine)
        if ns:
            from .h264_device import stack_sessions
            plain = stack_sessions([one(i) for i in range(ns)])
        else:
            plain = one(None)
        if out is None:
            return plain
        res = _out_tensors(nr, nc, y, out, keys, lead)
        return {k: res[k].copy_(plain[k]) for k in keys}
    res = _out_tensors(nr, nc, y, out, keys, lead)
    dev = y.device
    lam = marg = score = None
    tier = aq.TIERS.index(tune)
    if tune != "off":
        lam, _, marg = aq.device_tables(tune, dev, srow)
    if p_intra:
        score = torch.empty(lead + (nr, nc), dtype=torch.float32, device=dev)
    qpi = [int(qp), quant.chroma_qp(int(qp))]
    _cuda.launch("inter", "inter_frame_padded_launch",
                 [y, cb, cr, ref_y_pad, ref_cb_pad, ref_cr_pad, qp_dev, qp_map,
                  lam, marg] + [res[k] for k in _OUT_KEYS] + [score],
                 [nr, nc] + qpi + [tier, s, int(srow == 1)], dev)
    (encode_p_frame_padded_ref if srow == 2 else
     encode_p_frame_padded_ref.full.hq if tier else
     encode_p_frame_padded_ref.full).launches += 1
    if p_intra:
        _i16_passes(frame(y), frame(cb), frame(cr), res, qp_dev,
                    None if qp_map is None else qp_map.view(s * nr, nc),
                    lam, score, s * nr, nc, qpi, tier, dev)
    if qp_map is not None:
        res["qp_map"] = qp_map
    return res


encode_p_frame_padded_ref.launches = 0
encode_p_frame_padded_ref.full = _cuda.Counter()     # refine="full", tier 0
encode_p_frame_padded_ref.full.hq = _cuda.Counter()  # ... tiers 1, 2
