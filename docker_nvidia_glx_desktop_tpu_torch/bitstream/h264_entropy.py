"""H.264 I_16x16 slice/MB entropy layer (pure-Python reference).

Consumes the quantized level tensors produced by the device stage
(:mod:`..ops.h264_device`) and emits one CAVLC slice per macroblock row —
the slice-per-row structure that legalizes the device stage's row
parallelism.  The native C++ path (``native/cavlc.cpp``) mirrors this
byte-for-byte; tests enforce equality.

nC context derivation (spec §9.2.1) is vectorized in numpy up front so the
per-block Python work is pure bit emission.
"""

from __future__ import annotations

import numpy as np

from . import h264 as syn
from .bitwriter import BitWriter
from .cavlc import encode_block

# luma4x4BlkIdx -> (bx, by); keep in sync with ops.h264_device.LUMA_BLOCK_ORDER
_BLK_XY = [(0, 0), (1, 0), (0, 1), (1, 1),
           (2, 0), (3, 0), (2, 1), (3, 1),
           (0, 2), (1, 2), (0, 3), (1, 3),
           (2, 2), (3, 2), (2, 3), (3, 3)]


def _nc_grid(tc, left_from_prev_mb):
    """Vectorized nC for a (R, C, B, B) per-block total_coeff array.

    B = 4 (luma) or 2 (chroma).  Above-neighbor exists only within the MB
    (the MB above is in another slice); left-neighbor crosses into the
    previous MB's rightmost column of blocks.
    """
    r, c, b, _ = tc.shape
    na = np.zeros_like(tc)
    na_avail = np.zeros(tc.shape, bool)
    na[:, :, :, 1:] = tc[:, :, :, :-1]
    na_avail[:, :, :, 1:] = True
    na[:, 1:, :, 0] = left_from_prev_mb[:, :-1]
    na_avail[:, 1:, :, 0] = True
    nb = np.zeros_like(tc)
    nb_avail = np.zeros(tc.shape, bool)
    nb[:, :, 1:, :] = tc[:, :, :-1, :]
    nb_avail[:, :, 1:, :] = True
    both = na_avail & nb_avail
    nc = np.where(both, (na + nb + 1) >> 1,
                  np.where(na_avail, na, np.where(nb_avail, nb, 0)))
    return nc.astype(np.int32)


# Table 9-4: coded_block_pattern me(v) mapping, Inter column:
# _CBP_INTER_CODENUM[cbp] = codeNum to write.
_CBP_INTER_TO_CODENUM = np.zeros(48, np.int32)
_CBP_INTER_BY_CODENUM = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
for _cn, _cbp in enumerate(_CBP_INTER_BY_CODENUM):
    _CBP_INTER_TO_CODENUM[_cbp] = _cn

# Table 9-4, Intra_4x4 column: _CBP_INTRA_TO_CODENUM[cbp] = codeNum.
_CBP_INTRA_TO_CODENUM = np.zeros(48, np.int32)
_CBP_INTRA_BY_CODENUM = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
assert sorted(_CBP_INTRA_BY_CODENUM) == list(range(48))
for _cn, _cbp in enumerate(_CBP_INTRA_BY_CODENUM):
    _CBP_INTRA_TO_CODENUM[_cbp] = _cn


def p_mean_coded_qp(levels: dict, qp_map, slice_qp: int) -> float:
    """Mean EFFECTIVE per-MB qp of a P frame under ``qp_map`` — the
    spec-7.4.5 chain the emitted mb_qp_delta syntax realizes (an MB
    with no syntax carries the previous coded qp).  The device CAVLC
    meta word sums exactly this chain (ops/cavlc_p_device), so host
    fallbacks MUST report the same statistic or the RateController's
    +6-qp-halves-bits normalization jitters between paths."""
    from ..ops.aq import qp_chain_np

    luma = np.asarray(levels["luma"], np.int32)
    cb_dc = np.asarray(levels["cb_dc"], np.int32)
    cb_ac = np.asarray(levels["cb_ac"], np.int32)
    cr_dc = np.asarray(levels["cr_dc"], np.int32)
    cr_ac = np.asarray(levels["cr_ac"], np.int32)
    nr, nc_mb = luma.shape[:2]
    codes = (luma.any(axis=(2, 3)) | cb_dc.any(axis=2)
             | cb_ac.any(axis=(2, 3)) | cr_dc.any(axis=2)
             | cr_ac.any(axis=(2, 3)))
    mb_intra = np.asarray(levels.get(
        "mb_intra", np.zeros((nr, nc_mb), bool)), bool)
    codes = codes | mb_intra          # I_16x16 always codes mb_qp_delta
    eff, _ = qp_chain_np(np.asarray(qp_map, np.int32), codes,
                         int(slice_qp))
    return float(eff.mean())


def intra_mean_coded_qp(levels: dict, qp_map, slice_qp: int) -> float:
    """Mean effective per-MB qp of an intra picture under ``qp_map``:
    I_16x16 always codes the syntax; an I_NxN MB with cbp == 0 carries
    the previous MB's qp (mirrors encode_intra_picture)."""
    from ..ops.aq import qp_chain_np

    luma_ac = np.asarray(levels["luma_ac"], np.int32)
    nr, nc_mb = luma_ac.shape[:2]
    mb_i4 = np.asarray(levels.get(
        "mb_i4", np.zeros((nr, nc_mb), bool)), bool)
    luma_i4 = np.asarray(levels.get(
        "luma_i4", np.zeros((nr, nc_mb, 16, 16), np.int32)), np.int32)
    cb_dc = np.asarray(levels["cb_dc"], np.int32)
    cb_ac = np.asarray(levels["cb_ac"], np.int32)
    cr_dc = np.asarray(levels["cr_dc"], np.int32)
    cr_ac = np.asarray(levels["cr_ac"], np.int32)
    chroma_any = (cb_dc.any(axis=2) | cb_ac.any(axis=(2, 3))
                  | cr_dc.any(axis=2) | cr_ac.any(axis=(2, 3)))
    i4_codes = luma_i4.any(axis=(2, 3)) | chroma_any
    codes = np.where(mb_i4, i4_codes, True)
    eff, _ = qp_chain_np(np.asarray(qp_map, np.int32), codes,
                         int(slice_qp))
    return float(eff.mean())


def encode_p_picture(levels: dict, *, frame_num: int,
                     qp_delta: int = 0, deblocking_idc: int = 1,
                     qp_map=None, slice_qp: int = None) -> bytes:
    """Assemble a P access unit (one P slice per MB row) from the inter
    device stage's tensors (:mod:`..ops.h264_inter`).

    MV prediction uses the slice-per-row geometry: neighbors B/C are in
    other slices (unavailable), so mvp = left MB's MV (spec §8.4.1.3) and
    P_Skip motion is always (0,0) (§8.4.1.1 with mbAddrB unavailable) —
    an MB is skippable exactly when mv == (0,0) and cbp == 0.

    ``qp_map`` (tune=hq): (R, C) absolute per-MB qp the device stage
    quantized with; mb_qp_delta chains from ``slice_qp`` per row (the MB
    above is in another slice) and is emitted only where the syntax
    exists (cbp != 0, or I_16x16 which always codes it) — an uncoded MB
    has no coefficients, so carrying the previous qp is conformant by
    construction.

    ``levels["mb_intra"]`` (tune=hq I16-in-P): (R, C) bool plus
    ``i16_dc`` (R, C, 16) / ``i16_ac`` (R, C, 16, 15) — MBs the
    Lagrangian mode decision coded I_16x16/DC inside the P slice
    (Table 7-11 mb_type >= 5).  Mirrors ops/cavlc_p_device byte-for-byte.
    """
    mv = np.asarray(levels["mv"], np.int32)         # (R, C, 2) quarter-pel
    luma = np.asarray(levels["luma"], np.int32)     # (R, C, 16, 16) zigzag
    cb_dc = np.asarray(levels["cb_dc"], np.int32)   # (R, C, 4)
    cb_ac = np.asarray(levels["cb_ac"], np.int32)   # (R, C, 4, 15)
    cr_dc = np.asarray(levels["cr_dc"], np.int32)
    cr_ac = np.asarray(levels["cr_ac"], np.int32)
    nr, nc_mb = luma.shape[:2]
    mb_intra = np.asarray(levels.get(
        "mb_intra", np.zeros((nr, nc_mb), bool)), bool)
    i16_dc = np.asarray(levels.get(
        "i16_dc", np.zeros((nr, nc_mb, 16), np.int32)), np.int32)
    i16_ac = np.asarray(levels.get(
        "i16_ac", np.zeros((nr, nc_mb, 16, 15), np.int32)), np.int32)

    # --- CBP: luma bit per 8x8 sub-block (bits 0-3), chroma 2 bits -----
    # luma4x4BlkIdx -> 8x8 quadrant: blkIdx//4 (the _BLK_XY grouping).
    luma8x8_any = luma.reshape(nr, nc_mb, 4, 4, 16).any(axis=(3, 4))
    cbp_luma = (luma8x8_any * (1 << np.arange(4))).sum(axis=2)   # (R, C)
    chroma_ac_any = cb_ac.any(axis=(2, 3)) | cr_ac.any(axis=(2, 3))
    chroma_dc_any = cb_dc.any(axis=2) | cr_dc.any(axis=2)
    cbp_chroma = np.where(chroma_ac_any, 2,
                          np.where(chroma_dc_any, 1, 0))
    cbp = cbp_luma + 16 * cbp_chroma                             # (R, C)
    cl15 = i16_ac.any(axis=(2, 3))                 # I16 luma cbp 0/15

    zero_mv = (mv == 0).all(axis=2)
    skip = zero_mv & (cbp == 0) & ~mb_intra                      # (R, C)

    # --- nC grids: per-4x4 total_coeff (16-coef blocks) ---------------
    tc_blk = np.count_nonzero(luma, axis=3)                      # (R,C,16)
    tc_blk = np.where(mb_intra[:, :, None],
                      np.count_nonzero(i16_ac, axis=3)
                      * cl15[:, :, None], tc_blk)
    tc_luma = np.zeros((nr, nc_mb, 4, 4), np.int32)
    for b, (bx, by) in enumerate(_BLK_XY):
        tc_luma[:, :, by, bx] = tc_blk[:, :, b]

    def chroma_tc(ac):
        t = np.count_nonzero(ac, axis=3) * (cbp_chroma == 2)[:, :, None]
        return t.reshape(nr, nc_mb, 2, 2).astype(np.int32)

    tc_cb, tc_cr = chroma_tc(cb_ac), chroma_tc(cr_ac)
    nc_luma = _nc_grid(tc_luma, tc_luma[:, :, :, 3])
    nc_cb = _nc_grid(tc_cb, tc_cb[:, :, :, 1])
    nc_cr = _nc_grid(tc_cr, tc_cr[:, :, :, 1])

    if qp_map is not None and slice_qp is None:
        raise ValueError("qp_map requires slice_qp")

    out = bytearray()
    for my in range(nr):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=5,
                         frame_num=frame_num, idr=False, qp_delta=qp_delta,
                         deblocking_idc=deblocking_idc)
        run = 0
        prev_qp = slice_qp                    # row-start chain anchor
        mvp = np.zeros(2, np.int32)      # A unavailable at row start -> 0
        for mx in range(nc_mb):
            if skip[my, mx]:
                run += 1
                mvp = np.zeros(2, np.int32)   # skipped MB's mv is (0,0)
                continue
            if mb_intra[my, mx]:
                # I_16x16/DC inside the P slice (tune=hq mode decision):
                # mb_type 5 + (1 + predMode(2) + 4*cbp_chroma + 12*cl),
                # DC chroma mode, mb_qp_delta ALWAYS, Intra16x16DCLevel
                # then 15-coef AC blocks when the (0/15) luma cbp is set.
                syn.write_ue(bw, run)
                run = 0
                cc = int(cbp_chroma[my, mx])
                cl = bool(cl15[my, mx])
                syn.write_ue(bw, 8 + 4 * cc + (12 if cl else 0))
                syn.write_ue(bw, 0)           # intra_chroma_pred_mode DC
                if qp_map is None:
                    syn.write_se(bw, 0)
                else:
                    q = int(qp_map[my, mx])
                    syn.write_se(bw, q - prev_qp)
                    prev_qp = q
                encode_block(bw, i16_dc[my, mx],
                             int(nc_luma[my, mx, 0, 0]), 16)
                if cl:
                    for b, (bx, by) in enumerate(_BLK_XY):
                        encode_block(bw, i16_ac[my, mx, b],
                                     int(nc_luma[my, mx, by, bx]), 15)
                cc2 = cc
                if cc2 > 0:
                    encode_block(bw, cb_dc[my, mx], -1, 4)
                    encode_block(bw, cr_dc[my, mx], -1, 4)
                if cc2 == 2:
                    for b in range(4):
                        by, bx = divmod(b, 2)
                        encode_block(bw, cb_ac[my, mx, b],
                                     int(nc_cb[my, mx, by, bx]), 15)
                    for b in range(4):
                        by, bx = divmod(b, 2)
                        encode_block(bw, cr_ac[my, mx, b],
                                     int(nc_cr[my, mx, by, bx]), 15)
                # an intra neighbor contributes the zero vector to mv
                # prediction (spec 8.4.1.3.2: intra -> unavailable -> 0)
                mvp = np.zeros(2, np.int32)
                continue
            syn.write_ue(bw, run)             # mb_skip_run
            run = 0
            syn.write_ue(bw, 0)               # mb_type: P_L0_16x16
            # device MVs are quarter-pel — mvd's native unit, (x, y)
            mvd = mv[my, mx] - mvp
            syn.write_se(bw, int(mvd[1]))     # mvd_l0 x
            syn.write_se(bw, int(mvd[0]))     # mvd_l0 y
            mvp = mv[my, mx].copy()
            syn.write_ue(bw, int(_CBP_INTER_TO_CODENUM[cbp[my, mx]]))
            if cbp[my, mx]:
                if qp_map is None:
                    syn.write_se(bw, 0)       # mb_qp_delta
                else:
                    q = int(qp_map[my, mx])
                    syn.write_se(bw, q - prev_qp)
                    prev_qp = q
                if cbp_luma[my, mx]:
                    for b, (bx, by) in enumerate(_BLK_XY):
                        if cbp_luma[my, mx] & (1 << (b // 4)):
                            encode_block(bw, luma[my, mx, b],
                                         int(nc_luma[my, mx, by, bx]), 16)
                cc = int(cbp_chroma[my, mx])
                if cc > 0:
                    encode_block(bw, cb_dc[my, mx], -1, 4)
                    encode_block(bw, cr_dc[my, mx], -1, 4)
                if cc == 2:
                    for b in range(4):
                        by, bx = divmod(b, 2)
                        encode_block(bw, cb_ac[my, mx, b],
                                     int(nc_cb[my, mx, by, bx]), 15)
                    for b in range(4):
                        by, bx = divmod(b, 2)
                        encode_block(bw, cr_ac[my, mx, b],
                                     int(nc_cr[my, mx, by, bx]), 15)
        if run:
            syn.write_ue(bw, run)             # trailing skip run
        syn.rbsp_trailing_bits(bw)
        out += syn.nal_unit(syn.NAL_SLICE, bw.getvalue(), ref_idc=2)
    return bytes(out)


def encode_intra_picture(levels: dict, *,
                         frame_num: int = 0, idr_pic_id: int = 0,
                         sps: bytes = b"", pps: bytes = b"",
                         with_headers: bool = True,
                         qp_delta: int = 0, deblocking_idc: int = 1,
                         qp_map=None, slice_qp: int = None) -> bytes:
    """Assemble a full IDR access unit from device-stage level tensors.

    Macroblocks are I_16x16 by default; where ``mb_i4`` is set the MB is
    coded I_NxN (spec 7.3.5/7.4.5): per-4x4-block prediction modes
    (``i4_modes``, signaled against the min(A, B) predictor of 8.3.1.1),
    4-bit luma CBP over 8x8 groups, and 16-coefficient LumaLevel4x4
    residual blocks (``luma_i4``) with no Hadamard DC split.

    ``qp_map``/``slice_qp`` (tune=hq): per-MB absolute qp; mb_qp_delta
    chains per row from ``slice_qp``.  I_16x16 always codes the syntax;
    an I_NxN MB with cbp == 0 carries the previous MB's qp instead
    (it also has no coefficients, so the chain stays conformant)."""
    luma_dc = np.asarray(levels["luma_dc"])   # (R, C, 16) zigzag
    luma_ac = np.asarray(levels["luma_ac"])   # (R, C, 16, 15)
    cb_dc = np.asarray(levels["cb_dc"])       # (R, C, 4)
    cb_ac = np.asarray(levels["cb_ac"])       # (R, C, 4, 15)
    cr_dc = np.asarray(levels["cr_dc"])
    cr_ac = np.asarray(levels["cr_ac"])
    nr, nc_mb = luma_dc.shape[:2]
    # Intra16x16PredMode per MB (2 = DC everywhere when absent — the
    # pre-mode-decision contract)
    pred_mode = np.asarray(levels.get(
        "pred_mode", np.full((nr, nc_mb), 2, np.int32)))
    mb_i4 = np.asarray(levels.get(
        "mb_i4", np.zeros((nr, nc_mb), bool)))
    i4_modes = np.asarray(levels.get(
        "i4_modes", np.full((nr, nc_mb, 16), 2, np.int32)))
    luma_i4 = np.asarray(levels.get(
        "luma_i4", np.zeros((nr, nc_mb, 16, 16), np.int32)))

    # --- coded-block-pattern gating, vectorized ---
    # I_16x16: one bit covering all AC; I_NxN: one bit per 8x8 group
    # (luma4x4BlkIdx 4b..4b+3 form group b under the z-scan).
    cbp_luma = luma_ac.any(axis=(2, 3))                       # (R, C) I16
    i4_grp_any = luma_i4.reshape(nr, nc_mb, 4, 4, 16).any(axis=(3, 4))
    cbp_luma4 = (i4_grp_any * (1 << np.arange(4))).sum(axis=2)  # (R, C)
    chroma_ac_any = cb_ac.any(axis=(2, 3)) | cr_ac.any(axis=(2, 3))
    chroma_dc_any = cb_dc.any(axis=2) | cr_dc.any(axis=2)
    cbp_chroma = np.where(chroma_ac_any, 2,
                          np.where(chroma_dc_any, 1, 0))      # (R, C)

    # --- per-block total_coeff with gating, then nC grids ---
    tc_i16 = np.count_nonzero(luma_ac, axis=3) * cbp_luma[:, :, None]
    grp_bit = (cbp_luma4[:, :, None] >> (np.arange(16) // 4)[None, None]) & 1
    tc_i4 = np.count_nonzero(luma_i4, axis=3) * grp_bit
    tc_luma_blk = np.where(mb_i4[:, :, None], tc_i4, tc_i16)  # (R, C, 16)
    tc_luma = np.zeros((nr, nc_mb, 4, 4), np.int32)           # [by][bx]
    for blk, (bx, by) in enumerate(_BLK_XY):
        tc_luma[:, :, by, bx] = tc_luma_blk[:, :, blk]

    # --- Intra4x4PredMode predictors (8.3.1.1), vectorized ---
    # Raster-layout mode grid with 2 (DC) for non-I4 MBs; A = left block
    # (crossing into the previous MB's bx=3 column), B = above block
    # (available only within the MB under slice-per-row).
    modes_r = np.full((nr, nc_mb, 4, 4), 2, np.int32)
    for blk, (bx, by) in enumerate(_BLK_XY):
        modes_r[:, :, by, bx] = np.where(mb_i4, i4_modes[:, :, blk], 2)
    mode_a = np.full((nr, nc_mb, 4, 4), 2, np.int32)
    a_avail = np.zeros((nr, nc_mb, 4, 4), bool)
    mode_a[:, :, :, 1:] = modes_r[:, :, :, :-1]
    a_avail[:, :, :, 1:] = True
    mode_a[:, 1:, :, 0] = modes_r[:, :-1, :, 3]
    a_avail[:, 1:, :, 0] = True
    mode_b = np.full((nr, nc_mb, 4, 4), 2, np.int32)
    b_avail = np.zeros((nr, nc_mb, 4, 4), bool)
    mode_b[:, :, 1:, :] = modes_r[:, :, :-1, :]
    b_avail[:, :, 1:, :] = True
    pred_i4 = np.where(a_avail & b_avail,
                       np.minimum(mode_a, mode_b), 2)         # (R,C,4,4)

    def chroma_tc(ac):
        t = np.count_nonzero(ac, axis=3) * (cbp_chroma == 2)[:, :, None]
        return t.reshape(nr, nc_mb, 2, 2).astype(np.int32)    # raster [by][bx]

    tc_cb = chroma_tc(cb_ac)
    tc_cr = chroma_tc(cr_ac)

    nc_luma = _nc_grid(tc_luma, tc_luma[:, :, :, 3])
    nc_cb = _nc_grid(tc_cb, tc_cb[:, :, :, 1])
    nc_cr = _nc_grid(tc_cr, tc_cr[:, :, :, 1])
    # Intra16x16DCLevel uses blk (0,0)'s neighbors
    nc_dc = nc_luma[:, :, 0, 0]

    out = bytearray()
    if with_headers:
        out += syn.nal_unit(syn.NAL_SPS, sps)
        out += syn.nal_unit(syn.NAL_PPS, pps)

    if qp_map is not None and slice_qp is None:
        raise ValueError("qp_map requires slice_qp")

    for my in range(nr):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=7,
                         frame_num=frame_num, idr=True, idr_pic_id=idr_pic_id,
                         qp_delta=qp_delta, deblocking_idc=deblocking_idc)
        prev_qp = slice_qp                           # row-start anchor
        for mx in range(nc_mb):
            cc = int(cbp_chroma[my, mx])
            if mb_i4[my, mx]:
                cl4 = int(cbp_luma4[my, mx])
                syn.write_ue(bw, 0)                  # mb_type: I_NxN
                for blk, (bx, by) in enumerate(_BLK_XY):
                    mode = int(i4_modes[my, mx, blk])
                    pred = int(pred_i4[my, mx, by, bx])
                    if mode == pred:
                        bw.write(1, 1)               # prev_..._flag = 1
                    else:
                        rem = mode - 1 if mode > pred else mode
                        bw.write(rem, 4)             # flag 0 + 3-bit rem
                syn.write_ue(bw, 0)                  # intra_chroma: DC
                syn.write_ue(bw, int(
                    _CBP_INTRA_TO_CODENUM[cl4 + 16 * cc]))
                if cl4 or cc:
                    if qp_map is None:
                        syn.write_se(bw, 0)          # mb_qp_delta
                    else:
                        q = int(qp_map[my, mx])
                        syn.write_se(bw, q - prev_qp)
                        prev_qp = q
                for blk, (bx, by) in enumerate(_BLK_XY):
                    if cl4 & (1 << (blk // 4)):
                        encode_block(bw, luma_i4[my, mx, blk],
                                     int(nc_luma[my, mx, by, bx]), 16)
                if cc > 0:
                    encode_block(bw, cb_dc[my, mx], -1, 4)
                    encode_block(bw, cr_dc[my, mx], -1, 4)
                if cc == 2:
                    for blk in range(4):
                        by, bx = divmod(blk, 2)
                        encode_block(bw, cb_ac[my, mx, blk],
                                     int(nc_cb[my, mx, by, bx]), 15)
                    for blk in range(4):
                        by, bx = divmod(blk, 2)
                        encode_block(bw, cr_ac[my, mx, blk],
                                     int(nc_cr[my, mx, by, bx]), 15)
                continue
            cl = bool(cbp_luma[my, mx])
            # mb_type (Table 7-11): 1 + predMode + 4*cbp_chroma + 12*cbp_luma
            syn.write_ue(bw, 1 + int(pred_mode[my, mx]) + 4 * cc
                         + (12 if cl else 0))
            syn.write_ue(bw, 0)        # intra_chroma_pred_mode: DC
            if qp_map is None:
                syn.write_se(bw, 0)    # mb_qp_delta
            else:                      # I16 always codes the syntax
                q = int(qp_map[my, mx])
                syn.write_se(bw, q - prev_qp)
                prev_qp = q
            encode_block(bw, luma_dc[my, mx], int(nc_dc[my, mx]), 16)
            if cl:
                for blk, (bx, by) in enumerate(_BLK_XY):
                    encode_block(bw, luma_ac[my, mx, blk],
                                 int(nc_luma[my, mx, by, bx]), 15)
            if cc > 0:
                encode_block(bw, cb_dc[my, mx], -1, 4)
                encode_block(bw, cr_dc[my, mx], -1, 4)
            if cc == 2:
                for blk in range(4):
                    by, bx = divmod(blk, 2)
                    encode_block(bw, cb_ac[my, mx, blk],
                                 int(nc_cb[my, mx, by, bx]), 15)
                for blk in range(4):
                    by, bx = divmod(blk, 2)
                    encode_block(bw, cr_ac[my, mx, blk],
                                 int(nc_cr[my, mx, by, bx]), 15)
        syn.rbsp_trailing_bits(bw)
        out += syn.nal_unit(syn.NAL_IDR, bw.getvalue())
    return bytes(out)
