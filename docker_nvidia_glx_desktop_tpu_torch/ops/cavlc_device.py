"""Device-side CAVLC for the H.264 intra path: slot coder (K2), plus the
host pieces around it (slice-header slots, the flat buffer's metadata and
Annex-B assembly).

Every 4x4 residual block (27 per MB: luma DC, 16 luma, 2 chroma DC, 8
chroma AC) is CAVLC-coded (ITU-T H.264 §9.2) into a fixed layout of 34
``(value, length)`` codeword slots (length 0 = slot unused), and every MB
gets 20 syntax slots (mb_type, I_NxN mode signalling, chroma pred mode,
cbp, mb_qp_delta).  The bit packer (K3, :mod:`.bitmerge`) concatenates
them into one RBSP per MB row inside a flat buffer whose metadata header
the host reads to cut out the rows.

K2 replaces the reference's ``ops/cavlc_device.py`` ``frame_block_slots``
(``code_blocks``, ``nc_grid``, ``intra_mb_syntax_slots``):
:func:`frame_block_slots` runs the CUDA kernels of ``csrc/cavlc.cu`` for
CUDA tensors and :func:`frame_block_slots_plain` for CPU tensors.  The
tables are built from this package's copy of ``bitstream/cavlc.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..bitstream import cavlc as ref
from ..bitstream.h264_entropy import (_CBP_INTER_TO_CODENUM,
                                      _CBP_INTRA_TO_CODENUM)
from . import _cuda, aq
from .bitmerge import (FLAT_CAP_WORDS, MAX_META_ROWS,  # noqa: F401
                       META_QP_SUM_WORD, META_WORDS, pack_frame)

_I32 = np.int32


def _build_ct_tables():
    """coeff_token as (5, 17, 4) length/bits arrays.
    Classes: 0..2 = VLC by nC range, 3 = nC>=8 six-bit FLC, 4 = chroma DC."""
    ln = np.zeros((5, 17, 4), _I32)
    bi = np.zeros((5, 17, 4), _I32)
    for cls in range(3):
        ln[cls] = np.asarray(ref._CT_LEN[cls], _I32).reshape(17, 4)
        bi[cls] = np.asarray(ref._CT_BITS[cls], _I32).reshape(17, 4)
    for tc in range(17):
        for t1 in range(min(tc, 3) + 1):
            ln[3, tc, t1], bi[3, tc, t1] = ref._ct_flc(tc, t1)
    ln[4, :5] = np.asarray(ref._CT_LEN_CDC, _I32).reshape(5, 4)
    bi[4, :5] = np.asarray(ref._CT_BITS_CDC, _I32).reshape(5, 4)
    return ln, bi


def _build_tz_tables():
    """total_zeros: luma (16, 16) and chroma-DC (3, 4), [TotalCoeff-1][tz]."""
    ln = np.zeros((16, 16), _I32)
    bi = np.zeros((16, 16), _I32)
    for i, (lens, bits) in enumerate(zip(ref._TZ_LEN, ref._TZ_BITS)):
        ln[i, :len(lens)] = lens
        bi[i, :len(bits)] = bits
    lnc = np.zeros((3, 4), _I32)
    bic = np.zeros((3, 4), _I32)
    for i, (lens, bits) in enumerate(zip(ref._TZ_LEN_CDC, ref._TZ_BITS_CDC)):
        lnc[i, :len(lens)] = lens
        bic[i, :len(bits)] = bits
    return ln, bi, lnc, bic


def _build_rb_tables():
    """run_before: (7, 15) indexed [min(zerosLeft,7)-1][run]."""
    ln = np.zeros((7, 15), _I32)
    bi = np.zeros((7, 15), _I32)
    for i, (lens, bits) in enumerate(zip(ref._RB_LEN, ref._RB_BITS)):
        ln[i, :len(lens)] = lens
        bi[i, :len(bits)] = bits
    return ln, bi


_CT_LEN, _CT_BITS = _build_ct_tables()
_TZ_LEN, _TZ_BITS, _TZC_LEN, _TZC_BITS = _build_tz_tables()
_RB_LEN, _RB_BITS = _build_rb_tables()


def _pack_lb(len_tab, bits_tab):
    """(length << 16 | bits): every VLC here has bits < 2^16, length <= 32."""
    ln = np.asarray(len_tab, np.int64)
    bi = np.asarray(bits_tab, np.int64)
    assert (bi < (1 << 16)).all() and (ln <= 32).all()
    return ((ln << 16) | bi).astype(np.int32)


_CT_PACKED = _pack_lb(_CT_LEN, _CT_BITS)
_TZ_PACKED = _pack_lb(_TZ_LEN, _TZ_BITS)
_TZC_PACKED = _pack_lb(_TZC_LEN, _TZC_BITS)

# run_before packed, shrunk to the 57 live entries: zerosLeft <= 6 rows
# only reach run <= 6, so rows 0..5 need 7 slots each and only the
# zl > 6 row needs all 15.
_RB_PACKED = np.zeros(57, np.int32)
for _row in range(6):
    for _run in range(7):
        _RB_PACKED[_row * 7 + _run] = int(
            _pack_lb(_RB_LEN[_row, _run], _RB_BITS[_row, _run]))
for _run in range(15):
    _RB_PACKED[42 + _run] = int(_pack_lb(_RB_LEN[6, _run], _RB_BITS[6, _run]))
del _row, _run

# Exp-Golomb ue(v) as (value, length) for codeNum 0..63 — covers mb_type
# (<= 25) and coded_block_pattern codeNum (<= 47).
_UE_VAL = np.arange(1, 65, dtype=_I32)               # ue bit pattern = v+1
_UE_LEN = np.array([2 * int(v).bit_length() - 1 for v in _UE_VAL], _I32)

# MB-syntax slot layout (stream order, spec 7.3.5):
#   [0]      mb_type
#   [1..16]  I_NxN per-block mode signalling (prev flag / 4-bit rem)
#   [17]     intra_chroma_pred_mode ue(0)
#   [18]     coded_block_pattern (I_NxN only; folded into mb_type for I16)
#   [19]     mb_qp_delta se(0) (absent for an I_NxN MB with cbp == 0)
MB_SYN_SLOTS = 20
BLOCK_SLOTS = 1 + 1 + 16 + 1 + 15      # coeff_token, T1 signs, levels, tz, rb
MB_BLOCKS = 27                         # 1 lumaDC + 16 lumaAC + 2 cDC + 8 cAC
HDR_SLOTS = 3                          # slice header bits (<= 96), host-coded

# luma4x4BlkIdx -> (bx, by); matches h264_device.LUMA_BLOCK_ORDER.
_BLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3], _I32)
_BLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3], _I32)


# ---------------------------------------------------------------------------
# Plain PyTorch version of K2
# ---------------------------------------------------------------------------

def _lookup(table: np.ndarray, idx: torch.Tensor, active=None) -> torch.Tensor:
    """table[idx], 0 where idx is outside the table or not ``active``."""
    tab = torch.as_tensor(np.asarray(table).reshape(-1), dtype=torch.int64,
                          device=idx.device)
    n = tab.shape[0]
    ok = (idx >= 0) & (idx < n)
    if active is not None:
        ok = ok & active
    return torch.where(ok, tab[idx.clamp(0, n - 1)], 0)


def _level_vlc(code: torch.Tensor, sl: torch.Tensor):
    """(value, length) of one level codeword (§9.2.2.1), all prefix-escape
    tiers up to level_prefix 17 (codewords of at most 32 bits)."""
    slm = torch.clamp(sl, min=1)
    prefix = code >> slm
    r_v = (1 << slm) | (code & ((1 << slm) - 1))
    r_l = prefix + 1 + sl
    esc_base = (15 << sl) + torch.where(sl == 0, 15, 0)
    b16 = esc_base + (1 << 13) - 4096
    b17 = esc_base + (1 << 14) - 4096
    in_esc12 = code < esc_base + 4096
    in_esc13 = code < b16 + (1 << 13)
    esc_v = torch.where(in_esc12, (1 << 12) | (code - esc_base),
                        torch.where(in_esc13, (1 << 13) | (code - b16),
                                    (1 << 14) | (code - b17)))
    esc_l = torch.where(in_esc12, 28, torch.where(in_esc13, 30, 32))
    v0 = torch.where(code < 14, 1,
                     torch.where(code < 30, (1 << 4) | (code - 14), esc_v))
    l0 = torch.where(code < 14, code + 1, torch.where(code < 30, 19, esc_l))
    vp = torch.where(prefix < 15, r_v, esc_v)
    lp = torch.where(prefix < 15, r_l, esc_l)
    value = torch.where(sl == 0, v0, vp) & 0xFFFFFFFF
    return value, torch.where(sl == 0, l0, lp)


def code_blocks(levels, nc, is_cdc, max_coeff):
    """CAVLC-code N blocks at once (plain version of the block coder).

    levels (N, 16) scan order; nc (N,) nC context (ignored where is_cdc);
    is_cdc (N,) bool chroma-DC blocks; max_coeff (N,) in {4, 15, 16}.
    Returns (values, lengths): (N, 34) int64 slot arrays; a *coded*
    all-zero block emits its 1-slot coeff_token."""
    levels = levels.to(torch.int64)
    dev = levels.device
    n = levels.shape[0]
    idx16 = torch.arange(16, device=dev)
    mask = levels != 0
    csum = mask.to(torch.int64).cumsum(dim=1)
    total = csum[:, -1]
    # compaction into reverse scan order (highest frequency first)
    revj = torch.where(mask, total[:, None] - csum, -1)
    onehot = revj[:, :, None] == idx16
    rev_vals = torch.where(onehot, levels[:, :, None], 0).sum(dim=1)
    rev_pos = torch.where(onehot, idx16[None, :, None], 0).sum(dim=1)

    v0, v1, v2 = rev_vals[:, 0], rev_vals[:, 1], rev_vals[:, 2]
    c0 = (total > 0) & (v0.abs() == 1)
    c1 = c0 & (total > 1) & (v1.abs() == 1)
    c2 = c1 & (total > 2) & (v2.abs() == 1)
    t1 = c0.to(torch.int64) + c1.to(torch.int64) + c2.to(torch.int64)

    cls = torch.where(is_cdc, 4, torch.where(
        nc < 2, 0, torch.where(nc < 4, 1, torch.where(nc < 8, 2, 3))))
    ct = _lookup(_CT_PACKED, (cls * 17 + total) * 4 + t1)
    s0, s1, s2 = (v0 < 0).long(), (v1 < 0).long(), (v2 < 0).long()
    sign_val = torch.where(t1 == 1, s0, torch.where(
        t1 == 2, (s0 << 1) | s1, (s0 << 2) | (s1 << 1) | s2))
    sign_val = torch.where(t1 > 0, sign_val, 0)

    # remaining levels, highest frequency first: the j-th is rev index t1+j
    pad = torch.zeros((n, 3), dtype=torch.int64, device=dev)
    lv_in = torch.cat([rev_vals, pad], dim=1).gather(
        1, t1[:, None] + idx16[None, :])
    n_levels = total - t1
    sl = torch.where((total > 10) & (t1 < 3), 1, 0)
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    lv_vals, lv_lens = [], []
    for j in range(16):
        level = lv_in[:, j]
        active = j < n_levels
        code = torch.where(level > 0, 2 * level - 2, -2 * level - 1)
        code = code - torch.where(first & (t1 < 3), 2, 0)
        value, length = _level_vlc(code, sl)
        lv_vals.append(torch.where(active, value, 0))
        lv_lens.append(torch.where(active, length, 0))
        sl_new = torch.clamp(sl, min=1)
        grow = (level.abs() > (3 << torch.clamp(sl_new - 1, min=0))) & (sl_new < 6)
        sl = torch.where(active, torch.where(grow, sl_new + 1, sl_new), sl)
        first = first & ~active

    tz = torch.where(total > 0, rev_pos[:, 0] + 1 - total, 0)
    tzi = torch.clamp(total - 1, 0, 15)
    tz_packed = torch.where(
        is_cdc, _lookup(_TZC_PACKED, torch.clamp(tzi, 0, 2) * 4 + tz.clamp(0, 3)),
        _lookup(_TZ_PACKED, tzi * 16 + tz.clamp(0, 15)))
    tz_emit = (total > 0) & (total < max_coeff)
    tz_packed = torch.where(tz_emit, tz_packed, 0)

    # run_before: gaps between consecutive nonzeros; zerosLeft is tz minus
    # the gaps already emitted (an exclusive prefix sum)
    rev_pos_next = torch.cat([rev_pos[:, 1:], rev_pos[:, :1] * 0], dim=1)
    run = torch.clamp(rev_pos[:, :15] - rev_pos_next[:, :15] - 1, 0, 14)
    zeros_left = tz[:, None] - (run.cumsum(dim=1) - run)
    k15 = torch.arange(15, device=dev)
    rb_active = (k15 <= (total - 2)[:, None]) & (zeros_left > 0)
    rb_row = torch.clamp(torch.clamp(zeros_left, max=7) - 1, 0, 6)
    rb_idx = torch.where(rb_row < 6, rb_row * 7 + torch.clamp(run, max=6),
                         42 + run)
    rb_packed = _lookup(_RB_PACKED, rb_idx, active=rb_active)

    values = torch.cat([(ct & 0xFFFF)[:, None], sign_val[:, None],
                        torch.stack(lv_vals, dim=1), (tz_packed & 0xFFFF)[:, None],
                        rb_packed & 0xFFFF], dim=1)
    lengths = torch.cat([(ct >> 16)[:, None], t1[:, None],
                         torch.stack(lv_lens, dim=1), (tz_packed >> 16)[:, None],
                         rb_packed >> 16], dim=1)
    return values, lengths


def ue_slots(v: torch.Tensor):
    """Unsigned Exp-Golomb ue(v) as (value, length) slot tensors, v >= 0:
    the codeword is v + 1 written in 2 * bit_length(v + 1) - 1 bits."""
    code = v.to(torch.int64) + 1
    nbits = torch.frexp(code.to(torch.float64))[1].to(torch.int64)
    return code, 2 * nbits - 1


def se_slots(v: torch.Tensor):
    """Signed Exp-Golomb se(v): ue of 2v - 1 (v > 0) or -2v."""
    v = v.to(torch.int64)
    return ue_slots(torch.where(v > 0, 2 * v - 1, -2 * v))


def nc_grid(tc: torch.Tensor, left_from_prev_mb: torch.Tensor) -> torch.Tensor:
    """nC for (R, C, B, B) per-block total_coeff grids: the above
    neighbour exists only inside the MB (the MB above is another slice);
    the left neighbour crosses into the previous MB's right block column."""
    na = torch.zeros_like(tc)
    na_avail = torch.zeros(tc.shape, dtype=torch.bool, device=tc.device)
    na[:, :, :, 1:] = tc[:, :, :, :-1]
    na_avail[:, :, :, 1:] = True
    na[:, 1:, :, 0] = left_from_prev_mb[:, :-1]
    na_avail[:, 1:, :, 0] = True
    nb = torch.zeros_like(tc)
    nb_avail = torch.zeros(tc.shape, dtype=torch.bool, device=tc.device)
    nb[:, :, 1:, :] = tc[:, :, :-1, :]
    nb_avail[:, :, 1:, :] = True
    return torch.where(na_avail & nb_avail, (na + nb + 1) >> 1,
                       torch.where(na_avail, na, torch.where(nb_avail, nb, 0)))


def _pad16(a: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, 16 - a.shape[-1]))


def intra_mb_syntax_slots(pred_mode, mb_i4, i4_modes, cbp_luma, cbp_luma4,
                          cbp_chroma):
    """Per-MB syntax slots (MB_SYN_SLOTS layout, spec 7.3.5), with the
    8.3.1.1 min(A, B) Intra4x4PredMode predictor under slice-per-row
    neighbour rules."""
    dev = pred_mode.device
    nr, nc_mb = cbp_luma.shape
    by = torch.as_tensor(_BLK_Y, dtype=torch.long, device=dev)
    bx = torch.as_tensor(_BLK_X, dtype=torch.long, device=dev)
    i4_modes = i4_modes.to(torch.int64)
    modes_r = torch.full((nr, nc_mb, 4, 4), 2, dtype=torch.int64, device=dev)
    modes_r[:, :, by, bx] = torch.where(mb_i4[:, :, None], i4_modes, 2)
    mode_a = torch.full_like(modes_r, 2)
    a_avail = torch.zeros(modes_r.shape, dtype=torch.bool, device=dev)
    mode_a[:, :, :, 1:] = modes_r[:, :, :, :-1]
    a_avail[:, :, :, 1:] = True
    mode_a[:, 1:, :, 0] = modes_r[:, :-1, :, 3]
    a_avail[:, 1:, :, 0] = True
    mode_b = torch.full_like(modes_r, 2)
    b_avail = torch.zeros(modes_r.shape, dtype=torch.bool, device=dev)
    mode_b[:, :, 1:, :] = modes_r[:, :, :-1, :]
    b_avail[:, :, 1:, :] = True
    pred_i4 = torch.where(a_avail & b_avail, torch.minimum(mode_a, mode_b), 2)
    pred_blk = pred_i4[:, :, by, bx]

    flag = i4_modes == pred_blk
    rem = i4_modes - (i4_modes > pred_blk).long()
    mode_vals = torch.where(flag, 1, rem)
    mode_lens = torch.where(mb_i4[:, :, None], torch.where(flag, 1, 4), 0)

    cl = cbp_luma.long()
    cc = cbp_chroma
    mbt16 = 1 + pred_mode.long() + 4 * cc + 12 * cl
    mbt_val = torch.where(mb_i4, 1, _lookup(_UE_VAL, mbt16))
    mbt_len = torch.where(mb_i4, 1, _lookup(_UE_LEN, mbt16))
    cbp = cbp_luma4 + 16 * cc
    cbp_cn = _lookup(_CBP_INTRA_TO_CODENUM, cbp)
    cbp_val = _lookup(_UE_VAL, cbp_cn)
    cbp_len = torch.where(mb_i4, _lookup(_UE_LEN, cbp_cn), 0)
    ones = torch.ones((nr, nc_mb), dtype=torch.int64, device=dev)
    qp_len = torch.where(mb_i4 & (cbp == 0), 0, 1)
    syn_vals = torch.cat([mbt_val[:, :, None], mode_vals, ones[:, :, None],
                          cbp_val[:, :, None], ones[:, :, None]], dim=2)
    syn_lens = torch.cat([mbt_len[:, :, None], mode_lens, ones[:, :, None],
                          cbp_len[:, :, None], qp_len[:, :, None]], dim=2)
    return syn_vals, syn_lens


def qp_delta_slots(qp_map, codes, slice_qp: int, shards: int = 1):
    """tune=hq's mb_qp_delta slots: the per-row chain from ``slice_qp``
    (``aq.qp_chain``) as se(v) (value, length), length 0 where the MB
    carries no delta (``codes`` false), and the frame's summed effective
    qp as a (1,) int32 tensor (the flat buffer's META_QP_SUM_WORD); with
    ``shards``, (shards,) sums of equal bands of rows (each spatial
    shard's flat buffer carries its own)."""
    eff, delta = aq.qp_chain(qp_map, codes, slice_qp)
    v, ln = se_slots(delta)
    qp_sum = eff.reshape(shards, -1).sum(dim=1, dtype=torch.int64).to(
        torch.int32)
    return v, torch.where(codes, ln, 0), qp_sum


def frame_block_slots_plain(levels: dict, slice_qp: int = None,
                            shards: int = 1):
    """Plain PyTorch version of K2: level tensors (the intra core's dict)
    -> (values, lengths, syn_vals, syn_lens), int32 (R, C, 27, 34) block
    slots and (R, C, 20) MB-syntax slots; with the full tier's
    ``qp_map`` in ``levels`` also the frame's qp sum (per band of rows
    with ``shards``: see :func:`qp_delta_slots`), the mb_qp_delta slot
    chained from ``slice_qp``."""
    luma_dc = levels["luma_dc"].long()
    luma_ac = levels["luma_ac"].long()
    cb_dc, cb_ac = levels["cb_dc"].long(), levels["cb_ac"].long()
    cr_dc, cr_ac = levels["cr_dc"].long(), levels["cr_ac"].long()
    mb_i4 = levels["mb_i4"].to(torch.bool)
    luma_i4 = levels["luma_i4"].long()
    dev = luma_dc.device
    nr, nc_mb = luma_dc.shape[:2]
    by = torch.as_tensor(_BLK_Y, dtype=torch.long, device=dev)
    bx = torch.as_tensor(_BLK_X, dtype=torch.long, device=dev)

    cbp_luma = (luma_ac != 0).any(dim=3).any(dim=2)                # (R, C)
    grp_any = (luma_i4.reshape(nr, nc_mb, 4, 64) != 0).any(dim=3)   # (R, C, 4)
    cbp_luma4 = (grp_any.long() << torch.arange(4, device=dev)).sum(dim=2)
    chroma_ac_any = ((cb_ac != 0).any(dim=3).any(dim=2)
                     | (cr_ac != 0).any(dim=3).any(dim=2))
    chroma_dc_any = (cb_dc != 0).any(dim=2) | (cr_dc != 0).any(dim=2)
    cbp_chroma = torch.where(chroma_ac_any, 2, torch.where(chroma_dc_any, 1, 0))

    grp_bit16 = grp_any.repeat_interleave(4, dim=2)                 # (R, C, 16)
    luma_gate = torch.where(mb_i4[:, :, None], grp_bit16, cbp_luma[:, :, None])
    luma_lv = torch.where(mb_i4[:, :, None, None], luma_i4, _pad16(luma_ac))
    tc_blk = (luma_lv != 0).sum(dim=3) * luma_gate
    tc_luma = torch.zeros((nr, nc_mb, 4, 4), dtype=torch.int64, device=dev)
    tc_luma[:, :, by, bx] = tc_blk

    def chroma_tc(ac):
        t = (ac != 0).sum(dim=3) * (cbp_chroma == 2)[:, :, None]
        return t.reshape(nr, nc_mb, 2, 2)

    tc_cb, tc_cr = chroma_tc(cb_ac), chroma_tc(cr_ac)
    ncl = nc_grid(tc_luma, tc_luma[:, :, :, 3])
    nccb = nc_grid(tc_cb, tc_cb[:, :, :, 1])
    nccr = nc_grid(tc_cr, tc_cr[:, :, :, 1])

    blk_levels = torch.cat([
        _pad16(luma_dc)[:, :, None, :], luma_lv,
        _pad16(cb_dc)[:, :, None, :], _pad16(cr_dc)[:, :, None, :],
        _pad16(cb_ac), _pad16(cr_ac)], dim=2)                       # (R,C,27,16)
    zeros2 = torch.zeros((nr, nc_mb, 2), dtype=torch.int64, device=dev)
    blk_nc = torch.cat([ncl[:, :, 0, 0, None], ncl[:, :, by, bx], zeros2,
                        nccb.reshape(nr, nc_mb, 4),
                        nccr.reshape(nr, nc_mb, 4)], dim=2)         # (R, C, 27)
    is_cdc = torch.zeros(MB_BLOCKS, dtype=torch.bool, device=dev)
    is_cdc[17:19] = True
    max_coeff = torch.full((nr, nc_mb, MB_BLOCKS), 15, dtype=torch.int64,
                           device=dev)
    max_coeff[:, :, 0] = 16
    max_coeff[:, :, 17:19] = 4
    max_coeff[:, :, 1:17] = torch.where(mb_i4[:, :, None], 16, 15)

    nmb = nr * nc_mb
    values, lengths = code_blocks(blk_levels.reshape(nmb * MB_BLOCKS, 16),
                                  blk_nc.reshape(-1), is_cdc.repeat(nmb),
                                  max_coeff.reshape(-1))
    values = values.reshape(nr, nc_mb, MB_BLOCKS, BLOCK_SLOTS)
    lengths = lengths.reshape(nr, nc_mb, MB_BLOCKS, BLOCK_SLOTS)

    # cbp gating: un-coded blocks emit nothing at all
    gate = torch.ones((nr, nc_mb, MB_BLOCKS), dtype=torch.bool, device=dev)
    gate[:, :, 0] = ~mb_i4
    gate[:, :, 1:17] = luma_gate
    gate[:, :, 17:19] = (cbp_chroma > 0)[:, :, None]
    gate[:, :, 19:27] = (cbp_chroma == 2)[:, :, None]
    lengths = lengths * gate[:, :, :, None]

    syn_vals, syn_lens = intra_mb_syntax_slots(
        levels["pred_mode"], mb_i4, levels["i4_modes"], cbp_luma, cbp_luma4,
        cbp_chroma)
    i32 = lambda a: a.to(torch.int32)
    res = (i32(values), i32(lengths), i32(syn_vals), i32(syn_lens))
    if "qp_map" not in levels:
        return res
    # the syntax exists for every I16 MB and for I_NxN with cbp != 0
    cbp_any = torch.where(mb_i4, cbp_luma4 > 0, cbp_luma) | (cbp_chroma > 0)
    v, ln, qp_sum = qp_delta_slots(levels["qp_map"], ~mb_i4 | cbp_any,
                                   slice_qp, shards)
    res[2][:, :, 19] = v.to(torch.int32)
    res[3][:, :, 19] = ln.to(torch.int32)
    return res + (qp_sum,)


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

_LEVEL_KEYS = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
               "pred_mode", "mb_i4", "i4_modes", "luma_i4")


def _level_shapes(nr: int, nc: int) -> dict:
    return {"luma_dc": (nr, nc, 16), "luma_ac": (nr, nc, 16, 15),
            "cb_dc": (nr, nc, 4), "cb_ac": (nr, nc, 4, 15),
            "cr_dc": (nr, nc, 4), "cr_ac": (nr, nc, 4, 15),
            "pred_mode": (nr, nc), "mb_i4": (nr, nc),
            "i4_modes": (nr, nc, 16), "luma_i4": (nr, nc, 16, 16)}


def _upload_tables(lib) -> None:
    arrays = [np.ascontiguousarray(a, np.int32) for a in (
        _CT_PACKED, _TZ_PACKED, _TZC_PACKED, _RB_PACKED,
        _CBP_INTRA_TO_CODENUM, _CBP_INTER_TO_CODENUM)]
    fn = lib.cavlc_upload_tables
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(arrays)
    err = fn(*[a.ctypes.data for a in arrays])
    if err:
        raise RuntimeError(f"cavlc_upload_tables: CUDA error {err}")


_tables_on: set = set()


def frame_block_slots(levels: dict, slice_qp: int = None,
                      shards: int = 1):
    """Level tensors -> (values, lengths, syn_vals, syn_lens) CAVLC slots;
    with the full tier's ``qp_map`` in ``levels`` a fifth, the frame's
    qp sum ((shards,) sums of equal bands of rows with ``shards``, the
    spatial shards' packers' META words), and the mb_qp_delta slots
    chained from ``slice_qp``.

    CUDA tensors launch the slot coder: a per-MB pass for cbp, gates and
    total_coeff, then one thread per 4x4 block (plus one per MB for the
    syntax slots) running the sequential CAVLC loops in registers with
    the tables in constant memory; under the full tier then one warp per
    MB row scanning the qp chain.  CPU tensors run the plain version.

    Levels with a leading session axis (the stacked intra core's, tune
    "off") give slots with one: S sessions in one launch, the session
    the grid's second axis."""
    ns = levels["luma_dc"].dim() - 3          # 1 with a session axis
    if ns not in (0, 1):
        raise ValueError("levels must be (R, C, ...) or (S, R, C, ...)")
    lead = tuple(levels["luma_dc"].shape[:ns])
    nr, nc = levels["luma_dc"].shape[ns:ns + 2]
    shapes = {k: lead + v for k, v in _level_shapes(nr, nc).items()}
    dev = levels["luma_dc"].device
    for k in _LEVEL_KEYS:
        t = levels[k]
        want = torch.bool if k == "mb_i4" else torch.int32
        if tuple(t.shape) != shapes[k] or t.dtype != want or t.device != dev:
            raise ValueError(f"levels[{k!r}]: want {shapes[k]} {want} on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    hq = "qp_map" in levels
    if hq and slice_qp is None:
        raise ValueError("a qp_map needs the slice qp")
    if hq and lead:
        raise ValueError("stacked sessions take no qp_map")
    if dev.type == "cpu":
        if lead:
            from .h264_device import stack_sessions
            return stack_sessions([frame_block_slots_plain(
                {k: levels[k][i] for k in _LEVEL_KEYS})
                for i in range(lead[0])])
        return frame_block_slots_plain(levels, slice_qp, shards)
    lib = _cuda.library("cavlc")
    if dev not in _tables_on:
        with torch.cuda.device(dev):
            _upload_tables(lib)
        _tables_on.add(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    values = torch.empty(lead + (nr, nc, MB_BLOCKS, BLOCK_SLOTS), **i32)
    lengths = torch.empty(lead + (nr, nc, MB_BLOCKS, BLOCK_SLOTS), **i32)
    syn_vals = torch.empty(lead + (nr, nc, MB_SYN_SLOTS), **i32)
    syn_lens = torch.empty(lead + (nr, nc, MB_SYN_SLOTS), **i32)
    scratch = torch.empty(lead + (nr * nc, 32), **i32)
    _cuda.launch("cavlc", "cavlc_slots_launch",
                 [levels[k] for k in _LEVEL_KEYS]
                 + [values, lengths, syn_vals, syn_lens, scratch],
                 [nr, nc, lead[0] if lead else 1], dev)
    frame_block_slots.launches += 1
    if not hq:
        return values, lengths, syn_vals, syn_lens
    qp_sum = torch.empty(shards, **i32)
    _cuda.launch("cavlc", "cavlc_qp_chain_launch",
                 [levels["qp_map"], levels["mb_i4"], scratch, syn_vals,
                  syn_lens, qp_sum, None],
                 [nr, nc, int(slice_qp), 0, shards], dev)
    frame_block_slots.hq.launches += 1
    return values, lengths, syn_vals, syn_lens, qp_sum


frame_block_slots.launches = 0
frame_block_slots.hq = _cuda.Counter()      # the qp chain (full tier)


def encode_levels(levels: dict, hdr_vals, hdr_lens, slice_qp: int,
                  shards: int = 1):
    """The intra core's dict -> the flat buffer: K2 then K3, the qp sum
    riding in the metadata under the full tier.  With ``shards`` (the
    spatial shards) the frame's rows are split into that many equal
    bands, each packed into its own flat buffer under its rows' header
    slots ``hdr_vals``/``hdr_lens`` (shards, R / shards, 3): (shards,
    FLAT_BYTES)."""
    slots = frame_block_slots(levels, slice_qp, shards)
    qp_sum = slots[4] if len(slots) > 4 else None
    if shards == 1:
        return pack_frame(*slots[:4], hdr_vals, hdr_lens, qp_sum=qp_sum)
    return pack_frame(*(shard_view(t, shards) for t in slots[:4]),
                      hdr_vals, hdr_lens, qp_sum=qp_sum)


def shard_view(t: torch.Tensor, shards: int) -> torch.Tensor:
    """A frame-shaped (R, ...) tensor as (shards, R / shards, ...): the
    spatial shards' rows, a view."""
    return t.view((shards, t.shape[0] // shards) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
# Host side: slice-header slots, flat-buffer metadata, Annex-B assembly
# ---------------------------------------------------------------------------

class FlatMeta:
    """Decoded metadata header of the flat buffer."""

    def __init__(self, meta_bytes: np.ndarray, nr: int):
        w = meta_bytes[:META_WORDS * 4].reshape(META_WORDS, 4).astype(np.uint32)
        words = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]
        self.overflow = bool(words[0])
        self.total_words = int(words[1])
        self.row_bytes = words[2:2 + nr].astype(np.int64)
        self.word_off = words[2 + MAX_META_ROWS:
                              2 + MAX_META_ROWS + nr].astype(np.int64)
        # tune=hq: summed per-MB effective qp (0 = uniform slice qp)
        self.qp_sum = int(words[META_QP_SUM_WORD])


def slice_header_slots(nr: int, nc_mb: int, *, frame_num: int,
                       idr_pic_id: int = 0, qp_delta: int = 0,
                       slice_type: int = 7, idr: bool = True,
                       deblocking_idc: int = 1):
    """Pre-encode every row's slice header into HDR_SLOTS (value, length)
    pairs (host side; tiny).  Returns (R, 3) uint32 values / int32 lengths."""
    from ..bitstream import h264 as syn
    from ..bitstream.bitwriter import BitWriter

    vals = np.zeros((nr, HDR_SLOTS), np.uint32)
    lens = np.zeros((nr, HDR_SLOTS), np.int32)
    for r in range(nr):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=r * nc_mb, slice_type=slice_type,
                         frame_num=frame_num, idr=idr,
                         idr_pic_id=idr_pic_id, qp_delta=qp_delta,
                         deblocking_idc=deblocking_idc)
        bits, nbits = bw.peek_bits()
        assert nbits <= 32 * HDR_SLOTS, "slice header exceeds slot budget"
        # split MSB-first into 32-bit chunks, right-aligned per slot
        rem = nbits
        for s in range(HDR_SLOTS):
            take = min(32, rem)
            if take <= 0:
                break
            shift = rem - take
            vals[r, s] = (bits >> shift) & ((1 << take) - 1)
            lens[r, s] = take
            rem -= take
    return vals, lens


def assemble_annexb(flat_host: np.ndarray, meta: FlatMeta,
                    *, headers: bytes = b"", nal_type: int = None,
                    ref_idc: int = 3) -> bytes:
    """Host side: split the flat buffer into rows, EPB-escape each RBSP and
    wrap it in Annex-B NALs (IDR by default)."""
    from ..bitstream import h264 as syn

    if nal_type is None:
        nal_type = syn.NAL_IDR
    base = META_WORDS * 4
    out = bytearray(headers)
    for r in range(len(meta.row_bytes)):
        start = base + 4 * int(meta.word_off[r])
        rbsp = flat_host[start:start + int(meta.row_bytes[r])].tobytes()
        out += syn.nal_unit(nal_type, rbsp, ref_idc=ref_idc)
    return bytes(out)
