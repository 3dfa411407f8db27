"""Device-side CAVLC for P frames: the P slot coder (K6) and the fused
P stage around it (P core K5, slots K6, packer K7).

Replaces the reference's ``ops/cavlc_p_device.py`` (``p_mb_header_slots``,
``p_frame_block_slots`` for inter MBs, ``pack_p_frame``,
``encode_p_cavlc_frame``, ``_finish_p``):

- **mb_skip_run**: with slice-per-row a skipped MB is exactly ``mv ==
  (0, 0) and cbp == 0``; each coded MB's header carries the run of
  skipped MBs before it, and each row ends with its trailing run.
- **mvd**: mvp is the left MB's MV (spec 8.4.1.3 with B/C in other
  slices), so mvd = mv - left mv, x first.
- **residual blocks**: 26 per MB (16 luma 16-coefficient blocks, 2
  chroma DC, 8 chroma AC), gated by the inter CBP (a luma bit per 8x8
  group, Table 9-4 inter codeNum).

Slot layouts: block slots (R, C, 26, 34) as the intra coder's; MB header
(R, C, 7) = skip_run, mb_type, mvd_x, mvd_y, cbp, intra_chroma_pred_mode,
mb_qp_delta — every length 0 for a skipped MB.

tune=hq: with the P core's ``qp_map`` the mb_qp_delta slot carries the
per-row qp chain (``aq.qp_chain``: cbp != 0 or I16 MBs code it) and the
flat buffer's META_QP_SUM_WORD the summed effective qp; with its
``mb_intra`` (I16-in-P) every MB has 27 block slots, block 0 the
Intra16x16DCLevel (coded for intra MBs only), the 16 luma slots of an
intra MB its 15-coefficient AC blocks, and an intra MB's header codes
mb_type 5 + the I16 type with the cbp folded in, no mvd and no cbp, and
intra_chroma_pred_mode DC.
:func:`p_frame_slots` launches ``csrc/cavlc.cu``'s P kernels for CUDA
tensors and runs :func:`p_frame_slots_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from ..bitstream.h264_entropy import _CBP_INTER_TO_CODENUM
from . import _cuda, h264_inter
from .bitmerge import pack_p_frame
from .cavlc_device import (_BLK_X, _BLK_Y, BLOCK_SLOTS, _pad16, _tables_on,
                           _upload_tables, code_blocks, nc_grid,
                           qp_delta_slots, se_slots, shard_view, ue_slots)

P_MB_BLOCKS = 26          # 16 luma + 2 chroma DC + 8 chroma AC
P_MB_BLOCKS_I = 27        # + Intra16x16DCLevel (tune=hq I16-in-P)
HDR_SLOT_COUNT = 7        # skip_run, mb_type, mvd_x, mvd_y, cbp,
                          # intra_chroma_pred_mode, qp_delta
_CBP_TO_CODENUM = _CBP_INTER_TO_CODENUM      # cbp (0..47) -> inter codeNum

_LEVEL_KEYS = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")


def p_mb_header_slots(mv: torch.Tensor, cbp: torch.Tensor, qp_se=None,
                      mb_intra=None):
    """Per-MB P-slice header slots and each row's trailing skip run.

    mv (R, C, 2) quarter-pel (dy, dx); cbp (R, C), an intra MB's the I16
    pattern (luma 0/15 + 16 * chroma); ``qp_se`` the (value, length)
    mb_qp_delta slots of the qp chain (tune=hq), ``mb_intra`` the I16-in-P
    MBs.  Returns (vals (R, C, 7), lens (R, C, 7) — all zero for skipped
    MBs —, trail_vals (R,), trail_lens (R,), skip (R, C) bool), int64."""
    nr, nc = cbp.shape
    dev = cbp.device
    intra = (torch.zeros((nr, nc), dtype=torch.bool, device=dev)
             if mb_intra is None else mb_intra.to(torch.bool))
    skip = (mv == 0).all(dim=-1) & (cbp == 0) & ~intra
    coded = ~skip
    idx = torch.arange(nc, device=dev)[None, :].expand(nr, nc)
    # most recent coded MB at or before each position, -1 if none
    prev_incl = torch.cummax(torch.where(coded, idx, -1), dim=1).values
    prev_excl = torch.cat([torch.full((nr, 1), -1, dtype=prev_incl.dtype,
                                      device=dev), prev_incl[:, :-1]], dim=1)
    run = idx - prev_excl - 1
    mvp = torch.cat([torch.zeros_like(mv[:, :1]), mv[:, :-1]], dim=1)
    mvd = mv.long() - mvp.long()
    v_run, l_run = ue_slots(run)
    # P_L0_16x16 = ue(0); I_16x16 in a P slice = ue(5 + the I16 type),
    # DC prediction with the cbp folded in
    t_intra = 8 + 4 * (cbp.long() >> 4) + torch.where((cbp & 15) > 0, 12, 0)
    v_type, l_type = ue_slots(torch.where(intra, t_intra, 0))
    v_mx, l_mx = se_slots(mvd[..., 1])
    v_my, l_my = se_slots(mvd[..., 0])
    cn = torch.as_tensor(_CBP_TO_CODENUM, dtype=torch.int64, device=dev)
    v_cbp, l_cbp = ue_slots(cn[torch.where(intra, 0, cbp.long())])
    ones = torch.ones_like(run)
    l_mx, l_my, l_cbp = (a * ~intra for a in (l_mx, l_my, l_cbp))
    l_icp = intra.long()               # intra_chroma_pred_mode DC = ue(0)
    if qp_se is None:
        v_qpd, l_qpd = se_slots(torch.zeros_like(run))
        l_qpd = torch.where((cbp > 0) | intra, l_qpd, 0)
    else:
        v_qpd, l_qpd = qp_se
    vals = torch.stack([v_run, v_type, v_mx, v_my, v_cbp, ones, v_qpd], dim=-1)
    lens = torch.stack([l_run, l_type, l_mx, l_my, l_cbp, l_icp, l_qpd],
                       dim=-1) * coded[:, :, None]
    trail = nc - 1 - prev_incl[:, -1]
    tv, tl = ue_slots(trail)
    return vals, lens, tv, torch.where(trail > 0, tl, 0), skip


def p_frame_block_slots(out: dict):
    """Inter residual tensors (the P core's dict) -> (values, lengths)
    (R, C, 26, 34) int64 block slots — 27 with the I16-in-P outputs
    (``mb_intra``) —, cbp (R, C) (an intra MB's: its I16 pattern) and mv."""
    mb_intra = out.get("mb_intra")
    luma = out["luma"].long()                                # (R, C, 16, 16)
    cb_dc, cb_ac = out["cb_dc"].long(), out["cb_ac"].long()
    cr_dc, cr_ac = out["cr_dc"].long(), out["cr_ac"].long()
    dev = luma.device
    nr, nc_mb = luma.shape[:2]
    by = torch.as_tensor(_BLK_Y, dtype=torch.long, device=dev)
    bx = torch.as_tensor(_BLK_X, dtype=torch.long, device=dev)

    grp_any = (luma.reshape(nr, nc_mb, 4, 64) != 0).any(dim=3)   # (R, C, 4)
    cbp_luma = (grp_any.long() << torch.arange(4, device=dev)).sum(dim=2)
    chroma_ac_any = ((cb_ac != 0).any(dim=3).any(dim=2)
                     | (cr_ac != 0).any(dim=3).any(dim=2))
    chroma_dc_any = (cb_dc != 0).any(dim=2) | (cr_dc != 0).any(dim=2)
    cbp_chroma = torch.where(chroma_ac_any, 2, torch.where(chroma_dc_any, 1, 0))
    cbp = cbp_luma + 16 * cbp_chroma

    grp_gate = grp_any.repeat_interleave(4, dim=2)              # (R, C, 16)
    tc_blk = (luma != 0).sum(dim=3) * grp_gate
    luma_eff = luma
    if mb_intra is not None:
        intra = mb_intra.to(torch.bool)
        i16_dc = out["i16_dc"].long()
        i16_ac = out["i16_ac"].long()
        cl15 = (i16_ac != 0).any(dim=3).any(dim=2)              # (R, C)
        cbp = torch.where(intra, torch.where(cl15, 15, 0) + 16 * cbp_chroma,
                          cbp)
        tc_i = (i16_ac != 0).sum(dim=3) * cl15[:, :, None]
        tc_blk = torch.where(intra[:, :, None], tc_i, tc_blk)
        luma_eff = torch.where(intra[:, :, None, None], _pad16(i16_ac), luma)
    tc_luma = torch.zeros((nr, nc_mb, 4, 4), dtype=torch.int64, device=dev)
    tc_luma[:, :, by, bx] = tc_blk

    def chroma_tc(ac):
        t = (ac != 0).sum(dim=3) * (cbp_chroma == 2)[:, :, None]
        return t.reshape(nr, nc_mb, 2, 2)

    tc_cb, tc_cr = chroma_tc(cb_ac), chroma_tc(cr_ac)
    ncl = nc_grid(tc_luma, tc_luma[:, :, :, 3])
    nccb = nc_grid(tc_cb, tc_cb[:, :, :, 1])
    nccr = nc_grid(tc_cr, tc_cr[:, :, :, 1])

    parts = [luma_eff, _pad16(cb_dc)[:, :, None, :],
             _pad16(cr_dc)[:, :, None, :], _pad16(cb_ac), _pad16(cr_ac)]
    nc_parts = [ncl[:, :, by, bx],
                torch.zeros((nr, nc_mb, 2), dtype=torch.int64, device=dev),
                nccb.reshape(nr, nc_mb, 4), nccr.reshape(nr, nc_mb, 4)]
    off = 0 if mb_intra is None else 1
    nblk = P_MB_BLOCKS + off
    if off:
        parts.insert(0, i16_dc[:, :, None, :])        # Intra16x16DCLevel
        nc_parts.insert(0, ncl[:, :, 0, 0][:, :, None])
    blk_levels = torch.cat(parts, dim=2)                    # (R, C, nblk, 16)
    blk_nc = torch.cat(nc_parts, dim=2)
    is_cdc = torch.zeros(nblk, dtype=torch.bool, device=dev)
    is_cdc[off + 16:off + 18] = True
    max_coeff = torch.full((nr, nc_mb, nblk), 15, dtype=torch.int64,
                           device=dev)
    max_coeff[:, :, :off + 16] = 16
    max_coeff[:, :, off + 16:off + 18] = 4
    if off:       # an intra MB's luma AC blocks are 15-coefficient
        max_coeff[:, :, 1:17] = torch.where(intra[:, :, None], 15, 16)
    nmb = nr * nc_mb
    values, lengths = code_blocks(blk_levels.reshape(nmb * nblk, 16),
                                  blk_nc.reshape(-1), is_cdc.repeat(nmb),
                                  max_coeff.reshape(-1))
    values = values.reshape(nr, nc_mb, nblk, BLOCK_SLOTS)
    lengths = lengths.reshape(nr, nc_mb, nblk, BLOCK_SLOTS)
    luma_gate = (grp_gate if not off else
                 torch.where(intra[:, :, None], cl15[:, :, None], grp_gate))
    gate = [luma_gate,
            (cbp_chroma > 0)[:, :, None].expand(nr, nc_mb, 2),
            (cbp_chroma == 2)[:, :, None].expand(nr, nc_mb, 8)]
    if off:
        gate.insert(0, intra[:, :, None])              # DC: intra only
    gate = torch.cat(gate, dim=2)
    return values, lengths * gate[:, :, :, None], cbp, out["mv"]


def nnz_raster(luma: torch.Tensor) -> torch.Tensor:
    """(R, C, 16 blkIdx, 16) levels -> (R, C, 4, 4) bool coded-coefficient
    flags in raster [by][bx] order (the loop filter's bS = 2 input)."""
    nr, nc = luma.shape[:2]
    nz = torch.zeros((nr, nc, 4, 4), dtype=torch.bool, device=luma.device)
    by = torch.as_tensor(_BLK_Y, dtype=torch.long, device=luma.device)
    bx = torch.as_tensor(_BLK_X, dtype=torch.long, device=luma.device)
    nz[:, :, by, bx] = (luma != 0).any(dim=-1)
    return nz


def _qp_se(out: dict, cbp: torch.Tensor, slice_qp: int, shards: int = 1):
    """tune=hq's mb_qp_delta slots and qp sum: cbp != 0 or I16 MBs carry
    the syntax (skipped MBs have cbp 0)."""
    codes = cbp > 0
    if "mb_intra" in out:
        codes = codes | out["mb_intra"].to(torch.bool)
    v, ln, qp_sum = qp_delta_slots(out["qp_map"], codes, slice_qp, shards)
    return (v, ln), qp_sum


def p_frame_slots_plain(out: dict, slice_qp: int = None, shards: int = 1):
    """Plain PyTorch version of K6.  Same contract as
    :func:`p_frame_slots`."""
    values, lengths, cbp, mv = p_frame_block_slots(out)
    qp_se = qp_sum = None
    if "qp_map" in out:
        qp_se, qp_sum = _qp_se(out, cbp, slice_qp, shards)
    hv, hl, tv, tl, _ = p_mb_header_slots(mv, cbp, qp_se, out.get("mb_intra"))
    i32 = lambda a: a.to(torch.int32)
    res = (i32(values), i32(lengths), i32(hv), i32(hl), i32(tv), i32(tl),
           nnz_raster(out["luma"]))
    return res if qp_sum is None else res + (qp_sum,)


def p_frame_slots(out: dict, slice_qp: int = None, qp_dev=None,
                  shards: int = 1):
    """The P core's tensors -> (values (R, C, 26, 34), lengths, mbh_vals
    (R, C, 7), mbh_lens, run_vals (R,), run_lens (R,), nnz (R, C, 4, 4)
    bool); slot tensors int32 (values are the uint32 bit patterns).
    tune=hq: 27 block slots with the I16-in-P outputs (``mb_intra``,
    ``i16_dc``, ``i16_ac``), and with ``qp_map`` the mb_qp_delta chain
    from ``slice_qp`` (read from ``qp_dev``, one int32 on the card, where
    given) and an eighth output, the frame's qp sum ((shards,) sums of
    equal bands of rows with ``shards``: the spatial shards').

    CUDA tensors launch the slot coder, one pass: a CTA per segment of a
    row takes the row's skip runs by a max-scan of its coded MBs, stages
    each chunk of MBs' levels in shared memory, counts total_coeff, cbp,
    gates and the nnz flags there, codes a thread per 4x4 block and per
    MB header (the last MB of a row also codes its trailing run) into a
    shared tile and writes it out coalesced; the tune=hq forms are the
    kernel's compile-time I16-in-P instantiation and a qp-chain pass (one
    warp per MB row).  CPU tensors run the plain version.

    Tensors with a leading session axis (the stacked P core's, tune
    "off") give outputs with one: S sessions in one launch, the session
    the grid's second axis."""
    ns = out["mv"].dim() - 3                  # 1 with a session axis
    if ns not in (0, 1):
        raise ValueError("out must be (R, C, ...) or (S, R, C, ...)")
    lead = tuple(out["mv"].shape[:ns])
    nr, nc = out["mv"].shape[ns:ns + 2]
    dev = out["mv"].device
    shapes = {"mv": (nr, nc, 2), "luma": (nr, nc, 16, 16),
              "cb_dc": (nr, nc, 4), "cb_ac": (nr, nc, 4, 15),
              "cr_dc": (nr, nc, 4), "cr_ac": (nr, nc, 4, 15)}
    intra = "mb_intra" in out
    if intra:
        shapes.update({"i16_dc": (nr, nc, 16), "i16_ac": (nr, nc, 16, 15)})
    for k, shape in shapes.items():
        t = out[k]
        if (tuple(t.shape) != lead + shape or t.dtype != torch.int32
                or t.device != dev):
            raise ValueError(f"out[{k!r}]: want {lead + shape} int32 on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    hq = "qp_map" in out
    if hq and slice_qp is None:
        raise ValueError("a qp_map needs the slice qp")
    if lead and (hq or intra):
        raise ValueError("stacked sessions take tune='off' outputs")
    if dev.type == "cpu":
        if lead:
            from .h264_device import stack_sessions
            return stack_sessions([p_frame_slots_plain(
                {k: out[k][i] for k in shapes}) for i in range(lead[0])])
        return p_frame_slots_plain(out, slice_qp, shards)
    lib = _cuda.library("cavlc")
    if dev not in _tables_on:
        with torch.cuda.device(dev):
            _upload_tables(lib)
        _tables_on.add(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    nblk = P_MB_BLOCKS_I if intra else P_MB_BLOCKS
    res = (torch.empty(lead + (nr, nc, nblk, BLOCK_SLOTS), **i32),
           torch.empty(lead + (nr, nc, nblk, BLOCK_SLOTS), **i32),
           torch.empty(lead + (nr, nc, HDR_SLOT_COUNT), **i32),
           torch.empty(lead + (nr, nc, HDR_SLOT_COUNT), **i32),
           torch.empty(lead + (nr,), **i32), torch.empty(lead + (nr,), **i32),
           torch.empty(lead + (nr, nc, 4, 4), dtype=torch.bool, device=dev))
    scratch = torch.empty(lead + (nr * nc, 32), **i32)
    if intra and hq:
        # the full tier's slots and qp chain in one host call
        qp_sum = torch.empty(shards, **i32)
        _cuda.launch("cavlc", "cavlc_p_slots_i_chain_launch",
                     [out[k] for k in shapes] + [out["mb_intra"]] + list(res)
                     + [scratch, out["qp_map"], qp_sum, qp_dev],
                     [nr, nc, int(slice_qp), shards], dev)
        p_frame_slots.hq.launches += 1
        p_frame_slots.chain.launches += 1
        return res + (qp_sum,)
    if not intra:
        _cuda.launch("cavlc", "cavlc_p_slots_launch",
                     [out[k] for k in shapes] + list(res) + [scratch],
                     [nr, nc, lead[0] if lead else 1], dev)
        p_frame_slots.launches += 1
    else:
        _cuda.launch("cavlc", "cavlc_p_slots_i_launch",
                     [out[k] for k in shapes] + [out["mb_intra"]] + list(res)
                     + [scratch], [nr, nc], dev)
        p_frame_slots.hq.launches += 1
    if not hq:
        return res
    qp_sum = torch.empty(shards, **i32)
    _cuda.launch("cavlc", "cavlc_qp_chain_launch",
                 [out["qp_map"], None, scratch, res[2], res[3], qp_sum,
                  qp_dev], [nr, nc, int(slice_qp), 1, shards], dev)
    p_frame_slots.chain.launches += 1
    return res + (qp_sum,)


p_frame_slots.launches = 0
p_frame_slots.hq = _cuda.Counter()       # the I16-in-P form (27 blocks)
p_frame_slots.chain = _cuda.Counter()    # the qp chain (full tier)

_LEVEL_KEYS_HQ = ("qp_map", "mb_intra", "i16_dc", "i16_ac")


def _finish_p(out: dict, hdr_vals, hdr_lens, slice_qp: int = None,
              qp_dev=None, shards: int = 1):
    """P core output -> (flat, recon_y, recon_cb, recon_cr, mv, nnz,
    levels); ``levels`` are the residual tensors the host coder takes on
    an overflow (with the tune=hq qp plane and I16-in-P tensors, which
    it must re-emit the same).  With ``shards`` (the spatial shards) the
    frame-shaped slots are packed band by band of rows into (shards,
    FLAT_BYTES) flats under the (shards, R / shards, 3) header slots."""
    slots = p_frame_slots(out, slice_qp, qp_dev, shards)
    values, lengths, mbh_v, mbh_l, run_v, run_l, nnz = slots[:7]
    qp_sum = slots[7] if len(slots) > 7 else None
    if shards == 1:
        flat = pack_p_frame(values, lengths, mbh_v, mbh_l, run_v, run_l,
                            hdr_vals, hdr_lens, qp_sum=qp_sum)
    else:
        flat = pack_p_frame(*(shard_view(t, shards) for t in (
            values, lengths, mbh_v, mbh_l, run_v, run_l)), hdr_vals,
            hdr_lens, qp_sum=qp_sum)
    levels = {k: out[k] for k in _LEVEL_KEYS + _LEVEL_KEYS_HQ if k in out}
    return (flat, out["recon_y"], out["recon_cb"], out["recon_cr"],
            out["mv"], nnz, levels)


def encode_p_cavlc_frame(y, cb, cr, ref_y, ref_cb, ref_cr, hdr_vals,
                         hdr_lens, qp: int, qp_dev=None, out=None,
                         tune: str = "off", next_y=None,
                         p_intra: bool = False):
    """Fused P stage: the P core (K5), the P slot coder (K6) and the P
    packer (K7).  Returns (flat, recon_y, recon_cb, recon_cr, mv, nnz,
    levels).  The reference planes are only read; the recon planes are
    new tensors (``out``'s where given: see ``h264_inter.encode_p_frame``,
    as for ``qp_dev``, ``tune``, ``next_y`` and ``p_intra``).  The full
    tier's qp chain starts each row at ``qp`` (the slice qp)."""
    out = h264_inter.encode_p_frame(y, cb, cr, ref_y, ref_cb, ref_cr, qp,
                                    tune=tune, p_intra=p_intra,
                                    qp_dev=qp_dev, out=out, next_y=next_y)
    return _finish_p(out, hdr_vals, hdr_lens, slice_qp=qp, qp_dev=qp_dev)


__all__ = ["P_MB_BLOCKS", "P_MB_BLOCKS_I", "HDR_SLOT_COUNT",
           "encode_p_cavlc_frame", "nnz_raster", "p_frame_block_slots",
           "p_frame_slots", "p_frame_slots_plain", "p_mb_header_slots",
           "pack_p_frame"]
