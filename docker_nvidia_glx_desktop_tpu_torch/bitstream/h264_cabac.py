"""H.264 CABAC picture assembly (pure-Python reference).

Consumes the same quantized level tensors as the CAVLC layer
(:mod:`.h264_entropy`) and emits one CABAC slice per macroblock row —
entropy_coding_mode_flag=1 streams for the Main-profile parity axis
(reference Dockerfile:210, nvh264enc's default).  The slice-per-row
structure keeps rows independently codable: each row re-inits its
arithmetic engine, so the C++ twin can code rows on a thread pool.

A copy of the reference's ``docker_nvidia_glx_desktop_tpu/bitstream/
h264_cabac.py``.  The native coder (``native/cabac.cpp``) codes every
picture unless the caller passes ``use_native=False``; the pure-Python
coder and engine are kept for the tests, and run on their own only where
a native row overruns its output cap even at 4x.  ``python_pictures``
counts the pictures the Python coder or engine coded.
"""

from __future__ import annotations

import threading

import numpy as np

from . import h264 as syn
from .bitwriter import BitWriter
from .cabac import _BLK_XY, CabacEncoder, SliceCoder, _MbCtx


def _native_tables(table_idx: int):
    from .cabac_tables import context_init_tables, engine_tables
    rng, tmps, tlps = engine_tables()
    ctx = np.ascontiguousarray(context_init_tables()[table_idx], np.int8)
    return (ctx, np.ascontiguousarray(rng, np.uint8),
            np.ascontiguousarray(tmps, np.uint8),
            np.ascontiguousarray(tlps, np.uint8))


# Per-frame output buffers, reused across calls (60 fps hot path; keyed
# by geometry so a resize reallocates once).  THREAD-LOCAL: concurrent
# sessions each run their own encode thread, and the ctypes call writes
# into the buffer with the GIL released — a shared buffer would let two
# frames scribble over each other.
_TLS = threading.local()
python_pictures = 0


def _native_slices(symbol: str, table_idx: int, arrays, nr, nc_mb, qp):
    """Per-row slice payloads from the C++ twin, or None (fallback).

    On a cap overflow (pathological low-qp rows) retries once at 4x
    before logging and falling back — the Python coder is ~100x slower,
    so a silent per-frame fallback would be a latency cliff.  Raises
    when the native library cannot be built."""
    import logging

    from ..native import lib as native_lib
    tables = _native_tables(table_idx)
    cache = getattr(_TLS, "bufs", None)
    if cache is None:
        cache = _TLS.bufs = {}
    for scale in (1, 4):
        cap = (2048 + nc_mb * 1536) * scale
        key = (symbol, nr, cap)
        out = cache.get(key)
        if out is None:
            if len(cache) > 8:
                cache.clear()
            out = cache[key] = np.empty(nr * cap, np.uint8)
        lens = np.zeros(nr, np.int64)
        rc = native_lib.cabac_slices(symbol, arrays, nr, nc_mb, qp, tables,
                                     out, lens, cap)
        if rc == 0:
            return [out[r * cap:r * cap + lens[r]].tobytes()
                    for r in range(nr)]
    logging.getLogger(__name__).warning(
        "native CABAC row overflow at 4x cap; falling back to the "
        "Python coder for this picture")
    return None


def _native_intra_payloads(luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                           pred_mode, mb_i4, i4_modes, luma_i4, qp):
    nr, nc_mb = luma_dc.shape[:2]
    c = np.ascontiguousarray
    return _native_slices(
        "h264_cabac_intra_slices", 0,
        (c(luma_dc, np.int32), c(luma_ac, np.int32),
         c(cb_dc, np.int32), c(cb_ac, np.int32),
         c(cr_dc, np.int32), c(cr_ac, np.int32),
         c(pred_mode, np.int32), c(mb_i4, np.uint8),
         c(i4_modes, np.int32), c(luma_i4, np.int32)),
        nr, nc_mb, qp)


def _native_p_payloads(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, qp,
                       cabac_init_idc):
    nr, nc_mb = luma.shape[:2]
    c = np.ascontiguousarray
    return _native_slices(
        "h264_cabac_p_slices", 1 + cabac_init_idc,
        (c(mv, np.int32), c(luma, np.int32),
         c(cb_dc, np.int32), c(cb_ac, np.int32),
         c(cr_dc, np.int32), c(cr_ac, np.int32)),
        nr, nc_mb, qp)


def _engine_rows(buf: np.ndarray, nr: int, nc_mb: int, table_idx: int,
                 qp: int, use_native: bool = True):
    """Replay a device-binarized record stream (ops/cabac_binarize wire
    format) through the arithmetic engine: native C rows, or the
    pure-Python engine with ``use_native=False``.  Returns per-row slice
    payloads, or None on the transport's overflow flag or an output cap
    overrun even at 4x (caller goes dense).  A malformed record stream
    (a row's records do not end at its bit count) raises: the binarizer
    is at fault, and coding the frame from the dense levels would hide
    it."""
    global python_pictures
    from ..native import lib as native_lib
    from ..ops import cabac_binarize

    split = cabac_binarize.split_rows(buf, nr)
    if split is None:
        return None
    payload, row_off, row_bits = split
    if use_native:
        import logging
        ctx, rng, tmps, tlps = _native_tables(table_idx)
        for scale in (1, 4):
            cap = (2048 + nc_mb * 1536) * scale
            rows = native_lib.cabac_engine_rows(
                payload, row_off, row_bits, nr, qp, ctx, rng, tmps,
                tlps, cap)
            if isinstance(rows, list):
                return rows
            if rows == -2:
                raise RuntimeError(
                    "malformed CABAC record stream: a row's records do "
                    "not end at its bit count (binarizer fault)")
        logging.getLogger(__name__).warning(
            "native CABAC engine overflow at 4x cap; dense fallback")
        return None
    # Python engine: decode records, drive CabacEncoder
    python_pictures += 1
    out = []
    for r in range(nr):
        recs = cabac_binarize.decode_records_py(
            payload[row_off[r]:row_off[r + 1]], int(row_bits[r]))
        enc = CabacEncoder(table_idx, qp)
        for rec in recs:
            kind = rec[0]
            if kind == "dec":
                enc.decision(rec[1], rec[2])
            elif kind == "run":
                for _ in range(rec[2]):
                    enc.decision(rec[1], 1)
            elif kind == "byp":
                for b in rec[1]:
                    enc.bypass(b)
            else:
                enc.terminate(rec[1])
        out.append(enc.get_bytes())
    return out


def encode_intra_from_binstream(buf: np.ndarray, *, nr: int, nc_mb: int,
                                qp: int, frame_num: int = 0,
                                idr_pic_id: int = 0, sps: bytes = b"",
                                pps: bytes = b"",
                                with_headers: bool = True,
                                qp_delta: int = 0,
                                deblocking_idc: int = 1,
                                use_native: bool = True):
    """IDR access unit from a device-binarized record stream, or None
    when the transport flagged overflow (caller re-encodes dense)."""
    payloads = _engine_rows(buf, nr, nc_mb, 0, qp, use_native)
    if payloads is None:
        return None
    out = bytearray()
    if with_headers:
        out += syn.nal_unit(syn.NAL_SPS, sps)
        out += syn.nal_unit(syn.NAL_PPS, pps)
    for my, pl in enumerate(payloads):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=7,
                         frame_num=frame_num, idr=True,
                         idr_pic_id=idr_pic_id, qp_delta=qp_delta,
                         deblocking_idc=deblocking_idc, cabac=True)
        bw.pad_to_byte(1)
        out += syn.nal_unit(syn.NAL_IDR, bw.getvalue() + pl)
    return bytes(out)


def encode_p_from_binstream(buf: np.ndarray, *, nr: int, nc_mb: int,
                            qp: int, frame_num: int, qp_delta: int = 0,
                            deblocking_idc: int = 1,
                            cabac_init_idc: int = 0,
                            use_native: bool = True):
    """P access unit from a device-binarized record stream, or None on
    the transport overflow flag."""
    payloads = _engine_rows(buf, nr, nc_mb, 1 + cabac_init_idc, qp,
                            use_native)
    if payloads is None:
        return None
    out = bytearray()
    for my, pl in enumerate(payloads):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=5,
                         frame_num=frame_num, idr=False,
                         qp_delta=qp_delta,
                         deblocking_idc=deblocking_idc, cabac=True,
                         cabac_init_idc=cabac_init_idc)
        bw.pad_to_byte(1)
        out += syn.nal_unit(syn.NAL_SLICE, bw.getvalue() + pl,
                            ref_idc=2)
    return bytes(out)


def _prep_common(cb_dc, cb_ac, cr_dc, cr_ac):
    nr, nc_mb = cb_dc.shape[:2]
    chroma_ac_any = cb_ac.any(axis=(2, 3)) | cr_ac.any(axis=(2, 3))
    chroma_dc_any = cb_dc.any(axis=2) | cr_dc.any(axis=2)
    cbp_chroma = np.where(chroma_ac_any, 2,
                          np.where(chroma_dc_any, 1, 0))
    return cbp_chroma


def _code_chroma(sc: SliceCoder, cc: int, cb_dc, cr_dc, cb_ac, cr_ac,
                 ctx: _MbCtx, intra: bool) -> None:
    """Chroma residuals (DC cat3, AC cat4) + left-ctx bookkeeping."""
    if cc > 0:
        inc = sc.cbf_inc_dc("cbf_cb_dc", intra)
        ctx.cbf_cb_dc = sc.residual(cb_dc, 3, inc)
        inc = sc.cbf_inc_dc("cbf_cr_dc", intra)
        ctx.cbf_cr_dc = sc.residual(cr_dc, 3, inc)
    if cc == 2:
        for comp, (ac, grid, attr) in enumerate(
                ((cb_ac, ctx.cbf_cb, "cbf_cb"),
                 (cr_ac, ctx.cbf_cr, "cbf_cr"))):
            for b in range(4):
                by, bx = divmod(b, 2)
                inc = sc.cbf_inc_chroma(grid, attr, bx, by, intra)
                grid[by][bx] = sc.residual(ac[b], 4, inc)


def encode_intra_picture(levels: dict, *, qp: int,
                         frame_num: int = 0, idr_pic_id: int = 0,
                         sps: bytes = b"", pps: bytes = b"",
                         with_headers: bool = True,
                         qp_delta: int = 0,
                         deblocking_idc: int = 1,
                         use_native: bool = True,
                         qp_map=None) -> bytes:
    """Assemble a CABAC IDR access unit from device-stage level tensors.

    ``qp`` is SliceQPy (context init depends on it, spec 9.3.1.1) —
    pic_init_qp + qp_delta as signaled.

    ``qp_map`` (tune=hq): (R, C) absolute per-MB qp; mb_qp_delta chains
    from ``qp`` per row via the SliceCoder's ctx-60/61 machinery.  The
    native C++ coder has no qp plumbing, so a qp_map forces the Python
    coder.
    """
    luma_dc = np.asarray(levels["luma_dc"])   # (R, C, 16) zigzag
    luma_ac = np.asarray(levels["luma_ac"])   # (R, C, 16, 15)
    cb_dc = np.asarray(levels["cb_dc"])
    cb_ac = np.asarray(levels["cb_ac"])
    cr_dc = np.asarray(levels["cr_dc"])
    cr_ac = np.asarray(levels["cr_ac"])
    nr, nc_mb = luma_dc.shape[:2]
    pred_mode = np.asarray(levels.get(
        "pred_mode", np.full((nr, nc_mb), 2, np.int32)))
    mb_i4 = np.asarray(levels.get("mb_i4", np.zeros((nr, nc_mb), bool)))
    i4_modes = np.asarray(levels.get(
        "i4_modes", np.full((nr, nc_mb, 16), 2, np.int32)))
    luma_i4 = np.asarray(levels.get(
        "luma_i4", np.zeros((nr, nc_mb, 16, 16), np.int32)))

    def _headers():
        o = bytearray()
        if with_headers:
            o += syn.nal_unit(syn.NAL_SPS, sps)
            o += syn.nal_unit(syn.NAL_PPS, pps)
        return o

    def _slice_hdr(my):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=7,
                         frame_num=frame_num, idr=True,
                         idr_pic_id=idr_pic_id, qp_delta=qp_delta,
                         deblocking_idc=deblocking_idc, cabac=True)
        bw.pad_to_byte(1)                 # cabac_alignment_one_bit
        return bw.getvalue()

    if use_native and qp_map is None:
        payloads = _native_intra_payloads(
            luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
            pred_mode, mb_i4, i4_modes, luma_i4, qp)
        if payloads is not None:
            out = _headers()
            for my, pl in enumerate(payloads):
                out += syn.nal_unit(syn.NAL_IDR, _slice_hdr(my) + pl)
            return bytes(out)

    cbp_luma16 = luma_ac.any(axis=(2, 3))                 # I16 AC flag
    i4_grp_any = luma_i4.reshape(nr, nc_mb, 4, 4, 16).any(axis=(3, 4))
    cbp_luma4 = (i4_grp_any * (1 << np.arange(4))).sum(axis=2)
    cbp_chroma = _prep_common(cb_dc, cb_ac, cr_dc, cr_ac)

    # Intra4x4PredMode predictors (8.3.1.1) — same derivation as the
    # CAVLC layer: A crosses into the left MB, B only within the MB.
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
                       np.minimum(mode_a, mode_b), 2)

    global python_pictures
    python_pictures += 1
    out = _headers()

    for my in range(nr):
        enc = CabacEncoder(0, qp)
        sc = SliceCoder(enc, intra_slice=True)
        prev_qp = qp                          # mb_qp_delta row anchor
        for mx in range(nc_mb):
            cc = int(cbp_chroma[my, mx])
            ctx = _MbCtx()
            ctx.intra = True
            if mb_i4[my, mx]:
                cl4 = int(cbp_luma4[my, mx])
                sc.mb_type_i(True, 0, False, 0)
                for blk, (bx, by) in enumerate(_BLK_XY):
                    sc.i4_pred_mode(int(i4_modes[my, mx, blk]),
                                    int(pred_i4[my, mx, by, bx]))
                sc.intra_chroma_mode(0)
                sc.cbp(cl4, cc)
                if cl4 or cc:
                    if qp_map is None:
                        sc.qp_delta(0)
                    else:
                        q = int(qp_map[my, mx])
                        sc.qp_delta(q - prev_qp)
                        prev_qp = q
                else:
                    sc.qp_delta_absent()
                for blk, (bx, by) in enumerate(_BLK_XY):
                    if cl4 & (1 << (blk // 4)):
                        inc = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, True)
                        ctx.cbf_luma[by][bx] = sc.residual(
                            luma_i4[my, mx, blk], 2, inc)
                _code_chroma(sc, cc, cb_dc[my, mx], cr_dc[my, mx],
                             cb_ac[my, mx], cr_ac[my, mx], ctx, True)
                ctx.i16 = False
                ctx.modes = modes_r[my, mx]
                ctx.cbp_luma = cl4
            else:
                cl = bool(cbp_luma16[my, mx])
                sc.mb_type_i(False, int(pred_mode[my, mx]), cl, cc)
                sc.intra_chroma_mode(0)
                if qp_map is None:
                    sc.qp_delta(0)
                else:                         # I16 always codes the syntax
                    q = int(qp_map[my, mx])
                    sc.qp_delta(q - prev_qp)
                    prev_qp = q
                inc = sc.cbf_inc_dc("cbf_luma_dc", True, require_i16=True)
                ctx.cbf_luma_dc = sc.residual(luma_dc[my, mx], 0, inc)
                if cl:
                    for blk, (bx, by) in enumerate(_BLK_XY):
                        inc = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, True)
                        ctx.cbf_luma[by][bx] = sc.residual(
                            luma_ac[my, mx, blk], 1, inc)
                _code_chroma(sc, cc, cb_dc[my, mx], cr_dc[my, mx],
                             cb_ac[my, mx], cr_ac[my, mx], ctx, True)
                ctx.i16 = True
                ctx.cbp_luma = 0xF if cl else 0
            ctx.cbp_chroma = cc
            sc.left = ctx
            sc.end_of_slice(mx == nc_mb - 1)
        out += syn.nal_unit(syn.NAL_IDR, _slice_hdr(my) + enc.get_bytes())
    return bytes(out)


def encode_p_picture(levels: dict, *, qp: int, frame_num: int,
                     qp_delta: int = 0, deblocking_idc: int = 1,
                     cabac_init_idc: int = 0,
                     use_native: bool = True,
                     qp_map=None) -> bytes:
    """Assemble a CABAC P access unit (P_L0_16x16 + P_Skip subset).

    MV prediction matches the CAVLC layer: under slice-per-row, mvp is
    the left MB's MV and P_Skip requires mv == (0,0) (h264_entropy
    encode_p_picture docstring).  ``qp_map`` (tune=hq): per-MB qp, as in
    :func:`encode_intra_picture` — forces the Python coder.
    """
    mv = np.asarray(levels["mv"], np.int32)       # (R, C, 2) (y, x) qpel
    luma = np.asarray(levels["luma"], np.int32)   # (R, C, 16, 16) zigzag
    cb_dc = np.asarray(levels["cb_dc"], np.int32)
    cb_ac = np.asarray(levels["cb_ac"], np.int32)
    cr_dc = np.asarray(levels["cr_dc"], np.int32)
    cr_ac = np.asarray(levels["cr_ac"], np.int32)
    nr, nc_mb = luma.shape[:2]

    luma8x8_any = luma.reshape(nr, nc_mb, 4, 4, 16).any(axis=(3, 4))
    cbp_luma = (luma8x8_any * (1 << np.arange(4))).sum(axis=2)
    cbp_chroma = _prep_common(cb_dc, cb_ac, cr_dc, cr_ac)
    cbp = cbp_luma + 16 * cbp_chroma
    skip = (mv == 0).all(axis=2) & (cbp == 0)

    def _slice_hdr(my):
        bw = BitWriter()
        syn.slice_header(bw, first_mb=my * nc_mb, slice_type=5,
                         frame_num=frame_num, idr=False,
                         qp_delta=qp_delta, deblocking_idc=deblocking_idc,
                         cabac=True, cabac_init_idc=cabac_init_idc)
        bw.pad_to_byte(1)                 # cabac_alignment_one_bit
        return bw.getvalue()

    if use_native and qp_map is None:
        payloads = _native_p_payloads(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac,
                                      qp, cabac_init_idc)
        if payloads is not None:
            out = bytearray()
            for my, pl in enumerate(payloads):
                out += syn.nal_unit(syn.NAL_SLICE, _slice_hdr(my) + pl,
                                    ref_idc=2)
            return bytes(out)

    global python_pictures
    python_pictures += 1
    out = bytearray()
    for my in range(nr):
        enc = CabacEncoder(1 + cabac_init_idc, qp)
        sc = SliceCoder(enc, intra_slice=False)
        prev_qp = qp                          # mb_qp_delta row anchor
        mvp = np.zeros(2, np.int32)
        for mx in range(nc_mb):
            ctx = _MbCtx()
            if skip[my, mx]:
                sc.mb_skip(True)
                sc.qp_delta_absent()
                ctx.skip = True
                mvp = np.zeros(2, np.int32)
                sc.left = ctx
                sc.end_of_slice(mx == nc_mb - 1)
                continue
            sc.mb_skip(False)
            sc.mb_type_p16()
            mvd = mv[my, mx] - mvp
            sc.mvd(0, int(mvd[1]))        # x component
            sc.mvd(1, int(mvd[0]))        # y component
            ctx.abs_mvd = np.abs(mvd)[::-1].copy()   # (x, y) order
            mvp = mv[my, mx].copy()
            cl = int(cbp_luma[my, mx])
            cc = int(cbp_chroma[my, mx])
            sc.cbp(cl, cc)
            if cl or cc:
                if qp_map is None:
                    sc.qp_delta(0)
                else:
                    q = int(qp_map[my, mx])
                    sc.qp_delta(q - prev_qp)
                    prev_qp = q
            else:
                sc.qp_delta_absent()
            for blk, (bx, by) in enumerate(_BLK_XY):
                if cl & (1 << (blk // 4)):
                    inc = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, False)
                    ctx.cbf_luma[by][bx] = sc.residual(
                        luma[my, mx, blk], 2, inc)
            _code_chroma(sc, cc, cb_dc[my, mx], cr_dc[my, mx],
                         cb_ac[my, mx], cr_ac[my, mx], ctx, False)
            ctx.cbp_luma = cl
            ctx.cbp_chroma = cc
            sc.left = ctx
            sc.end_of_slice(mx == nc_mb - 1)
        out += syn.nal_unit(syn.NAL_SLICE, _slice_hdr(my) + enc.get_bytes(),
                            ref_idc=2)
    return bytes(out)
