"""Damage-driven encode: a P frame's device work covers its changed MB
rows only (the reference's ``ops/damage_mask.py``).

The host twin of the content plane's damage grid (:func:`damage_grid_np`,
the same per-MB summed abs diff against the same
``DNGD_CONTENT_DAMAGE_THR``) turns each P frame into a worklist of
damaged MB rows, padded to a power-of-two bucket with copies of its last
row (:func:`plan_rows`).  The P pipeline is row-local: a slice per MB
row, ``disable_deblocking_filter_idc=2``, the left MB as MV predictor and
a search window that reads at most ``_PAD`` pels past the row.  So
:func:`row_core` runs the P core over the worklist (K5r), codes and packs
the compacted rows (K6, K7), loop-filters the compacted stack (K8) and
scatters the filtered rows into new reference planes (K13,
:func:`scatter_rows`).  The untouched rows go on the wire as all-skip
slices cached on the host (:func:`skip_slice_nal`), which a decoder
reconstructs as the reference rows bit for bit; :func:`assemble_masked_au`
interleaves the two in raster order.  A frame whose bucket covers every
row takes the ordinary full-frame path: its bytes are the same.

The same core serves the per-frame masked step and the super-step
chunk's masked body (``ops/devloop.py``), so their bytes cannot drift.

Knobs (warn and keep the default on a bad value):

- ``DNGD_DAMAGE_MASK``: the master switch (off by default; mask-off
  output is the unmasked encoder's).
- ``DNGD_DAMAGE_COST_FLOOR``: the floor of the damage-scaled capacity
  charge, default 0.35.
- ``DNGD_CONTENT_DAMAGE_THR`` (``obs/content``): the damage threshold
  shared with the content plane.

The spatial shards cannot compact a worklist (a shard's rows are fixed),
so their masked P step gates instead (:func:`force_skip_rows`, K13s in
``csrc/spatial.cu``): after the P core, every MB of an undamaged row
becomes P_Skip with its recon the reference's, and the slot coder emits
those rows as the same skip runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from ..bitstream import h264 as syn
from ..bitstream.bitwriter import BitWriter
from ..utils.env import env_flag, env_float

__all__ = [
    "enabled", "cost_floor", "damage_factor", "damage_grid_np",
    "plan_rows", "RowPlan", "row_core", "scatter_rows",
    "scatter_rows_plain", "skip_slice_nal", "assemble_masked_au",
    "scatter_levels_np", "force_skip_rows", "force_skip_rows_plain",
]


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """Master gate (DNGD_DAMAGE_MASK), off by default."""
    return env_flag("DNGD_DAMAGE_MASK", False)


def cost_floor() -> float:
    """Floor of the damage-scaled capacity charge, clamped to [0, 1]."""
    return min(max(env_float("DNGD_DAMAGE_COST_FLOOR", 0.35), 0.0), 1.0)


def damage_factor(damage, floor: float = None) -> float:
    """Charge factor for a session at rolling damage ``damage``:
    ``floor + (1 - floor) * damage``; ``None`` (no telemetry yet)
    charges full cost."""
    if damage is None:
        return 1.0
    f = cost_floor() if floor is None else min(max(floor, 0.0), 1.0)
    return f + (1.0 - f) * min(max(float(damage), 0.0), 1.0)


# ---------------------------------------------------------------------------
# the host twin of the device damage grid, and the row worklist
# ---------------------------------------------------------------------------

def damage_grid_np(y: np.ndarray, prev_y, thr_sad: int = None) -> np.ndarray:
    """(R, C) uint8 damaged-MB grid of the uint8 ingest luma against the
    previous one: the numpy twin of K4's grid.  ``prev_y=None`` (stream
    start, resize) marks everything damaged.  The abs diff stays uint8
    and each MB's SAD is summed in two steps, 16 lines into uint16 (at
    most 16 * 255), then 16 columns into int32."""
    if thr_sad is None:
        from ..obs import content as obsc
        thr_sad = obsc.damage_thr_sad()
    r, c = y.shape[0] // 16, y.shape[1] // 16
    if prev_y is None:
        return np.ones((r, c), np.uint8)
    y, prev_y = np.asarray(y, np.uint8), np.asarray(prev_y, np.uint8)
    d = np.maximum(y, prev_y) - np.minimum(y, prev_y)
    cols = d.reshape(r, 16, c * 16).sum(axis=1, dtype=np.uint16)
    sad = cols.reshape(r, c, 16).sum(axis=2, dtype=np.int32)
    return (sad > thr_sad).astype(np.uint8)


class RowPlan:
    """One frame's worklist: ``rows`` the damaged MB rows (sorted,
    unique), ``padded`` the int32 worklist of length ``bucket`` (copies
    of the last damaged row fill it), ``total`` the frame's rows,
    ``frac`` the damaged share of its MBs.  ``full``: the bucket covers
    every row (the full-frame path serves the frame)."""

    __slots__ = ("rows", "padded", "bucket", "total", "frac")

    def __init__(self, rows, padded, bucket, total, frac):
        self.rows = rows
        self.padded = padded
        self.bucket = bucket
        self.total = total
        self.frac = frac

    @property
    def full(self) -> bool:
        return self.bucket >= self.total


def _bucket_for(n: int, total: int) -> int:
    """Smallest power of two >= n, capped at the frame's row count."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, total)


def plan_rows(grid: np.ndarray) -> RowPlan:
    """The row worklist of a damage grid.  A calm frame still encodes
    one row (row 0), which codes to the same all-skip bytes."""
    total = int(grid.shape[0])
    rows = np.flatnonzero(grid.any(axis=1)).astype(np.int32)
    frac = float(grid.mean()) if grid.size else 0.0
    if rows.size == 0:
        rows = np.zeros(1, np.int32)
    bucket = _bucket_for(int(rows.size), total)
    if bucket >= total:
        padded = np.arange(total, dtype=np.int32)
        return RowPlan(padded, padded, total, total, frac)
    padded = np.concatenate(
        [rows, np.full(bucket - rows.size, rows[-1], np.int32)])
    return RowPlan(rows, padded, bucket, total, frac)


# ---------------------------------------------------------------------------
# the compacted P stage
# ---------------------------------------------------------------------------

def scatter_rows_plain(ref_y, ref_cb, ref_cr, rec_y, rec_cb, rec_cr, rows):
    """Plain PyTorch version of K13: copies of the reference planes with
    the MB rows ``rows`` replaced by the stacked recon rows."""
    nr = ref_y.shape[0] // 16
    idx = rows.long()
    out = []
    for ref, rec, n in ((ref_y, rec_y, 16), (ref_cb, rec_cb, 8),
                        (ref_cr, rec_cr, 8)):
        o = ref.clone()
        o.view(nr, n, ref.shape[1])[idx] = rec.view(-1, n, ref.shape[1])
        out.append(o)
    return tuple(out)


def scatter_rows(ref_y, ref_cb, ref_cr, rec_y, rec_cb, rec_cr, rows):
    """New reference planes: the old ones (R MB rows), with MB row
    ``rows[i]`` taken from row i of the recon stack (16b / 8b lines).
    Padded duplicates in ``rows`` must carry equal recon rows.  The old
    planes stay as they were.

    CUDA tensors launch ``csrc/damage.cu``: a warp an output line of the
    frame (stored where its row is not in the worklist) or of the recon
    stack (stored at its row's place), 16-byte words, no line waiting on
    the worklist before its loads; planes at any byte offset.  CPU
    tensors run the plain version."""
    from .h264_device import _check_planes

    _check_planes(ref_y, ref_cb, ref_cr)
    _check_planes(rec_y, rec_cb, rec_cr)
    b = rows.numel()
    nr = ref_y.shape[0] // 16
    if (rows.dim() != 1 or rows.dtype != torch.int32 or not 0 < b <= nr
            or rec_y.shape != (16 * b, ref_y.shape[1])
            or rows.device != ref_y.device or rec_y.device != ref_y.device):
        raise ValueError("rows must be b <= R int32 and the recon stack "
                         "b MB rows wide as the reference, on one device")
    if ref_y.device.type == "cpu":
        return scatter_rows_plain(ref_y, ref_cb, ref_cr, rec_y, rec_cb,
                                  rec_cr, rows)
    out = [torch.empty_like(p) for p in (ref_y, ref_cb, ref_cr)]
    _cuda.launch("damage", "scatter_rows_launch",
                 [ref_y, ref_cb, ref_cr, rec_y, rec_cb, rec_cr,
                  rows.contiguous()] + out,
                 [nr, b, ref_y.shape[1]], ref_y.device)
    scatter_rows.launches += 1
    return tuple(out)


scatter_rows.launches = 0


def row_core(y, cb, cr, ref_y, ref_cb, ref_cr, rows, hv_r, hl_r, qp: int,
             tune: str = "off", next_y=None, p_intra: bool = False,
             deblock: bool = False, qp_dev=None):
    """Row-compacted P stage over the worklist ``rows`` (int32 (b,)), the
    per-frame masked step and the masked chunk's body alike (the
    reference's ``row_core`` and its jitted ``encode_p_rows``):
    the P core (K5r) at the kernel tier ``tune`` (the full tier's qp plane
    over the listed rows, K14r, biased by the same rows of ``next_y``;
    ``p_intra``: I16-in-P over the stack), the P slot coder and packer
    (K6, K7) over the b rows with their slice-header slots ``hv_r``/
    ``hl_r`` (b, 3) (the full tier's qp chain restarting each row at the
    slice qp, the flat's meta summing the rows' coded qps), the loop
    filter on the compacted stack when ``deblock`` (K8: with idc=2 no
    edge crosses a row), and the filtered rows scattered into new
    reference planes (K13).  Returns the unmasked stage's 7-tuple
    ``(flat, ref_y', ref_cb', ref_cr', mv, nnz, levels)``, the flat's
    meta describing the b rows.  ``qp_dev``: see
    ``h264_inter.encode_p_frame``."""
    from . import cavlc_p_device, h264_deblock, h264_inter

    out = h264_inter.encode_p_frame_rows(y, cb, cr, ref_y, ref_cb, ref_cr,
                                         rows, qp, tune=tune, next_y=next_y,
                                         p_intra=p_intra, qp_dev=qp_dev)
    flat, ry, rcb, rcr, mv, nnz, levels = cavlc_p_device._finish_p(
        out, hv_r, hl_r, slice_qp=qp, qp_dev=qp_dev)
    if deblock:
        ry, rcb, rcr = h264_deblock.deblock_frame(ry, rcb, rcr, qp,
                                                  nnz_blk=nnz, mv=mv,
                                                  qp_dev=qp_dev)
    new = scatter_rows(ref_y, ref_cb, ref_cr, ry, rcb, rcr, rows)
    return (flat,) + new + (mv, nnz, levels)


# ---------------------------------------------------------------------------
# the forced-skip row gate (the spatial shards' masked P step)
# ---------------------------------------------------------------------------

_SKIP_ZERO = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac", "mb_intra",
              "i16_dc", "i16_ac")
_SKIP_RECON = ("recon_y", "recon_cb", "recon_cr")


def _check_skip(out: dict, keep, refs) -> int:
    nr, nc = out["mv"].shape[:2]
    dev = out["mv"].device
    if (keep.dim() != 1 or keep.numel() != nr or keep.dtype != torch.bool
            or keep.device != dev):
        raise ValueError(f"keep must be ({nr},) bool on {dev}")
    for k, ref in zip(_SKIP_RECON, refs):
        if (ref.shape != out[k].shape or ref.dtype != torch.uint8
                or ref.device != dev):
            raise ValueError(f"reference {tuple(ref.shape)} does not match "
                             f"{k} {tuple(out[k].shape)}")
    return nr


def force_skip_rows_plain(out: dict, keep, ref_y, ref_cb, ref_cr) -> dict:
    """Plain PyTorch version of K13s, in the reference's order: where
    ``keep`` is False, the MV and levels (and the I16-in-P outputs) are
    zeroed and the recon rows are the reference's.  Gates ``out``'s
    tensors in place and returns ``out``."""
    _check_skip(out, keep, (ref_y, ref_cb, ref_cr))
    drop = ~keep
    for k in _SKIP_ZERO:
        if k in out:
            out[k][drop] = 0
    for k, ref, n in zip(_SKIP_RECON, (ref_y, ref_cb, ref_cr), (16, 8, 8)):
        rows = drop.repeat_interleave(n)
        out[k][rows] = ref[rows]
    return out


def force_skip_rows(out: dict, keep, ref_y, ref_cb, ref_cr) -> dict:
    """K13s, the reference's ``force_skip_rows``: every MB of the rows
    where ``keep`` ((R,) bool) is False becomes P_Skip before entropy —
    zero MV and levels (and ``mb_intra``/``i16_*`` where present), the
    recon rows the UNPADDED reference's ``ref_*`` — so the P slot coder
    emits those rows as pure skip runs, byte for byte the all-skip
    slices.  ``out`` is the P core's dict (R, C, ...) and its tensors are
    gated in place; returns ``out``.

    CUDA tensors launch ``csrc/spatial.cu``: a CTA a chunk of one
    tensor's row (a grid of chunks by MB rows), 16-byte words, zero
    words stored with no load; a kept row's CTAs return after reading
    ``keep``, and tensors may start at any byte offset.  CPU tensors run
    the plain version."""
    nr = _check_skip(out, keep, (ref_y, ref_cb, ref_cr))
    if keep.device.type == "cpu":
        return force_skip_rows_plain(out, keep, ref_y, ref_cb, ref_cr)
    nc = out["mv"].shape[1]
    _cuda.launch("spatial", "force_skip_launch",
                 [out.get(k) for k in _SKIP_ZERO]
                 + [out[k] for k in _SKIP_RECON]
                 + [ref_y, ref_cb, ref_cr, keep.contiguous()], [nr, nc],
                 keep.device)
    force_skip_rows.launches += 1
    return out


force_skip_rows.launches = 0


# ---------------------------------------------------------------------------
# host-cached all-skip slices for the untouched rows
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8192)
def skip_slice_nal(first_mb: int, nc_mb: int, frame_num: int,
                   qp_delta: int, deblocking_idc: int) -> bytes:
    """One all-skip P slice NAL of ``nc_mb`` MBs from ``first_mb``:
    slice header, mb_skip_run(nc_mb), trailing bits.  A decoder
    reconstructs it as the reference rows (P_Skip predicts the zero MV
    with no coded neighbour; bS=0 edges leave the filter inert)."""
    bw = BitWriter()
    syn.slice_header(bw, first_mb=first_mb, slice_type=5,
                     frame_num=frame_num & 0xF, idr=False,
                     qp_delta=qp_delta, deblocking_idc=deblocking_idc)
    syn.write_ue(bw, nc_mb)                 # mb_skip_run: the whole row
    syn.rbsp_trailing_bits(bw)
    return syn.nal_unit(syn.NAL_SLICE, bw.getvalue(), ref_idc=2)


def assemble_masked_au(flat_host: np.ndarray, meta, rows, nr_total: int,
                       nc_mb: int, *, frame_num: int, qp_delta: int = 0,
                       deblocking_idc: int = 1,
                       headers: bytes = b"") -> bytes:
    """Annex-B access unit of a masked frame: the device-coded rows of
    the compacted flat buffer and the cached all-skip slices of every
    other row, in raster order.  ``rows`` is the unpadded worklist; the
    padded copies at the meta's tail are never read."""
    from .cavlc_device import META_WORDS

    base = META_WORDS * 4
    slot = {}
    for i, r in enumerate(np.asarray(rows).tolist()):
        slot.setdefault(int(r), i)
    chunks = [headers]
    for r in range(nr_total):
        i = slot.get(r)
        if i is None:
            chunks.append(skip_slice_nal(r * nc_mb, nc_mb, frame_num,
                                         qp_delta, deblocking_idc))
        else:
            off = base + 4 * int(meta.word_off[i])
            rbsp = bytes(flat_host[off:off + int(meta.row_bytes[i])])
            chunks.append(syn.nal_unit(syn.NAL_SLICE, rbsp, ref_idc=2))
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# overflow fallback: compacted levels back to full-frame shapes
# ---------------------------------------------------------------------------

def scatter_levels_np(levels: dict, mv: np.ndarray, rows,
                      nr_total: int) -> tuple:
    """A compacted frame's level tensors and MVs scattered to full-frame
    shapes (untouched rows zero, i.e. skip), for the host coder of a
    flat-cap overflow."""
    rows = np.asarray(rows)
    full_lv = {}
    for k, v in levels.items():
        v = np.asarray(v)
        full = np.zeros((nr_total,) + v.shape[1:], v.dtype)
        full[rows] = v
        full_lv[k] = full
    mv = np.asarray(mv)
    full_mv = np.zeros((nr_total,) + mv.shape[1:], mv.dtype)
    full_mv[rows] = mv
    return full_lv, full_mv
