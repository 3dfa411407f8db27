"""Content statistics of one frame on the device (K4): the per-MB
damage grid and count against the previous ingest luma, the
``mb_activity`` percentiles p50/p95, and where the encoder has them the
luma SSE against the recon, the mean and p95 of |MV| and the
skip/inter/intra MB counts.

Replaces the reference's ``ops/content_stats.py`` ``frame_stats`` ->
``_frame_vec`` and ``chunk_stats``.  :func:`chunk_stats` (K4c) runs
``csrc/content.cu``'s three kernels over a chunk of K frames (the frame
as a grid axis) for CUDA tensors and its plain version
(:func:`frame_stats_full_plain` slot by slot) for CPU tensors: each slot
diffs against the one before it (slot 0 against ``prev_y``), the SSE
lands in the last slot only (the ring keeps only the last reference),
the |MV| and mode fields per slot where the MV field and residuals are
given.  :func:`frame_stats_full` is its one-frame call (the GOP encoder:
the IDR passes its recon, every P frame recon, MVs and residual) and
:func:`frame_stats` the form without recon, MV field or residual (the
all-intra encoder): ``[-1, n_damage, -1, -1, -1, -1, -1, act_p50,
act_p95, R*C]``.  The stats never feed back into the encode;
:func:`frame_stats_np` is the host oracle (float64).

The float slots: the SSE is an exact integer sum rounded once to float32
and the |MV| mean a float64 sum rounded once, where the reference sums in
float32 (order-dependent, ~1e-7 relative); the percentiles repeat
jnp.percentile's float32 interpolation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .aq import mb_activity

__all__ = ["VEC_LEN", "chunk_stats", "chunk_stats_plain", "frame_stats",
           "frame_stats_full", "frame_stats_full_plain", "frame_stats_np",
           "mb_activity_np", "psnr_from_sse", "vec_to_stats"]

# stats-vector slot layout (float32; -1.0 marks "not computed")
VEC_LEN = 10
IDX_SSE = 0        # luma SSE vs recon (-1 = no recon in reach)
IDX_DAMAGE = 1     # damaged-MB count (-1 = no previous ingest)
IDX_SKIP = 2       # skip-proxy MB count (-1 = no mode info)
IDX_INTER = 3      # coded inter MB count
IDX_INTRA = 4      # intra MB count
IDX_MV_MEAN = 5    # mean |MV|, quarter-pel (-1 = no MV field)
IDX_MV_P95 = 6     # p95 |MV|, quarter-pel
IDX_ACT_P50 = 7    # ops/aq.mb_activity p50
IDX_ACT_P95 = 8    # ops/aq.mb_activity p95
IDX_MBS = 9        # macroblock count (denominator, sanity echo)

# the activity sort runs in one CUDA block's shared memory
MAX_MBS = 1 << 15


def _percentiles_f32(act: torch.Tensor, qs=(50.0, 95.0)) -> torch.Tensor:
    """Percentiles ``qs`` of the values, as jnp.percentile's linear
    interpolation computes them in float32: q/100*(n-1), floor/ceil
    neighbours, low*(1-w) + high*w."""
    a = torch.sort(act.reshape(-1).to(torch.float32)).values
    n = a.shape[0]
    q = torch.tensor(qs, dtype=torch.float32, device=a.device)
    q = (q / 100.0) * float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_v = a[low.clamp(0, n - 1).long()]
    hi_v = a[high.clamp(0, n - 1).long()]
    return lo_v * lw + hi_v * hw


def frame_stats_full_plain(y, prev_y, thr_sad: int, recon_y=None, mv=None,
                           resid=None, mb_intra=None):
    """Plain PyTorch version of K4 in its full form: (vec float32 (10,),
    grid uint8 (R, C)).  ``resid`` is the P core's five residual level
    tensors; the mode counts need it and ``mv``, and count the I16-in-P
    MBs of ``mb_intra`` (tune=hq) as intra."""
    h, w = y.shape
    r, c = h // 16, w // 16
    d = (y.to(torch.int32) - prev_y.to(torch.int32)).abs()
    sad = d.reshape(r, 16, c, 16).sum(dim=(1, 3), dtype=torch.int32)
    grid = (sad > thr_sad).to(torch.uint8)
    vec = torch.full((VEC_LEN,), -1.0, dtype=torch.float32, device=y.device)
    vec[IDX_DAMAGE] = grid.sum(dtype=torch.int32).to(torch.float32)
    if recon_y is not None:
        e = y.to(torch.int32) - recon_y.to(torch.int32)
        mb_sse = (e * e).reshape(r, 16, c, 16).sum(dim=(1, 3), dtype=torch.int32)
        vec[IDX_SSE] = mb_sse.sum(dtype=torch.int64).to(torch.float32)
    if mv is not None:
        m = mv.to(torch.float32)
        mag = torch.sqrt((m * m).sum(dim=-1)).reshape(-1)
        vec[IDX_MV_MEAN] = (mag.to(torch.float64).sum() / mag.numel()).to(
            torch.float32)
        vec[IDX_MV_P95] = _percentiles_f32(mag, (95.0,))[0]
        if resid:
            coded = torch.zeros((r, c), dtype=torch.bool, device=y.device)
            for t in resid:
                coded |= (t.reshape(r, c, -1) != 0).any(dim=-1)
            intra = (torch.zeros((r, c), dtype=torch.bool, device=y.device)
                     if mb_intra is None else mb_intra.to(torch.bool))
            skip = ~coded & (mv == 0).all(dim=-1) & ~intra
            n_skip = skip.sum(dtype=torch.int32)
            n_intra = intra.sum(dtype=torch.int32)
            vec[IDX_SKIP] = n_skip.to(torch.float32)
            vec[IDX_INTER] = (r * c - n_intra - n_skip).to(torch.float32)
            vec[IDX_INTRA] = n_intra.to(torch.float32)
    vec[IDX_ACT_P50:IDX_ACT_P95 + 1] = _percentiles_f32(mb_activity(y))
    vec[IDX_MBS] = float(r * c)
    return vec, grid


def _check(ys, prev_y, recon_y=None, mvs=None, resid=None, mb_intra=None):
    """The contract of :func:`chunk_stats`'s inputs: ``ys`` (K, H, W)
    and the (K, ...) MV and residual stacks, the 2-D ``prev_y`` and
    ``recon_y``."""
    if ys.dtype != torch.uint8 or (prev_y is not None
                                   and prev_y.dtype != torch.uint8):
        raise TypeError("luma planes must be uint8")
    if ys.dim() != 3 or not ys.shape[0] or ys.shape[1] % 16 \
            or ys.shape[2] % 16:
        raise ValueError("ys must be a (K, H, W) stack of MB-aligned luma "
                         "planes, K >= 1")
    k, h, w = ys.shape
    r, c = h // 16, w // 16
    want = {}
    if prev_y is not None:
        want["prev_y"] = (prev_y, torch.uint8, (h, w))
    if recon_y is not None:
        want["recon_y"] = (recon_y, torch.uint8, (h, w))
    if mvs is not None:
        want["mv"] = (mvs, torch.int32, (k, r, c, 2))
    if resid:
        if mvs is None or len(resid) != 5:
            raise ValueError("the mode counts need the MV field and the "
                             "five residual tensors")
        for name, t, shape in zip(("luma", "cb_dc", "cb_ac", "cr_dc",
                                   "cr_ac"), resid,
                                  ((16, 16), (4,), (4, 15), (4,), (4, 15))):
            want[name] = (t, torch.int32, (k, r, c) + shape)
    if mb_intra is not None:
        if not resid:
            raise ValueError("mb_intra needs the mode counts' inputs")
        want["mb_intra"] = (mb_intra, torch.bool, (k, r, c))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape or t.device != ys.device:
            raise ValueError(f"{name}: want {shape} {dt} on {ys.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if ys.device.type != "cpu" and r * c > MAX_MBS:
        raise ValueError(f"{r * c} MBs exceed the kernel's {MAX_MBS}")


def frame_stats(y: torch.Tensor, prev_y: torch.Tensor, thr_sad: int):
    """Per-frame stats of an intra frame: ``(vec, grid)``, ``vec`` float32
    ``(VEC_LEN,)`` and ``grid`` uint8 ``(R, C)`` (1 = the MB's summed
    abs diff against ``prev_y`` exceeds ``thr_sad``)."""
    return frame_stats_full(y, prev_y, thr_sad)


def frame_stats_full(y: torch.Tensor, prev_y: torch.Tensor, thr_sad: int,
                     recon_y=None, mv=None, resid=None, mb_intra=None):
    """Per-frame stats with the recon (luma SSE) and, for a P frame, the
    MV field (|MV| mean and p95) and the residual level tensors ``resid``
    = (luma, cb_dc, cb_ac, cr_dc, cr_ac) (skip/inter/intra counts, the
    I16-in-P MBs of ``mb_intra`` intra): :func:`chunk_stats` of a
    one-frame chunk."""
    if y.dim() != 2:
        raise ValueError("y must be a 2-D luma plane")
    vecs, grids = chunk_stats(
        y.unsqueeze(0), prev_y, thr_sad, recon_y,
        None if mv is None else mv.unsqueeze(0),
        None if not resid else tuple(t.unsqueeze(0) for t in resid),
        None if mb_intra is None else mb_intra.unsqueeze(0))
    return vecs[0], grids[0]


def chunk_stats_plain(ys, prev_y, thr_sad: int, recon_last_y=None, mvs=None,
                      resid=None, mb_intra=None):
    """Plain PyTorch version of K4c: :func:`frame_stats_full_plain` slot
    by slot.  Same contract as :func:`chunk_stats`."""
    vecs, grids = [], []
    k = ys.shape[0]
    for i in range(k):
        # no previous luma: no damage in any slot
        prev = None if prev_y is None else prev_y if i == 0 else ys[i - 1]
        v, g = frame_stats_full_plain(
            ys[i], ys[i] if prev is None else prev, thr_sad,
            recon_last_y if i == k - 1 else None,
            None if mvs is None else mvs[i],
            None if mvs is None or not resid else tuple(t[i] for t in resid),
            None if mb_intra is None else mb_intra[i])
        if prev is None:
            v[IDX_DAMAGE] = -1.0
        vecs.append(v)
        grids.append(g)
    return torch.stack(vecs), torch.stack(grids)


def chunk_stats(ys, prev_y, thr_sad: int, recon_last_y=None, mvs=None,
                resid=None, mb_intra=None):
    """Stats of a chunk of K frames: ``ys`` the (K, H, W) uint8 luma
    stack; ``prev_y`` the luma before slot 0, or None (no damage in any
    slot: -1 and a zero grid); ``recon_last_y`` the last slot's
    reconstruction (SSE in slot K-1 only, -1 elsewhere); ``mvs`` (K, R,
    C, 2) and ``resid`` the
    five (K, ...) residual stacks, or None; ``mb_intra`` (K, R, C) the
    I16-in-P MBs (tune=hq), counted intra.  Returns ``(vecs, grids)``,
    float32 (K, VEC_LEN) and uint8 (K, R, C).

    CUDA tensors launch the kernels once for the chunk (the frame as a
    grid axis): one warp per MB for the damage SAD, the activity sums
    and the SSE, |MV| and coded flags, then one block per frame sorting
    the activity values in shared memory for the percentiles and a
    second sort for the |MV| p95.  CPU tensors run the plain version."""
    _check(ys, prev_y, recon_last_y, mvs, resid, mb_intra)
    k = ys.shape[0]
    if ys.device.type == "cpu":
        return chunk_stats_plain(ys, prev_y, int(thr_sad), recon_last_y, mvs,
                                 resid, mb_intra)
    r, c = ys.shape[1] // 16, ys.shape[2] // 16
    vecs = torch.empty((k, VEC_LEN), dtype=torch.float32, device=ys.device)
    grids = torch.empty((k, r, c), dtype=torch.uint8, device=ys.device)
    scratch = torch.empty(3 * k * r * c + 3 * k, dtype=torch.int32,
                          device=ys.device)
    _cuda.launch("content", "chunk_stats_launch",
                 [ys, prev_y, recon_last_y, mvs] + list(resid or (None,) * 5)
                 + [mb_intra, vecs, grids, scratch], [k, r, c, int(thr_sad)],
                 ys.device)
    if mb_intra is None:
        chunk_stats.launches += 1
    else:
        chunk_stats.hq.launches += 1
    return vecs, grids


chunk_stats.launches = 0
chunk_stats.hq = _cuda.Counter()         # with mb_intra (tune=hq)


# ---------------------------------------------------------------------------
# numpy oracle and host-side decoding (copied from the reference)
# ---------------------------------------------------------------------------

def mb_activity_np(y: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`ops.aq.mb_activity` (int32-exact)."""
    yi = np.asarray(y, np.int64)
    h, w = yi.shape
    t = yi.reshape(h // 16, 16, w // 16, 16)
    s = t.sum(axis=(1, 3))
    s2 = (t * t).sum(axis=(1, 3))
    return np.maximum(256 * s2 - s * s, 0).astype(np.int64)


def frame_stats_np(y, prev_y=None, recon_y=None, mv=None, resid=(),
                   mb_intra=None, thr_sad: int = 512
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle of :func:`frame_stats` — same vector layout, same
    -1 sentinels, float64 accumulation (the tolerance the device's
    float32 SSE sum is tested against)."""
    y = np.asarray(y)
    h, w = y.shape
    r, c = h // 16, w // 16
    vec = np.full(VEC_LEN, -1.0, np.float64)
    vec[IDX_MBS] = r * c
    if prev_y is not None:
        d = np.abs(y.astype(np.int64) - np.asarray(prev_y, np.int64))
        sad = d.reshape(r, 16, c, 16).sum(axis=(1, 3))
        grid = (sad > thr_sad).astype(np.uint8)
        vec[IDX_DAMAGE] = float(grid.sum())
    else:
        grid = np.zeros((r, c), np.uint8)
    if recon_y is not None:
        d = y.astype(np.int64) - np.asarray(recon_y, np.int64)
        vec[IDX_SSE] = float((d * d).sum())
    if mv is not None:
        m = np.asarray(mv, np.float64)
        mag = np.sqrt((m * m).sum(axis=-1)).reshape(-1)
        vec[IDX_MV_MEAN] = float(mag.mean())
        vec[IDX_MV_P95] = float(np.percentile(mag, 95.0))
    if mv is not None and len(resid):
        coded = np.zeros((r, c), bool)
        for t in resid:
            coded |= (np.asarray(t).reshape(r, c, -1) != 0).any(axis=-1)
        zero_mv = (np.asarray(mv) == 0).all(axis=-1)
        intra = (np.asarray(mb_intra, bool) if mb_intra is not None
                 else np.zeros((r, c), bool))
        vec[IDX_INTRA] = float(intra.sum())
        vec[IDX_SKIP] = float(((~coded) & zero_mv & (~intra)).sum())
        vec[IDX_INTER] = r * c - vec[IDX_INTRA] - vec[IDX_SKIP]
    act = mb_activity_np(y).astype(np.float64).reshape(-1)
    vec[IDX_ACT_P50] = float(np.percentile(act, 50.0))
    vec[IDX_ACT_P95] = float(np.percentile(act, 95.0))
    return vec, grid


# ---------------------------------------------------------------------------
# host-side decoding of the stats vector
# ---------------------------------------------------------------------------

def psnr_from_sse(sse: float, npix: int) -> Optional[float]:
    """Luma PSNR in dB from a summed SSE; None when the sentinel says
    no recon was in reach, 99.0 on an exact match (ops/aq convention)."""
    if sse is None or sse < 0:
        return None
    if sse <= 0:
        return 99.0
    return float(10.0 * np.log10(255.0 * 255.0 * npix / sse))


def vec_to_stats(vec: np.ndarray, grid: np.ndarray, npix: int) -> dict:
    """Decode one fetched stats vector + grid into the plain dict the
    content plane records (None for the -1 'not computed' slots)."""
    vec = np.asarray(vec, np.float64)
    mbs = max(int(vec[IDX_MBS]), 1)
    out = {
        "psnr_db": psnr_from_sse(float(vec[IDX_SSE]), npix),
        "damage_fraction": (float(vec[IDX_DAMAGE]) / mbs
                            if vec[IDX_DAMAGE] >= 0 else None),
        "damage_grid": np.asarray(grid, np.uint8),
        "mv_mean_qpel": (float(vec[IDX_MV_MEAN])
                         if vec[IDX_MV_MEAN] >= 0 else None),
        "mv_p95_qpel": (float(vec[IDX_MV_P95])
                        if vec[IDX_MV_P95] >= 0 else None),
        "act_p50": float(vec[IDX_ACT_P50]),
        "act_p95": float(vec[IDX_ACT_P95]),
        "mbs": mbs,
    }
    if vec[IDX_SKIP] >= 0:
        out["mode"] = {"skip": float(vec[IDX_SKIP]) / mbs,
                       "inter": float(vec[IDX_INTER]) / mbs,
                       "intra": float(vec[IDX_INTRA]) / mbs}
    else:
        out["mode"] = None
    return out


def downsample_grid(grid: np.ndarray, max_w: int = 32,
                    max_h: int = 18) -> np.ndarray:
    """Block-mean a (R, C) 0/1 MB damage grid down to at most
    ``max_h x max_w`` float cells for the /debug/content heatmap (a host
    helper, the reference's ``downsample_grid``)."""
    g = np.asarray(grid, np.float64)
    r, c = g.shape
    br = -(-r // max_h)
    bc = -(-c // max_w)
    if br > 1 or bc > 1:
        pr = -(-r // br) * br - r
        pc = -(-c // bc) * bc - c
        g = np.pad(g, ((0, pr), (0, pc)), constant_values=np.nan)
        g = np.nanmean(
            g.reshape(g.shape[0] // br, br, g.shape[1] // bc, bc),
            axis=(1, 3))
    return g
