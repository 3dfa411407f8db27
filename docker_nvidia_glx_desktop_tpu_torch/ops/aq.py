"""Perceptual-efficiency tuning (``ENCODER_TUNE=hq``), from the
reference's ``ops/aq.py``:

- the per-MB qp plane (K14, ``csrc/aq.cu``): an activity delta from the
  MB's luma variance, plus, where the next frame is staged, a lookahead
  bias from its SAD against this frame, added to the slice qp and
  clipped to [1, 51];
- the Lagrangian lambda tables the intra and P cores score with;
- the per-row ``mb_qp_delta`` chain the slot coders emit (spec 7.4.5:
  an MB without the syntax keeps the previous MB's qp).

The reference decides in float32 on XLA's CPU backend, and these
decisions are visible in the bitstream, so the port holds them exactly:

- **the activity delta** ``round(s * 0.5 * (log2(act/256 + 1) - 12))``
  is a monotone step function of the integer activity.  For the default
  knobs the port compares the activity against the reference's
  breakpoints (:data:`DEFAULT_AQ_STEPS`, pinned by the tests against
  ``aq_offsets``); XLA's fused ``log2`` is not CUDA's ``log2f`` nor
  numpy's, and differs from both at exact powers of two.  Other knob
  values take breakpoints found by bisection over numpy's float32
  ``log2``, which can differ from XLA's at isolated activities;
- **the lambda tables**, as float32 bit patterns: full ``hq`` computes
  ``0.85 * exp2((q - 12) / 3)`` per MB in float32 on XLA (and ``sqrt``
  of it for the motion lambda); ``hq_noaq`` computes them in Python
  float64 and rounds to float32 where they are used.  Two 52-entry
  tables per lambda;
- **the motion margins** ``(int)(lam_mv * bits)`` of the P core, as
  integer tables per qp.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from ..utils.env import env_float as _envf

__all__ = ["mb_activity", "aq_offsets", "lookahead_bias", "qp_plane",
           "qp_plane_plain", "qp_chain", "qp_chain_np", "lam_tables",
           "margin_tables", "device_tables", "AQ_STRENGTH", "AQ_MAX_DELTA",
           "AQ_MAX_UP", "LOOKAHEAD_BIAS", "TIERS", "sse_planes",
           "sse_planes_plain", "mse_planes", "psnr_planes"]

# Operator knobs, read once at import as the reference reads them: the
# activity strength, the delta clamps and the lookahead reward.
AQ_STRENGTH = _envf("DNGD_AQ_STRENGTH", 1.0)
AQ_MAX_DELTA = int(_envf("DNGD_AQ_MAX_DELTA", 4))
AQ_MAX_UP = int(_envf("DNGD_AQ_MAX_UP", 1))
LOOKAHEAD_BIAS = int(_envf("DNGD_LOOKAHEAD_BIAS", 2))

_AQ_REF_LOG = 12.0
TIERS = ("off", "hq_noaq", "hq")      # kernel tier index 0, 1, 2

# delta(A) = first + #(steps <= A) for the default knobs (strength 1,
# clamps -4 / +1): the activities A (= 256 * the MB's summed squared
# deviation) where the reference's delta rises by one.
DEFAULT_AQ_STEPS = (-4, (7937, 32512, 130817, 524033, 2096897))


def _mb_reduce(plane: torch.Tensor, op) -> torch.Tensor:
    """(H, W) -> (R, C) per-16x16-MB reduction."""
    h, w = plane.shape
    return op(plane.reshape(h // 16, 16, w // 16, 16), (1, 3))


def mb_activity(y: torch.Tensor) -> torch.Tensor:
    """Per-MB luma activity: sum of squared deviation from the MB mean
    times 256 (256 * s2 - s * s), int32-exact: both products wrap in
    int32 the same way, and their difference (<= ~2^30) does not."""
    yi = y.to(torch.int32)
    s = _mb_reduce(yi, lambda t, d: t.sum(dim=d, dtype=torch.int32))
    s2 = _mb_reduce(yi * yi, lambda t, d: t.sum(dim=d, dtype=torch.int32))
    return torch.clamp(256 * s2 - s * s, min=0)


def _delta_np(a: int, strength: float, max_delta: int) -> int:
    """The reference's activity delta of one activity, in numpy float32."""
    act = np.float32(a) / np.float32(256.0)
    lg = np.log2(act + np.float32(1.0))
    d = np.float32(strength * 0.5) * (lg - np.float32(_AQ_REF_LOG))
    return int(np.clip(np.round(d), -max_delta, min(AQ_MAX_UP, max_delta)))


def aq_steps(strength: float = None, max_delta: int = None):
    """(first, steps): delta(A) = first + #(steps <= A), A the int32
    activity; the default knobs' pinned table, else bisection over
    numpy's float32 log2 (see the module docstring)."""
    s = AQ_STRENGTH if strength is None else float(strength)
    md = AQ_MAX_DELTA if max_delta is None else int(max_delta)
    if s == 1.0 and md == 4 and AQ_MAX_UP == 1:
        return DEFAULT_AQ_STEPS
    hi_a = (1 << 31) - 1
    first, last = _delta_np(0, s, md), _delta_np(hi_a, s, md)
    if last < first:
        raise ValueError(f"DNGD_AQ_STRENGTH={s}: the activity delta must "
                         "not fall with activity")
    steps = []
    for k in range(first + 1, last + 1):
        lo, hi = 0, hi_a                      # least A with delta >= k
        while lo < hi:
            mid = (lo + hi) // 2
            if _delta_np(mid, s, md) >= k:
                hi = mid
            else:
                lo = mid + 1
        steps.append(lo)
    return first, tuple(steps)


def aq_offsets(y: torch.Tensor, strength: float = None,
               max_delta: int = None) -> torch.Tensor:
    """(R, C) int32 per-MB qp delta from luma activity (the reference's
    ``aq_offsets``)."""
    first, steps = aq_steps(strength, max_delta)
    act = mb_activity(y)
    st = torch.as_tensor(steps, dtype=torch.int32, device=y.device)
    return first + (act[..., None] >= st).sum(dim=-1, dtype=torch.int32)


def lookahead_bias(y: torch.Tensor, next_y: torch.Tensor,
                   bias: int = None) -> torch.Tensor:
    """(R, C) int32 qp bias from the next frame: ``-bias`` where the MB's
    SAD against it is at most 256 (mean abs diff 1), +1 from 6 * 256,
    else 0."""
    b = LOOKAHEAD_BIAS if bias is None else int(bias)
    d = (y.to(torch.int32) - next_y.to(torch.int32)).abs()
    sad = _mb_reduce(d, lambda t, dd: t.sum(dim=dd, dtype=torch.int32))
    return torch.where(sad <= 256, -b,
                       torch.where(sad >= 6 * 256, 1, 0)).to(torch.int32)


def qp_plane_plain(y: torch.Tensor, qp: int, next_y=None,
                   rows=None) -> torch.Tensor:
    """Plain PyTorch version of K14: the (R, C) int32 absolute qp map, or
    its rows ``rows`` ((b,) int32 worklist) as a (b, C) map (K14r)."""
    d = aq_offsets(y)
    if next_y is not None:
        d = d + lookahead_bias(y, next_y)
    res = torch.clamp(int(qp) + d, 1, 51).to(torch.int32)
    return res if rows is None else res[rows.long()]


def qp_plane(y: torch.Tensor, qp: int, next_y=None, qp_dev=None,
             out=None, rows=None) -> torch.Tensor:
    """Per-MB qp plane of the uint8 luma ``y`` (the reference's
    ``qp_plane``), with the lookahead bias where ``next_y`` is given.
    ``rows`` ((b,) int32, each in 0..R-1, duplicates allowed) asks for
    the plane of those MB rows only, (b, C) (K14r: the damage mask's
    worklist, whose bands the reference's ``row_core`` plans one by one;
    the math is per MB, so a band's plane is the frame's at its row).

    CUDA tensors launch K14 (one block per MB: the activity sums, the
    breakpoint compare, the lookahead SAD; over a worklist, a block per
    listed MB, reading only those rows); ``qp_dev`` (one int32 on the
    card) replaces ``qp`` for a captured graph, ``out`` is the int32
    result tensor where the caller owns it.  CPU tensors run the plain
    version."""
    if y.dtype != torch.uint8 or y.dim() != 2 or y.shape[0] % 16 \
            or y.shape[1] % 16 or not y.is_contiguous():
        raise ValueError("y must be a contiguous MB-aligned uint8 plane")
    if next_y is not None and (next_y.shape != y.shape
                               or next_y.dtype != torch.uint8
                               or next_y.device != y.device):
        raise ValueError("next_y must match y")
    nr, nc = y.shape[0] // 16, y.shape[1] // 16
    nb = nr
    if rows is not None:
        nb = rows.numel()
        if (rows.dim() != 1 or rows.dtype != torch.int32
                or rows.device != y.device or not 0 < nb <= nr):
            raise ValueError(f"rows must be 1 to {nr} int32 on {y.device}")
    if out is not None and (tuple(out.shape) != (nb, nc)
                            or out.dtype != torch.int32
                            or out.device != y.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be ({nb}, {nc}) int32 on y's device")
    if y.device.type == "cpu":
        if qp_dev is not None:
            qp = int(qp_dev.reshape(-1)[0])
        res = qp_plane_plain(y, qp, next_y, rows)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((nb, nc), dtype=torch.int32, device=y.device)
    first, steps, st = _steps_on(y.device)
    _cuda.launch("aq", "qp_plane_launch",
                 [y, next_y, None if rows is None else rows.contiguous(),
                  qp_dev, st, out],
                 [nr, nc, nb, int(qp), first, len(steps), LOOKAHEAD_BIAS],
                 y.device)
    (qp_plane if rows is None else qp_plane.rows).launches += 1
    return out


qp_plane.launches = 0
qp_plane.rows = _cuda.Counter()         # K14r: a worklist's rows

_steps_dev: dict = {}


def _steps_on(dev):
    """(first, steps, steps as a (16,) int32 tensor on ``dev``), cached:
    uploaded once, outside any graph capture."""
    got = _steps_dev.get(dev)
    if got is None:
        first, steps = aq_steps()
        if len(steps) > 16:
            raise ValueError("more than 16 activity breakpoints")
        got = _steps_dev[dev] = (first, steps, torch.tensor(
            list(steps) + [2 ** 31 - 1] * (16 - len(steps)),
            dtype=torch.int32, device=dev))
    return got


# ---------------------------------------------------------------------------
# Lagrangian lambdas (float32 bit patterns, qp 0..51)
# ---------------------------------------------------------------------------

# full hq: 0.85 * exp2((q - 12) / 3) computed in float32 on XLA's CPU
# backend, and its float32 sqrt
_LAM_MODE_HQ_BITS = (
    0x3d59999a, 0x3d891455, 0x3dacb591, 0x3dd9999a, 0x3e091455, 0x3e2cb591,
    0x3e59999a, 0x3e891455, 0x3eacb591, 0x3ed9999a, 0x3f091455, 0x3f2cb591,
    0x3f59999a, 0x3f891455, 0x3facb591, 0x3fd9999a, 0x40091455, 0x402cb591,
    0x4059999a, 0x40891455, 0x40acb591, 0x40d9999a, 0x41091455, 0x412cb591,
    0x4159999a, 0x41891455, 0x41acb591, 0x41d9999a, 0x42091455, 0x422cb591,
    0x4259999a, 0x42891455, 0x42acb591, 0x42d9999a, 0x43091455, 0x432cb591,
    0x4359999a, 0x43891455, 0x43acb591, 0x43d9999a, 0x44091455, 0x442cb591,
    0x4459999a, 0x44891455, 0x44acb591, 0x44d9999a, 0x45091455, 0x452cb597,
    0x4559999a, 0x45891450, 0x45acb591, 0x45d999a1,
)
_LAM_MV_HQ_BITS = (
    0x3e6c0535, 0x3e847642, 0x3e94aefa, 0x3ea6e43f, 0x3ebb5458, 0x3ed2452d,
    0x3eec0535, 0x3f047642, 0x3f14aefa, 0x3f26e43f, 0x3f3b5458, 0x3f52452d,
    0x3f6c0535, 0x3f847642, 0x3f94aefa, 0x3fa6e43f, 0x3fbb5458, 0x3fd2452d,
    0x3fec0535, 0x40047642, 0x4014aefa, 0x4026e43f, 0x403b5458, 0x4052452d,
    0x406c0535, 0x40847642, 0x4094aefa, 0x40a6e43f, 0x40bb5458, 0x40d2452d,
    0x40ec0535, 0x41047642, 0x4114aefa, 0x4126e43f, 0x413b5458, 0x4152452d,
    0x416c0535, 0x41847642, 0x4194aefa, 0x41a6e43f, 0x41bb5458, 0x41d2452d,
    0x41ec0535, 0x42047642, 0x4214aefa, 0x4226e43f, 0x423b5458, 0x42524531,
    0x426c0535, 0x4284763f, 0x4294aefa, 0x42a6e442,
)
# hq_noaq: the same in Python float64, rounded to float32
_LAM_MODE_NOAQ_BITS = (
    0x3d59999a, 0x3d891454, 0x3dacb590, 0x3dd9999a, 0x3e091454, 0x3e2cb590,
    0x3e59999a, 0x3e891454, 0x3eacb590, 0x3ed9999a, 0x3f091454, 0x3f2cb590,
    0x3f59999a, 0x3f891454, 0x3facb590, 0x3fd9999a, 0x40091454, 0x402cb590,
    0x4059999a, 0x40891454, 0x40acb590, 0x40d9999a, 0x41091454, 0x412cb590,
    0x4159999a, 0x41891454, 0x41acb590, 0x41d9999a, 0x42091454, 0x422cb590,
    0x4259999a, 0x42891454, 0x42acb590, 0x42d9999a, 0x43091454, 0x432cb590,
    0x4359999a, 0x43891454, 0x43acb590, 0x43d9999a, 0x44091454, 0x442cb590,
    0x4459999a, 0x44891454, 0x44acb590, 0x44d9999a, 0x45091454, 0x452cb590,
    0x4559999a, 0x45891454, 0x45acb590, 0x45d9999a,
)
_LAM_MV_NOAQ_BITS = (
    0x3e6c0535, 0x3e847641, 0x3e94aefa, 0x3ea6e43f, 0x3ebb5458, 0x3ed2452d,
    0x3eec0535, 0x3f047641, 0x3f14aefa, 0x3f26e43f, 0x3f3b5458, 0x3f52452d,
    0x3f6c0535, 0x3f847641, 0x3f94aefa, 0x3fa6e43f, 0x3fbb5458, 0x3fd2452d,
    0x3fec0535, 0x40047641, 0x4014aefa, 0x4026e43f, 0x403b5458, 0x4052452d,
    0x406c0535, 0x40847641, 0x4094aefa, 0x40a6e43f, 0x40bb5458, 0x40d2452d,
    0x40ec0535, 0x41047641, 0x4114aefa, 0x4126e43f, 0x413b5458, 0x4152452d,
    0x416c0535, 0x41847641, 0x4194aefa, 0x41a6e43f, 0x41bb5458, 0x41d2452d,
    0x41ec0535, 0x42047641, 0x4214aefa, 0x4226e43f, 0x423b5458, 0x4252452d,
    0x426c0535, 0x42847641, 0x4294aefa, 0x42a6e43f,
)


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


# the I16-vs-I4 signalling cost lam * 44: hq_noaq's is Python float64
# arithmetic rounded once to float32; full hq multiplies in float32
_I4_SIG_BITS = 44
_I4_SIG_NOAQ = np.array(
    [0.85 * 2.0 ** ((q - 12) / 3.0) * _I4_SIG_BITS for q in range(52)],
    np.float64).astype(np.float32)


def lam_tables(tune: str):
    """(lam_mode, lam_mv, i4_sig) float32 numpy tables of the kernel
    tier ``tune`` ("hq" or "hq_noaq"), indexed by qp 0..51; ``i4_sig``
    is hq_noaq's constant signalling cost (None under full hq, which
    multiplies lam_mode by 44 in the decision)."""
    if tune == "hq":
        return _f32(_LAM_MODE_HQ_BITS), _f32(_LAM_MV_HQ_BITS), None
    if tune == "hq_noaq":
        return (_f32(_LAM_MODE_NOAQ_BITS), _f32(_LAM_MV_NOAQ_BITS),
                _I4_SIG_NOAQ)
    raise ValueError(f"no lambda tables for tune={tune!r}")


# the P core's rate model (bits): the mvd+cbp a zero-MV skip saves, the
# extra mvd precision bits of a half- / quarter-pel refinement
_MARGIN_BITS = (16.0, 4.0, 3.0)


def margin_tables(tune: str, scale: int = 2) -> np.ndarray:
    """(3, 52) int32 motion margins ``(int)(lam_mv[q] * bits / scale)``
    in float32 for the zero-MV, half-pel and quarter-pel stages: on the
    alternate-line SAD scale (``scale`` 2, ``refine="alt"``) or the
    full-line one (1, ``refine="full"``'s refinement stages)."""
    lam_v = lam_tables(tune)[1]
    return np.stack([(lam_v * np.float32(b / scale)).astype(np.float32)
                     .astype(np.int32) for b in _MARGIN_BITS])


_tables_dev: dict = {}


def device_tables(tune: str, dev, scale: int = 2) -> tuple:
    """The tier's tables on ``dev`` for the hq kernels, cached: lam_mode
    (52,) float32, the I16-vs-I4 signalling cost (52,) float32 (hq_noaq's
    rounded constants; under full hq lam_mode again, which K1 multiplies
    by 44) and the motion margins (3, 52) int32 at ``scale``."""
    key = (tune, dev, scale)
    got = _tables_dev.get(key)
    if got is None:
        lam, _, sig = lam_tables(tune)
        got = _tables_dev[key] = (
            torch.from_numpy(lam.copy()).to(dev),
            torch.from_numpy((lam if sig is None else sig).copy()).to(dev),
            torch.from_numpy(margin_tables(tune, scale)).to(dev))
    return got


# ---------------------------------------------------------------------------
# mb_qp_delta chain
# ---------------------------------------------------------------------------

def qp_chain(qp_map: torch.Tensor, codes: torch.Tensor, slice_qp: int):
    """Per-row effective-qp chain and the per-MB mb_qp_delta values.

    ``codes``: (R, C) bool, the MBs whose syntax carries mb_qp_delta.
    Returns (eff, delta), int32 (R, C): an MB that does not code the
    syntax keeps the previous MB's effective qp (its delta is gated off
    by the caller); each row starts from ``slice_qp``."""
    qp_map = qp_map.to(torch.int32)
    nr, nc = qp_map.shape
    idx = torch.arange(nc, device=qp_map.device)[None, :].expand(nr, nc)
    j = torch.cummax(torch.where(codes.to(torch.bool), idx, -1), dim=1).values
    eff = torch.where(j >= 0, torch.gather(qp_map, 1, j.clamp(min=0)),
                      int(slice_qp)).to(torch.int32)
    prev = torch.cat([torch.full((nr, 1), int(slice_qp), dtype=torch.int32,
                                 device=qp_map.device), eff[:, :-1]], dim=1)
    return eff, (qp_map - prev).to(torch.int32)


def qp_chain_np(qp_map: np.ndarray, codes_delta: np.ndarray,
                slice_qp: int):
    """Numpy twin of :func:`qp_chain` for the host entropy coders."""
    qp_map = np.asarray(qp_map, np.int32)
    codes = np.asarray(codes_delta, bool)
    nr, nc = qp_map.shape
    idx = np.arange(nc, dtype=np.int32)[None, :]
    j = np.maximum.accumulate(np.where(codes, idx, -1), axis=1)
    eff = np.where(j >= 0,
                   np.take_along_axis(qp_map, np.clip(j, 0, None), axis=1),
                   slice_qp).astype(np.int32)
    prev = np.concatenate(
        [np.full((nr, 1), slice_qp, np.int32), eff[:, :-1]], axis=1)
    return eff, (qp_map - prev).astype(np.int32)


# ---------------------------------------------------------------------------
# The distortion reduction (row 14d): the BD-rate bench's PSNR input
# ---------------------------------------------------------------------------

def _plane_pair(a, b, device):
    """Two uint8 planes of one shape as tensors on one device: tensors stay
    where they are, numpy arrays go to ``device`` (None = the card)."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        from ..models.h264 import resolve_device
        dev = (a.device if isinstance(a, torch.Tensor) else
               b.device if isinstance(b, torch.Tensor) else
               resolve_device(device))
        a, b = (t if isinstance(t, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                for t in (a, b))
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError("the planes must be uint8")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("the planes must match in shape and device")
    return a.contiguous(), b.contiguous()


def sse_planes_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K14d: the int64 sum of squared differences."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).to(torch.int64).sum()


def sse_planes(a, b, device=None) -> torch.Tensor:
    """Exact sum of squared differences of two uint8 planes of one shape
    (numpy arrays or tensors), a one-element int64 tensor on their device,
    not synchronised.  CUDA tensors launch K14d (``csrc/aq.cu``), CPU
    tensors run the plain version; numpy arrays go to ``device`` first
    (None = the card: without CUDA that raises)."""
    a, b = _plane_pair(a, b, device)
    if a.device.type == "cpu":
        return sse_planes_plain(a, b)
    out = torch.empty(1, dtype=torch.int64, device=a.device)
    _cuda.launch("aq", "sse_launch", [a, b, out], [a.numel()], a.device)
    sse_planes.launches += 1
    return out[0]


sse_planes.launches = 0


def mse_planes(a, b, device=None) -> float:
    """Mean squared error of two planes from the exact int64 SSE (the
    reference's ``mse_planes``; its JAX sum is int32 and wraps where this
    one does not)."""
    sse = int(sse_planes(a, b, device))
    return sse / max(int(np.prod(a.shape)), 1)


def psnr_planes(a, b, device=None) -> float:
    """Luma PSNR in dB of two uint8 planes (99.0 when they are equal)."""
    m = mse_planes(a, b, device)
    if m <= 0:
        return 99.0
    return float(10.0 * np.log10(255.0 * 255.0 / m))
