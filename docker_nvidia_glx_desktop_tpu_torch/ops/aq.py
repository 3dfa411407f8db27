"""Per-MB luma reductions (from the reference's ``ops/aq.py``): the
activity the content-stats kernel reports, and the numpy qp chain the host
entropy coder uses under tune=hq."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mb_activity", "qp_chain_np"]


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


def qp_chain_np(qp_map: np.ndarray, codes_delta: np.ndarray,
                slice_qp: int):
    """Per-row effective-QP chain and the per-MB mb_qp_delta values: an MB
    that does not code the syntax keeps the previous MB's effective qp."""
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
