"""Zigzag scan orders (JPEG 8x8, H.264 4x4) as gather index tables."""

from __future__ import annotations

import numpy as np
import torch


def _zigzag_order(n: int) -> np.ndarray:
    """Return flat indices of an n*n block in zigzag order."""
    # Even anti-diagonals run up-right, odd run down-left: the standard order
    # starts (0,0),(0,1),(1,0),(2,0),(1,1),(0,2)...
    order = []
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(max(0, s - n + 1), min(s, n - 1) + 1)]
        if s % 2 == 0:
            diag = diag[::-1]  # up-right direction: row decreasing
        order.extend(diag)
    return np.array([i * n + j for i, j in order], dtype=np.int32)


ZIGZAG8 = _zigzag_order(8)          # JPEG 8x8 scan (64 entries)
ZIGZAG4 = _zigzag_order(4)          # H.264 4x4 zigzag scan (16 entries)

_INV8 = np.argsort(ZIGZAG8).astype(np.int32)
_INV4 = np.argsort(ZIGZAG4).astype(np.int32)


def _index(order: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(order, dtype=torch.long, device=device)


def zigzag(blocks: torch.Tensor, n: int = 8) -> torch.Tensor:
    """(..., n, n) -> (..., n*n) in zigzag order."""
    order = ZIGZAG8 if n == 8 else ZIGZAG4
    flat = blocks.reshape(blocks.shape[:-2] + (n * n,))
    return flat[..., _index(order, blocks.device)]


def unzigzag(scanned: torch.Tensor, n: int = 8) -> torch.Tensor:
    """(..., n*n) zigzag order -> (..., n, n)."""
    inv = _INV8 if n == 8 else _INV4
    flat = scanned[..., _index(inv, scanned.device)]
    return flat.reshape(scanned.shape[:-1] + (n, n))
