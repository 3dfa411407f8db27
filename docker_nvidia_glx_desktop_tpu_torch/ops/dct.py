"""The JPEG 8x8 float DCT, the H.264 4x4 integer core transform (spec
§8.5.12) and the 4x4 / 2x2 Hadamard DC transforms.

:func:`dct8x8` is the plain version of the JPEG transform's DCT (K16a,
``csrc/jpeg.cu``): the orthonormal DCT-II with the reference's float32
matrix, summed in float64 in one fixed order (rows, then columns, terms
in index order, no fused multiply-add) and rounded once to float32.  The
kernel spells the same order, so the two agree bit for bit; the
reference's float32 einsum agrees to ~4e-5 (its order is the compiler's).

Plain integer butterflies along one axis at a time, so the same code runs
on any device (CUDA has no integer matmul) and every sum is exact.  The
inverse transform follows the spec's pass order (rows, then columns) and
its ``>>1`` and final ``(x + 32) >> 6`` bit-exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos((2 * i + 1) * k * np.pi / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] = np.sqrt(1.0 / n)
    return m.astype(np.float32)


DCT8 = _dct_matrix(8)


def to_blocks(plane: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(..., H, W) -> (..., H/bh, W/bw, bh, bw)."""
    h, w = plane.shape[-2], plane.shape[-1]
    if h % bh or w % bw:
        raise ValueError(f"plane ({h}, {w}) does not split into {bh}x{bw}")
    p = plane.reshape(plane.shape[:-2] + (h // bh, bh, w // bw, bw))
    return p.transpose(-3, -2)


def dct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II over trailing (8, 8) dims -> float32.

    ``t[i][v] = sum_j x[i][j] * D[v][j]``, then ``c[u][v] = sum_i D[u][i]
    * t[i][v]``, each sum from index 0 up, every product and sum rounded
    to float64, the result rounded once to float32."""
    x = blocks.to(torch.float64)
    d = torch.as_tensor(DCT8, dtype=torch.float64, device=x.device)
    t = x[..., :, 0, None] * d[:, 0]
    for j in range(1, 8):
        t = t + x[..., :, j, None] * d[:, j]
    c = d[:, 0, None] * t[..., 0, None, :]
    for i in range(1, 8):
        c = c + d[:, i, None] * t[..., i, None, :]
    return c.to(torch.float32)


def _along(x: torch.Tensor, dim: int, f) -> torch.Tensor:
    """Apply the 4-point butterfly ``f`` along ``dim`` of ``x``."""
    return torch.stack(f(*x.unbind(dim)), dim=dim)


def _core_fwd(x0, x1, x2, x3):
    s03, d03, s12, d12 = x0 + x3, x0 - x3, x1 + x2, x1 - x2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def _had4(x0, x1, x2, x3):
    s01, d01, s23, d23 = x0 + x1, x0 - x1, x2 + x3, x2 - x3
    return s01 + s23, s01 - s23, d01 - d23, d01 + d23


def _core_inv(d0, d1, d2, d3):
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def fdct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Forward core transform ``Cf . X . Cf^T`` over trailing (4, 4) dims."""
    x = blocks.to(torch.int32)
    return _along(_along(x, -2, _core_fwd), -1, _core_fwd)


def idct4x4(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse core transform, bit-exact per spec §8.5.12.2: each row
    first (horizontal), then each column, then ``(x + 32) >> 6``."""
    d = coefs.to(torch.int32)
    h = _along(_along(d, -1, _core_inv), -2, _core_inv)
    return (h + 32) >> 6


def hadamard4x4(blocks: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard ``H . X . H^T`` (no scaling), trailing (4, 4) dims."""
    x = blocks.to(torch.int32)
    return _along(_along(x, -2, _had4), -1, _had4)


def hadamard2x2(blocks: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard (chroma DC), trailing (2, 2) dims."""
    x = blocks.to(torch.int32)
    had2 = lambda a, b: (a + b, a - b)
    return _along(_along(x, -2, had2), -1, had2)
