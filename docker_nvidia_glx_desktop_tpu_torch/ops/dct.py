"""H.264 4x4 integer core transform (spec §8.5.12) and the 4x4 / 2x2
Hadamard DC transforms, on int32 tensors.

Plain integer butterflies along one axis at a time, so the same code runs
on any device (CUDA has no integer matmul) and every sum is exact.  The
inverse transform follows the spec's pass order (rows, then columns) and
its ``>>1`` and final ``(x + 32) >> 6`` bit-exactly.
"""

from __future__ import annotations

import torch


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
