"""JPEG quality tables and quantizer (T.81 Annex K, libjpeg scaling), and
the H.264 integer quant/dequant (JM/x264 MF/V fixed point; spec §8.5) on
int32 tensors:

    level  = sign(w) * ((|w| * MF[qp%6] + f) >> qbits),   qbits = 15 + qp//6
    w'     = level * V[qp%6] << (qp//6)                    (AC dequant)

``qp`` is a slice qp (an int: the tune=off path) or a per-MB int32
tensor broadcastable to the coefficients' leading dims (tune=hq's qp
plane); both give the same integers MB by MB.
"""

from __future__ import annotations

import numpy as np
import torch

# JPEG (ITU T.81 Annex K) base tables + libjpeg quality scaling
JPEG_LUMA_Q = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.int32)

JPEG_CHROMA_Q = np.array(
    [[17, 18, 24, 47, 99, 99, 99, 99],
     [18, 21, 26, 66, 99, 99, 99, 99],
     [24, 26, 56, 99, 99, 99, 99, 99],
     [47, 66, 99, 99, 99, 99, 99, 99]]
    + [[99] * 8] * 4, dtype=np.int32)


def jpeg_quality_tables(quality: int):
    """libjpeg-style quality (1..100) scaling of the Annex-K tables:
    (luma, chroma) int32 (8, 8)."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    luma = np.clip((JPEG_LUMA_Q * scale + 50) // 100, 1, 255).astype(np.int32)
    chroma = np.clip((JPEG_CHROMA_Q * scale + 50) // 100, 1, 255).astype(np.int32)
    return luma, chroma


def jpeg_quantize(coefs: torch.Tensor, table) -> torch.Tensor:
    """float32 ``round(c / q)`` (IEEE divide, half to even) as int32."""
    t = torch.as_tensor(np.asarray(table), dtype=torch.float32,
                        device=coefs.device)
    return torch.round(coefs.to(torch.float32) / t).to(torch.int32)


# MF (multiplication factor) per qp%6, by coefficient position class:
#   a: (0,0),(0,2),(2,0),(2,2)   b: (1,1),(1,3),(3,1),(3,3)   c: others
_MF_A = np.array([13107, 11916, 10082, 9362, 8192, 7282], dtype=np.int32)
_MF_B = np.array([5243, 4660, 4194, 3647, 3355, 2893], dtype=np.int32)
_MF_C = np.array([8066, 7490, 6554, 5825, 5243, 4559], dtype=np.int32)

# V (dequant scale) per qp%6, same position classes.
_V_A = np.array([10, 11, 13, 14, 16, 18], dtype=np.int32)
_V_B = np.array([16, 18, 20, 23, 25, 29], dtype=np.int32)
_V_C = np.array([13, 14, 16, 18, 20, 23], dtype=np.int32)


def _position_table(vec_a, vec_b, vec_c) -> np.ndarray:
    """(6, 4, 4) table from the three position-class vectors."""
    i = np.arange(4)[:, None] % 2
    j = np.arange(4)[None, :] % 2
    cls = np.where((i == 0) & (j == 0), 0, np.where((i == 1) & (j == 1), 1, 2))
    return np.stack([vec_a, vec_b, vec_c])[cls].transpose(2, 0, 1).copy()


MF_TABLE = _position_table(_MF_A, _MF_B, _MF_C)   # (6, 4, 4)
V_TABLE = _position_table(_V_A, _V_B, _V_C)       # (6, 4, 4)

# Chroma QP mapping for QPy 30..51 (below 30, QPc == QPy).  Spec Table 8-15.
_QPC_HIGH = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int32,
)


# Full 0..51 chroma-QP table (offset 0) for the per-MB qp path.
QPC_TABLE = np.array([q if q < 30 else int(_QPC_HIGH[q - 30])
                      for q in range(52)], dtype=np.int32)


def chroma_qp(qp_y: int, chroma_qp_index_offset: int = 0) -> int:
    q = int(np.clip(qp_y + chroma_qp_index_offset, 0, 51))
    return q if q < 30 else int(_QPC_HIGH[q - 30])


def chroma_qp_v(qp_y: torch.Tensor) -> torch.Tensor:
    """Per-MB chroma qp: int32 tensor in, Table 8-15 mapped out."""
    q = qp_y.to(torch.long).clamp(0, 51)
    return torch.as_tensor(QPC_TABLE, device=qp_y.device)[q]


def _vq(qp, ndim: int):
    """A per-MB qp tensor reshaped to broadcast under ``ndim``-dim
    coefficients: trailing unit dims."""
    q = qp.to(torch.int32)
    return q.reshape(q.shape + (1,) * (ndim - q.dim()))


def _table(tab: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tab, dtype=torch.int32, device=like.device)


def _signed(w: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    return (torch.sign(w) * level).to(torch.int32)


def h264_quantize_4x4(coefs: torch.Tensor, qp: int,
                      intra: bool = True) -> torch.Tensor:
    """Quantize core-transform coefficients, trailing dims (4, 4)."""
    w = coefs.to(torch.int32)
    if isinstance(qp, torch.Tensor):
        q = _vq(qp, w.dim())
        qbits = 15 + q // 6
        mf = _table(MF_TABLE, w)[(q % 6)[..., 0, 0].long()]
        f = (1 << qbits) // (3 if intra else 6)
        return _signed(w, (w.abs() * mf + f) >> qbits)
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    level = (w.abs() * _table(MF_TABLE[qp % 6], w) + f) >> qbits
    return _signed(w, level)


def h264_dequantize_4x4(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize 4x4 AC levels per spec §8.5.12.1 (no rounding)."""
    lv = levels.to(torch.int32)
    if isinstance(qp, torch.Tensor):
        q = _vq(qp, lv.dim())
        v = _table(V_TABLE, lv)[(q % 6)[..., 0, 0].long()]
        return (lv * v) << (q // 6)
    return (lv * _table(V_TABLE[qp % 6], lv)) << (qp // 6)


def h264_quantize_luma_dc(dc_hadamard: torch.Tensor, qp: int) -> torch.Tensor:
    """Quantize the 4x4 Hadamard-transformed luma DC block (JM convention:
    MF[qp%6][0,0] with an extra >>1 of headroom, qbits + 1)."""
    w = dc_hadamard.to(torch.int32)
    if isinstance(qp, torch.Tensor):
        q = _vq(qp, w.dim())
        qbits = 15 + q // 6
        mf00 = _table(_MF_A, w)[(q % 6).long()]
        return _signed(w, (w.abs() * mf00 + 2 * ((1 << qbits) // 3))
                       >> (qbits + 1))
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    level = (w.abs() * int(_MF_A[qp % 6]) + 2 * f) >> (qbits + 1)
    return _signed(w, level)


def h264_dequantize_luma_dc(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize luma DC *after* the inverse Hadamard (spec §8.5.10).

    dcY = (f * V00 << (qp//6)) >> 2         if qp >= 12
        = (f * V00 + 2^(1 - qp//6)) >> (2 - qp//6)   otherwise
    """
    f = levels.to(torch.int32)
    if isinstance(qp, torch.Tensor):
        q = _vq(qp, f.dim())
        v00 = _table(_V_A, f)[(q % 6).long()]
        hi = (f * v00) << torch.clamp(q // 6 - 2, min=0)
        shift = torch.clamp(2 - q // 6, min=1)
        lo = (f * v00 + (1 << (shift - 1))) >> shift
        return torch.where(q >= 12, hi, lo)
    v00 = int(_V_A[qp % 6])
    if qp >= 12:
        return (f * v00) << (qp // 6 - 2)
    shift = 2 - qp // 6
    return (f * v00 + (1 << (shift - 1))) >> shift


def h264_quantize_chroma_dc(dc_hadamard: torch.Tensor, qp_c: int,
                            intra: bool = True) -> torch.Tensor:
    """Quantize the 2x2 Hadamard chroma DC (JM convention: qbits + 1)."""
    w = dc_hadamard.to(torch.int32)
    if isinstance(qp_c, torch.Tensor):
        q = _vq(qp_c, w.dim())
        qbits = 15 + q // 6
        mf00 = _table(_MF_A, w)[(q % 6).long()]
        f = (1 << qbits) // (3 if intra else 6)
        return _signed(w, (w.abs() * mf00 + 2 * f) >> (qbits + 1))
    qbits = 15 + qp_c // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    level = (w.abs() * int(_MF_A[qp_c % 6]) + 2 * f) >> (qbits + 1)
    return _signed(w, level)


def h264_dequantize_chroma_dc(levels: torch.Tensor, qp_c: int) -> torch.Tensor:
    """Dequantize chroma DC after inverse 2x2 Hadamard (spec §8.5.11):
    dcC = ((f * V00) << (qp_c//6)) >> 1."""
    f = levels.to(torch.int32)
    if isinstance(qp_c, torch.Tensor):
        q = _vq(qp_c, f.dim())
        return ((f * _table(_V_A, f)[(q % 6).long()]) << (q // 6)) >> 1
    return ((f * int(_V_A[qp_c % 6])) << (qp_c // 6)) >> 1
