"""RGB -> studio-range BT.601 YUV 4:2:0 planes on the card (K9), and the
plain full-range (JFIF) conversion of the JPEG transform (K16a).

Replaces the reference's ``models/h264.py`` ``_yuv_stage`` (``ops/
color.py`` ``rgb_to_yuv420`` with ``matrix="video"``, then round and
clip): an (H, W, 3) uint8 RGB frame is edge-padded to (pad_h, pad_w),
each pixel's Y, Cb and Cr are float32 multiply-adds, chroma is the 2x2
mean, and every value is rounded half-to-even and clipped to uint8.

Bit-exact with the reference as XLA compiles it on the CPU, which
contracts the multiply-adds into fused multiply-adds: per channel
``fma(b, m2, fma(r, m0, g*m1)) + off``, then the 2x2 quad summed in row
order (``((p00 + p01) + p10) + p11``) and divided by 4.  The tests pin
both orders against the reference over every RGB triple (luma) and on
random, flat and edge frames (chroma).  The plain version evaluates each
fused step in float64 and rounds it to float32: a product of an 8-bit
integer and a float32 constant plus a float32 is exact in float64, so
that rounding is the single rounding of a fused multiply-add.

:func:`rgb_to_yuv420_frames` converts a chunk of K frames in one launch
of ``csrc/color.cu`` (the kernel's frame axis) for a CUDA tensor and
runs :func:`rgb_to_yuv420_frames_plain` for a CPU tensor: the super-step
ring's rgb ingest, and the luma stack its content stats take (the
reference's ``models/h264.py`` ``_stack_luma``).  :func:`rgb_to_yuv420`
is its one-frame call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

# BT.601 luma coefficients; full-range matrix scaled to studio range in
# float32, as the reference builds it.
_KR, _KG, _KB = 0.299, 0.587, 0.114
_M_FULL = np.array([[_KR, _KG, _KB],
                    [-_KR / 1.772, -_KG / 1.772, 0.5],
                    [0.5, -_KG / 1.402, -_KB / 1.402]], dtype=np.float32)
M_VIDEO = _M_FULL * np.array([[219.0 / 255.0], [224.0 / 255.0],
                              [224.0 / 255.0]], dtype=np.float32)
OFF_VIDEO = np.array([16.0, 128.0, 128.0], dtype=np.float32)
# the kernel's arguments: the matrix row-major, then the offsets, as
# float32 bit patterns
_MATRIX_BITS = [int(v) for v in np.concatenate(
    [M_VIDEO.ravel(), OFF_VIDEO]).view(np.int32)]


OFF_FULL = np.array([0.0, 128.0, 128.0], dtype=np.float32)


def rgb_to_ycbcr_full(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) full-range YCbCr in float64,
    ``((r * m0 + g * m1) + b * m2) + off`` with the reference's float32
    matrix.  Every step is exact in float64 (a product of an 8-bit
    integer and a float32 constant has at most 32 significant bits, and
    the sums span under 40), so any order gives these values; the
    reference's float32 rounds them."""
    f = rgb.to(torch.float64)
    r, g, b = f.unbind(-1)
    chans = []
    for d in range(3):
        m = [float(v) for v in _M_FULL[d]]
        chans.append(((r * m[0] + g * m[1]) + b * m[2]) + float(OFF_FULL[d]))
    return torch.stack(chans, dim=-1)


def subsample_420(chroma: torch.Tensor) -> torch.Tensor:
    """2x2 mean of a (..., H, W) plane, H and W even: the quad summed in
    row order, ``((p00 + p01) + p10) + p11``, times 0.25."""
    s = ((chroma[..., 0::2, 0::2] + chroma[..., 0::2, 1::2])
         + chroma[..., 1::2, 0::2]) + chroma[..., 1::2, 1::2]
    return s * 0.25


def rgb_to_yuv420_full(rgb: torch.Tensor):
    """(..., H, W, 3) uint8 RGB -> full-range (Y (..., H, W), Cb, Cr
    (..., H/2, W/2)) float64 planes, unrounded (exact: see
    :func:`rgb_to_ycbcr_full`; the quad mean is exact too)."""
    ycc = rgb_to_ycbcr_full(rgb)
    return ycc[..., 0], subsample_420(ycc[..., 1]), subsample_420(ycc[..., 2])


def _channel(rgb64: torch.Tensor, d: int) -> torch.Tensor:
    """float32 channel ``d`` of (..., 3) float64 RGB, fused order."""
    m = [float(v) for v in M_VIDEO[d]]
    r, g, b = rgb64.unbind(-1)
    acc = (g * m[1]).to(torch.float32)
    acc = (r * m[0] + acc.double()).to(torch.float32)
    acc = (b * m[2] + acc.double()).to(torch.float32)
    return acc + torch.tensor(float(OFF_VIDEO[d]), dtype=torch.float32)


def _q(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(p), 0, 255).to(torch.uint8)


def rgb_to_yuv420_plain(rgb: torch.Tensor, pad_h: int, pad_w: int):
    """One frame of K9's plain version: same contract as
    :func:`rgb_to_yuv420`."""
    h, w = rgb.shape[:2]
    rows = torch.clamp(torch.arange(pad_h, device=rgb.device), max=h - 1)
    cols = torch.clamp(torch.arange(pad_w, device=rgb.device), max=w - 1)
    f = rgb[rows][:, cols].double()
    y = _q(_channel(f, 0))
    out = [y]
    for d in (1, 2):
        c = _channel(f, d)
        s = ((c[0::2, 0::2] + c[0::2, 1::2]) + c[1::2, 0::2]) + c[1::2, 1::2]
        out.append(_q(s / 4))
    return tuple(out)


def _check(rgbs, pad_h, pad_w):
    if rgbs.dtype != torch.uint8 or rgbs.dim() != 4 or rgbs.shape[3] != 3 \
            or not rgbs.shape[0]:
        raise ValueError("rgb must be (H, W, 3) uint8, a chunk (K, H, W, 3) "
                         "with K >= 1")
    h, w = rgbs.shape[1:3]
    if pad_h % 16 or pad_w % 16 or pad_h < h or pad_w < w or not (h and w):
        raise ValueError(f"padding ({pad_h}, {pad_w}) must be MB multiples "
                         f"covering the frame ({h}, {w})")
    if not rgbs.is_contiguous():
        raise ValueError("rgb must be contiguous")


def rgb_to_yuv420(rgb: torch.Tensor, pad_h: int, pad_w: int):
    """(H, W, 3) uint8 RGB -> (y (pad_h, pad_w), cb, cr (pad_h/2,
    pad_w/2)) uint8 planes, edge-padded to MB multiples.  Any H and W,
    odd ones too: :func:`rgb_to_yuv420_frames` of a one-frame chunk."""
    if rgb.dim() != 3:
        raise ValueError("rgb must be an (H, W, 3) uint8 tensor")
    y, cb, cr = rgb_to_yuv420_frames(rgb.unsqueeze(0), pad_h, pad_w)
    return y[0], cb[0], cr[0]


def rgb_to_yuv420_frames_plain(rgbs: torch.Tensor, pad_h: int, pad_w: int):
    """Plain PyTorch version of K9: the frames one by one."""
    planes = [rgb_to_yuv420_plain(f, pad_h, pad_w) for f in rgbs]
    return tuple(torch.stack([p[i] for p in planes]) for i in range(3))


def rgb_to_yuv420_frames(rgbs: torch.Tensor, pad_h: int, pad_w: int):
    """(K, H, W, 3) uint8 RGB frames -> (ys (K, pad_h, pad_w), cbs, crs
    (K, pad_h/2, pad_w/2)).

    A CUDA tensor launches the kernel once for all K frames (one thread
    per 2x2 output quad: four luma samples and one chroma sample of each
    plane; grid.z = K); a CPU tensor runs the plain version."""
    _check(rgbs, pad_h, pad_w)
    if rgbs.device.type == "cpu":
        return rgb_to_yuv420_frames_plain(rgbs, pad_h, pad_w)
    k, dev = rgbs.shape[0], rgbs.device
    ys = torch.empty((k, pad_h, pad_w), dtype=torch.uint8, device=dev)
    cbs = torch.empty((k, pad_h // 2, pad_w // 2), dtype=torch.uint8,
                      device=dev)
    crs = torch.empty_like(cbs)
    _cuda.launch("color", "rgb_to_yuv420_launch", [rgbs, ys, cbs, crs],
                 [k, rgbs.shape[1], rgbs.shape[2], pad_h, pad_w]
                 + _MATRIX_BITS, dev)
    rgb_to_yuv420_frames.launches += 1
    return ys, cbs, crs


rgb_to_yuv420_frames.launches = 0
