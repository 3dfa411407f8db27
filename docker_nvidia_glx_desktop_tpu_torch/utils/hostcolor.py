"""Host-side RGB -> BT.601 studio-range YUV 4:2:0 (the capture path).

One implementation shared by every encoder's host-color path (H.264, VP8)
so the conversion cannot drift between codecs.  The capture host may have
a single CPU core, so the formulation is chosen for host cost (measured
p50 at 1080p, one core):

- Y from the fused fixed-point SIMD ``cv2.COLOR_RGB2YUV_I420`` call
  (~1.4 ms; matches ops/color ``matrix="video"`` within 1 LSB — the
  call's top-left-picked chroma is discarded),
- chroma from the 2x2-averaged half-res RGB (the color matrix is affine,
  so average-then-transform == transform-then-average within rounding):
  an INTER_AREA resize plus a quarter-size two-row transform, ~3 ms.

The float fallback (no cv2) keeps the same matrix and chroma siting.
"""

from __future__ import annotations

import numpy as np

# BT.601 studio-range chroma rows (Cb, Cr) with offsets — the same matrix
# as ops/color.rgb_to_yuv420(matrix="video").
_CBCR_M = np.array(
    [[-37.797 / 255, -74.203 / 255, 112.0 / 255, 128.0],
     [112.0 / 255, -93.786 / 255, -18.214 / 255, 128.0]], np.float64)

_Y_M = np.array([65.481 / 255, 128.553 / 255, 24.966 / 255], np.float64)


def rgb_to_yuv420_host(rgb: np.ndarray, pad_h: int, pad_w: int,
                       float_fallback: bool = True):
    """(H, W, 3) uint8 RGB -> (y, cb, cr) uint8 planes, edge-padded to
    (pad_h, pad_w).  H and W must be even (callers gate).

    With ``float_fallback=False``, returns None when cv2 is unavailable —
    for callers whose device-side conversion beats a host float path."""
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    try:
        import cv2
    except Exception:
        cv2 = None
    if cv2 is not None:
        # runtime cv2 errors propagate loudly — only a MISSING cv2 selects
        # a fallback (a transient error must not silently flip the whole
        # process to a different conversion path)
        y = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)[:h]
        half = cv2.resize(rgb, (w // 2, h // 2),
                          interpolation=cv2.INTER_AREA)
        cbcr = cv2.transform(half, _CBCR_M)
        u, v = cbcr[..., 0], cbcr[..., 1]
    else:
        if not float_fallback:
            return None
        f = rgb.astype(np.float64)
        y = np.clip(np.round(f @ _Y_M + 16.0), 0, 255).astype(np.uint8)
        hf = f.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
        cbcr = hf @ _CBCR_M[:, :3].T + _CBCR_M[:, 3]
        cbcr = np.clip(np.round(cbcr), 0, 255).astype(np.uint8)
        u, v = cbcr[..., 0], cbcr[..., 1]
    if (pad_h, pad_w) != (h, w):
        y = np.pad(y, ((0, pad_h - h), (0, pad_w - w)), mode="edge")
        u = np.pad(u, ((0, (pad_h - h) // 2), (0, (pad_w - w) // 2)),
                   mode="edge")
        v = np.pad(v, ((0, (pad_h - h) // 2), (0, (pad_w - w) // 2)),
                   mode="edge")
    return y, u, v
