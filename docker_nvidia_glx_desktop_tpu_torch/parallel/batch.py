"""The MJPEG session batch on one card.

The port of the reference's ``parallel/batch.py`` MJPEG step
(``_session_transform``, ``batch_encode_step``, ``assemble_session_jpeg``).
There, sessions and restart strips are the axes of a device mesh; on one
card they are grid axes of the same three kernels as the single encoder
(``ops/jpeg_device``: K16a over S frames, K16b and K16c over S sessions
of ``spatial`` strips each).  Each strip starts its DC predictors at 0 and
packs into its own buffer, exactly JPEG's restart-interval contract, so a
session's JPEG is its strips joined with RSTn markers; the strips'
histograms are summed per session (the reference's psum over its spatial
axis), so every strip of a session packs with one set of tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.h264 import resolve_device
from ..models.mjpeg import headers
from ..ops import bitpack, jpeg_device, quant


class BatchStep:
    """``step(frames, *tables) -> (packed, totals, hists)`` for S frames
    of one geometry; ``transform`` and ``entropy`` are its two halves."""

    def __init__(self, frame_h: int, frame_w: int, quality: int, spatial: int,
                 device):
        self.frame_h, self.frame_w, self.spatial = frame_h, frame_w, spatial
        self.device = device
        self.luma_q, self.chroma_q = quant.jpeg_quality_tables(quality)

    def transform(self, frames):
        """(S, H, W, 3) uint8 frames -> levels (``ops/jpeg_device``
        layout): K16a over the session axis (the reference's vmapped
        ``_session_transform``; its strips are whole MCU rows, so one
        transform of the frame gives every strip's levels)."""
        t = torch.as_tensor(np.ascontiguousarray(frames, np.uint8)) \
            if not isinstance(frames, torch.Tensor) else frames
        t = t.to(self.device).contiguous()
        if tuple(t.shape[1:]) != (self.frame_h, self.frame_w, 3):
            raise ValueError(f"frames {tuple(t.shape)} are not "
                             f"(S, {self.frame_h}, {self.frame_w}, 3)")
        return jpeg_device.jpeg_transform(t, self.luma_q, self.chroma_q,
                                          self.frame_h, self.frame_w)

    def entropy(self, y, cb, cr, *tables):
        """Given levels and the 8 dense table arrays: (packed (S, nx,
        bytes) uint8, totals (S, nx) int32, histograms (dc_y, ac_y, dc_c,
        ac_c), each (S, n), summed over a session's strips)."""
        tab = jpeg_device.table_tensor(tables, self.device)
        hist = jpeg_device.jpeg_analyze(y, cb, cr, self.spatial)
        packed, totals = jpeg_device.jpeg_pack(y, cb, cr, tab, self.spatial)
        return packed, totals, jpeg_device.split_hists(hist)

    def __call__(self, frames, *tables):
        return self.entropy(*self.transform(frames), *tables)


def batch_encode_step(frame_h: int, frame_w: int, quality: int = 85,
                      spatial: int = 1, device=None) -> BatchStep:
    """The multi-session MJPEG step on one card (the card by default;
    ``"cpu"`` runs the plain versions).

    Returns step(frames, *tables) -> (packed, totals, hists): frames
    (S, H, W, 3) uint8; tables the 8 dense arrays of
    ``ops/jpeg_device.dense_tables``; packed (S, spatial, bytes) with
    each strip's first ``ceil(totals / 8)`` bytes meaningful."""
    if frame_h % (16 * spatial):
        raise ValueError("frame height must split into MCU rows")
    if frame_w % 16:
        raise ValueError("frame width must be a multiple of 16")
    return BatchStep(frame_h, frame_w, quality, spatial,
                     resolve_device(device))


def assemble_session_jpeg(packed_shards, totals, tables, width: int,
                          height: int, quality: int = 85) -> bytes:
    """One session's JPEG from its strips: each strip 1-padded to a byte
    and 0xFF-stuffed, joined with RST0..RST7 markers (cycling) under a
    DRI of one strip's MCUs."""
    nx = len(packed_shards)
    restart_interval = (width // 16) * ((height // 16) // nx) if nx > 1 else 0
    luma_q, chroma_q = quant.jpeg_quality_tables(quality)
    parts = [headers(width, height, luma_q, chroma_q, tables,
                     restart_interval)]
    for i, (shard, nbits) in enumerate(zip(packed_shards, totals)):
        scan = bitpack.finalize_bytes(shard, int(nbits), pad_bit=1)
        parts.append(bitpack.jpeg_stuff_bytes(scan))
        if i < nx - 1:
            parts.append(bytes([0xFF, 0xD0 + (i % 8)]))
    parts.append(b"\xff\xd9")
    return b"".join(parts)
