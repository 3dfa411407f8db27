"""Variable-length bit packing: the plain version, and the host's last
steps of a packed JPEG scan.

Given the codes, concatenating variable-length codewords is a scan: an
exclusive sum of the code lengths gives every codeword its bit offset,
and because the bit ranges are disjoint, adding into 32-bit words is the
same as OR-ing into them.  :func:`pack_bits` is that, in plain PyTorch
(the plain version of K16c's packing in ``csrc/jpeg.cu``).  Trimming to
the scan's length, padding the last byte and JPEG's byte stuffing stay on
the host (:func:`finalize_bytes`, :func:`jpeg_stuff_bytes`), over the
packed scan only.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bits(values: torch.Tensor, lengths: torch.Tensor, nbytes=None):
    """Concatenate variable-length codewords into a big-endian bit stream.

    values:  (N,) integer tensor: right-aligned bit patterns (the codeword
             in the low ``lengths[i]`` bits; higher bits zero), < 2^32.
    lengths: (N,) integer tensor in [0, 32]; zero-length entries vanish.
    nbytes:  the output's size; default ``4 * (N + 1)``, which always fits.

    Returns (packed (nbytes,) uint8, MSB-first, zero past the last bit;
    total_bits int32 scalar tensor)."""
    v = values.to(torch.int64)
    ln = lengths.to(torch.int64)
    n = v.shape[0]
    nbytes = 4 * (n + 1) if nbytes is None else int(nbytes)
    nwords = nbytes // 4 + 2
    offsets = torch.cumsum(ln, 0) - ln
    total = offsets[-1] + ln[-1] if n else torch.zeros((), dtype=torch.int64)
    w = offsets >> 5
    s = offsets & 31
    end = s + ln
    straddle = end > 32
    hi = torch.where(straddle, v >> (end - 32).clamp(min=0),
                     v << (32 - end).clamp(min=0))
    hi = torch.where(ln > 0, hi, 0)
    lo = torch.where(straddle, (v << (64 - end).clamp(max=31)) & 0xFFFFFFFF, 0)
    words = torch.zeros(nwords, dtype=torch.int64, device=v.device)
    words.index_add_(0, w, hi)
    words.index_add_(0, w + 1, lo)
    by = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                      (words >> 8) & 0xFF, words & 0xFF], dim=-1)
    packed = by.reshape(-1)[:nbytes].to(torch.uint8)
    return packed, total.to(torch.int32)


def finalize_bytes(packed_bytes, total_bits, pad_bit: int = 1) -> bytes:
    """Host side: trim to ``total_bits`` and pad the final partial byte
    with ``pad_bit`` ones.  ``packed_bytes`` may be a tensor (of any
    device: only the prefix is copied) or a numpy array."""
    nbits = int(total_bits)
    nbytes = (nbits + 7) // 8
    head = packed_bytes[:nbytes]
    if isinstance(head, torch.Tensor):
        head = head.cpu().numpy()
    data = np.array(head, dtype=np.uint8, copy=True)
    rem = nbits % 8
    if rem and pad_bit:
        data[-1] |= (1 << (8 - rem)) - 1
    return data.tobytes()


def jpeg_stuff_bytes(data: bytes) -> bytes:
    """Insert 0x00 after every 0xFF (T.81 §B.1.1.5), vectorized on host."""
    arr = np.frombuffer(data, np.uint8)
    pos = np.nonzero(arr == 0xFF)[0]
    if len(pos) == 0:
        return data
    return np.insert(arr, pos + 1, 0).tobytes()
