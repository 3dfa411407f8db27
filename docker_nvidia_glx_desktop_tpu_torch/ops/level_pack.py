"""Level transport of the CABAC path (K10): a frame's quantized level
tensors -> one compact uint32 buffer, pulled to the host and decoded
there for the native CABAC coder.

Replaces the reference's ``ops/level_pack.py`` ``pack_levels`` (its body
``_pack``).  Each MB's level slots, in the wire order of ``INTRA_KEYS``
or ``P_KEYS``, code as

  zero       -> 1 bit "0"
  nonzero    -> "1" + the 15-bit two's complement of the value

MSB-first inside each word; an MB row is one bit string (the MBs back to
back), starting on a word boundary.  Values outside -16384..16383 set
the overflow flag (the caller then pulls the dense tensors).

Transport layout (uint32 words, version 1):
  [0] version (1)   [1] value-overflow flag   [2] total payload words
  [3] rows R        [4] slots per MB          [5..7] reserved (0)
  [META_WORDS .. META_WORDS+R)   per-row payload word counts
  [META_WORDS+R ..)              row payloads, each word-aligned

The header and the payload equal the reference's word for word (the
buffer's length is the largest payload the shapes allow, not the
reference's).  The plain version zeroes the words past the payload; the
kernel leaves them as they were.  Every consumer reads the header and
the payload only: ``models/h264.py``'s prefix pull (``_pull_transport``
takes the header's total), :func:`unpack_levels` (slices the payload by
the row word counts) and the native level decoder (given that payload).

Only the output words carry over, not the TPU's bitmerge trees: the
kernel (``csrc/levelpack.cu``) is one launch after a memset of a small
look-back state, a CTA a segment of a row's MBs with their levels staged
once, a warp an MB counting its bits by ballots, a look-back over the
row's earlier segments, then each nonzero slot's code ORed into a shared
window of the segment's words and stored.  :func:`pack_levels` launches
it for CUDA tensors and runs :func:`pack_slots_plain` for CPU tensors.
The host decodes with the port's native decoder
(``native/levelpack.cpp``) or, with ``use_native=False``, a NumPy loop.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda

__all__ = ["META_WORDS", "INTRA_KEYS", "P_KEYS", "pack_levels",
           "pack_slots_plain", "mb_slots", "buffer_words", "header_words",
           "payload_words", "unpack_levels", "place_bits", "to_words"]

META_WORDS = 8

# Per-MB slot layout: (key, slots, final dense shape per MB).  The order
# is the wire contract between the device packer and the host decoder.
INTRA_KEYS = (
    ("luma_dc", 16, (16,)),
    ("luma_ac", 240, (16, 15)),
    ("cb_dc", 4, (4,)),
    ("cb_ac", 60, (4, 15)),
    ("cr_dc", 4, (4,)),
    ("cr_ac", 60, (4, 15)),
    ("luma_i4", 256, (16, 16)),
)
P_KEYS = (
    ("luma", 256, (16, 16)),
    ("cb_dc", 4, (4,)),
    ("cb_ac", 60, (4, 15)),
    ("cr_dc", 4, (4,)),
    ("cr_ac", 60, (4, 15)),
)
_MAX_KEYS = 7


def mb_slots(levels: dict, keys) -> torch.Tensor:
    """(R, C, S) int32 slot matrix in wire order."""
    r, c = levels[keys[0][0]].shape[:2]
    return torch.cat([levels[k].reshape(r, c, -1).to(torch.int32)
                      for k, _, _ in keys], dim=-1)


def place_bits(vals: torch.Tensor, lens: torch.Tensor,
               word_off: torch.Tensor, n_words: int) -> torch.Tensor:
    """OR variable-length codes into MSB-first words.

    vals/lens (R, N) int64 (each code at most 32 bits; bits of a value
    above its length are dropped), one row's codes back to back starting
    at word ``word_off[r]``.  Returns (n_words,) int64 words < 2^32.
    OR equals ADD: the codes of a row never share a bit."""
    vals = vals & ((1 << lens) - 1)
    pos = lens.cumsum(dim=1) - lens + 32 * word_off[:, None]
    live = lens > 0
    pos, lens, vals = pos[live], lens[live], vals[live]
    w = pos >> 5
    end = (pos & 31) + lens
    hi = torch.where(end > 32, vals >> (end - 32).clamp(min=0),
                     (vals << (32 - end).clamp(min=0)) & 0xFFFFFFFF)
    lo = torch.where(end > 32,
                     (vals << (64 - end).clamp(max=63)) & 0xFFFFFFFF, 0)
    words = torch.zeros(n_words + 1, dtype=torch.int64, device=vals.device)
    words.index_add_(0, w, hi)
    words.index_add_(0, w + 1, lo)
    return words[:n_words]


def to_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> the same bit patterns as int32."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def buffer_words(rows: int, cols: int, slots: int) -> int:
    """Length of the transport buffer: header + the largest payload
    (every slot nonzero: 16 bits)."""
    return META_WORDS + rows + rows * cols * slots // 2


def pack_slots_plain(slots3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10 over an (R, C, S) int32 slot matrix:
    the transport buffer as int32 words (the uint32 bit patterns)."""
    r, c, s = slots3.shape
    v = slots3.long()
    nz = v != 0
    overflow = bool(((v > 16383) | (v < -16384)).any())
    vals = torch.where(nz, (1 << 15) | (v & 0x7FFF), 0).reshape(r, -1)
    lens = torch.where(nz, 16, 1).reshape(r, -1)
    row_bits = lens.sum(dim=1)
    row_words = (row_bits + 31) >> 5
    word_off = row_words.cumsum(dim=0) - row_words
    n = buffer_words(r, c, s)
    hdr = torch.zeros(META_WORDS + r, dtype=torch.int64, device=v.device)
    hdr[0], hdr[1], hdr[2], hdr[3], hdr[4] = 1, int(overflow), \
        row_words.sum(), r, s
    hdr[META_WORDS:] = row_words
    payload = place_bits(vals, lens, word_off, n - META_WORDS - r)
    return to_words(torch.cat([hdr, payload]))


@functools.lru_cache(maxsize=None)
def _kernel_buffer_words(rows: int, cols: int, slots: int) -> int:
    """int32 words of K10's one buffer, as ``csrc/levelpack.cu``'s
    ``level_pack_buffer_words`` lays it out: the transport
    (:func:`buffer_words`), then the look-back state (the launch zeroes
    only the state)."""
    fn = _cuda.library("levelpack").level_pack_buffer_words
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return int(fn(buffer_words(rows, cols, slots), rows, cols))


def pack_levels(levels: dict, keys) -> torch.Tensor:
    """Compact the level tensors named by ``keys`` (INTRA_KEYS/P_KEYS)
    into one transport buffer: a 1-D int32 tensor holding the uint32
    words (``buffer_words`` long; from the kernel, the words past the
    payload are unspecified).  No host sync.

    CUDA tensors launch the kernel (a CTA a segment of a row's MBs, a
    warp an MB, placed by a look-back over the row's earlier segments);
    CPU tensors run the plain version."""
    ts = [levels[k] for k, _, _ in keys]
    r, c = ts[0].shape[:2]
    dev = ts[0].device
    for (k, n, shape), t in zip(keys, ts):
        if (tuple(t.shape) != (r, c) + shape or t.dtype != torch.int32
                or t.device != dev):
            raise ValueError(f"{k}: want {(r, c) + shape} int32 on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if dev.type == "cpu":
        return pack_slots_plain(mb_slots(levels, keys))
    s = sum(n for _, n, _ in keys)
    buf = torch.empty(_kernel_buffer_words(r, c, s), dtype=torch.int32,
                      device=dev)
    ptrs = ts + [None] * (_MAX_KEYS - len(ts))
    counts = [n for _, n, _ in keys] + [0] * (_MAX_KEYS - len(ts))
    _cuda.launch("levelpack", "level_pack_launch", ptrs + [buf],
                 [r, c] + counts, dev)
    pack_levels.launches += 1
    return buf[:buffer_words(r, c, s)]


pack_levels.launches = 0


def header_words(rows: int) -> int:
    return META_WORDS + rows


def payload_words(head: np.ndarray) -> int:
    """Total payload words, from a pulled header prefix."""
    return int(head[2])


# ---------------------------------------------------------------------------
# Host-side decode
# ---------------------------------------------------------------------------

def _unpack_rows_numpy(payload: np.ndarray, row_off: np.ndarray,
                       rows: int, slots_row: int) -> np.ndarray:
    """Row-wise bit decode without the native library (tests)."""
    out = np.zeros(rows * slots_row, np.int32)
    for r in range(rows):
        w = payload[row_off[r]:row_off[r + 1]]
        if w.size == 0:
            continue
        bits = np.unpackbits(
            np.ascontiguousarray(w.astype(">u4")).view(np.uint8))
        pos = 0
        base = r * slots_row
        for s in range(slots_row):
            if bits[pos]:
                raw = 0
                for b in bits[pos + 1:pos + 16]:
                    raw = (raw << 1) | int(b)
                out[base + s] = raw - (raw >> 14) * (1 << 15)
                pos += 16
            else:
                pos += 1
    return out


def unpack_levels(buf: np.ndarray, rows: int, cols: int, keys,
                  use_native: bool = True):
    """Expand a transport buffer (host uint32 array covering header +
    payload) back into the dense per-tensor arrays, or None on value
    overflow.  ``use_native=False`` decodes with NumPy."""
    buf = np.asarray(buf).view(np.uint32)
    head = buf[:META_WORDS + rows]
    assert int(head[0]) == 1, "level_pack version mismatch"
    if int(head[1]):
        return None
    slots_row = cols * int(head[4])
    row_words = head[META_WORDS:META_WORDS + rows].astype(np.int64)
    row_off = np.zeros(rows + 1, np.int64)
    np.cumsum(row_words, out=row_off[1:])
    payload = np.ascontiguousarray(
        buf[META_WORDS + rows:META_WORDS + rows + int(row_off[-1])],
        dtype=np.uint32)
    if use_native:
        from ..native import lib as native_lib
        dense = native_lib.level_unpack(payload, row_off, rows, slots_row)
    else:
        dense = _unpack_rows_numpy(payload, row_off, rows, slots_row)
    dense = dense.reshape(rows, cols, int(head[4]))
    out, off = {}, 0
    for k, n, shape in keys:
        out[k] = np.ascontiguousarray(
            dense[:, :, off:off + n]).reshape((rows, cols) + shape)
        off += n
    return out
