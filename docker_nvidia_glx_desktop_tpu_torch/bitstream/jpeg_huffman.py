"""Per-frame optimal JPEG Huffman tables + baseline entropy encoding
(host code, a copy of the reference's ``bitstream/jpeg_huffman.py``).

Instead of hardcoding the T.81 Annex-K example tables, each frame gets
canonical Huffman codes built from its own symbol histogram (T.81 Annex K.2
procedure: Huffman growth, 16-bit depth adjustment, reserved all-ones code).
The DHT segment then self-describes the exact codes used — better compression
than the example tables and no table-transcription risk.

The symbol alphabets are the standard baseline ones:
- DC: SIZE category 0..11 of the DC difference.
- AC: RRRRSSSS = (zero-run << 4) | size, plus EOB (0x00) and ZRL (0xF0).
"""

from __future__ import annotations

import numpy as np

from .bitwriter import BitWriter


# ---------------------------------------------------------------------------
# Canonical code construction (T.81 Annex K.2)
# ---------------------------------------------------------------------------

def build_code_lengths(freqs: np.ndarray, max_len: int = 16) -> np.ndarray:
    """Return per-symbol code lengths for the given frequencies.

    Implements the JPEG reference procedure: pairwise merge of the two least
    frequent "packages" tracked via CODESIZE/OTHERS, then Adjust_BITS to cap
    lengths at ``max_len``.  A reserved pseudo-symbol with frequency 1 is
    appended so no real symbol is assigned the all-ones code.
    """
    n = len(freqs)
    freq = np.zeros(n + 1, dtype=np.int64)
    freq[:n] = freqs
    freq[n] = 1  # reserved symbol, gets the longest code
    codesize = np.zeros(n + 1, dtype=np.int64)
    others = np.full(n + 1, -1, dtype=np.int64)

    while True:
        present = np.where(freq > 0)[0]
        if len(present) <= 1:
            break
        # v1: least-frequent (highest index breaks ties per spec)
        fmin = freq[present].min()
        v1 = present[freq[present] == fmin].max()
        rest = present[present != v1]
        fmin2 = freq[rest].min()
        v2 = rest[freq[rest] == fmin2].max()

        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1

    # BITS[l] = number of codes of length l
    bits = np.zeros(max(33, codesize.max() + 1), dtype=np.int64)
    for size in codesize:
        if size > 0:
            bits[size] += 1

    # Adjust_BITS: fold lengths > max_len down (spec figure K.3)
    i = len(bits) - 1
    while i > max_len:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    # Remove the reserved symbol's code (the longest one)
    i = max_len
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1

    # Sort symbols by (codesize, symbol) -> canonical order, assign lengths
    real_sizes = codesize[:n]
    order = np.argsort(real_sizes * 4096 + np.arange(n))  # stable by size then index
    order = order[real_sizes[order] > 0]

    lengths = np.zeros(n, dtype=np.int32)
    li = 1
    counts = bits.copy()
    for sym in order:
        while counts[li] == 0:
            li += 1
        lengths[sym] = li
        counts[li] -= 1
    return lengths


def canonical_codes(lengths: np.ndarray):
    """(code, length) per symbol from canonical lengths (shorter first,
    then smaller symbol value).  Returns (codes, lengths, bits, huffval):
    ``bits``/``huffval`` are the DHT wire form.
    """
    n = len(lengths)
    syms = [s for s in range(n) if lengths[s] > 0]
    syms.sort(key=lambda s: (lengths[s], s))
    codes = np.zeros(n, dtype=np.int64)
    code = 0
    prev_len = 0
    bits = np.zeros(17, dtype=np.int64)
    huffval = []
    for s in syms:
        code <<= (lengths[s] - prev_len)
        codes[s] = code
        code += 1
        prev_len = lengths[s]
        bits[lengths[s]] += 1
        huffval.append(s)
    return codes, lengths, bits[1:17], np.array(huffval, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Symbol extraction (vectorized where possible)
# ---------------------------------------------------------------------------

def block_symbols(zz: np.ndarray, prev_dc: int):
    """Extract the Huffman symbols of one zigzagged block.

    zz: int array of 64 coefficients in zigzag order.
    Returns (dc_entry, ac_entries, new_prev_dc) where entries carry
    (symbol, amplitude_bits_value, nbits).  This is the single source of
    truth for symbol extraction — histogramming and emission both consume
    its output, so tables and scan can never disagree.
    """
    diff = int(zz[0]) - prev_dc
    dc_size = abs(diff).bit_length()
    amp = diff if diff >= 0 else diff + (1 << dc_size) - 1
    dc_entry = (dc_size, amp, dc_size)

    ac_entries = []
    nz_idx = np.nonzero(zz[1:])[0]
    prev = -1
    for idx in nz_idx:
        run = int(idx) - prev - 1
        while run >= 16:
            ac_entries.append((0xF0, 0, 0))  # ZRL
            run -= 16
        v = int(zz[idx + 1])
        size = abs(v).bit_length()
        a = v if v >= 0 else v + (1 << size) - 1
        ac_entries.append(((run << 4) | size, a, size))
        prev = int(idx)
    if prev < 62:
        ac_entries.append((0x00, 0, 0))  # EOB
    return dc_entry, ac_entries, int(zz[0])


def frame_symbols(blocks_per_comp, comp_table_ids):
    """Run :func:`block_symbols` over every block of every component.

    blocks_per_comp: list of (nblk, 64) int arrays in per-component scan
    order.  Returns (symbols_per_comp, dc_hist, ac_hist): the symbol lists
    to emit, and their histograms per table id (0 luma / 1 chroma).
    """
    dc_hist = [np.zeros(17, dtype=np.int64) for _ in range(2)]
    ac_hist = [np.zeros(256, dtype=np.int64) for _ in range(2)]
    symbols_per_comp = []
    for comp, tid in zip(blocks_per_comp, comp_table_ids):
        zz = np.asarray(comp)
        prev_dc = 0
        entries = []
        for b in range(zz.shape[0]):
            dc_entry, ac_entries, prev_dc = block_symbols(zz[b], prev_dc)
            entries.append((dc_entry, ac_entries))
            dc_hist[tid][dc_entry[0]] += 1
            for sym, _, _ in ac_entries:
                ac_hist[tid][sym] += 1
        symbols_per_comp.append(entries)
    return symbols_per_comp, dc_hist, ac_hist


class HuffmanTable:
    """Encode-side Huffman table with DHT wire form."""

    def __init__(self, freqs: np.ndarray):
        freqs = np.asarray(freqs, dtype=np.int64).copy()
        if freqs.sum() == 0:
            freqs[0] = 1  # degenerate: ensure at least one code exists
        lengths = build_code_lengths(freqs)
        self.codes, self.lengths, self.bits, self.huffval = canonical_codes(lengths)

    @classmethod
    def from_fields(cls, codes, lengths, bits, huffval) -> "HuffmanTable":
        """A table from its arrays (``codes``, ``lengths``, ``bits``,
        ``huffval``), as another encoder's exported state carries them:
        no code is rebuilt."""
        t = cls.__new__(cls)
        t.codes = np.asarray(codes, dtype=np.int64).copy()
        t.lengths = np.asarray(lengths, dtype=np.int32).copy()
        t.bits = np.asarray(bits, dtype=np.int64).copy()
        t.huffval = np.asarray(huffval, dtype=np.uint8).copy()
        return t

    def emit(self, bw: BitWriter, symbol: int) -> None:
        bw.write(int(self.codes[symbol]), int(self.lengths[symbol]))

    def dht_payload(self, table_class: int, table_id: int) -> bytes:
        out = bytearray([(table_class << 4) | table_id])
        out += bytes(int(b) for b in self.bits)
        out += bytes(self.huffval.tolist())
        return bytes(out)
