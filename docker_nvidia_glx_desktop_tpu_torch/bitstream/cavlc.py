"""CAVLC residual coding (ITU-T H.264 §9.2) — pure-Python reference.

This is the entropy half of the ``nvh264enc`` replacement (reference
Dockerfile:210): NVENC's silicon CAVLC stage re-implemented first-party.
The native C++ fast path (``native/cavlc.cpp``) must produce byte-identical
output; tests enforce that.  Tables below are transcribed from the spec
(Tables 9-5, 9-7, 9-8, 9-9(a), 9-10); `_check_prefix_free` validates each
is a well-formed prefix code at import time so a transcription slip fails
loudly rather than emitting broken streams.
"""

from __future__ import annotations

from .bitwriter import BitWriter

# ---------------------------------------------------------------------------
# Table 9-5: coeff_token.  Layout: [nC-class][4*TotalCoeff + TrailingOnes]
# -> (length, bits).  Classes: 0: 0<=nC<2, 1: 2<=nC<4, 2: 4<=nC<8,
# 3: nC>=8 (6-bit FLC, generated), 4: nC==-1 (chroma DC).
# ---------------------------------------------------------------------------

_CT_LEN = [
    # 0 <= nC < 2
    [1, 0, 0, 0,
     6, 2, 0, 0,
     8, 6, 3, 0,
     9, 8, 7, 5,
     10, 9, 8, 6,
     11, 10, 9, 7,
     13, 11, 10, 8,
     13, 13, 11, 9,
     13, 13, 13, 10,
     14, 14, 13, 11,
     14, 14, 14, 13,
     15, 15, 14, 14,
     15, 15, 15, 14,
     16, 15, 15, 15,
     16, 16, 16, 15,
     16, 16, 16, 16,
     16, 16, 16, 16],
    # 2 <= nC < 4
    [2, 0, 0, 0,
     6, 2, 0, 0,
     6, 5, 3, 0,
     7, 6, 6, 4,
     8, 6, 6, 4,
     8, 7, 7, 5,
     9, 8, 8, 6,
     11, 9, 9, 6,
     11, 11, 11, 7,
     12, 11, 11, 9,
     12, 12, 12, 11,
     12, 12, 12, 11,
     13, 13, 13, 12,
     13, 13, 13, 13,
     13, 14, 13, 13,
     14, 14, 14, 13,
     14, 14, 14, 14],
    # 4 <= nC < 8
    [4, 0, 0, 0,
     6, 4, 0, 0,
     6, 5, 4, 0,
     6, 5, 5, 4,
     7, 5, 5, 4,
     7, 5, 5, 4,
     7, 6, 6, 4,
     7, 6, 6, 4,
     8, 7, 7, 5,
     8, 8, 7, 6,
     9, 8, 8, 7,
     9, 9, 8, 8,
     9, 9, 9, 8,
     10, 9, 9, 9,
     10, 10, 10, 10,
     10, 10, 10, 10,
     10, 10, 10, 10],
]

_CT_BITS = [
    [1, 0, 0, 0,
     5, 1, 0, 0,
     7, 4, 1, 0,
     7, 6, 5, 3,
     7, 6, 5, 3,
     7, 6, 5, 4,
     15, 6, 5, 4,
     11, 14, 5, 4,
     8, 10, 13, 4,
     15, 14, 9, 4,
     11, 10, 13, 12,
     15, 14, 9, 12,
     11, 10, 13, 8,
     15, 1, 9, 12,
     11, 14, 13, 8,
     7, 10, 9, 12,
     4, 6, 5, 8],
    [3, 0, 0, 0,
     11, 2, 0, 0,
     7, 7, 3, 0,
     7, 10, 9, 5,
     7, 6, 5, 4,
     4, 6, 5, 6,
     7, 6, 5, 8,
     15, 6, 5, 4,
     11, 14, 13, 4,
     15, 10, 9, 4,
     11, 14, 13, 12,
     8, 10, 9, 8,
     15, 14, 13, 12,
     11, 10, 9, 12,
     7, 11, 6, 8,
     9, 8, 10, 1,
     7, 6, 5, 4],
    [15, 0, 0, 0,
     15, 14, 0, 0,
     11, 15, 13, 0,
     8, 12, 14, 12,
     15, 10, 11, 11,
     11, 8, 9, 10,
     9, 14, 13, 9,
     8, 10, 9, 8,
     15, 14, 13, 13,
     11, 14, 10, 12,
     15, 10, 13, 12,
     11, 14, 9, 12,
     8, 10, 13, 8,
     13, 7, 9, 12,
     9, 12, 11, 10,
     5, 8, 7, 6,
     1, 4, 3, 2],
]

# nC == -1 (chroma DC 2x2, Table 9-5 rightmost column)
_CT_LEN_CDC = [2, 0, 0, 0,
               6, 1, 0, 0,
               6, 6, 3, 0,
               6, 7, 7, 6,
               6, 8, 8, 7]
_CT_BITS_CDC = [1, 0, 0, 0,
                7, 1, 0, 0,
                4, 6, 1, 0,
                3, 3, 2, 5,
                2, 3, 2, 0]


def _ct_flc(tc: int, t1: int) -> tuple[int, int]:
    """nC >= 8: 6-bit fixed-length coeff_token."""
    if tc == 0:
        return 6, 3
    return 6, ((tc - 1) << 2) | t1


# ---------------------------------------------------------------------------
# Tables 9-7/9-8: total_zeros for 4x4 blocks, indexed [TotalCoeff-1][tz]
# ---------------------------------------------------------------------------

_TZ_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]

_TZ_BITS = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]

# Table 9-9(a): total_zeros for chroma DC (maxNumCoeff 4), [TC-1][tz]
_TZ_LEN_CDC = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
_TZ_BITS_CDC = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]

# Table 9-10: run_before, indexed [min(zerosLeft,7)-1][run]
_RB_LEN = [
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
_RB_BITS = [
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]


def _check_prefix_free() -> None:
    """Import-time sanity: every table is a prefix-free code."""
    def check(pairs, what):
        codes = [(ln, bits) for ln, bits in pairs if ln > 0]
        seen = set()
        for ln, bits in codes:
            assert bits < (1 << ln), (what, ln, bits)
            seen.add((ln, bits))
        assert len(seen) == len(codes), f"{what}: duplicate codes"
        for ln_a, b_a in codes:
            for ln_b, b_b in codes:
                if ln_a < ln_b and (b_b >> (ln_b - ln_a)) == b_a:
                    raise AssertionError(f"{what}: prefix violation")

    for cls in range(3):
        pairs = []
        for tc in range(17):
            for t1 in range(min(tc, 3) + 1):
                pairs.append((_CT_LEN[cls][4 * tc + t1],
                              _CT_BITS[cls][4 * tc + t1]))
        check(pairs, f"coeff_token[{cls}]")
    pairs = [(_CT_LEN_CDC[4 * tc + t1], _CT_BITS_CDC[4 * tc + t1])
             for tc in range(5) for t1 in range(min(tc, 3) + 1)]
    check(pairs, "coeff_token[chromaDC]")
    for i, (lens, bits) in enumerate(zip(_TZ_LEN, _TZ_BITS)):
        check(list(zip(lens, bits)), f"total_zeros[{i}]")
    for i, (lens, bits) in enumerate(zip(_TZ_LEN_CDC, _TZ_BITS_CDC)):
        check(list(zip(lens, bits)), f"total_zeros_cdc[{i}]")
    for i, (lens, bits) in enumerate(zip(_RB_LEN, _RB_BITS)):
        check(list(zip(lens, bits)), f"run_before[{i}]")


_check_prefix_free()


# ---------------------------------------------------------------------------
# Block encoder
# ---------------------------------------------------------------------------

def encode_block(bw: BitWriter, levels, nc: int, max_coeff: int) -> int:
    """CAVLC-code one residual block (levels in scan order, length
    ``max_coeff``).  ``nc``: context from neighbor totals, or -1 for chroma
    DC.  Returns TotalCoeff (the caller records it for neighbor nC).
    """
    nz = [(i, int(v)) for i, v in enumerate(levels) if v]
    total = len(nz)
    # trailing ones: up to 3 final +-1s in scan order
    t1 = 0
    while t1 < 3 and t1 < total and abs(nz[total - 1 - t1][1]) == 1:
        t1 += 1

    if nc == -1:
        ln, bits = _CT_LEN_CDC[4 * total + t1], _CT_BITS_CDC[4 * total + t1]
    elif nc >= 8:
        ln, bits = _ct_flc(total, t1)
    else:
        cls = 0 if nc < 2 else (1 if nc < 4 else 2)
        ln, bits = _CT_LEN[cls][4 * total + t1], _CT_BITS[cls][4 * total + t1]
    assert ln > 0, (total, t1, nc)
    bw.write(bits, ln)
    if total == 0:
        return 0

    # trailing-one signs, highest frequency first
    for k in range(t1):
        bw.write(1 if nz[total - 1 - k][1] < 0 else 0, 1)

    # remaining levels, highest frequency first
    suffix_len = 1 if total > 10 and t1 < 3 else 0
    first = True
    for k in range(total - 1 - t1, -1, -1):
        level = nz[k][1]
        code = 2 * level - 2 if level > 0 else -2 * level - 1
        if first and t1 < 3:
            code -= 2      # first non-T1 level cannot be +-1
        first = False
        _write_level(bw, code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    tz = nz[total - 1][0] + 1 - total
    if total < max_coeff:
        if nc == -1:
            bw.write(_TZ_BITS_CDC[total - 1][tz], _TZ_LEN_CDC[total - 1][tz])
        else:
            bw.write(_TZ_BITS[total - 1][tz], _TZ_LEN[total - 1][tz])

    # run_before, highest frequency first; last coded coeff's run implied
    zeros_left = tz
    for k in range(total - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[k][0] - nz[k - 1][0] - 1
        row = _RB_LEN[min(zeros_left, 7) - 1]
        bw.write(_RB_BITS[min(zeros_left, 7) - 1][run], row[run])
        zeros_left -= run
    return total


def _write_level(bw: BitWriter, code: int, suffix_len: int) -> None:
    """level_prefix / level_suffix per §9.2.2.1, including the
    level_prefix >= 16 escape extension for arbitrarily large levels."""
    if suffix_len == 0:
        if code < 14:
            bw.write(1, code + 1)            # code zeros then a 1
            return
        if code < 30:
            bw.write(1, 15)                  # prefix 14, 4-bit suffix
            bw.write(code - 14, 4)
            return
        extra = 15                           # levelCode += 15 when sl == 0
    else:
        prefix = code >> suffix_len
        if prefix < 15:
            bw.write(1, prefix + 1)
            bw.write(code & ((1 << suffix_len) - 1), suffix_len)
            return
        extra = 0
    if code < (15 << suffix_len) + extra + 4096:
        bw.write(1, 16)                      # prefix 15, 12-bit suffix
        bw.write(code - (15 << suffix_len) - extra, 12)
        return
    p = 16                                   # prefix >= 16: suffix p-3 bits,
    while True:                              # levelCode += (1<<(p-3)) - 4096
        base = (15 << suffix_len) + extra + (1 << (p - 3)) - 4096
        if code < base + (1 << (p - 3)):
            bw.write(1, p + 1)
            bw.write(code - base, p - 3)
            return
        p += 1


def nc_from_neighbors(na: int | None, nb: int | None) -> int:
    """§9.2.1: context from left (na) / above (nb) block coefficient counts;
    None = neighbor unavailable."""
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    if na is not None:
        return na
    if nb is not None:
        return nb
    return 0
