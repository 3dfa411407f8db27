"""Small shape/alignment helpers shared by ops and kernels."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple of ``multiple``."""
    return cdiv(x, multiple) * multiple


def pad_amount(x: int, multiple: int) -> int:
    """How much padding brings ``x`` to a multiple of ``multiple``."""
    return round_up(x, multiple) - x


def unwrap16(last_ext: int, value16: int) -> int:
    """Nearest extension of a 16-bit wrapping counter to ``last_ext``
    (RTP sequence numbers: SRTP index resolution, RR highest-seq
    mapping, receiver-side reassembly all share this one unwrap)."""
    d = (value16 - last_ext) & 0xFFFF
    if d >= 0x8000:
        d -= 0x10000
    return last_ext + d
