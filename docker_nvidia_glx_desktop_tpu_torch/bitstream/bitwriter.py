"""MSB-first bit writer with optional JPEG/H.264 byte-stuffing modes.

Pure-Python reference implementation; the C++ twin in ``native/entropy.cpp``
must produce byte-identical output (tested in tests/test_native.py).
"""

from __future__ import annotations


class BitWriter:
    """Accumulates bits MSB-first into a bytearray.

    stuffing:
      - ``None``: raw bits (H.264 RBSP before emulation prevention).
      - ``"jpeg"``: insert a 0x00 after every 0xFF data byte (T.81 §B.1.1.5).
    """

    def __init__(self, stuffing: str | None = None) -> None:
        self.buf = bytearray()
        self._acc = 0          # bit accumulator (int)
        self._nbits = 0        # bits currently in accumulator
        self._stuffing = stuffing

    def write(self, value: int, nbits: int) -> None:
        """Append the low ``nbits`` of ``value``, MSB first."""
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            byte = (self._acc >> self._nbits) & 0xFF
            self.buf.append(byte)
            if self._stuffing == "jpeg" and byte == 0xFF:
                self.buf.append(0x00)
        self._acc &= (1 << self._nbits) - 1

    def write_bit(self, bit: int) -> None:
        self.write(bit & 1, 1)

    def pad_to_byte(self, pad_bit: int = 1) -> None:
        """Pad with ``pad_bit`` up to the next byte boundary (JPEG pads 1s)."""
        if self._nbits % 8:
            n = 8 - self._nbits % 8
            self.write(((1 << n) - 1) if pad_bit else 0, n)

    @property
    def bit_position(self) -> int:
        return len(self.buf) * 8 + self._nbits

    def peek_bits(self) -> tuple:
        """(bits, nbits): the whole stream so far as one MSB-first integer,
        including unflushed accumulator bits.  Raw mode only — with byte
        stuffing the integer would contain stuffing bytes."""
        assert self._stuffing is None, "peek_bits is for raw (RBSP) mode"
        return ((int.from_bytes(bytes(self.buf), "big") << self._nbits)
                | self._acc, self.bit_position)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unflushed bits; call pad_to_byte() first"
        return bytes(self.buf)
