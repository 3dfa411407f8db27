"""CABAC entropy coding (spec 9.3) for the rebuild's H.264 syntax subset.

Replaces CAVLC bit emission with context-adaptive binary arithmetic
coding — the reference's default encoder ``nvh264enc`` emits Main-profile
CABAC streams (reference Dockerfile:210), worth ~10-15% bitrate at equal
quality.  Normative tables come from :mod:`.cabac_tables` (constants,
pinned equal to the reference's recovered tables by the tests).

A copy of the reference's ``docker_nvidia_glx_desktop_tpu/bitstream/
cabac.py``: the pure-Python engine and slice coder, the oracle of the
native coder.

The slice-per-MB-row structure the whole codec is built around carries
over unchanged: every row is its own slice with its own arithmetic-engine
init, so rows stay independently codable (host thread-parallel in the
C++ twin, device-parallel later) and the CAVLC paths' availability rules
(top neighbors never available) apply to context derivation too.

Syntax subset coded here (matching the CAVLC layer, h264_entropy.py):
- I slices: I_16x16 (4 pred modes) and I_NxN macroblocks, chroma DC mode
- P slices: P_L0_16x16 + P_Skip, single reference, no sub-partitions
"""

from __future__ import annotations

import numpy as np

from .cabac_tables import engine_tables, init_contexts

# zigzag scan for 4x4 blocks (coefficient lists arrive already in zigzag
# order from the device stage, same contract as the CAVLC layer)

# ctxBlockCat offsets (spec 9.3.3.1.3, Table 9-40)
_CBF_OFF = {0: 0, 1: 4, 2: 8, 3: 12, 4: 16}       # coded_block_flag, base 85
_SIG_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}     # significant_coeff, 105
_LAST_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}    # last_significant, 166
_ABS_OFF = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}     # coeff_abs_level_m1, 227

# luma4x4BlkIdx -> (bx, by), the z-scan (matches h264_entropy._BLK_XY)
_BLK_XY = [(0, 0), (1, 0), (0, 1), (1, 1),
           (2, 0), (3, 0), (2, 1), (3, 1),
           (0, 2), (1, 2), (0, 3), (1, 3),
           (2, 2), (3, 2), (2, 3), (3, 3)]


class CabacEncoder:
    """The arithmetic coding engine (spec 9.3.4) for ONE slice.

    ``table_idx``: 0 for I slices, 1 + cabac_init_idc for P slices.
    Output via :meth:`get_bytes` after :meth:`finish` — starts at a byte
    boundary (the caller byte-aligns the slice header first with
    cabac_alignment_one_bit padding)."""

    def __init__(self, table_idx: int, qp: int):
        rng, tmps, tlps = engine_tables()
        self._rng_lps = rng
        self._tmps = tmps
        self._tlps = tlps
        st, mps = init_contexts(table_idx, qp)
        self.state = st.astype(np.int32)
        self.mps = mps.astype(np.int32)
        self.low = 0
        self.range = 510
        self._outstanding = 0
        self._first = True
        self._bits = []                  # appended MSB-first

    # -- bit plumbing (9.3.4.2: PutBit / WriteBits) --------------------

    def _put(self, b: int) -> None:
        if self._first:
            self._first = False
        else:
            self._bits.append(b)
        while self._outstanding > 0:
            self._bits.append(1 - b)
            self._outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self._outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- coding primitives (9.3.4.3) -----------------------------------

    def decision(self, ctx: int, b: int) -> None:
        s = int(self.state[ctx])
        r_lps = int(self._rng_lps[s][(self.range >> 6) & 3])
        self.range -= r_lps
        if b != self.mps[ctx]:
            self.low += self.range
            self.range = r_lps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = self._tlps[s]
        else:
            self.state[ctx] = self._tmps[s]
        self._renorm()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put(1)
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self._outstanding += 1

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            # WriteBits(((low >> 7) & 3) | 1, 2): the final 1 is the
            # rbsp_stop_one_bit
            v = ((self.low >> 7) & 3) | 1
            self._bits.append((v >> 1) & 1)
            self._bits.append(v & 1)
        else:
            self._renorm()

    def get_bytes(self) -> bytes:
        """Byte-aligned slice data (call after terminate(1)); pads the
        tail with rbsp_alignment_zero_bits."""
        bits = self._bits
        out = bytearray()
        acc = 0
        for i, b in enumerate(bits):
            acc = (acc << 1) | b
            if (i & 7) == 7:
                out.append(acc)
                acc = 0
        if len(bits) & 7:
            out.append(acc << (8 - (len(bits) & 7)))
        return bytes(out)

    # -- shared binarization helpers -----------------------------------

    def tu(self, v: int, cmax: int, ctxs) -> None:
        """Truncated unary: v ones then a zero (omitted at cmax);
        ``ctxs[i]`` is the context for bin i (last entry reused)."""
        for i in range(v):
            self.decision(ctxs[min(i, len(ctxs) - 1)], 1)
        if v < cmax:
            self.decision(ctxs[min(v, len(ctxs) - 1)], 0)

    def ueg_suffix(self, v: int, k: int) -> None:
        """Exp-Golomb order-k suffix in bypass (9.3.2.3)."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        for i in reversed(range(k)):
            self.bypass((v >> i) & 1)


class _MbCtx:
    """Per-MB left-neighbor context snapshot (top is never available
    under slice-per-row)."""

    __slots__ = ("intra", "i16", "skip", "cbf_luma", "cbf_luma_dc",
                 "cbf_cb", "cbf_cr", "cbf_cb_dc", "cbf_cr_dc",
                 "cbp_luma", "cbp_chroma", "abs_mvd", "modes")

    def __init__(self):
        self.intra = False
        self.i16 = False
        self.skip = False
        self.cbf_luma = np.zeros((4, 4), np.int32)     # [by][bx]
        self.cbf_luma_dc = 0
        self.cbf_cb = np.zeros((2, 2), np.int32)
        self.cbf_cr = np.zeros((2, 2), np.int32)
        self.cbf_cb_dc = 0
        self.cbf_cr_dc = 0
        self.cbp_luma = 0
        self.cbp_chroma = 0
        self.abs_mvd = np.zeros(2, np.int32)
        self.modes = np.full((4, 4), 2, np.int32)      # I4x4 pred modes


class SliceCoder:
    """Entropy-codes one MB-row slice.  ``enc`` is a fresh CabacEncoder;
    the caller writes the (byte-aligned) slice header separately."""

    def __init__(self, enc: CabacEncoder, intra_slice: bool):
        self.e = enc
        self.intra_slice = intra_slice
        self.left: _MbCtx | None = None   # None = MB column 0
        self._prev_qp_delta_nz = 0

    # -- residual block (9.3.3.1.3) ------------------------------------

    def residual(self, coeffs, cat: int, cbf_ctx_inc: int) -> int:
        """coded_block_flag + significance map + levels for one block.
        Returns the coded cbf (0/1)."""
        e = self.e
        coeffs = [int(c) for c in coeffs]
        nz = [i for i, c in enumerate(coeffs) if c]
        cbf = 1 if nz else 0
        e.decision(85 + _CBF_OFF[cat] + cbf_ctx_inc, cbf)
        if not cbf:
            return 0
        n = len(coeffs)
        last_nz = nz[-1]
        sig_base = 105 + _SIG_OFF[cat]
        last_base = 166 + _LAST_OFF[cat]
        for i in range(n - 1):
            inc = min(i, 2) if cat == 3 else i
            sig = 1 if coeffs[i] else 0
            e.decision(sig_base + inc, sig)
            if sig:
                e.decision(last_base + inc, 1 if i == last_nz else 0)
                if i == last_nz:
                    break
        # levels, reverse scan order over significant positions
        abs_base = 227 + _ABS_OFF[cat]
        num_eq1 = 0
        num_gt1 = 0
        for i in reversed(nz):
            lvl = abs(coeffs[i]) - 1          # coeff_abs_level_minus1
            c0 = abs_base + (0 if num_gt1 else min(4, 1 + num_eq1))
            cn = abs_base + 5 + min(3 if cat == 3 else 4, num_gt1)
            prefix = min(lvl, 14)
            for k in range(prefix):
                e.decision(c0 if k == 0 else cn, 1)
            if prefix < 14:
                e.decision(c0 if prefix == 0 else cn, 0)
            else:
                e.ueg_suffix(lvl - 14, 0)
            e.bypass(1 if coeffs[i] < 0 else 0)
            if lvl == 0:
                num_eq1 += 1
            else:
                num_gt1 += 1
        return 1

    # -- macroblock-level elements -------------------------------------

    def mb_skip(self, skip: bool) -> None:
        left = self.left
        inc = 1 if (left is not None and not left.skip) else 0
        self.e.decision(11 + inc, 1 if skip else 0)

    def mb_type_i(self, i4: bool, pred_mode: int, cbp_luma_nz: bool,
                  cbp_chroma: int) -> None:
        """mb_type for I slices (and the intra suffix in P slices)."""
        e = self.e
        if self.intra_slice:
            left = self.left
            # condTermN = 0 iff mbN unavailable or mbN is I_NxN; the top
            # MB is another slice, so condTermB is always 0
            inc = (1 if (left is not None and left.i16) else 0)
            e.decision(3 + inc, 0 if i4 else 1)
            if i4:
                return
            base = 3 + 2               # I-slice suffix contexts 6..10
            e.terminate(0)             # not I_PCM
            e.decision(base + 1, 1 if cbp_luma_nz else 0)
            e.decision(base + 2, 1 if cbp_chroma else 0)
            if cbp_chroma:
                e.decision(base + 3, 1 if cbp_chroma == 2 else 0)
            e.decision(base + 4, (pred_mode >> 1) & 1)
            e.decision(base + 5, pred_mode & 1)
        else:
            # intra in P: prefix bin 1 then suffix at base 17 with
            # SHARED chroma/pred contexts (lavc decode_cabac_mb_type)
            e.decision(14, 1)
            e.decision(17, 0 if i4 else 1)
            if i4:
                return
            e.terminate(0)
            e.decision(18, 1 if cbp_luma_nz else 0)
            e.decision(19, 1 if cbp_chroma else 0)
            if cbp_chroma:
                e.decision(19, 1 if cbp_chroma == 2 else 0)
            e.decision(20, (pred_mode >> 1) & 1)
            e.decision(20, pred_mode & 1)

    def mb_type_p16(self) -> None:
        """P_L0_16x16: prefix bin string "000" (ctx 14, 15, 16 —
        validated against the libavcodec decoder; "001" is P_8x8)."""
        e = self.e
        e.decision(14, 0)
        e.decision(15, 0)
        e.decision(16, 0)

    def mvd(self, comp: int, val: int) -> None:
        """mvd_l0 component (0 = x, 1 = y), UEG3 uCoff=9 + sign."""
        e = self.e
        base = 40 if comp == 0 else 47
        left = self.left
        s = int(left.abs_mvd[comp]) if left is not None else 0
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        a = abs(val)
        prefix = min(a, 9)
        ctxs = [base + inc, base + 3, base + 4, base + 5, base + 6]
        for k in range(prefix):
            e.decision(ctxs[min(k, 4)], 1)
        if prefix < 9:
            e.decision(ctxs[min(prefix, 4)], 0)
        else:
            e.ueg_suffix(a - 9, 3)
        if a:
            e.bypass(1 if val < 0 else 0)

    def intra_chroma_mode(self, mode: int) -> None:
        """condTermN = (mbN available, intra, chroma mode != 0).  This
        encoder always codes chroma DC (mode 0), so the left term is
        identically 0 — kept explicit so a future chroma-mode decision
        only needs to track the left mode in _MbCtx."""
        inc = 0
        e = self.e
        if mode == 0:
            e.decision(64 + inc, 0)
        else:
            e.decision(64 + inc, 1)
            e.tu(mode - 1, 2, [67])

    def i4_pred_mode(self, mode: int, pred: int) -> None:
        e = self.e
        if mode == pred:
            e.decision(68, 1)
        else:
            e.decision(68, 0)
            rem = mode - 1 if mode > pred else mode
            e.decision(69, rem & 1)
            e.decision(69, (rem >> 1) & 1)
            e.decision(69, (rem >> 2) & 1)

    def cbp(self, cbp_luma: int, cbp_chroma: int) -> None:
        """coded_block_pattern for I_NxN / P MBs (4 luma bins + chroma)."""
        e = self.e
        left = self.left
        # luma: 8x8 indices 0..3 (z-order: 0 tl, 1 tr, 2 bl, 3 br)
        for b in range(4):
            if b & 1:                       # right half: left nb in-MB
                a_bit = (cbp_luma >> (b - 1)) & 1
                a_avail = True
            else:                           # left half: from left MB
                a_bit = ((left.cbp_luma >> (b + 1)) & 1
                         if left is not None else 0)
                a_avail = left is not None
            if b & 2:                       # bottom: top nb in-MB
                b_bit = (cbp_luma >> (b - 2)) & 1
                b_avail = True
            else:
                b_bit = 0
                b_avail = False             # top MB: other slice
            inc = ((1 if (a_avail and not a_bit) else (0 if a_avail else 0))
                   + 2 * (1 if (b_avail and not b_bit) else 0))
            e.decision(73 + inc, (cbp_luma >> b) & 1)
        ca = left.cbp_chroma if left is not None else 0
        inc = (1 if ca > 0 else 0)          # top: unavailable -> 0
        e.decision(77 + inc, 1 if cbp_chroma else 0)
        if cbp_chroma:
            inc = (1 if ca == 2 else 0)
            e.decision(81 + inc, 1 if cbp_chroma == 2 else 0)

    def qp_delta(self, v: int) -> None:
        e = self.e
        mapped = 2 * abs(v) - (1 if v > 0 else 0)
        ctxs = [60 + self._prev_qp_delta_nz, 62, 63]
        for i in range(mapped):
            e.decision(ctxs[min(i, 2)], 1)
        e.decision(ctxs[min(mapped, 2)], 0)
        self._prev_qp_delta_nz = 1 if v else 0

    def qp_delta_absent(self) -> None:
        """An MB with no mb_qp_delta syntax (cbp==0 non-I16, or skip)
        infers mb_qp_delta = 0 — and the ctx for the NEXT coded one keys
        off the previous MB in decoding order (spec 9.3.3.1.1.5), so the
        flag must clear here or encoder and decoder pick different
        contexts."""
        self._prev_qp_delta_nz = 0

    def end_of_slice(self, last: bool) -> None:
        self.e.terminate(1 if last else 0)

    # -- coded_block_flag neighbor helpers ------------------------------

    def cbf_inc_luma(self, cur_cbf, bx: int, by: int, intra: bool) -> int:
        """ctxIdxInc for a luma 4x4 block at raster (bx, by) given the
        current MB's in-progress cbf grid ``cur_cbf`` [by][bx]."""
        left = self.left
        if bx > 0:
            a = int(cur_cbf[by][bx - 1])
        elif left is not None and not left.skip:
            a = int(left.cbf_luma[by][3])
        elif left is not None:
            a = 0
        else:
            a = 1 if intra else 0        # unavailable
        if by > 0:
            b = int(cur_cbf[by - 1][bx])
        else:
            b = 1 if intra else 0        # top MB: other slice
        return a + 2 * b

    def cbf_inc_chroma(self, cur, grid_attr: str, bx: int, by: int,
                       intra: bool) -> int:
        left = self.left
        if bx > 0:
            a = int(cur[by][bx - 1])
        elif left is not None and not left.skip:
            a = int(getattr(left, grid_attr)[by][1])
        elif left is not None:
            a = 0
        else:
            a = 1 if intra else 0
        if by > 0:
            b = int(cur[by - 1][bx])
        else:
            b = 1 if intra else 0
        return a + 2 * b

    def cbf_inc_dc(self, attr: str, intra: bool, require_i16: bool = False
                   ) -> int:
        left = self.left
        if left is None:
            a = 1 if intra else 0
        elif left.skip or (require_i16 and not left.i16):
            a = 0
        else:
            a = int(getattr(left, attr))
        b = 1 if intra else 0            # top MB: other slice
        return a + 2 * b
