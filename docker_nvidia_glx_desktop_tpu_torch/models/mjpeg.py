"""Baseline JPEG / MJPEG encoder on the card.

The port of the reference's ``models/mjpeg.py``: a frame goes through the
transform (K16a: colour, DCT, quantization, zigzag), then, on a table
refresh, the symbol histograms (K16b) and the host's optimal Huffman
tables (T.81 Annex K.2), then the bit pack (K16c) with those tables; the
host pulls the scan's length, then that many bytes, pads and byte-stuffs
them.  Any JPEG decoder (PIL, cv2, browsers) decodes the result.  It is
the noVNC path's Tight-JPEG encoder (``rfb/server.py``) and
``WEBRTC_ENCODER=tpumjpegenc``.

``entropy="python"`` pulls the levels and codes them on the host (the
reference's Python coder, the tests' oracle), ``"native"`` likewise with
the port's copy of the reference's C++ coder (``native/entropy.cpp``:
the histograms and the scan; the same bytes); ``"device"`` (``"auto"``)
is the path above.
"""

from __future__ import annotations

import struct
import time

import numpy as np
import torch

from ..bitstream import jpeg_huffman as jh
from ..bitstream.bitwriter import BitWriter
from ..ops import bitpack, jpeg_device, quant
from ..ops.scan import ZIGZAG8
from ..utils.mathutil import round_up
from .base import EncodedFrame, Encoder
from .h264 import resolve_device


def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def _tables_from_hists(hists, smooth: bool):
    """Four HuffmanTables (dc_l, ac_l, dc_c, ac_c) from one session's
    histograms; ``smooth`` adds 1 to every bin, so that sticky tables can
    code any later frame."""
    dc_y, ac_y, dc_c, ac_c = [np.asarray(h, np.int64) + int(smooth)
                              for h in hists]
    return (jh.HuffmanTable(dc_y[:12]), jh.HuffmanTable(ac_y),
            jh.HuffmanTable(dc_c[:12]), jh.HuffmanTable(ac_c))


def headers(width: int, height: int, luma_q, chroma_q, tables,
            restart_interval: int = 0) -> bytes:
    """SOI, JFIF, DQT x2, SOF0 (4:2:0), DHT x4, DRI when restarts are on,
    SOS: everything of a baseline JPEG before its scan."""
    out = bytearray(b"\xff\xd8")
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    lq = np.asarray(luma_q).reshape(64)[ZIGZAG8].astype(np.uint8).tobytes()
    cq = np.asarray(chroma_q).reshape(64)[ZIGZAG8].astype(np.uint8).tobytes()
    out += _marker(0xDB, b"\x00" + lq)
    out += _marker(0xDB, b"\x01" + cq)
    sof = struct.pack(">BHHB", 8, height, width, 3)
    sof += bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    out += _marker(0xC0, sof)
    dc_l, ac_l, dc_c, ac_c = tables
    out += _marker(0xC4, dc_l.dht_payload(0, 0))
    out += _marker(0xC4, ac_l.dht_payload(1, 0))
    out += _marker(0xC4, dc_c.dht_payload(0, 1))
    out += _marker(0xC4, ac_c.dht_payload(1, 1))
    if restart_interval:
        out += _marker(0xDD, struct.pack(">H", restart_interval))
    out += _marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return bytes(out)


class JpegEncoder(Encoder):
    """Single-image JPEG / MJPEG stream encoder."""

    codec = "mjpeg"

    def __init__(self, width: int, height: int, quality: int = 85,
                 use_native: bool | None = None, entropy: str = "auto",
                 table_mode: str = "sticky", table_refresh: int = 300,
                 device=None):
        """entropy: "device" (histograms and pack on the card; only the
        packed scan crosses to the host), "native" (the C++ host coder),
        "python" (the host's reference coder) or "auto" (= "device").
        ``use_native`` (the reference's older knob) picks "native" or
        "python".  A native library that does not build raises.

        table_mode: "per_frame" builds optimal Huffman tables from every
        frame's histograms; "sticky" builds +1-smoothed tables (every
        symbol coded) from the first frame and keeps them for
        ``table_refresh`` frames: one histogram pass per refresh.

        device: the card by default; ``"cpu"`` runs the plain versions."""
        super().__init__(width, height)
        self.device = resolve_device(device)
        self.quality = quality
        self.luma_q, self.chroma_q = quant.jpeg_quality_tables(quality)
        self.pad_w = round_up(width, 16)
        self.pad_h = round_up(height, 16)
        if use_native is not None:                      # legacy knob
            entropy = "native" if use_native else "python"
        if entropy == "auto":
            entropy = "device"
        if entropy == "native":
            from ..native import lib as native_lib
            native_lib.get_lib()          # fail at construction, not per frame
        if entropy not in ("device", "native", "python"):
            raise ValueError(f"unknown entropy mode {entropy!r}; expected "
                             "'auto', 'device', 'native', or 'python'")
        if table_mode not in ("sticky", "per_frame"):
            raise ValueError(f"unknown table_mode {table_mode!r}")
        self.entropy = entropy
        self.use_native = entropy == "native"
        self.table_mode = table_mode
        self.table_refresh = table_refresh
        self._tables = None
        self._table_arrays = None
        self._table_dev = None
        self._frames_since_tables = 0
        self.table_builds = 0

    # -- device stage --------------------------------------------------------

    def _levels(self, rgb):
        t = torch.as_tensor(np.ascontiguousarray(rgb, np.uint8))
        return jpeg_device.jpeg_transform(
            t.to(self.device).unsqueeze(0), self.luma_q, self.chroma_q,
            self.pad_h, self.pad_w)

    def transform(self, rgb):
        """K16a; returns host numpy (y_zz (nMCU, 4, 64), cb_zz, cr_zz)."""
        return tuple(t[0].cpu().numpy() for t in self._levels(rgb))

    # -- host stage ----------------------------------------------------------

    def _headers(self, tables, restart_interval: int = 0) -> bytes:
        return headers(self.width, self.height, self.luma_q, self.chroma_q,
                       tables, restart_interval)

    def entropy_encode(self, y_zz, cb_zz, cr_zz) -> bytes:
        """The host coder: symbols once -> optimal tables -> headers +
        scan (one symbol list feeds the histogram and the emission)."""
        nmcu = y_zz.shape[0]
        y_flat = np.asarray(y_zz).reshape(nmcu * 4, 64)
        if self.use_native:
            from ..native import lib as native_lib
            dc_hist, ac_hist = native_lib.jpeg_histograms(y_flat, cb_zz, cr_zz)
            tables = (jh.HuffmanTable(dc_hist[0][:12]),
                      jh.HuffmanTable(ac_hist[0]),
                      jh.HuffmanTable(dc_hist[1][:12]),
                      jh.HuffmanTable(ac_hist[1]))
            scan = native_lib.jpeg_encode_scan(y_flat, cb_zz, cr_zz, tables)
            return self._headers(tables) + scan + b"\xff\xd9"
        symbols, dc_hist, ac_hist = jh.frame_symbols(
            [y_flat, cb_zz, cr_zz], [0, 1, 1])
        tables = (jh.HuffmanTable(dc_hist[0][:12]), jh.HuffmanTable(ac_hist[0]),
                  jh.HuffmanTable(dc_hist[1][:12]), jh.HuffmanTable(ac_hist[1]))
        dc_l, ac_l, dc_c, ac_c = tables
        y_syms, cb_syms, cr_syms = symbols
        bw = BitWriter(stuffing="jpeg")
        for m in range(nmcu):
            for sub in range(4):
                self._emit_block(bw, y_syms[m * 4 + sub], dc_l, ac_l)
            self._emit_block(bw, cb_syms[m], dc_c, ac_c)
            self._emit_block(bw, cr_syms[m], dc_c, ac_c)
        bw.pad_to_byte(1)
        return self._headers(tables) + bw.getvalue() + b"\xff\xd9"

    @staticmethod
    def _emit_block(bw, entry, dc_table, ac_table) -> None:
        dc_entry, ac_entries = entry
        sym, amp, nbits = dc_entry
        dc_table.emit(bw, sym)
        bw.write(amp, nbits)
        for sym, amp, nbits in ac_entries:
            ac_table.emit(bw, sym)
            bw.write(amp, nbits)

    # -- device entropy path -------------------------------------------------

    def _set_tables(self, tables) -> None:
        self._tables = tables
        self._table_arrays = jpeg_device.dense_tables(tables)
        self._table_dev = jpeg_device.table_tensor(self._table_arrays,
                                                   self.device)

    def entropy_device(self, y, cb, cr) -> bytes:
        """K16b on a table refresh, the host tables, K16c, the host's
        trim and stuffing: levels (module layout, S = 1) -> JPEG bytes."""
        refresh = (self._tables is None or self.table_mode == "per_frame"
                   or self._frames_since_tables >= self.table_refresh)
        if refresh:
            hist = jpeg_device.jpeg_analyze(y, cb, cr)[0].cpu().numpy()
            self._set_tables(_tables_from_hists(
                np.split(hist, np.cumsum(jpeg_device.TABLE_SIZES)[:3]),
                smooth=self.table_mode == "sticky"))
            self._frames_since_tables = 0
            self.table_builds += 1
        self._frames_since_tables += 1
        packed, totals = jpeg_device.jpeg_pack(y, cb, cr, self._table_dev)
        (strip,), = jpeg_device.strip_bytes(packed, totals)
        scan = bitpack.finalize_bytes(*strip, pad_bit=1)
        return (self._headers(self._tables) + bitpack.jpeg_stuff_bytes(scan)
                + b"\xff\xd9")

    # -- checkpoint/restore --------------------------------------------------
    # Every frame is a keyframe; the state is the sticky tables, so a
    # restored session keeps the same DHT instead of rebuilding on its
    # first frame.

    def export_state(self) -> dict:
        st = super().export_state()
        st.update({"tables": self._tables, "table_arrays": self._table_arrays,
                   "frames_since_tables": self._frames_since_tables})
        return st

    def import_state(self, state: dict) -> None:
        """Also takes the reference encoder's state: its tables are
        rebuilt from their arrays (``codes``, ``lengths``, ``bits``,
        ``huffval``), whatever class carries them."""
        super().import_state(state)
        tables = state.get("tables")
        if tables is None:
            self._tables = self._table_arrays = self._table_dev = None
        else:
            self._set_tables(tuple(
                jh.HuffmanTable.from_fields(t.codes, t.lengths, t.bits,
                                            t.huffval) for t in tables))
        self._frames_since_tables = int(state.get("frames_since_tables", 0))

    # -- public API ----------------------------------------------------------

    def encode(self, rgb) -> EncodedFrame:
        t0 = time.perf_counter()
        if self.entropy == "device":
            data = self.entropy_device(*self._levels(rgb))
        else:
            data = self.entropy_encode(*self.transform(rgb))
        ms = (time.perf_counter() - t0) * 1e3
        ef = EncodedFrame(data=data, keyframe=True, frame_index=self.frame_index,
                          codec=self.codec, width=self.width, height=self.height,
                          encode_ms=ms)
        self.frame_index += 1
        return ef
