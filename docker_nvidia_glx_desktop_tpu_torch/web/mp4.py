"""First-party fragmented-MP4 (fMP4/CMAF) muxer for H.264 access units.

The reference's media packaging is GStreamer's RTP payloader feeding
webrtcbin (SURVEY.md §3.2).  Browsers can equally decode H.264 delivered as
fMP4 fragments through Media Source Extensions — which needs no GStreamer,
no SRTP stack, and rides the same WebSocket the signaling uses, so the
first-party web client plays the TPU encoder's output directly.  This
module converts Annex-B access units (what ``models/h264.py`` emits) into:

- an **init segment** (``ftyp`` + ``moov`` with ``avcC`` from the SPS/PPS and
  a ``mvex`` making it fragment-ready), and
- one **media segment** per access unit (``moof`` + ``mdat`` with
  AVCC-length-prefixed NALs), one sample per fragment for minimum latency.

Box layout follows ISO/IEC 14496-12; only what MSE requires is emitted.
"""

from __future__ import annotations

import struct
from typing import List

__all__ = ["split_annexb", "annexb_to_avcc", "Mp4Muxer"]

TIMESCALE = 90_000  # the conventional 90 kHz video clock


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">B3s", version,
                                 flags.to_bytes(3, "big")) + payload)


def split_annexb(data: bytes) -> List[bytes]:
    """Split an Annex-B byte stream into NAL units (start codes stripped).

    Handles both 3- and 4-byte start codes (the extra leading zero of a
    4-byte code belongs to the separator, not the preceding NAL).
    """
    starts = []
    pos = 0
    while True:
        pos = data.find(b"\x00\x00\x01", pos)
        if pos < 0:
            break
        starts.append(pos)
        pos += 3
    nals = []
    for idx, sc in enumerate(starts):
        begin = sc + 3
        end = starts[idx + 1] if idx + 1 < len(starts) else len(data)
        if idx + 1 < len(starts) and end > begin and data[end - 1] == 0:
            end -= 1                     # 4-byte start code's leading zero
        if end > begin:
            nals.append(data[begin:end])
    return nals


def annexb_to_avcc(data: bytes) -> bytes:
    """Annex-B AU -> AVCC (4-byte length-prefixed NALs, SPS/PPS dropped —
    they live in the init segment's avcC)."""
    out = bytearray()
    for nal in split_annexb(data):
        ntype = nal[0] & 0x1F
        if ntype in (7, 8):          # SPS/PPS carried out-of-band
            continue
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def _avcc_box(sps: bytes, pps: bytes) -> bytes:
    payload = struct.pack(">BBBBB", 1, sps[1], sps[2], sps[3],
                          0xFC | 3)           # lengthSizeMinusOne = 3
    payload += struct.pack(">B", 0xE0 | 1) + struct.pack(">H", len(sps)) + sps
    payload += struct.pack(">B", 1) + struct.pack(">H", len(pps)) + pps
    return _box(b"avcC", payload)


class Mp4Muxer:
    """Stateful muxer: ``init_segment()`` once, then ``fragment(au)`` per
    access unit."""

    def __init__(self, width: int, height: int, sps: bytes, pps: bytes,
                 fps: float = 60.0):
        self.width, self.height = width, height
        self.sps, self.pps = sps, pps
        self.sample_duration = int(round(TIMESCALE / fps))
        self.seq = 0
        self.decode_time = 0

    @property
    def mime(self) -> str:
        """MSE codec string from the real SPS bytes (profile_idc,
        constraint flags, level_idc)."""
        s = self.sps
        return f'video/mp4; codecs="avc1.{s[1]:02X}{s[2]:02X}{s[3]:02X}"'

    # -- init segment --------------------------------------------------

    def init_segment(self) -> bytes:
        ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200)
                    + b"isomiso5iso6avc1mp41")
        return ftyp + self._moov()

    def _moov(self) -> bytes:
        mvhd = _full(b"mvhd", 0, 0, struct.pack(
            ">IIII", 0, 0, 1000, 0)                # times, timescale, dur
            + struct.pack(">iH2xII", 0x00010000, 0x0100, 0, 0)
            + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
            + b"\0" * 24 + struct.pack(">I", 2))   # pre_defined, next track
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIII", 0, 0, 1, 0)
                     + struct.pack(">I", 0) + b"\0" * 8
                     + struct.pack(">hhhH", 0, 0, 0, 0)
                     + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                   0x40000000)
                     + struct.pack(">II", self.width << 16,
                                   self.height << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, TIMESCALE, 0, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide")
                     + b"\0" * 12 + b"VideoHandler\0")
        vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
        dref = _full(b"dref", 0, 0, struct.pack(">I", 1)
                     + _full(b"url ", 0, 1, b""))
        dinf = _box(b"dinf", dref)
        avc1 = _box(b"avc1", b"\0" * 6 + struct.pack(">H", 1)
                    + b"\0" * 16
                    + struct.pack(">HH", self.width, self.height)
                    + struct.pack(">IIIH", 0x00480000, 0x00480000, 0, 1)
                    + b"\0" * 32
                    + struct.pack(">Hh", 0x18, -1)
                    + self._avcc())
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + avc1)
        stbl = _box(b"stbl", stsd
                    + _full(b"stts", 0, 0, struct.pack(">I", 0))
                    + _full(b"stsc", 0, 0, struct.pack(">I", 0))
                    + _full(b"stsz", 0, 0, struct.pack(">II", 0, 0))
                    + _full(b"stco", 0, 0, struct.pack(">I", 0)))
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        trak = _box(b"trak", tkhd + mdia)
        trex = _full(b"trex", 0, 0, struct.pack(">IIIII", 1, 1, 0, 0, 0))
        mvex = _box(b"mvex", trex)
        return _box(b"moov", mvhd + trak + mvex)

    def _avcc(self) -> bytes:
        return _avcc_box(self.sps, self.pps)

    # -- media segments ------------------------------------------------

    def fragment(self, annexb_au: bytes, keyframe: bool = True,
                 pts_ms: int = None) -> bytes:
        """One moof+mdat for one access unit.

        ``pts_ms`` is accepted for muxer-interface uniformity and ignored:
        the MSE client plays this stream in 'sequence' mode, where append
        order defines the timeline."""
        payload = annexb_to_avcc(annexb_au)
        self.seq += 1
        mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", self.seq))
        # tfhd: default-base-is-moof (0x20000) + default sample duration
        # (0x8) + default sample flags (0x20).
        nonsync = 0x0101_0000          # sample_depends_on=1, non-sync
        sync = 0x0200_0000             # sample_depends_on=2... sync sample
        tfhd = _full(b"tfhd", 0, 0x20000 | 0x8 | 0x20,
                     struct.pack(">III", 1, self.sample_duration,
                                 sync if keyframe else nonsync))
        tfdt = _full(b"tfdt", 1, 0, struct.pack(">Q", self.decode_time))
        self.decode_time += self.sample_duration
        # trun: data-offset (0x1) + sample-size (0x200); one sample.  The
        # data_offset (moof start -> mdat payload) is fully determined by
        # the box sizes: moof hdr + mfhd + traf hdr + tfhd + tfdt + trun
        # (trun = 8 hdr + 4 ver/flags + 4 count + 4 offset + 4 size = 24),
        # plus the mdat header.
        trun_len = 24
        moof_len = 8 + len(mfhd) + 8 + len(tfhd) + len(tfdt) + trun_len
        data_offset = moof_len + 8
        trun = _full(b"trun", 0, 0x1 | 0x200,
                     struct.pack(">IiI", 1, data_offset, len(payload)))
        traf = _box(b"traf", tfhd + tfdt + trun)
        moof = _box(b"moof", mfhd + traf)
        assert len(moof) == moof_len
        return moof + _box(b"mdat", payload)
