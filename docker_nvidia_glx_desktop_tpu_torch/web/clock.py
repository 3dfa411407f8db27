"""Shared media clock for A/V synchronization.

The reference's A/V sync is implicit in GStreamer's running-time model:
pulsesrc and ximagesrc stamp buffers against one pipeline clock and
webrtcbin maps that to RTP/RTCP (SURVEY.md §3.2).  The first-party
equivalent is one wall clock per process, read in the conventional 90 kHz
media timescale (``web/mp4.py`` TIMESCALE): the audio session stamps every
packet with it, the WebRTC RTCP sender reports map it to NTP time, and
the video path records capture times against it — so every transport
shares one timeline.
"""

from __future__ import annotations

import time

__all__ = ["MediaClock"]


class MediaClock:
    """Monotonic 90 kHz timeline anchored at construction."""

    RATE = 90_000

    def __init__(self):
        self.epoch = time.monotonic()

    def now90k(self) -> int:
        """Current media time in 90 kHz ticks (wraps like RTP at 2^32)."""
        return int((time.monotonic() - self.epoch) * self.RATE) & 0xFFFFFFFF

    def now90k_unwrapped(self) -> int:
        """Monotonic 90 kHz ticks WITHOUT the RTP 2^32 wrap — for
        consumers that need a non-wrapping timeline (the WebM cluster
        timestamps: a wrap after ~13 h would jump the MSE timeline back
        to zero and stall playback)."""
        return int((time.monotonic() - self.epoch) * self.RATE)

    def to_seconds(self, ts90k: int) -> float:
        return ts90k / self.RATE
