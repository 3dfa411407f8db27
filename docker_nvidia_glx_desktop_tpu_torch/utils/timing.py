"""Per-stage frame timing and latency statistics.

The north-star metric is p50 frame-encode latency (BASELINE.md); the reference
had no profiling beyond GStreamer debug categories (SURVEY.md §5), so this is
a rebuild addition: capture -> device -> kernel -> bitstream -> wire
timestamps per frame, with percentile summaries for the stats endpoint.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class StageTimer:
    """Records monotonic timestamps for the stages of a single frame.

    Doubles as the trace feeder: :meth:`flush_to` hands the ordered marks
    to an :class:`..obs.trace.TraceRecorder` ring buffer tagged with the
    frame's monotonic id, and resets for the next frame.  The hand-off is
    one deque append of already-held strings and floats — no formatting
    (span names are derived at `/debug/trace` export time).
    """

    __slots__ = ("stamps",)

    def __init__(self) -> None:
        self.stamps: Dict[str, float] = {}

    def mark(self, stage: str) -> None:
        self.stamps[stage] = time.perf_counter()

    def marks(self):
        """Ordered (stage, t) pairs (marks are made in time order; the
        insertion-ordered dict preserves it)."""
        return list(self.stamps.items())

    def flush_to(self, recorder, frame_id: int) -> None:
        """Append this frame's marks to ``recorder`` and reset."""
        if len(self.stamps) >= 2:
            recorder.record_marks(frame_id, self.marks())
        self.stamps = {}

    def spans_ms(self) -> Dict[str, float]:
        """Durations between consecutive marks, in milliseconds."""
        items = sorted(self.stamps.items(), key=lambda kv: kv[1])
        out: Dict[str, float] = {}
        for (name_a, t_a), (name_b, t_b) in zip(items, items[1:]):
            out[f"{name_a}->{name_b}"] = (t_b - t_a) * 1e3
        if len(items) >= 2:
            out["total"] = (items[-1][1] - items[0][1]) * 1e3
        return out


class FrameStats:
    """Rolling per-session frame statistics (fps, encode ms percentiles).

    The reference exposes similar counters through the selkies web UI
    (SURVEY.md §5 metrics); we serve them from the stats endpoint.
    """

    def __init__(self, window: int = 600) -> None:
        self.encode_ms: deque = deque(maxlen=window)
        self.frame_times: deque = deque(maxlen=window)
        self.bytes_out: deque = deque(maxlen=window)
        self._last_frame_t: Optional[float] = None
        self.frames_total = 0

    def last_frame_age_s(self) -> Optional[float]:
        """Seconds since the last recorded frame (None before the first) —
        the staleness signal health checks need."""
        if self._last_frame_t is None:
            return None
        return time.perf_counter() - self._last_frame_t

    def record_frame(self, encode_ms: float, nbytes: int) -> None:
        now = time.perf_counter()
        self.encode_ms.append(encode_ms)
        self.bytes_out.append(nbytes)
        if self._last_frame_t is not None:
            self.frame_times.append(now - self._last_frame_t)
        self._last_frame_t = now
        self.frames_total += 1

    def summary(self) -> Dict[str, float]:
        enc = sorted(self.encode_ms)
        fps = 0.0
        if self.frame_times:
            mean_dt = sum(self.frame_times) / len(self.frame_times)
            fps = 1.0 / mean_dt if mean_dt > 0 else 0.0
        bitrate_kbps = 0.0
        if self.frame_times and self.bytes_out:
            window_s = sum(self.frame_times)
            if window_s > 0:
                bitrate_kbps = sum(list(self.bytes_out)[-len(self.frame_times):]) * 8 / 1e3 / window_s
        return {
            "frames_total": float(self.frames_total),
            "fps": fps,
            "encode_ms_p50": percentile(enc, 50),
            "encode_ms_p90": percentile(enc, 90),
            "encode_ms_p99": percentile(enc, 99),
            "bitrate_kbps": bitrate_kbps,
        }
