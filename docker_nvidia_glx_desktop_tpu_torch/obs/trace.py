"""Per-frame pipeline tracing: ring buffer in, Chrome trace-event JSON out.

Every frame gets a process-monotonic frame id at capture; each pipeline
stage appends ``(stage, t0, dur)`` spans tagged with that id to a named
:class:`TraceRecorder` ring buffer.  ``/debug/trace`` exports the merged
buffers as Chrome trace-event JSON — drop it into ``chrome://tracing`` or
Perfetto and the capture → device-submit → device-collect → bitstream →
publish → rtp-sent pipeline renders as nested tracks per recorder.

Spans may carry a small ``meta`` tuple of ``(key, value)`` pairs — the
frame-journey layer (obs/journey) stamps ``session`` / ``chunk`` /
``slot`` / ``shards`` so a chunked super-step frame or a spatially
sharded 4K session reads as labeled lanes in the export instead of an
indistinguishable blob.  A ``("session", id)`` pair routes the span to
its own per-session track (tid) at export time.

Hot-path contract: recording is a single
``deque.append`` of a tuple of numbers + interned constant strings — no
string formatting, no JSON, no allocation beyond the tuple.  All
formatting happens at export time.

Trace loss is NEVER silent: a ring overwrite (the deque evicting its
oldest entry) and a listener raising out of its flush both count into
``dngd_trace_dropped_total{tracer,reason}`` — the serving-budget smoke
asserts the counter stays 0 over its window (obs consumers see every
span through the listener hook, so a non-zero count means the budget
ledger's view is incomplete).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import metrics as obsm

__all__ = ["TraceRecorder", "tracer", "tracers", "next_frame_id",
           "export_chrome_trace", "set_enabled", "enabled",
           "dropped_total", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 4096      # spans per recorder (ring; oldest evicted)

_frame_ids = itertools.count(1)

_M_DROPPED = obsm.counter(
    "dngd_trace_dropped_total",
    "Trace entries lost by tracer and reason: ring_overwrite = the "
    "ring buffer evicted an un-exported entry, listener_error = a "
    "flush listener raised and its view of that entry is gone",
    ("tracer", "reason"))

# Master switch for the A/B overhead gate (bench --quick
# trace_overhead_pct): False turns record_span/record_marks into
# early returns so the full-tracing vs no-tracing fps delta is
# measurable on the identical serving path.
_ENABLED = True


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def dropped_total() -> float:
    """Sum of dngd_trace_dropped_total over all children (the
    serving-budget smoke gate)."""
    return sum(child.value for _, child in _M_DROPPED.series())


def next_frame_id() -> int:
    """Process-monotonic frame id; tags every span of one frame across
    recorders (encode thread, event loop, webrtc) for correlation."""
    return next(_frame_ids)


class TraceRecorder:
    """One named ring buffer of spans.

    ``record_span(stage, t0, dur, frame_id)`` — one complete span;
    ``record_marks(frame_id, marks)`` — a frame's ordered (stage, t)
    stage marks (a :class:`..utils.timing.StageTimer` flush); consecutive
    marks become spans at export time, named after the mark they END on,
    so the recorder never formats strings per frame.  Both accept an
    optional ``meta`` tuple of (key, value) pairs merged into the Chrome
    export's ``args`` (and used for per-session track routing).
    """

    def __init__(self, name: str, capacity: int = DEFAULT_CAPACITY):
        self.name = name
        # span entries: (stage, t0_s, dur_s, frame_id, pts, meta)
        self._spans: deque = deque(maxlen=capacity)
        # mark entries: (frame_id, ((stage, t_s), ...), pts, meta)
        self._marks: deque = deque(maxlen=capacity)
        # live consumers (the serving-budget ledger): called synchronously
        # on the recording thread with the stored tuple — listeners must
        # be append-only cheap, mirroring the ring buffer's contract
        self._listeners: List = []
        # dropped-entry children resolved once (hot path must not format
        # label strings per drop)
        self._m_overwrite = _M_DROPPED.labels(name, "ring_overwrite")
        self._m_listener = _M_DROPPED.labels(name, "listener_error")

    def add_listener(self, fn) -> None:
        """Register ``fn(kind, entry)`` called on every record:
        kind 'span' with (stage, t0, dur, frame_id, pts, meta), or kind
        'marks' with (frame_id, ((stage, t), ...), pts, meta).  The ring
        buffer only keeps the last ``capacity`` entries; a listener sees
        every one.  A listener that raises loses that entry only for
        itself — the error is counted (listener_error), never propagated
        into the recording thread."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def _notify(self, kind: str, entry) -> None:
        for fn in self._listeners:
            try:
                fn(kind, entry)
            except Exception:
                # a raising listener must not kill the encode thread,
                # and its missed entry must not vanish silently
                self._m_listener.inc()

    def record_span(self, stage: str, t0: float, dur: float,
                    frame_id: int = 0,
                    pts: Optional[int] = None,
                    meta: Optional[tuple] = None) -> None:
        if not _ENABLED:
            return
        entry = (stage, t0, dur, frame_id, pts, meta)
        if len(self._spans) == self._spans.maxlen:
            self._m_overwrite.inc()
        self._spans.append(entry)
        self._notify("span", entry)

    def record_marks(self, frame_id: int,
                     marks: Sequence[Tuple[str, float]],
                     pts: Optional[int] = None,
                     meta: Optional[tuple] = None) -> None:
        if not _ENABLED:
            return
        entry = (frame_id, tuple(marks), pts, meta)
        if len(self._marks) == self._marks.maxlen:
            self._m_overwrite.inc()
        self._marks.append(entry)
        self._notify("marks", entry)

    def __len__(self) -> int:
        return len(self._spans) + len(self._marks)

    def clear(self) -> None:
        self._spans.clear()
        self._marks.clear()

    # -- export (scrape-time only) -------------------------------------

    def chrome_events(self, tid: int = 0, tid_of=None) -> List[dict]:
        """Complete ('ph': 'X') events, ts/dur in microseconds (the
        Chrome trace-event contract).  ``args.pts`` (when recorded) is
        the cross-track correlation key: the encode thread and the
        webrtc sender tag spans of the same frame with the same pts.
        ``meta`` pairs land in ``args`` verbatim — ``chunk``/``slot``
        name a super-step frame's chunk, ``shards`` its spatial extent.
        ``tid_of(meta) -> tid`` (when given) routes spans to
        per-session tracks."""
        def args(fid, pts, meta):
            a = {"frame": fid} if pts is None else {"frame": fid,
                                                   "pts": pts}
            if meta:
                a.update(meta)
            return a

        def tid_for(meta):
            if tid_of is not None:
                t = tid_of(meta)
                if t is not None:
                    return t
            return tid

        out = []
        for stage, t0, dur, fid, pts, meta in list(self._spans):
            out.append({"name": stage, "cat": self.name, "ph": "X",
                        "ts": t0 * 1e6, "dur": dur * 1e6,
                        "pid": 0, "tid": tid_for(meta),
                        "args": args(fid, pts, meta)})
        for fid, marks, pts, meta in list(self._marks):
            for (_, t_a), (stage_b, t_b) in zip(marks, marks[1:]):
                out.append({"name": stage_b, "cat": self.name, "ph": "X",
                            "ts": t_a * 1e6, "dur": (t_b - t_a) * 1e6,
                            "pid": 0, "tid": tid_for(meta),
                            "args": args(fid, pts, meta)})
        return out


_tracers: Dict[str, TraceRecorder] = {}
_lock = threading.Lock()


def tracer(name: str, capacity: int = DEFAULT_CAPACITY) -> TraceRecorder:
    """Get-or-create the process-wide recorder ``name`` (one per
    pipeline: 'pipeline', 'webrtc', 'batch', ...)."""
    rec = _tracers.get(name)
    if rec is None:
        with _lock:
            rec = _tracers.get(name)
            if rec is None:
                rec = _tracers[name] = TraceRecorder(name, capacity)
    return rec


def tracers() -> Iterable[TraceRecorder]:
    return list(_tracers.values())


def export_chrome_trace(
        which: Optional[Iterable[TraceRecorder]] = None) -> dict:
    """The `/debug/trace` payload: Chrome trace-event JSON object form.

    Thread names come from metadata events so Perfetto labels each
    recorder's track; ts stays on the perf_counter timebase (Chrome only
    needs monotonicity, not wall-clock).  Spans stamped with a
    ``("session", id)`` meta pair get their own per-session track
    (``<recorder>:<session>``) so a multi-session capture reads as N
    lanes instead of one interleaved blob."""
    recs = list(which) if which is not None else tracers()
    events: List[dict] = []
    # base tids are assigned per recorder; per-session lanes extend past
    # them.  The allocator is shared across recorders so every
    # (recorder, session) pair is a distinct, stable lane.
    next_tid = len(recs)
    lanes: Dict[tuple, int] = {}
    for tid, rec in enumerate(recs):
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": rec.name}})

        def tid_of(meta, _rec=rec, _base=tid):
            nonlocal next_tid
            if not meta:
                return _base
            sid = next((v for k, v in meta if k == "session"), None)
            if sid is None:
                return _base
            key = (_rec.name, sid)
            lane = lanes.get(key)
            if lane is None:
                lane = lanes[key] = next_tid
                next_tid += 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": 0, "tid": lane,
                               "args": {"name": f"{_rec.name}:{sid}"}})
            return lane

        events.extend(rec.chrome_events(tid=tid, tid_of=tid_of))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"exported_at": time.time()}}
