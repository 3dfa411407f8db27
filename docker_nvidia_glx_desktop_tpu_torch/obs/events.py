"""Fleet event timeline: a bounded structured ring of control-plane
events, each anchored to the per-session frame-id frontier.

Metrics answer "how much"; traces answer "how long"; neither answers
"what happened, in what order, relative to which frame".  Every
consequential control-plane transition — degradation ladder moves,
fleet admission decisions and sheds, mesh rebuilds, chip loss, breaker
opens, drain, armed-fault firings — lands here as one dict:

    {"seq": N, "ts": <wall>, "t": <perf_counter>, "kind": "...",
     "session": "...", "frontier": {session: newest_fid}, ...detail}

The ``frontier`` anchor (obs/journey) is what makes the timeline a
debugging tool rather than a log: "the shed landed between frame 8841
and 8842 of session s3" turns a vague incident into a frame-exact one,
and the flight recorder (obs/flight) snapshots the same ring next to
the journeys those fids name.

``emit`` may be called from any thread (encode thread, event loop,
fault sites); it appends under one lock and fans out to listeners (the
flight recorder's trigger hook) on the emitting thread.  Exported at
``/debug/events`` as JSON + human text (obs/http).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from . import metrics as obsm

__all__ = ["EventLog", "EVENTS", "emit", "render_events_text"]

DEFAULT_CAPACITY = 1024

_M_EVENTS = obsm.counter(
    "dngd_events_total",
    "Fleet timeline events recorded, by kind (obs/events ring; "
    "exported at /debug/events)", ("kind",))


class EventLog:
    """Bounded ring of structured control-plane events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._listeners: List[Callable] = []

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(event)`` on every emit, on the emitting thread.  The
        flight recorder registers here; listeners must be cheap and
        never raise (raises are swallowed)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def emit(self, kind: str, session: Optional[str] = None,
             **detail) -> dict:
        """Record one event.  ``detail`` values must be JSON-able."""
        from . import journey as obsj

        ev = {"seq": next(self._seq), "ts": time.time(),
              "t": time.perf_counter(), "kind": str(kind)}
        if session is not None:
            ev["session"] = str(session)
        try:
            ev["frontier"] = obsj.frontier()
        except Exception:
            ev["frontier"] = {}
        if detail:
            ev.update(detail)
        with self._lock:
            self._ring.append(ev)
        _M_EVENTS.labels(kind).inc()
        for fn in list(self._listeners):
            try:
                fn(ev)
            except Exception:
                pass
        return ev

    def recent(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> dict:
        """The ``/debug/events?format=json`` payload."""
        events = self.recent()
        kinds: dict = {}
        for ev in events:
            kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        return {"count": len(events), "capacity": self._ring.maxlen,
                "by_kind": kinds, "events": events}


EVENTS = EventLog()

# Importing events must ARM the flight recorder: every emitter reaches
# this module (resilience/faults.fire lazy-imports it on an armed
# firing), and a trigger event with no recorder listening would be a
# silent no-op exactly when a postmortem matters.  Bottom-of-EVENTS so
# the circular import resolves: flight's `from .events import EVENTS`
# finds it already bound on this partially-initialized module.
from . import flight as _flight  # noqa: E402,F401  (registers listener)


def emit(kind: str, session: Optional[str] = None, **detail) -> dict:
    """Module-level shorthand onto the process event log."""
    return EVENTS.emit(kind, session=session, **detail)


def render_events_text(log: Optional[EventLog] = None,
                       n: int = 200) -> str:
    """The human-readable ``/debug/events`` payload (newest last)."""
    evs = (log if log is not None else EVENTS).recent(n)
    lines = [f"fleet event timeline — last {len(evs)} events "
             f"(newest last; ?format=json for the full ring)", ""]
    for ev in evs:
        ts = time.strftime("%H:%M:%S", time.localtime(ev["ts"]))
        frontier = ev.get("frontier") or {}
        anchor = ",".join(f"{s}@{f}" for s, f in sorted(frontier.items()))
        extra = {k: v for k, v in ev.items()
                 if k not in ("seq", "ts", "t", "kind", "session",
                              "frontier")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        sess = f" [{ev['session']}]" if "session" in ev else ""
        lines.append(f"{ev['seq']:>6} {ts} {ev['kind']:<16}{sess}"
                     f"{'  ' + detail if detail else ''}"
                     f"{'  frame-frontier ' + anchor if anchor else ''}")
    if not evs:
        lines.append("(no events yet)")
    return "\n".join(lines) + "\n"
