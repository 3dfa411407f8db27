"""Flight recorder: automatic postmortem snapshots on failure triggers.

When something goes wrong — an armed fault fires, a circuit breaker
opens, the fleet sheds a session, the mesh rebuilds after chip loss —
the numbers that explain it are about to rotate out of every ring
buffer.  The flight recorder listens on the event timeline
(obs/events) and, on any TRIGGER_KINDS event, snapshots the state that
a postmortem needs *at that instant*:

- the last N frame journeys of every live session (obs/journey, with
  amortized chunk device attribution),
- the recent event timeline itself,
- the serving-budget ledger snapshot (per-stage p50s, SLO verdicts,
  dispatch/halo/stitch attribution),
- any registered extra state providers (the fleet scheduler and the
  batch manager register theirs at wiring time).

Dumps land in a bounded in-memory ring served at ``/debug/flight`` and
— when ``DNGD_FLIGHT_SPOOL`` names a directory — as capped JSON files
on disk for postmortems that outlive the process.  Disk writes happen
on a dedicated spool thread so a trigger on the event loop (a fault
firing inside a websocket pump) never blocks serving on I/O.

Triggers are debounced per (kind, name): a fault storm costs one dump
per second per fault point, not one per firing.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import metrics as obsm
from .events import EVENTS

log = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "FLIGHT", "register_state_provider"]

DEFAULT_CAPACITY = 16         # in-memory dump ring
SPOOL_MAX_FILES = 32          # on-disk cap (oldest deleted)
MIN_INTERVAL_S = 1.0          # per-(kind,name) debounce
JOURNEYS_PER_BOOK = 32
EVENTS_PER_DUMP = 128

# event kinds that trip a dump; the `point`/`reason` detail key becomes
# the debounce name so distinct faults each get their own dump budget
TRIGGER_KINDS = frozenset((
    "fault-fire", "breaker-open", "shed", "mesh-rebuild", "chip-loss",
    # quality incidents (obs/content): a PSNR floor breach or a damage
    # spike snapshots content state next to the journeys it rode with
    "psnr_floor_breach", "damage_spike",
    # abuse incidents (resilience/ingress): a peer crossing the
    # quarantine rung snapshots the wire state that got it there
    # (eviction rides the existing "shed" trigger)
    "ingress_quarantine",
    # a handoff falling back to shed (resilience/handoff): the deploy
    # that silently degraded into an incident gets a postmortem dump
    "handoff-failed"))

_M_DUMPS = obsm.counter(
    "dngd_flight_dumps_total",
    "Flight-recorder dumps taken, by triggering event kind", ("kind",))
_M_SPOOLED = obsm.counter(
    "dngd_flight_spooled_total",
    "Flight-recorder dumps written to the on-disk spool "
    "(DNGD_FLIGHT_SPOOL)")


class FlightRecorder:
    """Bounded ring of postmortem snapshots, spooled to disk."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 min_interval_s: float = MIN_INTERVAL_S):
        self._dumps: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._last: Dict[tuple, float] = {}      # (kind, name) -> t
        self._counts: Dict[str, int] = {}        # cumulative, survives
        self._seq = 0                            # ring eviction
        self._min_interval = float(min_interval_s)
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._spool_q: Optional[queue.Queue] = None
        self._spool_thread: Optional[threading.Thread] = None

    # -- wiring --------------------------------------------------------

    def register_state_provider(self, name: str,
                                fn: Callable[[], dict]) -> None:
        """``fn() -> JSON-able dict`` evaluated at dump time (the fleet
        scheduler's snapshot, the batch manager's mesh state, ...)."""
        self._providers[str(name)] = fn

    def spool_dir(self) -> Optional[str]:
        """Read per dump (not cached) so tests and bench runs can point
        the spool without re-importing the module."""
        d = os.environ.get("DNGD_FLIGHT_SPOOL", "").strip()
        return d or None

    # -- trigger path --------------------------------------------------

    def on_event(self, ev: dict) -> None:
        """Event-timeline listener: dump on trigger kinds (debounced)."""
        kind = ev.get("kind")
        if kind not in TRIGGER_KINDS:
            return
        name = str(ev.get("point") or ev.get("reason")
                   or ev.get("session") or "")
        now = time.monotonic()
        with self._lock:
            last = self._last.get((kind, name), 0.0)
            if now - last < self._min_interval:
                return
            self._last[(kind, name)] = now
        try:
            self.dump(kind, name, trigger=ev)
        except Exception:
            log.exception("flight-recorder dump failed (trigger %s/%s)",
                          kind, name)

    def dump(self, kind: str, name: str = "",
             trigger: Optional[dict] = None) -> dict:
        """Take one snapshot now; returns it (and rings/spools it)."""
        from . import journey as obsj
        from .budget import LEDGER

        with self._lock:
            self._seq += 1
            seq = self._seq
        snap = {
            "seq": seq,
            "ts": time.time(),
            "kind": str(kind),
            "name": str(name),
            "trigger": trigger,
            "journeys": {b.session: b.recent(JOURNEYS_PER_BOOK)
                         for b in obsj.books()},
            "glass_to_glass": obsj.global_summary(),
            "events": EVENTS.recent(EVENTS_PER_DUMP),
            "budget": LEDGER.snapshot(),
        }
        # the reference's dumps also embed the kernel profiler's stage
        # view and the SLO burn-rate verdicts; those planes come to the
        # port with the browser layer (ROADMAP item 6b)
        snap["profile"] = snap["slo"] = {"error": "not in the port yet"}
        for pname, fn in list(self._providers.items()):
            try:
                snap[pname] = fn()
            except Exception:
                snap[pname] = {"error": "state provider failed"}
        key = f"{kind}:{name}" if name else str(kind)
        with self._lock:
            self._dumps.append(snap)
            self._counts[key] = self._counts.get(key, 0) + 1
        _M_DUMPS.labels(kind).inc()
        self._spool(snap)
        return snap

    # -- on-disk spool (dedicated thread; never blocks the trigger) ----

    def _spool(self, snap: dict) -> None:
        if self.spool_dir() is None:
            return
        with self._lock:               # dump() runs on encode thread
            if (self._spool_thread is None     # AND event loop: the
                    or not self._spool_thread.is_alive()):  # lazy spawn
                self._spool_q = queue.Queue(maxsize=64)     # must not
                self._spool_thread = threading.Thread(      # race
                    target=self._spool_worker,
                    args=(self._spool_q,), daemon=True,
                    name="flight-spool")
                self._spool_thread.start()
            q = self._spool_q
        try:
            q.put_nowait(snap)
        except queue.Full:
            pass                       # spool saturated: ring still has it

    def _spool_worker(self, q: "queue.Queue") -> None:
        while True:
            snap = q.get()
            try:
                self._write_spool(snap)
            except Exception:
                log.exception("flight spool write failed")
            finally:
                q.task_done()          # flush_spool joins on this

    def _write_spool(self, snap: dict) -> None:
        d = self.spool_dir()
        if d is None:
            return
        os.makedirs(d, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in f"{snap['kind']}-{snap['name']}")[:64]
        path = os.path.join(d, f"flight_{snap['seq']:06d}_{safe}.json")
        with open(path, "w") as f:
            json.dump(snap, f, default=str)
        _M_SPOOLED.inc()
        # cap the spool: oldest files out first (lexicographic seq order)
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("flight_") and n.endswith(".json"))
        for n in names[:-SPOOL_MAX_FILES]:
            try:
                os.remove(os.path.join(d, n))
            except OSError:
                pass

    def flush_spool(self, timeout_s: float = 5.0) -> None:
        """Block until queued spool writes are ON DISK (bench/CI runs
        read the spool right after the triggers).  task_done-based: an
        empty queue with a write still in flight does not count as
        flushed."""
        with self._lock:
            q = self._spool_q
        if q is None:
            return
        deadline = time.monotonic() + timeout_s
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.02)

    # -- reads ---------------------------------------------------------

    def dumps(self) -> List[dict]:
        with self._lock:
            return list(self._dumps)

    def by_reason(self) -> Dict[str, int]:
        """CUMULATIVE dump counts per trigger (not just the ring — a
        long chaos run's later dump storm must not make earlier faults'
        dumps look like they never happened)."""
        with self._lock:
            return dict(self._counts)

    def find_dump(self, kind: str, name: str = "") -> Optional[dict]:
        """Most recent ringed dump matching (kind, name)."""
        for d in reversed(self.dumps()):
            if d["kind"] == kind and (not name or d["name"] == name):
                return d
        return None

    def clear(self) -> None:
        with self._lock:
            self._dumps.clear()
            self._last.clear()
            self._counts.clear()

    def snapshot(self, full: bool = False) -> dict:
        """The ``/debug/flight`` payload: dump index + the latest dump
        (``full`` embeds every ringed dump)."""
        ds = self.dumps()
        return {
            "dumps": len(ds),
            "spool_dir": self.spool_dir(),
            "by_reason": self.by_reason(),
            "index": [{"seq": d["seq"], "ts": d["ts"], "kind": d["kind"],
                       "name": d["name"]} for d in ds],
            ("all" if full else "latest"): (
                ds if full else (ds[-1] if ds else None)),
        }


FLIGHT = FlightRecorder()
EVENTS.add_listener(FLIGHT.on_event)


def register_state_provider(name: str, fn: Callable[[], dict]) -> None:
    FLIGHT.register_state_provider(name, fn)
