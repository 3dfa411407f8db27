"""Glass-to-glass frame journeys: one identity from capture to client.

The budget ledger (obs/budget) measures the server's stages; nothing
before this module measured past ``publish`` — the frame was declared
served the moment it entered a websocket queue, and the north-star
"p50 at the client" was actually "p50 at the socket".  A
:class:`FrameJourney` is minted at capture with the frame's process
frame id (obs/trace.next_frame_id), stamped with the encoder's
chunk/shard attribution (models/h264 ``pop_journey_meta``), marked
published when the fragment fans out, and **closed by the client**:

- **client acks** — the first-party web client echoes
  ``{"type": "ack", "id": <frame_id>}`` for sampled frames (the server
  tags every ``DNGD_JOURNEY_SAMPLE``-th fragment with an ``fprobe``
  control message over /ws; a stock-selkies client may send the same
  ack over its ``stats`` data channel).  Closure time is the SERVER'S
  receipt of the ack, so the measured glass-to-glass includes the ack's
  uplink — an honest upper bound that needs no clock sync.
- **RTCP fallback** — for WebRTC media the receiver's RRs carry the
  extended highest sequence received; the peer (webrtc/peer) maps it
  back through its per-frame last-RTP-seq log and closes the journey at
  ``now - rtt/2`` (rtt from LSR/DLSR when the peer has one).  Stock
  clients that never ack still close their journeys this way.

Chunk honesty: under the super-step ring, a staged frame costs 0
dispatches and the chunk frame pays for everyone, so per-frame "device"
spans are fictional.  Journeys carry ``(chunk_id, slot, chunk_len)``
and the summary AMORTIZES: a chunk's total device time is spread evenly
over its frames (``amortized_device_ms``), and the shard count rides
along so spatially sharded sessions attribute per chip group.

Everything here is bounded: per-book journey ring (capacity), rolling
glass-to-glass window, and label-churn-safe gauges (books remove their
label children on close).  ``mint``/``complete`` run on the encode
thread; ``close``/``close_by_pts`` on the event loop — every mutation
takes the book lock (per frame, not per span; a handful of dict ops).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.timing import percentile
from . import metrics as obsm

__all__ = ["FrameJourney", "JourneyBook", "books", "frontier",
           "probe_due", "sample_every", "set_enabled", "enabled",
           "global_summary", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 512        # journeys per book (open + recently closed)
G2G_WINDOW = 600              # closed glass-to-glass samples per book

# DNGD_JOURNEY_SAMPLE: every Nth frame gets a client-ack probe over the
# websocket (1 = every frame, 0 = never — RTCP-only closure).  Journeys
# themselves are minted for EVERY frame regardless; the knob bounds the
# ack chatter, not the accounting.
_SAMPLE = 8
try:
    _SAMPLE = int(os.environ.get("DNGD_JOURNEY_SAMPLE", "8") or "0")
except ValueError:
    pass

_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Master switch for the bench --quick trace-overhead A/B: off turns
    mint/complete/close into early returns on the identical code path."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def sample_every(n: Optional[int] = None) -> int:
    """Get (or, in tests/bench, set) the ack-probe sampling period."""
    global _SAMPLE
    if n is not None:
        _SAMPLE = int(n)
    return _SAMPLE


def probe_due(fid: int) -> bool:
    """Should this frame's websocket fragment carry an ack probe?"""
    return _ENABLED and _SAMPLE > 0 and fid % _SAMPLE == 0


_M_G2G_FRAMES = obsm.counter(
    "dngd_g2g_frames_total",
    "Frame journeys closed at the client, by closure method "
    "(client = ws/data-channel ack at server receipt time; rtcp = "
    "RR extended-highest-seq, now - rtt/2)", ("session", "method"))
_M_G2G_P50 = obsm.gauge(
    "dngd_g2g_p50_ms", "Glass-to-glass p50 (capture -> client) over the "
    "rolling window", ("session",))
_M_G2G_P95 = obsm.gauge(
    "dngd_g2g_p95_ms", "Glass-to-glass p95 over the rolling window",
    ("session",))
_M_G2G_P99 = obsm.gauge(
    "dngd_g2g_p99_ms", "Glass-to-glass p99 over the rolling window",
    ("session",))
_M_G2G_OK = obsm.gauge(
    "dngd_g2g_ok",
    "Glass-to-glass SLO verdict vs the active BASELINE rung: 1 = g2g "
    "p50 within budget_ms + one frame interval (the delivery "
    "allowance), 0 = over, -1 = no closed journeys / no active rung",
    ("session",))
_M_OPEN = obsm.gauge(
    "dngd_journey_open",
    "Journeys minted but not yet closed by a client signal (bounded by "
    "the per-book ring)", ("session",))
_M_EXPIRED = obsm.counter(
    "dngd_journey_expired_total",
    "Journeys evicted from the ring before any client signal closed "
    "them (no acking client connected, or closure signal lost)",
    ("session",))


class FrameJourney:
    """One frame's identity and its life-cycle timestamps (perf_counter
    timebase, like the trace marks it correlates with)."""

    __slots__ = ("fid", "pts", "t_capture", "t_publish", "t_client",
                 "method", "chunk_id", "slot", "chunk_len", "shards",
                 "device_ms")

    def __init__(self, fid: int, pts: Optional[int], t_capture: float):
        self.fid = fid
        self.pts = pts
        self.t_capture = t_capture
        self.t_publish: Optional[float] = None
        self.t_client: Optional[float] = None
        self.method: Optional[str] = None       # "client" | "rtcp"
        self.chunk_id: Optional[int] = None
        self.slot = 0
        self.chunk_len = 1
        self.shards = 1
        self.device_ms = 0.0     # this frame's own submit+collect cost

    @property
    def closed(self) -> bool:
        return self.t_client is not None

    def g2g_ms(self) -> Optional[float]:
        if self.t_client is None:
            return None
        return (self.t_client - self.t_capture) * 1e3

    def delivery_ms(self) -> Optional[float]:
        if self.t_client is None or self.t_publish is None:
            return None
        return (self.t_client - self.t_publish) * 1e3

    def as_dict(self) -> dict:
        d = {"fid": self.fid, "pts": self.pts,
             "t_capture": self.t_capture, "t_publish": self.t_publish,
             "t_client": self.t_client, "method": self.method,
             "device_ms": round(self.device_ms, 3),
             "shards": self.shards}
        if self.chunk_len > 1:
            d.update({"chunk_id": self.chunk_id, "slot": self.slot,
                      "chunk_len": self.chunk_len})
        g = self.g2g_ms()
        if g is not None:
            d["g2g_ms"] = round(g, 3)
            d["delivery_ms"] = round(self.delivery_ms() or 0.0, 3)
        return d


_books: Dict[str, "JourneyBook"] = {}
_books_lock = threading.Lock()
_book_seq = 0


class JourneyBook:
    """Per-session journey registry: bounded ring of journeys keyed by
    frame id, a pts index for RTCP closure, and the rolling
    glass-to-glass window feeding the ``dngd_g2g_*`` gauges.

    Encode thread: :meth:`mint`, :meth:`complete`.  Event loop:
    :meth:`close`, :meth:`close_by_pts`, the scrape-time reads.  Every
    method takes the one book lock (per-frame cadence)."""

    def __init__(self, session: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY):
        global _book_seq
        with _books_lock:
            if session is None:
                session = f"s{_book_seq}"
            _book_seq += 1
        self.session = str(session)
        self._lock = threading.Lock()
        self._cap = int(capacity)
        self._j: Dict[int, FrameJourney] = {}
        self._order: deque = deque()
        self._by_pts: Dict[int, int] = {}
        self._g2g: deque = deque(maxlen=G2G_WINDOW)   # (ms, method)
        self._delivery: deque = deque(maxlen=G2G_WINDOW)
        self._frontier = 0           # newest minted fid
        self._closed_total = 0
        self._chunk_device: Dict[int, list] = {}      # chunk_id -> [ms]
        self._m_client = _M_G2G_FRAMES.labels(self.session, "client")
        self._m_rtcp = _M_G2G_FRAMES.labels(self.session, "rtcp")
        self._m_expired = _M_EXPIRED.labels(self.session)
        _M_G2G_P50.labels(self.session).set_function(
            lambda: self._pctl(50))
        _M_G2G_P95.labels(self.session).set_function(
            lambda: self._pctl(95))
        _M_G2G_P99.labels(self.session).set_function(
            lambda: self._pctl(99))
        _M_G2G_OK.labels(self.session).set_function(self._slo_ok)
        _M_OPEN.labels(self.session).set_function(self._open_count)
        with _books_lock:
            _books[self.session] = self

    # -- encode-thread side --------------------------------------------

    def mint(self, fid: int, pts: Optional[int] = None,
             t_capture: Optional[float] = None) -> Optional[FrameJourney]:
        if not _ENABLED:
            return None
        j = FrameJourney(fid, pts,
                         t_capture if t_capture is not None
                         else time.perf_counter())
        with self._lock:
            self._j[fid] = j
            self._order.append(fid)
            if pts is not None:
                self._by_pts[pts] = fid
            self._frontier = max(self._frontier, fid)
            while len(self._order) > self._cap:
                old = self._order.popleft()
                oj = self._j.pop(old, None)
                if oj is not None:
                    if oj.pts is not None:
                        self._by_pts.pop(oj.pts, None)
                    if not oj.closed:
                        self._m_expired.inc()
        return j

    def complete(self, fid: int, t_publish: float,
                 device_ms: float = 0.0,
                 meta: Optional[dict] = None) -> None:
        """Stamp publish time + the encoder's chunk/shard attribution
        (``meta`` is models pop_journey_meta(): chunk_id/slot/chunk_len/
        shards, or None for unchunked codecs)."""
        if not _ENABLED:
            return
        with self._lock:
            j = self._j.get(fid)
            if j is None:
                return
            j.t_publish = t_publish
            j.device_ms = float(device_ms)
            if meta:
                j.chunk_id = meta.get("chunk_id")
                j.slot = int(meta.get("slot", 0))
                j.chunk_len = max(1, int(meta.get("chunk_len", 1)))
                j.shards = max(1, int(meta.get("shards", 1)))
            if j.chunk_id is not None:
                dev = self._chunk_device.setdefault(j.chunk_id, [])
                dev.append(j.device_ms)
                if len(self._chunk_device) > 64:    # bounded
                    self._chunk_device.pop(
                        next(iter(self._chunk_device)))

    # -- client-signal side (event loop) -------------------------------

    def close(self, fid: int, t_client: Optional[float] = None,
              method: str = "client") -> bool:
        """Close a journey by frame id (websocket / data-channel ack).
        Returns whether a journey was actually closed (late/duplicate
        acks and unknown ids are ignored)."""
        if not _ENABLED:
            return False
        t = t_client if t_client is not None else time.perf_counter()
        with self._lock:
            j = self._j.get(fid)
            if j is None or j.closed:
                return False
            j.t_client = t
            j.method = method
            g2g = j.g2g_ms()
            self._g2g.append((g2g, method))
            d = j.delivery_ms()
            if d is not None:
                self._delivery.append(d)
            self._closed_total += 1
        (self._m_client if method == "client" else self._m_rtcp).inc()
        if d is not None and d >= 0.0:
            # the delivery stage: distinct from compute (the encoder
            # stages) and from link-RTT (the host<->device probe) —
            # free-standing so it never inflates the compute floor
            from .budget import LEDGER
            LEDGER.observe_stage("delivery", d)
        return True

    def close_by_pts(self, pts: int, t_client: Optional[float] = None,
                     method: str = "rtcp") -> bool:
        """Close by media pts (the RTCP path: the peer knows which pts
        the acknowledged RTP seq range covered, not the frame id)."""
        with self._lock:
            fid = self._by_pts.get(pts)
        if fid is None:
            return False
        return self.close(fid, t_client, method)

    # -- scrape-time views ---------------------------------------------

    def frontier(self) -> int:
        """Newest minted frame id — the fleet event timeline anchors
        events to this per-session frontier."""
        return self._frontier

    def _open_count(self) -> float:
        """Journeys minted but not yet client-closed (the gauge value —
        NOT ring occupancy: closed journeys stay in the ring for the
        flight recorder but are not 'open')."""
        with self._lock:
            return float(sum(1 for f in self._order
                             if f in self._j and not self._j[f].closed))

    def _pctl(self, q: float) -> float:
        vals = sorted(ms for ms, _ in list(self._g2g))
        return round(percentile(vals, q), 3) if vals else 0.0

    def _slo_ok(self) -> float:
        if not self._g2g:
            return -1.0
        from .budget import LEDGER
        rung = LEDGER.active_rung()
        if rung is None:
            return -1.0
        allowance = 1000.0 / max(rung.fps, 1.0)
        return 1.0 if self._pctl(50) <= rung.budget_ms + allowance \
            else 0.0

    def amortized_device_ms(self, j: FrameJourney) -> float:
        """The honest per-frame device cost: a chunked frame's share of
        its chunk's total (the chunk frame paid for everyone; ring
        frames paid ~0), an unchunked frame's own cost."""
        if j.chunk_id is None:
            return j.device_ms
        with self._lock:
            dev = self._chunk_device.get(j.chunk_id)
        if not dev:
            return j.device_ms
        return sum(dev) / max(j.chunk_len, len(dev))

    def recent(self, n: int = 32) -> List[dict]:
        """Last ``n`` journeys, oldest first (flight-recorder payload),
        with amortized device attribution resolved."""
        with self._lock:
            fids = list(self._order)[-n:]
            js = [self._j[f] for f in fids if f in self._j]
        out = []
        for j in js:
            d = j.as_dict()
            d["amortized_device_ms"] = round(
                self.amortized_device_ms(j), 3)
            out.append(d)
        return out

    def summary(self) -> dict:
        """The ``glass_to_glass`` block (bench / budget snapshot)."""
        with self._lock:
            samples = list(self._g2g)
            delivery = sorted(self._delivery)
            closed = self._closed_total
            minted = self._frontier
            open_n = sum(1 for f in self._order
                         if f in self._j and not self._j[f].closed)
        by_method: Dict[str, int] = {}
        for _, m in samples:
            by_method[m] = by_method.get(m, 0) + 1
        vals = sorted(ms for ms, _ in samples)
        return {
            "session": self.session,
            "closed": closed,
            "open": open_n,
            "frontier_fid": minted,
            "by_method": by_method,
            "p50_ms": round(percentile(vals, 50), 3) if vals else None,
            "p95_ms": round(percentile(vals, 95), 3) if vals else None,
            "p99_ms": round(percentile(vals, 99), 3) if vals else None,
            "delivery_p50_ms": (round(percentile(delivery, 50), 3)
                                if delivery else None),
            "slo_ok": self._slo_ok(),
        }

    def close_book(self) -> None:
        """Session teardown: deregister and drop the per-session label
        children (a server churning thousands of sessions must not leak
        g2g series)."""
        with _books_lock:
            _books.pop(self.session, None)
        for g in (_M_G2G_P50, _M_G2G_P95, _M_G2G_P99, _M_G2G_OK,
                  _M_OPEN):
            g.remove(self.session)
        _M_G2G_FRAMES.remove(self.session, "client")
        _M_G2G_FRAMES.remove(self.session, "rtcp")
        _M_EXPIRED.remove(self.session)
        with self._lock:
            self._j.clear()
            self._order.clear()
            self._by_pts.clear()
            self._chunk_device.clear()


def books() -> List[JourneyBook]:
    with _books_lock:
        return list(_books.values())


def frontier() -> Dict[str, int]:
    """Per-session frame-id frontier — the event timeline's anchor."""
    return {b.session: b.frontier() for b in books()}


def global_summary() -> dict:
    """All live books' g2g blocks (budget snapshot / flight recorder)."""
    return {b.session: b.summary() for b in books()}
