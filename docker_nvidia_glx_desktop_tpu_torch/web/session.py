"""Streaming session: capture -> encode on the card -> fMP4 -> clients
(the port of the reference's ``web/session.py``).

FrameSource -> the H.264 (or MJPEG) encoder of ``make_encoder``,
pipelined submit/collect so the upload of frame N+1 overlaps frame N's
device stage -> Mp4Muxer -> fan-out to subscriber queues (one per
client).  The session runs on a private thread (the encoder's collect
waits on the card; keeping it off the event loop keeps signalling
responsive) and publishes into asyncio via ``loop.call_soon_threadsafe``.
``StreamSession`` takes the encoder's ``device`` (None = the card).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import weakref
from typing import Optional

from ..models import make_encoder
from ..obs import budget as obsb
from ..obs import events as obsev
from ..obs import journey as obsj
from ..obs import metrics as obsm
from ..obs.trace import next_frame_id, tracer
from ..resilience import continuity as rcont
from ..resilience import faults as rfaults
from ..resilience.policy import CircuitBreaker, RetryPolicy
from ..utils.config import Config
from ..utils.timing import FrameStats, percentile
from .mp4 import Mp4Muxer, split_annexb

log = logging.getLogger(__name__)

__all__ = ["StreamSession", "SubscriberSet", "keyframe_requester"]


def keyframe_requester(session):
    """The ``fn(reason)`` to wire into a WebRTC peer's
    ``on_keyframe_request``: the session's rate-limited ``request_idr``
    when it has one (StreamSession, SessionHub), the legacy unlimited
    ``request_keyframe`` otherwise (reason dropped), or None for
    sessions with no keyframe surface at all.  One definition — the
    /ws offer path and the stock-selkies shim both wire through it."""
    if hasattr(session, "request_idr"):
        return session.request_idr
    if hasattr(session, "request_keyframe"):
        return lambda reason: session.request_keyframe()
    return None

# -- telemetry (obs registry; see obs/__init__ for the naming scheme) ----
_M_SUBMIT_MS = obsm.histogram(
    "dngd_encoder_submit_ms",
    "Capture + host color conversion + async device dispatch per frame")
_M_COLLECT_MS = obsm.histogram(
    "dngd_encoder_collect_ms",
    "Device wait + bitstream pull + AU assembly per frame")
_M_FRAMES = obsm.counter(
    "dngd_encoder_frames_total", "Encoded frames delivered to fan-out")
_M_BYTES = obsm.counter(
    "dngd_encoder_bytes_total", "Muxed media bytes delivered to fan-out")
_M_COLLECT_FAIL = obsm.counter(
    "dngd_encoder_collect_failures_total",
    "encode_collect failures (frame dropped, IDR resync engaged)")
_M_DROPPED = obsm.counter(
    "dngd_session_dropped_frags_total",
    "Media fragments evicted from slow subscriber queues")
_M_SLOW = obsm.counter(
    "dngd_session_slow_subscriber_events_total",
    "Publishes that hit a full subscriber queue (backpressure engaged)")
_M_EVICTED = obsm.counter(
    "dngd_session_evicted_subscribers_total",
    "Subscribers evicted after a sustained slow streak (reconnect "
    "re-admits them with a fresh IDR-gated queue)")
_M_SUBMIT_FAIL = obsm.counter(
    "dngd_encoder_submit_failures_total",
    "encode_submit failures (frame dropped; breaker-counted — the "
    "session stops only when the device is declared dead)")
_M_SOURCE_FAIL = obsm.counter(
    "dngd_session_source_failures_total",
    "Frame-source grab failures (X server gone; retried with backoff)")
_M_KEYFRAMES = obsm.counter(
    "dngd_encoder_keyframes_total",
    "Keyframes delivered to fan-out (IDR resyncs land here)")
M_IDR_REQUESTS = obsm.counter(
    "dngd_idr_requests_total",
    "Forced-IDR requests through the session's rate-limited "
    "request_idr path, by reason (pli/fir = client feedback, resync = "
    "collect-failure recovery, degrade = ladder rung, evict = "
    "keyframe lost to queue eviction)", ("reason",))

# Queue depth / client count are scrape-time functions over the live
# SubscriberSets — zero hot-path cost, always-current value.
_ALL_SUBSCRIBER_SETS: "weakref.WeakSet" = weakref.WeakSet()
_M_QDEPTH = obsm.gauge(
    "dngd_session_queue_depth",
    "Queued media/control items across all subscriber queues")
_M_QDEPTH.set_function(
    lambda: sum(s.queue_depth() for s in list(_ALL_SUBSCRIBER_SETS)))
_M_CLIENTS = obsm.gauge(
    "dngd_session_clients", "Connected media subscribers")
_M_CLIENTS.set_function(
    lambda: sum(len(s) for s in list(_ALL_SUBSCRIBER_SETS)))


class _Sub:
    __slots__ = ("q", "want_key", "slow_streak")

    def __init__(self, q: asyncio.Queue, want_key: bool):
        self.q = q
        self.want_key = want_key
        self.slow_streak = 0     # consecutive publishes that hit full


class SubscriberSet:
    """Per-session client fan-out: asyncio queue per subscriber with
    latest-wins backpressure (slow clients shed their OLDEST fragment, the
    way the reference's RTP path sheds late media).

    GOP-aware: a subscriber created with ``want_key=True`` receives no
    media fragment until its first keyframe (a mid-GOP joiner must not
    see undecodable P fragments), and when eviction drops a keyframe the
    subscriber is re-gated and :meth:`publish` returns True so the caller
    can ask the encoder for a fresh IDR.

    A subscriber whose queue is full for ``SLOW_EVICT_STREAK``
    *consecutive* publishes is evicted outright (its queue gets one
    final ``("evicted", reason)`` control item the websocket layer turns
    into a close): per-item eviction protects the other clients' memory,
    but a permanently wedged client still costs an IDR storm every
    cooldown and a queue of garbage.  Reconnect grace: eviction carries
    no penalty — the same client reconnecting is re-admitted immediately
    with a fresh IDR-gated queue (the normal join path)."""

    # ~0.5 s of sustained stall at 60 fps before eviction; one drained
    # item resets the streak, so bursty-but-alive clients never trip it
    SLOW_EVICT_STREAK = 30

    def __init__(self):
        self._subs: list = []
        _ALL_SUBSCRIBER_SETS.add(self)

    def close(self) -> None:
        """Session teardown: drop every subscriber and deregister from
        the scrape-time gauges NOW instead of waiting for GC — a long-
        running server churning thousands of sessions must not carry
        dead sets in the queue-depth/client-count reads."""
        self._subs = []
        _ALL_SUBSCRIBER_SETS.discard(self)

    def queue_depth(self) -> int:
        """Items currently queued across this set's subscribers (the
        `/metrics` queue-depth gauge reads this at scrape time)."""
        return sum(s.q.qsize() for s in self._subs)

    def __len__(self) -> int:
        return len(self._subs)

    def __bool__(self) -> bool:
        return bool(self._subs)

    def subscribe(self, first_items=(), maxsize: int = 8,
                  want_key: bool = False) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        for item in first_items:
            q.put_nowait(item)
        self._subs.append(_Sub(q, want_key))
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self._subs = [s for s in self._subs if s.q is not q]

    @staticmethod
    def _drop_frags(q: asyncio.Queue) -> bool:
        """Drop media frags up to the next queued keyframe (they follow a
        dropped keyframe and cannot be decoded); keep control items, and
        keep a later queued keyframe plus its successors — that is a
        valid recovery point.  Returns True if a keyframe was retained."""
        keep, kept_key, dropped = [], False, 0
        while True:
            try:
                it = q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if it[0] != "frag" or kept_key:
                keep.append(it)
            elif len(it) > 2 and it[2]:
                kept_key = True
                keep.append(it)
            else:
                dropped += 1
        for it in keep:
            q.put_nowait(it)
        if dropped:
            _M_DROPPED.inc(dropped)
        return kept_key

    def publish(self, item, keyframe=None) -> bool:
        """Fan ``item`` out to every subscriber.

        ``keyframe``: None for control items (never gated), else whether
        this media frag is a keyframe.  Returns True when any subscriber
        lost a keyframe to eviction (caller should request a new IDR)."""
        need_idr = False
        for sub in list(self._subs):
            if keyframe is not None and sub.want_key and not keyframe:
                continue                 # undecodable until the next IDR
            slow_counted = False
            while True:
                try:
                    sub.q.put_nowait(item)
                    if keyframe:
                        sub.want_key = False
                    break
                except asyncio.QueueFull:
                    if not slow_counted:
                        slow_counted = True
                        _M_SLOW.inc()
                    try:
                        old = sub.q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if old[0] == "frag":
                        _M_DROPPED.inc()
                    if old[0] == "frag" and len(old) > 2 and old[2]:
                        # Evicted this client's keyframe: frags queued
                        # before the NEXT keyframe (if any) are garbage.
                        if self._drop_frags(sub.q):
                            continue     # queued IDR is a recovery point
                        if keyframe:
                            continue     # incoming IDR replaces it
                        sub.want_key = True
                        need_idr = True
                        if keyframe is False:
                            break        # withhold the undecodable P frag
                        # control item (keyframe=None): retry the enqueue
            if slow_counted:
                sub.slow_streak += 1
                if sub.slow_streak >= self.SLOW_EVICT_STREAK:
                    self._evict(sub, "slow-subscriber")
            else:
                sub.slow_streak = 0
        return need_idr

    def _evict(self, sub: _Sub, reason: str) -> None:
        """Drop a wedged subscriber: drain its queue, leave one
        ``("evicted", reason)`` control item (the ws layer sends it and
        closes), and forget it.  The client reconnects through the
        normal join path — that IS the reconnect grace."""
        self._subs = [s for s in self._subs if s is not sub]
        while True:
            try:
                sub.q.get_nowait()
            except asyncio.QueueEmpty:
                break
        sub.q.put_nowait(("evicted", reason))
        _M_EVICTED.inc()
        log.warning("evicted subscriber after %d consecutive slow "
                    "publishes (%s); reconnect is immediate",
                    sub.slow_streak, reason)

    def broadcast_all(self, items) -> None:
        """Deliver a sequence atomically-ish to every queue (resize
        re-announcements); drops on full rather than evicting."""
        for sub in list(self._subs):
            try:
                for item in items:
                    sub.q.put_nowait(item)
            except asyncio.QueueFull:
                pass


class StreamSession:
    """One desktop's encode-and-fan-out loop."""

    def __init__(self, cfg: Config, source, loop=None, clock=None,
                 device=None):
        from .clock import MediaClock

        self.cfg = cfg
        self.device = device
        self.source = source
        self.loop = loop
        self.clock = clock if clock is not None else MediaClock()
        self.stats = FrameStats()
        # degradation-ladder state (resilience/degrade executes through
        # these): must exist before the first _setup_codec
        self._qp_offset = 0
        self._fps_cap: Optional[float] = None
        self._setup_codec(source.width, source.height)
        self._subscribers = SubscriberSet()
        # raw-AU taps (WebRTC peers): fn(annexb_au, keyframe, pts90k),
        # called on the encode thread
        self._au_listeners: list = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prewarm = None
        self._last_seq = -1
        self._need_frame = False
        # set on a collect failure: suppress delivery of in-flight P
        # frames (they predict from a reference the client never got)
        # until the encoder's forced-IDR resync comes through
        self._drop_until_key = False
        # healthz liveness: the loop made PROGRESS (delivered a frame or
        # was legitimately idle) — a loop spinning on encode failures
        # does not refresh this and goes unhealthy after the stall window
        self._last_tick = time.monotonic()
        self._pending_resize: Optional[tuple] = None
        self._resize_lock = threading.Lock()
        # rate-limited forced-IDR path (request_idr): PLI/FIR feedback,
        # the collect-failure resync and the degrade ladder's IDR rung
        # all dedupe here — a PLI storm costs ONE keyframe per window,
        # over-limit requests collapse into a single deferred grant
        self._idr_lock = threading.Lock()
        self._idr_last_grant = -1e9
        self._idr_deferred = False
        # submit failures are breaker-counted: isolated failures drop
        # one frame each; a run of consecutive failures (device genuinely
        # gone) opens the breaker — which no longer kills the session:
        # it enters device-loss RECOVERY (re-acquire + checkpoint
        # restore), with the breaker's half-open probe pacing the
        # re-acquire attempts.  The short reset timeout is the probe
        # cadence, not a death sentence.
        self._submit_breaker = CircuitBreaker(failure_threshold=8,
                                              reset_timeout_s=2.0)
        # frame-source failures (X server gone) retry with capped
        # backoff until the supervisor brings the server back
        self._source_policy = RetryPolicy(initial=0.05, cap=1.0)
        self._source_failures = 0
        # session continuity (resilience/continuity): host-side encoder
        # checkpoints on a cadence; device loss restores the SAME stream
        # lineage (muxer, clock, subscribers, AU listeners — and with
        # them SSRC/seq/timestamps) onto a re-acquired device
        self._ckpt = rcont.CheckpointKeeper(
            getattr(cfg, "ckpt_interval_s", 5.0))
        self._recovery_policy = RetryPolicy(initial=0.25, cap=2.0,
                                            max_attempts=40)
        self._recoveries = 0
        # zero-downtime handoff (resilience/handoff): a predecessor's
        # exported lineage parks here (loop side, lock-guarded like
        # _pending_resize) until the encode thread adopts it between
        # frames — import_state is never called cross-thread
        self._pending_adopt: Optional[dict] = None
        self._adopt_lock = threading.Lock()
        self._handoff_adopted = False
        from collections import deque
        self._submit_ms: deque = deque(maxlen=600)
        self._collect_ms: deque = deque(maxlen=600)
        # per-frame trace spans land in the process 'pipeline' ring
        # buffer, exported at /debug/trace (obs/trace)
        self._tracer = tracer("pipeline")
        # glass-to-glass frame journeys (obs/journey): minted at
        # capture, chunk/shard-stamped at collect, closed by the client
        # (ws ack or the peer's RTCP highest-seq).  Public: the /ws ack
        # handler and the WebRTC peer close through this book.
        self.journeys = obsj.JourneyBook()
        # CPU-energy proxy published to /metrics per tune tier (obs/
        # procstats) — continuously scrapeable, not a bench-only number
        from ..obs.procstats import CpuEnergyMeter, register_energy_gauges
        register_energy_gauges()   # family scrapeable before 1st publish
        self._energy = CpuEnergyMeter()
        self._energy_frames = 0

    # After a codec (re)build the first frames build the CUDA kernels
    # (nvcc) and capture the ring's graph, which can exceed
    # HEALTHZ_STALL_S on a cold build directory; the liveness probe must
    # not kill the pod mid-build.
    COMPILE_GRACE_S = 180.0

    def _setup_codec(self, width: int, height: int) -> None:
        self._healthz_grace_until = time.monotonic() + self.COMPILE_GRACE_S
        self.encoder, self.codec_name = make_encoder(self.cfg, width, height,
                                                     device=self.device)
        # super-step ring encoders stage chunk+1 frames in flight (the
        # chunk dispatches as ONE device program); classic codecs keep 2
        self.PIPELINE_DEPTH = getattr(self.encoder, "pipeline_depth", 2)
        if self._qp_offset:
            # degradation survives a codec rebuild (resize mid-degrade)
            self.encoder.degrade_qp_offset = self._qp_offset
        # The budget ledger's SLO verdicts gate against the BASELINE rung
        # matching the LIVE geometry/rate (obs/budget); resizes re-aim it.
        obsb.LEDGER.set_context(width, height, self.cfg.refresh)
        if self.codec_name.startswith("h264"):
            sps, pps = self._sps_pps()
            self.muxer = Mp4Muxer(width, height, sps, pps,
                                  fps=self.cfg.refresh)
            self.init_segment = self.muxer.init_segment()
        else:
            # MJPEG transport: each binary message is one JPEG; the client
            # paints frames directly (no MSE, no init segment).
            self.muxer = None
            self.init_segment = b""

    def hello(self) -> dict:
        """The client handshake message (sent on join and after resize)."""
        return {
            "type": "hello",
            "codec": self.codec_name,
            "mime": self.mime,
            "width": self.source.width,
            "height": self.source.height,
        }

    # -- dynamic resize (WEBRTC_ENABLE_RESIZE, reference Dockerfile:211) --

    def request_resize(self, width: int, height: int) -> bool:
        """Queue a resolution change; applied by the encode thread between
        frames (the kernels take the geometry as arguments; a new one
        builds nothing)."""
        if not self.cfg.webrtc_enable_resize:
            return False
        if not hasattr(self.source, "resize"):
            return False
        width, height = int(width), int(height)
        if not (16 <= width <= 7680 and 16 <= height <= 4320):
            return False
        with self._resize_lock:
            self._pending_resize = (width, height)
        return True

    def _apply_resize(self) -> None:
        with self._resize_lock:
            pending = self._pending_resize
            self._pending_resize = None
        if pending is None:
            return
        w, h = pending
        if (w, h) == (self.source.width, self.source.height):
            return
        log.info("resizing session to %dx%d", w, h)
        self.source.resize(w, h)
        self._setup_codec(w, h)
        # the prewarm belongs to an encoder: stop the old one's and start
        # one for the fresh encoder
        self._restart_prewarm()
        self._last_seq = -1
        hello = self.hello()
        init = self.init_segment

        items = [("json", hello)] + ([("init", init)] if init else [])
        if self.loop is not None:
            self.loop.call_soon_threadsafe(
                self._subscribers.broadcast_all, items)
        else:
            self._subscribers.broadcast_all(items)

    def _sps_pps(self):
        nals = split_annexb(self.encoder.headers())
        sps = next(n for n in nals if (n[0] & 0x1F) == 7)
        pps = next(n for n in nals if (n[0] & 0x1F) == 8)
        return sps, pps

    @property
    def mime(self) -> str:
        """Muxer-declared MSE type, or the direct-paint MJPEG type."""
        return "image/jpeg" if self.muxer is None else self.muxer.mime

    # -- client fan-out --------------------------------------------------

    def subscribe(self, maxsize: int = 8) -> asyncio.Queue:
        """Register a client; first queue item is always the init segment.
        The encoder is asked for an IDR so the client can join mid-stream
        (SURVEY.md §5 'resume = force IDR'), and the queue is gated until
        that keyframe arrives — a mid-GOP joiner never sees P frags it
        cannot decode."""
        first = [("init", self.init_segment)] if self.init_segment else []
        q = self._subscribers.subscribe(first, maxsize=maxsize,
                                        want_key=True)
        self.request_keyframe()
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self._subscribers.unsubscribe(q)

    def request_keyframe(self) -> None:
        """Force an IDR *and* wake the encode loop: on an idle desktop
        the damage gate would otherwise skip encoding forever, leaving a
        gated new joiner with no picture.  Unconditional — the join
        path must never defer (a gated subscriber has no picture until
        its IDR); rate-limitable reasons go through :meth:`request_idr`."""
        self.encoder.request_keyframe()
        self._need_frame = True

    # One forced IDR per window across every dedupe-able reason: a
    # misbehaving client PLI-storming the feedback channel must not
    # cost all other clients an IDR-bitrate storm (each IDR is ~10x a
    # P frame), and PLI / collect-resync / ladder requests racing each
    # other should collapse into the single keyframe that serves all.
    IDR_MIN_INTERVAL_S = 1.0

    def request_idr(self, reason: str = "manual") -> bool:
        """Rate-limited, deduped forced-IDR request.

        Returns True when the request was granted immediately; an
        over-limit request is DEFERRED (not dropped): the encode loop
        grants one collapsed IDR once the window reopens, so a resync
        requested right after a PLI-granted keyframe still happens —
        at most ``IDR_MIN_INTERVAL_S`` late."""
        M_IDR_REQUESTS.labels(reason).inc()
        now = time.monotonic()
        with self._idr_lock:
            if now - self._idr_last_grant >= self.IDR_MIN_INTERVAL_S:
                self._idr_last_grant = now
                self._idr_deferred = False
                grant = True
            else:
                self._idr_deferred = True
                grant = False
        if grant:
            self.request_keyframe()
        return grant

    def _idr_tick(self) -> None:
        """Encode-loop side of :meth:`request_idr`: grant the collapsed
        deferred request once the rate window reopens."""
        with self._idr_lock:
            if not self._idr_deferred:
                return
            now = time.monotonic()
            if now - self._idr_last_grant < self.IDR_MIN_INTERVAL_S:
                return
            self._idr_deferred = False
            self._idr_last_grant = now
        self.request_keyframe()

    # -- degradation executors (resilience/degrade walks these) --------

    def set_qp_offset(self, offset: int) -> None:
        """Bias the encoder's effective qp by ``offset`` (0 restores).
        Applied on the NEXT frame; survives resizes.  The reference
        grants a codec rebuild's healthz grace here (a new qp is a new
        compile there); the port keeps that grace, so the liveness probe
        never kills a pod for degrading."""
        self._qp_offset = int(offset)
        self.encoder.degrade_qp_offset = self._qp_offset
        if self._qp_offset:
            self._healthz_grace_until = max(
                self._healthz_grace_until,
                time.monotonic() + self.COMPILE_GRACE_S)

    def set_fps_cap(self, fps: Optional[float]) -> None:
        """Cap the encode loop's frame rate below the configured refresh
        (None restores).  Read by the loop every iteration, so the cap
        lands within one frame interval."""
        self._fps_cap = None if fps is None else max(float(fps), 1.0)

    # -- raw access-unit taps (the WebRTC media plane's input) ---------

    def add_au_listener(self, fn) -> None:
        """Register fn(annexb_au, keyframe, pts90k); runs on the encode
        thread — listeners must marshal to their own loop."""
        self._au_listeners.append(fn)
        self.request_keyframe()

    def remove_au_listener(self, fn) -> None:
        if fn in self._au_listeners:
            self._au_listeners.remove(fn)

    def _publish(self, fragment: bytes, keyframe: bool,
                 fid: int = 0) -> None:
        # the 4th tuple element is the frame-journey id: the websocket
        # pump probes sampled fids and the client's ack closes the
        # journey (obs/journey)
        if self._subscribers.publish(("frag", fragment, keyframe, fid),
                                     keyframe=keyframe):
            # A permanently stalled client would otherwise evict its
            # keyframe every queue-depth frames and storm the encoder
            # with IDR requests (IDRs cost every OTHER client
            # bitrate); request_idr's shared window IS the cap.
            self.request_idr("evict")

    # -- encode loop ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stream-session")
        self._thread.start()
        self._restart_prewarm()

    def _restart_prewarm(self) -> None:
        """(Re)start the background prewarm of the CURRENT encoder (the
        kernel builds and loads, and the ring's graph capture at the next
        IDR): a resize builds a fresh encoder, so the old one's stops."""
        if self._prewarm is not None:
            self._prewarm[1].set()
            self._prewarm = None
        if (self.cfg.encoder_prewarm
                and getattr(self.encoder, "_rate", None) is not None
                and hasattr(self.encoder, "prewarm_async")):
            self._prewarm = self.encoder.prewarm_async()

    def stop(self) -> None:
        self._stop.set()
        if self._prewarm is not None:
            self._prewarm[1].set()       # abort between ladder steps
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._prewarm is not None:
            # a daemon thread mid-build at interpreter exit leaves a
            # half-written library; give the in-flight build a chance to
            # finish before teardown proceeds
            self._prewarm[0].join(timeout=30)
            self._prewarm = None

    def close(self) -> None:
        """Full teardown: stop the encode thread AND release every piece
        of per-session observability state.  A server churning thousands
        of sessions must end each one with this (not bare ``stop()``) or
        the registry accumulates dead entries: the subscriber set stays
        in the queue-depth/client gauges until GC, the budget ledger
        keeps gating SLO rungs against a geometry that no longer serves,
        and AU listeners pin their peers."""
        self.stop()
        self._au_listeners.clear()
        self._subscribers.close()
        self.journeys.close_book()
        obsb.LEDGER.clear_context()
        from ..obs.content import PLANE as _content
        _content.drop(self.journeys.session)

    # -- zero-downtime handoff (resilience/handoff) --------------------

    def export_handoff(self) -> dict:
        """This session's half of a process-handoff snapshot.  Call with
        the encode thread STOPPED (``stop()``): ``export_state`` walks
        encoder internals that are not safe against a running loop."""
        return {"encoder": self.encoder.export_state(),
                "codec": self.codec_name,
                "width": self.source.width,
                "height": self.source.height,
                "recoveries": self._recoveries,
                "session": self.journeys.session}

    def adopt_handoff(self, state: dict) -> None:
        """Queue a predecessor's exported lineage; the encode thread
        imports it between frames (the ``_pending_resize`` pattern).
        Safe before ``start()`` too — the first loop iteration adopts."""
        with self._adopt_lock:
            self._pending_adopt = state

    def _consume_adopt(self) -> None:
        """Encode-thread side of :meth:`adopt_handoff`.  A failed import
        (schema drift, geometry change between builds) degrades to a
        fresh lineage + keyframe — and emits ``handoff-failed`` so the
        flight recorder dumps why the deploy wasn't seamless."""
        with self._adopt_lock:
            state = self._pending_adopt
            self._pending_adopt = None
        if state is None:
            return
        from ..resilience import handoff as rhandoff
        ckpt = state.get("encoder") or {}
        try:
            self.encoder.import_state(ckpt)
        except Exception as e:
            log.warning("handoff adopt rejected (%s); continuing with a "
                        "fresh lineage", e)
            rhandoff.count_session("failed")
            obsev.emit("handoff-failed", reason="adopt_reject",
                       session=self.journeys.session, error=str(e))
            self.encoder.request_keyframe()
            return
        # the imported checkpoint becomes the latest: a device loss in
        # the first cadence window still restores the migrated lineage
        self._ckpt.adopt(ckpt)
        self._recoveries += int(state.get("recoveries") or 0)
        self._handoff_adopted = True
        rhandoff.count_session("imported")
        obsev.emit("handoff-adopted", session=self.journeys.session,
                   frame_index=ckpt.get("frame_index"),
                   predecessor=state.get("session"))
        log.info("adopted handoff lineage (frame_index=%s, codec=%s)",
                 ckpt.get("frame_index"), state.get("codec"))

    # -- device-loss recovery (resilience/continuity) ------------------

    def _recover_device(self) -> bool:
        """Re-acquire a device and restore the checkpointed lineage.

        Runs on the encode thread while the submit breaker is open.  The
        breaker's half-open probe paces the attempts: each ``allow()``
        grants one re-acquire try (rebuild encoder + device round-trip +
        checkpoint import — the import re-uploads reference planes, so a
        still-dead device fails HERE, re-opening the breaker for another
        cool-down).  The muxer, media clock, subscriber queues and AU
        listeners are untouched, so the restored stream keeps its init
        segment, timestamp timeline and (via the persistent WebRTC peer)
        SSRC and contiguous RTP sequence numbers; the client sees the
        recovery IDR as a glitch, not a teardown.  Returns False when
        the retry budget is exhausted or stop was requested."""
        t0 = time.monotonic()
        ckpt = self._ckpt.state
        attempt = 0
        # recovery IS progress: the liveness probe must not kill a pod
        # mid-re-acquire (a restart would only recover more slowly)
        self._healthz_grace_until = time.monotonic() + self.COMPILE_GRACE_S
        while not self._stop.is_set():
            if not self._submit_breaker.allow():
                time.sleep(0.05)             # open: cooling down
                continue
            try:
                enc, name = rcont.restore_encoder(
                    self.cfg, self.source.width, self.source.height, ckpt,
                    device=self.device)
            except Exception:
                attempt += 1
                log.exception("device re-acquire attempt %d failed",
                              attempt)
                self._submit_breaker.record_failure()   # re-opens
                if self._recovery_policy.gives_up(attempt):
                    return False
                time.sleep(self._recovery_policy.delay(attempt - 1))
                continue
            if name != self.codec_name:
                # config-driven codec selection changed under us (e.g. a
                # fallback encoder); lineage cannot carry over — rebuild
                # the muxer path and let clients re-hello
                log.warning("recovered codec %s != %s; full codec "
                            "rebuild", name, self.codec_name)
                self._setup_codec(self.source.width, self.source.height)
            else:
                self.encoder = enc
                self._healthz_grace_until = (
                    time.monotonic() + self.COMPILE_GRACE_S)
            self._submit_breaker.record_success()
            self._restart_prewarm()
            self._need_frame = True          # wake the damage gate
            self._recoveries += 1
            elapsed = time.monotonic() - t0
            rcont.record_recovery(elapsed)
            log.warning(
                "device recovered in %.2fs (attempt %d, checkpoint %s); "
                "recovery IDR queued on the existing stream lineage",
                elapsed, attempt + 1,
                "age %.1fs" % self._ckpt.age_s if ckpt is not None
                else "absent")
            obsev.emit("device-recovered",
                       session=self.journeys.session,
                       elapsed_s=round(elapsed, 2),
                       attempts=attempt + 1)
            return True
        return False

    PIPELINE_DEPTH = 2   # frames in flight: upload/compute/pull overlap

    def _run(self) -> None:
        pending: list = []                   # submitted tokens, oldest first
        while not self._stop.is_set():
            # re-read each iteration: the degrade ladder caps the rate live
            rate = max(self.cfg.refresh, 1)
            if self._fps_cap is not None:
                rate = min(rate, self._fps_cap)
            frame_interval = 1.0 / rate
            if self._pending_adopt is not None:
                self._consume_adopt()
            if self._pending_resize is not None:
                while pending:               # drain old-geometry frames
                    try:
                        self.encoder.encode_collect(pending.pop(0)[0])
                    except Exception:
                        pass
                self._apply_resize()
            self._idr_tick()       # grant a deferred rate-limited IDR
            t0 = time.perf_counter()
            try:
                if rfaults.fire("xserver_gone") is not None:
                    raise ConnectionError("fault injection: xserver_gone")
                rgb, seq = self.source.frame()
            except Exception:
                # X server (or capture backend) gone: retry with capped
                # backoff — the supervisor is restarting it; a long
                # outage stops refreshing _last_tick and healthz flags
                # the pod, a short one recovers invisibly (plus an IDR
                # so clients resync to the revived desktop).
                if self._source_failures == 0:
                    log.exception("frame source failed; retrying with "
                                  "backoff")
                _M_SOURCE_FAIL.inc()
                self._source_failures += 1
                time.sleep(self._source_policy.delay(
                    self._source_failures - 1))
                continue
            if self._source_failures:
                log.info("frame source recovered after %d failures; "
                         "forcing IDR resync", self._source_failures)
                self._source_failures = 0
                self.request_keyframe()
            # A pending keyframe request (new joiner / evicted IDR)
            # overrides the damage gate: a static desktop must still
            # produce the IDR that un-gates the subscriber.
            changed = seq != self._last_seq or self._need_frame
            if not changed and not pending:
                # Legitimate idleness counts as liveness progress; a loop
                # stuck failing every encode does NOT (healthz catches it).
                self._last_tick = time.monotonic()
                # idle: poll gently, and barely at all with no clients
                # (each poll costs a grab + damage compare)
                time.sleep(frame_interval / 4 if self._subscribers
                           else min(frame_interval * 4, 0.25))
                continue
            self._need_frame = False
            self._last_seq = seq

            if changed:
                # pts stamped at CAPTURE (submit) so the A/V contract
                # aligns on when pixels existed, not when encode finished.
                # Unwrapped: the muxer timeline must never jump back; AU
                # listeners (RTP) reduce mod 2^32 themselves.
                capture_pts = self.clock.now90k_unwrapped()
                fid = next_frame_id()
                # journey minted at capture: this id survives through
                # the encoder, muxer, fan-out, and comes back in the
                # client's ack (or via the peer's RTCP seq mapping)
                self.journeys.mint(fid, pts=capture_pts, t_capture=t0)
                t_cap = time.perf_counter()
                try:
                    if rfaults.fire("device_submit_error") is not None:
                        raise RuntimeError(
                            "fault injection: device_submit_error")
                    if rfaults.fire("device_preempt") is not None:
                        # a preemption notice is unambiguous — no point
                        # counting 8 failures against a revoked device
                        self._submit_breaker.trip()
                        raise RuntimeError(
                            "fault injection: device_preempt "
                            "(device revoked)")
                    token = self.encoder.encode_submit(rgb)
                except Exception:
                    # One failed submit drops one frame (nothing is in
                    # flight for it); a consecutive run — a device that
                    # is actually gone — opens the breaker and the
                    # session enters device-loss recovery instead of
                    # dying (resilience/continuity).
                    _M_SUBMIT_FAIL.inc()
                    self._submit_breaker.record_failure()
                    if self._submit_breaker.state == "open":
                        log.exception(
                            "encode_submit failed %d times consecutively; "
                            "device declared lost, entering recovery",
                            self._submit_breaker.consecutive_failures)
                        obsev.emit(
                            "breaker-open",
                            session=self.journeys.session,
                            point="device-submit",
                            failures=self._submit_breaker
                            .consecutive_failures)
                        # in-flight frames died with the device; the
                        # recovery IDR is the client's next sync point
                        pending.clear()
                        self._drop_until_key = True
                        if not self._recover_device():
                            log.error("device recovery exhausted; "
                                      "stopping session")
                            return
                        continue
                    log.exception("encode_submit failed; dropping frame")
                    self._need_frame = True     # retry the capture
                    time.sleep(frame_interval)
                    continue
                self._submit_breaker.record_success()
                t_sub = time.perf_counter()
                # marks flow to the trace ring at publish; span names
                # are derived at export time (no per-frame formatting)
                pending.append((token, capture_pts, fid,
                                [("capture", t0), ("captured", t_cap),
                                 ("device-submit", t_sub)]))
                submit_ms = (t_sub - t0) * 1e3
                self._submit_ms.append(submit_ms)
                _M_SUBMIT_MS.observe(submit_ms)
                # dispatch stage (obs/budget): Python->device crossings
                # + submit-to-launch gap this frame accrued (0 crossings
                # for a ring-staged frame; the chunk's single crossing
                # lands on its dispatch frame)
                disp = self.encoder.pop_dispatch_sample() \
                    if hasattr(self.encoder, "pop_dispatch_sample") \
                    else None
                if disp is not None:
                    obsb.LEDGER.record_dispatch(disp[0], disp[1])
            # Collect the oldest frame once the pipeline is full (or the
            # source went quiet — drain so its frames aren't stranded).
            if pending and (len(pending) >= self.PIPELINE_DEPTH
                            or not changed):
                tc = time.perf_counter()
                token, frame_pts, fid, marks = pending.pop(0)
                try:
                    spec = rfaults.fire("collect_timeout")
                    if spec is not None:
                        if spec.get("mode") == "slow":
                            # sustained-budget-breach injection: inflate
                            # the collect stage without dropping frames
                            time.sleep(
                                float(spec.get("delay_ms", 50.0)) / 1e3)
                        else:
                            raise TimeoutError(
                                "fault injection: collect_timeout")
                    ef = self.encoder.encode_collect(token)
                except Exception:
                    # Transient device/transfer failure: drop this frame,
                    # keep the session alive (supervisord-style resilience).
                    # P tokens already in flight predict from a reference
                    # the client will now never decode — deliver nothing
                    # until the encoder's forced-IDR resync arrives.
                    log.exception("encode_collect failed; dropping frame")
                    _M_COLLECT_FAIL.inc()
                    self._drop_until_key = True
                    # the encoder forces its own IDR when ITS collect
                    # failed; a failure raised before reaching it (device
                    # RPC timeout, injected collect_timeout) needs the
                    # session to request the resync — idempotent either
                    # way, and rate-limited/deduped against PLI and the
                    # ladder rung (a deferred grant lands via _idr_tick)
                    self.request_idr("resync")
                    continue
                t_col = time.perf_counter()
                collect_ms = (t_col - tc) * 1e3
                self._collect_ms.append(collect_ms)
                _M_COLLECT_MS.observe(collect_ms)
                marks.append(("device-collect", t_col))
                if self._drop_until_key:
                    if not ef.keyframe:
                        continue        # stale pre-failure P frame
                    self._drop_until_key = False
                for fn in list(self._au_listeners):
                    try:
                        fn(ef.data, ef.keyframe, frame_pts)
                    except Exception:
                        log.exception("AU listener failed")
                frag = (self.muxer.fragment(ef.data, keyframe=ef.keyframe,
                                            pts_ms=frame_pts // 90)
                        if self.muxer is not None else ef.data)
                marks.append(("bitstream", time.perf_counter()))
                self.stats.record_frame(ef.encode_ms, len(frag))
                _M_FRAMES.inc()
                if ef.keyframe:
                    _M_KEYFRAMES.inc()
                _M_BYTES.inc(len(frag))
                self._post(frag, ef.keyframe, fid)
                t_pub = time.perf_counter()
                marks.append(("publish", t_pub))
                # journey: publish + the encoder's chunk/shard identity
                # (device span amortizes over the chunk at export);
                # device_ms = this frame's own submit span + collect
                jmeta = (self.encoder.pop_journey_meta()
                         if hasattr(self.encoder, "pop_journey_meta")
                         else None)
                self.journeys.complete(
                    fid, t_pub,
                    device_ms=collect_ms + (marks[2][1] - marks[1][1])
                    * 1e3,
                    meta=jmeta)
                # pts is the cross-track key: the webrtc 'rtp-sent' span
                # for this frame carries the identical pts value;
                # session/chunk/shard meta labels the Chrome-trace lane
                tmeta = [("session", self.journeys.session)]
                if jmeta and jmeta.get("chunk_len", 1) > 1:
                    tmeta += [("chunk", jmeta["chunk_id"]),
                              ("slot", jmeta["slot"])]
                if jmeta and jmeta.get("shards", 1) > 1:
                    tmeta.append(("shards", jmeta["shards"]))
                self._tracer.record_marks(fid, marks, pts=frame_pts,
                                          meta=tuple(tmeta))
                # content & quality plane (obs/content): the encoder's
                # in-graph stats for this frame, if one was sampled
                cstats = (self.encoder.pop_content_stats()
                          if hasattr(self.encoder, "pop_content_stats")
                          else None)
                if cstats is not None:
                    try:
                        from ..obs.content import PLANE as _content
                        _content.record(self.journeys.session, cstats)
                    except Exception:
                        log.exception("content stats record failed")
                self._last_tick = time.monotonic()   # delivered = progress
                # energy-proxy gauges on a ~2 s cadence at 60 fps: the
                # read is two getrusage fields, publish is two gauge sets
                self._energy_frames += 1
                if self._energy_frames >= 120:
                    try:
                        self._energy.publish(
                            self._energy_frames,
                            tune=getattr(self.encoder, "tune", "off"))
                    except Exception:
                        pass
                    self._energy.reset()
                    self._energy_frames = 0

            # continuity checkpoint on its cadence (the due-check is one
            # clock read).  Mid-pipeline state is fine: counters may run
            # a frame or two ahead of what clients saw, but restore
            # forces a recovery IDR that resets the visual chain anyway.
            self._ckpt.maybe_snapshot(self.encoder)

            elapsed = time.perf_counter() - t0
            sleep = frame_interval - elapsed
            if sleep > 0 and not self._subscribers:
                time.sleep(min(sleep * 4, 0.25))   # idle: throttle down
            elif sleep > 0:
                time.sleep(sleep)

    def _post(self, fragment: bytes, keyframe: bool,
              fid: int = 0) -> None:
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self._publish, fragment,
                                           keyframe, fid)
        else:
            self._publish(fragment, keyframe, fid)

    def stats_summary(self) -> dict:
        s = self.stats.summary()
        s.update({
            "codec": self.codec_name,
            "width": self.source.width,
            "height": self.source.height,
            "clients": len(self._subscribers),
            # per-stage breakdown (SURVEY.md §5 tracing parity): submit =
            # host color conversion + async device dispatch; collect =
            # device wait + bitstream pull + assembly.
            "stage_ms": {
                "submit_p50": percentile(sorted(self._submit_ms), 50),
                "collect_p50": percentile(sorted(self._collect_ms), 50),
            },
            "continuity": {
                "recoveries": self._recoveries,
                "checkpoints": self._ckpt.count,
                "checkpoint_age_s": (None if self._ckpt.age_s is None
                                     else round(self._ckpt.age_s, 1)),
            },
        })
        return s
