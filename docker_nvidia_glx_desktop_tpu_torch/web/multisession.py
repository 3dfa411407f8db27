"""Multi-session batch serving: N desktops, one batched encode on the card
(the port of the reference's ``web/multisession.py``).

N sessions' frames stacked on a leading session axis run through the
H.264 kernels with a session grid axis (``parallel/batch``: the IDR step
15b, the P step 15c and the chunk step 15d) — one host, one card, N
desktops.  ``BatchStreamManager`` runs the single encode loop; each
:class:`SessionHub` carries one session's muxer/subscribers/stats and
plugs into the same websocket protocol a single :class:`StreamSession`
does.

The reference plans a ("session", "spatial") mesh over its devices; with
one device that mesh is (1, 1) and every session sits on it.  The port
plans over ``torch.cuda.device_count()`` cards (or the CPU when asked
for) the same way, serves the (1, 1) plan, and raises naming ROADMAP
item 11 for any plan over more than one device (the spatial and
multi-device paths, rows 15e-15h).

GOP mode is batched too: non-key ticks run the P step with the
reference planes held on the device.  All sessions in a bucket share one
GOP phase: the batch is one program per tick, so a forced IDR (join,
eviction recovery, overflow) re-keys every session in the bucket — the
per-hub request_idr rate window bounds how often one client can impose
that cost on its bucket-mates.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.h264 import H264Encoder, resolve_device
from ..obs import events as obsev
from ..obs import journey as obsj
from ..obs import metrics as obsm
from ..obs.trace import next_frame_id, tracer
from ..resilience import faults as rfaults
from ..utils.config import Config
from ..utils.timing import FrameStats
from .mp4 import Mp4Muxer, split_annexb
from .session import M_IDR_REQUESTS, SubscriberSet

log = logging.getLogger(__name__)

__all__ = ["SessionHub", "BatchStreamManager", "BucketedStreamManager",
           "export_batch_state", "import_batch_state"]

# Batched-path analogs of the single-session encoder histograms: submit
# = host YUV staging + the launches of the whole batch, collect = device
# wait + host transfer of every session's flat buffer.
_M_BATCH_SUBMIT = obsm.histogram(
    "dngd_batch_submit_ms",
    "Batched step device dispatch time per tick (all sessions)")
_M_BATCH_COLLECT = obsm.histogram(
    "dngd_batch_collect_ms",
    "Batched step device wait + host transfer per tick (all sessions)")
_M_BATCH_TICKS = obsm.counter(
    "dngd_batch_ticks_total", "Batched encode ticks delivered", ("kind",))
_M_MESH_REBUILDS = obsm.counter(
    "dngd_mesh_rebuilds_total",
    "Elastic mesh rebuilds after chip loss (N->N-1 re-bucketing)")
_M_MESH_CHIPS = obsm.gauge(
    "dngd_mesh_dead_chips", "Mesh chips currently marked dead")


class SessionHub:
    """One session's client-facing state (no encode thread of its own).

    ``injector`` is per-hub: only the hub whose source is a real X display
    gets a real input backend — otherwise a client on session 1 would
    inject keystrokes into session 0's desktop."""

    def __init__(self, cfg: Config, source, sps: bytes, pps: bytes,
                 codec_name: str, injector=None):
        self.cfg = cfg
        self.source = source
        self.codec_name = codec_name
        self.injector = injector
        self.stats = FrameStats()
        self.muxer = Mp4Muxer(source.width, source.height, sps, pps,
                              fps=cfg.refresh)
        self.init_segment = self.muxer.init_segment()
        self._subscribers = SubscriberSet()
        # per-hub glass-to-glass journeys (obs/journey): minted by the
        # manager at delivery, closed by the hub's clients' ws acks
        self.journeys = obsj.JourneyBook()
        # request_idr rate limiter (loop-only state: every caller —
        # PLI dispatch, ws handler, degrade executor — runs on the
        # event loop, unlike StreamSession's locked twin)
        self._idr_last_grant = -1e9
        self._idr_deferred = False

    @property
    def mime(self) -> str:
        return self.muxer.mime

    def hello(self) -> dict:
        return {"type": "hello", "codec": self.codec_name,
                "mime": self.mime, "width": self.source.width,
                "height": self.source.height}

    # the websocket handler's session protocol -------------------------

    on_keyframe_request = None     # set by the manager (GOP resync)

    def subscribe(self, maxsize: int = 8) -> asyncio.Queue:
        q = self._subscribers.subscribe(
            [("init", self.init_segment)], maxsize=maxsize, want_key=True)
        self.request_keyframe()    # joiners mid-GOP need an IDR to start
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self._subscribers.unsubscribe(q)

    def close(self) -> None:
        """Drop every subscriber and deregister from the scrape-time
        client/queue-depth gauges (see StreamSession.close)."""
        self._subscribers.close()
        self.journeys.close_book()

    def rebucket(self, sps: bytes, pps: bytes) -> list:
        """Adopt a re-bucketed geometry (elastic failover resolution
        downshift): rebuild the muxer for the source's NEW size and
        return the hello + init items to re-announce so MSE clients
        re-init without renegotiating the websocket.  Runs on the
        encode thread (the swap must land before the next tick's
        fragment); the caller marshals the broadcast to the loop."""
        self.muxer = Mp4Muxer(self.source.width, self.source.height,
                              sps, pps, fps=self.cfg.refresh)
        self.init_segment = self.muxer.init_segment()
        return [("json", self.hello()), ("init", self.init_segment)]

    @property
    def encoder(self):
        return self            # request_keyframe target

    def request_keyframe(self) -> None:
        if self.on_keyframe_request is not None:
            self.on_keyframe_request()   # GOP mode: force the next IDR

    # One forced IDR per window (the StreamSession.request_idr
    # contract): in GOP mode request_keyframe fans out through the
    # manager to EVERY co-tenant session's next frame, so an unlimited
    # PLI storm here has the largest blast radius in the system.
    IDR_MIN_INTERVAL_S = 1.0

    def request_idr(self, reason: str = "manual") -> bool:
        """Rate-limited, deduped forced-IDR (PLI/FIR, degrade rung).
        The hub has no encode loop of its own, so an over-limit
        request defers via ``loop.call_later`` instead of a tick."""
        M_IDR_REQUESTS.labels(reason).inc()
        now = time.monotonic()
        if now - self._idr_last_grant >= self.IDR_MIN_INTERVAL_S:
            self._idr_last_grant = now
            self._idr_deferred = False
            self.request_keyframe()
            return True
        if not self._idr_deferred:
            self._idr_deferred = True
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                pass                     # no loop: collapse silently —
            else:                        # the next grantable call wins
                loop.call_later(
                    self.IDR_MIN_INTERVAL_S
                    - (now - self._idr_last_grant),
                    self._grant_deferred_idr)
        return False

    def _grant_deferred_idr(self) -> None:
        if not self._idr_deferred:
            return
        self._idr_deferred = False
        self._idr_last_grant = time.monotonic()
        self.request_keyframe()

    def stats_summary(self) -> dict:
        s = self.stats.summary()
        s.update({"codec": self.codec_name, "width": self.source.width,
                  "height": self.source.height,
                  "clients": len(self._subscribers)})
        return s

    def publish(self, fragment: bytes, keyframe: bool = True,
                fid: int = 0) -> None:
        if self._subscribers.publish(("frag", fragment, keyframe, fid),
                                     keyframe=keyframe):
            # a slow client lost its keyframe; request_idr's shared
            # rate window keeps one stalled client from storming every
            # co-tenant session's GOP
            self.request_idr("evict")


def _host(t) -> np.ndarray:
    """A step's output on the host (the device wait and the pull)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class BatchStreamManager:
    """One encode loop batch-encoding every session's frames on the card
    (``device`` None; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: Config, sources: List, loop=None,
                 injectors: Optional[List] = None, device=None):
        from ..parallel import batch

        self.cfg = cfg
        self.device = resolve_device(device)
        self.loop = loop
        self.sources = sources
        w, h = sources[0].width, sources[0].height
        # One compiled step serves one PADDED geometry; sessions may differ
        # in raw size within the same MB-padded bucket (each hub's own SPS
        # carries its crop window).  Mixed padded geometries are composed
        # by BucketedStreamManager.
        probe = self._make_probe(w, h)
        self._probe = probe
        probes = [probe if (s.width, s.height) == (w, h)
                  else self._make_probe(s.width, s.height)
                  for s in sources]
        if any((p.pad_h, p.pad_w) != (probe.pad_h, probe.pad_w)
               for p in probes):
            raise ValueError("batched sessions share one padded geometry "
                             "(see BucketedStreamManager for mixed buckets)")
        if cfg.codec != "tpuh264enc":
            # The batched steps are the CAVLC pipeline; other codec
            # selections serve it (with this warning) rather than failing
            # N sessions.
            log.warning("WEBRTC_ENCODER=%s is not batchable; multi-session "
                        "mode serves h264_cavlc", cfg.webrtc_encoder)

        injectors = injectors or [None] * len(sources)
        self.hubs = []
        self._hub_headers = []
        for src, inj, pr in zip(sources, injectors, probes):
            nals = split_annexb(pr.headers())
            sps = next(n for n in nals if (n[0] & 0x1F) == 7)
            pps = next(n for n in nals if (n[0] & 0x1F) == 8)
            self.hubs.append(SessionHub(cfg, src, sps, pps, "h264_cavlc",
                                        injector=inj))
            self._hub_headers.append(pr.headers())
        self._hub_probes = probes

        # the devices a mesh could plan over: every card (or the CPU when
        # asked for); the port serves the one-device plan (1, 1)
        ndev = (torch.cuda.device_count() if self.device.type == "cuda"
                else 1)
        # the failover pool: the bucket runs on self.device alone, so a
        # lost chip has no spare device to move to (re-planning sessions
        # onto other cards comes with the multi-device mesh, ROADMAP
        # queue 1 item 11)
        self._all_devices = [self.device]
        shape = cfg.mesh_shape
        total = int(np.prod(shape))
        if total > ndev or len(shape) > 2:
            log.warning("TPU_MESH %s needs %d devices, have %d; using 1",
                        shape, total, ndev)
            shape = (1, 1)
        if len(shape) == 1:
            shape = (shape[0], 1)
        if len(sources) % shape[0] != 0:
            # the session batch must divide over the session axis;
            # shrink the axis to the largest divisor that fits.
            ns = shape[0]
            while ns > 1 and len(sources) % ns != 0:
                ns -= 1
            log.warning("%d sessions not divisible over %d-way session "
                        "axis; using %d", len(sources), shape[0], ns)
            shape = (ns, shape[1])
        nx = shape[1]
        if probe.pad_h % (16 * nx) != 0:
            log.warning("height %d cannot split over %d spatial shards; "
                        "using 1", probe.pad_h, nx)
            shape = (shape[0], 1)
        # spatial planning (ENCODER_SPATIAL_SHARDS): when the knob asks
        # for — or "auto" models — more than one chip per session and
        # TPU_MESH did not already pin a spatial extent, replan_mesh
        # trades the session axis for spatial shards: eight 1080p
        # sessions stay one-per-chip on the session axis, one 4K
        # session spreads its MB rows across the chips its modeled
        # per-chip cost demands (fleet/capacity.chips_for_session)
        shape = self._plan_spatial_extent(cfg, probe, shape, ndev)
        self._check_plan(shape)
        # elastic failover state: the full device pool minus devices
        # marked dead; a mesh_chip_lost event re-plans onto the survivors
        self._dead_devices: list = []
        self._native_geom = (w, h)
        self._rebuilds = 0
        self.mesh_shape = tuple(shape)
        # GOP over the mesh needs the context-parallel P step (reference
        # halo exchange); geometry that can't donate the halo serves
        # all-intra instead.
        self.gop = max(int(cfg.encoder_gop), 1)
        if self.gop > 1 and not batch.p_halo_feasible(probe.pad_h, shape[1]):
            log.warning("spatial shards too short for the P-frame halo; "
                        "multi-session mode serves all-intra")
            self.gop = 1
        self.step, self.rows_local = batch.h264_batch_encode_step(
            probe.pad_h, probe.pad_w, qp=cfg.encoder_qp,
            with_recon=self.gop > 1, device=self.device)
        self.p_step = None
        # GOP-chunk super-step (ENCODER_SUPERSTEP_CHUNK): P ticks stage
        # host-side and a full chunk runs as ONE replay of a captured CUDA
        # graph (parallel/batch.h264_p_chunk_batch_step); 0 = per tick
        self.chunk = (max(2, min(int(getattr(cfg, "encoder_chunk", 0)), 6))
                      if getattr(cfg, "encoder_chunk", 0) >= 2
                      and self.gop > 1 else 0)
        self.chunk_step = None
        self._stage: list = []           # staged (ys, cbs, crs, frame_num)
        self._stage_hdr_cache = {}
        if self.gop > 1:
            self.p_step, _ = batch.h264_p_batch_step(
                probe.pad_h, probe.pad_w, qp=cfg.encoder_qp,
                device=self.device)
            if self.chunk:
                self.chunk_step, _ = batch.h264_p_chunk_batch_step(
                    probe.pad_h, probe.pad_w, self.chunk, qp=cfg.encoder_qp,
                    device=self.device)
        self.headers = probe.headers()
        self._batch = batch
        self._refs = None                    # the device reference planes
        self._gop_pos = 0
        self._frame_num = 0
        self._idr_count = 0
        self._force_idr = False
        self._p_hdr_cache = {}
        self._tracer = tracer("batch")
        self._m_idr_ticks = _M_BATCH_TICKS.labels("idr")
        self._m_p_ticks = _M_BATCH_TICKS.labels("p")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_tick = time.monotonic()   # loop liveness (healthz)
        self._last_seqs = [-1] * len(sources)
        # the first batched ticks build the kernels and capture the chunk
        # graph; don't let the liveness probe read that as a stall (see
        # StreamSession.COMPILE_GRACE_S)
        self._healthz_grace_until = time.monotonic() + 180.0
        # consecutive organic tick failures escalate to chip-lost
        # re-bucketing (same machinery as the mesh_chip_lost injection)
        from ..resilience.policy import CircuitBreaker
        self._tick_breaker = CircuitBreaker(failure_threshold=5,
                                            reset_timeout_s=5.0)
        # fleet-wide degrade ladder (fleet/scheduler backpressure hook):
        # the event loop queues a level, the encode thread applies it
        # between ticks (muxer swaps must land there)
        self._pending_degrade: Optional[int] = None
        self._degrade_level = 0
        # wired unconditionally: in all-intra mode the forced-IDR flag
        # still WAKES the damage-gated loop so a joiner on a static
        # desktop gets its first (intra) frame
        for hub in self.hubs:
            hub.on_keyframe_request = self.request_keyframe_all
        # declare the serving context so the ledger's measured costs are
        # attributable to a geometry x session count — what the fleet
        # capacity model (fleet/capacity) divides by.  Multi-bucket
        # deployments overwrite each other here (one global ledger);
        # last bucket wins, which is the conservative larger-geometry
        # one under the bucket ordering.
        self._set_ledger_context()
        # flight-recorder postmortems embed the mesh picture (same
        # last-bucket-wins convention as the ledger context above)
        from ..obs import flight as obsf
        obsf.register_state_provider("mesh", self.stats_summary)

    def _make_probe(self, w: int, h: int) -> H264Encoder:
        """The bucket's header/geometry/colour source: never encodes, so
        the process-wide encoder knobs are pinned off."""
        return H264Encoder(w, h, qp=self.cfg.encoder_qp, mode="cavlc",
                           superstep_chunk=0, spatial_shards="0",
                           tune="off", damage_mask=False, device=self.device)

    def _plan_spatial_extent(self, cfg, probe, shape, ndev):
        """Resolve the mesh's spatial extent from ENCODER_SPATIAL_SHARDS.
        Only engages when the operator's TPU_MESH left the spatial axis
        at 1.  With one device the shape stays as it is (the reference's
        result there), decided before the knob is read; with more, a knob
        asking for spatial shards raises: the spatial path (rows
        15e-15h, and the capacity model "auto" reads) is not ported."""
        knob = str(getattr(cfg, "encoder_spatial_shards", "0") or "0")
        knob = knob.strip()
        if shape[1] != 1 or knob in ("0", "1", "off", "") or ndev <= 1:
            return shape
        raise NotImplementedError(
            f"ENCODER_SPATIAL_SHARDS={knob!r} over {ndev} devices is not "
            "ported to the PyTorch/CUDA package yet (ROADMAP queue 1 item "
            "11, the spatial rows 15e-15h)")

    def _check_plan(self, shape) -> None:
        """The port serves the one-device plan (1, 1); a mesh over more
        devices raises instead of quietly serving something else."""
        if int(np.prod(shape)) > 1:
            raise NotImplementedError(
                f"a {shape[0]} session x {shape[1]} spatial mesh over "
                f"{int(np.prod(shape))} devices is not ported to the "
                "PyTorch/CUDA package yet (ROADMAP queue 1 item 11)")

    def _set_ledger_context(self) -> None:
        from ..obs.budget import LEDGER
        LEDGER.set_context(self._probe.width, self._probe.height,
                           self.cfg.refresh, sessions=len(self.sources))

    def session(self, idx: int):
        return self.hubs[idx] if 0 <= idx < len(self.hubs) else None

    def stats_summary(self) -> dict:
        return {"sessions": [h.stats_summary() for h in self.hubs],
                "mesh": list(self.mesh_shape),
                "dead_chips": len(self._dead_devices),
                "mesh_rebuilds": self._rebuilds,
                "degrade_level": self._degrade_level,
                "geometry": f"{self._probe.width}x{self._probe.height}"}

    def surviving_chips(self) -> int:
        """Live chip count (the fleet scheduler's capacity input)."""
        return len(self._surviving())

    def applied_degrade_level(self) -> int:
        """The degrade rung ACTUALLY serving (the fleet scheduler's
        capacity-model input — a refused re-bucket must not let modeled
        capacity rise on a geometry shrink that never happened)."""
        return self._degrade_level

    # -- encode loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="batch-encode")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=15)
            self._thread = None

    def close(self) -> None:
        """Stop the encode loop and release every hub's observability
        state (scrape-time gauges over subscriber sets)."""
        self.stop()
        for hub in self.hubs:
            hub.close()
        from ..obs.budget import LEDGER
        LEDGER.clear_context()

    def _planes(self, rgb, i: int = 0):
        probe = self._hub_probes[i]
        planes = probe._host_yuv420(rgb)
        if planes is not None:
            return planes
        # no cv2, or an odd geometry: the device conversion (K9)
        return tuple(_host(p) for p in probe._device_colour(rgb))

    def _run(self) -> None:
        frame_interval = 1.0 / max(self.cfg.refresh, 1)
        while not self._stop.is_set():
            spec = rfaults.fire("mesh_chip_lost")
            if spec is not None:
                self.mark_chip_dead(int(spec.get("chip", -1)))
            pend = self._pending_degrade
            if pend is not None:
                self._pending_degrade = None
                self._apply_degrade_level(pend)
            t0 = time.perf_counter()
            frames = []
            # a pending forced IDR (new joiner) overrides the damage gate:
            # static desktops must still produce the un-gating keyframe
            changed = self._force_idr
            for i, src in enumerate(self.sources):
                rgb, seq = src.frame()
                changed |= seq != self._last_seqs[i]
                self._last_seqs[i] = seq
                frames.append(rgb)
            has_clients = any(h._subscribers for h in self.hubs)
            if not changed:
                # legitimate idleness = liveness progress (healthz);
                # staged super-step frames must not strand — flush the
                # partial chunk through the per-tick step first
                if self._stage:
                    try:
                        with self._batch.DEVICE_LOCK:
                            flushed = self._chunk_flush()
                        for flat, idr, jmeta in flushed:
                            self._deliver_tick(
                                flat, idr,
                                (time.perf_counter() - t0) * 1e3,
                                jmeta)
                    except Exception:
                        log.exception("partial-chunk flush failed; "
                                      "forcing IDR resync")
                        self._stage.clear()
                        self._force_idr = True
                self._last_tick = time.monotonic()
                time.sleep(frame_interval / 4 if has_clients
                           else min(frame_interval * 4, 0.25))
                continue
            planes = [self._planes(f, i) for i, f in enumerate(frames)]
            ys = np.stack([p[0] for p in planes])
            cbs = np.stack([p[1] for p in planes])
            crs = np.stack([p[2] for p in planes])
            try:
                with self._batch.DEVICE_LOCK:
                    results = self._encode_tick(ys, cbs, crs)
            except Exception:
                # consecutive tick failures = a chip is actually gone
                # (organic analog of the mesh_chip_lost injection):
                # re-bucket onto the survivors instead of spinning
                self._tick_breaker.record_failure()
                self._stage.clear()          # staged frames died too
                self._force_idr = True
                if (self._tick_breaker.state == "open"
                        and len(self._surviving()) > 1):
                    # probe each survivor so the EVICTED chip is the one
                    # that actually stopped answering — blindly dropping
                    # the last chip would shed healthy capacity while
                    # the dead one keeps poisoning every tick
                    victim = self._probe_dead_chip()
                    log.exception("batch encode failed %d times; marking "
                                  "chip %s dead and re-bucketing",
                                  self._tick_breaker.consecutive_failures,
                                  victim)
                    self.mark_chip_dead(victim)
                    self._tick_breaker.record_success()
                else:
                    log.exception("batch encode failed; dropping tick")
                time.sleep(frame_interval)
                continue
            self._tick_breaker.record_success()
            t_enc = (time.perf_counter() - t0) * 1e3
            delivered = False
            for flat, idr, jmeta in results:
                delivered |= self._deliver_tick(flat, idr, t_enc, jmeta)
            if delivered:
                self._last_tick = time.monotonic()   # progress (healthz)
            elapsed = time.perf_counter() - t0
            sleep = frame_interval - elapsed
            if sleep > 0:
                time.sleep(sleep if has_clients
                           else min(sleep * 4, 0.25))

    def _deliver_tick(self, flat, idr: bool, t_enc: float,
                      jmeta: Optional[dict] = None) -> bool:
        """Assemble + publish one tick's AUs for every hub; returns
        whether anything was delivered (healthz progress).  ``jmeta``
        carries the super-step chunk identity so every hub's journey
        amortizes the chunk's one dispatch honestly."""
        from ..bitstream import h264 as syn

        t_now = time.perf_counter()
        shards = int(self.mesh_shape[1])
        delivered = False
        for i, hub in enumerate(self.hubs):
            try:
                au = self._batch.assemble_session_h264(
                    flat[i], self.rows_local,
                    headers=self._hub_headers[i] if idr else b"",
                    nal_type=None if idr else syn.NAL_SLICE,
                    ref_idc=3 if idr else 2)
            except self._batch.ShardOverflow:
                log.warning("session %d: shard overflow; frame dropped",
                            i)
                self._force_idr = True   # resync the GOP next tick
                continue
            frag = hub.muxer.fragment(au, keyframe=idr)
            hub.stats.record_frame(t_enc, len(frag))
            # per-hub journey: capture approximated by tick start (the
            # batch path has no per-hub capture stamp), chunk identity
            # shared across the whole batch tick
            fid = next_frame_id()
            hub.journeys.mint(fid, t_capture=t_now - t_enc / 1e3)
            meta = dict(jmeta) if jmeta else {}
            meta.setdefault("shards", shards)
            # the chunk's slot-0 frame carries the whole chunk's device
            # cost (mirrors the super-step ring: staged frames cost ~0);
            # amortization spreads it back over the chunk at export
            dev = (t_enc if not meta.get("chunk_id")
                   or meta.get("slot", 0) == 0 else 0.0)
            hub.journeys.complete(fid, t_now, device_ms=dev, meta=meta)
            self._post(hub, frag, idr, fid)
            delivered = True
        return delivered

    def _encode_tick(self, ys, cbs, crs):
        """One capture tick -> list of (flat_shards, is_idr) AU batches,
        advancing the GOP state machine (intra-only when gop == 1).

        Per-tick mode returns exactly one entry.  Super-step mode
        (``self.chunk``) STAGES P ticks host-side and returns [] until
        the chunk fills, then dispatches the whole chunk as one device
        program and returns its ``chunk`` frames at once; an IDR due
        with a partial stage flushes the stage through the per-tick
        step first (byte-identical path)."""
        t0 = time.perf_counter()
        idr = (self.gop == 1 or self._gop_pos == 0 or self._force_idr
               or self._refs is None)
        if not idr and self.chunk_step is not None:
            return self._chunk_stage_tick(ys, cbs, crs, t0)
        out = []
        if self._stage:
            # IDR due with a partial chunk staged: flush it per-tick so
            # the ring never straddles the reference-chain reset
            out.extend(self._chunk_flush())
        fid = next_frame_id()
        if idr:
            self._force_idr = False
            self._gop_pos = 0
            self._frame_num = 0
            # Consecutive IDR AUs must carry different idr_pic_id
            # (H.264 7.4.3) — alternate parity like the single-session
            # encoder's _idr_count % 2.
            step_out = self.step(ys, cbs, crs,
                                 idr_parity=self._idr_count & 1)
            self._idr_count += 1
            if self.gop > 1:
                flat, ry, rcb, rcr = step_out
                self._refs = (ry, rcb, rcr)
            else:
                flat = step_out
        else:
            self._frame_num = (self._frame_num + 1) % 16
            hv, hl = self._p_hdr(self._frame_num)
            flat, ry, rcb, rcr = self.p_step(
                ys, cbs, crs, *self._refs, hv, hl)
            self._refs = (ry, rcb, rcr)
        if self.gop > 1:
            self._gop_pos = (self._gop_pos + 1) % self.gop
        # the launches are asynchronous; the pull is the device wait +
        # transfer
        t_sub = time.perf_counter()
        flat_np = _host(flat)
        t_col = time.perf_counter()
        _M_BATCH_SUBMIT.observe((t_sub - t0) * 1e3)
        _M_BATCH_COLLECT.observe((t_col - t_sub) * 1e3)
        (self._m_idr_ticks if idr else self._m_p_ticks).inc()
        self._tracer.record_marks(fid, (
            ("device-submit", t0), ("device-dispatch", t_sub),
            ("device-collect", t_col)), meta=(("session", "batch"),))
        out.append((flat_np, idr, None))
        return out

    # -- GOP-chunk super-step staging (parallel/batch chunk step) ------

    def _chunk_stage_tick(self, ys, cbs, crs, t0: float):
        self._frame_num = (self._frame_num + 1) % 16
        self._gop_pos = (self._gop_pos + 1) % self.gop
        self._stage.append((ys, cbs, crs, self._frame_num))
        if len(self._stage) < self.chunk:
            return []
        stage, self._stage = self._stage, []
        fid = next_frame_id()
        ys_c = np.stack([s[0] for s in stage], axis=1)
        cbs_c = np.stack([s[1] for s in stage], axis=1)
        crs_c = np.stack([s[2] for s in stage], axis=1)
        hv, hl = self._chunk_hdrs(tuple(s[3] for s in stage))
        # one graph replay: it reads the references and writes new ones
        # (double-buffered), and overwrites the previous replay's flats —
        # pulled below, and released, before the next chunk
        flats, ry, rcb, rcr = self.chunk_step(
            ys_c, cbs_c, crs_c, *self._refs, hv, hl)
        self._refs = (ry, rcb, rcr)
        t_sub = time.perf_counter()
        try:
            flat_np = _host(flats)             # (S, K, nx, L)
        finally:
            # a failed pull drops the chunk (the tick's error path forces
            # an IDR); the next chunk may overwrite these outputs either way
            self.chunk_step.release()
        t_col = time.perf_counter()
        _M_BATCH_SUBMIT.observe((t_sub - t0) * 1e3)
        _M_BATCH_COLLECT.observe((t_col - t_sub) * 1e3)
        self._m_p_ticks.inc(len(stage))
        # chunk=/chunk_len= args name this super-step lane in the
        # Chrome export — a chunk tick is one span covering K frames
        self._tracer.record_marks(fid, (
            ("device-submit", t0), ("device-dispatch", t_sub),
            ("device-collect", t_col)),
            meta=(("session", "batch"), ("chunk", fid),
                  ("chunk_len", len(stage))))
        return [(flat_np[:, k], False,
                 {"chunk_id": fid, "slot": k, "chunk_len": len(stage)})
                for k in range(len(stage))]

    def _chunk_flush(self):
        """Push a PARTIAL chunk through the per-tick P step (IDR due or
        idle drain) — byte-identical to the chunk path, so this is a
        pure latency/dispatch decision."""
        stage, self._stage = self._stage, []
        out = []
        for ys, cbs, crs, fn in stage:
            hv, hl = self._p_hdr(fn)
            flat, ry, rcb, rcr = self.p_step(
                ys, cbs, crs, *self._refs, hv, hl)
            self._refs = (ry, rcb, rcr)
            self._m_p_ticks.inc()
            # flushed frames went per-tick: unchunked journey identity
            # (the chunk-flush boundary must not fake an amortized span)
            out.append((_host(flat), False, None))
        return out

    def _chunk_hdrs(self, fns: tuple):
        """K frames' slice-header slots stacked on the scan axis
        (cached per frame_num sequence — bounded by the mod-16 cycle)."""
        got = self._stage_hdr_cache.get(fns)
        if got is None:
            hvs, hls = zip(*(self._p_hdr(fn) for fn in fns))
            got = (np.stack(hvs), np.stack(hls))
            self._stage_hdr_cache[fns] = got
        return got

    def _p_hdr(self, frame_num: int):
        slots = self._p_hdr_cache.get(frame_num)
        if slots is None:
            from ..ops import cavlc_device
            hv, hl = cavlc_device.slice_header_slots(
                self._probe.mb_h, self._probe.mb_w, frame_num=frame_num,
                slice_type=5, idr=False)
            slots = (np.asarray(hv), np.asarray(hl))
            self._p_hdr_cache[frame_num] = slots
        return slots

    def request_keyframe_all(self) -> None:
        self._force_idr = True

    # -- fleet-wide degrade (fleet/scheduler backpressure hook) --------

    def request_degrade_level(self, level: int) -> None:
        """Queue a degrade-ladder level (0 = native) for EVERY session
        in the bucket: the MB-snapped resolution downshift grows the
        modeled sessions-per-chip so admission capacity rises before
        anyone is shed.  Applied by the encode thread between ticks."""
        self._pending_degrade = int(level)

    def _apply_degrade_level(self, level: int) -> None:
        """Encode-thread half of :meth:`request_degrade_level`: rebuild
        the bucket at the requested rung (same machinery as the elastic
        chip-loss re-bucket — geometry, steps, recovery IDR, client
        re-announce), tracked so restores are idempotent.  The level is
        FLOORED at the elastic chip-loss recommendation: a backpressure
        RESTORE must never rebuild at a geometry a shrunken mesh cannot
        sustain (the mirror of the floor inside _rebuild_mesh)."""
        batch = self._batch
        level = max(int(level), batch.elastic_degrade_level(
            len(self.sources), len(self._surviving())))
        level = max(0, min(level, len(batch.DEGRADE_SCALES) - 1))
        if level == self._degrade_level:
            return
        if self._rebucket_target(level) is None:
            # refusal known up front (resize off, non-uniform sources,
            # or already serving that geometry): the rebuild would cost
            # a recompile + fleet-wide recovery IDR for zero capacity.
            # When the mesh already serves the rung's geometry, claim
            # the level so stats stay honest and the no-op guard holds.
            nw, nh = self._native_geom
            if batch.degraded_geometry(nw, nh, level) == (
                    self._probe.width, self._probe.height):
                self._degrade_level = level
            return
        log.warning("fleet degrade: re-bucketing all %d sessions to "
                    "ladder level %d", len(self.sources), level)
        # _rebuild_mesh records _degrade_level itself — and only when
        # the re-bucket genuinely applied
        self._rebuild_mesh(self._surviving(), level=level)

    # -- elastic multichip failover (resilience/continuity leg 2) ------

    def _surviving(self) -> list:
        return [d for d in self._all_devices if d not in self._dead_devices]

    def _probe_dead_chip(self) -> int:
        """Index (into the surviving list) of the first device that fails
        a tiny put/pull round-trip, or -1 when every device answers (a
        collective failure — evict the last, the least-disruptive
        default for the prefix-assignment rebuild)."""
        for i, dev in enumerate(self._surviving()):
            try:
                torch.zeros(1, dtype=torch.uint8, device=dev).cpu()
            except Exception:
                return i
        return -1

    def mark_chip_dead(self, chip: int = -1) -> None:
        """Declare one mesh chip lost and re-bucket onto the survivors.

        ``chip`` indexes the CURRENT surviving list (-1 = the last chip,
        the default the fault injection uses).  Runs on the encode
        thread between ticks; sessions displaced off the dead chip
        restart from their host-side GOP checkpoint (the counters below
        — ``_gop_pos``/``_frame_num``/``_idr_count`` — ARE that
        checkpoint; only the device-resident reference planes died) via
        the recovery IDR the rebuild forces."""
        surviving = self._surviving()
        if len(surviving) <= 1:
            log.error("mesh chip lost with no spare device; keeping the "
                      "current mesh and hoping for a reset")
            return
        idx = chip if 0 <= chip < len(surviving) else len(surviving) - 1
        dead = surviving.pop(idx)
        self._dead_devices.append(dead)
        _M_MESH_CHIPS.set(len(self._dead_devices))
        log.warning("mesh chip %s lost; re-bucketing %d sessions onto "
                    "%d surviving chips", dead, len(self.sources),
                    len(surviving))
        obsev.emit("chip-loss", point=str(dead),
                   survivors=len(surviving),
                   sessions=len(self.sources))
        self._rebuild_mesh(surviving)

    def _rebuild_mesh(self, surviving: list, level: int = None) -> None:
        """Rebuild the batch step(s) over an (N-1)-device plan.

        The halo-exchange neighbor pairs are derived from the new
        spatial extent inside ``h264_p_batch_step``, so rebuilding the
        step IS the halo rewire.  GOP lineage (idr_pic_id parity,
        frame_num phase) carries over on the host; the reference planes
        are gone with the old mesh, so the next tick is a recovery IDR
        for every session in the bucket.

        ``level`` pins the degrade-ladder rung (the fleet backpressure
        path); None derives it from the chip:session ratio (the elastic
        chip-loss path)."""
        batch = self._batch
        probe = self._probe
        want_nx = self.mesh_shape[1]
        if level is None:
            # chip loss must never UNDO a fleet-backpressure rung: the
            # elastic recommendation floors at the level already engaged
            level = max(batch.elastic_degrade_level(len(self.sources),
                                                    len(surviving)),
                        self._degrade_level)
        if level or self._degrade_level:
            # level 0 through this branch RESTORES native geometry
            # (degraded_geometry(native, 0) == native)
            self._maybe_rebucket_geometry(level)
            probe = self._probe              # may have changed
        ns, nx = batch.replan_mesh(len(self.sources), len(surviving),
                                   probe.pad_h, want_nx=want_nx)
        self._check_plan((ns, nx))
        self.mesh_shape = (ns, nx)
        self.step, self.rows_local = batch.h264_batch_encode_step(
            probe.pad_h, probe.pad_w, qp=self.cfg.encoder_qp,
            with_recon=self.gop > 1, device=self.device)
        self.p_step = None
        self.chunk_step = None
        if self.gop > 1:
            if batch.p_halo_feasible(probe.pad_h, nx):
                self.p_step, _ = batch.h264_p_batch_step(
                    probe.pad_h, probe.pad_w, qp=self.cfg.encoder_qp,
                    device=self.device)
                if self.chunk:
                    self.chunk_step, _ = batch.h264_p_chunk_batch_step(
                        probe.pad_h, probe.pad_w, self.chunk,
                        qp=self.cfg.encoder_qp, device=self.device)
            else:
                log.warning("re-bucketed spatial shards too short for "
                            "the P halo; bucket serves all-intra now")
                self.gop = 1
        # displaced sessions restart from the checkpoint: counters kept,
        # the reference RING and any staged chunk died with the old mesh
        # -> re-seed: next tick is a recovery IDR whose recon re-seeds
        # the reference planes on the new plan
        self._refs = None
        self._stage.clear()
        self._force_idr = True
        self._p_hdr_cache.clear()
        self._stage_hdr_cache.clear()
        self._rebuilds += 1
        # track the rung ACTUALLY serving (both the chip-loss and the
        # backpressure path land here): a stale level would misreport
        # stats and let the next request_degrade_level pass the no-op
        # guard into a redundant recompile + IDR burst.  Only claim the
        # rung when the re-bucket really applied (it refuses when
        # resize is off or sources are non-uniform).
        gw, gh = batch.degraded_geometry(*self._native_geom, level)
        if (probe.width, probe.height) == (gw, gh):
            self._degrade_level = level
        _M_MESH_REBUILDS.inc()
        obsev.emit("mesh-rebuild", point=f"{ns}x{nx}",
                   chips=len(surviving), level=level,
                   geometry=f"{probe.width}x{probe.height}")
        # the rebuilt chunk step captures its graph on its first chunk;
        # the liveness probe must ride that out like any codec rebuild
        self._healthz_grace_until = time.monotonic() + 180.0
        log.warning("mesh rebuilt: (%d session x %d spatial) over %d "
                    "chips%s; recovery IDR queued for all sessions",
                    ns, nx, len(surviving),
                    f", degrade level {level}" if level else "")

    def _rebucket_target(self, level: int, verbose: bool = True):
        """``(w, h)`` the bucket would serve at this rung, or None when
        the re-bucket cannot apply: already at that geometry, resizing
        disabled, or sessions not uniformly resizable (mixed raw sizes
        would degrade into DIFFERENT buckets, breaking the one-compiled-
        step invariant).  The backpressure path checks this BEFORE
        committing to a mesh rebuild — a refused re-bucket must not cost
        a recompile and a fleet-wide recovery IDR for zero capacity."""
        batch = self._batch
        nw, nh = self._native_geom
        w, h = batch.degraded_geometry(nw, nh, level)
        # uniformity is judged against the CURRENT bucket geometry, not
        # the native one — after a first rebucket the sources sit at the
        # previous degrade level and must still be eligible for the next
        cur = (self._probe.width, self._probe.height)
        if (w, h) == cur:
            return None
        if not self.cfg.webrtc_enable_resize:
            if verbose:
                log.warning("degrade level %d wants %dx%d but "
                            "WEBRTC_ENABLE_RESIZE is off; keeping "
                            "current geometry", level, w, h)
            return None
        if not all(hasattr(s, "resize") for s in self.sources) or any(
                (s.width, s.height) != cur for s in self.sources):
            if verbose:
                log.warning("sessions not uniformly resizable; keeping "
                            "current geometry")
            return None
        return (w, h)

    def _maybe_rebucket_geometry(self, level: int) -> None:
        """Shed resolution through the MB-snapped degrade ladder so the
        survivors carry the extra sessions-per-chip within budget (see
        :meth:`_rebucket_target` for when this refuses)."""
        target = self._rebucket_target(level)
        if target is None:
            return
        w, h = target
        nw, nh = self._native_geom
        log.warning("re-bucketing geometry %dx%d -> %dx%d (degrade "
                    "level %d)", self._probe.width, self._probe.height,
                    w, h, level)
        for src in self.sources:
            src.resize(w, h)
        probe = self._make_probe(w, h)
        self._probe = probe
        self._hub_probes = [probe] * len(self.sources)
        # measured us/MB must be attributed to the NEW bucket geometry
        self._set_ledger_context()
        nals = split_annexb(probe.headers())
        sps = next(n for n in nals if (n[0] & 0x1F) == 7)
        pps = next(n for n in nals if (n[0] & 0x1F) == 8)
        self.headers = probe.headers()
        self._hub_headers = [probe.headers()] * len(self.hubs)
        for hub in self.hubs:
            items = hub.rebucket(sps, pps)   # muxer swap: encode thread
            if self.loop is not None:        # client announce: loop
                self.loop.call_soon_threadsafe(
                    hub._subscribers.broadcast_all, items)
            else:
                hub._subscribers.broadcast_all(items)

    def _post(self, hub: SessionHub, fragment: bytes,
              keyframe: bool, fid: int = 0) -> None:
        if self.loop is not None:
            self.loop.call_soon_threadsafe(hub.publish, fragment,
                                           keyframe, fid)
        else:
            hub.publish(fragment, keyframe, fid)


class BucketedStreamManager:
    """Mixed-geometry multi-session serving (SURVEY.md §7 M5 hard part #3).

    The steps serve one padded geometry, so sessions are BUCKETED by their
    MB-padded geometry: every bucket gets its own
    :class:`BatchStreamManager` (its own steps and encode loop);
    sessions whose raw sizes pad to the same (pad_h, pad_w) share a bucket
    and differ only in their SPS crop window.  The device serializes the
    buckets' dispatches, so capacity is shared rather than partitioned.

    Global session indices keep their order across buckets — the
    ``/ws?session=i`` contract is unchanged."""

    def __init__(self, cfg: Config, sources: List, loop=None,
                 injectors: Optional[List] = None, device=None):
        from ..utils.mathutil import round_up

        injectors = injectors or [None] * len(sources)
        order = {}                      # (pad_h, pad_w) -> [global idx]
        for i, s in enumerate(sources):
            key = (round_up(s.height, 16), round_up(s.width, 16))
            order.setdefault(key, []).append(i)
        self.managers = []
        self._hub_of = {}               # global idx -> (manager, local idx)
        for key, idxs in order.items():
            mgr = BatchStreamManager(
                cfg, [sources[i] for i in idxs], loop=loop,
                injectors=[injectors[i] for i in idxs], device=device)
            for local, gi in enumerate(idxs):
                self._hub_of[gi] = (mgr, local)
            self.managers.append(mgr)
        log.info("bucketed %d sessions into %d geometry buckets: %s",
                 len(sources), len(self.managers),
                 {f"{k[1]}x{k[0]}": len(v) for k, v in order.items()})

    def session(self, idx: int):
        ent = self._hub_of.get(idx)
        return ent[0].session(ent[1]) if ent else None

    def start(self) -> None:
        for m in self.managers:
            m.start()

    def stop(self) -> None:
        for m in self.managers:
            m.stop()

    def close(self) -> None:
        for m in self.managers:
            m.close()

    def request_degrade_level(self, level: int) -> None:
        """Fleet backpressure applies to every bucket at once: degrading
        one bucket would punish its sessions without relieving the
        shared device (the dispatches serialize across buckets)."""
        for m in self.managers:
            m.request_degrade_level(level)

    def surviving_chips(self) -> int:
        # buckets share ONE device pool; the stalest view is the truth
        return min(m.surviving_chips() for m in self.managers)

    def applied_degrade_level(self) -> int:
        # conservative across buckets: the bucket still at the highest
        # quality bounds how much capacity degradation really freed
        return min(m.applied_degrade_level() for m in self.managers)

    def stats_summary(self) -> dict:
        # report sessions in GLOBAL index order (the /ws?session=i
        # numbering), not bucket order — monitoring must agree with serving
        per = {id(m): m.stats_summary() for m in self.managers}
        sessions = []
        for gi in sorted(self._hub_of):
            mgr, local = self._hub_of[gi]
            entry = dict(per[id(mgr)]["sessions"][local])
            entry["session"] = gi
            sessions.append(entry)
        return {"sessions": sessions,
                "buckets": [{"mesh": p["mesh"],
                             "sessions": len(p["sessions"])}
                            for p in per.values()]}

    # healthz liveness: the freshest bucket tick counts as progress only
    # if EVERY bucket is alive; report the stalest.
    @property
    def _last_tick(self):
        return min(m._last_tick for m in self.managers)

    @property
    def _healthz_grace_until(self):
        return max(m._healthz_grace_until for m in self.managers)


# -- state carried across (tests and hand-over) ---------------------------

def _buckets(manager) -> list:
    return list(getattr(manager, "managers", None) or [manager])


def export_batch_state(manager) -> list:
    """One dict per bucket of a batch manager (the port's or the
    reference's: only the attributes both keep are read) — the GOP
    counters and the reference planes as host arrays.  A manager with
    chunk frames staged has state on the host that no counter carries:
    that raises."""
    out = []
    for m in _buckets(manager):
        if m._stage:
            raise ValueError("a chunk is staged: flush it before exporting")
        refs = None
        if m._refs is not None:
            refs = tuple(np.array(r.cpu() if isinstance(r, torch.Tensor)
                                  else r) for r in m._refs)
        out.append({"gop_pos": int(m._gop_pos),
                    "frame_num": int(m._frame_num),
                    "idr_count": int(m._idr_count),
                    "force_idr": bool(m._force_idr), "refs": refs})
    return out


def import_batch_state(manager, states: list) -> None:
    """Set :func:`export_batch_state`'s dicts (from the reference's
    manager of the same buckets, in the same order, or the port's) on a
    port manager: its next tick then emits the bytes the exporting
    manager's would."""
    mgrs = _buckets(manager)
    if len(states) != len(mgrs):
        raise ValueError(f"{len(states)} bucket states for {len(mgrs)} "
                         "buckets")
    for m, st in zip(mgrs, states):
        refs = st.get("refs")
        if refs is not None:
            want = (len(m.sources), m._probe.pad_h, m._probe.pad_w)
            if tuple(np.shape(refs[0])) != want:
                raise ValueError(f"reference planes {np.shape(refs[0])} "
                                 f"do not fit the bucket {want}")
            refs = tuple(torch.from_numpy(np.ascontiguousarray(r, np.uint8))
                         .to(m.device) for r in refs)
        m._stage.clear()
        m._gop_pos = int(st["gop_pos"])
        m._frame_num = int(st["frame_num"])
        m._idr_count = int(st["idr_count"])
        m._force_idr = bool(st.get("force_idr", False))
        m._refs = refs
