"""Serving-budget ledger: per-stage latency accounting + SLO gating (the
port of the reference's ``obs/budget.py``).

The north-star metric (BASELINE.md) is END-TO-END: frames/sec per card
with p50 <= 20 ms at 1080p60.  This module turns the per-frame trace
spans into that budget:

- :class:`BudgetLedger` subscribes to the 'pipeline' and 'webrtc' trace
  recorders (obs/trace listener hook) and keeps rolling per-stage latency
  windows; ingestion is deque-appends on the encode thread, summaries are
  computed at scrape time only.
- **Link separation**: :func:`ops.devloop.measure_link_rtt` measures the
  fixed per-dispatch host<->device round-trip (differenced trip counts of
  the K17g probe loop, so device compute cancels).  The ledger subtracts
  it from the collect stage: ``compute_p50 = e2e_p50 - link_rtt``.
- **SLO gating**: the BASELINE ladder rungs are declarative
  :class:`SloRung` specs evaluated at scrape time against the same data,
  exported as ``slo_*`` gauges on ``/metrics`` and rendered with
  per-stage over-budget attribution at ``/debug/budget`` — a regression
  names its stage, not just its total.

Stage names are the trace mark names (a span is named after the mark it
ENDS on, obs/trace contract): ``captured`` (grab + damage compare),
``device-submit`` (host color conversion + async dispatch),
``device-collect`` (pipeline wait + device compute + bitstream pull —
the only link-bearing stage), ``bitstream`` (mux/AU assembly),
``publish`` (fan-out enqueue), plus ``rtp-sent`` spans from the WebRTC
track and per-frame ``total`` (first mark -> last mark).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

from ..utils.timing import percentile
from . import metrics as obsm
from .trace import tracer

__all__ = ["BudgetLedger", "SloRung", "SLO_LADDER", "LEDGER",
           "register_slo_gauges", "render_budget_text",
           "record_bdrate", "bdrate_block", "serving_budget_block",
           "G2G_METHODOLOGY"]

WINDOW = 600              # frames per rolling stage window (~10 s at 60)

# The stage whose duration includes the host<->device link round-trip
# (submit dispatches async; collect blocks on the device AND pulls the
# packed bitstream across the link).
LINK_STAGE = "device-collect"


class SloRung:
    """One BASELINE ladder rung as a declarative budget spec."""

    __slots__ = ("name", "width", "height", "fps", "budget_ms",
                 "sessions")

    def __init__(self, name: str, width: int, height: int, fps: float,
                 budget_ms: float, sessions: int = 1):
        self.name = name
        self.width = width
        self.height = height
        self.fps = fps
        self.budget_ms = budget_ms
        self.sessions = sessions

    def matches(self, width: int, height: int, fps: float,
                sessions: int = 1) -> bool:
        return (self.width == width and self.height == height
                and abs(self.fps - fps) < 1.0
                and self.sessions == sessions)


# BASELINE.md config ladder, budgets = the published p50 bars (1080p60
# <= 20 ms from BASELINE targets; 30 fps rungs get the frame interval).
SLO_LADDER: Tuple[SloRung, ...] = (
    SloRung("720p30", 1280, 720, 30, 33.3),        # rung 1 (noVNC tier)
    SloRung("1080p30", 1920, 1080, 30, 33.3),      # rung 2 (vp8 tier)
    SloRung("1080p60", 1920, 1080, 60, 20.0),      # rung 3 (flagship bar)
    SloRung("4k30", 3840, 2160, 30, 33.3),         # rung 4
    # rung 5: per-session budget over a batched v5e-8 (the sessions
    # field keeps it distinct from rung 3 for active-rung matching)
    SloRung("8x1080p60", 1920, 1080, 60, 20.0, sessions=8),
)


class BudgetLedger:
    """Rolling per-stage latency windows + link separation + SLO verdicts.

    Hot-path contract (same as the rest of obs/): :meth:`_on_trace` runs
    on the encode thread and does deque-appends only; every percentile,
    subtraction and verdict is computed at scrape/render time.
    """

    def __init__(self, window: int = WINDOW):
        self._window = window
        self._stages: Dict[str, deque] = {}
        # stages fed by per-frame MARKS (the serving pipeline proper) vs
        # free-standing spans (rtp-sent, batch-dispatch-*): only the
        # former participate in the compute-floor clamp — a batch span's
        # p50 must not inflate the link-separated compute view
        self._frame_stages: set = set()
        self._lock = threading.Lock()          # guards dict mutation only
        self._link_rtt_ms: Optional[float] = None
        self._link_probe: Optional[dict] = None
        # device-internal stage profile ({"device-me": ms, ...}): the
        # fused device step is ONE span to the host tracer, so ME /
        # deblock / entropy attribution inside it must be FED by a
        # caller of set_device_profile (bench.py does, from the devloop
        # stage loops; a serving process that wants the rows on its
        # /debug/budget calls the same API) — first-class spans here so
        # an over-budget 4K frame attributes to a stage, not "the
        # device"
        self._device_profile: Dict[str, float] = {}
        # per-frame Python->device crossing counts (record_dispatch):
        # the super-step acceptance gauge — per-frame dispatch serves
        # ~1/frame, the GOP-chunk ring ~1/chunk
        self._dispatch_crossings: deque = deque(maxlen=window)
        # serving context (set by the session on codec build): which
        # ladder rung is ACTIVE for this geometry/rate/session-count
        self._ctx: Optional[Tuple[int, int, float, int]] = None
        self._frames = 0
        # summary memo: recomputed only after new data (a /metrics
        # scrape reads ~25 gauge children off ONE summary, not 25)
        self._dirty = True
        self._summary_cache: Dict[str, Dict[str, float]] = {}
        # fired once per NEW stage name (inside the creation lock): the
        # slo_stage_p50_ms gauge binds a child the moment a stage exists
        self.on_new_stage = None

    # -- ingestion (encode thread) -------------------------------------

    def attach(self, *tracer_names: str) -> None:
        """Subscribe to named process tracers ('pipeline', 'webrtc')."""
        for name in tracer_names:
            tracer(name).add_listener(self._on_trace)

    def _stage(self, name: str) -> deque:
        dq = self._stages.get(name)
        if dq is None:
            with self._lock:
                dq = self._stages.get(name)
                if dq is None:
                    dq = self._stages[name] = deque(maxlen=self._window)
                    if self.on_new_stage is not None:
                        try:
                            self.on_new_stage(name)
                        except Exception:
                            pass
        return dq

    def _on_trace(self, kind: str, entry) -> None:
        # entries may carry a trailing meta tuple (obs/trace) — index,
        # don't destructure, so the listener survives entry growth
        if kind == "marks":
            marks = entry[1]
            for (_, t_a), (stage_b, t_b) in zip(marks, marks[1:]):
                self._frame_stages.add(stage_b)
                self._stage(stage_b).append((t_b - t_a) * 1e3)
            if len(marks) >= 2:
                self._stage("total").append(
                    (marks[-1][1] - marks[0][1]) * 1e3)
                self._frames += 1
        else:
            stage, dur = entry[0], entry[2]
            self._stage(stage).append(dur * 1e3)
        self._dirty = True

    def observe_stage(self, stage: str, ms: float,
                      frame_stage: bool = False) -> None:
        """Direct feed for paths without a tracer (tests, batch);
        ``frame_stage`` opts the stage into the compute-floor clamp."""
        if frame_stage:
            self._frame_stages.add(stage)
        self._stage(stage).append(ms)
        self._dirty = True

    def record_dispatch(self, crossings: float, gap_ms: float) -> None:
        """One frame's dispatch accounting: how many Python -> device
        crossings it cost (0 for a super-step ring-staged frame; the
        chunk frame carries the whole chunk's single crossing) and the
        submit-to-launch gap those crossings spent.  The gap lands in
        the free-standing ``dispatch`` stage (NOT a frame stage — it is
        a subset of device-submit, and must not inflate the compute
        floor); crossings keep their own window so the <N crossings
        per frame claim is a scraped gauge."""
        self._dispatch_crossings.append(float(crossings))
        self._stage("dispatch").append(float(gap_ms))
        self._dirty = True

    def record_spatial(self, halo_ms: Optional[float] = None,
                       stitch_ms: Optional[float] = None) -> None:
        """Spatial-shard overhead attribution (single-session mesh
        sharding, parallel/batch spatial steps): ``halo_ms`` is the
        per-step cost of the ppermute reference-halo exchange (fed by
        the bench's halo-on/halo-off differencing — it is fused inside
        the device program and invisible to host tracing), ``stitch_ms``
        the host-side per-AU shard assembly/stitch cost (measured live
        by the encoder's spatial collect).  Both land as free-standing
        ``halo-exchange`` / ``bitstream-stitch`` stages — /debug/budget
        rows and the ``dngd_halo_ms`` / ``dngd_stitch_ms`` gauges — so
        a 4K regression names the leaking sub-stage instead of a
        blended device number.  NOT frame stages: the halo lives inside
        device-collect and the stitch inside bitstream; adding them to
        the compute floor would double-count."""
        if halo_ms is not None:
            self._stage("halo-exchange").append(float(halo_ms))
        if stitch_ms is not None:
            self._stage("bitstream-stitch").append(float(stitch_ms))
        self._dirty = True

    def record_content(self, damage_fraction: float) -> None:
        """Content-plane annotation (obs/content): the frame's per-MB
        damage fraction as a free-standing ``content-damage-pct`` stage
        row (value in PERCENT so the /debug/budget table reads
        naturally next to the ms rows).  NOT a frame stage — it is a
        content property, not wall-clock, and must never enter the
        compute floor.  Since the damage-driven encode landed this row
        is load-bearing: it is the ledger's view of the same fraction
        the mask gates encode work on and the capacity model charges
        admission with (fleet/capacity session_cost_ms(damage=...),
        fleet/placement damage-scaled packing)."""
        self._stage("content-damage-pct").append(
            float(damage_fraction) * 100.0)
        self._dirty = True

    def dispatch_summary(self) -> Optional[dict]:
        """{"crossings_per_frame", "crossings_p50", "gap_ms_p50", "n"}
        over the rolling window, or None before any frame reported."""
        vals = list(self._dispatch_crossings)
        if not vals:
            return None
        s = sorted(vals)
        return {
            "crossings_per_frame": round(sum(vals) / len(vals), 4),
            "crossings_p50": percentile(s, 50),
            "gap_ms_p50": self._stage_p50("dispatch"),
            "n": len(vals),
        }

    # -- context / link probe ------------------------------------------

    def set_context(self, width: int, height: int, fps: float,
                    sessions: int = 1) -> None:
        self._ctx = (int(width), int(height), float(fps), int(sessions))

    def context(self) -> Optional[Tuple[int, int, float, int]]:
        """The serving context, ``(width, height, fps, sessions)``, or
        None before any session declared one.  Public contract for
        consumers modeling costs off this ledger (fleet/capacity)."""
        return self._ctx

    def clear_context(self) -> None:
        """Session teardown: a closed session's geometry must not keep
        matching an SLO rung forever (the slo_active/slo_ok gauges would
        gate on a stream that no longer exists)."""
        self._ctx = None

    def set_link_rtt(self, rtt_ms: float, probe: Optional[dict] = None
                     ) -> None:
        self._link_rtt_ms = float(rtt_ms)
        self._link_probe = probe

    def set_device_profile(self, stages: Dict[str, float]) -> None:
        """Record device-internal stage timings (ms) as first-class
        spans — e.g. {"device-me": 12.1, "device-deblock": 2.3,
        "device-entropy": 5.0} from the devloop stage loops.  They feed
        the ``device-*`` rows of /debug/budget attribution and the
        slo_stage_p50_ms gauges (one observation each; re-calling
        replaces the window so the profile stays current)."""
        for name, ms in stages.items():
            key = name if name.startswith("device-") else f"device-{name}"
            dq = self._stage(key)
            dq.clear()
            dq.append(float(ms))
            self._device_profile[key] = float(ms)
        self._dirty = True

    @property
    def device_profile(self) -> Dict[str, float]:
        return dict(self._device_profile)

    def probe_link(self, device=None) -> dict:
        """Run the devloop link probe (K17g) and record its result.
        ``device`` None is the card (raises without CUDA); ``"cpu"``
        times the plain loop (the 'link' is then dispatch overhead).  A
        probe that fails raises: the ledger never records a made-up rtt."""
        from ..ops import devloop
        res = devloop.measure_link_rtt(device=device)
        self.set_link_rtt(res["rtt_ms"], res)
        return res

    def clear(self) -> None:
        with self._lock:
            self._stages.clear()
            self._frame_stages.clear()
        self._dispatch_crossings.clear()
        self._frames = 0
        self._dirty = True

    # -- scrape-time views ---------------------------------------------

    @property
    def frames(self) -> int:
        return self._frames

    @property
    def link_rtt_ms(self) -> Optional[float]:
        return self._link_rtt_ms

    def stage_summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {p50, p90, p99, n}} over the rolling windows.

        Memoized until new data arrives: one /metrics scrape reads
        ~25 gauge children, and all of them must (and do) share one
        sort pass, not one each."""
        if not self._dirty:
            return self._summary_cache
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            items = list(self._stages.items())
        self._dirty = False        # before the sorts: a concurrent
        for name, dq in items:     # append re-dirties and re-sorts
            vals = sorted(dq)
            if not vals:
                continue
            out[name] = {"p50": round(percentile(vals, 50), 3),
                         "p90": round(percentile(vals, 90), 3),
                         "p99": round(percentile(vals, 99), 3),
                         "n": len(vals)}
        self._summary_cache = out
        return out

    def _stage_p50(self, stage: str, summary=None) -> float:
        s = summary if summary is not None else self.stage_summary()
        return s.get(stage, {}).get("p50", 0.0)

    def e2e_p50_ms(self, summary=None) -> float:
        return self._stage_p50("total", summary)

    def compute_p50_ms(self, summary=None) -> float:
        """End-to-end p50 with the measured link round-trip removed —
        the number a PCIe-attached deployment would see for the same
        pipeline (link cost sits in the collect stage; clamp at the sum
        of the non-link PER-FRAME stages so a noisy probe can't go
        negative — free-standing spans like batch-dispatch-* or
        rtp-sent are NOT part of the capture->publish path and must not
        inflate the floor)."""
        s = summary if summary is not None else self.stage_summary()
        e2e = self.e2e_p50_ms(s)
        if e2e <= 0.0:
            return 0.0
        link = self._link_rtt_ms or 0.0
        floor = sum(v["p50"] for k, v in s.items()
                    if k in self._frame_stages and k != LINK_STAGE)
        return round(max(e2e - link, min(floor, e2e)), 3)

    def active_rung(self) -> Optional[SloRung]:
        if self._ctx is None:
            return None
        w, h, fps, sessions = self._ctx
        for rung in SLO_LADDER:
            if rung.matches(w, h, fps, sessions):
                return rung
        # off-ladder geometry: synthesize a frame-interval budget so the
        # gauges still gate (custom rungs never hide a regression)
        name = (f"custom_{w}x{h}@{fps:g}" if sessions == 1
                else f"custom_{sessions}x{w}x{h}@{fps:g}")
        return SloRung(name, w, h, fps,
                       round(1000.0 / max(fps, 1.0), 1),
                       sessions=sessions)

    def evaluate(self) -> dict:
        """Every rung's verdict from the current windows (scrape time).

        A rung verdict: {"budget_ms", "p50_ms" (link-separated compute),
        "e2e_p50_ms", "margin_ms", "ok", "active", "attribution"} where
        ``ok`` is None until any frame was measured and ``attribution``
        lists stages by p50 descending with their share of the budget —
        the "which stage regressed" answer.
        """
        summary = self.stage_summary()
        e2e = self.e2e_p50_ms(summary)
        compute = self.compute_p50_ms(summary)
        active = self.active_rung()
        stages = [(k, v["p50"]) for k, v in summary.items()
                  if k not in ("total",)]
        stages.sort(key=lambda kv: kv[1], reverse=True)
        out = {"frames": self._frames,
               "link_rtt_ms": self._link_rtt_ms,
               "e2e_p50_ms": e2e,
               "compute_p50_ms": compute,
               "stages": summary,
               "dispatch": self.dispatch_summary(),
               "device_profile": dict(self._device_profile),
               "rungs": {}}
        for rung in SLO_LADDER + ((active,) if active is not None
                                  and active.name.startswith("custom_")
                                  else ()):
            measured = self._frames > 0
            ok = (compute <= rung.budget_ms) if measured else None
            attribution = [
                {"stage": name, "p50_ms": p50,
                 "budget_pct": round(p50 / rung.budget_ms * 100.0, 1)}
                for name, p50 in stages] if measured else []
            out["rungs"][rung.name] = {
                "budget_ms": rung.budget_ms,
                "geometry": f"{rung.width}x{rung.height}@{rung.fps:g}",
                "p50_ms": compute,
                "e2e_p50_ms": e2e,
                "margin_ms": (round(rung.budget_ms - compute, 3)
                              if measured else None),
                "ok": ok,
                "active": (active is not None
                           and rung.name == active.name),
                "attribution": attribution,
            }
        return out

    def snapshot(self) -> dict:
        """The `serving_budget` JSON block (BENCH + /stats embedding).

        ``glass_to_glass`` embeds the frame-journey books' client-closed
        view (obs/journey): the ``delivery`` stage row above is the same
        data as a free-standing stage — distinct from compute (encoder
        stages) and from link-RTT (the device probe).  ``bdrate`` embeds
        the last recorded perceptual-efficiency result (bench --bdrate /
        record_bdrate) so a /stats scrape shows which tuning tier this
        rung's kbps figure was bought at."""
        ev = self.evaluate()
        ev["link_probe"] = self._link_probe
        ev["window"] = self._window
        g2g = _journey_summary()
        if g2g:
            ev["glass_to_glass"] = g2g
        bd = bdrate_block()
        if bd:
            ev["bdrate"] = bd
        return ev


def _journey_summary() -> dict:
    """All live journey books' glass-to-glass blocks (one fetch shared
    by snapshot() and render_budget_text); {} when none exist."""
    try:
        from . import journey as obsj
        return obsj.global_summary()
    except Exception:
        return {}


_BDRATE: dict = {}


def record_bdrate(block: dict) -> None:
    """Publish a BD-rate bench result into the ledger snapshot
    (``bdrate.*``): bench.py --bdrate calls this before snapshotting so
    BENCH artifacts and the serving /stats endpoint carry the tuning
    tier's measured bits-per-quality evidence next to the SLO verdicts."""
    global _BDRATE
    _BDRATE = dict(block)


def bdrate_block() -> dict:
    return _BDRATE


G2G_METHODOLOGY = (
    "client-ack over the loopback ws (fprobe/ack echo, closure at "
    "server receipt — includes the ack uplink); stock clients without "
    "an ack path close via RTCP RR extended-highest-seq at now - rtt/2")


def serving_budget_block(ledger: Optional["BudgetLedger"] = None,
                         session: Optional[str] = None) -> dict:
    """THE ``serving_budget`` block — the one emitter behind
    ``/debug/budget?format=json``, ``/stats`` and bench.py's BENCH
    lines.  (bench and the endpoint previously built overlapping blocks
    through separate code paths; two renderings of "the" budget that
    can drift are worse than none.)

    Wraps :meth:`BudgetLedger.snapshot` and normalizes the journey
    view: ``glass_to_glass`` is the single live book's flattened
    summary (closed/by_method/p50_ms at top level, annotated with the
    sampling cadence and closure methodology) when exactly one book
    exists or ``session`` names one; with several live books the keyed
    per-session dict is kept under ``glass_to_glass_sessions``.
    """
    led = ledger if ledger is not None else LEDGER
    ev = led.snapshot()
    raw = ev.pop("glass_to_glass", None)
    if isinstance(raw, dict) and raw:
        flat = None
        if session is not None:
            flat = raw.get(session)
        if flat is None and len(raw) == 1:
            flat = next(iter(raw.values()))
        if flat is not None:
            try:
                from . import journey as obsj
                se = obsj.sample_every()
            except Exception:
                se = None
            ev["glass_to_glass"] = dict(
                flat, sample_every=se, methodology=G2G_METHODOLOGY)
        if flat is None or len(raw) > 1:
            ev["glass_to_glass_sessions"] = raw
    return ev


LEDGER = BudgetLedger()
# The session's encode thread feeds tracer('pipeline'); the WebRTC peer
# feeds tracer('webrtc') rtp-sent spans; the multi-session path feeds
# tracer('batch') dispatch spans.  Attaching here (import time) means
# any process that imports obs.budget gets the accounting without
# per-callsite wiring.
LEDGER.attach("pipeline", "webrtc", "batch")


def register_slo_gauges(ledger: Optional[BudgetLedger] = None,
                        registry=None) -> None:
    """Create the scrape-time ``slo_*`` gauge families over ``ledger``.

    All values are computed inside gauge set_functions at scrape time —
    zero hot-path cost, always-current verdicts.  Families:

    - ``slo_budget_ms{rung=}``     the rung's declarative budget;
    - ``slo_p50_ms{rung=}``        link-separated compute p50;
    - ``slo_e2e_p50_ms{rung=}``    raw end-to-end p50 (link included);
    - ``slo_margin_ms{rung=}``     budget - p50 (negative = over);
    - ``slo_ok{rung=}``            1 ok / 0 over-budget / -1 no data OR
      rung not active — so ``slo_ok == 0`` is alertable as-is: a pod
      serving 720p30 within budget never pages the 1080p60 rung (the
      would-pass view for inactive rungs stays on ``slo_margin_ms``);
    - ``slo_active{rung=}``        1 on the rung matching the session;
    - ``slo_stage_p50_ms{stage=}`` per-stage p50 (the attribution);
    - ``slo_link_rtt_ms``          the probe's round-trip estimate.
    """
    led = ledger if ledger is not None else LEDGER
    reg = registry if registry is not None else obsm.REGISTRY

    g_budget = obsm.gauge("slo_budget_ms",
                          "Declarative p50 budget of a BASELINE ladder "
                          "rung", ("rung",), registry=reg)
    g_p50 = obsm.gauge("slo_p50_ms",
                       "Link-separated compute p50 evaluated against the "
                       "rung", ("rung",), registry=reg)
    g_e2e = obsm.gauge("slo_e2e_p50_ms",
                       "Raw end-to-end p50 (link included)", ("rung",),
                       registry=reg)
    g_margin = obsm.gauge("slo_margin_ms",
                          "budget_ms - p50_ms (negative = over budget)",
                          ("rung",), registry=reg)
    g_ok = obsm.gauge("slo_ok",
                      "SLO verdict: 1 ok, 0 over budget, -1 no data yet",
                      ("rung",), registry=reg)
    g_active = obsm.gauge("slo_active",
                          "1 when the rung matches the serving geometry",
                          ("rung",), registry=reg)
    g_stage = obsm.gauge("slo_stage_p50_ms",
                         "Per-stage rolling p50 feeding the SLO verdicts "
                         "(over-budget attribution)", ("stage",),
                         registry=reg)
    g_link = obsm.gauge("slo_link_rtt_ms",
                        "Measured host<->device round-trip per dispatch "
                        "(ops/devloop probe; subtracted from collect)",
                        registry=reg)
    g_disp = obsm.gauge(
        "dngd_dispatch_crossings_per_frame",
        "Mean Python->device dispatch crossings per encoded frame over "
        "the rolling window (~1 on the per-frame path, ~1/chunk under "
        "the super-step ring; the ROADMAP item 2 acceptance gauge)",
        registry=reg)
    g_disp_gap = obsm.gauge(
        "dngd_dispatch_gap_ms",
        "p50 submit-to-launch gap per frame (the Python dispatch cost "
        "inside device-submit)", registry=reg)

    g_halo = obsm.gauge(
        "dngd_halo_ms",
        "p50 spatial-shard reference-halo exchange cost per step "
        "(ppermute inside the sharded device program; fed by the bench "
        "halo-on/off differencing via BudgetLedger.record_spatial)",
        registry=reg)
    g_stitch = obsm.gauge(
        "dngd_stitch_ms",
        "p50 host-side bitstream stitch/assembly cost per spatially-"
        "sharded AU (per-shard NAL concat / CABAC record-stream row "
        "stitch)", registry=reg)
    g_halo.set_function(lambda: led._stage_p50("halo-exchange"))
    g_stitch.set_function(lambda: led._stage_p50("bitstream-stitch"))

    def _disp_read(which: str):
        def read() -> float:
            d = led.dispatch_summary()
            if d is None:
                return 0.0
            return d["crossings_per_frame" if which == "x" else
                     "gap_ms_p50"]
        return read

    g_disp.set_function(_disp_read("x"))
    g_disp_gap.set_function(_disp_read("gap"))

    def rung_fn(rung: SloRung, which: str):
        def read() -> float:
            if which == "budget":
                return rung.budget_ms
            measured = led.frames > 0
            if which == "ok":
                active = led.active_rung()
                if (not measured or active is None
                        or active.name != rung.name):
                    return -1.0     # no data / not this pod's rung
                return 1.0 if led.compute_p50_ms() <= rung.budget_ms \
                    else 0.0
            if which == "active":
                active = led.active_rung()
                return 1.0 if (active is not None
                               and active.name == rung.name) else 0.0
            if not measured:
                return 0.0
            if which == "p50":
                return led.compute_p50_ms()
            if which == "e2e":
                return led.e2e_p50_ms()
            return rung.budget_ms - led.compute_p50_ms()    # margin
        return read

    for rung in SLO_LADDER:
        g_budget.labels(rung.name).set_function(rung_fn(rung, "budget"))
        g_p50.labels(rung.name).set_function(rung_fn(rung, "p50"))
        g_e2e.labels(rung.name).set_function(rung_fn(rung, "e2e"))
        g_margin.labels(rung.name).set_function(rung_fn(rung, "margin"))
        g_ok.labels(rung.name).set_function(rung_fn(rung, "ok"))
        g_active.labels(rung.name).set_function(rung_fn(rung, "active"))
    g_link.set_function(lambda: led.link_rtt_ms or 0.0)

    # Per-stage children are bound the moment the ledger first sees a
    # stage (the stage set isn't known until frames flow).
    def bind_stage(stage: str) -> None:
        g_stage.labels(stage).set_function(
            lambda s=stage: led._stage_p50(s))

    led.on_new_stage = bind_stage
    for stage in list(led.stage_summary()):     # stages seen pre-register
        bind_stage(stage)


register_slo_gauges()


def render_budget_text(ledger: Optional[BudgetLedger] = None) -> str:
    """The human-readable ``/debug/budget`` payload."""
    led = ledger if ledger is not None else LEDGER
    ev = led.evaluate()
    lines = ["serving budget ledger"
             f" — {ev['frames']} frames in window",
             ""]
    link = ev["link_rtt_ms"]
    lines.append(f"link rtt/dispatch : "
                 f"{'unprobed' if link is None else f'{link:.3f} ms'}"
                 f"  (stage '{LINK_STAGE}' carries it)")
    lines.append(f"e2e p50           : {ev['e2e_p50_ms']:.3f} ms "
                 "(capture -> publish, link included)")
    lines.append(f"compute p50       : {ev['compute_p50_ms']:.3f} ms "
                 "(link-separated: what a PCIe-attached chip would see)")
    disp = ev.get("dispatch")
    if disp:
        lines.append(
            f"dispatch          : {disp['crossings_per_frame']:.3f} "
            f"Python crossings/frame (p50 {disp['crossings_p50']:g}), "
            f"launch gap p50 {disp['gap_ms_p50']:.3f} ms over "
            f"{disp['n']} frames")
    lines.append("")
    lines.append(f"{'stage':<16} {'p50 ms':>9} {'p90 ms':>9} "
                 f"{'p99 ms':>9} {'n':>5}")
    for name, s in sorted(ev["stages"].items(),
                          key=lambda kv: -kv[1]["p50"]):
        lines.append(f"{name:<16} {s['p50']:>9.3f} {s['p90']:>9.3f} "
                     f"{s['p99']:>9.3f} {s['n']:>5}")
    lines.append("")
    lines.append(f"{'rung':<22} {'budget':>8} {'p50':>9} {'margin':>9} "
                 f"{'verdict':>8}")
    for name, r in ev["rungs"].items():
        verdict = ("no-data" if r["ok"] is None
                   else "OK" if r["ok"] else "OVER")
        active = " *" if r["active"] else ""
        margin = ("-" if r["margin_ms"] is None
                  else f"{r['margin_ms']:.2f}")
        lines.append(f"{name + active:<22} {r['budget_ms']:>8.1f} "
                     f"{r['p50_ms']:>9.3f} {margin:>9} {verdict:>8}")
    # over-budget attribution for the active (or first failing) rung
    worst = next((r for r in ev["rungs"].values()
                  if r["active"] and r["ok"] is not None), None)
    if worst is None:
        worst = next((r for r in ev["rungs"].values()
                      if r["ok"] is False), None)
    if worst is not None and worst["attribution"]:
        lines.append("")
        lines.append("attribution (stage p50 as % of "
                     f"{worst['budget_ms']:.1f} ms budget):")
        for a in worst["attribution"]:
            bar = "#" * min(60, int(a["budget_pct"] * 0.6))
            lines.append(f"  {a['stage']:<16} {a['p50_ms']:>9.3f} ms "
                         f"{a['budget_pct']:>6.1f}%  {bar}")
    if ev.get("device_profile"):
        lines.append("")
        lines.append("device stage profile (devloop; inside the fused "
                     "device step — attributes ME/deblock/entropy):")
        for name, ms in sorted(ev["device_profile"].items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"  {name:<16} {ms:>9.3f} ms")
    g2g = _journey_summary()
    if g2g:
        lines.append("")
        lines.append("glass-to-glass (obs/journey — closed at the "
                     "CLIENT; 'delivery' above is the same data as a "
                     "stage, distinct from compute and link-rtt):")
        for sid, s in sorted(g2g.items()):
            if not s["closed"]:
                lines.append(f"  {sid:<10} no closed journeys "
                             f"({s['open']} open, frontier "
                             f"{s['frontier_fid']})")
                continue
            methods = ",".join(f"{m}:{n}"
                               for m, n in sorted(s["by_method"].items()))
            verdict = {1.0: "OK", 0.0: "OVER"}.get(s["slo_ok"],
                                                   "no-rung")
            lines.append(
                f"  {sid:<10} p50 {s['p50_ms']:>8.3f}  "
                f"p95 {s['p95_ms']:>8.3f}  p99 {s['p99_ms']:>8.3f} ms  "
                f"delivery p50 {s['delivery_p50_ms'] or 0:>7.3f} ms  "
                f"({s['closed']} closed via {methods})  {verdict}")
    lines.append("")
    lines.append("* = rung matching the live serving geometry; verdicts "
                 "gate on compute p50 (link separated).")
    return "\n".join(lines) + "\n"
