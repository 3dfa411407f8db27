"""Fault-injection harness: named failure points, deterministically armed.

Every recovery path in the serving stack guards a *named failure point*:
the code calls :func:`fire` at the exact spot where the real failure
would surface, and when that point is armed the injected failure takes
the identical code path the organic one would.  Disarmed (the steady
state) a ``fire()`` is one dict emptiness check — safe on the encode
hot path.

Canonical points (each names where it fires and what recovery it
exercises):

========================  ==================================================
``device_submit_error``   ``encode_submit`` raises on the encode thread ->
                          frame dropped, breaker-counted, session survives
``collect_timeout``       ``encode_collect`` raises (or, with
                          ``mode="slow"``, stalls by ``delay_ms`` —
                          the sustained-budget-breach injection) ->
                          IDR resync path
``ws_send_stall``         the per-client websocket pump stalls ->
                          queue eviction + slow-subscriber eviction
``turn_refresh_401``      TURN allocation refresh fails 401 ->
                          log-once + bounded re-allocation
``peer_rtcp_loss_burst``  per-peer RTCP loss reads as a 50% burst ->
                          degradation ladder engages
``xserver_gone``          the frame source raises (X server died) ->
                          bounded retry until the supervisor restarts it
``device_preempt``        the device is preempted/reset mid-GOP ->
                          checkpoint restore + recovery IDR, same
                          SSRC/seq/timestamp lineage (continuity)
``mesh_chip_lost``        a multi-session mesh chip drops out ->
                          N->N-1 re-bucket, halo rewire, recovery IDRs
``sctp_drop_burst``       SCTP packet egress swallows N packets ->
                          T3-rtx / fast retransmit redeliver input
``dcep_open_stall``       the DATA_CHANNEL_ACK is delayed delay_ms ->
                          deferred flush completes the channel open
``rtp_loss_burst``        the media wire swallows the next N RTP
                          packets -> NACK/RTX repairs them, zero frame
                          gaps, no IDR (webrtc/feedback + web/impair)
``pli_storm``             the client spams N PLIs in one RTCP arrival
                          -> the session's rate-limited request_idr
                          grants exactly ONE keyframe per window
========================  ==================================================

Arming: :func:`arm` from tests/bench code, ``DNGD_FAULTS=
"collect_timeout=3,ws_send_stall"`` from the environment at import, or
``POST /debug/faults`` when ``DNGD_FAULT_INJECTION`` is truthy (the
non-prod gate) — the POST also sits behind the session's basic auth
(the web middleware auth-exempts only read-only methods); the GET view
is always available.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, Optional

from ..obs import metrics as obsm

log = logging.getLogger(__name__)

__all__ = ["register", "fire", "arm", "disarm", "disarm_all", "points",
           "snapshot", "injection_allowed", "add_fault_routes",
           "CANONICAL_POINTS"]

_M_INJECTED = obsm.counter(
    "dngd_fault_injections_total",
    "Fault-injection firings by failure point", ("point",))


class FaultPoint:
    __slots__ = ("name", "description", "fired")

    def __init__(self, name: str, description: str):
        self.name = name
        self.description = description
        self.fired = 0


_lock = threading.Lock()
_points: Dict[str, FaultPoint] = {}
# name -> {"remaining": int, "params": dict}; EMPTY in production, so the
# hot-path fire() below is a single falsy check
_armed: Dict[str, dict] = {}


def register(name: str, description: str = "") -> FaultPoint:
    """Declare a failure point (idempotent; modules register at import)."""
    with _lock:
        pt = _points.get(name)
        if pt is None:
            pt = _points[name] = FaultPoint(name, description)
        elif description and not pt.description:
            pt.description = description
    return pt


def fire(name: str) -> Optional[dict]:
    """Hot-path check at the failure site.  Returns the armed params
    dict (possibly empty) when this firing should fail, else None.
    Each firing consumes one count; the point auto-disarms at zero."""
    if not _armed:                      # steady state: one falsy check
        return None
    with _lock:
        spec = _armed.get(name)
        if spec is None:
            return None
        spec["remaining"] -= 1
        if spec["remaining"] <= 0:
            del _armed[name]
        pt = _points.get(name)
        if pt is not None:
            pt.fired += 1
    _M_INJECTED.labels(name).inc()
    # timeline + flight-recorder trigger (obs/events -> obs/flight): an
    # injected failure is exactly the moment a postmortem snapshot is
    # worth its cost — this path only runs when the point is ARMED, so
    # the disarmed hot path above stays one falsy check
    try:
        from ..obs import events as obsev
        obsev.emit("fault-fire", point=name,
                   params=dict(spec["params"]) or None)
    except Exception:
        pass
    return spec["params"]


def arm(name: str, count: int = 1, **params) -> dict:
    """Arm ``name`` for the next ``count`` firings with optional params
    (e.g. ``mode="slow", delay_ms=80``).  Unregistered names are
    registered on the fly (tests may declare ad-hoc points)."""
    register(name)
    with _lock:
        spec = {"remaining": max(1, int(count)), "params": dict(params)}
        _armed[name] = spec
    log.info("fault %r armed for %d firing(s) %s", name, spec["remaining"],
             params or "")
    return spec


def disarm(name: str) -> bool:
    with _lock:
        return _armed.pop(name, None) is not None


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def points() -> Dict[str, FaultPoint]:
    return dict(_points)


def armed_count(name: str) -> int:
    """Remaining armed firings for ``name`` (0 when disarmed)."""
    with _lock:
        spec = _armed.get(name)
        return spec["remaining"] if spec else 0


def snapshot() -> dict:
    """The ``GET /debug/faults`` payload."""
    with _lock:
        return {
            "injection_enabled": injection_allowed(),
            "points": {
                name: {
                    "description": pt.description,
                    "fired_total": pt.fired,
                    "armed": name in _armed,
                    "remaining": (_armed[name]["remaining"]
                                  if name in _armed else 0),
                    "params": (_armed[name]["params"]
                               if name in _armed else {}),
                }
                for name, pt in sorted(_points.items())
            },
        }


def injection_allowed(env=None) -> bool:
    """POST-arming gate: only non-prod builds set DNGD_FAULT_INJECTION.
    The in-process API (tests, chaos bench) is always available."""
    env = os.environ if env is None else env
    return env.get("DNGD_FAULT_INJECTION", "").strip().lower() in (
        "1", "true", "yes", "on")


def _arm_from_env(env=None) -> None:
    """``DNGD_FAULTS="collect_timeout=3,ws_send_stall"`` — arm at
    import so container runs can exercise recovery without code."""
    env = os.environ if env is None else env
    raw = env.get("DNGD_FAULTS", "").strip()
    if not raw:
        return
    for part in filter(None, (p.strip() for p in raw.split(","))):
        name, _, cnt = part.partition("=")
        try:
            arm(name.strip(), int(cnt) if cnt else 1)
        except ValueError:
            log.warning("DNGD_FAULTS entry %r invalid; ignored", part)


# -- canonical registry (the chaos bench iterates THIS set) --------------

CANONICAL_POINTS = (
    ("device_submit_error",
     "encode_submit raises on the encode thread; recovery: frame "
     "dropped, circuit-breaker counted, session survives"),
    ("collect_timeout",
     "encode_collect raises TimeoutError (mode=slow: stalls delay_ms "
     "instead — the sustained-budget-breach injection); recovery: "
     "frame dropped, stale P suppressed, forced-IDR resync"),
    ("ws_send_stall",
     "the per-client websocket media pump stalls; recovery: queue "
     "eviction, then slow-subscriber eviction with reconnect grace"),
    ("turn_refresh_401",
     "TURN allocation refresh answers 401; recovery: log-once + "
     "bounded re-allocation with backoff"),
    ("peer_rtcp_loss_burst",
     "per-peer RTCP fraction-lost reads as a 50% burst; recovery: "
     "degradation ladder engages, restores when the burst ends"),
    ("xserver_gone",
     "the frame source raises (X server died); recovery: bounded "
     "retry with backoff until the supervisor brings X back"),
    ("device_preempt",
     "the TPU is preempted/reset mid-GOP: encode_submit raises and the "
     "device-submit breaker trips open at once; recovery: session "
     "re-acquires a device, restores the encoder-state checkpoint "
     "(resilience/continuity), emits a recovery IDR on the SAME "
     "SSRC/sequence/timestamp lineage — a glitch, not a teardown"),
    ("mesh_chip_lost",
     "one chip of the multi-session mesh drops out mid-GOP; recovery: "
     "surviving chips re-bucket (parallel/batch.replan_mesh), halo-"
     "exchange neighbors rewire with the rebuilt step, displaced "
     "sessions restart from their host-side GOP checkpoint via a "
     "recovery IDR instead of dying"),
    ("sctp_drop_burst",
     "the data channel's SCTP packet egress swallows the next N "
     "outbound packets (mid-typing loss burst, webrtc/sctp); recovery: "
     "T3-rtx + fast retransmit redeliver every input event in order — "
     "no lost keystrokes, dngd_sctp_retransmits_total counts"),
    ("dcep_open_stall",
     "the DATA_CHANNEL_ACK answering an inbound DATA_CHANNEL_OPEN is "
     "delayed by delay_ms (webrtc/datachannel); recovery: the deferred "
     "ACK flushes on the next poll and the channel open completes"),
    ("rtp_loss_burst",
     "the media wire tail-drops the next N RTP packets (params: "
     "packets; fires in web/impair.ImpairedLink.send); recovery: the "
     "receiver NACKs the holes, the send-history ring answers with "
     "RTX retransmissions — contiguous frames at the sink, NO "
     "keyframe spent"),
    ("pli_storm",
     "one RTCP arrival dispatches N synthetic PLIs (params: plis; "
     "fires in webrtc/rtcp.PeerRtcpMonitor.ingest); recovery: the "
     "session-level rate-limited request_idr collapses the storm into "
     "exactly one granted IDR per window"),
)

for _name, _desc in CANONICAL_POINTS:
    register(_name, _desc)
_arm_from_env()


# -- /debug/faults (aiohttp; mounted by web/server) ----------------------

def add_fault_routes(app) -> None:
    """``GET /debug/faults`` (always) + ``POST`` (env-gated arming)."""
    from aiohttp import web

    async def get_faults(request):
        return web.json_response(snapshot())

    async def post_faults(request):
        if not injection_allowed():
            return web.json_response(
                {"error": "fault injection disabled; set "
                          "DNGD_FAULT_INJECTION=1 (non-prod builds only)"},
                status=403)
        try:
            body = json.loads(await request.text() or "{}")
        except ValueError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        name = body.get("point", "")
        if not name:
            return web.json_response({"error": "missing 'point'"},
                                     status=400)
        if body.get("action") == "disarm":
            return web.json_response({"disarmed": disarm(name),
                                      "point": name})
        params = body.get("params") or {}
        if not isinstance(params, dict):
            return web.json_response({"error": "'params' must be an "
                                               "object"}, status=400)
        try:
            count = int(body.get("count", 1))
        except (TypeError, ValueError):
            return web.json_response({"error": "'count' must be an "
                                               "integer"}, status=400)
        if {"name", "count"} & set(params):
            return web.json_response(
                {"error": "'params' keys 'name'/'count' are reserved"},
                status=400)
        arm(name, count=count, **params)
        return web.json_response({"armed": name,
                                  "remaining": armed_count(name)})

    app.router.add_get("/debug/faults", get_faults)
    app.router.add_post("/debug/faults", post_faults)
