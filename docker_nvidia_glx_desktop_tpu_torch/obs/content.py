"""Content & quality telemetry plane (the port of the reference's
``obs/content.py``): what the encoder produced — luma PSNR of the
closed-loop recon, the per-MB frame-diff damage fraction, the
skip/inter/intra mode mix, |MV| stats, coded-bits split and MB activity
percentiles.

Feeding: ``models/h264`` launches the ``ops/content_stats`` kernels (K4,
K4c) inside its submit and hands the per-frame dict it pulls at collect
(``pop_content_stats``) to the serving loop (``web/session``), which
calls :meth:`ContentPlane.record`.  Surfaces: per-session
``dngd_content_*`` gauges and counters, a ``content-damage-pct`` budget
ledger row, ``psnr_floor_breach`` / ``damage_spike`` events (flight
recorder triggers, with the plane registered as a flight state provider)
and :meth:`ContentPlane.snapshot` (the ``/debug/content`` payload of the
browser layer, ROADMAP item 6b).

Knobs: ``DNGD_CONTENT_SAMPLE`` (stats cadence in frames, default 1),
``DNGD_CONTENT_DAMAGE_THR`` (per-pixel mean-abs-diff damage threshold,
default 2.0), ``DNGD_CONTENT_PSNR_FLOOR`` (dB floor; a single number
or per-tier ``off:30,hq:33`` list), ``DNGD_CONTENT_SPIKE`` (damage
fraction that counts as a spike, default 0.85).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from . import metrics as obsm

__all__ = ["ContentPlane", "PLANE", "set_enabled", "enabled",
           "sample_every", "damage_thr_sad", "psnr_floor",
           "spike_threshold", "snapshot", "render_content_text"]

_WINDOW = 240                    # rolling per-session sample window
_EVENT_DEBOUNCE_S = 5.0          # per-session, per-kind emit spacing

# default per-tier PSNR floors (dB): hq buys quality, so its floor is
# higher; hq_noaq sits between (lambda decisions without the qp plane)
_DEFAULT_FLOORS = {"off": 30.0, "hq": 33.0, "hq_noaq": 32.0}


# ---------------------------------------------------------------------------
# master switch + knobs
# ---------------------------------------------------------------------------

_enabled = True


def set_enabled(v: bool) -> None:
    """Master switch (the bench's content_overhead_pct A/B arm): off
    means the encoders dispatch NO stats work at all."""
    global _enabled
    _enabled = bool(v)


def enabled() -> bool:
    return _enabled


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def sample_every() -> int:
    """Stats cadence in frames (1 = every frame)."""
    try:
        return max(int(os.environ.get("DNGD_CONTENT_SAMPLE", "1") or 1), 1)
    except ValueError:
        return 1


def damage_thr_sad() -> int:
    """Per-MB summed-abs-diff damage threshold: the per-pixel mean knob
    scaled by the 256 px of a macroblock (integer device compare)."""
    return int(round(_env_float("DNGD_CONTENT_DAMAGE_THR", 2.0) * 256))


def psnr_floor(tier: str) -> float:
    """The tier's PSNR floor in dB.  ``DNGD_CONTENT_PSNR_FLOOR`` is a
    single number (every tier) or a ``tier:db`` comma list."""
    raw = os.environ.get("DNGD_CONTENT_PSNR_FLOOR", "").strip()
    floors = dict(_DEFAULT_FLOORS)
    if raw:
        if ":" in raw:
            for part in raw.split(","):
                k, _, v = part.partition(":")
                try:
                    floors[k.strip()] = float(v)
                except ValueError:
                    pass
        else:
            try:
                f = float(raw)
                floors = {k: f for k in floors}
            except ValueError:
                pass
    return floors.get(tier, floors.get("off", 30.0))


def spike_threshold() -> float:
    return _env_float("DNGD_CONTENT_SPIKE", 0.85)


# ---------------------------------------------------------------------------
# metric families (registered at import: /metrics must carry them
# from server boot, web/server imports this module)
# ---------------------------------------------------------------------------

_G_PSNR = obsm.gauge(
    "dngd_content_psnr_db",
    "Per-session luma PSNR of the closed-loop recon vs source, dB "
    "(latest sampled frame; 99 = exact; obs/content)", ("session",))
_G_DAMAGE = obsm.gauge(
    "dngd_content_damage_fraction",
    "Fraction of MBs whose frame-diff vs the previous ingest exceeds "
    "DNGD_CONTENT_DAMAGE_THR (latest sampled frame)", ("session",))
_G_MODE = obsm.gauge(
    "dngd_content_mode_fraction",
    "Per-session MB mode mix of the latest sampled frame (skip is the "
    "zero-MV & uncoded telemetry proxy)", ("session", "mode"))
_G_MV = obsm.gauge(
    "dngd_content_mv_qpel",
    "Per-session |MV| of the latest sampled frame, quarter-pel",
    ("session", "stat"))
_G_ACT = obsm.gauge(
    "dngd_content_mb_activity",
    "ops/aq.mb_activity percentiles of the latest sampled frame "
    "(the AQ / damage-driven-encode substrate)", ("session", "pct"))
_C_BITS = obsm.counter(
    "dngd_content_bits_total",
    "Coded bits by frame type — the served coded-bits split",
    ("session", "frame_type"))
_C_FRAMES = obsm.counter(
    "dngd_content_frames_total",
    "Frames with content stats recorded", ("session",))

# event-kind counter series must exist from boot, not first breach
from . import events as obse  # noqa: E402

obse._M_EVENTS.labels("psnr_floor_breach")
obse._M_EVENTS.labels("damage_spike")


class ContentPlane:
    """Per-session content state: latest sampled stats + rolling
    windows, the event triggers, and the /debug/content payload.

    Thread contract: ``record`` runs on each session's encode thread;
    the /debug endpoints and scrape-time gauge reads run on the event
    loop.  Every shared container is mutated under ``_lock``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._s: Dict[str, dict] = {}

    # -- feeding -------------------------------------------------------

    def _state(self, session: str) -> dict:
        st = self._s.get(session)
        if st is None:
            st = self._s[session] = {
                "last": None, "psnr": deque(maxlen=_WINDOW),
                "damage": deque(maxlen=_WINDOW), "frames": 0,
                "tier": "off", "breach_t": 0.0, "spike_t": 0.0,
                "breaches": 0, "spikes": 0,
            }
            self._bind_gauges(session)
        return st

    def _bind_gauges(self, session: str) -> None:
        def latest(key, default=0.0):
            def read():
                with self._lock:
                    st = self._s.get(session)
                    last = st["last"] if st else None
                v = (last or {}).get(key)
                return default if v is None else float(v)
            return read

        _G_PSNR.labels(session).set_function(latest("psnr_db", -1.0))
        _G_DAMAGE.labels(session).set_function(
            latest("damage_fraction", -1.0))
        for stat in ("mean", "p95"):
            _G_MV.labels(session, stat).set_function(
                latest(f"mv_{stat}_qpel", -1.0))
        for pct in ("p50", "p95"):
            _G_ACT.labels(session, pct).set_function(latest(f"act_{pct}"))
        for mode in ("skip", "inter", "intra"):
            def read_mode(m=mode):
                with self._lock:
                    st = self._s.get(session)
                    last = st["last"] if st else None
                mm = (last or {}).get("mode") or {}
                return float(mm.get(m, -1.0))
            _G_MODE.labels(session, mode).set_function(read_mode)

    def record(self, session: str, stats: dict) -> None:
        """Record one frame's fetched stats dict (encode thread)."""
        session = str(session)
        now = time.time()
        damage = stats.get("damage_fraction")
        psnr = stats.get("psnr_db")
        tier = stats.get("tier") or "off"
        with self._lock:
            st = self._state(session)
            prior = list(st["damage"])
            st["last"] = dict(stats, ts=now)
            st["tier"] = tier
            st["frames"] += 1
            if psnr is not None:
                st["psnr"].append(float(psnr))
            if damage is not None:
                st["damage"].append(float(damage))
        _C_FRAMES.labels(session).inc()
        bits = stats.get("au_bytes")
        if bits:
            _C_BITS.labels(session,
                           stats.get("frame_type", "p")).inc(bits * 8)
        # ledger annotation: a free-standing stage row (NOT a frame
        # stage — it is a content fraction, not wall-clock)
        if damage is not None:
            try:
                from .budget import LEDGER
                LEDGER.record_content(damage)
            except Exception:
                pass
        self._maybe_events(session, st, psnr, damage, tier, prior)

    def _maybe_events(self, session, st, psnr, damage, tier,
                      prior) -> None:
        from . import events as obse_

        now = time.perf_counter()
        if psnr is not None:
            floor = psnr_floor(tier)
            if psnr < floor and now - st["breach_t"] > _EVENT_DEBOUNCE_S:
                with self._lock:
                    st["breach_t"] = now
                    st["breaches"] += 1
                obse_.emit("psnr_floor_breach", session=session,
                           psnr_db=round(psnr, 2), floor_db=floor,
                           tier=tier)
        if damage is not None:
            thr = spike_threshold()
            # a spike is a DEPARTURE: it needs calm history to depart
            # from — a fresh session or a steadily-busy desktop sitting
            # at high damage is workload, not an anomaly
            calm_before = (bool(prior)
                           and float(np.median(prior[-30:])) <= thr / 2)
            if (damage >= thr and calm_before
                    and now - st["spike_t"] > _EVENT_DEBOUNCE_S):
                with self._lock:
                    st["spike_t"] = now
                    st["spikes"] += 1
                obse_.emit("damage_spike", session=session,
                           damage_fraction=round(damage, 3),
                           threshold=thr)

    def drop(self, session: str) -> None:
        """Session teardown: a closed session's series must not be
        exported stale forever (metrics cardinality contract)."""
        session = str(session)
        with self._lock:
            self._s.pop(session, None)
        _G_PSNR.remove(session)
        _G_DAMAGE.remove(session)
        for stat in ("mean", "p95"):
            _G_MV.remove(session, stat)
        for pct in ("p50", "p95"):
            _G_ACT.remove(session, pct)
        for mode in ("skip", "inter", "intra"):
            _G_MODE.remove(session, mode)
        _C_FRAMES.remove(session)
        for ft in ("p", "intra", "key"):
            _C_BITS.remove(session, ft)

    def clear(self) -> None:
        with self._lock:
            names = list(self._s)
        for s in names:
            self.drop(s)

    # -- scrape-time views ---------------------------------------------

    def mean_damage_fraction(self) -> Optional[float]:
        """Fleet-mean rolling damage fraction (the capacity model's
        snapshot figure), or None before any sample."""
        with self._lock:
            vals = [float(np.mean(st["damage"]))
                    for st in self._s.values() if st["damage"]]
        return float(np.mean(vals)) if vals else None

    def damage_charge(self, session: str) -> Optional[float]:
        """The damage fraction admission should CHARGE this session:
        ``max(latest sample, p95 of the rolling window)``, clipped to
        1.  The p95 term keeps spike-recovery headroom priced in — a
        desktop that bursts to full-frame damage every few seconds is
        charged near its burst, not its calm median — while the
        latest term raises the charge the moment a fresh spike lands.
        None before any damage sample (callers fall back to full
        cost: unknown workloads are charged conservatively)."""
        with self._lock:
            st = self._s.get(str(session))
            if not st or not st["damage"]:
                return None
            vals = np.asarray(st["damage"], np.float64)
        return float(min(max(float(vals[-1]),
                             float(np.percentile(vals, 95))), 1.0))

    def quality_state(self) -> Dict[str, dict]:
        """Per-session rolling PSNR vs the tier floor — the SLO quality
        plane's input (obs/slo merges this into /debug/slo)."""
        out = {}
        with self._lock:
            items = [(s, st["tier"], list(st["psnr"]), st["breaches"])
                     for s, st in self._s.items()]
        for s, tier, psnrs, breaches in items:
            floor = psnr_floor(tier)
            if psnrs:
                p50 = float(np.percentile(psnrs, 50))
                p5 = float(np.percentile(psnrs, 5))
                verdict = "ok" if p50 >= floor else "breach"
            else:
                p50 = p5 = None
                verdict = "no-data"
            out[s] = {"tier": tier, "floor_db": floor, "psnr_p50": p50,
                      "psnr_p5": p5, "n": len(psnrs),
                      "breaches": breaches, "verdict": verdict}
        return out

    def snapshot(self, brief: bool = False) -> dict:
        """The ``/debug/content?format=json`` payload (and, with
        ``brief``, the flight recorder's embedded content block — the
        grid dropped so dumps stay small)."""
        from ..ops import content_stats as cs

        sessions = {}
        with self._lock:
            items = list(self._s.items())
        for s, st in items:
            last = dict(st["last"]) if st["last"] else None
            if last is not None:
                grid = last.pop("damage_grid", None)
                if not brief and grid is not None:
                    g = cs.downsample_grid(grid)
                    last["damage_grid_shape"] = list(
                        np.asarray(grid).shape)
                    last["damage_grid"] = np.round(
                        np.nan_to_num(g), 3).tolist()
            psnrs = list(st["psnr"])
            dmg = list(st["damage"])
            sessions[s] = {
                "last": last,
                "frames": st["frames"],
                "tier": st["tier"],
                "psnr_floor_db": psnr_floor(st["tier"]),
                "breaches": st["breaches"],
                "spikes": st["spikes"],
                "rolling": {
                    "n": len(psnrs),
                    "psnr_p50": (round(float(np.percentile(psnrs, 50)),
                                       2) if psnrs else None),
                    "psnr_p5": (round(float(np.percentile(psnrs, 5)), 2)
                                if psnrs else None),
                    "damage_p50": (round(float(np.percentile(dmg, 50)),
                                         4) if dmg else None),
                    "damage_p95": (round(float(np.percentile(dmg, 95)),
                                         4) if dmg else None),
                },
            }
        return {"enabled": _enabled,
                "sample_every": sample_every(),
                "damage_thr_sad": damage_thr_sad(),
                "spike_threshold": spike_threshold(),
                "sessions": sessions,
                "quality": self.quality_state()}


PLANE = ContentPlane()


def snapshot() -> dict:
    return PLANE.snapshot()


_HEAT = " .:-=+*#%@"


def render_content_text(plane: Optional[ContentPlane] = None) -> str:
    """The human-readable ``/debug/content`` payload: per-session stat
    lines + the current frame's MB damage grid as an ASCII heatmap."""
    p = plane if plane is not None else PLANE
    snap = p.snapshot()
    lines = ["content & quality telemetry plane "
             "(?format=json for the full payload)",
             f"enabled={snap['enabled']} "
             f"sample_every={snap['sample_every']} "
             f"damage_thr_sad={snap['damage_thr_sad']}", ""]
    if not snap["sessions"]:
        lines.append("(no sessions with content stats yet)")
    for s, st in sorted(snap["sessions"].items()):
        last = st.get("last") or {}
        q = snap["quality"].get(s, {})
        psnr = last.get("psnr_db")
        dmg = last.get("damage_fraction")
        mode = last.get("mode") or {}
        lines.append(
            f"session {s} [{st['tier']}] frames={st['frames']} "
            f"verdict={q.get('verdict')} floor={st['psnr_floor_db']} dB")
        lines.append(
            f"  psnr={psnr if psnr is None else round(psnr, 2)} dB "
            f"(p50 {st['rolling']['psnr_p50']})  "
            f"damage={dmg if dmg is None else round(dmg, 3)} "
            f"(p50 {st['rolling']['damage_p50']})  "
            f"skip/inter/intra="
            f"{'/'.join(str(round(mode.get(k, -1), 2)) for k in ('skip', 'inter', 'intra')) if mode else 'n/a'}  "
            f"|mv| mean={last.get('mv_mean_qpel')} "
            f"p95={last.get('mv_p95_qpel')} qpel")
        grid = last.get("damage_grid")
        if grid:
            lines.append("  MB damage heatmap "
                         f"({last.get('damage_grid_shape')} MBs, "
                         "downsampled):")
            for row in grid:
                lines.append("    " + "".join(
                    _HEAT[min(int(v * (len(_HEAT) - 1) + 0.5),
                              len(_HEAT) - 1)] for v in row))
        lines.append("")
    return "\n".join(lines) + "\n"


# flight recorder: postmortems embed the (grid-free) content state next
# to the journeys; psnr_floor_breach/damage_spike are trigger kinds
# (obs/flight.TRIGGER_KINDS), so a quality incident snapshots itself
from . import flight as _flight  # noqa: E402

_flight.register_state_provider(
    "content", lambda: PLANE.snapshot(brief=True))
