"""Session continuity under device loss: checkpoint cadence, device
re-acquisition, and drain coordination.

The policy and fault modules make the serving path *react* to failure;
this module makes the state *survive* it.  Three pieces:

- :class:`CheckpointKeeper` — host-side, bounded-memory snapshots of an
  encoder's :meth:`~..models.base.Encoder.export_state` on a configurable
  cadence (``DNGD_CKPT_INTERVAL``).  Only the latest checkpoint is kept
  (one dict + the reference planes of one frame), so memory is bounded
  regardless of session lifetime.
- :func:`restore_encoder` — rebuild an encoder from config on the
  current (reset or replacement) device, verify the device actually
  answers, and import the checkpoint.  The session keeps its muxer,
  media clock, subscriber set and AU listeners across the swap, so the
  client-visible stream keeps its SSRC, RTP sequence lineage and
  timestamp timeline — recovery surfaces as one IDR-sized glitch, not a
  renegotiation.
- :class:`DrainState` — the graceful-drain flag the web layer flips on
  SIGTERM or ``POST /debug/drain``: stop admitting sessions, tell
  connected clients (``("draining")`` control item) so they can
  pre-connect elsewhere, flush in-flight frames, then exit.

The recovery loop itself lives in ``web/session.py`` (it owns the encode
thread); this module supplies the policy-free mechanics so they are unit
testable without a device or an event loop.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from ..obs import metrics as obsm

log = logging.getLogger(__name__)

__all__ = ["CheckpointKeeper", "restore_encoder", "record_recovery",
           "DrainState"]

_M_SNAPSHOTS = obsm.counter(
    "dngd_ckpt_snapshots_total",
    "Encoder-state checkpoints taken (resilience/continuity)")
_M_SNAPSHOT_FAIL = obsm.counter(
    "dngd_ckpt_snapshot_failures_total",
    "Checkpoint attempts that raised (device already unreachable)")
_M_RECOVERIES = obsm.counter(
    "dngd_session_recoveries_total",
    "Device-loss recoveries completed (encoder restored from checkpoint, "
    "recovery IDR emitted on the same stream lineage)")
_M_RECOVERY_MS = obsm.histogram(
    "dngd_session_recovery_ms",
    "Wall time from device declared lost to restored encoder ready")
_M_DRAINING = obsm.gauge(
    "dngd_draining", "1 while the server is draining (SIGTERM or "
    "POST /debug/drain); new sessions are refused")


class CheckpointKeeper:
    """Latest-wins encoder-state snapshots on a monotonic cadence.

    ``interval_s <= 0`` disables snapshotting (``state`` stays None and
    recovery falls back to a bare recovery IDR with no lineage restore).
    ``maybe_snapshot`` is called from the encode loop between frames; the
    due-check is one clock read, so calling it every iteration is free.
    """

    def __init__(self, interval_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = float(interval_s)
        self._clock = clock
        self.state: Optional[dict] = None
        self.taken_at: Optional[float] = None
        self.count = 0
        self._warned = False

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    @property
    def age_s(self) -> Optional[float]:
        return (None if self.taken_at is None
                else self._clock() - self.taken_at)

    def due(self) -> bool:
        if not self.enabled:
            return False
        return (self.taken_at is None
                or self._clock() - self.taken_at >= self.interval_s)

    def maybe_snapshot(self, encoder) -> bool:
        """Snapshot ``encoder`` when the cadence says so.  Returns True
        when a fresh checkpoint was taken.  A failing export (device
        already unreachable mid-snapshot) keeps the PREVIOUS checkpoint —
        stale-but-consistent beats fresh-but-absent."""
        if not self.due():
            return False
        try:
            state = encoder.export_state()
        except Exception:
            _M_SNAPSHOT_FAIL.inc()
            if not self._warned:
                self._warned = True
                log.exception("encoder checkpoint failed; keeping the "
                              "previous one (age %.1fs)", self.age_s or 0.0)
            return False
        self.state = state
        self.taken_at = self._clock()
        self.count += 1
        self._warned = False
        _M_SNAPSHOTS.inc()
        return True

    def adopt(self, state: dict) -> None:
        """Seed the lineage from a handoff snapshot (resilience/handoff):
        the imported predecessor checkpoint becomes this keeper's latest,
        so a device loss in the first ``interval_s`` after a migration
        still recovers into the migrated lineage, not a blank one."""
        self.state = state
        self.taken_at = self._clock()
        self.count += 1


def restore_encoder(cfg, width: int, height: int,
                    checkpoint: Optional[dict] = None, device=None):
    """Re-acquire a device and restore the stream lineage onto it.

    Builds a fresh encoder from config (the same deterministic selection
    the session's ``_setup_codec`` used, so the codec — and therefore the
    muxer/init-segment the client already holds — matches), proves the
    device answers with a trivial round-trip, then imports ``checkpoint``
    (which re-uploads any reference planes — a second, bigger proof).
    Raises when the device is still dead; the caller's half-open breaker
    turns that into another cool-down.

    ``device``: the encoder's device (None = the card, as
    ``make_encoder``).  Returns ``(encoder, codec_name)``.
    """
    import torch

    from ..models import make_encoder, resolve_device

    enc, codec_name = make_encoder(cfg, width, height, device=device)
    # does the device answer?  A put, an add on the device and a pull
    probe = torch.zeros(8, dtype=torch.int32, device=resolve_device(device))
    if int((probe + 1).sum().cpu()) != 8:
        raise RuntimeError("device round trip returned a wrong sum")
    usable = (checkpoint is not None
              and (checkpoint.get("codec"), checkpoint.get("width"),
                   checkpoint.get("height"))
              == (enc.codec, enc.width, enc.height))
    if usable:
        from ..models.base import CheckpointSchemaError
        try:
            enc.import_state(checkpoint)
        except CheckpointSchemaError as e:
            # versioned reject (models/base CKPT_SCHEMA): the lineage is
            # from an incompatible build — recover WITHOUT it rather than
            # failing the device re-acquisition outright
            log.warning("checkpoint rejected (%s); recovering without "
                        "lineage", e)
            enc.request_keyframe()
    else:
        # codec selection or geometry changed under us (config fallback,
        # a resize racing the snapshot): the lineage cannot carry over —
        # discard it HERE so the mismatch never reads as a dead device,
        # and let the caller's codec-name check trigger the full rebuild
        if checkpoint is not None:
            log.warning(
                "checkpoint (%s %sx%s) does not match rebuilt encoder "
                "(%s %dx%d); discarding lineage",
                checkpoint.get("codec"), checkpoint.get("width"),
                checkpoint.get("height"), enc.codec, enc.width, enc.height)
        enc.request_keyframe()               # no lineage: plain resync IDR
    return enc, codec_name


def record_recovery(elapsed_s: float) -> None:
    """Feed the recovery telemetry (called by the session on success)."""
    _M_RECOVERIES.inc()
    _M_RECOVERY_MS.observe(elapsed_s * 1e3)


class DrainState:
    """Process-wide graceful-drain flag.

    ``begin()`` is idempotent; the web layer checks :attr:`draining`
    before admitting a websocket session and broadcasts the
    ``("draining",)`` control item to connected subscribers so clients
    can pre-connect elsewhere while the last in-flight frames flush.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.draining = False
        self.since: Optional[float] = None
        self.reason: Optional[str] = None
        _M_DRAINING.set_function(lambda: 1.0 if self.draining else 0.0)

    def begin(self, reason: str = "drain") -> bool:
        """Flip into draining mode; returns False when already draining."""
        if self.draining:
            return False
        self.draining = True
        self.since = self._clock()
        self.reason = reason
        log.warning("draining (%s): refusing new sessions, notifying "
                    "connected clients", reason)
        return True

    def snapshot(self) -> dict:
        return {"draining": self.draining, "reason": self.reason,
                "for_s": (None if self.since is None
                          else round(self._clock() - self.since, 2))}
