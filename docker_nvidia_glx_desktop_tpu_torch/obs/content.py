"""Content & quality telemetry knobs (copied from the reference's
``obs/content.py``).

Only the switches the encoder reads live here so far: the master switch,
the stats cadence and the damage threshold.  Metrics, events and flight
publishing come with the serving slice.
"""

from __future__ import annotations

import os

__all__ = ["set_enabled", "enabled", "sample_every", "damage_thr_sad"]

_enabled = True


def set_enabled(v: bool) -> None:
    """Master switch: off means the encoder dispatches NO stats work."""
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
