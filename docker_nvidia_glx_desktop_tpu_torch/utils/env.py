"""Small env-var parsers (copied from the reference's ``utils/env.py``):
warn and keep the default on a malformed value."""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

__all__ = ["env_float", "env_flag"]


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with a logged fallback on absent or
    malformed values — a typo'd knob must degrade to the default, not
    crash the serving path that reads it."""
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


def env_flag(name: str, default: bool) -> bool:
    """Boolean env knob: 1/true/yes/on (case-insensitive) is True,
    0/false/no/off is False, anything else falls back to the default —
    same degrade-don't-crash contract as :func:`env_float`."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off"):
        return False
    log.warning("%s=%r is not a boolean; using %s", name, raw, default)
    return default
