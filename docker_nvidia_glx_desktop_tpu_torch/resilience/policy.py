"""Unified retry/timeout/backoff policy primitives.

Before this module every component rolled its own recovery arithmetic:
the supervisor doubled a local ``backoff`` variable, the TURN client
hard-coded retransmit doublings, ICE had no liveness policy at all, and
the web session counted failures ad hoc.  These three small classes are
the single vocabulary they all share now:

- :class:`RetryPolicy` — capped exponential backoff with *full jitter*
  (delay drawn uniformly from ``[floor, min(cap, initial*mult^n)]``,
  the AWS architecture-blog result: full jitter spreads a thundering
  herd of simultaneous retriers across the whole window, where equal
  or no jitter re-synchronizes them every attempt);
- :class:`Deadline` — a budget-aware timeout: one absolute expiry that
  every sub-operation clamps its own wait against, so a chain of
  retries can never overrun the caller's budget;
- :class:`CircuitBreaker` — consecutive-failure escalation with a
  half-open probe, the supervisor-quarantine / stop-hammering-a-dead-
  device state machine.

Everything takes an injectable ``rng``/``clock`` so tests pin exact
delay envelopes without sleeping.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

__all__ = ["RetryPolicy", "Deadline", "CircuitBreaker"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + full jitter.

    ``delay(attempt)`` for attempt 0, 1, 2, ... draws uniformly from
    ``[floor, ceiling(attempt)]`` where ``ceiling(attempt) =
    min(cap, initial * multiplier**attempt)``.  ``jitter="none"``
    returns the ceiling itself (deterministic legacy behavior, and the
    upper envelope tests pin).
    """

    initial: float = 0.5
    cap: float = 15.0
    multiplier: float = 2.0
    jitter: str = "full"          # "full" | "none"
    floor: float = 0.0            # lower bound of the jitter window
    max_attempts: int = 0         # 0 = retry forever

    def ceiling(self, attempt: int) -> float:
        """Upper bound of the delay window for ``attempt`` (0-based)."""
        return min(self.cap, self.initial * self.multiplier ** max(attempt, 0))

    def delay(self, attempt: int,
              rng: Callable[[], float] = random.random) -> float:
        c = self.ceiling(attempt)
        if self.jitter == "none":
            return c
        lo = min(self.floor, c)
        return lo + (c - lo) * rng()

    def gives_up(self, attempt: int) -> bool:
        """True once ``attempt`` (0-based count of failures so far)
        exhausts ``max_attempts``."""
        return self.max_attempts > 0 and attempt >= self.max_attempts


class Deadline:
    """One absolute expiry shared by a chain of sub-operations.

    ``Deadline(5.0)`` gives the whole chain 5 s; each step asks
    ``timeout(want)`` for its own wait, clamped to what's left, so the
    chain as a whole can never exceed the budget no matter how many
    retries happen inside it.
    """

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.budget_s = float(budget_s)
        self.expires_at = clock() + self.budget_s

    @property
    def remaining(self) -> float:
        return max(0.0, self.expires_at - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self.expires_at

    def timeout(self, want: float) -> float:
        """``want`` clamped into the remaining budget (>= 0)."""
        return max(0.0, min(float(want), self.remaining))


class CircuitBreaker:
    """Consecutive-failure escalation with a half-open probe.

    States: ``closed`` (normal), ``open`` (tripped — ``allow()`` is
    False until ``reset_timeout_s`` elapses), ``half-open`` (one probe
    admitted; its success closes the breaker, its failure re-opens).
    The supervisor's quarantine and the encode thread's give-up-on-dead-
    device logic are both this machine with different thresholds.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self.consecutive_failures = 0
        self._state = "closed"
        self._opened_at: Optional[float] = None
        self._probe_out = False

    @property
    def state(self) -> str:
        # lazily promote open -> half-open when the cool-down elapsed
        if (self._state == "open" and self._opened_at is not None
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = "half-open"
            self._probe_out = False
        return self._state

    def allow(self) -> bool:
        """May the caller attempt the protected operation now?"""
        st = self.state
        if st == "closed":
            return True
        if st == "half-open" and not self._probe_out:
            self._probe_out = True       # exactly one probe in flight
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._state = "closed"
        self._opened_at = None
        self._probe_out = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if (self.state == "half-open"
                or self.consecutive_failures >= self.failure_threshold):
            self._state = "open"
            self._opened_at = self._clock()
            self._probe_out = False

    def trip(self) -> None:
        """Force-open immediately: for unambiguous device-revoked signals
        (TPU preemption notice, mesh chip declared lost) there is nothing
        to count — the protected resource is KNOWN gone, and the half-open
        probe after ``reset_timeout_s`` is the first legitimate retry."""
        self.consecutive_failures = max(self.consecutive_failures,
                                        self.failure_threshold)
        self._state = "open"
        self._opened_at = self._clock()
        self._probe_out = False
