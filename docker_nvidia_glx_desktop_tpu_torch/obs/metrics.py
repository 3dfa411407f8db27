"""Dependency-free metrics registry with Prometheus text exposition.

The container image bakes in no prometheus_client; this is the ~200-line
subset serving actually needs: Counter / Gauge / Histogram with labels, a
process-global default registry, the text exposition format (version
0.0.4) and a JSON snapshot so the legacy ``/stats`` endpoint is a view
over the same data.

Design constraints:

- recording is **integer-add only**: counters/gauges mutate one slot,
  histograms bisect a precomputed edge tuple and bump one bucket slot —
  no string formatting, allocation, or rendering on the hot path;
- ``labels(...)`` resolves a child once; hot paths hold the child;
- label cardinality is capped per metric (default 64 series): beyond the
  cap new label sets collapse into a single ``other`` series instead of
  growing the registry without bound (a hostile client must not be able
  to OOM the server by varying a label);
- rendering happens only at scrape time (``Registry.render``).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS_MS"]

# Fixed ms-scale edges: frame stages live in 0.1 ms (host splice) to
# seconds (cold jit) — log-ish spacing covers the whole range.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0)

MAX_LABEL_SETS = 64          # per-metric series cap
_OVERFLOW = "other"          # collapsed label value past the cap
# self-describing cardinality loss: bumped every time a labels() call
# collapses into the `other` series, so a dashboard can tell "other is
# big" apart from "other is actively eating new series right now"
OVERFLOW_COUNTER = "dngd_metrics_series_overflow_total"


def _escape(v: str) -> str:
    """Label-value escaping per the exposition format 0.0.4: backslash
    FIRST (or the other escapes' backslashes double), then line feed and
    double quote."""
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    """# HELP text escaping: the format escapes only backslash and line
    feed here (quotes are legal verbatim in help text)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class _GaugeChild:
    __slots__ = ("value", "fn")

    def __init__(self) -> None:
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def set_function(self, fn: Callable[[], float]) -> None:
        """Value computed at scrape time (e.g. queue depth, uptime) —
        zero hot-path cost for quantities that are cheap to read but
        change constantly."""
        self.fn = fn

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return self.value
        return self.value


class _HistogramChild:
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Tuple[float, ...]) -> None:
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)     # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # Prometheus bucket semantics: le is inclusive (v <= edge).
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1


class _Metric:
    """Shared label bookkeeping for the three instrument kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None,
                 max_series: int = MAX_LABEL_SETS):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._children: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        if self.labelnames == ():
            self._default = self._children[()] = self._new_child()
        self._registry = registry if registry is not None else REGISTRY
        self._registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values) -> object:
        """Resolve (and cache) the child for one label-value tuple.  Call
        once at setup; hold the returned child on hot paths."""
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(values)}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            overflowed = False
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= self.max_series:
                        # cardinality cap: collapse into one series
                        overflowed = True
                        key = (_OVERFLOW,) * len(self.labelnames)
                        child = self._children.get(key)
                        if child is None:
                            child = self._children[key] = self._new_child()
                    else:
                        child = self._children[key] = self._new_child()
            if overflowed:
                self._note_overflow()
        return child

    def _note_overflow(self) -> None:
        """Count one collapsed resolution on this metric's registry.
        Outside ``self._lock`` (the overflow counter is its own metric
        with its own lock); self-guarded so the counter overflowing its
        own 64 metric-name series cannot recurse."""
        if self.name == OVERFLOW_COUNTER:
            return
        try:
            self._registry._get_or_create(
                Counter, OVERFLOW_COUNTER,
                "Label-set resolutions collapsed into the `other` "
                "series by the per-metric cardinality cap",
                ("metric",)).labels(self.name).inc()
        except Exception:
            pass

    def remove(self, *values) -> None:
        """Drop one label-value series (per-entity series — e.g. a
        closed WebRTC peer's SSRC gauges — must be removed or they are
        exported stale forever and exhaust the cardinality cap)."""
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    def series(self) -> Iterable[Tuple[tuple, object]]:
        return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default.set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default.dec(n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default.set_function(fn)

    @property
    def value(self) -> float:
        return self._default.read()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                 registry: Optional["Registry"] = None,
                 max_series: int = MAX_LABEL_SETS):
        self.edges = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, help, labelnames, registry, max_series)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.edges)

    def observe(self, v: float) -> None:
        self._default.observe(v)


class Registry:
    """Named metrics + exposition.  One process-global default below;
    tests build private registries for isolation."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None and have is not metric:
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            have = self._metrics.get(name)
        if have is not None:
            if have.kind != cls.kind or have.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared with different "
                    f"kind/labels")
            return have
        return cls(name, help, labelnames, registry=self, **kw)

    # -- exposition ----------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4.

        ``# HELP`` / ``# TYPE`` are emitted exactly once per metric
        family — every series of a labeled metric (and every
        ``_bucket``/``_sum``/``_count`` line of a histogram) rides under
        the one header pair, as the format requires.
        """
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out.append(f"# HELP {name} {_escape_help(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            for key, child in sorted(m.series()):
                if isinstance(child, _HistogramChild):
                    cum = 0
                    for edge, c in zip(m.edges + (float("inf"),),
                                       child.counts):
                        cum += c
                        lbl = _fmt_labels(m.labelnames, key,
                                          f'le="{_fmt_value(edge)}"')
                        out.append(f"{name}_bucket{lbl} {cum}")
                    lbl = _fmt_labels(m.labelnames, key)
                    out.append(f"{name}_sum{lbl} {_fmt_value(child.sum)}")
                    out.append(f"{name}_count{lbl} {child.count}")
                else:
                    v = (child.read() if isinstance(child, _GaugeChild)
                         else child.value)
                    lbl = _fmt_labels(m.labelnames, key)
                    out.append(f"{name}{lbl} {_fmt_value(v)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able view over the same data (the `/stats` embedding)."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            for key, child in sorted(m.series()):
                labels = dict(zip(m.labelnames, key))
                if isinstance(child, _HistogramChild):
                    series.append({"labels": labels, "sum": child.sum,
                                   "count": child.count,
                                   "buckets": dict(zip(
                                       map(str, m.edges), child.counts))})
                elif isinstance(child, _GaugeChild):
                    series.append({"labels": labels, "value": child.read()})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out


REGISTRY = Registry()


def counter(name: str, help: str, labelnames: Sequence[str] = (),
            registry: Optional[Registry] = None) -> Counter:
    """Get-or-create a :class:`Counter` (idempotent at module import)."""
    return (registry or REGISTRY)._get_or_create(
        Counter, name, help, labelnames)


def gauge(name: str, help: str, labelnames: Sequence[str] = (),
          registry: Optional[Registry] = None) -> Gauge:
    return (registry or REGISTRY)._get_or_create(
        Gauge, name, help, labelnames)


def histogram(name: str, help: str, labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
              registry: Optional[Registry] = None) -> Histogram:
    return (registry or REGISTRY)._get_or_create(
        Histogram, name, help, labelnames, buckets=buckets)


# pre-register the overflow counter on the default registry so the
# family is discoverable on a fresh /metrics scrape (dashboards alert
# on it; an absent family reads as "never collapsed" only after the
# scraper already knows the name) — private registries still create it
# lazily on first collapse
counter(OVERFLOW_COUNTER,
        "Label-set resolutions collapsed into the `other` series by "
        "the per-metric cardinality cap", ("metric",))
