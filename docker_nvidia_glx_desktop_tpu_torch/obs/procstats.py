"""Process-level startup observability: peak RSS and the CPU-energy
proxy (the port of the reference's ``obs/procstats.py``).

- ``process_peak_rss_bytes`` — scrape-time gauge over
  ``getrusage(RUSAGE_SELF).ru_maxrss`` (kilobytes on Linux);
- ``dngd_cpu_joules_per_frame_proxy`` / ``dngd_cpu_ms_per_frame`` —
  the per-tune-tier energy proxy a serving session publishes.

Left out: the reference's persistent-compile-cache counters, fed there by
``jax.monitoring`` events.  The port has no XLA cache; its cold-start
costs are the nvcc builds and CUDA-graph captures, and counting those is
ROADMAP item 15b (telemetry).  ``log_startup()`` writes the memory
picture to the process log once the serving stack is up.
"""

from __future__ import annotations

import logging
import resource

from . import metrics as obsm
from ..utils.env import env_float

log = logging.getLogger(__name__)

__all__ = ["register_process_gauges", "register_energy_gauges",
           "log_startup", "peak_rss_bytes", "cpu_seconds",
           "CpuEnergyMeter"]



def peak_rss_bytes() -> float:
    """Peak resident set size of this process (ru_maxrss is KB on
    Linux, bytes on macOS — normalize to bytes)."""
    import sys

    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return float(maxrss if sys.platform == "darwin" else maxrss * 1024)


def cpu_seconds() -> float:
    """This process's consumed CPU time (utime + stime), seconds."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return float(r.ru_utime + r.ru_stime)


class CpuEnergyMeter:
    """CPU-energy **proxy** per frame (ROADMAP item 4's energy axis).

    True joules need RAPL/IPMI counters the container may not expose;
    this meter instead accumulates the utime+stime delta across a
    measured span and converts CPU-seconds to joules at a configurable
    active-power coefficient (``DNGD_CPU_WATTS``, default 12 W/core —
    a mid-range server-core active power).  The per-frame CPU-seconds
    number is exact; the joules figure is that times a constant, so
    per-tune-tier *ratios* (the BD-rate bench's use) are meaningful on
    any host even when the absolute wattage is not calibrated.

        m = CpuEnergyMeter()
        ... encode N frames ...
        stats = m.read(frames=N)   # cpu_s, cpu_ms_per_frame, joules_*
    """

    # env_float: a malformed DNGD_CPU_WATTS (a bench-only proxy knob)
    # must not crash server startup at this module's import
    WATTS_PER_CORE = env_float("DNGD_CPU_WATTS", 12.0)

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = cpu_seconds()

    def read(self, frames: int) -> dict:
        dt = max(cpu_seconds() - self._t0, 0.0)
        n = max(int(frames), 1)
        return {
            "cpu_s": round(dt, 4),
            "frames": int(frames),
            "cpu_ms_per_frame": round(dt * 1e3 / n, 3),
            "joules_per_frame_proxy": round(dt * self.WATTS_PER_CORE / n, 4),
            "watts_per_core_assumed": self.WATTS_PER_CORE,
        }

    def publish(self, frames: int, tune: str = "off",
                registry=None) -> dict:
        """``read()`` + set the per-tune-tier ``/metrics`` gauges, so
        the energy axis is continuously scrapeable (not a bench-only
        number).  The serving session calls this periodically; the
        BD-rate bench calls it once per tier."""
        stats = self.read(frames)
        reg = registry if registry is not None else obsm.REGISTRY
        register_energy_gauges(reg)
        t = str(tune or "off")
        reg.get("dngd_cpu_joules_per_frame_proxy").labels(t).set(
            stats["joules_per_frame_proxy"])
        reg.get("dngd_cpu_ms_per_frame").labels(t).set(
            stats["cpu_ms_per_frame"])
        return stats


def register_energy_gauges(registry=None) -> None:
    """Idempotently create the CPU-energy-proxy gauge families."""
    reg = registry if registry is not None else obsm.REGISTRY
    obsm.gauge("dngd_cpu_joules_per_frame_proxy",
               "CPU-energy proxy per frame over the last measured span "
               "(cpu-seconds x DNGD_CPU_WATTS; ratios across tiers are "
               "meaningful, absolutes need calibration)", ("tune",),
               registry=reg)
    obsm.gauge("dngd_cpu_ms_per_frame",
               "CPU milliseconds per frame over the last measured span",
               ("tune",), registry=reg)


def register_process_gauges(registry=None) -> None:
    """Idempotently create the process-level gauge families."""
    reg = registry if registry is not None else obsm.REGISTRY
    obsm.gauge("process_peak_rss_bytes",
               "Peak resident set size (getrusage ru_maxrss)",
               registry=reg).set_function(peak_rss_bytes)


def log_startup() -> dict:
    """Log (and return) the startup memory picture — called once the
    serving stack is up."""
    register_process_gauges()
    stats = {"peak_rss_mb": round(peak_rss_bytes() / 1e6, 1)}
    log.info("startup memory: peak host rss %.1f MB", stats["peak_rss_mb"])
    return stats
