#!/usr/bin/env python3
"""The bench's BD-rate gate in alternating fresh processes, on one card.

    python3 tools/bdrate_pairs.py --runs 6 parent=.tree/parent change=.

runs the gate (``bench.bdrate_main(quick=True)``: 192x112, the
reference's geometry, frames and qp ladder, host-clock P steps) in a
fresh process per run that imports the package from PATH, the variants
in turn and in reverse the next round, and records each run's gate,
``max_step_cost_ratio`` and every class's off / hq P step p50s, then
``bdrate_split``: off and hq P frames in turn in one process, each
tier's median frame, submit and collect ms and the host ms of each
kernel entry's launch.  ``--profile`` adds, in the first two rounds, one
tune=off and one tune=hq encoder of the gate's ``natural_gradients``
frames at qp 26 side by side: cProfile over seven P frames (per-frame
host seconds by function) and ``torch.profiler`` over one P frame (host
ops, launches, copies and syncs, kernels by device time).  Prints the
card's name and power limit and one JSON line per run; writes
everything to ``chiprun_out/bdrate_pairs.json``.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "docker_nvidia_glx_desktop_tpu_torch"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"bdrate_pairs: FAILED: {msg}")


def smi_line() -> str:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.smi_line()


BD_W, BD_H, BD_FRAMES, BD_QP = 192, 112, 9, 26


def bdrate_profile(dev) -> dict:
    """cProfile and torch.profiler of one off and one hq P frame path."""
    import cProfile
    import pstats

    import torch

    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder

    frames = bench._bdrate_frames("natural_gradients", BD_W, BD_H, BD_FRAMES)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for tier in ("off", "hq"):
        def fresh():
            enc = H264Encoder(BD_W, BD_H, qp=BD_QP, mode="cavlc",
                              entropy="device", gop=len(frames),
                              keep_recon=True, tune=tier, device=dev)
            enc.encode(frames[0])
            enc.encode(frames[1])
            return enc
        bench.run_tier(frames, tier, BD_QP, BD_W, BD_H, dev, warm_only=True)
        enc, ms = fresh(), []
        prof = cProfile.Profile()
        for f in frames[2:]:
            t0 = time.perf_counter()
            prof.enable()
            enc.encode(f)
            prof.disable()
            ms.append((time.perf_counter() - t0) * 1e3)
        n = len(frames) - 2
        st = pstats.Stats(prof)
        funcs = sorted(((f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", v[1] / n,
                         v[2] / n * 1e3, v[3] / n * 1e3)
                        for k, v in st.stats.items()),
                       key=lambda r: -r[3])
        enc = fresh()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as tp:
            enc.encode(frames[2])
            torch.cuda.synchronize()
        ops = [{"name": e.key, "count": e.count,
                "cpu_us": round(e.cpu_time_total, 1),
                "device_us": round(getattr(e, "device_time_total", 0.0), 1)}
               for e in tp.key_averages()]
        out[tier] = {
            "p_ms_cprofiled": ms,
            "cprofile_top_cum_ms": [
                {"fn": f, "calls": c, "tot_ms": round(t, 4),
                 "cum_ms": round(cu, 4)} for f, c, t, cu in funcs[:45]],
            "torch_ops": sorted(ops, key=lambda r: -r["cpu_us"])[:60]}
    return out


def bdrate_split(dev, n: int = 160) -> dict:
    """An off and an hq encoder of the gate's natural_gradients frames at
    qp 26 (one long GOP, ``keep_recon``), P frames in turn for ``n``
    rounds: each tier's median host ms of a frame, of its submit and of
    its collect, the host ms a frame spent in each kernel entry's
    ``_cuda.launch`` (its checks, the ctypes call, the launch) and in each
    of the P path's wrappers (inclusive: a wrapper's launches and the
    wrappers it calls)."""
    import collections
    import functools

    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        _cuda, aq, cavlc_p_device, color, content_stats, h264_inter)

    frames = bench._bdrate_frames("natural_gradients", BD_W, BD_H, BD_FRAMES)
    encs = {}
    for tier in ("off", "hq"):
        encs[tier] = H264Encoder(BD_W, BD_H, qp=BD_QP, mode="cavlc",
                                 entropy="device", gop=1 << 20,
                                 keep_recon=True, tune=tier, device=dev)
        encs[tier].encode(frames[0])
    spent, calls, cur = collections.Counter(), collections.Counter(), [None]
    launch = _cuda.launch

    def timed(lib, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return launch(lib, fn, *args, **kw)
        finally:
            spent[(cur[0], fn)] += time.perf_counter() - t0
            calls[(cur[0], fn)] += 1
    ms = {t: {"frame": [], "submit": [], "collect": []} for t in encs}
    wrapped = [(mod, name) for mod, names in (
        (h264_inter, ("encode_p_frame", "_i16_passes", "_out_tensors")),
        (aq, ("qp_plane",)), (color, ("rgb_to_yuv420",)),
        (cavlc_p_device, ("p_frame_slots", "pack_p_frame", "_finish_p")),
        (content_stats, ("frame_stats_full",))) for name in names]
    saved = {(mod, name): getattr(mod, name) for mod, name in wrapped}

    def timed_fn(key, fn):
        @functools.wraps(fn)            # keeps the launch counters
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[(cur[0], "py:" + key)] += time.perf_counter() - t0
        return run
    _cuda.launch = timed
    for (mod, name), fn in saved.items():
        setattr(mod, name, timed_fn(name, fn))
    try:
        for i in range(n):
            for tier in (("off", "hq") if i % 2 == 0 else ("hq", "off")):
                f, enc = frames[1 + i % (BD_FRAMES - 1)], encs[tier]
                cur[0] = tier if i >= n // 4 else None
                t0 = time.perf_counter()
                tok = enc.encode_submit(f)
                t1 = time.perf_counter()
                enc.encode_collect(tok)
                t2 = time.perf_counter()
                if i >= n // 4:          # the first quarter warms up
                    ms[tier]["frame"].append((t2 - t0) * 1e3)
                    ms[tier]["submit"].append((t1 - t0) * 1e3)
                    ms[tier]["collect"].append((t2 - t1) * 1e3)
    finally:
        _cuda.launch = launch
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    timed_n = n - n // 4
    out = {t: {k: statistics.median(v) for k, v in d.items()}
           for t, d in ms.items()}
    for (tier, fn), s in spent.items():
        if tier is None:
            continue
        if fn.startswith("py:"):
            out[tier].setdefault("wrapper_ms", {})[fn[3:]] = round(
                s / timed_n * 1e3, 4)
            continue
        out[tier].setdefault("launch_ms", {})[fn] = round(
            s / timed_n * 1e3, 4)
        out[tier].setdefault("launches", {})[fn] = calls[(tier, fn)] / timed_n
    for t in out:
        out[t]["launch_ms_total"] = round(
            sum(out[t].get("launch_ms", {}).values()), 4)
    out["ratio"] = out["hq"]["frame"] / out["off"]["frame"]
    return out


def bdrate_child(tree: str, profile: bool) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    mod = sys.modules[PKG]
    check(mod.__file__.startswith(os.path.abspath(tree)),
          f"imported {mod.__file__}, not the package of {tree}")

    _cuda.build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bd = bench.bdrate_main(quick=True, device=dev)["bdrate"]
    out = {"ok": bd["ok"], "max_step_cost_ratio": bd["max_step_cost_ratio"],
           "best_gain_pct": bd["best_gain_pct"],
           "worst_gain_pct": bd["worst_gain_pct"],
           "bdrate_s": round(time.perf_counter() - t0, 2),
           "classes": {c: {"ratio": r["step_cost_ratio_hq"],
                           "off_p50": r["tiers"]["off"]["p_step_ms_p50"],
                           "hq_p50": r["tiers"]["hq"]["p_step_ms_p50"],
                           "rate_off": r["tiers"]["off"]["rate_bits"],
                           "rate_hq": r["tiers"]["hq"]["rate_bits"]}
                       for c, r in bd["classes"].items()}}
    if profile:
        out["profile"] = bdrate_profile(dev)
    out["split"] = bdrate_split(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/bdrate_pairs.py")
    ap.add_argument("variants", nargs="*", help="NAME=PATH")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(bdrate_child(args.child, args.profile)))
        return 0
    variants = [v.split("=", 1) for v in args.variants]
    check(bool(variants) and all(os.path.isdir(os.path.join(t, PKG))
                                 for _, t in variants), "give NAME=PATH ...")

    def one(tree, profile=False):
        cmd = ([sys.executable, os.path.abspath(__file__), "--child", tree]
               + (["--profile"] if profile else []))
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                           cwd=HERE)
        check(p.returncode == 0, f"run of {tree} failed:\n{p.stderr[-4000:]}")
        return json.loads(p.stdout.strip().splitlines()[-1])
    smi = smi_line()
    print(smi, flush=True)
    runs = []
    for i in range(args.runs):
        for name, tree in (variants if i % 2 == 0 else variants[::-1]):
            r = dict(one(tree, args.profile and i < 2), variant=name, round=i)
            runs.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("profile", "classes")}),
                  flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "bdrate_pairs.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
