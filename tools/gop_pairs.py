#!/usr/bin/env python3
"""Alternating timings of the port's GOP path across checkouts, on one card.

Compares two or more checkouts of the repository (for example a commit
and its parent, each unpacked with ``git archive``) on the default
configuration, ``make_encoder(from_env({"SIZEW": "1920", "SIZEH":
"1080"}))`` (GOP 60, deblock, rate control), with one frame in flight:

    python3 tools/gop_pairs.py --pairs 10 --frames 36 \\
        parent=.tree/parent change=.tree/change \\
        change-py-epb=.tree/change:py-epb

Each ``NAME=PATH[:py-epb]`` is a variant.  ``py-epb`` turns the native
emulation-prevention escaper of ``bitstream/h264.nal_unit`` off, so
every NAL unit goes through the Python escaper and the native library
is never loaded.  Every run is a fresh process that imports the package
from PATH, so the variants share nothing but the card and the host.
Round ``i`` runs the variants in order, round ``i + 1`` in reverse, so a
drift of the host over the call reaches every variant alike.  Each run
first encodes four warm-up frames (kernels loaded, caches filled), then
times ``--frames`` fresh frames of ``chip_smoke.gop_frames`` (an IDR,
then P frames), cv2's host colour conversion alone on five of them, and
the GOP path's per-frame kernels on one 1080p P frame: K1 (the intra
core on its planes), K2 and K3 on K1's levels, K4 (full form), K5, K6
and K7 on K5's outputs, K8 and K9, each as one eager
call timed by CUDA events (host launch
work included) and as the replay of that call captured into a CUDA graph
(the kernel's device time), medians of 50 (``chip_smoke.cuda_ms`` and
``graph_ms``).

Prints the card's name and power limit, one JSON line per run and, per
variant, the medians over its runs; writes everything to
``chiprun_out/gop_pairs.json``.  Needs CUDA.
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
W, H = 1920, 1080
WARM_FRAMES = 4
KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "k9")
METRICS = ("fps", "p50_ms", "p50_p_ms", "idr_ms", "submit_ms", "collect_ms",
           "colour_ms") + tuple(f"{k}_{w}_ms" for k in KERNELS
                                for w in ("event", "graph"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str, py_epb: bool, frames: int, build_only: bool) -> dict:
    """One run: import the package from ``tree`` and time the GOP path."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    mod = sys.modules[PKG]
    if not mod.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {mod.__file__}, not the package of {tree}")
    native = None
    if os.path.exists(os.path.join(tree, PKG, "native", "lib.py")):
        from docker_nvidia_glx_desktop_tpu_torch.native import lib as native
        if py_epb:
            native.available = lambda: False
    if build_only:
        _cuda.build()
        if native is not None and not py_epb:
            native.get_lib()
        return {"built": tree}

    smoke = _chip_smoke()
    cfg = from_env({"SIZEW": str(W), "SIZEH": str(H)})
    warm, _ = make_encoder(cfg, W, H)
    for f in smoke.gop_frames(WARM_FRAMES, seed=1):
        warm.encode_collect(warm.encode_submit(f))
    timed = smoke.gop_frames(frames, seed=2)
    enc, _ = make_encoder(cfg, W, H)
    lat, sub, col, kinds = [], [], [], []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for f in timed:
        ts = time.perf_counter()
        tok = enc.encode_submit(f)
        tc = time.perf_counter()
        enc.encode_collect(tok)
        te = time.perf_counter()
        sub.append((tc - ts) * 1e3)
        col.append((te - tc) * 1e3)
        lat.append((te - ts) * 1e3)
        kinds.append(tok[0])
    run_s = time.perf_counter() - t_run
    colour = []
    for f in timed[:5]:
        t = time.perf_counter()
        enc._host_yuv420(f)
        colour.append((time.perf_counter() - t) * 1e3)
    return dict(kernel_ms(smoke, enc, timed[1]),
                fps=len(timed) / run_s, p50_ms=statistics.median(lat),
                p50_p_ms=statistics.median(
                    [m for m, k in zip(lat, kinds) if k == "p"]),
                idr_ms=lat[0], submit_ms=statistics.median(sub),
                collect_ms=statistics.median(col),
                colour_ms=statistics.median(colour),
                native_loaded=bool(native is not None
                                   and native._LIB is not None))


def kernel_ms(smoke, enc, rgb) -> dict:
    """K1 on the P frame ``rgb``'s planes with K2 and K3 on its levels,
    and K4 (full form), K5 (with K6 and K7 on its outputs), K8 and K9 on
    it against the encoder's reference, through the wrappers every
    checkout has."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        bitmerge, cavlc_device, cavlc_p_device, color, content_stats,
        h264_deblock, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.ops.cavlc_p_device import (
        nnz_raster)

    dev, qp = enc.device, 26
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in enc._host_yuv420(rgb)]
    ref = tuple(p.clone() for p in enc._ref)
    o = h264_inter.encode_p_frame(*planes, *ref, qp)
    rec = (o["recon_y"], o["recon_cb"], o["recon_cr"])
    nnz = nnz_raster(o["luma"])
    resid = tuple(o[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"))
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
    lv = h264_device.encode_intra_frame_yuv(*planes, qp)
    hv, hl = enc._hdr_slots(0)
    islots = cavlc_device.frame_block_slots(lv)
    pslots = cavlc_p_device.p_frame_slots(o)
    phv, phl = enc._p_hdr_slots(1, 0)
    calls = {"k1": lambda: h264_device.encode_intra_frame_yuv(*planes, qp),
             "k2": lambda: cavlc_device.frame_block_slots(lv),
             "k3": lambda: bitmerge.pack_frame(*islots, hv, hl),
             "k6": lambda: cavlc_p_device.p_frame_slots(o),
             "k7": lambda: bitmerge.pack_p_frame(*pslots[:6], phv, phl),
             "k4": lambda: content_stats.frame_stats_full(
                 planes[0], ref[0], 512, rec[0], o["mv"], resid),
             "k5": lambda: h264_inter.encode_p_frame(*planes, *ref, qp),
             "k8": lambda: h264_deblock.deblock_frame(*rec, qp, nnz_blk=nnz,
                                                      mv=o["mv"]),
             "k9": lambda: color.rgb_to_yuv420(rgb_t, enc.pad_h, enc.pad_w)}
    out = {}
    for k, fn in calls.items():
        out[f"{k}_event_ms"] = smoke.cuda_ms(fn, reps=50)
        out[f"{k}_graph_ms"] = smoke.graph_ms(fn, reps=50)
    return out


def _run_child(tree, py_epb, frames, build_only=False):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
           "--frames", str(frames)]
    cmd += ["--py-epb"] if py_epb else []
    cmd += ["--build-only"] if build_only else []
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                       cwd=HERE)
    if p.returncode != 0:
        raise SystemExit(f"run of {tree} failed:\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help="NAME=PATH[:py-epb]")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--py-epb", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.py_epb, args.frames,
                               args.build_only)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    variants = []
    for v in args.variants:
        name, spec = v.split("=", 1)
        tree, _, opt = spec.partition(":")
        if opt not in ("", "py-epb") or not os.path.isdir(os.path.join(tree, PKG)):
            raise SystemExit(f"bad variant {v!r}")
        variants.append((name, tree, opt == "py-epb"))
    if len(variants) < 2:
        raise SystemExit("give at least two variants")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name, tree, py_epb in variants:                 # builds, untimed
        _run_child(tree, py_epb, args.frames, build_only=True)
    runs = []
    for i in range(args.pairs):
        order = variants if i % 2 == 0 else variants[::-1]
        for name, tree, py_epb in order:
            r = dict(_run_child(tree, py_epb, args.frames), variant=name,
                     round=i)
            runs.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    for name, _, _ in variants:
        mine = [r for r in runs if r["variant"] == name]
        summary[name] = {m: statistics.median(r[m] for r in mine)
                         for m in METRICS}
        summary[name]["fps_all"] = [r["fps"] for r in mine]
    # per round, the fps of each variant over the first variant's
    base = variants[0][0]
    for name, _, _ in variants[1:]:
        ratios = []
        for i in range(args.pairs):
            a = next(r["fps"] for r in runs if r["variant"] == base
                     and r["round"] == i)
            b = next(r["fps"] for r in runs if r["variant"] == name
                     and r["round"] == i)
            ratios.append(b / a)
        summary[name][f"fps_over_{base}"] = ratios
        summary[name][f"rounds_slower_than_{base}"] = sum(x < 1 for x in ratios)
    print(json.dumps({"card": smi, "frames": args.frames, "summary": summary}))
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "gop_pairs.json"), "w") as f:
        json.dump({"card": smi, "frames": args.frames, "runs": runs,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
