#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's H.264 encoder through the entry points a serving
session calls (``make_encoder(from_env(...))``, ``encode_submit`` /
``encode_collect``) at 1920x1080 on synthetic desktop-like frames from a
seeded generator, in two phases:

- **intra**: ``ENCODER_GOP=1``, the default rate control, one frame
  noisy enough to overflow the packer and take the host fallback
  (kernels K1-K4);
- **gop**: the default serving configuration (GOP 60, deblock on, rate
  control on): an IDR, then P frames over a static region, scrolling
  text and a window dragged by a sub-pel displacement, a requested
  keyframe halfway (a second IDR through the intra loop filter), one
  full-noise P frame that overflows the packer and takes the P host
  fallback, two frames in flight (K1-K3, K4 full form, K5-K8).

Checks, each of which fails the run:

  build   nvcc builds every kernel of ``csrc/`` (one process per source)
  main    each phase's encode loop; every kernel of the phase's path must
          have launched (counts set to 0 just before, read just after)
  (a)     each kernel against its plain PyTorch version on the same CUDA
          inputs at the phase's 1080p shapes (exact; float stats within a
          stated relative tolerance), timed with CUDA events
  (b)     every access unit against the plain path on the card; in the
          GOP phase every deblocked reference against the plain chain
  (c)     where cv2 decodes H.264, the decoded luma of the GOP stream
          against the encoder's deblocked references
  check   NAL structure, recon PSNR, qp moved, no jax imported

Prints the card's name and power limit, per-kernel times beside their
bounds, the GOP path's frames/s, p50 frame ms, busy share and host spans,
a ``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, without CUDA or
outside a checkout of the repository.

Run: ``python3 chip_smoke.py`` (details go to ``chiprun_out/``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
N_FRAMES = 12              # intra phase desktop frames; one noisy frame is added
NOISY_AT = 1               # still at the first frames' qp: it overflows
GOP_FRAMES = 26            # GOP phase: IDR, P frames, a second IDR at KF_AT
GOP_KF_AT = 12
GOP_NOISY_AT = 20          # a full-noise P frame: the P host fallback
TIMED_FRAMES = 12          # GOP frames timed with one frame in flight
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# No integer rate is in the data-sheet table: the integer work of K5 is
# held against the 67 T/s non-tensor float32 rate (one operation per
# add, subtract, absolute value, compare, multiply or shift).
SCALAR_OPS_PER_S = 67e12
EXACT_REL_TOL = 1e-6       # activity percentiles (float32 interpolation)
FLOAT_REL_TOL = 1e-5       # SSE, |MV| mean and p95 of the full K4 form


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def desktop_base(rng):
    """Gradient wallpaper, flat windows with title bars, glyph strokes."""
    import numpy as np

    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([(xx * 255 // (W - 1)), (yy * 255 // (H - 1)),
                     ((xx + yy) * 255 // (W + H - 2))], axis=-1).astype(np.uint8)
    windows = [(rng.integers(0, H - 400), rng.integers(0, W - 600),
                rng.integers(200, 400), rng.integers(300, 600)) for _ in range(5)]
    for (y0, x0, h, w) in windows:
        base[y0:y0 + h, x0:x0 + w] = rng.integers(200, 250, 3)
        base[y0:y0 + 24, x0:x0 + w] = rng.integers(40, 90, 3)
        # glyph rows: short dark strokes on the window body
        for ty in range(y0 + 40, y0 + h - 16, 18):
            for tx in range(x0 + 10, x0 + w - 20, 9):
                if rng.random() < 0.7:
                    gh, gw = rng.integers(6, 12), rng.integers(1, 6)
                    base[ty:ty + gh, tx:tx + gw] = rng.integers(0, 60)
    return base


def desktop_frames(n: int, seed: int = 0):
    """Intra phase: a region that scrolls every frame, a window that
    appears part-way, a cursor; plus one frame of noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = desktop_base(rng)
    text = base[300:700, 800:1500].copy()
    frames = []
    for i in range(n):
        f = base.copy()
        f[300:700, 800:1500] = np.roll(text, -12 * i, axis=0)      # scroll
        if i >= n // 2:
            f[600:900, 100:700] = (30, 30, 60)                      # new window
            f[620:880, 120:680:7] = 230
        cy = 100 + 20 * i
        f[cy:cy + 20, 1700:1712] = 255                              # cursor
        frames.append(f)
    noisy = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    frames.insert(NOISY_AT, noisy)
    return frames


def gop_frames(n: int, seed: int = 1, noisy_at=None):
    """GOP phase: the desktop stays still outside two regions — text
    scrolling up 6 pels a frame (integer MVs) and a window whose smooth
    content and frame move by (0.75, 2.25) pels a frame (sub-pel MVs);
    frame ``noisy_at`` is full noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = desktop_base(rng)
    text = base[200:560, 900:1500].copy()
    wy, wx = np.mgrid[0:240, 0:360].astype(np.float64)
    frames = []
    for i in range(n):
        f = base.copy()
        f[200:560, 900:1500] = np.roll(text, -6 * i, axis=0)        # scroll
        dy, dx = 0.75 * i, 2.25 * i
        y0, x0 = 620 + int(dy), 200 + int(dx)
        sy, sx = wy - (dy - int(dy)), wx - (dx - int(dx))
        win = (128 + 60 * np.sin(sx / 9.0) * np.cos(sy / 13.0)
               + 30 * np.sin((sx + sy) / 21.0))
        f[y0:y0 + 240, x0:x0 + 360] = np.clip(win, 0, 255)[..., None].astype(
            np.uint8) * np.array([1, 1, 1], np.uint8)
        f[y0:y0 + 20, x0:x0 + 360] = (50, 60, 140)                 # title bar
        frames.append(f)
    if noisy_at is not None:
        frames[noisy_at] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return frames


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1):
    """Median ms of ``fn()`` by CUDA events, one launch per sample."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_busy(enc, frames, depth: int = 2):
    """Device busy share over a short window with ``depth`` frames in
    flight, from a torch.profiler trace (kernel and copy time over host
    wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pending = []
            for f in frames:
                pending.append(enc.encode_submit(f))
                if len(pending) == depth:
                    enc.encode_collect(pending.pop(0))
            for tok in pending:
                enc.encode_collect(tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:       # no CUPTI tracing on this host
        print(f"device busy share: not measured (profiler: {e})")
        return None
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages())
    if busy_us <= 0:
        print("device busy share: not measured (the trace holds no device time)")
        return None
    share = busy_us / 1e3 / wall_ms
    top = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    print(f"device busy share: {share:.3f} over {len(frames)} frames, {depth} "
          f"in flight ({busy_us / 1e3 / len(frames):.2f} ms device / "
          f"{wall_ms / len(frames):.2f} ms wall per frame); top: " + "; ".join(
              f"{e.key[:40]} {getattr(e, 'self_device_time_total', 0.0) / 1e3 / len(frames):.3f} ms"
              for e in top))
    return {"share": share, "wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "frames": len(frames), "depth": depth}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_row(name, src, replaces, launches, err, ms, plain_ms, nb, ops=0.0):
    """One entry of the kernels line: the bound is the larger of the
    bytes over the memory rate and the operations over the scalar rate."""
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": "docker_nvidia_glx_desktop_tpu_torch/csrc/" + src,
            "replaces": "docker_nvidia_glx_desktop_tpu/ops/" + replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None}


def k5_ops(nmb: int) -> float:
    """Integer operations of the P core (K5) per frame, counted from its
    stages (fixed work: no loop ends early):
      coarse   81 candidates x 128 even-line pels x (sub, abs, add)
      +-1      9 x 128 x 3;  half 8 x 128 x 3;  quarter 8 x 128 x 5
               (the rounded average: add, add, shift)
      planes   b and h: 324 samples x 12 (6 taps, round, shift, clip);
               j: 324 x (6 x 11 + 12)
      MC       luma 256 x 5, chroma 128 x 16
      residual 24 4x4 blocks x (64 fdct + 48 quant + 32 dequant + 80 idct
               + 32 prediction and clip)
      argmin   (81 + 9 + 8 + 8) compares"""
    per_mb = (81 * 128 * 3 + 9 * 128 * 3 + 8 * 128 * 3 + 8 * 128 * 5
              + 2 * 324 * 12 + 324 * (6 * 11 + 12)
              + 256 * 5 + 128 * 16 + 24 * (64 + 48 + 32 + 80 + 32)
              + (81 + 9 + 8 + 8))
    return float(per_mb * nmb)


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _cuda.build(verbose=True)
    report["build_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"build: {len(logs)} sources in {report['build_s']:.1f} s")

    rows = intra_phase(report)
    print(f"intra phase done at {time.perf_counter() - t_start:.0f} s")
    rows += gop_phase(report)
    print(f"gop phase done at {time.perf_counter() - t_start:.0f} s")
    check("jax" not in sys.modules, "the port imported jax")
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def intra_phase(report):
    """``ENCODER_GOP=1``: K1-K4 on the all-intra path."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        bitmerge, cavlc_device, content_stats, h264_device)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    dev = torch.device("cuda")
    frames = desktop_frames(N_FRAMES)
    wrappers = {
        "intra": h264_device.encode_intra_frame_yuv,
        "cavlc_slots": cavlc_device.frame_block_slots,
        "pack": bitmerge.pack_frame,
        "content_stats": content_stats.frame_stats,
    }

    # -- main path ---------------------------------------------------------
    cfg = from_env({"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": "1"})
    enc, codec = make_encoder(cfg, W, H)
    check(enc.device.type == "cuda", "the encoder did not pick the card")
    for fn in wrappers.values():
        fn.launches = 0
    tokens, aus, lat_ms, qps, stats = [], [], [], [], []
    sub_ms, col_ms = [], []
    t_run = time.perf_counter()
    pending = []
    for f in frames + [None]:
        if f is not None:
            ts = time.perf_counter()
            pending.append((ts, enc.encode_submit(f)))
            sub_ms.append((time.perf_counter() - ts) * 1e3)
        if len(pending) == 2 or (f is None and pending):
            ts, tok = pending.pop(0)
            tc = time.perf_counter()
            ef = enc.encode_collect(tok)
            col_ms.append((time.perf_counter() - tc) * 1e3)
            lat_ms.append((time.perf_counter() - ts) * 1e3)
            tokens.append(tok)
            aus.append(ef.data)
            qps.append(tok[4][2])
            stats.append(enc.pop_content_stats())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {k: fn.launches for k, fn in wrappers.items()}
    report.update(qps=qps, launches=launches, au_bytes=[len(a) for a in aus])
    print(f"intra main: {len(aus)} frames, qp {qps}, launches {launches}")
    check(all(v >= 1 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(len(set(qps)) > 1, "the rate controller did not move qp")
    fps = len(frames) / run_s
    normal = [m for i, m in enumerate(lat_ms) if i != NOISY_AT]
    print(f"intra e2e: {fps:.2f} frames/s over {len(frames)} frames (incl. "
          f"the overflow frame), p50 {statistics.median(lat_ms):.2f} ms, "
          f"p50 without it {statistics.median(normal):.2f} ms")
    print(f"intra host spans: submit p50 {statistics.median(sub_ms):.2f} ms "
          f"(colour, upload, launches), collect p50 "
          f"{statistics.median(col_ms):.2f} ms (wait, pull, Annex-B); "
          f"overflow frame collect {col_ms[NOISY_AT]:.0f} ms")
    report.update(fps=fps, p50_ms=statistics.median(lat_ms), lat_ms=lat_ms,
                  submit_ms=sub_ms, collect_ms=col_ms)
    report["device_busy"] = device_busy(enc, frames[2:8])

    # -- host costs --------------------------------------------------------
    col = []
    for f in frames[:5]:
        t = time.perf_counter()
        rgb_to_yuv420_host(f, enc.pad_h, enc.pad_w, float_fallback=True)
        col.append((time.perf_counter() - t) * 1e3)
    planes0 = tokens[0][4][3]
    hv, hl = enc._hdr_slots(0, tokens[0][4][2] - enc.qp)
    y0, cb0, cr0 = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                    for p in planes0)
    flat0 = bitmerge.pack_frame(
        *cavlc_device.frame_block_slots(
            h264_device.encode_intra_frame_yuv(y0, cb0, cr0, tokens[0][4][2])),
        hv, hl).cpu().numpy()
    meta0 = cavlc_device.FlatMeta(flat0, enc.mb_h)
    nal = []
    for _ in range(3):
        t = time.perf_counter()
        cavlc_device.assemble_annexb(flat0, meta0, headers=enc.headers())
        nal.append((time.perf_counter() - t) * 1e3)
    try:
        import cv2  # noqa: F401
        colour_path = "cv2"
    except ImportError:
        colour_path = "numpy"
    print(f"host colour ({colour_path}): {statistics.median(col):.2f} ms; "
          f"host EPB/NAL (pure Python): {statistics.median(nal):.2f} ms")
    report.update(host_colour_ms=statistics.median(col), colour_path=colour_path,
                  host_nal_ms=statistics.median(nal))

    # -- (a) kernels against their plain versions ---------------------------
    rows = []
    dirty = tokens[NOISY_AT][4]
    for label, tok in (("desktop", tokens[3][4]), ("overflow", dirty)):
        _, idr, qp, planes, _, _, _ = tok
        y, cb, cr = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                     for p in planes)
        hv, hl = enc._hdr_slots(idr, qp - enc.qp)
        lv_k = h264_device.encode_intra_frame_yuv(y, cb, cr, qp)
        lv_p = h264_device.encode_intra_frame_yuv_plain(y, cb, cr, qp)
        torch.cuda.synchronize()
        for k in lv_p:
            check(torch.equal(lv_k[k], lv_p[k]), f"K1 {label}: {k} differs")
        sl_k = cavlc_device.frame_block_slots(lv_k)
        sl_p = cavlc_device.frame_block_slots_plain(lv_k)
        for name, a, b in zip(("values", "lengths", "syn_vals", "syn_lens"),
                              sl_k, sl_p):
            check(torch.equal(a, b), f"K2 {label}: {name} differs")
        fl_k = bitmerge.pack_frame(*sl_k, hv, hl)
        fl_p = bitmerge.pack_frame_plain(*sl_k, hv, hl)
        m_k = cavlc_device.FlatMeta(fl_k[:4096].cpu().numpy(), enc.mb_h)
        check(torch.equal(fl_k[:4096], fl_p[:4096]), f"K3 {label}: META differs")
        if not m_k.overflow:
            n = 4096 + 4 * m_k.total_words
            check(torch.equal(fl_k[:n], fl_p[:n]), f"K3 {label}: RBSPs differ")
            check(not bool(fl_k[n:].any()), f"K3 {label}: tail not zero")
        check(m_k.overflow == (label == "overflow"),
              f"K3 {label}: overflow flag {m_k.overflow}")
        prev = torch.from_numpy(np.ascontiguousarray(tokens[2][4][3][0])).to(dev)
        v_k, g_k = content_stats.frame_stats(y, prev, 512)
        v_p, g_p = content_stats.frame_stats_plain(y, prev, 512)
        check(torch.equal(g_k, g_p), f"K4 {label}: damage grid differs")
        check(torch.equal(v_k[:7], v_p[:7]) and torch.equal(v_k[9:], v_p[9:]),
              f"K4 {label}: integer fields differ {v_k} {v_p}")
        rel = ((v_k[7:9] - v_p[7:9]).abs() / v_p[7:9].abs().clamp(min=1)).max()
        check(float(rel) <= EXACT_REL_TOL, f"K4 {label}: percentiles {v_k} {v_p}")
        print(f"(a) intra {label}: K1-K4 equal to their plain versions "
              f"(K4 percentile rel err {float(rel):.3g})")
        if label != "desktop":
            continue
        # timing at the main path's shapes, plain version beside the kernel
        out_k1 = nbytes(*lv_k.values())
        total_bytes = 4096 + 4 * m_k.total_words
        specs = [
            ("intra", "intra.cu", "h264_device.py:555 encode_intra_frame_yuv",
             lambda: h264_device.encode_intra_frame_yuv(y, cb, cr, qp),
             lambda: h264_device.encode_intra_frame_yuv_plain(y, cb, cr, qp),
             nbytes(y, cb, cr) + out_k1),
            ("cavlc_slots", "cavlc.cu", "cavlc_device.py:416 frame_block_slots",
             lambda: cavlc_device.frame_block_slots(lv_k),
             lambda: cavlc_device.frame_block_slots_plain(lv_k),
             nbytes(*[lv_k[k] for k in lv_k if not k.startswith("recon")])
             + nbytes(*sl_k)),
            ("pack", "pack.cu", "cavlc_device.py:629 pack_frame",
             lambda: bitmerge.pack_frame(*sl_k, hv, hl),
             lambda: bitmerge.pack_frame_plain(*sl_k, hv, hl),
             nbytes(*sl_k, hv, hl) + total_bytes),
            ("content_stats", "content.cu", "content_stats.py:156 frame_stats",
             lambda: content_stats.frame_stats(y, prev, 512),
             lambda: content_stats.frame_stats_plain(y, prev, 512),
             nbytes(y, prev) + nbytes(v_k, g_k)),
        ]
        saved = {k: fn.launches for k, fn in wrappers.items()}
        for name, src, replaces, fk, fp, nb in specs:
            err = (float((v_k[7:9] - v_p[7:9]).abs().max())
                   if name == "content_stats" else 0.0)
            rows.append(kernel_row(name, src, replaces, launches[name], err,
                                   cuda_ms(fk, reps=20), cuda_ms(fp, reps=3),
                                   nb))
        for k, fn in wrappers.items():
            fn.launches = saved[k]
        # K1's chain: 120 MBs in order, ~21 barrier-separated stages each,
        # ~0.5 us of dependent integer work per stage (estimate)
        depth_ms = enc.mb_w * 21 * 0.5e-3
        for r in rows:
            print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
                  f"{r['launches'] / len(frames):.2f} launches/frame)")
        print(f"kernel intra: sequential-depth estimate {depth_ms:.2f} ms "
              f"({enc.mb_w} MBs x 21 stages x ~0.5 us)")

    # -- (b) every access unit against the plain path on the card ------------
    for i, tok in enumerate(tokens):
        _, idr, qp, planes, _, _, _ = tok[4]
        y, cb, cr = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                     for p in planes)
        hv, hl = enc._hdr_slots(idr, qp - enc.qp)
        lv = h264_device.encode_intra_frame_yuv_plain(y, cb, cr, qp)
        flat = bitmerge.pack_frame_plain(
            *cavlc_device.frame_block_slots_plain(lv), hv, hl).cpu().numpy()
        meta = cavlc_device.FlatMeta(flat, enc.mb_h)
        if meta.overflow:
            ref = h264_entropy.encode_intra_picture(
                {k: v.cpu().numpy() for k, v in lv.items()
                 if not k.startswith("recon")},
                frame_num=0, idr_pic_id=idr, sps=enc._sps, pps=enc._pps,
                with_headers=True, qp_delta=qp - enc.qp,
                deblocking_idc=enc._deblock_idc, qp_map=None, slice_qp=qp)
        else:
            ref = cavlc_device.assemble_annexb(flat, meta, headers=enc.headers())
        check(aus[i] == ref, f"(b) intra frame {i}: AU differs from the plain path")
        # structure: SPS, PPS, then one IDR slice per MB row
        nals = aus[i].split(syn.START_CODE)[1:]
        types = [n[0] & 0x1F for n in nals]
        check(types == [syn.NAL_SPS, syn.NAL_PPS] + [syn.NAL_IDR] * enc.mb_h,
              f"frame {i}: NAL types {types[:4]}...")
        if i == 0:
            rec = lv["recon_y"][:H].double()
            mse = float(((rec - y[:H].double()) ** 2).mean())
            psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-9))
            check(psnr > 30.0, f"recon PSNR {psnr:.2f} dB")
            print(f"check: frame 0 recon luma PSNR {psnr:.2f} dB at qp {qp}")
    print(f"(b) intra: {len(aus)} access units equal to the plain path on the card")
    check(launches["intra"] == len(frames) + 1, "no overflow fallback ran")
    sd = [s for s in stats if s is not None]
    check(len(sd) == len(aus), "content stats missing for a frame")
    check(all(0.0 <= s["damage_fraction"] <= 1.0 for s in sd[1:]),
          "damage fraction out of range")
    return rows


def gop_phase(report):
    """The default configuration: IDR, P frames, deblock, rate control."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        bitmerge, cavlc_device, cavlc_p_device, content_stats, h264_deblock,
        h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    dev = torch.device("cuda")
    frames = gop_frames(GOP_FRAMES, noisy_at=GOP_NOISY_AT)
    wrappers = {
        "intra": h264_device.encode_intra_frame_yuv,
        "cavlc_slots": cavlc_device.frame_block_slots,
        "pack": bitmerge.pack_frame,
        "content_stats_full": content_stats.frame_stats_full,
        "inter": h264_inter.encode_p_frame,
        "cavlc_p_slots": cavlc_p_device.p_frame_slots,
        "pack_p": bitmerge.pack_p_frame,
        "deblock": h264_deblock.deblock_frame,
    }
    cfg = from_env({"SIZEW": str(W), "SIZEH": str(H)})
    enc, codec = make_encoder(cfg, W, H)
    check(enc.device.type == "cuda", "the encoder did not pick the card")
    check(enc.gop == 60 and enc.deblock and enc._rate is not None,
          f"not the default configuration: gop {enc.gop} deblock "
          f"{enc.deblock} rate {enc._rate}")

    # -- main path: two frames in flight -------------------------------------
    for fn in wrappers.values():
        fn.launches = 0
    toks, refs, aus, keys, overflow, stats = [], [], [], [], [], []
    pending = []
    for i, f in enumerate(frames + [None]):
        if f is not None:
            if i == GOP_KF_AT:
                enc.request_keyframe()
            tok = enc.encode_submit(f)
            toks.append(tok)
            refs.append(tuple(p.clone() for p in enc._ref))
            pending.append(tok)
        if len(pending) == 2 or (f is None and pending):
            tok = pending.pop(0)
            prefix = tok[4][5][0]
            overflow.append(cavlc_device.FlatMeta(prefix.numpy(),
                                                  enc.mb_h).overflow)
            ef = enc.encode_collect(tok)
            aus.append(ef.data)
            keys.append(ef.keyframe)
            stats.append(enc.pop_content_stats())
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    kinds = [t[0] for t in toks]
    qps = [t[4][0] if t[0] == "p" else t[4][2] for t in toks]
    idr_ids = [t[4][1] for t in toks if t[0] == "intra"]
    report["gop"] = {"qps": qps, "kinds": kinds, "launches": launches,
                     "au_bytes": [len(a) for a in aus], "overflow": overflow,
                     "idr_pic_ids": idr_ids}
    print(f"gop main: {len(aus)} frames, kinds {''.join(k[0] for k in kinds)}, "
          f"qp {qps}, idr_pic_id {idr_ids}, overflow at "
          f"{[i for i, o in enumerate(overflow) if o]}, launches {launches}")
    check(all(v >= 1 for v in launches.values()),
          f"a kernel of the GOP path never launched: {launches}")
    check(keys == [i in (0, GOP_KF_AT) for i in range(GOP_FRAMES)],
          f"keyframes {keys}")
    check(len(set(qps)) > 1, "the rate controller did not move qp")
    check(overflow[GOP_NOISY_AT] and kinds[GOP_NOISY_AT] == "p",
          "the noise P frame did not overflow into the host fallback")
    check(len(set(idr_ids)) == 2, f"consecutive IDRs share idr_pic_id {idr_ids}")
    check(launches["deblock"] == GOP_FRAMES,
          f"deblock launches {launches['deblock']} != {GOP_FRAMES} frames")
    sd = [s for s in stats if s is not None]
    check(len(sd) == len(aus), "content stats missing for a frame")
    p_stats = [s for s, k in zip(stats, kinds) if k == "p"]
    check(all(s["psnr_db"] is not None and s["mode"] is not None
              and s["mv_mean_qpel"] is not None for s in p_stats),
          "a P frame lacks PSNR, mode mix or MV stats")
    mv_frac = []

    # -- (b) every AU and deblocked reference against the plain chain --------
    t_b = time.perf_counter()
    plain_ref = None
    for i, tok in enumerate(toks):
        planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in enc._host_yuv420(frames[i])]
        if tok[0] == "intra":
            _, idr, qp, _, _, _, _ = tok[4]
            hv, hl = enc._hdr_slots(idr, qp - enc.qp)
            lv = h264_device.encode_intra_frame_yuv_plain(*planes, qp)
            flat = bitmerge.pack_frame_plain(
                *cavlc_device.frame_block_slots_plain(lv), hv, hl).cpu().numpy()
            meta = cavlc_device.FlatMeta(flat, enc.mb_h)
            if meta.overflow:
                want = h264_entropy.encode_intra_picture(
                    {k: v.cpu().numpy() for k, v in lv.items()
                     if not k.startswith("recon")},
                    frame_num=0, idr_pic_id=idr, sps=enc._sps, pps=enc._pps,
                    with_headers=True, qp_delta=qp - enc.qp,
                    deblocking_idc=enc._deblock_idc, qp_map=None, slice_qp=qp)
            else:
                want = cavlc_device.assemble_annexb(flat, meta,
                                                    headers=enc.headers())
            plain_ref = h264_deblock.deblock_frame_plain(
                lv["recon_y"], lv["recon_cb"], lv["recon_cr"], qp)
        else:
            qp, frame_num = tok[4][0], tok[4][1]
            hv, hl = enc._p_hdr_slots(frame_num, qp - enc.qp)
            out = h264_inter.encode_p_frame_plain(*planes, *plain_ref, qp)
            sl = cavlc_p_device.p_frame_slots_plain(out)
            flat = bitmerge.pack_p_frame_plain(*sl[:6], hv, hl).cpu().numpy()
            meta = cavlc_device.FlatMeta(flat, enc.mb_h)
            if meta.overflow:
                lv = {k: out[k].cpu().numpy()
                      for k in ("mv", "luma", "cb_dc", "cb_ac", "cr_dc",
                                "cr_ac")}
                want = h264_entropy.encode_p_picture(
                    lv, frame_num=frame_num, qp_delta=qp - enc.qp,
                    deblocking_idc=enc._deblock_idc, qp_map=None, slice_qp=qp)
            else:
                want = cavlc_device.assemble_annexb(
                    flat, meta, nal_type=syn.NAL_SLICE, ref_idc=2)
            mv_frac.append(float((out["mv"] % 4 != 0).any(dim=-1).float().mean()))
            plain_ref = h264_deblock.deblock_frame_plain(
                out["recon_y"], out["recon_cb"], out["recon_cr"], qp,
                nnz_blk=sl[6], mv=out["mv"])
        check(aus[i] == want, f"(b) gop frame {i} ({tok[0]}): AU differs "
              "from the plain path")
        for name, a, b in zip(("y", "cb", "cr"), refs[i], plain_ref):
            check(torch.equal(a, b), f"(b) gop frame {i}: deblocked {name} "
                  "reference differs from the plain deblock")
        nals = aus[i].split(syn.START_CODE)[1:]
        types = [n[0] & 0x1F for n in nals]
        want_types = ([syn.NAL_SPS, syn.NAL_PPS] + [syn.NAL_IDR] * enc.mb_h
                      if tok[0] == "intra" else [syn.NAL_SLICE] * enc.mb_h)
        check(types == want_types, f"gop frame {i}: NAL types {types[:4]}...")
    print(f"(b) gop: {len(aus)} access units and deblocked references equal "
          f"to the plain chain on the card ({time.perf_counter() - t_b:.0f} s); "
          f"P frames with a sub-pel MV: mean share of MBs "
          f"{statistics.mean(mv_frac):.3f}")
    check(max(mv_frac) > 0, "no sub-pel MV in the GOP run")

    # -- (c) a decoder's view: cv2 decodes the stream -------------------------
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("(c) cv2 decode: not run (no cv2 on this machine)")
        report["gop"]["cv2_decode"] = "not run"
    else:
        path = os.path.join(HERE, "chiprun_out", "gop.264")
        with open(path, "wb") as f:
            f.write(b"".join(aus))
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        for i, ref in enumerate(refs):
            ok, img = cap.read()
            check(ok, f"(c) cv2 stopped decoding at frame {i}")
            dec = np.asarray(img).reshape(H, W)
            check(np.array_equal(dec, ref[0][:H, :W].cpu().numpy()),
                  f"(c) frame {i}: decoded luma differs from the deblocked "
                  "reference")
        cap.release()
        os.remove(path)
        print(f"(c) cv2 decode: ran; {len(refs)} decoded luma planes equal "
              "to the encoder's deblocked references")
        report["gop"]["cv2_decode"] = "ran"

    # -- (a) kernels against their plain versions at this run's inputs --------
    pi = 3                                  # a P frame of the first GOP
    check(kinds[pi] == "p" and kinds[0] == "intra", "unexpected frame kinds")
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in enc._host_yuv420(frames[pi])]
    ref = refs[pi - 1]
    qp, frame_num = toks[pi][4][0], toks[pi][4][1]
    hv, hl = enc._p_hdr_slots(frame_num, qp - enc.qp)
    o_k = h264_inter.encode_p_frame(*planes, *ref, qp)
    o_p = h264_inter.encode_p_frame_plain(*planes, *ref, qp)
    torch.cuda.synchronize()
    for k in o_p:
        check(torch.equal(o_k[k], o_p[k]), f"K5: {k} differs")
    s_k = cavlc_p_device.p_frame_slots(o_k)
    s_p = cavlc_p_device.p_frame_slots_plain(o_k)
    for i, (a, b) in enumerate(zip(s_k, s_p)):
        check(torch.equal(a, b), f"K6: output {i} differs")
    f_k = bitmerge.pack_p_frame(*s_k[:6], hv, hl)
    f_p = bitmerge.pack_p_frame_plain(*s_k[:6], hv, hl)
    m_k = cavlc_device.FlatMeta(f_k[:4096].cpu().numpy(), enc.mb_h)
    n_flat = 4096 + 4 * m_k.total_words
    check(not m_k.overflow and torch.equal(f_k[:n_flat], f_p[:n_flat])
          and not bool(f_k[n_flat:].any()), "K7: flat differs")
    nnz, mv = s_k[6], o_k["mv"]
    recon = (o_k["recon_y"], o_k["recon_cb"], o_k["recon_cr"])
    d_k = h264_deblock.deblock_frame(*recon, qp, nnz_blk=nnz, mv=mv)
    d_p = h264_deblock.deblock_frame_plain(*recon, qp, nnz_blk=nnz, mv=mv)
    for a, b in zip(d_k, d_p):
        check(torch.equal(a, b), "K8 (P bS): differs")
    idr_planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in enc._host_yuv420(frames[0])]
    idr_qp = toks[0][4][2]
    lv0 = h264_device.encode_intra_frame_yuv(*idr_planes, idr_qp)
    recon0 = (lv0["recon_y"], lv0["recon_cb"], lv0["recon_cr"])
    i_k = h264_deblock.deblock_frame(*recon0, idr_qp)
    i_p = h264_deblock.deblock_frame_plain(*recon0, idr_qp)
    for a, b in zip(i_k, i_p):
        check(torch.equal(a, b), "K8 (intra bS): differs")
    resid = tuple(o_k[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"))
    prev_y = refs[pi - 1][0]                # any same-shape luma will do
    errs = []
    for args in ((recon[0], mv, resid), (recon0[0],)):
        v_k, g_k = content_stats.frame_stats_full(planes[0], prev_y, 512, *args)
        v_p, g_p = content_stats.frame_stats_full_plain(planes[0], prev_y, 512,
                                                        *args)
        check(torch.equal(g_k, g_p), "K4 full: damage grid differs")
        ints = [1, 2, 3, 4, 9]
        check(torch.equal(v_k[ints], v_p[ints]),
              f"K4 full: integer fields differ {v_k} {v_p}")
        rel = ((v_k - v_p).abs() / v_p.abs().clamp(min=1)).max()
        check(float(rel) <= FLOAT_REL_TOL, f"K4 full: {v_k} vs {v_p}")
        errs.append(float((v_k - v_p).abs().max()))
    print(f"(a) gop: K5, K6, K7, K8 (P and intra bS) and the full K4 equal to "
          f"their plain versions at frame {pi} (qp {qp}) and IDR 0 (qp "
          f"{idr_qp}); K4 full max abs err {max(errs):.3g}")

    # timing
    nmb = enc.mb_h * enc.mb_w
    vk, gk = content_stats.frame_stats_full(planes[0], prev_y, 512, recon[0],
                                            mv, resid)
    specs = [
        ("content_stats_full", "content.cu",
         "content_stats.py:156 frame_stats (full _frame_vec :120)",
         lambda: content_stats.frame_stats_full(planes[0], prev_y, 512,
                                                recon[0], mv, resid),
         lambda: content_stats.frame_stats_full_plain(planes[0], prev_y, 512,
                                                      recon[0], mv, resid),
         nbytes(planes[0], prev_y, recon[0], mv, *resid, vk, gk), 0.0,
         max(errs)),
        ("inter", "inter.cu", "h264_inter.py:272 encode_p_frame",
         lambda: h264_inter.encode_p_frame(*planes, *ref, qp),
         lambda: h264_inter.encode_p_frame_plain(*planes, *ref, qp),
         nbytes(*planes, *ref, *o_k.values()), k5_ops(nmb), 0.0),
        ("cavlc_p_slots", "cavlc.cu", "cavlc_p_device.py:158 p_frame_block_slots",
         lambda: cavlc_p_device.p_frame_slots(o_k),
         lambda: cavlc_p_device.p_frame_slots_plain(o_k),
         nbytes(mv, *resid, *s_k), 0.0, 0.0),
        ("pack_p", "pack.cu", "cavlc_p_device.py:298 pack_p_frame",
         lambda: bitmerge.pack_p_frame(*s_k[:6], hv, hl),
         lambda: bitmerge.pack_p_frame_plain(*s_k[:6], hv, hl),
         nbytes(*s_k[:6], hv, hl) + n_flat, 0.0, 0.0),
        ("deblock", "deblock.cu", "h264_deblock.py:225 deblock_frame",
         lambda: h264_deblock.deblock_frame(*recon, qp, nnz_blk=nnz, mv=mv),
         lambda: h264_deblock.deblock_frame_plain(*recon, qp, nnz_blk=nnz,
                                                  mv=mv),
         2 * nbytes(*recon) + nbytes(nnz, mv), 0.0, 0.0),
    ]
    saved = {k: fn.launches for k, fn in wrappers.items()}
    rows = []
    for name, src, replaces, fk, fp, nb, ops, err in specs:
        rows.append(kernel_row(name, src, replaces, launches[name], err,
                               cuda_ms(fk, reps=20), cuda_ms(fp, reps=3), nb,
                               ops))
    i_ms = cuda_ms(lambda: h264_deblock.deblock_frame(*recon0, idr_qp), reps=20)
    for k, fn in wrappers.items():
        fn.launches = saved[k]
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches'] / GOP_FRAMES:.2f} launches/frame)")
    print(f"kernel deblock (intra bS, IDR 0): {i_ms:.3f} ms")
    report["gop"]["deblock_intra_ms"] = i_ms

    # -- the GOP path timed with one frame in flight --------------------------
    timed = gop_frames(TIMED_FRAMES, seed=2)
    enc2, _ = make_encoder(cfg, W, H)
    lat, sub, col, kinds2 = [], [], [], []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for f in timed:
        ts = time.perf_counter()
        tok = enc2.encode_submit(f)
        tc = time.perf_counter()
        enc2.encode_collect(tok)
        te = time.perf_counter()
        sub.append((tc - ts) * 1e3)
        col.append((te - tc) * 1e3)
        lat.append((te - ts) * 1e3)
        kinds2.append(tok[0])
    run_s = time.perf_counter() - t_run
    p_lat = [m for m, k in zip(lat, kinds2) if k == "p"]
    colour = []
    for f in timed[:5]:
        t = time.perf_counter()
        enc2._host_yuv420(f)
        colour.append((time.perf_counter() - t) * 1e3)
    tok = enc2.encode_submit(timed[1])
    flat = tok[4][4].cpu().numpy()
    meta = cavlc_device.FlatMeta(flat, enc2.mb_h)
    nal = []
    for _ in range(3):
        t = time.perf_counter()
        cavlc_device.assemble_annexb(flat, meta, nal_type=syn.NAL_SLICE,
                                     ref_idc=2)
        nal.append((time.perf_counter() - t) * 1e3)
    enc2.encode_collect(tok)
    busy = device_busy(enc2, timed[2:10], depth=1)
    fps = len(timed) / run_s
    print(f"gop e2e (one frame in flight): {fps:.2f} frames/s over "
          f"{len(timed)} frames ({kinds2.count('p')} P), p50 "
          f"{statistics.median(lat):.2f} ms, P p50 {statistics.median(p_lat):.2f} "
          f"ms, IDR {lat[0]:.2f} ms")
    print(f"gop host spans: submit p50 {statistics.median(sub):.2f} ms (colour, "
          f"upload, launches), collect p50 {statistics.median(col):.2f} ms "
          f"(wait, pull, Annex-B), colour {statistics.median(colour):.2f} ms, "
          f"P-frame EPB/NAL {statistics.median(nal):.2f} ms")
    report["gop"].update(fps=fps, p50_ms=statistics.median(lat),
                         p50_p_ms=statistics.median(p_lat), lat_ms=lat,
                         submit_ms=sub, collect_ms=col,
                         colour_ms=statistics.median(colour),
                         nal_ms=statistics.median(nal), device_busy=busy)
    return rows


def main():
    try:
        return run()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
