#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's all-intra H.264 encoder through the entry points a
serving session calls (``make_encoder(from_env(...))``, ``encode_submit``
/ ``encode_collect``) at 1920x1080 with ``ENCODER_GOP=1`` and the default
rate control, on synthetic desktop-like frames from a seeded generator,
one of them noisy enough to overflow the packer and take the host-entropy
fallback.  Phases, each of which fails the run:

  build   nvcc builds every kernel of ``csrc/`` (one process per source)
  main    the encode loop; every kernel's launch counter must move
  (a)     each kernel against its plain PyTorch version on the same CUDA
          inputs at the main path's shapes (exact; activity percentiles
          within 1e-6 relative), timed with CUDA events
  (b)     every frame's access unit against the plain path on the card
  check   NAL structure of every AU and the luma PSNR of the recon

Prints the card's name and power limit, per-kernel times beside their
bounds, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.

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
N_FRAMES = 16              # desktop frames; one noisy frame is added
NOISY_AT = 1               # still at the first frames' qp: it overflows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
EXACT_REL_TOL = 1e-6       # activity percentiles (float32 interpolation)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def desktop_frames(n: int, seed: int = 0):
    """Desktop-like RGB frames: gradient wallpaper, flat windows with
    title bars, glyph-like strokes, a region that scrolls every frame and
    a window that appears part-way; plus one frame of noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
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


def device_busy(enc, frames):
    """Device busy share over a short pipelined window, from a
    torch.profiler trace (kernel and copy time over host wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tok = None
            for f in frames:
                nxt = enc.encode_submit(f)
                if tok is not None:
                    enc.encode_collect(tok)
                tok = nxt
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
    print(f"device busy share: {share:.3f} over {len(frames)} frames "
          f"({busy_us / 1e3 / len(frames):.2f} ms device / "
          f"{wall_ms / len(frames):.2f} ms wall per frame); top: " + "; ".join(
              f"{e.key[:40]} {getattr(e, 'self_device_time_total', 0.0) / 1e3 / len(frames):.3f} ms"
              for e in top))
    return {"share": share, "wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "frames": len(frames)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def run():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
        from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy
        from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
        from docker_nvidia_glx_desktop_tpu_torch.ops import (
            _cuda, bitmerge, cavlc_device, content_stats, h264_device)
        from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
        from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
            rgb_to_yuv420_host)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    dev = torch.device("cuda")
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
    print(f"main: {len(aus)} frames, qp {qps}, launches {launches}")
    check(all(v >= 1 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(len(set(qps)) > 1, "the rate controller did not move qp")
    fps = len(frames) / run_s
    normal = [m for i, m in enumerate(lat_ms) if i != NOISY_AT]
    print(f"e2e: {fps:.2f} frames/s over {len(frames)} frames (incl. the "
          f"overflow frame), p50 {statistics.median(lat_ms):.2f} ms, "
          f"p50 without it {statistics.median(normal):.2f} ms")
    print(f"host spans: submit p50 {statistics.median(sub_ms):.2f} ms "
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
        print(f"(a) {label}: K1-K4 equal to their plain versions "
              f"(K4 percentile rel err {float(rel):.3g})")
        if label != "desktop":
            continue
        # timing at the main path's shapes, plain version beside the kernel
        out_k1 = nbytes(*lv_k.values())
        total_bytes = 4096 + 4 * m_k.total_words
        specs = [
            ("intra", "h264_device.py:555 encode_intra_frame_yuv",
             "docker_nvidia_glx_desktop_tpu_torch/csrc/intra.cu",
             lambda: h264_device.encode_intra_frame_yuv(y, cb, cr, qp),
             lambda: h264_device.encode_intra_frame_yuv_plain(y, cb, cr, qp),
             nbytes(y, cb, cr) + out_k1),
            ("cavlc_slots", "cavlc_device.py:416 frame_block_slots",
             "docker_nvidia_glx_desktop_tpu_torch/csrc/cavlc.cu",
             lambda: cavlc_device.frame_block_slots(lv_k),
             lambda: cavlc_device.frame_block_slots_plain(lv_k),
             nbytes(*[lv_k[k] for k in lv_k if not k.startswith("recon")])
             + nbytes(*sl_k)),
            ("pack", "cavlc_device.py:629 pack_frame",
             "docker_nvidia_glx_desktop_tpu_torch/csrc/pack.cu",
             lambda: bitmerge.pack_frame(*sl_k, hv, hl),
             lambda: bitmerge.pack_frame_plain(*sl_k, hv, hl),
             nbytes(*sl_k, hv, hl) + total_bytes),
            ("content_stats", "content_stats.py:156 frame_stats",
             "docker_nvidia_glx_desktop_tpu_torch/csrc/content.cu",
             lambda: content_stats.frame_stats(y, prev, 512),
             lambda: content_stats.frame_stats_plain(y, prev, 512),
             nbytes(y, prev) + nbytes(v_k, g_k)),
        ]
        saved = {k: fn.launches for k, fn in wrappers.items()}
        for name, replaces, src, fk, fp, nb in specs:
            ms = cuda_ms(fk, reps=20)
            plain_ms = cuda_ms(fp, reps=3)
            bound = nb / HBM_BYTES_PER_S * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": "docker_nvidia_glx_desktop_tpu/ops/" + replaces,
                "launches": launches[name], "max_abs_err": 0.0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": None})
        for k, fn in wrappers.items():
            fn.launches = saved[k]
        rows[-1]["max_abs_err"] = float((v_k[7:9] - v_p[7:9]).abs().max())
        # K1's chain: 120 MBs in order, ~21 barrier-separated stages each,
        # ~0.5 us of dependent integer work per stage (estimate)
        depth_ms = enc.mb_w * 21 * 0.5e-3
        for r in rows:
            print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
                  f"by bytes; plain {r['plain_ms']:.2f} ms; "
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
        check(aus[i] == ref, f"(b) frame {i}: AU differs from the plain path")
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
    print(f"(b) {len(aus)} access units equal to the plain path on the card")
    check(launches["intra"] == len(frames) + 1, "no overflow fallback ran")
    sd = [s for s in stats if s is not None]
    check(len(sd) == len(aus), "content stats missing for a frame")
    check(all(0.0 <= s["damage_fraction"] <= 1.0 for s in sd[1:]),
          "damage fraction out of range")
    check("jax" not in sys.modules, "the port imported jax")
    report["kernels"] = rows
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    try:
        return run()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
