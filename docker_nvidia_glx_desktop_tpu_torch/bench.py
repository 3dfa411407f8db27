"""The port's bench: encoded 1080p frames/s on one card and the device-only
step times of the encoder's stages, or (``--bdrate``) the BD-rate of the
tune tiers.

Run on the card::

    python -m docker_nvidia_glx_desktop_tpu_torch.bench            # main
    python -m docker_nvidia_glx_desktop_tpu_torch.bench --bdrate [--quick]

Prints ONE JSON line.  ``--device`` defaults to ``cuda``; without CUDA the
run raises unless ``--device cpu`` asks for the plain versions.  The
reference's knobs are read as it reads them: ``BENCH_TIMEOUT_S`` (the hang
watchdog and the blocks' time gates), ``BENCH_FRAMES``,
``BENCH_FRAMES_GOP`` and ``BENCH_PIPELINE_DEPTH``.

:func:`main` runs, in turn, the reference's default blocks
(``bench.py:111-607`` of the JAX package):

- the headline: the flagship encoder (all-intra device CAVLC with host
  colour) pipelined three frames deep over ``BENCH_FRAMES`` frames:
  frames/s and the p50/p90 frame ms;
- ``gop``: GOP 60 with device CAVLC;
- ``device_only``: :func:`ops.devloop.intra_loop` and ``p_loop`` (with the
  loop filter), differenced into a step ms by ``measure_steady_state``;
- ``cabac``: the CABAC device loops on both transports and the host
  stages (the native level decoder, ``encode_intra_picture``, the
  arithmetic engine ``encode_intra_from_binstream`` and the native CAVLC
  coder) on the bench frame and on a calm desktop;
- ``4k``: the intra and P loops at 3840x2160, the P core (also with the
  round-5 ``refine="full"``) and loop-filter profile, written into the
  budget ledger's device profile.

:func:`bdrate_main` is the reference's ``bdrate_main``: four synthetic
content classes over a qp ladder at the three tune tiers, each frame's
luma PSNR from the encoder's reconstruction against the source luma of
the device colour stage (K9), through :func:`ops.aq.psnr_planes` (K14d);
the exit code is 1 when tune=hq loses to tune=off on a class.

The JSON carries the card's name and power limit as ``nvidia-smi`` reports
them.  The reference's other modes raise naming their ROADMAP item:
``--spatial`` (11m), ``--serving-budget`` and ``--chaos`` (6b),
``--fleet`` (14), bare ``--quick`` (15b, the profiler's stage gates);
the observability stamp (``_stamp_obs``) waits for 15b.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

RESULT: dict = {}

FOURK = (3840, 2160)         # the 4k block's geometry (BASELINE config 4)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA bench yet "
        f"(ROADMAP queue 1 item {item})")


def _refusal(item: str) -> str:
    return f"not ported (item {item})"


def _device_info(dev) -> dict:
    """The device the numbers come from: the card's name and power limit
    as ``nvidia-smi`` reports them, or the host's CPU."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "smi": out.stdout.strip().splitlines()[0]
            if out.returncode == 0 and out.stdout.strip() else None}


def _p(vals, q):
    s = sorted(vals)
    return round(s[min(len(s) - 1, int(q / 100 * len(s)))], 2)


def _err(e: Exception, n: int = 300) -> str:
    return f"{type(e).__name__}: {e}"[:n]


def make_frames():
    """Desktop-like 1080p frames: gradients, a flat window, a strip of
    binary noise, then three copies rolled by 8, 16 and 24 pels (the
    reference's ``make_frames``)."""
    import numpy as np

    h, w = 1080, 1920
    r = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    frame = np.stack(
        [(xx * 255 // w), (yy * 255 // h), ((xx + yy) * 255 // (h + w))],
        axis=-1).astype(np.uint8)
    frame[h // 4:h // 2, w // 4:w // 2] = (240, 240, 235)
    frame[h // 2:h // 2 + h // 8] = (
        r.integers(0, 2, size=(h // 8, w, 3)) * 200).astype(np.uint8)
    frames = [frame]
    for shift in (8, 16, 24):  # mild motion so DC prediction isn't static
        frames.append(np.ascontiguousarray(np.roll(frame, shift, axis=1)))
    return frames


def _upload(planes, dev):
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            for p in planes]


def main(device=None) -> dict:
    """The default bench (see the module docstring).  Fills and returns
    :data:`RESULT`; a block's failure lands in its error key, as in the
    reference, and never hides the headline."""
    from .models import H264Encoder, make_flagship_encoder, resolve_device
    from .ops import devloop

    dev = resolve_device(device)
    t_start = time.perf_counter()
    budget_s = int(os.environ.get("BENCH_TIMEOUT_S", "600"))
    elapsed = lambda: time.perf_counter() - t_start  # noqa: E731
    RESULT.clear()
    RESULT.update({"metric": "h264_1080p_intra_encode_fps_per_chip",
                   "value": 0.0, "unit": "frames/sec/chip",
                   "vs_baseline": 0.0, "device": _device_info(dev)})

    frames = make_frames()
    h, w = frames[0].shape[:2]
    enc, codec_name = make_flagship_encoder(w, h, device=dev)
    RESULT["metric"] = f"{codec_name}_1080p_intra_encode_fps_per_chip"
    enc.encode(frames[0])  # build + table warmup
    enc.encode(frames[1])

    # --- the pipelined steady state (the serving loop's shape) ---
    depth = int(os.environ.get("BENCH_PIPELINE_DEPTH", "3"))
    n = int(os.environ.get("BENCH_FRAMES", "60"))
    lat_ms, submit_ms, collect_ms = [], [], []
    nbytes = 0
    t0_run = time.perf_counter()
    pending = []
    done = i = 0
    while done < n:
        while i < n and len(pending) < depth:
            t0 = time.perf_counter()
            pending.append(enc.encode_submit(frames[i % len(frames)]))
            submit_ms.append((time.perf_counter() - t0) * 1e3)
            i += 1
        t0 = time.perf_counter()
        ef = enc.encode_collect(pending.pop(0))
        collect_ms.append((time.perf_counter() - t0) * 1e3)
        lat_ms.append(ef.encode_ms)
        nbytes += len(ef.data)
        done += 1
    wall = time.perf_counter() - t0_run
    fps = n / wall
    RESULT.update({
        "value": round(fps, 2),
        "vs_baseline": round(fps / 60.0, 4),
        "p50_encode_ms": _p(lat_ms, 50),
        "p90_encode_ms": _p(lat_ms, 90),
        "avg_kbits_per_frame": round(nbytes * 8 / n / 1e3, 1),
        "codec": codec_name,
        "backend": dev.type,
        "host_cores": os.cpu_count(),
        "pipelined": True,
        "stage_ms": {
            # submit = host colour + upload + launch; collect = wait,
            # bitstream pull and Annex-B assembly
            "submit_p50": _p(submit_ms, 50),
            "collect_p50": _p(collect_ms, 50),
            "frame_interval_p50": round(wall / n * 1e3, 2),
        },
    })

    # --- GOP mode (IDR + P with device CAVLC), time-gated ---
    if elapsed() < budget_s * 0.5:
        try:
            genc = H264Encoder(w, h, mode="cavlc", entropy="device",
                               host_color=True, gop=60, device=dev)
            genc.encode(frames[0])
            for k in range(1, 1 + len(frames)):     # one content cycle
                genc.encode(frames[k % len(frames)])
            ng = int(os.environ.get("BENCH_FRAMES_GOP", "36"))
            gbytes = 0
            gsub, gcol = [], []
            tg = time.perf_counter()
            gp = []
            gi = gdone = 0
            while gdone < ng:
                while gi < ng and len(gp) < depth:
                    ts = time.perf_counter()
                    gp.append(genc.encode_submit(
                        frames[(gi + 2) % len(frames)]))
                    gsub.append((time.perf_counter() - ts) * 1e3)
                    gi += 1
                ts = time.perf_counter()
                gbytes += len(genc.encode_collect(gp.pop(0)).data)
                gcol.append((time.perf_counter() - ts) * 1e3)
                gdone += 1
            gwall = time.perf_counter() - tg
            RESULT["gop"] = {
                "fps": round(ng / gwall, 2),
                "avg_kbits_per_frame": round(gbytes * 8 / ng / 1e3, 1),
                "stage_ms": {"submit_p50": _p(gsub, 50),
                             "collect_p50": _p(gcol, 50),
                             "frame_interval_p50": round(
                                 gwall / ng * 1e3, 2)},
            }
        except Exception as e:  # never fail the primary metric
            RESULT["gop"] = {"error": _err(e)}

    # --- device-only steady state: captured steps replayed K times, a
    # 4-byte pull, two trip counts differenced ---
    if elapsed() < budget_s * 0.6:
        dv = {}
        RESULT["device_only"] = dv
        try:
            denc = (enc if getattr(enc, "host_color", False)
                    else H264Encoder(w, h, mode="cavlc", entropy="device",
                                     host_color=True, device=dev))
            planes = denc._host_yuv420(frames[0])
            if planes is None:
                raise RuntimeError("cv2 unavailable")
            d = _upload(planes, dev)
            hv, hl = denc._hdr_slots(0, 0)
            remaining = budget_s - elapsed()
            sub_budget = min(60.0, remaining * 0.18)
            qp = denc.qp
        except Exception as e:
            dv["error"] = _err(e)
        else:
            try:
                r = devloop.measure_steady_state(
                    lambda k: devloop.intra_loop(*d, hv, hl, k, qp),
                    budget_s=sub_budget)
                dv["intra_fps"] = r["fps"]
                dv["intra_step_ms"] = r["step_ms"]
            except Exception as e:
                dv["intra_error"] = _err(e)
            try:
                hvp, hlp = denc._p_hdr_slots(1, 0)
                r = devloop.measure_steady_state(
                    lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp,
                                             deblock=True),
                    budget_s=sub_budget)
                dv["p_fps"] = r["fps"]
                dv["p_step_ms"] = r["step_ms"]
                dv["p_deblock_in_loop"] = True
            except Exception as e:
                dv["p_error"] = _err(e)

    if elapsed() < budget_s * 0.72:
        cab = {}
        RESULT["cabac"] = cab
        try:
            _cabac_block(cab, frames, dev, budget_s, elapsed)
        except Exception as e:
            cab["error"] = _err(e)

    if elapsed() < budget_s * 0.8:
        fourk = {}
        RESULT["4k"] = fourk
        try:
            _fourk_block(fourk, frames, dev, budget_s, elapsed)
        except Exception as e:
            fourk["error"] = _err(e)
    return RESULT


def _cabac_block(cab: dict, frames, dev, budget_s: float, elapsed) -> None:
    """The CABAC path: the device stage's loops on both transports and the
    host stages on the bench frame's levels and on a calm desktop."""
    import numpy as np

    from .bitstream import h264_cabac
    from .models import H264Encoder
    from .ops import cabac_binarize, devloop, h264_device, level_pack

    h, w = frames[0].shape[:2]
    cenc = H264Encoder(w, h, mode="cavlc", entropy="cabac", host_color=True,
                       device=dev)
    d = _upload(cenc._host_yuv420(frames[0]), dev)
    sub_budget = min(45.0, (budget_s - elapsed()) * 0.15)
    qp = cenc.qp
    res = devloop.measure_steady_state(
        lambda k: devloop.cabac_intra_loop(*d, k, qp), budget_s=sub_budget)
    cab["intra_device_step_ms"] = res["step_ms"]
    lv = h264_device.encode_intra_frame_yuv(*d, qp)
    buf = level_pack.pack_levels(lv, level_pack.INTRA_KEYS).cpu().numpy() \
        .view(np.uint32)
    cab["payload_mb"] = round(int(buf[2]) * 4 / 1e6, 2)
    nrows = int(buf[3])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        level_pack.unpack_levels(buf, nrows, w // 16, level_pack.INTRA_KEYS)
        times.append((time.perf_counter() - t0) * 1e3)
    cab["host_unpack_ms"] = _p(times, 50)
    lvn = {k: v.cpu().numpy() for k, v in lv.items()
           if not k.startswith("recon")}
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        h264_cabac.encode_intra_picture(lvn, qp=qp)
        times.append((time.perf_counter() - t0) * 1e3)
    cab["intra_host_code_ms"] = _p(times, 50)
    nrows = (h + 15) // 16
    cab["rows"] = nrows
    cab["intra_host_code_ms_per_row"] = round(
        cab["intra_host_code_ms"] / nrows, 3)
    cab["host_cores"] = os.cpu_count()
    bound = max(cab["intra_device_step_ms"],
                cab["host_unpack_ms"] + cab["intra_host_code_ms"])
    cab["intra_pipelined_fps"] = round(1e3 / bound, 1)
    # the device-binarize split: the host runs only the arithmetic engine
    try:
        resb = devloop.measure_steady_state(
            lambda k: devloop.cabac_intra_loop(*d, k, qp, binarize=True),
            budget_s=min(45.0, max(10.0, (budget_s - elapsed()) * 0.12)))
        cab["intra_device_binarize_step_ms"] = resb["step_ms"]

        def binarized(levels):
            return cabac_binarize.binarize_intra(
                levels["luma_dc"], levels["luma_ac"], levels["cb_dc"],
                levels["cb_ac"], levels["cr_dc"], levels["cr_ac"],
                levels["pred_mode"], levels["mb_i4"], levels["i4_modes"],
                levels["luma_i4"]).cpu().numpy().view(np.uint32)

        def engine_ms(b):
            ts, au = [], None
            for _ in range(8):
                t0 = time.perf_counter()
                au = h264_cabac.encode_intra_from_binstream(
                    b, nr=int(b[3]), nc_mb=w // 16, qp=qp)
                ts.append((time.perf_counter() - t0) * 1e3)
            return au, _p(ts, 50)

        binbuf = binarized(lv)
        cab["binarize_payload_mb"] = round(int(binbuf[2]) * 4 / 1e6, 2)
        au0, eng0 = engine_ms(binbuf)
        if au0 is None:
            raise RuntimeError("binarize overflow on bench frame")
        cab["intra_host_engine_ms"] = eng0
        cab["intra_host_engine_ms_per_row"] = round(eng0 / nrows, 3)
        cab["intra_binarize_pipelined_fps"] = round(1e3 / max(
            cab["intra_device_binarize_step_ms"], eng0), 1)
        # calm desktop content: the bench frame's noise strip pins the
        # engine's bin count far above real desktop serving
        calm = frames[0].copy()
        calm[h // 2:h // 2 + h // 8] = (180, 180, 178)
        dcal = _upload(cenc._host_yuv420(calm), dev)
        bufc = binarized(h264_device.encode_intra_frame_yuv(*dcal, qp))
        auc, eng = engine_ms(bufc)
        if auc is not None:
            cab["calm_desktop"] = {
                "payload_mb": round(int(bufc[2]) * 4 / 1e6, 2),
                "host_engine_ms": eng,
                "host_engine_ms_per_row": round(eng / nrows, 3),
                "pipelined_fps": round(1e3 / max(
                    cab["intra_device_binarize_step_ms"], eng), 1),
            }
        if cab["intra_binarize_pipelined_fps"] > cab["intra_pipelined_fps"]:
            cab["intra_pipelined_fps"] = cab["intra_binarize_pipelined_fps"]
            cab["split"] = "device-binarize"
        else:
            cab["split"] = "host-coder"
    except Exception as e:
        cab["binarize_error"] = _err(e)
    # the native CAVLC host coder (native/cavlc.cpp) on the same levels'
    # luma/chroma DC and AC arrays: the per-row host stage of
    # ENCODER_ENTROPY=native, timed as the reference times it
    from .native import lib as native_lib

    lv_dc = {k: np.ascontiguousarray(lvn[k], np.int32)
             for k in ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc",
                       "cr_ac")}
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        native_lib.h264_encode_intra_picture(lv_dc, frame_num=0, idr_pic_id=0)
        times.append((time.perf_counter() - t0) * 1e3)
    cab["cavlc_host_code_ms"] = _p(times, 50)
    cab["cavlc_host_code_ms_per_row"] = round(
        cab["cavlc_host_code_ms"] / nrows, 3)
    # the P device stage: inter + deblock + compaction, recon-chained
    resp = devloop.measure_steady_state(
        lambda k: devloop.cabac_p_loop(*d, *d, k, qp), budget_s=sub_budget)
    cab["p_device_step_ms"] = resp["step_ms"]


def _fourk_block(fourk: dict, frames, dev, budget_s: float, elapsed) -> None:
    """BASELINE config 4: the device-only intra and P loops at 4K, then the
    P core and loop-filter profile into the ledger's device profile."""
    import numpy as np
    import torch

    from .models import H264Encoder
    from .obs.budget import LEDGER
    from .ops import devloop

    w4, h4 = FOURK
    f4 = np.tile(frames[0], (2, 2, 1))[:h4, :w4]
    kenc = H264Encoder(w4, h4, mode="cavlc", entropy="device",
                       host_color=True, device=dev)
    planes = kenc._host_yuv420(f4)
    if planes is None:
        raise RuntimeError("cv2 unavailable")
    d = _upload(planes, dev)
    hv, hl = kenc._hdr_slots(0, 0)
    sub_budget = min(45.0, (budget_s - elapsed()) * 0.2)
    qp = kenc.qp
    try:
        r4 = devloop.measure_steady_state(
            lambda k: devloop.intra_loop(*d, hv, hl, k, qp),
            budget_s=sub_budget)
        fourk["intra_step_ms"] = r4["step_ms"]
        fourk["intra_fps"] = r4["fps"]
    except Exception as e:
        fourk["intra_error"] = _err(e, 200)
    try:
        hvp, hlp = kenc._p_hdr_slots(1, 0)
        rp4 = devloop.measure_steady_state(
            lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp, deblock=True),
            budget_s=sub_budget)
        fourk["p_step_ms"] = rp4["step_ms"]
        fourk["p_fps"] = rp4["fps"]
        fourk["meets_4k30"] = rp4["step_ms"] <= 33.3
    except Exception as e:
        fourk["p_error"] = _err(e, 200)
    # the P core (and its round-5 full-line refinement) and the loop
    # filter alone; K8 has one schedule for every wavefront group, so the
    # reference's deblock_step_ms_r5_column and _wavefront_g8 keys would
    # repeat deblock_step_ms and are left out
    try:
        prof = {}
        fourk["profile"] = prof
        pb = min(30.0, max(8.0, (budget_s - elapsed()) * 0.04))
        me = devloop.measure_steady_state(
            lambda k: devloop.inter_loop(*d, *d, k, qp), budget_s=pb)
        me_old = devloop.measure_steady_state(
            lambda k: devloop.inter_loop(*d, *d, k, qp, refine="full"),
            budget_s=pb)
        db = devloop.measure_steady_state(
            lambda k: devloop.deblock_loop(*d, k, qp), budget_s=pb)
        prof["me_step_ms"] = me["step_ms"]
        prof["me_step_ms_r5_fullline"] = me_old["step_ms"]
        prof["me_improvement_pct"] = round(
            (1 - me["step_ms"] / me_old["step_ms"]) * 100, 1)
        prof["deblock_step_ms"] = db["step_ms"]
        if "p_step_ms" in fourk:
            prof["entropy_step_ms_est"] = round(max(
                fourk["p_step_ms"] - prof["me_step_ms"]
                - prof["deblock_step_ms"], 0.0), 3)
            LEDGER.set_device_profile({
                "device-me": prof["me_step_ms"],
                "device-deblock": prof["deblock_step_ms"],
                "device-entropy": prof["entropy_step_ms_est"],
            })
            fourk["budget_attribution"] = LEDGER.device_profile
    except Exception as e:
        fourk["profile_error"] = _err(e, 200)
    # one session's frame across several cards: the forced-host-mesh
    # block needs shards on distinct cards (item 11m)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    fourk["sharded"] = {"skipped": "single-device backend" if n_dev < 2
                        else _refusal("11m")}


# ---------------------------------------------------------------------------
# BD-rate (--bdrate)
# ---------------------------------------------------------------------------

def _bdrate_frames(kind: str, w: int, h: int, n: int):
    """Synthetic content classes for the BD-rate harness, seeded (the
    reference's ``_bdrate_frames``): ``desktop_text`` (window chrome and
    glyph rows scrolling 2 px/frame), ``natural_gradients`` (smooth
    gradients drifting), ``panning_motion`` (band-limited texture panning
    4 px/frame) and ``scrolling`` (a document panned 8 px/frame)."""
    import numpy as np

    r = np.random.default_rng(42)
    if kind == "desktop_text":
        # continuous micro-grain keeps PSNR(qp) monotonic; flat margins
        # give the AQ map flat MBs; a scrolling text column
        grain = r.normal(0.0, 2.0, (h, w, 1))
        base = np.clip(246.0 + grain, 0, 255).astype(np.uint8).repeat(3, 2)
        base[: h // 8] = (58, 62, 70)                 # title bar
        base[: h // 8] += r.integers(0, 3, (h // 8, w, 3)).astype(np.uint8)
        glyphs = (r.random((h, w)) < 0.18) & (
            (np.arange(h) % 8 < 5)[:, None])          # text lines
        glyphs[:, : w // 4] = False                   # left margin
        glyphs[:, w - w // 6:] = False                # right margin
        pane = slice(h // 8 + 8, h - 8)
        frames = []
        for i in range(n):
            f = base.copy()
            g = np.roll(glyphs, -2 * i, axis=0)       # scrolling pane
            f[pane][g[pane]] = (16, 16, 20)
            frames.append(f)
        return frames
    if kind == "natural_gradients":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        frames = []
        for i in range(n):
            ph = i * 0.35
            g = (110 + 70 * np.sin(xx / w * 3.1 + ph)
                 + 55 * np.cos(yy / h * 2.3 + 0.4 * ph))
            f = np.stack([g, g * 0.92 + 12, g * 0.85 + 25], axis=-1)
            frames.append(np.clip(f, 0, 255).astype(np.uint8))
        return frames
    if kind == "panning_motion":
        # band-limited texture: blurred noise, tiled wide enough to pan
        big = r.integers(0, 256, (h, w * 2, 3)).astype(np.float64)
        k = 7
        kern = np.ones(k) / k
        for ax in (0, 1):
            big = np.apply_along_axis(
                lambda v: np.convolve(v, kern, mode="same"), ax, big)
        big = np.clip((big - big.mean()) * 3.0 + 128, 0, 255)
        big = big.astype(np.uint8)
        return [np.ascontiguousarray(big[:, 4 * i:4 * i + w])
                for i in range(n)]
    if kind == "scrolling":
        # a tall document (ruled text, grey figures) scrolled 8 px/frame
        doc_h = h + 8 * n
        grain = r.normal(0.0, 2.0, (doc_h, w, 1))
        doc = np.clip(248.0 + grain, 0, 255).astype(np.uint8).repeat(3, 2)
        text = (r.random((doc_h, w)) < 0.16) & (
            (np.arange(doc_h) % 10 < 6)[:, None])
        text[:, : w // 6] = False
        text[:, w - w // 8:] = False
        doc[text] = (20, 20, 24)
        for fy in range(0, doc_h - h // 3, max(doc_h // 5, 1)):
            doc[fy:fy + h // 6, w // 3:w - w // 3] = (
                r.integers(96, 160, (1, 1, 3)).astype(np.uint8))
        return [np.ascontiguousarray(doc[8 * i:8 * i + h])
                for i in range(n)]
    raise ValueError(kind)


def _bd_rate_pct(rate_ref, psnr_ref, rate_new, psnr_new) -> float:
    """Bjontegaard rate delta of NEW vs REF, percent (negative = NEW spends
    fewer bits at equal quality): a cubic log-rate fit over the
    overlapping PSNR interval."""
    import numpy as np

    la, lb = np.log10(rate_ref), np.log10(rate_new)
    pa = np.polyfit(psnr_ref, la, 3)
    pb = np.polyfit(psnr_new, lb, 3)
    lo = max(np.min(psnr_ref), np.min(psnr_new))
    hi = min(np.max(psnr_ref), np.max(psnr_new))
    if hi - lo < 1e-6:
        return 0.0
    ia, ib = np.polyint(pa), np.polyint(pb)
    span = lambda p: np.polyval(p, hi) - np.polyval(p, lo)  # noqa: E731
    avg = (span(ib) - span(ia)) / (hi - lo)
    return float((10.0 ** avg - 1.0) * 100.0)


def run_tier(frames, tier: str, qp: int, w: int, h: int, device=None,
             warm_only: bool = False):
    """One BD-rate point: ``frames`` through ``H264Encoder(keep_recon=True,
    tune=tier)`` as one GOP at ``qp``.  Returns the bits, the mean luma
    PSNR of the reconstructions against the K9 source luma, each frame's
    bits and PSNR, the P frames' p50 encode ms and the CPU-energy proxy
    (None with ``warm_only``, which encodes two frames)."""
    import numpy as np
    import torch

    from .models import H264Encoder, resolve_device
    from .obs import procstats
    from .ops import aq, color

    dev = resolve_device(device)
    enc = H264Encoder(w, h, qp=qp, mode="cavlc", entropy="device",
                      gop=len(frames), keep_recon=True, tune=tier,
                      device=dev)
    if warm_only:                       # build the I and P paths only
        for f in frames[:2]:
            enc.encode(f)
        return None
    src_y = [color.rgb_to_yuv420(torch.from_numpy(f).to(dev), enc.pad_h,
                                 enc.pad_w)[0] for f in frames]
    bits, psnrs, sizes, times = 0, [], [], []
    meter = procstats.CpuEnergyMeter()
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        ef = enc.encode(f)
        dt = (time.perf_counter() - t0) * 1e3
        if i:                           # the P frames' steady state
            times.append(dt)
        bits += len(ef.data) * 8
        sizes.append(len(ef.data) * 8)
        psnrs.append(aq.psnr_planes(enc.last_recon[0], src_y[i], dev))
    energy = meter.publish(frames=len(frames), tune=tier)
    return {"bits": bits, "psnr_y": round(float(np.mean(psnrs)), 3),
            "frame_bits": sizes, "frame_psnr_y": psnrs,
            "p_step_ms_p50": round(float(np.median(times)), 3),
            "energy": energy}


def bdrate_main(quick: bool = False, device=None) -> dict:
    """The BD-rate harness (the reference's ``bdrate_main``): four content
    classes over the qp ladder (26, 30, 34, 38) at tune ``off``,
    ``hq_noaq`` and ``hq``; the Bjontegaard rate delta of each tuned tier
    against off, the tiers' P step cost and the CPU-energy proxy.  The
    harness drives the per-frame path (``keep_recon`` keeps the ring
    off), so the hq tier runs without the ring's lookahead.  Fills and
    returns :data:`RESULT`; ``RESULT["bdrate"]["ok"]`` is the gate (hq
    never loses to off, its step cost at most 1.5x)."""
    import numpy as np

    from .models import resolve_device
    from .obs import budget as obs_budget

    dev = resolve_device(device)
    RESULT.clear()
    w, h = (192, 112) if quick else (448, 256)
    n = 9 if quick else 12
    qps = (26, 30, 34, 38)
    tiers = ("off", "hq_noaq", "hq")
    classes = ("desktop_text", "natural_gradients", "panning_motion",
               "scrolling")
    block = {"geometry": f"{w}x{h}", "frames": n, "qps": list(qps),
             "backend": dev.type, "quick": bool(quick), "classes": {}}
    worst_gain = best_gain = None
    max_cost = 0.0
    for cls in classes:
        frames = _bdrate_frames(cls, w, h, n)
        per_tier = {t: {"rate_bits": [], "psnr_y": [],
                        "p_step_ms_p50": [], "joules_per_frame_proxy": []}
                    for t in tiers}
        for qp in qps:
            for t in tiers:
                # build the paths before the timed pass
                run_tier(frames, t, qp, w, h, dev, warm_only=True)
                r = run_tier(frames, t, qp, w, h, dev)
                per_tier[t]["rate_bits"].append(r["bits"])
                per_tier[t]["psnr_y"].append(r["psnr_y"])
                per_tier[t]["p_step_ms_p50"].append(r["p_step_ms_p50"])
                per_tier[t]["joules_per_frame_proxy"].append(
                    r["energy"]["joules_per_frame_proxy"])
        crow = {"tiers": per_tier}
        off = per_tier["off"]
        for t in ("hq_noaq", "hq"):
            crow[f"bd_rate_{t}_vs_off_pct"] = round(_bd_rate_pct(
                off["rate_bits"], off["psnr_y"], per_tier[t]["rate_bits"],
                per_tier[t]["psnr_y"]), 2)
        cost = (float(np.median(per_tier["hq"]["p_step_ms_p50"]))
                / max(float(np.median(off["p_step_ms_p50"])), 1e-9))
        crow["step_cost_ratio_hq"] = round(cost, 3)
        block["classes"][cls] = crow
        gain = -crow["bd_rate_hq_vs_off_pct"]
        worst_gain = gain if worst_gain is None else min(worst_gain, gain)
        best_gain = gain if best_gain is None else max(best_gain, gain)
        max_cost = max(max_cost, cost)
    block["best_gain_pct"] = round(best_gain, 2)
    block["worst_gain_pct"] = round(worst_gain, 2)
    block["max_step_cost_ratio"] = round(max_cost, 3)
    block["ok"] = bool(worst_gain >= 0.0 and max_cost <= 1.5)
    block["meets_15pct_gain"] = bool(best_gain >= 15.0 and max_cost <= 1.5)
    obs_budget.record_bdrate(block)
    RESULT.update({
        "metric": "h264_hq_best_bdrate_gain_pct",
        "value": block["best_gain_pct"],
        "unit": "pct_fewer_bits_at_equal_psnr",
        "vs_baseline": round(block["best_gain_pct"] / 15.0, 3),
        "backend": dev.type,
        "device": _device_info(dev),
        "bdrate": block,
    })
    return RESULT


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def _watchdog(signum, frame):
    RESULT["note"] = "watchdog timeout (BENCH_TIMEOUT_S)"
    print(json.dumps(RESULT), flush=True)
    os._exit(1)


def _arm_watchdog(default_s: int) -> None:
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(int(os.environ.get("BENCH_TIMEOUT_S", str(default_s))))


def cli(argv=None) -> int:
    """Parse the reference's flags, run, print the JSON line; returns the
    exit code."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bdrate", action="store_true",
                    help="BD-rate of the tune tiers over a qp ladder")
    ap.add_argument("--quick", action="store_true",
                    help="with --bdrate: the smoke geometry")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    for flag, item in (("--spatial", "11m"), ("--serving-budget", "6b"),
                       ("--chaos", "6b"), ("--fleet", "14")):
        ap.add_argument(flag, action="store_true",
                        help=f"not ported yet (ROADMAP item {item})")
    args = ap.parse_args(argv)
    for flag, item in (("spatial", "11m"), ("serving_budget", "6b"),
                       ("chaos", "6b"), ("fleet", "14")):
        if getattr(args, flag):
            raise _not_ported(f"bench --{flag.replace('_', '-')}", item)
    if args.quick and not args.bdrate:
        raise _not_ported("bench --quick (the stage-budget smoke)", "15b")
    from .models import resolve_device

    dev = resolve_device(args.device)
    _arm_watchdog((420 if args.quick else 1800) if args.bdrate else 600)
    try:
        if args.bdrate:
            code = 0 if bdrate_main(args.quick, dev)["bdrate"]["ok"] else 1
        else:
            main(dev)
            code = 0
    finally:
        signal.alarm(0)
    print(json.dumps(RESULT), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(cli())
