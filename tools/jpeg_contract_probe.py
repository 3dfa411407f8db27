#!/usr/bin/env python3
"""The JPEG transform's float contract, measured on the CPU: the port's
plain K16a (float64 in one fixed order, rounded once to float32) against
the JAX reference (float32 in XLA-CPU's order) on seeded frames.

Prints, per frame (seeded noise, and the same noise darkened to 0..15,
whose DCs lie near -1000): the largest coefficient difference, and the
largest in float32 ulps among coefficients of magnitude >= 256; the share of luma and chroma levels
that differ, by how much, and how far the reference's ``c / q`` lay from
a half-integer where they differ.

Run: ``JAX_PLATFORMS=cpu python3 tools/jpeg_contract_probe.py [--h 272
--w 480 --seeds 0 1 2]`` from the repository root.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=272)
    ap.add_argument("--w", type=int, default=480)
    ap.add_argument("--quality", type=int, default=85)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import torch

    from docker_nvidia_glx_desktop_tpu.ops import color as j_color
    from docker_nvidia_glx_desktop_tpu.ops import dct as j_dct
    from docker_nvidia_glx_desktop_tpu_torch.ops import color, dct, quant

    lq, cq = quant.jpeg_quality_tables(args.quality)

    def compare(rgb):
        jp = [np.asarray(a) for a in j_color.rgb_to_yuv420(rgb, "full")]
        tp = color.rgb_to_yuv420_full(torch.from_numpy(rgb))
        out = []
        for name, a, b, q in (("Y", jp[0], tp[0], lq), ("Cb", jp[1], tp[1], cq),
                              ("Cr", jp[2], tp[2], cq)):
            want = np.asarray(j_dct.dct8x8(j_dct.to_blocks(a - 128.0, 8, 8)))
            got = dct.dct8x8(dct.to_blocks(b - 128.0, 8, 8)).numpy()
            diff = np.abs(got - want)
            big = np.abs(want) >= 256
            ulps = (diff[big] / np.spacing(np.abs(want[big]))).max() \
                if big.any() else 0.0
            ratio = want / q.astype(np.float32)
            lev_ref = np.round(ratio).astype(np.int64)
            lev = quant.jpeg_quantize(torch.from_numpy(got), q).numpy()
            bad = lev != lev_ref
            tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5)
            out.append(f"{name}: max |dc| {diff.max():.3g} ({ulps:.1f} ulps "
                       f"where |c| >= 256), levels differing {bad.mean():.3g} "
                       f"({int(bad.sum())} of {bad.size}, by "
                       f"{sorted(set(np.abs(lev - lev_ref)[bad].tolist()))}, "
                       f"max distance of c/q from a half-integer there "
                       f"{tie[bad].max() if bad.any() else 0:.3g})")
        return "; ".join(out)

    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        noise = rng.integers(0, 256, (args.h, args.w, 3), dtype=np.uint8)
        for kind, rgb in (("noise", noise), ("dark", noise // 16)):
            print(f"seed {seed} {kind} {args.w}x{args.h} q{args.quality}: "
                  + compare(rgb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
