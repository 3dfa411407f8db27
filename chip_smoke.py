#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's H.264 encoder through the entry points a serving
session calls (``make_encoder(from_env(...))``, ``encode_submit`` /
``encode_collect``) at 1920x1080 on synthetic desktop-like frames from a
seeded generator, in twenty-one phases:

- **intra**: ``ENCODER_GOP=1``, the default rate control, one frame
  noisy enough to overflow the packer and take the host fallback
  (kernels K1-K4);
- **gop**: the default serving configuration (GOP 60, deblock on, rate
  control on): an IDR, then P frames over a static region, scrolling
  text and a window dragged by a sub-pel displacement, a requested
  keyframe halfway (a second IDR through the intra loop filter), one
  full-noise P frame that overflows the packer and takes the P host
  fallback, two frames in flight (K1-K3, K4 full form, K5-K8);
- **chain**: K1 and K6 against their plain versions on the inputs
  their designs are sensitive to (K1: full noise at each tier, saturated
  planes, 8 stacked sessions, 4K; K6: all-skip, full noise, I16-in-P, 8
  sessions), with the two sources' ``-Xptxas -v`` lines and each
  wrapper's kernels by device time;
- **k2k8**: K2 and K8 against their plain versions on the inputs that
  break their designs (K8: qp 15, 30 and 51, random flags with MV steps
  of 3 and 4 quarter pels, saturated and flat bands, the ``luma`` and
  ``qp_dev`` forms, 8 sessions, worklists of 1, 8 and 68 rows, shard
  rows, 4K; K2: zero, dense and escape-coded levels, I4 and I16 mixed,
  chroma DC only and AC, 1 to 240 MBs wide, 8 sessions, the qp chain);
- **k3k7**: K3 and K7 (26 blocks, and 27 with the qp sum) against
  their plain versions, whole flat buffers, on synthetic slots that break
  the segment design (widths of 1 MB to 240, all-zero blocks and all-skip
  rows, 32-bit codewords, pieces and MBs at the caps and one bit over,
  totals at FLAT_CAP_WORDS and one word over, pad 0 and 7, 8 sessions
  with shared and per-session header slots, worklist frames, nx = 2
  bands, 4K) and on 1080p slots of a desktop IDR and a moving P frame;
- **k11k16**: K16c (the JPEG bit pack) and K11p (the CABAC P binarizer)
  against their plain versions, byte for byte, on crafted inputs that
  break their segment designs (``tests/jpeg_levels.py``'s levels; skip
  runs, dense levels, budget overflows and an MB over its cap) and on
  every form of their main paths;
- **k10k11i**: K10 (the CABAC level transport) and K11i (the CABAC
  intra binarizer) against their plain versions, header and payload word
  for word, on crafted inputs that break their segment designs
  (``tests/level_slots.py``'s slots; flat to dense levels, budget
  overflows, all-I_NxN and checkerboard frames, an MB over its cap) and on
  every form of their main paths;
- **i16halo**: the halo pad 15e and K5's I16-in-P passes against their
  plain versions on crafted inputs that break their designs (15e: nx 1,
  2, 4, halo on and off, 1080p and 4K, tail words, sources off a 16-byte
  boundary; the passes: all, none, alternating, runs across segments and
  random wanting MBs at 1, 7, 9 and 120 MBs a row, tiers 1 and 2, a
  worklist with duplicate rows, ``qp_dev``) and on the P core's 1080p
  forms with I16-in-P (desktop and noise P frames, worklist, ``qp_dev``,
  K5p);
- **k16a14d**: K16a (the JPEG transform) and K14d (the SSE reduction)
  against their plain versions on the inputs that break their designs
  (K16a: S = 1 and 4, 1080p, 4K, 1919x1079, a ragged tile, 16x16 and
  17x33, saturated and all-zero frames, rounding ties; K14d: short and
  misaligned planes, the 4K full-scale pair, graph replays);
- **k16b14a**: K16b (the JPEG symbol histograms) and K14a/K14r (the qp
  plane) against their plain versions on the inputs that break their
  designs (K16b: S = 1, 4 and 65, nx = 1, 3 and 4, 1080p, 4K, 1919x1079,
  all-zero and saturated levels, crafted zero runs, DC sizes past 16;
  K14a: with and without the lookahead, ``qp_dev``, activities past
  int32, the SAD thresholds, odd MB columns, planes off 16 bytes,
  worklists of 1, 8 and 64 rows with duplicates, graph replays);
- **k13s13**: 13s (the forced-skip row gate) and K13 (the reference-row
  scatter) against their plain versions, ``torch.equal``, on the inputs
  that break their designs (13s: gate patterns, I16-in-P, the shard frame
  views, 4K, 81 MBs a row, tensors off 16 bytes; K13: 1, 8 and 68 rows,
  duplicates, rows 0 and nr - 1, 4K, W = 16 x 81, planes and stacks off
  16 bytes; graph replays of both);
- **modes**: K1's other mode sets (``ENCODER_INTRA_MODES`` full, i16,
  dc) at each tier and K5's ``refine="full"`` (K5 and K5p) against their
  plain versions at 1080p; the served knobs ``ENCODER_INTRA_MODES`` and
  ``ENCODER_ENTROPY=native``/``python`` at 640x368 through
  ``make_encoder``, the bench's full-line ME loop, ``mode="pcm"`` and
  MJPEG's native coder;
- **colour**: the default configuration at an odd geometry
  (1919x1079), which the host converter cannot take: the device colour
  conversion (K9) on every frame, two frames in flight;
- **cabac**: ``ENCODER_ENTROPY=cabac`` (GOP 60, deblock, rate control)
  on both transports, ``ENCODER_CABAC_BINARIZE=host`` (K10, the native
  level decoder and CABAC coder) and ``=device`` (K11i/K11p, the native
  arithmetic engine), an IDR and P frames, two frames in flight (K1,
  K4 full, K5, K8 and the route's kernels); at a low fixed qp a noise P
  frame whose records overflow takes the dense coder;
- **ring**: ``ENCODER_SUPERSTEP_CHUNK=4``, the deployed manifest's
  setting (GOP 57 = 14x4+1, deblock, rate control), pipelined at the
  encoder's depth: device CAVLC with a noise P frame inside a chunk (the
  chunk's overflow fallback), a keyframe requested mid-chunk (a partial
  chunk flushed per frame) and a drained chunk; then CABAC with
  ``ENCODER_CABAC_BINARIZE=device``, and rgb ingest at the odd geometry
  (K9's frame axis).  Every chunk runs as one replay of a captured CUDA
  graph (``ops/devloop``), its stats as one K4c launch;
- **damage**: ``DNGD_DAMAGE_MASK=true`` on a desktop with a blinking
  cursor (1 MB row), a scrolling terminal pane (8 rows) and one
  full-frame change, per frame and in the ring (K5r, K13, and K6-K8 on
  the compacted rows); its tune-mask part adds ``ENCODER_TUNE=hq`` on
  both kernel tiers (the served ``make_encoder``, hq_noaq under the loop
  filter; the full ``H264Encoder(..., deblock=False, tune="hq")``: the qp
  plane over the worklist K14r, K5r's hq form and its I16-in-P passes
  over the rows), per frame, in the ring and in the masked spatial step
  at nx = 2;
- **tune**: ``ENCODER_TUNE=hq`` on both kernel tiers: the full tier
  (``H264Encoder(..., deblock=False, tune="hq")``: the qp plane K14, the
  hq forms of K1, K2, K3, K5 with its I16-in-P passes, K6, K7 and K4, rate
  control), per frame and in the ring with the 1-frame lookahead; the
  served tier (``make_encoder`` with ``ENCODER_TUNE=hq``: hq_noaq under
  the loop filter), per frame, in the ring and on CABAC's two routes;
- **mjpeg**: ``tpumjpegenc``, RFB's Tight rects and the MJPEG session
  batch (K16a-c);
- **sessions**: ``TPU_SESSIONS=10`` under ``BucketedStreamManager``
  (eight 1080p sessions and two 720p ones in a second bucket) on its
  encode threads, GOP 60 per tick and in chunk rings of 4, a hub's
  keyframe request and a noise frame's overflow: the session steps 15b
  (K1-K3), 15c (K5-K7, and K8 with ``deblock=True``) and 15d (their
  captured graph), and the link probe (K17g);
- **spatial**: ``ENCODER_SPATIAL_SHARDS`` on one card's default shard
  devices (it serves unsharded, as the reference resolves one device),
  then over ``spatial_devices=[cuda:0] * nx`` for nx = 2 and 4: CAVLC
  and CABAC-device per frame and in chunk-4 rings, hq_noaq and the
  masked row gate (the halo pad 15e, the padded-reference P core K5p,
  the gate 13s, the steps 15f-15h);
- **bench**: the port's bench as its user runs it (``bench.main`` under a
  shortened ``BENCH_TIMEOUT_S``: the all-intra headline, GOP, the
  device-only timing loops at 1080p and 4K, CABAC's device and host
  stages; ``bench.bdrate_main(quick=True)``): the SSE reduction K14d and
  the loops' kernels K17p (input perturbation) and K17c (checksum carry),
  each loop a captured graph replayed K times (rows 14d, 17a-f).

Checks, each of which fails the run:

  build   nvcc builds every kernel of ``csrc/`` (one process per source)
  main    each phase's encode loop; every kernel of the phase's path must
          have launched (counts set to 0 just before, read just after)
  (a)     each kernel against its plain PyTorch version on the same CUDA
          inputs at the phase's 1080p shapes (exact; float stats within a
          stated relative tolerance), timed with CUDA events
  (b)     every access unit against the plain path on the card; in the
          GOP phase every deblocked reference against the plain chain
  (c)     where cv2 decodes H.264, the decoded luma of the GOP and CABAC
          streams against the encoder's deblocked references
  chain   K1 (tiers 1, 2 on 1080p noise; bands of saturated planes at
          each tier at 640x368; 8 stacked sessions at 320x192; 3840x2176)
          and K6 (an all-skip and a full-noise P frame, I16-in-P with the
          qp chain over 1 and 4 row bands, 8 stacked 1080p sessions)
          equal to their plain versions
  k5k4    K5 against plain on moves of (+-9, +-9) (the MV at the window's
          edge, every frame edge clamped), an unchanged flat frame, a
          flat frame +3 and one over raised blocks (tied SADs: the first
          minimum decides), noise and 4K at each tier, 8 stacked
          sessions, K5p, refine=full and K5r at edge rows and 64 rows;
          K4 on a flat frame, one texture everywhere, activity runs ending
          at and holding the p50/p95 positions, 4K and K4c at K = 4 with
          and without prev, in the intra, full and mb_intra forms
  k2k8    K8 on intra frames at qp 15 (nothing filters), 30 and 51 over
          bands of texture, noise, saturated 0/255 rows and flat areas
          (strong filter, clips), a P frame with random coded flags and MV
          steps of exactly 3 and 4 quarter pels, the luma and qp_dev forms
          at a qp other than the host's, 8 stacked 1080p sessions,
          worklist frames of 1, 8 and 68 rows, nx = 2 shard rows and 4K;
          K2 on all-zero, sparse (I4 and I16 mixed in every row), dense
          escape-coded, chroma-DC-only and chroma-AC levels at 1, 33, 120
          and 240 MBs wide, K1's levels of noise at qp 4, 8 stacked
          sessions and the qp chain over 1 and 4 bands; all equal to plain
  k3k7    K3, K7 and K7's 27-block qp-sum form, whole flat buffers equal
          to plain on 66 synthetic frames (``tests/pack_slots.py``: widths 1, 7, 9,
          33, 120, 240; zero blocks, all-skip rows, 32-bit codewords,
          pieces of 256 and 257 bits, MBs of 2048, 2049 and all 32-bit
          slots, pad 0 and 7, totals at FLAT_CAP_WORDS and one over, 8
          sessions with shared and own headers, 1, 8 and 68 rows, nx = 2
          bands, 4K; the overflow flags where the caps say) and on the
          1080p slots of ``k3k7_inputs``
  k11k16  K16c's strips equal to plain on all-zero blocks, a nonzero
          only at position 63, DC differences of size 11, negative
          amplitudes, 32-bit blocks (``edge_tables``), noise at the worst
          case of bits a block and random levels, at S = 1 x nx = 1 of
          1080p, S = 4 x nx = 4 and S = 2 x 40 MCUs at nx = 1, 2, 4, and on
          the single encoder's sticky and per-frame tables at 1080p,
          1919x1079, RFB's encoder, the batch and 4K; K11p's header and
          payload equal to plain on skip runs, dense levels, mvd and level
          overflows (the flag set) at three shapes, an MB over a cap of 8
          words (the flag set, the header otherwise plain's), a desktop P
          frame, a noise frame and a shard's 34 rows
  k10k11i K10's header and payload equal to plain on both key sets over
          all-zero, all-nonzero, the range's edge values, one past it (the
          flag set, and only there), zero and nonzero rows in turn and
          sparse slots at 68x120, 1x7, 34x120 and 3x13 MBs, and on a
          desktop and a noise IDR's intra keys and a desktop and a noise P
          frame's P keys; K11i's on flat, sparse, dense and extreme levels,
          a level past its budget (the flag), all I_NxN and an I_16x16 /
          I_NxN checkerboard at three shapes, an MB over a cap of 8 words
          (the flag, the header otherwise plain's), a desktop IDR, a noise
          IDR at qp 18, all I_16x16, all I_NxN and a shard's 34 rows
  i16halo 15e equal to plain at nx = 1, 2, 4, halo on and off, 1088x1920
          and 2176x3840 (luma planes whose size is no multiple of 16 bytes)
          and on sources 1 and 4 bytes off a 16-byte boundary; the I16-in-P
          passes equal to ``i16_passes_plain`` on every output (the I16 keys
          filled with garbage first) for inter scores that make all, no,
          every other, runs of 3-19 and 60% random MBs want, at 1, 7, 9 and
          120 MBs a row, tiers 1 and 2 (a random qp plane), frame and a
          worklist with duplicate rows, with and without ``qp_dev``; K5 with
          I16-in-P equal to plain on a 1080p desktop and a noise P frame at
          both tiers, a worklist with duplicates, ``qp_dev``, K5p at nx = 2
  k16a14d K16a equal to plain, every level of y, cb and cr, at S = 1 and 4
          on 1080p, 4K, 1919x1079 (edge clamps) and the odd frame padded
          past one MCU (a ragged tile), 16x16 and 17x33 frames, saturated
          colours, checkerboards and all-zero frames, with quality 85's
          tables and tables of ones, and on tests/test_torch_jpeg.py's
          frames with tables that put a block on rounding ties; two 1080p
          JPEGs and a 333x177 rect byte-equal to the plain transform's;
          K14d's exact SSE equal to plain at 0, 1, 15, 16, 17, 4095 and
          4097 bytes, 1088x1920 twice, a 4K plane of zeros against 255
          (5.4e11), views 3 and 7 bytes off a 16-byte boundary, one graph
          replayed 32 times on new planes and a graph of 32 launches
  k13s13  13s equal to plain on every tensor (in place, the reference
          untouched) at S20's form, with I16-in-P and at 4K; the (r // 3)
          % 2, every-other, all-kept (nothing written), all-gated and
          first- or last-only gates at 1080p and 81 MBs a row with and
          without I16-in-P; tensors 1-15 bytes off a 16-byte boundary;
          the frame views of the padded-reference core at nx 2 and 4 and
          two tiers; a graph replayed on new gates.  K13 equal to plain
          (new planes, the old reference untouched) at 1, 8 and 68 rows
          and 4K; rows 0, nr - 1, padded duplicates, a reversed full list
          at 1080p, 1296x720 and 4K; planes and recon stacks off 16 bytes
          and stacks that are views; a graph replayed on new worklists
  colour  the odd-geometry stream against one whose colour conversion
          is the plain version; K9 on 1080p and odd frames
  cabac   both routes' access units byte-identical; every K10 and K11
          transport of both runs against its plain version (header and
          payload: the kernels leave the words past it unwritten); the overflow
          flags of K10, K11i and K11p on one giant level; the native
          library built by g++ from the port's ``native/`` into its
          ``build/``, and the native coder and engine, never the Python
          coder, coded every frame
  ring    each stream's access units byte-identical to the per-frame
          path's at the ring's qps (the ring holds one qp per chunk); one
          chunk's graph replay equal to the eager body on the same inputs
          (flats, references, MVs, levels); every kernel of the chunk
          counted through the graph (direct launches, less those recorded
          at capture, plus each graph's kernel nodes times its replays)
  damage  the masked access units and references against the plain
          chain on the card (plain K5r, K6-K8 and K13 from the IDR's
          reference on), cv2's decode against the references, the masked
          ring against the per-frame masked path at the ring's qps; under
          tune (both tiers) every masked P frame's AU and references
          against the plain chain from the encoder's reference before it,
          cv2's decode, each ring against the per-frame path with the
          chunk's lookahead at its qps and worklists, the nx=2 masked
          spatial streams against the unsharded masked ones, I16-in-P
          fired, K5r tiers 1 and 2 with and without I16-in-P and K14r
          with and without next_y against plain at 1, 8 and 64 rows
  tune    K14 and every hq form against its plain version at 1080p, I16-
          in-P fired, an IDR's and two P frames' AUs per tier against the
          plain path, cv2's decode of both tiers, each ring against the
          per-frame path at its qps (the full tier's with the lookahead),
          CABAC's routes byte-identical under hq_noaq; the tune=off K1 and
          K5 timed again beside the earlier phases' times
  sessions every recorded 15b/15c/15d call against S single-session
          launches of the kernels on every session (flats, recon and
          references), 15d against four 15c calls, 15c with the loop
          filter against K5-K8, session 0 of an IDR and a P tick and
          every session of a chunk against the plain versions, the
          overflow dropping only its session's frames, the re-key, each
          hub's fMP4 demuxed, equal to the checked AUs and decoded by cv2
          to the recons; the ledger's link rtt set from the probe, and
          the probe's kernel against its plain loop
  spatial every sharded stream byte-equal to the unsharded encoder's, one
          decoded by cv2; 15e (nx 2 and 4, halo on and off), K5p (three
          tiers) and 13s against their plain versions at 1080p; one IDR
          of 15f, one P frame of 15g and of the masked 15g, and a chunk
          of 15h against the plain steps; 15h's replay against its
          eager body
  bench   the bench's JSON free of error keys (the item refusals are
          values), every block run, K14d, K17p and K17c counted on its
          path and equal to their plain versions at 1080p (the
          full-scale SSE pair 65025), each loop's graph replay equal to
          its eager kernel loop at 1080p and to its plain loop at
          320x192 (checksum, last transport's header and payload, chained
          planes)
  modes   K1 full / i16 / dc at each tier on saturated bands and a frame
          where full picks all nine I4 modes (each counted), at tiers 0
          and 2 on 1080p noise,
          K5 and K5p refine=full at each tier, equal to plain; an IDR and
          two P frames of ENCODER_INTRA_MODES=full / dc and
          ENCODER_ENTROPY=native / python equal to a twin on the host's
          CPU, every stream decoded by cv2, the native coder counted; a
          PCM frame decoded to its K9 planes; MJPEG native equal to the
          Python coder on the same levels
  gate    the bench's --bdrate --quick gate (hq never loses to off, its P
          step at most 1.5x off's) printed as ``bdrate gate: ok`` or
          ``FAILED`` on a line of its own; not a check while its host-clock
          ratio flaps on this card (ROADMAP queue 3)
  check   NAL structure, recon PSNR, qp moved, no jax imported

Prints the card's name and power limit, per-kernel times beside their
bounds, the GOP and CABAC paths' frames/s, p50 frame ms and host spans
(the CABAC span per route), the GOP path's busy share, the ring against
the per-frame path (frames/s and submit p50 in alternating runs), the
masked P stage's device ms at 1, 8 and 68 damaged rows (and per tune
tier at 1, 8 and 64 rows, beside tune=off's), the graphs'
count and memory pools, the hq tiers' K1 and K5 times and frames/s
against tune=off, the sessions' tick times and frames/s at S = 1-8,
K1 and K5 batched against S single launches and the buckets' graph
pools, the link rtt, the spatial shards' step and kernel times, K5p
against K5 and frames/s at nx = 1, 2, 4, the bench's JSON lines and each
timing loop's step ms at 1080p and 4K, the script's total run time,
a ``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, without CUDA or
outside a checkout of the repository.

Run: ``python3 chip_smoke.py`` (details go to ``chiprun_out/``).  Two
measurement modes for the intra core and the P slot coder (see their
section near the end): ``python3 chip_smoke.py k1k6-pairs --pairs 3
parent=.tree/parent change=.`` and ``python3 chip_smoke.py k1-variants``;
the modes phase alone: ``python3 chip_smoke.py modes``; K5 and K4: ``python3
chip_smoke.py pairs --set k5k4 --pairs 3 parent=.tree/parent change=.``,
``python3 chip_smoke.py k5k4-split`` and the k5k4 phase alone ``python3
chip_smoke.py k5k4``; K2 and K8: ``python3 chip_smoke.py pairs --set k2k8
--pairs 3 parent=.tree/parent change=.``, ``python3 chip_smoke.py
k2k8-split`` and the k2k8 phase alone ``python3 chip_smoke.py k2k8``; K3 and
K7: ``python3 chip_smoke.py pairs --set k3k7 --pairs 3 parent=.tree/parent
change=.``, ``python3 chip_smoke.py k3k7-split`` and the k3k7 phase alone
``python3 chip_smoke.py k3k7``; K16c and K11p: ``python3 chip_smoke.py pairs
--set k11k16 --pairs 3 parent=.tree/parent change=.``, ``python3
chip_smoke.py k11k16-split`` and the k11k16 phase alone ``python3
chip_smoke.py k11k16``; K10 and K11i: ``python3 chip_smoke.py pairs
--set k10k11i --pairs 3 parent=.tree/parent change=.``, ``python3
chip_smoke.py k10k11i-split`` and the k10k11i phase alone ``python3
chip_smoke.py k10k11i``; 15e and K5's I16-in-P passes: ``python3
chip_smoke.py pairs --set i16halo --pairs 3 parent=.tree/parent change=.``,
``python3 chip_smoke.py i16halo-split`` and the i16halo phase alone ``python3
chip_smoke.py i16halo``; K16a and K14d: ``python3 chip_smoke.py pairs --set
k16a14d --pairs 3 parent=.tree/parent change=.``, ``python3 chip_smoke.py
k16a14d-split`` and the k16a14d phase alone ``python3 chip_smoke.py
k16a14d``; K16b and K14a/K14r: ``python3 chip_smoke.py pairs --set k16b14a
--pairs 3 parent=.tree/parent change=.``, ``python3 chip_smoke.py
k16b14a-split`` and the k16b14a phase alone ``python3 chip_smoke.py
k16b14a``; 13s and K13: ``python3 chip_smoke.py pairs --set k13s13
--pairs 3 parent=.tree/parent change=.``, ``python3 chip_smoke.py
k13s13-split`` and the k13s13 phase alone ``python3 chip_smoke.py
k13s13``; the damage phase's
tune-mask part alone: ``python3 chip_smoke.py tune-mask`` (~75 s).  The BD-rate gate
in alternating fresh processes is ``tools/bdrate_pairs.py``.
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
N_FRAMES = 6               # intra phase desktop frames; one noisy frame is added
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
# K16a's float64 work: the data sheet's 34 TFLOPS FP64 counts an FMA as
# two operations; the kernel's unfused __dmul_rn / __dadd_rn issue one
# instruction each, so its rate is half: 17 T/s.
FP64_OPS_PER_S = 17e12
# K16a's float64 operations an MCU: colour 256 x 3 x (3 mul + 3 add), the
# chroma quad means 64 x 2 x 5, luma -128 256, two DCT passes 2 x 384 x 15
K16A_FP64_OPS_PER_MCU = 256 * 3 * 6 + 64 * 2 * 5 + 256 + 2 * 384 * 15
EXACT_REL_TOL = 1e-6       # activity percentiles (float32 interpolation)
FLOAT_REL_TOL = 1e-5       # SSE, |MV| mean and p95 of the full K4 form
COLOUR_FRAMES = 4          # colour phase: odd geometry, device colour (K9)
ODD_W, ODD_H = 1919, 1079
CABAC_FRAMES = 12          # CABAC phase: an IDR and P frames, per route
CABAC_DENSE_QP = "8"       # a noise P frame at this qp passes the record budget
RING_FRAMES = 30           # ring phase: IDR, 7 chunks, a flushed and a drained one
RING_KF_AT = 18            # a keyframe requested with a chunk half staged
RING_NOISY_AT = 6          # a noise P frame inside the second chunk: overflow
RING_CABAC_FRAMES = 10
RING_RGB_FRAMES = 9
RING_TIMED_FRAMES = 29     # IDR + 7 chunks a timed run
DAMAGE_FRAMES = 12
TUNE_FRAMES = 8            # tune phase: IDR + 7 P frames per tier
TUNE_RING_FRAMES = 10      # IDR, two chunks of 4 and a drained frame
TUNE_CABAC_FRAMES = 5
TUNE_TIMED_FRAMES = 12     # frames a timed run, four configurations in turn
TUNE_ROUNDS = 3
MJPEG_STICKY_FRAMES = 24   # mjpeg phase: make_encoder's sticky tables
MJPEG_PER_FRAME_FRAMES = 12  # then per-frame tables: K16b every frame
MJPEG_PLAIN_FRAMES = 4     # frames also encoded through the plain versions
RFB_FRAMES = 12            # Tight rects the raw-socket client receives
RFB_QUALITY = 75           # RfbServer's JPEG quality
BATCH_S, BATCH_NX = 4, 4   # the session batch: sessions x restart strips
BATCH_H = 1088             # its frame height: 1080 edge-padded to 16 * nx
MJPEG_MIN_PSNR = 30.0      # decoded desktop frames against their source (dB)
SESS_S = 8                 # sessions phase: BASELINE config 5, eight 1080p sessions
SESS_B2, SESS_B2_N = (1280, 720), 2   # a second bucket: two sessions at 720p
H_PAD = 1088               # 1080 padded to MB rows
SESS_TICKS = 18            # ticks a bucket and configuration
SESS_CHUNK = 4             # the ring configuration (the deployed manifest's)
SESS_KF_HUB, SESS_KF_AT = 3, 6   # hub 3 asks for a keyframe after tick 6
SESS_NOISY = (5, 13)       # (session, tick): full noise, its P frame overflows
SP_FRAMES = 9              # spatial phase: IDR + 8 P frames (two chunks of 4)
SP_NX = (2, 4)             # shard counts on one card (34 and 17 MB rows a shard)
SP_TIMED_FRAMES = 17       # frames a timed run (nx = 1, 2, 4 in turn)
SP_TIMED_ROUNDS = 2
SP_DEVICE = "cuda"         # the shard devices are [SP_DEVICE] * nx
SESS_TIMED_S = (1, 2, 4, 8)
SESS_TIMED_TICKS = 13      # an IDR and 12 P ticks a timed run


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


def graph_ms(fn, reps: int = 20):
    """Median ms of ``fn`` captured once into a CUDA graph and replayed
    (CUDA events): the kernels' device time without the host's launch
    gaps, which ``cuda_ms`` of a short kernel includes."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops.devloop import graph_capture

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with graph_capture(g):
        fn()
    return cuda_ms(g.replay, reps=reps)


def graph_each_ms(fn, n: int = 32, reps: int = 10):
    """Median ms of one call of ``fn`` out of ``n`` captured back to back
    in one CUDA graph (CUDA events around a replay, over ``n``): a short
    kernel's device time without the graph's own launch, which
    ``graph_ms`` of one call includes."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops.devloop import graph_capture

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with graph_capture(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, reps=reps) / n


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


def max_diff(pairs) -> float:
    """The largest absolute difference over (a, b) tensor pairs (values
    compared in float64 on the CPU; shapes must match)."""
    worst = 0.0
    for a, b in pairs:
        check(tuple(a.shape) == tuple(b.shape),
              f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
        d = (a.cpu().double() - b.cpu().double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def kernel_row(name, src, replaces, launches, err, ms, plain_ms, nb, ops=0.0,
               library_ms=None, floor_ms=0.0):
    """One entry of the kernels line: the bound is the larger of the
    bytes over the memory rate and the operations over the scalar rate,
    or ``floor_ms`` where that is larger (a graph kernel node's own floor,
    the least time one launch of any work takes: counted as operations)."""
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / SCALAR_OPS_PER_S * 1e3, floor_ms)
    return {"name": name, "route": "cuda",
            "source": "docker_nvidia_glx_desktop_tpu_torch/csrc/" + src,
            "replaces": "docker_nvidia_glx_desktop_tpu/" + (
                replaces if replaces.startswith(("models/", "parallel/"))
                else "ops/" + replaces),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": library_ms}


def halo_index(h: int, w: int, nx: int, dev):
    """15e as one gather a plane: the flat index of each padded shard
    byte in an (h, w) plane (rows past a shard reach into its neighbours,
    clamped at the frame's edges; columns clamped), (nx, h/nx + 26, w +
    26) int64."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops.h264_inter import _PAD

    hl = h // nx
    rows = (torch.arange(-_PAD, hl + _PAD, device=dev)[None]
            + hl * torch.arange(nx, device=dev)[:, None]).clamp(0, h - 1)
    cols = torch.arange(-_PAD, w + _PAD, device=dev).clamp(0, w - 1)
    return rows[:, :, None] * w + cols


def live_sector_bytes(vals, lens) -> int:
    """The bytes of ``vals`` in the 32-byte sectors that hold a value whose
    length in ``lens`` (same shape) is non-zero: all a packer that reads
    only live values must fetch of them."""
    import torch

    live = lens.reshape(-1) != 0
    lead = (vals.data_ptr() % 32) // vals.element_size()
    per = 32 // vals.element_size()
    live = torch.cat([live.new_zeros(lead), live,
                      live.new_zeros(-(lead + live.numel()) % per)])
    return 32 * int(live.view(-1, per).any(dim=1).sum())


def pack_bytes(values, lengths, syn_vals, syn_lens, others, flat_bytes) -> int:
    """The bytes K3 / K7 must move on these slots: every length and every
    header, run and qp-sum slot (``others``) read once, the block and
    syntax values only in the sectors that hold a live one, and the flat
    written up to its last word (META and the rows)."""
    return (nbytes(lengths, syn_lens, *others) + live_sector_bytes(values, lengths)
            + live_sector_bytes(syn_vals, syn_lens) + flat_bytes)


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

    # -- build: nvcc per CUDA source and g++ for the native library, at once
    import threading

    from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib

    t0 = time.perf_counter()
    native = {}

    def build_native():
        try:
            native_lib.get_lib()
            native["s"] = time.perf_counter() - t0
        except RuntimeError as e:
            native["error"] = str(e)

    th = threading.Thread(target=build_native)
    th.start()
    logs = _cuda.build(verbose=True)
    report["build_s"] = time.perf_counter() - t0
    th.join()
    check("error" not in native, f"native library: {native.get('error')}")
    so = native_lib._so_path()
    check(os.path.dirname(so) == os.path.join(HERE, "docker_nvidia_glx_desktop_tpu_torch",
                                              "build") and os.path.exists(so),
          f"the native library is not the port's own build: {so}")
    report["native_build_s"] = native["s"]
    print(f"native library: built with g++ from the port's native/ in "
          f"{native['s']:.1f} s")
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"build: {len(logs)} sources in {report['build_s']:.1f} s")

    rows = intra_phase(report)
    print(f"intra phase done at {time.perf_counter() - t_start:.0f} s")
    rows += gop_phase(report)
    print(f"gop phase done at {time.perf_counter() - t_start:.0f} s")
    chain_phase(report, logs)
    print(f"chain phase done at {time.perf_counter() - t_start:.0f} s")
    k5k4_phase(report)
    print(f"k5k4 phase done at {time.perf_counter() - t_start:.0f} s")
    k2k8_phase(report)
    print(f"k2k8 phase done at {time.perf_counter() - t_start:.0f} s")
    k3k7_phase(report)
    print(f"k3k7 phase done at {time.perf_counter() - t_start:.0f} s")
    k11k16_phase(report)
    print(f"k11k16 phase done at {time.perf_counter() - t_start:.0f} s")
    k10k11i_phase(report)
    print(f"k10k11i phase done at {time.perf_counter() - t_start:.0f} s")
    i16halo_phase(report)
    print(f"i16halo phase done at {time.perf_counter() - t_start:.0f} s")
    k16a14d_phase(report)
    print(f"k16a14d phase done at {time.perf_counter() - t_start:.0f} s")
    k16b14a_phase(report)
    print(f"k16b14a phase done at {time.perf_counter() - t_start:.0f} s")
    k13s13_phase(report)
    print(f"k13s13 phase done at {time.perf_counter() - t_start:.0f} s")
    rows += modes_phase(report)
    print(f"modes phase done at {time.perf_counter() - t_start:.0f} s")
    rows += colour_phase(report)
    print(f"colour phase done at {time.perf_counter() - t_start:.0f} s")
    rows += cabac_phase(report)
    print(f"cabac phase done at {time.perf_counter() - t_start:.0f} s")
    rows += ring_phase(report)
    print(f"ring phase done at {time.perf_counter() - t_start:.0f} s")
    rows += damage_phase(report)
    rows += tune_mask_phase(report)
    print(f"damage phase done at {time.perf_counter() - t_start:.0f} s")
    rows += tune_phase(report, rows)
    print(f"tune phase done at {time.perf_counter() - t_start:.0f} s")
    rows += mjpeg_phase(report)
    print(f"mjpeg phase done at {time.perf_counter() - t_start:.0f} s")
    rows += sessions_phase(report)
    print(f"sessions phase done at {time.perf_counter() - t_start:.0f} s")
    rows += spatial_phase(report)
    print(f"spatial phase done at {time.perf_counter() - t_start:.0f} s")
    rows += bench_phase(report, rows)
    print(f"bench phase done at {time.perf_counter() - t_start:.0f} s")
    check("jax" not in sys.modules, "the port imported jax")
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    print(f"total run time: {report['wall_s']:.1f} s (build included)")
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
        "content_stats": content_stats.chunk_stats,
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
    y0, cb0, cr0 = tokens[0][4][3]          # the submit's device planes
    hv, hl = enc._hdr_slots(0, tokens[0][4][2] - enc.qp)
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
        _, idr, qp, (y, cb, cr), _, _, _ = tok
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
        prev = tokens[2][4][3][0]
        v_k, g_k = content_stats.frame_stats(y, prev, 512)
        v_p, g_p = content_stats.frame_stats_full_plain(y, prev, 512)
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
             pack_bytes(*sl_k, (hv, hl), total_bytes)),
            ("content_stats", "content.cu", "content_stats.py:156 frame_stats",
             lambda: content_stats.frame_stats(y, prev, 512),
             lambda: content_stats.frame_stats_full_plain(y, prev, 512),
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
        # K1's chain: 120 MBs in order, each 7 dependent I4 steps and the
        # barrier with the decision, ~1 us a step (estimate)
        depth_ms = enc.mb_w * 8 * 1.0e-3
        for r in rows:
            print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
                  f"{r['launches'] / len(frames):.2f} launches/frame)")
        print(f"kernel pack: bound if every slot value were read (worst "
              f"case) {(nbytes(*sl_k, hv, hl) + total_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms")
        print(f"kernel intra: sequential-depth estimate {depth_ms:.2f} ms "
              f"({enc.mb_w} MBs x 8 steps x ~1 us)")

    # -- (b) every access unit against the plain path on the card ------------
    for i, tok in enumerate(tokens):
        _, idr, qp, (y, cb, cr), _, _, _ = tok[4]
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
        "content_stats_full": content_stats.chunk_stats,
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
         pack_bytes(*s_k[:4], (*s_k[4:6], hv, hl), n_flat), 0.0, 0.0),
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
    print(f"kernel pack_p: bound if every slot value were read (worst case) "
          f"{(nbytes(*s_k[:6], hv, hl) + n_flat) / HBM_BYTES_PER_S * 1e3:.4f} ms")
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


def kernel_split(fn, n: int = 10, tries: int = 3, launches=None,
                 strict: bool = False) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, by name
    (``torch.profiler``): each kernel's mean over the events the trace
    holds, times its launches per call (its events over ``n`` calls,
    rounded up).  A trace in which some kernel's events are not a whole
    multiple of ``n`` dropped events: it is taken again, up to ``tries``
    traces.  Where none is whole, ``strict`` returns {}, else the last
    trace's means, with a warning either way.  Where ``launches`` is
    given, a trace whose kernels do not make up that many launches a call
    is never used.  {} also where no trace holds device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    why, est = "no device time in the trace", {}
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:       # no CUPTI tracing on this host
            print(f"kernel split: not measured (profiler: {e})")
            return {}
        tot, counts = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.replace("void ", "").split("(")[0][:60]
                counts[name] = counts.get(name, 0) + e.count
                tot[name] = tot.get(name, 0.0) + us / 1e3
        per_call = {k: -(-c // n) for k, c in counts.items()}
        if not tot:
            continue
        if launches is not None and sum(per_call.values()) != launches:
            why = f"{per_call} launches a call, not {launches}"
            continue
        out = {k: v / counts[k] * per_call[k] for k, v in tot.items()}
        dropped = {k: c for k, c in counts.items() if c % n}
        if not dropped:
            return out
        why, est = f"events dropped: {dropped} for {n} calls", out
    if est and not strict:
        print(f"kernel split: means over the events held ({why})")
        return est
    print(f"kernel split: not measured ({why}, {tries} traces)")
    return {}


def device_ms(fn, name: str, bound_ms: float, launches: int):
    """Device ms a call of ``fn`` (``kernel_split``'s sum over its
    ``launches`` launches, a memset counting as one), or None where no
    trace held them all; a time under ``bound_ms`` fails the run."""
    split = kernel_split(fn, launches=launches, strict=True)
    if not split:
        print(f"warning: {name}: device time not measured")
        return None
    t = sum(split.values())
    check(t >= bound_ms, f"{name}: device time {t:.4f} ms under its bound "
          f"{bound_ms:.4f} ms")
    return t


def saturated_planes(h: int, w: int, dev):
    """Three bands of MB rows, luma and chroma alike: all 0, all 255 and
    a 0/255 checkerboard (every MB row is its own slice in K1)."""
    import torch

    def one(hh, ww):
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(ww, device=dev)[None, :]
        band = yy * 3 // hh
        return torch.where(band == 0, 0, torch.where(
            band == 1, 255, (yy + xx) % 2 * 255)).to(torch.uint8)
    return [one(h, w), one(h // 2, w // 2), one(h // 2, w // 2)]


def chain_phase(report, logs):
    """K1 (the intra core's pre-pass and chain) and K6 (the one-pass P
    slot coder) against their plain versions on the inputs their designs
    are sensitive to: K1 on a full-noise 1080p frame at each tier, the
    saturated planes at each tier, 8 stacked sessions and a 4K frame; K6
    on an all-skip and a full-noise P frame, the I16-in-P form and 8
    stacked sessions.  Prints the two sources' ``-Xptxas -v`` lines and
    each wrapper's kernels by device time."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        cavlc_p_device, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    dev = torch.device("cuda")
    for src in ("intra", "cavlc"):
        for ln in logs.get(src, "").splitlines():
            if "registers" in ln or "stack frame" in ln:
                print(f"ptxas {src}: {ln.strip()}")
    k1, k6 = h264_device.encode_intra_frame_yuv, cavlc_p_device.p_frame_slots
    saved = (k1.launches, k1.hq.launches, k6.launches, k6.hq.launches,
             k6.chain.launches)
    rep = report.setdefault("chain", {})
    t0 = time.perf_counter()

    def up(rgb, ph, pw):
        return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in rgb_to_yuv420_host(rgb, ph, pw)]

    def same_k1(label, planes, qp, tune="off"):
        got = k1(*planes, qp, tune)
        want = h264_device.encode_intra_frame_yuv_plain(
            *planes, qp, tune, got.get("qp_map"))
        for k in want:
            check(torch.equal(got[k], want[k]), f"K1 {label}: {k} differs")
        return got

    rng = np.random.default_rng(21)
    noise = up(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), H_PAD, W)
    for tune in ("hq_noaq", "hq"):          # tier 0's noise: the intra phase
        same_k1(f"noise {tune}", noise, 26, tune)
    sat = saturated_planes(368, 640, dev)
    for tune in ("off", "hq_noaq", "hq"):
        same_k1(f"saturated {tune}", sat, 26, tune)
    sh, sw = 192, 320
    small = [up(f[:sh, :sw], sh, sw) for f in desktop_frames(8, seed=4)[:8]]
    stacked = [torch.stack([p[i] for p in small]) for i in range(3)]
    got = k1(*stacked, 30)
    for i in range(8):
        want = h264_device.encode_intra_frame_yuv_plain(*small[i], 30)
        for k in want:
            check(torch.equal(got[k][i], want[k]), f"K1 S=8 session {i}: {k}")
    desk = desktop_frames(1, seed=5)[0]
    big = up(np.tile(desk, (2, 2, 1)), 2 * H_PAD, 2 * W)
    same_k1("4K", big, 26)
    print("(a) chain: K1 equal to plain on 1080p noise (hq_noaq, hq), the "
          "saturated bands at each tier (640x368), S = 8 (320x192) and a "
          "3840x2176 frame")
    planes = up(desk, H_PAD, W)
    rep["k1_split"] = kernel_split(lambda: k1(*planes, 26))
    rep["k1_4k_ms"] = cuda_ms(lambda: k1(*big, 26), reps=10)
    s8 = [torch.stack([p[i] for p in [planes] * 8]) for i in range(3)]
    rep["k1_s8_ms"] = cuda_ms(lambda: k1(*s8, 26), reps=10)

    # K6 on the P core's outputs
    lv = k1(*planes, 26)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    moved = up(np.roll(desk, (2, 3), (0, 1)), H_PAD, W)
    o = h264_inter.encode_p_frame(*moved, *ref, 26)
    cases = {"all-skip": {k: torch.zeros_like(v) for k, v in o.items()},
             "noise": h264_inter.encode_p_frame(*noise, *ref, 26)}
    for label, out in cases.items():
        a, b = k6(out), cavlc_p_device.p_frame_slots_plain(out)
        for i, (x, y) in enumerate(zip(a, b)):
            check(torch.equal(x, y), f"K6 {label}: output {i} differs")
    check(int(k6(cases["all-skip"])[3].sum()) == 0,
          "K6 all-skip: a header coded")
    oh = h264_inter.encode_p_frame(*noise, *ref, 26, tune="hq", p_intra=True)
    check(bool(oh["mb_intra"].any()), "K6 I16-in-P: no intra MB")
    for sh in (1, 4):                   # the qp sums of 1 and 4 row bands
        a = k6(oh, 26, shards=sh)
        b = cavlc_p_device.p_frame_slots_plain(oh, 26, sh)
        for i, (x, y) in enumerate(zip(a, b)):
            check(torch.equal(x, y), f"K6 I16-in-P {sh}: output {i} differs")
    keys = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    outs = [h264_inter.encode_p_frame(*up(np.roll(desk, (i, 2 * i), (0, 1)),
                                          H_PAD, W), *ref, 26)
            for i in range(8)]
    o8 = {k: torch.stack([x[k] for x in outs]) for k in keys}
    a = k6(o8)
    for i in range(8):
        b = cavlc_p_device.p_frame_slots_plain({k: o8[k][i] for k in keys})
        for j, (x, y) in enumerate(zip(a, b)):
            check(torch.equal(x[i], y), f"K6 S=8 session {i}: output {j}")
    print("(a) chain: K6 equal to plain on an all-skip and a full-noise P "
          "frame, the I16-in-P form with the qp chain (qp sums of 1 and 4 "
          "row bands) and S = 8 (1080p)")
    rep["k6_split"] = kernel_split(lambda: k6(o))
    rep["k6_i_split"] = kernel_split(lambda: k6(oh, 26))
    rep["k6_s8_ms"] = cuda_ms(lambda: k6(o8), reps=10)
    rep["s"] = time.perf_counter() - t0
    (k1.launches, k1.hq.launches, k6.launches, k6.hq.launches,
     k6.chain.launches) = saved
    for name in ("k1_split", "k6_split", "k6_i_split"):
        print(f"{name} (device ms): " + "; ".join(
            f"{k} {v:.4f}" for k, v in rep[name].items()))
    print(f"chain: K1 at S = 8 {rep['k1_s8_ms']:.3f} ms, at 4K "
          f"{rep['k1_4k_ms']:.3f} ms; K6 at S = 8 {rep['k6_s8_ms']:.3f} ms; "
          f"phase {rep['s']:.1f} s")


def mode_planes(h: int, w: int, dev, seed: int = 31):
    """A frame where the full I4 set picks each of its nine modes: per MB
    a grating along one of eight directions (the I4 modes' angles) or a
    flat patch; grey chroma."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    y = np.zeros((h, w))
    dirs = [(0, 1), (1, 0), (1, 1), (1, -1), (2, 1), (1, 2), (2, -1), (1, -2)]
    for r in range(h // 16):
        for c in range(w // 16):
            k = rng.integers(0, len(dirs) + 1)
            sl = (slice(r * 16, r * 16 + 16), slice(c * 16, c * 16 + 16))
            if k == len(dirs):
                y[sl] = rng.integers(40, 220)
                continue
            a, b = dirs[k]
            y[sl] = 128 + 90 * np.sin(rng.uniform(0.3, 1.2)
                                      * (a * xx[sl] + b * yy[sl])
                                      + rng.uniform(0, 6.3))
    c = np.full((h // 2, w // 2), 128, np.uint8)
    return [torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in
            (np.clip(np.round(y), 0, 255).astype(np.uint8), c, c.copy())]


def k5_full_ops(nmb: int, tier: int = 0) -> float:
    """K5's operations under ``refine="full"``: ``k5_ops`` with the +-1,
    half- and quarter-pel stages on all 256 luma lines instead of the 128
    even ones; at the hq tiers ``k5_hq_ops``' extra (no I16-in-P)."""
    full = k5_ops(nmb) + float((9 * 3 + 8 * 3 + 8 * 5) * 128 * nmb)
    return full + (k5_hq_ops(nmb, False) - k5_ops(nmb) if tier else 0.0)


MODES_SMALL = (368, 640)           # saturated bands, the nine-mode frame
MODES_ENC_CROP = (560, 100)        # the encoders' 640x368 window of the GOP desktop
MODES_ENC = {                      # name: the served knobs; the first four
    "full": {"ENCODER_INTRA_MODES": "full"},      # held against the plain path
    "dc": {"ENCODER_INTRA_MODES": "dc"},
    # rate control off: the C coder takes only frames at the slice qp
    "native": {"ENCODER_ENTROPY": "native", "ENCODER_BITRATE_KBPS": "0"},
    "python": {"ENCODER_ENTROPY": "python"},
    "i16": {"ENCODER_INTRA_MODES": "i16"},
    "full_hq": {"ENCODER_INTRA_MODES": "full", "ENCODER_TUNE": "hq"},
    "i16_hq": {"ENCODER_INTRA_MODES": "i16", "ENCODER_TUNE": "hq"},
    "native_hq": {"ENCODER_ENTROPY": "native", "ENCODER_TUNE": "hq"},
}
MODES_PLAIN = ("full", "dc", "native", "python")


def modes_phase(report):
    """K1's other mode sets and K5's ``refine="full"``: K1 at
    "full", "i16" and "dc", each at tiers 0-2, against its plain version
    on the saturated bands and a frame where "full" picks each of the
    nine I4 modes (the picks counted), and at tiers 0 and 2 on 1080p
    noise; K5 and K5p in the FULL form at three tiers against plain at
    1080p.  The main path: ``make_encoder`` at 640x368 under each of
    ``MODES_ENC`` (an IDR and two P frames through
    ``encode_submit``/``encode_collect``) and the bench's
    ``devloop.inter_loop(refine="full")`` at 1080p, every count zeroed
    before and read after (the FULL forms no caller reaches must read
    0); the first four configurations' AUs against a
    twin encoder on the host's CPU (the plain versions), every stream
    decoded by cv2; a PCM frame decoded to its exact K9 planes; an MJPEG
    ``entropy="native"`` frame byte-equal to the Python coder's on the
    same levels.  Times each new form by CUDA events beside its bound."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import (
        H264Encoder, JpegEncoder, make_encoder)
    from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, color, devloop, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    dev = torch.device("cuda")
    rep = report.setdefault("modes", {})
    t_phase = time.perf_counter()
    laps = rep.setdefault("laps_s", {})

    def lap(name):                    # seconds each section took
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())
    k1, k5, k5p = (h264_device.encode_intra_frame_yuv,
                   h264_inter.encode_p_frame,
                   h264_inter.encode_p_frame_padded_ref)
    tiers = ("off", "hq_noaq", "hq")

    def up(rgb, ph, pw):
        return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in rgb_to_yuv420_host(rgb, ph, pw)]

    def same(label, got, want):
        for k in want:
            check(torch.equal(got[k], want[k]), f"{label}: {k} differs")

    plain_s = {}

    def held_k1(label, planes, qp, modes, tune):
        got = k1(*planes, qp, tune, i16_modes=modes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = h264_device.encode_intra_frame_yuv_plain(
            *planes, qp, tune, got.get("qp_map"), modes)
        torch.cuda.synchronize()
        plain_s.setdefault((modes, tune), (time.perf_counter() - t0) * 1e3)
        same(f"K1 {modes} {tune} {label}", got, want)
        return got

    # -- (a) K1's mode sets against plain -------------------------------------
    rng = np.random.default_rng(41)
    noise = up(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), H_PAD, W)
    sat = saturated_planes(*MODES_SMALL, dev)
    pick = mode_planes(*MODES_SMALL, dev)
    picks = {}
    for modes in ("full", "i16", "dc"):
        for tune in tiers:
            # 1080p at the two tiers the kernels line times (the plain
            # full set takes ~20-30 s a 1080p frame); hq_noaq at 640x368
            if tune != "hq_noaq":
                held_k1("1080p noise", noise, 26, modes, tune)
            held_k1("saturated", sat, 26, modes, tune)
    for tune in tiers:
        got = held_k1("nine-mode frame", pick, 26, "full", tune)
        m = got["i4_modes"][got["mb_i4"]].reshape(-1)
        picks[tune] = torch.bincount(m, minlength=9).tolist()
        check(all(n > 0 for n in picks[tune]),
              f"K1 full {tune}: a mode never picked: {picks[tune]}")
        check(not bool(got["mb_i4"].all()), "K1 full: no I16 MB")
    rep["full_picks"] = picks
    print("(a) modes: K1 full / i16 / dc at each tier equal to plain on the "
          "saturated bands (640x368), at off and hq on 1080p noise; full "
          "picks every I4 mode "
          "(V, H, DC, DDL, DDR, VR, HD, VL, HU counts per tier): "
          + "; ".join(f"{t} {picks[t]}" for t in tiers))

    lap("k1_checks")
    # -- (a) K5 / K5p FULL at three tiers against plain (1080p) ----------------
    gop = gop_frames(3, seed=12)
    cur, ref = up(gop[1], H_PAD, W), up(gop[0], H_PAD, W)
    pad = [h264_inter._edge_pad(p.to(torch.int32), h264_inter._PAD)
           .to(torch.uint8).contiguous() for p in ref]
    for tune in tiers:
        pi = tune != "off"
        qm = aq.qp_plane(cur[0], 26) if tune == "hq" else None
        got = k5(*cur, *ref, 26, refine="full", tune=tune, p_intra=pi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = h264_inter.encode_p_frame_plain(*cur, *ref, 26, tune, qm, pi,
                                               refine="full")
        torch.cuda.synchronize()
        plain_s[("k5", tune)] = (time.perf_counter() - t0) * 1e3
        same(f"K5 full {tune}", got, want)
        alt = k5(*cur, *ref, 26, tune=tune)
        rep.setdefault("k5_full_mv_differs", {})[tune] = not torch.equal(
            alt["mv"], got["mv"])
        got = k5p(*cur, *pad, 26, refine="full", tune=tune, p_intra=pi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = h264_inter.encode_p_frame_padded_ref_plain(
            *cur, *pad, 26, tune, qm, pi, refine="full")
        torch.cuda.synchronize()
        plain_s[("k5p", tune)] = (time.perf_counter() - t0) * 1e3
        same(f"K5p full {tune}", got, want)
    print("(a) modes: K5 and K5p (refine=full) equal to plain at each tier "
          "(the hq tiers with I16-in-P) at 1080p; MVs differ from refine=alt: "
          + str(rep["k5_full_mv_differs"]))

    lap("k5_checks")
    # -- main path: the served knobs and the bench's full-line loop ----------
    # No caller reaches K5's FULL form at the hq tiers or K5p's FULL form
    # (the reference runs refine="full" only in the bench's inter_loop, at
    # tune=off): those rows carry 0 launches on the path, and (a) holds them.
    named = {f"intra_{m}{t}": getattr(getattr(k1, m), "hq") if t else getattr(k1, m)
             for m in ("full", "i16", "dc") for t in ("", "_hq")}
    named["inter_full"] = k5.full
    no_path = {"inter_full_hq": k5.full.hq, "inter_padded_full": k5p.full,
               "inter_padded_full_hq": k5p.full.hq}
    y0, x0 = MODES_ENC_CROP
    eh, ew = MODES_SMALL
    efr = [np.ascontiguousarray(f[y0:y0 + eh, x0:x0 + ew])
           for f in gop_frames(3, seed=13)]
    d = up(gop[2], H_PAD, W)
    zero_counts({**named, **no_path})
    n0 = dict(native_lib.calls)
    streams = {}
    for name, knobs in MODES_ENC.items():
        env = dict(SIZEW=str(ew), SIZEH=str(eh), **knobs)
        enc, _ = make_encoder(from_env(env), ew, eh)
        _, aus, keys = drive(enc, efr)
        check(keys == [True, False, False], f"modes {name}: keyframes {keys}")
        streams[name] = (env, aus, enc)
    loop_sum = devloop.inter_loop(*d, *d, 4, 26, refine="full")
    torch.cuda.synchronize()
    launches = path_launches({**named, **no_path})
    native_calls = {k: v - n0.get(k, 0) for k, v in native_lib.calls.items()}
    rep["launches"], rep["native_calls"] = launches, native_calls
    for name in named:
        check(launches[name] > 0, f"modes main path: {name} never launched")
    for name in no_path:
        check(launches[name] == 0, f"modes main path: {name} launched")
    check(native_calls.get("h264_encode_intra_picture", 0) >= 1,
          "modes: the native CAVLC coder coded no IDR")
    check(streams["native"][2].i16_modes == "dc"
          and not streams["native"][2].deblock, "native: dc / no deblock")
    print("main modes: launches on the path (make_encoder under each of "
          "MODES_ENC, the _hq counts at hq_noaq; inter_loop(refine=full)): "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f" (no caller reaches {', '.join(no_path)}); native coder calls "
          f"{native_calls}")
    # the same step eager (direct launches) against the replays
    check(devloop.inter_loop(*d, *d, 4, 26, refine="full", eager=True)
          == loop_sum, "inter_loop(refine=full): replay differs from eager")

    lap("main_path")
    # -- (b) AUs against the plain path; (c) cv2 ---------------------------------
    for name in MODES_PLAIN:
        env, aus, _ = streams[name]
        twin, _ = make_encoder(from_env(env), ew, eh, device="cpu")
        _, taus, _ = drive(twin, efr)
        for i, (a, b) in enumerate(zip(aus, taus)):
            check(a == b, f"(b) modes {name}: frame {i} differs from the plain path")
    src_y = [rgb_to_yuv420_host(f, eh, ew)[0][:eh, :ew] for f in efr]
    rep["psnr"] = {}
    for name, (_, aus, _) in streams.items():
        dec = cv2_luma(f"modes_{name}", aus, eh, ew)
        if dec is None:
            rep["psnr"][name] = "not run"
            continue
        check(len(dec) == len(aus), f"(c) modes {name}: cv2 decoded {len(dec)}")
        p = min(psnr(a, b) for a, b in zip(dec, src_y))
        check(p > 30.0, f"(c) modes {name}: PSNR {p:.2f} dB")
        rep["psnr"][name] = p
    print(f"(b) modes: {', '.join(MODES_PLAIN)}: an IDR and two P frames equal "
          "to the plain path (a twin on the host's CPU); (c) cv2 decoded every "
          "stream, min luma PSNR " + ", ".join(
              f"{k} {v if isinstance(v, str) else round(v, 2)}"
              for k, v in rep["psnr"].items()))

    lap("twins_cv2")
    # PCM: lossless, so cv2 gives back K9's planes exactly
    pcm = H264Encoder(W, H, device=dev)
    check(pcm.mode == "pcm", "the default mode is not pcm")
    au = pcm.encode(gop[0]).data
    check(au == H264Encoder(W, H, device="cpu").encode(gop[0]).data,
          "(b) pcm: the frame differs from the plain path")
    ky = color.rgb_to_yuv420(torch.from_numpy(gop[0]).to(dev), H_PAD, W)[0]
    dec = cv2_luma("modes_pcm", [au], H, W)
    if dec is not None:
        check(len(dec) == 1 and np.array_equal(dec[0], ky[:H].cpu().numpy()),
              "(c) pcm: cv2 did not give back the source planes")
    print("(b) pcm: a 1080p frame equal to the plain path; (c) cv2 decoded it "
          "to its K9 luma exactly" if dec is not None else
          "(c) pcm: cv2 decode not run (no cv2)")

    # MJPEG native against the Python coder on the same levels
    mj = JpegEncoder(ew, eh, entropy="native", device=dev)
    lv = mj.transform(efr[0])
    a = mj.entropy_encode(*lv)
    b = JpegEncoder(ew, eh, entropy="python", device=dev).entropy_encode(*lv)
    check(a == b, "mjpeg native: bytes differ from the Python coder's")
    check(mj.encode(efr[0]).data == a, "mjpeg native: encode differs")
    print(f"(b) mjpeg native: {len(a)} bytes equal to the Python coder's on "
          "the same levels")

    lap("pcm_mjpeg")
    # -- timing: each new form beside its bound (1080p desktop) ---------------
    desk = up(gop[0], H_PAD, W)
    nb1 = nbytes(*desk) + nbytes(*k1(*desk, 26).values())
    rows, times = [], {}
    for modes in ("full", "i16", "dc"):
        for tune in tiers:
            times[(modes, tune)] = cuda_ms(
                lambda: k1(*desk, 26, tune, i16_modes=modes), reps=10)
        for suffix, tune in (("", "off"), ("_hq", "hq")):
            rows.append(kernel_row(
                f"intra_{modes}{suffix}", "intra.cu", "h264_device.py:555",
                launches[f"intra_{modes}{suffix}"], 0.0, times[(modes, tune)],
                plain_s[(modes, tune)], nb1))
    nmb = (H_PAD // 16) * (W // 16)
    nb5 = nbytes(*cur, *ref) + nbytes(*k5(*cur, *ref, 26).values())
    for kind, fn, src, args in (("inter_full", k5, "h264_inter.py:272", ref),
                                ("inter_padded_full", k5p, "h264_inter.py:300",
                                 pad)):
        for tune in tiers:
            times[(kind, tune)] = cuda_ms(
                lambda: fn(*cur, *args, 26, refine="full", tune=tune), reps=20)
        for suffix, tune, tier in (("", "off", 0), ("_hq", "hq", 2)):
            rows.append(kernel_row(
                kind + suffix, "inter.cu", src, launches[kind + suffix], 0.0,
                times[(kind, tune)],
                plain_s[("k5" if kind == "inter_full" else "k5p", tune)], nb5,
                k5_full_ops(nmb, tier)))
    rep["ms"] = {f"{k[0]} {k[1]}": v for k, v in times.items()}
    rep["plain_ms"] = {f"{k[0]} {k[1]}": v for k, v in plain_s.items()}
    rep["k1_auto_ms"] = cuda_ms(lambda: k1(*desk, 26), reps=10)
    rep["k5_alt_ms"] = cuda_ms(lambda: k5(*cur, *ref, 26), reps=20)
    for (what, tune), ms in times.items():
        print(f"kernel {what} {tune}: {ms:.3f} ms")
    print(f"modes: K1 auto {rep['k1_auto_ms']:.3f} ms, K5 alt "
          f"{rep['k5_alt_ms']:.3f} ms beside them (same call)")
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              + ("no caller reaches it)" if r["name"] in no_path else
                 f"{r['launches']} launches on the path)"))
    lap("timing")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"modes phase: {rep['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    return rows


def cv2_luma(name: str, aus, h: int, w: int):
    """The luma planes cv2 decodes from an Annex-B stream (None without
    cv2)."""
    import numpy as np
    try:
        import cv2
    except ImportError:
        return None
    path = os.path.join(HERE, "chiprun_out", f"{name}.264")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(aus))
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(np.asarray(img).reshape(-1, w)[:h])
    cap.release()
    os.remove(path)
    return out


def colour_phase(report):
    """Device colour (K9): an odd geometry, which the host converter
    cannot take, through ``make_encoder`` (the default GOP configuration,
    two frames in flight); the access units against an encoder whose
    colour is the plain version; K9 against its plain version on 1080p
    and odd frames, and against cv2's host conversion plus upload."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import color
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    dev = torch.device("cuda")
    frames = [np.ascontiguousarray(f[:ODD_H, :ODD_W])
              for f in gop_frames(COLOUR_FRAMES, seed=3)]
    cfg = from_env({"SIZEW": str(ODD_W), "SIZEH": str(ODD_H)})

    def run_stream():
        enc, _ = make_encoder(cfg, ODD_W, ODD_H)
        aus, pending = [], []
        for f in frames + [None]:
            if f is not None:
                pending.append(enc.encode_submit(f))
            if len(pending) == 2 or (f is None and pending):
                aus.append(enc.encode_collect(pending.pop(0)).data)
        return enc, aus

    # -- main path ----------------------------------------------------------
    color.rgb_to_yuv420_frames.launches = 0
    enc, aus = run_stream()
    torch.cuda.synchronize()
    launches = color.rgb_to_yuv420_frames.launches
    print(f"colour main: {len(aus)} frames at {ODD_W}x{ODD_H} (host_color "
          f"{enc.host_color}, no host planes for odd geometry), K9 launches "
          f"{launches}")
    check(launches == COLOUR_FRAMES, f"K9 launched {launches} times for "
          f"{COLOUR_FRAMES} frames")
    # (b) the same stream with the plain colour conversion
    kernel = color.rgb_to_yuv420

    def plain(rgb, pad_h, pad_w):
        return color.rgb_to_yuv420_plain(rgb, pad_h, pad_w)

    color.rgb_to_yuv420 = plain
    try:
        _, want = run_stream()
    finally:
        color.rgb_to_yuv420 = kernel
    check(aus == want, "(b) colour: the AUs differ from those of the plain "
          "colour conversion")
    print(f"(b) colour: {len(aus)} access units equal to the plain colour's")

    # -- (a) K9 against its plain version, exact -----------------------------
    ph, pw = -(-H // 16) * 16, -(-W // 16) * 16
    big = gop_frames(3, seed=4)
    cases = [(f, ph, pw) for f in big] + [(frames[0], ph, pw)]
    for f, ph, pw in cases:
        t = torch.from_numpy(np.ascontiguousarray(f)).to(dev)
        for a, b in zip(color.rgb_to_yuv420(t, ph, pw),
                        color.rgb_to_yuv420_plain(t, ph, pw)):
            check(torch.equal(a, b), f"K9 differs at {tuple(t.shape)}")
    print(f"(a) colour: K9 equal to its plain version on {len(big)} {W}x{H} "
          f"frames and a {ODD_W}x{ODD_H} frame")
    rgb = torch.from_numpy(big[1]).to(dev)
    y, cb, cr = color.rgb_to_yuv420(rgb, ph, pw)
    ms = cuda_ms(lambda: color.rgb_to_yuv420(rgb, ph, pw), reps=20)
    plain_ms = cuda_ms(lambda: color.rgb_to_yuv420_plain(rgb, ph, pw), reps=3)

    # the two colour routes of a 1080p frame, host clock, synchronised
    def host_route():
        planes = rgb_to_yuv420_host(big[1], ph, pw, float_fallback=False)
        out = [torch.from_numpy(p).to(dev) for p in planes]
        torch.cuda.synchronize()
        return out

    def device_route():
        out = color.rgb_to_yuv420(torch.from_numpy(big[1]).to(dev), ph, pw)
        torch.cuda.synchronize()
        return out

    spans = {}
    for name, fn in (("host", host_route), ("device", device_route)):
        fn()
        ts = []
        for _ in range(7):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        spans[name] = statistics.median(ts)
    print(f"colour at {W}x{H}: cv2 on the host + plane upload "
          f"{spans['host']:.2f} ms; RGB upload + K9 {spans['device']:.2f} ms "
          f"(host clock, synchronised, median of 7)")
    report["colour"] = {"launches": launches, "k9_ms": ms, "plain_ms": plain_ms,
                        "host_route_ms": spans["host"],
                        "device_route_ms": spans["device"]}
    row = kernel_row("color", "color.cu",
                     "models/h264.py:207 _yuv_stage (ops/color.py:90 "
                     "rgb_to_yuv420)", launches, 0.0, ms, plain_ms,
                     nbytes(rgb, y, cb, cr))
    print(f"kernel color: {ms:.3f} ms (bound {row['bound_ms']:.4f} ms by "
          f"bytes; plain {plain_ms:.2f} ms; 1 launch/frame)")
    return [row]


def cabac_phase(report):
    """``ENCODER_ENTROPY=cabac`` at 1080p (GOP 60, deblock, rate control)
    on both transports: ``ENCODER_CABAC_BINARIZE=host`` (K10) and
    ``=device`` (K11i/K11p), two frames in flight."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_cabac
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        cabac_binarize, content_stats, h264_deblock, h264_device, h264_inter,
        level_pack)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    dev = torch.device("cuda")
    frames = gop_frames(CABAC_FRAMES, seed=5)
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_ENTROPY": "cabac"}
    common = {"intra": h264_device.encode_intra_frame_yuv,
              "content_stats_full": content_stats.chunk_stats,
              "inter": h264_inter.encode_p_frame,
              "deblock": h264_deblock.deblock_frame}
    route_kernels = {"host": {"level_pack": level_pack.pack_levels},
                     "device": {"binarize_intra": cabac_binarize.binarize_intra,
                                "binarize_p": cabac_binarize.binarize_p}}

    def encoder(route, **extra):
        os.environ["ENCODER_CABAC_BINARIZE"] = route
        enc, codec = make_encoder(from_env(dict(env, **extra)), W, H)
        check(codec == "h264_cabac" and enc.cabac_device_binarize == (
            route == "device"), f"not the CABAC {route} route")
        return enc

    def flag(tok):
        """The transport's overflow flag, once its prefix has landed."""
        host, ev = tok[4][3]
        if ev is not None:
            ev.synchronize()
        return bool(host.numpy()[1])

    # -- main path, per route ------------------------------------------------
    runs = {}
    for route in ("host", "device"):
        enc = encoder(route)
        check(enc.gop == 60 and enc.deblock and enc._rate is not None,
              "not the default configuration")
        wrappers = dict(common, **route_kernels[route])
        for fn in wrappers.values():
            fn.launches = 0
        calls0, py0 = dict(native_lib.calls), h264_cabac.python_pictures
        toks, refs, aus, overflow, pending = [], [], [], [], []
        for f in frames + [None]:
            if f is not None:
                toks.append(enc.encode_submit(f))
                refs.append(tuple(p.clone() for p in enc._ref))
                pending.append(toks[-1])
            if len(pending) == 2 or (f is None and pending):
                tok = pending.pop(0)
                overflow.append(flag(tok))
                aus.append(enc.encode_collect(tok).data)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        calls = {k: native_lib.calls[k] - calls0.get(k, 0)
                 for k in native_lib.calls}
        qps = [t[4][5] for t in toks]
        print(f"cabac main ({route}): {len(aus)} frames, qp {qps}, overflow "
              f"at {[i for i, o in enumerate(overflow) if o]}, launches "
              f"{launches}, native calls {calls}")
        check(all(v >= 1 for v in launches.values()),
              f"a kernel of the CABAC {route} path never launched: {launches}")
        check(h264_cabac.python_pictures == py0,
              f"the Python CABAC coder ran on the {route} route")
        check(len(set(qps)) > 1, "the rate controller did not move qp")
        check(not any(overflow), f"a {route} transport overflowed")
        # each route's own native entry points coded every frame and the
        # other route's never ran: no device-route frame went dense
        n = len(frames)
        want = ({"level_unpack_rows": n, "h264_cabac_intra_slices": 1,
                 "h264_cabac_p_slices": n - 1, "h264_cabac_engine_rows": 0}
                if route == "host" else
                {"level_unpack_rows": 0, "h264_cabac_intra_slices": 0,
                 "h264_cabac_p_slices": 0, "h264_cabac_engine_rows": n})
        got = {k: calls.get(k, 0) for k in want}
        check(got == want, f"the {route} route's native calls {got}, not {want}")
        runs[route] = {"enc": enc, "toks": toks, "refs": refs, "aus": aus,
                       "launches": launches, "calls": calls, "qps": qps}
    check(runs["host"]["aus"] == runs["device"]["aus"],
          "the two CABAC routes' access units differ")
    for a, b in zip(runs["host"]["refs"], runs["device"]["refs"]):
        check(all(torch.equal(p, q) for p, q in zip(a, b)),
              "the two CABAC routes' references differ")
    aus = runs["host"]["aus"]
    nr, nc = runs["host"]["enc"].mb_h, runs["host"]["enc"].mb_w
    types = [[n[0] & 0x1F for n in au.split(syn.START_CODE)[1:]] for au in aus]
    check(types[0] == [syn.NAL_SPS, syn.NAL_PPS] + [syn.NAL_IDR] * nr
          and all(t == [syn.NAL_SLICE] * nr for t in types[1:]),
          f"CABAC NAL types {types[0][:4]}...")
    check(aus[0].split(syn.START_CODE)[1][1] == 77, "the SPS is not Main profile")
    print(f"cabac: the host and device routes' {len(aus)} access units are "
          f"byte-identical ({sum(map(len, aus))} bytes)")

    # -- (a) every transport against its plain version at the run's inputs ---
    t_a = time.perf_counter()
    for route, r in runs.items():
        enc = r["enc"]
        for i, tok in enumerate(r["toks"]):
            kind, lv, buf = tok[0], tok[4][1], tok[4][2]
            if route == "host":
                keys = (level_pack.INTRA_KEYS if kind == "cabac_intra"
                        else level_pack.P_KEYS)
                want = level_pack.pack_slots_plain(level_pack.mb_slots(lv, keys))
            elif kind == "cabac_intra":
                want = cabac_binarize.binarize_intra_plain(
                    *(lv[k] for k in enc._BIN_INTRA_KEYS))
            else:
                want = cabac_binarize.binarize_p_plain(
                    *(lv[k] for k in enc._BIN_P_KEYS))
            words = k10_words if route == "host" else k11_words
            buf, want = words(buf), words(want)
            check(torch.equal(buf, want), f"(a) cabac {route} frame {i} "
                  f"({kind}): the transport differs from the plain version")
    # the overflow flags on one giant value, at the main path's shapes
    def zeros(keys):
        return {k: torch.zeros((nr, nc) + shape, dtype=torch.int32, device=dev)
                for k, _, shape in keys}

    lp = zeros(level_pack.P_KEYS)
    lp["luma"][0, 0, 0, 0] = 20000
    got = level_pack.pack_levels(lp, level_pack.P_KEYS)
    want = level_pack.pack_slots_plain(level_pack.mb_slots(lp, level_pack.P_KEYS))
    check(torch.equal(k10_words(got), k10_words(want)) and int(got[1]) == 1,
          "K10 overflow flag")
    lp["luma"][0, 0, 0, 0] = 500
    mv = torch.zeros((nr, nc, 2), dtype=torch.int32, device=dev)
    args = [mv] + [lp[k] for k, _, _ in level_pack.P_KEYS]
    got = cabac_binarize.binarize_p(*args)
    check(torch.equal(k11_words(got), k11_words(cabac_binarize.binarize_p_plain(*args)))
          and int(got[1]) == 1, "K11p overflow flag")
    li = zeros(level_pack.INTRA_KEYS)
    li["luma_i4"][0, 1, 2, 0] = -500
    mb_i4 = torch.zeros((nr, nc), dtype=torch.bool, device=dev)
    mb_i4[0, 1] = True
    i32 = lambda *s: torch.zeros((nr, nc) + s, dtype=torch.int32, device=dev)
    args = [li[k] for k in ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc",
                            "cr_ac")] + [i32(), mb_i4, i32(16), li["luma_i4"]]
    got = cabac_binarize.binarize_intra(*args)
    check(torch.equal(k11_words(got), k11_words(cabac_binarize.binarize_intra_plain(*args)))
          and int(got[1]) == 1, "K11i overflow flag")
    print(f"(a) cabac: every K10, K11i and K11p transport of both runs equal "
          f"to its plain version ({time.perf_counter() - t_a:.0f} s); the "
          "overflow flags of K10, K11p and K11i set and equal on one giant level")

    # -- the dense fallback: a noise P frame past the record budget ----------
    dense_frames = [frames[0], np.random.default_rng(6).integers(
        0, 256, (H, W, 3), dtype=np.uint8), frames[2]]
    dense = {}
    for route in ("device", "host"):
        enc = encoder(route, ENCODER_BITRATE_KBPS="0", ENCODER_QP=CABAC_DENSE_QP)
        calls0 = dict(native_lib.calls)
        toks = [enc.encode_submit(f) for f in dense_frames]
        flags = [flag(t) for t in toks]
        dense[route] = ([enc.encode_collect(t).data for t in toks], flags, {
            k: native_lib.calls[k] - calls0.get(k, 0) for k in native_lib.calls})
    d_aus, d_flags, d_calls = dense["device"]
    check(d_flags[1] and d_calls.get("h264_cabac_p_slices", 0) >= 1,
          f"the noise P frame did not take the dense coder: {d_flags} {d_calls}")
    check(d_aus == dense["host"][0], "the dense fallback's AUs differ from the "
          "host route's")
    print(f"cabac dense fallback: at qp {CABAC_DENSE_QP} the noise P frame's "
          f"records overflowed (flags {d_flags}), the native coder coded it from "
          f"the dense levels, AUs equal to the host route's (flags "
          f"{dense['host'][1]})")

    # -- (c) a decoder's view ------------------------------------------------
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("(c) cabac cv2 decode: not run (no cv2 on this machine)")
    else:
        path = os.path.join(HERE, "chiprun_out", "cabac.264")
        with open(path, "wb") as f:
            f.write(b"".join(aus))
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        for i, ref in enumerate(runs["host"]["refs"]):
            ok, img = cap.read()
            check(ok, f"(c) cv2 stopped decoding the CABAC stream at frame {i}")
            check(np.array_equal(np.asarray(img).reshape(H, W),
                                 ref[0][:H, :W].cpu().numpy()),
                  f"(c) CABAC frame {i}: decoded luma differs from the "
                  "deblocked reference")
        cap.release()
        os.remove(path)
        print(f"(c) cabac cv2 decode: ran; {len(aus)} decoded luma planes equal "
              "to the deblocked references")

    # -- kernel times at the main path's inputs ------------------------------
    pi = 3
    h_tok, d_tok = runs["host"]["toks"], runs["device"]["toks"]
    out_p, lv_i = h_tok[pi][4][1], d_tok[0][4][1]
    enc_d = runs["device"]["enc"]
    p_args = [out_p[k] for k in enc_d._BIN_P_KEYS]
    i_args = [lv_i[k] for k in enc_d._BIN_INTRA_KEYS]

    def out_bytes(buf):
        return 4 * (nr + 8 + int(buf[2]))

    b10, b11p, b11i = h_tok[pi][4][2], d_tok[pi][4][2], d_tok[0][4][2]
    lv_p = [out_p[k] for k, _, _ in level_pack.P_KEYS]
    specs = [
        ("level_pack", "levelpack.cu", "level_pack.py:131 pack_levels (_pack :83)",
         runs["host"]["launches"]["level_pack"],
         lambda: level_pack.pack_levels(out_p, level_pack.P_KEYS),
         lambda: level_pack.pack_slots_plain(level_pack.mb_slots(
             out_p, level_pack.P_KEYS)),
         nbytes(*lv_p) + out_bytes(b10)),
        ("binarize_intra", "cabac.cu", "cabac_binarize.py:490 binarize_intra",
         runs["device"]["launches"]["binarize_intra"],
         lambda: cabac_binarize.binarize_intra(*i_args),
         lambda: cabac_binarize.binarize_intra_plain(*i_args),
         nbytes(*i_args) + out_bytes(b11i)),
        ("binarize_p", "cabac.cu", "cabac_binarize.py:415 binarize_p",
         runs["device"]["launches"]["binarize_p"],
         lambda: cabac_binarize.binarize_p(*p_args),
         lambda: cabac_binarize.binarize_p_plain(*p_args),
         nbytes(*p_args) + out_bytes(b11p)),
    ]
    rows = []
    for name, src, replaces, launches, fk, fp, nb in specs:
        rows.append(kernel_row(name, src, replaces, launches, 0.0,
                               cuda_ms(fk, reps=20), cuda_ms(fp, reps=3), nb))
        # beside the eager ms: the device time (a memset and a launch)
        rows[-1]["device_ms"] = device_ms(fk, name, rows[-1]["bound_ms"], 2)
    k10_intra = lambda: level_pack.pack_levels(lv_i, level_pack.INTRA_KEYS)
    k10_intra_ms = cuda_ms(k10_intra, reps=20)
    k10_intra_bound = (nbytes(*(lv_i[k] for k, _, _ in level_pack.INTRA_KEYS))
                       + out_bytes(k10_intra())) / HBM_BYTES_PER_S * 1e3
    k10_intra_dev = device_ms(k10_intra, "level_pack (IDR levels)", k10_intra_bound, 2)
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches'] / len(frames):.2f} launches/frame)")
    print(f"kernel level_pack (IDR levels): {k10_intra_ms:.3f} ms, device "
          f"{k10_intra_dev} ms (bound {k10_intra_bound:.4f} ms by bytes); payload words "
          f"K10 P {int(b10[2])}, K11p {int(b11p[2])}, K11i {int(b11i[2])}")

    # -- each route timed with one frame in flight ---------------------------
    # host spans of a collect: "decode" the level transport's decode
    # (native decoder + NumPy unpacking), "code" the CABAC picture coder
    # (NumPy preparation, native coder or engine, slice headers, EPB and
    # NAL), "native" the native entry points alone (inside the other two)
    timed = gop_frames(CABAC_FRAMES, seed=6)
    hooks = ([(native_lib, n, "native") for n in
              ("cabac_slices", "cabac_engine_rows", "level_unpack")]
             + [(level_pack, "unpack_levels", "decode")]
             + [(h264_cabac, n, "code") for n in
                ("encode_intra_picture", "encode_p_picture",
                 "encode_intra_from_binstream", "encode_p_from_binstream")])
    originals = [getattr(mod, n) for mod, n, _ in hooks]
    span = {"native": 0.0, "decode": 0.0, "code": 0.0}

    def timed_fn(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                span[key] += (time.perf_counter() - t) * 1e3
        return call

    report["cabac"] = {"k10_intra": {"ms": k10_intra_ms, "device_ms": k10_intra_dev,
                                     "bound_ms": k10_intra_bound}}
    for route in ("host", "device"):
        enc = encoder(route)
        lat, sub, col = [], [], []
        spans = {k: [] for k in span}
        for (mod, n, key), fn in zip(hooks, originals):
            setattr(mod, n, timed_fn(fn, key))
        try:
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            for f in timed:
                for k in span:
                    span[k] = 0.0
                ts = time.perf_counter()
                tok = enc.encode_submit(f)
                tc = time.perf_counter()
                enc.encode_collect(tok)
                te = time.perf_counter()
                sub.append((tc - ts) * 1e3)
                col.append((te - tc) * 1e3)
                lat.append((te - ts) * 1e3)
                for k in span:
                    spans[k].append(span[k])
            run_s = time.perf_counter() - t_run
        finally:
            for (mod, n, _), fn in zip(hooks, originals):
                setattr(mod, n, fn)
        fps = len(timed) / run_s
        med = {k: statistics.median(v[1:]) for k, v in spans.items()}
        wait = statistics.median(c - d - e for c, d, e in zip(
            col[1:], spans["decode"][1:], spans["code"][1:]))
        print(f"cabac e2e ({route}, one frame in flight): {fps:.2f} frames/s over "
              f"{len(timed)} frames, p50 {statistics.median(lat):.2f} ms, P p50 "
              f"{statistics.median(lat[1:]):.2f} ms, IDR {lat[0]:.2f} ms; submit "
              f"p50 {statistics.median(sub):.2f} ms, collect p50 "
              f"{statistics.median(col):.2f} ms")
        print(f"cabac host spans ({route}, P frames, p50 ms): wait + pull "
              f"{wait:.2f}, transport decode {med['decode']:.2f}, picture coder "
              f"{med['code']:.2f}; host CABAC span (the native "
              f"{'level decoder and coder' if route == 'host' else 'engine'}) "
              f"{med['native']:.2f} (IDR {spans['native'][0]:.2f})")
        report["cabac"][route] = {
            "fps": fps, "p50_ms": statistics.median(lat),
            "p50_p_ms": statistics.median(lat[1:]), "lat_ms": lat,
            "submit_ms": sub, "collect_ms": col, "spans_ms": spans,
            "qps": runs[route]["qps"], "launches": runs[route]["launches"],
            "native_calls": runs[route]["calls"]}
    os.environ.pop("ENCODER_CABAC_BINARIZE", None)
    report["cabac"]["au_bytes"] = [len(a) for a in aus]
    return rows

# -- the chunk ring and damage-driven encode ------------------------------------

class _Owner:
    """Owner of a chunk step's outputs in a check run outside an encoder:
    released, so the next replay may reuse them."""
    released = True


def drive(enc, frames, keyframe_at=(), depth=None, on_submit=None,
          on_collect=None):
    """The serving loop at ``depth`` frames in flight (the encoder's
    preferred depth by default).  Returns (tokens, AUs, keyframe flags)."""
    depth = depth or enc.pipeline_depth
    toks, aus, keys, pend = [], [], [], []
    for i, f in enumerate(list(frames) + [None]):
        if f is not None:
            if i in keyframe_at:
                enc.request_keyframe()
            pend.append(enc.encode_submit(f))
            toks.append(pend[-1])
            if on_submit is not None:
                on_submit(enc, pend[-1])
        while len(pend) >= depth or (f is None and pend):
            ef = enc.encode_collect(pend.pop(0))
            aus.append(ef.data)
            keys.append(ef.keyframe)
            if on_collect is not None:
                on_collect(enc)
    return toks, aus, keys


def token_qp(tok) -> int:
    kind, payload = tok[0], tok[4]
    if kind == "ring":
        return payload[0].qp
    if kind == "intra":
        return payload[2]
    if kind in ("cabac_intra", "cabac_p"):
        return payload[5]
    return payload[0]


def pinned_per_frame(env, w, h, qps):
    """The per-frame path at the qps a ring run coded (the ring holds one
    qp per chunk where the rate controller moves it per frame): chunk
    off, rate control off, each frame's qp taken from ``qps``."""
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    enc, _ = make_encoder(from_env(dict(env, ENCODER_SUPERSTEP_CHUNK="0",
                                        ENCODER_BITRATE_KBPS="0")), w, h)
    it = iter(qps)
    enc._eff_qp = lambda keyframe=True: next(it)
    return enc


def zero_counts(named) -> None:
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    for fn in named.values():
        fn.launches = 0
    devloop.reset_counts()


def path_launches(named) -> dict:
    """Launches of each wrapper's kernel since the counts were zeroed:
    direct launches, less those recorded into graphs at capture (which
    never ran), plus the graphs' kernel nodes times their replays."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    graph_name = {id(fn): n for n, fn in devloop.wrappers().items()}
    out = {}
    for name, fn in named.items():
        g = graph_name.get(id(fn))
        out[name] = fn.launches + (devloop.replayed[g] - devloop.captured[g]
                                   if g else 0)
    return out


def graph_stats(*encs) -> dict:
    """The encoders' graph budgets: instances live, captured and evicted
    over their lives, the pools' bytes now and at their peak, replays."""
    bs = [e._graphs for e in encs]
    return {"graphs": sum(len(b.live) for b in bs),
            "captures": sum(b.captures for b in bs),
            "evicted": sum(b.evicted for b in bs),
            "pool_bytes": sum(b.pool_bytes for b in bs),
            "peak_pool_bytes": sum(b.peak_bytes for b in bs),
            "replays": sum(b.replays for b in bs)}


def dispatched_chunks(toks) -> int:
    rings = {id(t[4][0]): t[4][0] for t in toks if t[0] == "ring"}
    return sum(1 for r in rings.values() if r.res is not None)


def ring_phase(report):
    """ENCODER_SUPERSTEP_CHUNK=4 through make_encoder: device CAVLC,
    CABAC (device binarization) and rgb ingest, each against the
    per-frame path at the ring's qps; one chunk's replay against the
    eager body; K4c and K9's frame axis against their plain versions;
    the ring against the per-frame path in alternating timed runs."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        bitmerge, cavlc_device, color, content_stats, devloop, h264_device)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    dev = torch.device("cuda")
    named = dict(devloop.wrappers(),
                 content_chunk=content_stats.chunk_stats,
                 intra=h264_device.encode_intra_frame_yuv,
                 cavlc_slots=cavlc_device.frame_block_slots,
                 pack=bitmerge.pack_frame)
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": "57",
           "ENCODER_SUPERSTEP_CHUNK": "4"}
    frames = gop_frames(RING_FRAMES, seed=5, noisy_at=RING_NOISY_AT)
    rep = report["ring"] = {}

    # -- main path: device CAVLC ----------------------------------------------
    zero_counts(named)
    enc, _ = make_encoder(from_env(env), W, H)
    check(enc._ring_chunk == 4 and enc.pipeline_depth == 5 and enc.deblock
          and enc._rate is not None and enc.gop == 57,
          "not the deployed ring configuration")
    stats = []
    t0 = time.perf_counter()
    toks, aus, keys = drive(enc, frames, (RING_KF_AT,),
                            on_collect=lambda e: stats.append(
                                e.pop_content_stats()))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = path_launches(named)
    gs = graph_stats(enc)
    kinds = [t[0] for t in toks]
    qps = [token_qp(t) for t in toks]
    chunks = dispatched_chunks(toks)
    rep.update(kinds=kinds, qps=qps, launches=launches, chunks=chunks,
               au_bytes=[len(a) for a in aus], graphs=gs)
    print(f"ring main: {len(aus)} frames in {main_s:.2f} s (graph captures "
          f"included), {chunks} chunks replayed, qp {qps}, launches "
          f"{launches}, graphs {gs}")
    check(all(launches[k] >= 1 for k in (
        "inter", "cavlc_p_slots", "pack_p", "deblock", "content_chunk",
        "intra", "cavlc_slots", "pack")),
          f"a kernel of the ring path never launched: {launches}")
    check(gs["replays"] == chunks, f"{gs['replays']} replays for {chunks} "
          "chunks")
    check(keys == [i in (0, RING_KF_AT) for i in range(RING_FRAMES)],
          f"keyframes {keys}")
    check(len(set(qps[1:])) > 1, "the rate controller did not move qp")
    ring, slot = toks[RING_NOISY_AT][4]
    check(ring.res is not None and cavlc_device.FlatMeta(
        ring.prefix[slot][0].numpy(), enc.mb_h).overflow,
          "the noise P frame did not overflow inside a chunk")
    check(any(t[0] == "ring" and t[4][0].pf is not None for t in toks),
          "no partial chunk went through the per-frame path")
    check(all(s is not None for s in stats), "content stats missing")
    check(any(s["psnr_db"] is not None and s["mode"] is not None
              for s, k in zip(stats, kinds) if k == "ring"),
          "no chunk slot carries PSNR and the mode mix")

    # -- (b) the per-frame path at the ring's qps ------------------------------
    per = pinned_per_frame(env, W, H, qps)
    _, paus, _ = drive(per, frames, (RING_KF_AT,), depth=2)
    check(aus == paus, "(b) ring: the AUs differ from the per-frame path's")
    for i, au in enumerate(aus):
        types = [n[0] & 0x1F for n in au.split(syn.START_CODE)[1:]]
        check(types.count(syn.NAL_SLICE if not keys[i] else syn.NAL_IDR)
              == enc.mb_h, f"ring frame {i}: NAL types {types[:4]}...")
    print(f"(b) ring: {len(aus)} access units byte-identical to the per-frame "
          "path at the ring's qps on the card")

    # -- one chunk: the graph's replay against the eager body -----------------
    step = enc._chunk_steps[("cavlc", "yuv", 0)]
    host = [enc._host_yuv420(f) for f in frames[1:5]]
    hv, hl = enc._chunk_hdr_slots((1, 2, 3, 4), 0)
    refs = tuple(p.clone() for p in enc._ref)
    qp0 = qps[1]
    g = step(host, refs, hv, hl, None, qp0, owner=_Owner())
    e = step.run_eager(host, refs, hv, hl, None, qp0)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(g.flats, e.flats))
            and all(torch.equal(a, b) for a, b in zip(g.refs, e.refs))
            and torch.equal(g.mvs, e.mvs) and torch.equal(g.ys, e.ys)
            and all(torch.equal(g.lvs[k], e.lvs[k]) for k in e.lvs))
    check(same, "a chunk's graph replay differs from the eager body")
    inst = next(i for i in step.instances if i.out is g)
    fr_t, refs_t, hv_t, hl_t, _, qp_t = inst.inputs
    g_ms = cuda_ms(inst.graph.replay, reps=20)
    e_ms = cuda_ms(lambda: step._body(fr_t, refs_t, hv_t, hl_t, None, qp0,
                                      qp_t), reps=10)
    nmb = enc.mb_h * enc.mb_w
    chunk_bytes = (nbytes(*fr_t, *refs_t, hv_t, hl_t, g.mvs, *g.lvs.values(),
                          *g.refs) + 4 * bitmerge.FLAT_BYTES)
    g_row = kernel_row("chunk_step_graph", "", "devloop.py:226 "
                       "build_p_chunk_step", chunks, 0.0, g_ms, e_ms,
                       chunk_bytes, 4 * k5_ops(nmb))
    g_row["source"] = "docker_nvidia_glx_desktop_tpu_torch/ops/devloop.py"
    print(f"(a) ring: one chunk's replay equal to the eager body (flats, "
          f"references, MVs, levels); replay {g_ms:.3f} ms, eager body "
          f"{e_ms:.3f} ms a chunk of 4 (CUDA events)")

    # -- (a) K5 and K8 reading qp from device memory, as the graph does, ----
    # against their plain versions on the chunk's first frame, at a qp other
    # than the one the host argument names
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        cavlc_p_device, h264_deblock, h264_inter)

    qp_alt = qp0 + 5 if qp0 <= 46 else qp0 - 5
    qp_t1 = torch.full((1,), qp_alt, dtype=torch.int32, device=dev)
    cur = tuple(f[0] for f in fr_t)
    o_k = h264_inter.encode_p_frame(*cur, *refs, qp0, qp_dev=qp_t1)
    o_p = h264_inter.encode_p_frame_plain(*cur, *refs, qp_alt)
    for k in o_p:
        check(torch.equal(o_k[k], o_p[k]), f"K5 with qp_dev: {k} differs")
    rec = (o_k["recon_y"], o_k["recon_cb"], o_k["recon_cr"])
    d_k = h264_deblock.deblock_frame(*rec, qp0, mv=o_k["mv"],
                                     luma=o_k["luma"], qp_dev=qp_t1)
    d_p = h264_deblock.deblock_frame_plain(
        *rec, qp_alt, nnz_blk=cavlc_p_device.nnz_raster(o_k["luma"]),
        mv=o_k["mv"])
    for plane, a, b in zip(("luma", "cb", "cr"), d_k, d_p):
        check(torch.equal(a, b), f"K8 with luma= and qp_dev: {plane} differs")
    print(f"(a) ring: K5 with qp_dev and K8 with luma= and qp_dev (qp {qp_alt} "
          f"on the card, {qp0} named by the host) equal to their plain "
          f"versions at qp {qp_alt} on the chunk's first frame (every output; "
          "all three filtered planes)")

    # -- (a) K4c against its plain version on the chunk's outputs -------------
    resid = tuple(e.lvs[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc",
                                     "cr_ac"))
    prev = refs[0]
    vk, gk = content_stats.chunk_stats(e.ys, prev, 512, e.refs[0], e.mvs,
                                       resid)
    vp, gp = content_stats.chunk_stats_plain(e.ys, prev, 512, e.refs[0],
                                             e.mvs, resid)
    ints = [1, 2, 3, 4, 9]
    check(torch.equal(gk, gp) and torch.equal(vk[:, ints], vp[:, ints]),
          "K4c: grids or integer fields differ")
    rel = float(((vk - vp).abs() / vp.abs().clamp(min=1)).max())
    check(rel <= FLOAT_REL_TOL, f"K4c: {vk} vs {vp}")
    c_err = float((vk - vp).abs().max())
    c_ms = cuda_ms(lambda: content_stats.chunk_stats(
        e.ys, prev, 512, e.refs[0], e.mvs, resid), reps=20)
    c_plain = cuda_ms(lambda: content_stats.chunk_stats_plain(
        e.ys, prev, 512, e.refs[0], e.mvs, resid), reps=3)
    c_row = kernel_row("content_chunk", "content.cu",
                       "content_stats.py:169 chunk_stats",
                       launches["content_chunk"], c_err, c_ms, c_plain,
                       nbytes(e.ys, prev, e.refs[0], e.mvs, *resid, vk, gk))
    print(f"(a) ring: K4c equal to its plain version over a chunk of 4 "
          f"(grids and counts exact, floats within rel {FLOAT_REL_TOL}); "
          f"max abs err {c_err:.3g}")

    # -- CABAC with device binarization --------------------------------------
    os.environ["ENCODER_CABAC_BINARIZE"] = "device"
    try:
        cenv = dict(env, ENCODER_ENTROPY="cabac")
        cframes = gop_frames(RING_CABAC_FRAMES, seed=6)
        zero_counts(named)
        cenc, _ = make_encoder(from_env(cenv), W, H)
        check(cenc._ring_chunk == 4, "the CABAC ring is off")
        ctoks, caus, _ = drive(cenc, cframes)
        torch.cuda.synchronize()
        cl = path_launches(named)
        check(all(cl[k] >= 1 for k in ("inter", "binarize_p", "deblock")),
              f"a kernel of the CABAC ring never launched: {cl}")
        cper = pinned_per_frame(cenv, W, H, [token_qp(t) for t in ctoks])
        _, cpaus, _ = drive(cper, cframes, depth=2)
        check(caus == cpaus, "(b) CABAC ring: the AUs differ from the "
              "per-frame path's")
    finally:
        os.environ.pop("ENCODER_CABAC_BINARIZE", None)
    print(f"ring cabac: {len(caus)} AUs byte-identical to the per-frame path "
          f"({dispatched_chunks(ctoks)} chunks), launches {cl}")

    # -- rgb ingest: K9's frame axis at the odd geometry -----------------------
    renv = dict(env, SIZEW=str(ODD_W), SIZEH=str(ODD_H))
    rframes = [np.ascontiguousarray(f[:ODD_H, :ODD_W])
               for f in gop_frames(RING_RGB_FRAMES, seed=7)]
    zero_counts(named)
    renc, _ = make_encoder(from_env(renv), ODD_W, ODD_H)
    rtoks, raus, _ = drive(renc, rframes)
    torch.cuda.synchronize()
    rl = path_launches(named)
    check(("cavlc", "rgb", 0) in renc._chunk_steps and rl["color_frames"] >= 1,
          f"the rgb ring did not run K9's frame axis: {rl}")
    rper = pinned_per_frame(renv, ODD_W, ODD_H, [token_qp(t) for t in rtoks])
    _, rpaus, _ = drive(rper, rframes, depth=2)
    check(raus == rpaus, "(b) rgb ring: the AUs differ from the per-frame "
          "path's")
    print(f"ring rgb ingest ({ODD_W}x{ODD_H}): {len(raus)} AUs byte-identical "
          f"to the per-frame path, launches {rl}")
    # K9's frame axis against its plain version on a 1080p chunk, exact
    rgbs = torch.from_numpy(np.stack(gop_frames(4, seed=8))).to(dev)
    ph, pw = enc.pad_h, enc.pad_w
    k_out = color.rgb_to_yuv420_frames(rgbs, ph, pw)
    p_out = color.rgb_to_yuv420_frames_plain(rgbs, ph, pw)
    check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
          "K9 frame axis differs from its plain version")
    k9_ms = cuda_ms(lambda: color.rgb_to_yuv420_frames(rgbs, ph, pw), reps=20)
    k9_plain = cuda_ms(lambda: color.rgb_to_yuv420_frames_plain(rgbs, ph, pw),
                       reps=3)
    k9_row = kernel_row("color_frames", "color.cu",
                        "models/h264.py:220 _stack_luma (and the ring's rgb "
                        "ingest, ops/devloop.py:306)", rl["color_frames"], 0.0,
                        k9_ms, k9_plain, nbytes(rgbs, *k_out))
    print(f"(a) ring: K9's frame axis equal to its plain version on 4 {W}x{H} "
          f"frames; {k9_ms:.3f} ms a chunk of 4")

    # -- the ring against the per-frame path, alternating timed runs ---------
    timed = gop_frames(RING_TIMED_FRAMES, seed=9)
    encs = {"per-frame": make_encoder(from_env(
        {"SIZEW": str(W), "SIZEH": str(H)}), W, H)[0],
        "ring": make_encoder(from_env(env), W, H)[0]}
    runs = {k: [] for k in encs}

    def timed_run(name):
        e = encs[name]
        e.request_keyframe()
        sub, pend = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f in timed:
            ts = time.perf_counter()
            pend.append(e.encode_submit(f))
            sub.append((time.perf_counter() - ts) * 1e3)
            while len(pend) >= e.pipeline_depth:
                e.encode_collect(pend.pop(0))
        while pend:
            e.encode_collect(pend.pop(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return {"fps": len(timed) / wall, "submit_p50_ms":
                statistics.median(sub[1:]), "submit_mean_ms":
                statistics.mean(sub[1:]), "submit_ms": sub}

    for name in encs:                        # warm: builds and graph captures
        timed_run(name)
    for name in ("per-frame", "ring", "ring", "per-frame") * 3:
        runs[name].append(timed_run(name))
    for name, rs in runs.items():
        print(f"{name} e2e ({encs[name].pipeline_depth} in flight, "
              f"{len(timed)} frames, IDR + {len(timed) - 1} P): frames/s "
              + ", ".join(f"{r['fps']:.2f}" for r in rs) + "; submit p50 ms "
              + ", ".join(f"{r['submit_p50_ms']:.2f}" for r in rs)
              + "; submit mean ms "
              + ", ".join(f"{r['submit_mean_ms']:.2f}" for r in rs))
    busy = {name: device_busy(encs[name], timed[1:17],
                              depth=encs[name].pipeline_depth)
            for name in ("per-frame", "ring")}
    gs_all = graph_stats(enc, cenc, renc, encs["ring"])
    print(f"ring graphs: {gs_all['captures']} captured, {gs_all['graphs']} "
          f"live, {gs_all['evicted']} evicted, pools "
          f"{gs_all['pool_bytes'] / 2**20:.1f} MiB in all (peak "
          f"{gs_all['peak_pool_bytes'] / 2**20:.1f}), {gs_all['replays']} "
          "replays")
    rep.update(timed={k: [{x: r[x] for x in ("fps", "submit_p50_ms",
                                              "submit_mean_ms")} for r in rs]
                      for k, rs in runs.items()},
               graphs_all=gs_all, replay_ms=g_ms, eager_body_ms=e_ms,
               cabac_launches=cl, rgb_launches=rl, device_busy=busy,
               graph_ms={"content_chunk": graph_ms(lambda: content_stats
                                                   .chunk_stats(e.ys, prev, 512,
                                                                e.refs[0], e.mvs,
                                                                resid)),
                         "color_frames": graph_ms(lambda: color
                                                  .rgb_to_yuv420_frames(
                                                      rgbs, ph, pw))})
    print("ring: device ms replayed from a captured graph: K4c "
          f"{rep['graph_ms']['content_chunk']:.3f}, K9 frame axis "
          f"{rep['graph_ms']['color_frames']:.3f}")
    for r in (g_row, c_row, k9_row):
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches)")
    dead_graph_capture(dev)
    return [g_row, c_row, k9_row]


class _Cycle:
    def __init__(self, payload):
        self.payload, self.me = payload, self


def dead_graph_capture(dev) -> None:
    """A capture through ``devloop.capture_graph`` survives the cycle
    collector's automatic runs while a dead graph (one held only by a
    reference cycle, as a dropped encoder's steps are) waits to be
    collected: destroying it mid-capture would invalidate the capture."""
    import gc

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    x = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    _Cycle(devloop.capture_graph(dev, lambda: x + 1)[:2])
    threshold = gc.get_threshold()
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 2:             # the capture, after the warm-up
            gc.set_threshold(1)
            try:
                for _ in range(1000):
                    _Cycle(None)
            finally:
                gc.set_threshold(*threshold)
        return x * 2

    g, out = devloop.capture_graph(dev, body)[:2]
    g.replay()
    torch.cuda.synchronize()
    check(torch.equal(out, x * 2), "the capture beside a dead graph differs")
    gc.collect()
    print("ring: a capture survived automatic collections with a dead graph "
          "waiting in a reference cycle")


def damage_frames(n: int, seed: int = 10):
    """A desktop whose cursor blinks every frame (MB row 41), with a
    terminal pane (MB rows 19-25) scrolling on frames 4-7 and the whole
    screen changing at frame 8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = desktop_base(rng)
    term = base[304:416, 960:1700].copy()
    frames = []
    for i in range(n):
        f = (255 - base) if i >= 8 else base.copy()
        if 4 <= i < 8:
            f[304:416, 960:1700] = np.roll(term, -18 * (i - 3), axis=0)
        if i % 2:                                                  # cursor
            f[658:670, 300:310] = 0 if f[658:670, 300:310].mean() > 127 else 255
        frames.append(f)
    return frames


def damage_phase(report):
    """DNGD_DAMAGE_MASK=true through make_encoder (the default
    configuration), per frame and in the ring: the masked AUs and
    references against the plain chain on the card, cv2's decode, the
    masked ring against the per-frame masked path at the ring's qps,
    K5r and K13 against their plain versions, and the masked P stage's
    device ms at 1, 8 and 68 damaged rows."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        bitmerge, cavlc_device, cavlc_p_device, damage_mask as dmg, devloop,
        h264_deblock, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    dev = torch.device("cuda")
    named = devloop.wrappers()
    frames = damage_frames(DAMAGE_FRAMES)
    env = {"SIZEW": str(W), "SIZEH": str(H)}
    renv = dict(env, ENCODER_SUPERSTEP_CHUNK="4")
    os.environ["DNGD_DAMAGE_MASK"] = "true"
    try:
        # -- main path: per frame, then in the ring ---------------------------
        zero_counts(named)
        enc, _ = make_encoder(from_env(env), W, H)
        check(enc.damage_mask and enc._ring_chunk == 0, "mask off")
        refs = []
        toks, aus, keys = drive(enc, frames, depth=2, on_submit=lambda e, t:
                                refs.append(tuple(p.clone() for p in e._ref)))
        renc, _ = make_encoder(from_env(renv), W, H)
        rtoks, raus, _ = drive(renc, frames)
        torch.cuda.synchronize()
        launches = path_launches(named)
        kinds = [t[0] for t in toks]
        buckets = [t[4][6].bucket if t[0] == "p_masked" else None
                   for t in toks]
        print(f"damage main: kinds {kinds}, buckets {buckets}, AU bytes "
              f"{[len(a) for a in aus]}; ring steps "
              f"{sorted(renc._chunk_steps)}, launches {launches}")
        check(kinds == ["intra"] + ["p_masked"] * 7 + ["p"]
              + ["p_masked"] * 3, f"kinds {kinds}")
        check(buckets[1:4] == [1, 1, 1] and buckets[4:8] == [8] * 4,
              f"buckets {buckets}")
        check(all(launches[k] >= 1 for k in ("inter_rows", "scatter_rows",
                                              "cavlc_p_slots", "pack_p",
                                              "deblock", "inter")),
              f"a kernel of the masked path never launched: {launches}")
        check(("cavlc", "yuv", 8) in renc._chunk_steps,
              f"no masked chunk: {sorted(renc._chunk_steps)}")
        # the masked ring against the per-frame masked path at its qps and
        # its worklists: a chunk shares its most damaged frame's bucket, and
        # one whose bucket covers the frame runs the full-frame chunk
        rper = pinned_per_frame(env, W, H, [token_qp(t) for t in rtoks])
        plans = [p for t, p in zip(rtoks, ring_plans(rtoks, enc.mb_h))
                 if t[0] == "ring"]
        it = iter(plans)
        rper._damage_plan = lambda y: next(it)
        _, rpaus, _ = drive(rper, frames, depth=2)
        check(raus == rpaus, "(b) masked ring: the AUs differ from the "
              "per-frame masked path's")
        print(f"(b) damage: the masked ring's {len(raus)} AUs byte-identical "
              "to the per-frame path at its qps and worklists (buckets "
              f"{[None if p is None else p.bucket for p in plans]})")
    finally:
        os.environ.pop("DNGD_DAMAGE_MASK", None)
    report["damage"] = {"kinds": kinds, "buckets": buckets,
                        "launches": launches,
                        "au_bytes": [len(a) for a in aus],
                        "ring_au_bytes": [len(a) for a in raus],
                        "ring_steps": [list(k) for k in renc._chunk_steps],
                        "graphs": graph_stats(renc)}

    # -- (b) the plain chain on the card, from the IDR's reference on --------
    t_b = time.perf_counter()
    ref = refs[0]
    for i in range(1, len(frames)):
        planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in enc._host_yuv420(frames[i])]
        tok = toks[i]
        if tok[0] == "p_masked":
            qp, fn, plan = tok[4][0], tok[4][1], tok[4][6]
            hv, hl = enc._p_hdr_slots_np(fn, qp - enc.qp)
            rows = torch.from_numpy(plan.padded).to(dev)
            hvr = torch.from_numpy(np.ascontiguousarray(hv[plan.padded])).to(dev)
            hlr = torch.from_numpy(np.ascontiguousarray(hl[plan.padded])).to(dev)
            out = h264_inter.encode_p_frame_rows_plain(*planes, *ref, rows, qp)
            nb = plan.bucket
        else:
            qp, fn = tok[4][0], tok[4][1]
            hvr, hlr = enc._p_hdr_slots(fn, qp - enc.qp)
            out = h264_inter.encode_p_frame_plain(*planes, *ref, qp)
            nb = enc.mb_h
        sl = cavlc_p_device.p_frame_slots_plain(out)
        flat = bitmerge.pack_p_frame_plain(*sl[:6], hvr, hlr).cpu().numpy()
        rec = h264_deblock.deblock_frame_plain(
            out["recon_y"], out["recon_cb"], out["recon_cr"], qp,
            nnz_blk=sl[6], mv=out["mv"])
        meta = cavlc_device.FlatMeta(flat, nb)
        if tok[0] == "p_masked":
            ref = dmg.scatter_rows_plain(*ref, *rec, rows)
            if meta.overflow:
                want = enc._masked_overflow(
                    {k: out[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc",
                                         "cr_ac")}, out["mv"], plan.padded,
                    qp, fn)
            else:
                want = dmg.assemble_masked_au(
                    flat, meta, plan.rows, enc.mb_h, enc.mb_w, frame_num=fn,
                    qp_delta=qp - enc.qp, deblocking_idc=enc._deblock_idc)
        else:
            ref = rec
            if meta.overflow:
                lv = {k: out[k].cpu().numpy() for k in (
                    "mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")}
                want = h264_entropy.encode_p_picture(
                    lv, frame_num=fn, qp_delta=qp - enc.qp,
                    deblocking_idc=enc._deblock_idc, qp_map=None, slice_qp=qp)
            else:
                want = cavlc_device.assemble_annexb(
                    flat, meta, nal_type=syn.NAL_SLICE, ref_idc=2)
        check(aus[i] == want, f"(b) damage frame {i} ({tok[0]}): AU differs "
              "from the plain chain")
        for name, a, b in zip(("y", "cb", "cr"), refs[i], ref):
            check(torch.equal(a, b), f"(b) damage frame {i}: {name} "
                  "reference differs from the plain chain")
    print(f"(b) damage: {len(aus) - 1} P access units and references equal to "
          f"the plain chain on the card ({time.perf_counter() - t_b:.0f} s)")

    # -- (c) cv2 decodes the masked stream to the references ------------------
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("(c) damage cv2 decode: not run (no cv2 on this machine)")
        report["damage"]["cv2_decode"] = "not run"
    else:
        path = os.path.join(HERE, "chiprun_out", "damage.264")
        with open(path, "wb") as f:
            f.write(b"".join(aus))
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        for i, r in enumerate(refs):
            ok, img = cap.read()
            check(ok, f"(c) cv2 stopped decoding the masked stream at {i}")
            check(np.array_equal(np.asarray(img).reshape(H, W),
                                 r[0][:H, :W].cpu().numpy()),
                  f"(c) masked frame {i}: decoded luma differs from the "
                  "reference")
        cap.release()
        with open(path, "wb") as f:
            f.write(b"".join(raus))
        cap = cv2.VideoCapture(path)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        os.remove(path)
        check(n == len(raus), f"(c) cv2 decoded {n} of the masked ring's "
              f"{len(raus)} frames")
        print(f"(c) damage cv2 decode: ran; {len(refs)} decoded luma planes "
              "equal to the encoder's references; the masked ring's "
              f"{n} frames decoded")
        report["damage"]["cv2_decode"] = "ran"

    # -- (a) K5r and K13 against their plain versions, and the masked stage --
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in enc._host_yuv420(frames[4])]
    ref = refs[3]
    qp, fn, plan8 = toks[4][4][0], toks[4][4][1], toks[4][4][6]
    hv, hl = enc._p_hdr_slots_np(fn, qp - enc.qp)
    rows8 = torch.from_numpy(plan8.padded).to(dev)
    o_k = h264_inter.encode_p_frame_rows(*planes, *ref, rows8, qp)
    o_p = h264_inter.encode_p_frame_rows_plain(*planes, *ref, rows8, qp)
    torch.cuda.synchronize()
    for k in o_p:
        check(torch.equal(o_k[k], o_p[k]), f"K5r: {k} differs")
    rec = (o_k["recon_y"], o_k["recon_cb"], o_k["recon_cr"])
    s_k = dmg.scatter_rows(*ref, *rec, rows8)
    s_p = dmg.scatter_rows_plain(*ref, *rec, rows8)
    for a, b in zip(s_k, s_p):
        check(torch.equal(a, b), "K13 differs")
    print(f"(a) damage: K5r and K13 equal to their plain versions on the "
          f"{plan8.bucket}-row worklist {plan8.padded.tolist()} (qp {qp})")
    nb = plan8.bucket
    r5_ms = cuda_ms(lambda: h264_inter.encode_p_frame_rows(*planes, *ref,
                                                           rows8, qp), reps=20)
    r5_plain = cuda_ms(lambda: h264_inter.encode_p_frame_rows_plain(
        *planes, *ref, rows8, qp), reps=3)
    frac = nb / enc.mb_h
    r5_row = kernel_row("inter_rows", "inter.cu",
                        "damage_mask.py:170 row_core (its P core over the "
                        "worklist)", launches["inter_rows"], 0.0, r5_ms,
                        r5_plain, frac * nbytes(*planes, *ref)
                        + nbytes(rows8, *o_k.values()),
                        k5_ops(nb * enc.mb_w))
    s_ms = cuda_ms(lambda: dmg.scatter_rows(*ref, *rec, rows8), reps=20)
    s_plain = cuda_ms(lambda: dmg.scatter_rows_plain(*ref, *rec, rows8),
                      reps=3)
    s_row = kernel_row("scatter_rows", "damage.cu",
                       "damage_mask.py:228 row_core's reference-row scatter",
                       launches["scatter_rows"], 0.0, s_ms, s_plain,
                       2 * nbytes(*s_k) + nbytes(rows8))
    # the library yardstick: torch.index_copy, one call a plane
    idx8 = rows8.long()
    s_row["library_ms"] = cuda_ms(lambda: [
        torch.index_copy(p.view(enc.mb_h, n, -1), 0, idx8, r.view(nb, n, -1))
        for p, r, n in zip(ref, rec, (16, 8, 8))], reps=20)
    # the masked P stage (K5r, K6, K7, K8, K13) at 1 and 8 rows; 68 rows is
    # the full-frame stage (K5, K6, K7, K8), which a fully damaged frame runs
    stage, stage_g = {}, {}
    for b, r in ((1, toks[1][4][6]), (nb, plan8)):
        rt = torch.from_numpy(r.padded).to(dev)
        hvr = torch.from_numpy(np.ascontiguousarray(hv[r.padded])).to(dev)
        hlr = torch.from_numpy(np.ascontiguousarray(hl[r.padded])).to(dev)

        def masked_stage():
            dmg.row_core(*planes, *ref, rt, hvr, hlr, qp, deblock=True)

        stage[b] = cuda_ms(masked_stage, reps=20)
        stage_g[b] = graph_ms(masked_stage)
    hvf, hlf = enc._p_hdr_slots(fn, qp - enc.qp)

    def full_stage():
        st = cavlc_p_device.encode_p_cavlc_frame(*planes, *ref, hvf, hlf, qp)
        h264_deblock.deblock_frame(*st[1:4], qp, nnz_blk=st[5], mv=st[4])

    stage[enc.mb_h] = cuda_ms(full_stage, reps=20)
    stage_g[enc.mb_h] = graph_ms(full_stage)
    print("damage: masked P stage ms (CUDA events, median of 20), eager call "
          "/ replay of its captured graph: " + ", ".join(
              f"{b} rows {stage[b]:.3f} / {stage_g[b]:.3f}" for b in stage))
    report["damage"].update(stage_ms={str(b): ms for b, ms in stage.items()},
                            stage_graph_ms={str(b): ms
                                            for b, ms in stage_g.items()})
    k_g = {"inter_rows": graph_ms(lambda: h264_inter.encode_p_frame_rows(
        *planes, *ref, rows8, qp)),
        "scatter_rows": graph_ms(lambda: dmg.scatter_rows(*ref, *rec, rows8))}
    report["damage"]["graph_ms"] = k_g
    print(f"damage: device ms replayed from a captured graph: K5r "
          f"{k_g['inter_rows']:.3f}, K13 {k_g['scatter_rows']:.3f}")
    mask_serving_cost(report["damage"], planes[0].cpu().numpy(),
                      ref[0].cpu().numpy())
    for r in (r5_row, s_row):
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches)")
    print(f"library: torch.index_copy of the three planes (K13's function) "
          f"{s_row['library_ms']:.3f} ms")
    return [r5_row, s_row]


def mask_serving_cost(rep, y, prev_y):
    """What the mask costs a session to serve: the host damage grid's ms
    on two 1080p luma planes, then masked and unmasked sessions, per
    frame and in the ring, over three passes of the damage desktop (its
    buckets 1, 8 and the full frame, and a full change where a pass
    wraps): submit p50 and max and frames/s of two timed passes in
    alternating order after a first pass (graph captures), and each ring
    session's graph budget over its life (peak pool bytes).  First, a
    masked ring under a budget of two graphs against one under the
    default: evictions and recaptures leave the bytes as they were."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    grid_ms = []
    for _ in range(21):
        t = time.perf_counter()
        dmg.damage_grid_np(y, prev_y, 512)
        grid_ms.append((time.perf_counter() - t) * 1e3)
    frames = damage_frames(DAMAGE_FRAMES) * 3

    def make(chunk, mask):
        os.environ["DNGD_DAMAGE_MASK"] = mask
        try:
            e = make_encoder(from_env({
                "SIZEW": str(W), "SIZEH": str(H),
                "ENCODER_SUPERSTEP_CHUNK": chunk}), W, H)[0]
        finally:
            os.environ.pop("DNGD_DAMAGE_MASK", None)
        check(e.damage_mask == (mask == "true"), "mask switch ignored")
        return e

    # a masked ring held to two graph instances evicts idle buckets' graphs
    # and captures them again: the same bytes as the default budget's
    small, full = make("4", "true"), make("4", "true")
    small._graphs.limit = 2
    aus_small, aus_full = drive(small, frames)[1], drive(full, frames)[1]
    gs_small = graph_stats(small)
    check(gs_small["evicted"] >= 1 and aus_small == aus_full,
          f"a masked ring under a two-graph budget: {gs_small}, AUs equal "
          f"{aus_small == aus_full}")
    print(f"damage: a masked ring held to 2 graphs evicted "
          f"{gs_small['evicted']} and captured {gs_small['captures']} over "
          f"{len(frames)} frames, its AUs equal to the default budget's "
          f"({graph_stats(full)['captures']} captures)")
    rep["budget_of_two"] = gs_small
    del small, full
    encs = {}
    for chunk in ("0", "4"):
        for mask in ("false", "true"):
            encs[("ring" if chunk == "4" else "per-frame")
                 + (" masked" if mask == "true" else "")] = make(chunk, mask)

    def one_pass(e):
        e.request_keyframe()
        sub, pend = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f in frames:
            ts = time.perf_counter()
            pend.append(e.encode_submit(f))
            sub.append((time.perf_counter() - ts) * 1e3)
            while len(pend) >= e.pipeline_depth:
                e.encode_collect(pend.pop(0))
        while pend:
            e.encode_collect(pend.pop(0))
        torch.cuda.synchronize()
        return len(frames) / (time.perf_counter() - t), sub[1:]

    first = {k: one_pass(e) for k, e in encs.items()}
    timed = {k: [] for k in encs}
    for order in (list(encs), list(encs)[::-1]):
        for k in order:
            timed[k].append(one_pass(encs[k]))
    out = {"grid_ms_p50": statistics.median(grid_ms),
           "frames": len(frames)}
    for k, e in encs.items():
        sub = [m for _, ms in timed[k] for m in ms]
        out[k] = {"fps": [f for f, _ in timed[k]],
                  "submit_p50_ms": statistics.median(sub),
                  "submit_max_ms": max(sub),
                  "first_pass_submit_max_ms": max(first[k][1]),
                  "graphs": graph_stats(e)}
        g = out[k]["graphs"]
        print(f"damage serving, {k} ({e.pipeline_depth} in flight, "
              f"{len(frames)} frames a pass): frames/s "
              + ", ".join(f"{f:.2f}" for f in out[k]["fps"])
              + f"; submit p50 {out[k]['submit_p50_ms']:.2f} ms, max "
              f"{out[k]['submit_max_ms']:.2f} ms (first pass "
              f"{out[k]['first_pass_submit_max_ms']:.2f}); graphs "
              f"{g['captures']} captured, {g['evicted']} evicted, pools peak "
              f"{g['peak_pool_bytes'] / 2**20:.1f} MiB")
    print(f"damage serving: host damage grid {out['grid_ms_p50']:.3f} ms a "
          f"{W}x{H} frame (median of 21)")
    rep["serving"] = out


TUNE_MASK_ROWS = (1, 8, 64)  # worklists the new forms are held and timed at


def tune_mask_frames(n: int):
    """The damage desktop with a new flat panel on frames 5 (in the
    scrolling pane, MB rows 20-24) and 10 (MB row 41), content motion
    estimation cannot track (where I16-in-P fires); the damaged rows and
    the buckets stay the damage phase's."""
    frames = damage_frames(n)
    frames[5][320:400, 1000:1400] = (140, 150, 160)
    frames[10][656:672, 400:800] = (90, 200, 60)
    return frames


def worklist_64(nr: int):
    """64 distinct MB rows in a scattered order, the last a padded copy
    of the first."""
    import numpy as np

    rows = np.array([(7 * i) % nr for i in range(64)], np.int32)
    rows[-1] = rows[0]
    return rows


def i16_pass_ms(fn, reps: int = 20) -> float:
    """Median device ms of the I16-in-P launches inside ``fn()``:
    CUDA events recorded on the stream just before and after the passes'
    host call, one sample per call."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter

    orig, marks = h264_inter._i16_passes, []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        orig(*a, **k)
        ev[1].record()
        marks.append(ev)

    h264_inter._i16_passes = timed
    try:
        fn()
        marks.clear()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        h264_inter._i16_passes = orig
    check(len(marks) == reps, "the I16-in-P passes did not run")
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def tune_mask_phase(report):
    """The damage phase's tune-mask part: DNGD_DAMAGE_MASK=true with
    ENCODER_TUNE=hq at 1080p, the served tier (make_encoder: hq_noaq under
    the loop filter) and the full tier (``H264Encoder(..., deblock=False,
    tune="hq")``: K14r, I16-in-P over the worklist), per frame and in the
    ring; the masked AUs and references against the plain chain on the
    card, cv2's decode, each ring against the per-frame path with the
    chunk's lookahead at its qps, the masked spatial step at nx = 2 against
    the unsharded masked path, the new forms (K5r tiers 1 and 2 with and
    without I16-in-P, K14r with and without next_y) against their plain
    versions at 1, 8 and 64 rows, and the masked stage's device ms per
    tier."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder, make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, bitmerge, cavlc_device, cavlc_p_device, damage_mask as dmg, devloop,
        h264_deblock, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.parallel.batch import indexed_device
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["tune_mask"] = {}
    named = devloop.wrappers()
    frames = tune_mask_frames(DAMAGE_FRAMES)
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_TUNE": "hq"}
    full_kw = dict(mode="cavlc", entropy="device", deblock=False, tune="hq",
                   gop=60, bitrate_kbps=8000, host_color=True,
                   damage_mask=True)

    def make(tier, chunk=0, pinned=False):
        if tier == "served":
            e = dict(env, ENCODER_SUPERSTEP_CHUNK=str(chunk))
            if pinned:
                e["ENCODER_BITRATE_KBPS"] = "0"
            enc = make_encoder(from_env(e), W, H)[0]
        else:
            enc = H264Encoder(W, H, superstep_chunk=chunk,
                              **dict(full_kw, bitrate_kbps=0 if pinned
                                     else full_kw["bitrate_kbps"]))
        check(enc.damage_mask and enc._ring_chunk == chunk,
              f"{tier}: mask or ring not set up")
        check((enc._ktune, enc._p_intra, enc.deblock) == (
            ("hq_noaq", False, True) if tier == "served" else ("hq", True, False)),
            f"{tier}: tier {enc._ktune} p_intra {enc._p_intra}")
        return enc

    # -- main path, per tier: per frame, then in the ring ------------------------
    runs, windows = {}, {}
    os.environ["DNGD_DAMAGE_MASK"] = "true"
    try:
        for tier in ("served", "full"):
            zero_counts(named)
            enc = make(tier)
            refs, intra = [], []

            def on_submit(e, tok, refs=refs, intra=intra):
                refs.append(tuple(p.clone() for p in e._ref))
                if tok[0] == "p_masked" and "mb_intra" in tok[4][2]:
                    intra.append(int(tok[4][2]["mb_intra"].sum()))

            toks, aus, keys = drive(enc, frames, depth=2, on_submit=on_submit)
            ring = make(tier, chunk=4)
            rtoks, raus, _ = drive(ring, frames)
            torch.cuda.synchronize()
            windows[tier] = path_launches(named)
            runs[tier] = dict(enc=enc, toks=toks, aus=aus, refs=refs,
                              intra=intra, ring=ring, rtoks=rtoks, raus=raus)
        # the masked spatial step at nx = 2 (shard devices repeating the card)
        zero_counts(named)
        sp = {}
        sdev = [indexed_device(dev)] * 2
        for tier in ("served", "full"):
            if tier == "served":
                e = dict(env, ENCODER_SPATIAL_SHARDS="2")
                senc = make_encoder(from_env(e), W, H, spatial_devices=sdev)[0]
            else:
                senc = H264Encoder(W, H, spatial_shards=2, spatial_devices=sdev,
                                   **full_kw)
            check(senc._spatial_nx == 2, f"spatial {tier}: not sharded")
            sp[tier] = drive(senc, frames)[1]
        torch.cuda.synchronize()
        windows["spatial"] = path_launches(named)
    finally:
        os.environ.pop("DNGD_DAMAGE_MASK", None)

    want_kinds = ["intra"] + ["p_masked"] * 7 + ["p"] + ["p_masked"] * 3
    for tier, r in runs.items():
        kinds = [t[0] for t in r["toks"]]
        buckets = [t[4][6].bucket if t[0] == "p_masked" else None
                   for t in r["toks"]]
        check(kinds == want_kinds, f"tune-mask {tier}: kinds {kinds}")
        check(buckets[1:4] == [1, 1, 1] and buckets[4:8] == [8] * 4,
              f"tune-mask {tier}: buckets {buckets}")
        check(dispatched_chunks(r["rtoks"]) == 2 and any(
            k[2] > 0 for k in r["ring"]._chunk_steps),
            f"tune-mask {tier}: no masked chunk replayed "
            f"{sorted(r['ring']._chunk_steps)}")
        r.update(kinds=kinds, buckets=buckets)
        print(f"tune-mask {tier} main: kinds {kinds}, buckets {buckets}, AU "
              f"bytes {[len(a) for a in r['aus']]}; ring steps "
              f"{sorted(r['ring']._chunk_steps)}; launches {windows[tier]}")
    ws, wf, wsp = windows["served"], windows["full"], windows["spatial"]
    for k in ("inter_rows_hq", "scatter_rows", "cavlc_p_slots", "pack_p",
              "deblock"):
        check(ws[k] >= 1, f"tune-mask served: {k} never launched: {ws}")
    check(ws["qp_plane_rows"] == ws["inter_rows_i16"] == ws["inter_rows"] == 0,
          f"tune-mask served ran another tier's kernels: {ws}")
    for k in ("inter_rows_hq", "inter_rows_i16", "qp_plane_rows", "scatter_rows",
              "cavlc_p_chain", "pack_p_hq"):
        check(wf[k] >= 1, f"tune-mask full: {k} never launched: {wf}")
    check(wf["inter_rows"] == 0 and wf["inter"] == 0 and wf["deblock"] == 0,
          f"tune-mask full ran a tune=off core or the loop filter: {wf}")
    check(wsp["force_skip"] >= 1 and wsp["inter_padded"] >= 1,
          f"tune-mask spatial: the row gate never ran: {wsp}")
    check(sum(runs["full"]["intra"]) > 0,
          f"tune-mask full: no I16-in-P MB in a masked frame {runs['full']['intra']}")
    print(f"tune-mask full: I16-in-P MBs a masked frame {runs['full']['intra']}")

    # -- (b) each ring against the per-frame path with the chunk's lookahead ------
    for tier, r in runs.items():
        rqps = [token_qp(t) for t in r["rtoks"]]
        os.environ["DNGD_DAMAGE_MASK"] = "true"
        try:
            twin = flush_twin(make(tier, chunk=4, pinned=True),
                              ring_plans(r["rtoks"], r["enc"].mb_h))
            twin._eff_qp = lambda keyframe=True, twin=twin, rqps=rqps: \
                rqps[twin.frame_index - 1]
            taus = drive(twin, frames)[1]
        finally:
            os.environ.pop("DNGD_DAMAGE_MASK", None)
        check(r["raus"] == taus, f"(b) tune-mask {tier} ring: the AUs differ "
              "from the per-frame masked path at the ring's qps")
        r["ring_graphs"] = graph_stats(r["ring"])
        print(f"(b) tune-mask {tier} ring: {len(taus)} AUs equal to the per-frame "
              f"masked path with the chunk's lookahead at its qps {rqps}; graphs "
              f"{r['ring_graphs']['captures']} captured, pools peak "
              f"{r['ring_graphs']['peak_pool_bytes'] / 2**20:.1f} MiB")
    # the masked spatial step against the unsharded masked path
    for tier in ("served", "full"):
        check(sp[tier] == runs[tier]["aus"], f"(b) tune-mask spatial {tier}: the "
              "nx=2 masked stream differs from the unsharded masked path's")
    print("(b) tune-mask spatial: the nx=2 masked streams of both tiers equal to "
          "the unsharded masked path's")

    # -- (b) every masked P frame against the plain chain on the card --------------
    t_b = time.perf_counter()
    n_checked = 0
    for tier, r in runs.items():
        enc = r["enc"]
        for i in range(1, len(frames)):
            tok = r["toks"][i]
            if tok[0] != "p_masked":
                continue                  # the full frame: the tune phase's
            ref = r["refs"][i - 1]
            planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                      for p in enc._host_yuv420(frames[i])]
            qp, fn, plan = tok[4][0], tok[4][1], tok[4][6]
            hv, hl = enc._p_hdr_slots_np(fn, qp - enc.qp)
            rows = torch.from_numpy(plan.padded).to(dev)
            hvr = torch.from_numpy(np.ascontiguousarray(hv[plan.padded])).to(dev)
            hlr = torch.from_numpy(np.ascontiguousarray(hl[plan.padded])).to(dev)
            qm = (aq.qp_plane_plain(planes[0], qp, None, rows)
                  if enc._ktune == "hq" else None)
            out = h264_inter.encode_p_frame_rows_plain(
                *planes, *ref, rows, qp, enc._ktune, qm, enc._p_intra)
            sl = cavlc_p_device.p_frame_slots_plain(out, qp)
            flat = bitmerge.pack_p_frame_plain(
                *sl[:6], hvr, hlr, qp_sum=sl[7] if len(sl) > 7 else None
            ).cpu().numpy()
            rec = (out["recon_y"], out["recon_cb"], out["recon_cr"])
            if enc.deblock:
                rec = h264_deblock.deblock_frame_plain(*rec, qp, nnz_blk=sl[6],
                                                       mv=out["mv"])
            new = dmg.scatter_rows_plain(*ref, *rec, rows)
            meta = cavlc_device.FlatMeta(flat, plan.bucket)
            if meta.overflow:
                want = enc._masked_overflow(
                    {k: v for k, v in out.items() if not k.startswith("recon")
                     and k != "mv"}, out["mv"], plan.padded, qp, fn)
            else:
                want = dmg.assemble_masked_au(
                    flat, meta, plan.rows, enc.mb_h, enc.mb_w, frame_num=fn,
                    qp_delta=qp - enc.qp, deblocking_idc=enc._deblock_idc)
            check(r["aus"][i] == want, f"(b) tune-mask {tier} frame {i}: AU "
                  "differs from the plain chain")
            for name, a, b in zip(("y", "cb", "cr"), r["refs"][i], new):
                check(torch.equal(a, b), f"(b) tune-mask {tier} frame {i}: {name} "
                      "reference differs from the plain chain")
            n_checked += 1
    print(f"(b) tune-mask: {n_checked} masked P access units and references of "
          f"both tiers equal to the plain chain on the card "
          f"({time.perf_counter() - t_b:.0f} s)")

    # -- (c) cv2 decodes both tiers' masked streams to their references ------------
    for tier, r in runs.items():
        r["cv2"] = cv2_luma_check(f"tune_mask_{tier}", r["aus"], r["refs"])

    # -- (a) the new forms against their plain versions at 1, 8 and 64 rows --------
    fenc = runs["full"]["enc"]
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in fenc._host_yuv420(frames[5])]
    nxt = torch.from_numpy(np.ascontiguousarray(
        fenc._host_yuv420(frames[6])[0])).to(dev)
    ref = runs["full"]["refs"][4]
    qp = runs["full"]["toks"][5][4][0]
    plan8 = runs["full"]["toks"][5][4][6]
    lists = {1: np.array([41], np.int32), 8: plan8.padded,
             64: worklist_64(fenc.mb_h)}
    check(len(lists[8]) == 8, f"the 8-row worklist is {lists[8]}")
    forms = (("hq_noaq", False), ("hq_noaq", True), ("hq", False), ("hq", True))
    fired, worst = 0, 0.0
    for b, rl in lists.items():
        rt = torch.from_numpy(rl).to(dev)
        for ny in (None, nxt):
            got = aq.qp_plane(planes[0], qp, ny, rows=rt)
            want = aq.qp_plane_plain(planes[0], qp, ny, rt)
            check(torch.equal(got, want), f"K14r differs at {b} rows "
                  f"(next_y {ny is not None})")
        for tune, pi in forms:
            ny = nxt if tune == "hq" else None
            o_k = h264_inter.encode_p_frame_rows(*planes, *ref, rt, qp, tune=tune,
                                                 next_y=ny, p_intra=pi)
            qm = aq.qp_plane_plain(planes[0], qp, ny, rt) if tune == "hq" else None
            o_p = h264_inter.encode_p_frame_rows_plain(*planes, *ref, rt, qp, tune,
                                                       qm, pi)
            check(set(o_k) == set(o_p), f"K5r {tune} {pi}: keys {set(o_k)}")
            worst = max(worst, max_diff((o_k[k], o_p[k]) for k in o_p))
            for k in o_p:
                check(torch.equal(o_k[k], o_p[k]), f"K5r {tune} p_intra {pi} at "
                      f"{b} rows: {k} differs")
            if pi:
                fired += int(o_k["mb_intra"].sum())
    check(fired > 0, "K5r: no I16-in-P MB in the checks")
    print(f"(a) tune-mask: K5r tiers 1 and 2, with and without I16-in-P ({fired} "
          f"I16-in-P MBs), and K14r with and without next_y equal to their plain "
          f"versions at {list(lists)} rows (qp {qp}; the 64-row worklist "
          "unsorted with a padded copy)")

    # -- the masked stage's device ms per tier at 1, 8 and 64 rows ----------------
    hv, hl = fenc._p_hdr_slots_np(runs["full"]["toks"][5][4][1], qp - fenc.qp)
    stages = {"off": ("off", False, True), "hq_noaq": ("hq_noaq", False, True),
              "hq": ("hq", True, False)}
    stage, stage_g = {}, {}
    for b, rl in lists.items():
        rt = torch.from_numpy(rl).to(dev)
        hvr = torch.from_numpy(np.ascontiguousarray(hv[rl])).to(dev)
        hlr = torch.from_numpy(np.ascontiguousarray(hl[rl])).to(dev)
        for name, (tune, pi, db) in stages.items():
            ny = nxt if tune == "hq" else None

            def masked_stage(tune=tune, pi=pi, db=db, ny=ny):
                dmg.row_core(*planes, *ref, rt, hvr, hlr, qp, tune=tune,
                             next_y=ny, p_intra=pi, deblock=db)

            stage[f"{name}/{b}"] = cuda_ms(masked_stage, reps=20)
            stage_g[f"{name}/{b}"] = graph_ms(masked_stage)
    print("tune-mask: masked P stage ms (CUDA events, median of 20), eager call / "
          "replay of its captured graph, by tier (off, hq_noaq deblocked; hq with "
          "I16-in-P, no deblock) at " + f"{list(lists)} rows: " + "; ".join(
              f"{k} {stage[k]:.3f} / {stage_g[k]:.3f}" for k in stage))

    # -- the kernels line's rows (8 rows; launches from the tiers' windows) --------
    nb, nc = 8, fenc.mb_w
    rt8 = torch.from_numpy(lists[8]).to(dev)
    frac = nb / fenc.mb_h
    in_bytes = frac * nbytes(*planes, *ref) + nbytes(rt8)
    specs = (
        ("inter_rows_hq_noaq", "hq_noaq", False, ws["inter_rows_hq"]),
        ("inter_rows_hq_noaq_i16", "hq_noaq", True, 0),
        ("inter_rows_hq", "hq", False, 0),
        ("inter_rows_hq_i16", "hq", True, wf["inter_rows_i16"]),
    )
    out_rows = []
    for name, tune, pi, n in specs:
        ny = nxt if tune == "hq" else None
        fk = lambda tune=tune, pi=pi, ny=ny: h264_inter.encode_p_frame_rows(
            *planes, *ref, rt8, qp, tune=tune, next_y=ny, p_intra=pi)
        o = fk()
        qm = aq.qp_plane_plain(planes[0], qp, ny, rt8) if tune == "hq" else None
        fp = lambda tune=tune, pi=pi, qm=qm: h264_inter.encode_p_frame_rows_plain(
            *planes, *ref, rt8, qp, tune, qm, pi)
        err = max_diff((o[k], v) for k, v in fp().items())
        check(err == 0, f"{name}: max |kernel - plain| {err} at 8 rows")
        extra = frac * nbytes(ny) if ny is not None else 0
        out_rows.append(kernel_row(
            name, "inter.cu", f"damage_mask.py:170 row_core (tune={tune}"
            + (", p_intra: h264_inter.py:688-782" if pi else "") + ")", n, err,
            cuda_ms(fk, reps=20), cuda_ms(fp, reps=3),
            in_bytes + extra + nbytes(*o.values()), k5_hq_ops(nb * nc, pi)))
    # the I16-in-P launches alone over the worklist: their host call by
    # CUDA events, their kernels by device time
    fk = lambda: h264_inter.encode_p_frame_rows(
        *planes, *ref, rt8, qp, tune="hq", next_y=nxt, p_intra=True)
    i16_ms = i16_pass_ms(fk)
    split = kernel_split(fk)
    o = fk()
    qm8 = aq.qp_plane_plain(planes[0], qp, nxt, rt8)
    fp = lambda: h264_inter.encode_p_frame_rows_plain(
        *planes, *ref, rt8, qp, "hq", qm8, True)
    # the passes write the I16 keys and merge into every other output
    err = max_diff((o[k], v) for k, v in fp().items())
    check(err == 0, f"inter_rows_i16: max |kernel - plain| {err} at 8 rows")
    i16_row = kernel_row(
        "inter_rows_i16", "inter.cu", "h264_inter.py:688-782 I16-in-P in "
        "damage_mask.py:170 row_core (the want and the gate and merge "
        "launches over the worklist)",
        wf["inter_rows_i16"], err, i16_ms, cuda_ms(fp, reps=3),
        i16_bytes(planes, o, rt8) + nbytes(rt8),
        I16_CAND_OPS * (nb * nc + float(o["mb_intra"].sum())))
    i16_row["device_ms"] = (sum(v for k, v in split.items() if "i16" in k)
                            if split else None)
    check(i16_row["device_ms"] is None or i16_row["device_ms"] >= i16_row["bound_ms"],
          f"inter_rows_i16: device time {i16_row['device_ms']} ms under its bound")
    out_rows.append(i16_row)
    k14 = lambda: aq.qp_plane(planes[0], qp, nxt, rows=rt8)
    k14p = lambda: aq.qp_plane_plain(planes[0], qp, nxt, rt8)
    err = max_diff([(k14(), k14p())])
    check(err == 0, f"qp_plane_rows: max |kernel - plain| {err} at 8 rows")
    out_rows.append(kernel_row(
        "qp_plane_rows", "aq.cu", "aq.py:115 qp_plane per row band in "
        "damage_mask.py:170 row_core", wf["qp_plane_rows"], err,
        cuda_ms(k14, reps=20), cuda_ms(k14p, reps=3),
        2 * frac * nbytes(planes[0]) + nbytes(rt8, k14())))
    k_g = {"K5r hq_noaq": graph_ms(lambda: h264_inter.encode_p_frame_rows(
        *planes, *ref, rt8, qp, tune="hq_noaq")),
        "K5r hq + I16-in-P": graph_ms(lambda: h264_inter.encode_p_frame_rows(
            *planes, *ref, rt8, qp, tune="hq", next_y=nxt, p_intra=True)),
        "K14r": graph_ms(k14)}
    print("tune-mask: device ms replayed from a captured graph at 8 rows: "
          + ", ".join(f"{k} {v:.3f}" for k, v in k_g.items()))
    for r in out_rows:
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches"
              + ("; no caller reaches it)" if r["launches"] == 0 else ")"))
    rep.update(
        windows=windows, stage_ms=stage, stage_graph_ms=stage_g, graph_ms=k_g,
        i16_ms=i16_ms, max_abs_err=worst,
        tiers={t: {"kinds": r["kinds"], "buckets": r["buckets"],
                   "mb_intra": r["intra"], "au_bytes": [len(a) for a in r["aus"]],
                   "ring_au_bytes": [len(a) for a in r["raus"]],
                   "ring_graphs": r["ring_graphs"], "cv2": r["cv2"]}
               for t, r in runs.items()},
        phase_s=time.perf_counter() - t_phase)
    print(f"tune-mask part: {rep['phase_s']:.1f} s")
    return out_rows


def cv2_luma_check(name: str, aus, refs) -> str:
    """cv2's decoded luma of ``aus`` against each reference's (frame for
    frame); "not run" without cv2."""
    import numpy as np

    try:
        import cv2
    except ImportError:
        print(f"(c) {name}: cv2 decode not run (no cv2 on this machine)")
        return "not run"
    path = os.path.join(HERE, "chiprun_out", f"{name}.264")
    with open(path, "wb") as f:
        f.write(b"".join(aus))
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, r in enumerate(refs):
        ok, img = cap.read()
        check(ok, f"(c) {name}: cv2 stopped at frame {i}")
        check(np.array_equal(np.asarray(img).reshape(H, W),
                             r[0][:H, :W].cpu().numpy()),
              f"(c) {name}: frame {i} decodes differently")
    cap.release()
    os.remove(path)
    print(f"(c) {name}: cv2 decoded {len(refs)} frames to the references")
    return "ran"


def tune_frames(n: int, seed: int = 3):
    """Tune phase: the GOP phase's desktop, and from frame 2 every third
    frame a new flat panel over the scrolling text, content motion
    estimation cannot track (where I16-in-P fires)."""
    frames = gop_frames(n, seed=seed)
    for i in range(2, n, 3):
        frames[i][220:420, 940:1300] = (140 + 8 * i, 150, 160)
    return frames


# an MB's I16-in-P candidate: 24 blocks x 256 (as the residual), its SSD
# and bit estimates and the gate
I16_CAND_OPS = 24 * 256 + 384 * 3 + 384 * 4 + 8


def k5_hq_ops(nmb: int, p_intra: bool) -> float:
    """K5's operations under tune=hq: ``k5_ops`` plus, per MB, the forced
    skip's coded and skip SSDs (384 pels x 3 each) and bit estimates (384
    levels x 4), and under I16-in-P the intra candidate (24 blocks x 256,
    as the residual), its SSD and bit estimates and the gate."""
    extra = 2 * 384 * 3 + 384 * 4
    if p_intra:
        extra += I16_CAND_OPS
    return k5_ops(nmb) + float(extra * nmb)


def flush_twin(enc, plans=None):
    """Make ``enc`` (a ring encoder) push each full chunk through its
    per-frame flush instead of the graph: the per-frame path with the
    chunk's lookahead shift, for the full tier's ring comparison.
    ``plans`` (one per frame index; masked rings): the worklists a
    dispatched chunk's frames take in place of their own, None where the
    chunk ran the full frame."""
    pos = [1]                                   # frame 0 is the IDR

    def dispatch(ring):
        if plans is not None:
            ring.plans = plans[pos[0]:pos[0] + len(ring.frames)]
            pos[0] += len(ring.frames)
        enc._ring = ring
        enc._ring_flush()
    enc._ring_dispatch = dispatch
    return enc


def ring_plans(toks, mb_h: int) -> list:
    """Each frame's worklist as a masked ring ran it (by frame index): a
    dispatched chunk's shared bucket, None where the chunk ran the full
    frame (or for a frame outside the ring), a flushed frame's own."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg

    plans = []
    for t in toks:
        if t[0] != "ring":
            plans.append(None)
            continue
        ring, slot = t[4]
        p = ring.plans[slot] if ring.plans else None
        if ring.res is not None:
            p = None if ring.dmg is None else dmg.RowPlan(
                p.rows, ring.dmg[1][slot], ring.dmg[0], mb_h, p.frac)
        plans.append(p)
    return plans


def tune_phase(report, rows_before):
    """ENCODER_TUNE=hq: the full tier (deblock off: K14, K1/K2/K3/K5/K6/K7/
    K4 hq forms, I16-in-P) and the served tier (make_encoder: hq_noaq
    under the loop filter), per frame, in the ring and (served) on both
    CABAC routes; kernels against their plain versions at 1080p, AUs
    against the plain path, cv2's decode; times against tune=off."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder, make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, bitmerge, cavlc_device, cavlc_p_device, color, content_stats, devloop,
        h264_deblock, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    rep = report["tune"] = {}
    t_phase = time.perf_counter()
    frames = tune_frames(TUNE_FRAMES)
    full_kw = dict(mode="cavlc", entropy="device", deblock=False, tune="hq",
                   gop=60, bitrate_kbps=8000)
    named = dict(devloop.wrappers(),
                 intra_hq=h264_device.encode_intra_frame_yuv.hq,
                 cavlc_slots=cavlc_device.frame_block_slots,
                 cavlc_chain=cavlc_device.frame_block_slots.hq,
                 pack_hq=bitmerge.pack_frame.hq,
                 content_hq=content_stats.chunk_stats.hq,
                 content=content_stats.chunk_stats,
                 inter_off=h264_inter.encode_p_frame,
                 cavlc_p_off=cavlc_p_device.p_frame_slots,
                 pack_p_off=bitmerge.pack_p_frame,
                 intra_off=h264_device.encode_intra_frame_yuv)
    del named["inter"], named["cavlc_p_slots"], named["pack_p"]

    def planes_of(enc, f):
        return tuple(p.contiguous() for p in enc._planes_device(f))

    # -- main path, full tier: K9 colour, K14, the hq forms, I16-in-P ----------
    zero_counts(named)
    enc = H264Encoder(W, H, **full_kw)
    check(enc.device.type == "cuda" and enc._ktune == "hq" and enc._p_intra
          and not enc.host_color, "not the full tier on the card")
    refs, intra = [], []

    def on_submit(e, tok):
        refs.append(tuple(p.clone() for p in e._ref))
        if tok[0] == "p":
            intra.append(int(tok[4][2]["mb_intra"].sum()))

    toks, aus, keys = drive(enc, frames, depth=2, on_submit=on_submit)
    torch.cuda.synchronize()
    launches = path_launches(named)
    qps = [token_qp(t) for t in toks]
    rep["full"] = {"qps": qps, "launches": launches, "mb_intra": intra,
                   "au_bytes": [len(a) for a in aus]}
    print(f"tune full main: {len(aus)} frames, qp {qps}, I16-in-P MBs a P "
          f"frame {intra}, launches {launches}")
    for k in ("color_frames", "qp_plane", "intra_hq", "cavlc_chain", "pack_hq",
              "inter_hq", "inter_i16", "inter_merge", "cavlc_p_slots_hq",
              "cavlc_p_chain", "pack_p_hq", "content_hq"):
        check(launches[k] >= 1, f"tune full: {k} never launched: {launches}")
    check(launches["inter_off"] == 0 and launches["intra_off"] == 0,
          "the full tier ran a tune=off core")
    check(sum(intra) > 0, "no I16-in-P MB in the full-tier run")
    check(keys == [i == 0 for i in range(TUNE_FRAMES)], f"keyframes {keys}")

    # -- (a) the full tier's kernels against their plain versions -------------
    pi = next(i for i, n in enumerate(intra, 1) if n > 0)
    pl = planes_of(enc, frames[pi])
    nxt = planes_of(enc, frames[min(pi + 1, TUNE_FRAMES - 1)])[0]
    ref, qp = refs[pi - 1], qps[pi]
    hv, hl = enc._p_hdr_slots(toks[pi][4][1], qp - enc.qp)
    m_k = aq.qp_plane(pl[0], qp, nxt)
    check(torch.equal(m_k, aq.qp_plane_plain(pl[0], qp, nxt)), "K14 differs")
    o_k = h264_inter.encode_p_frame(*pl, *ref, qp, tune="hq", p_intra=True)
    o_p = h264_inter.encode_p_frame_plain(*pl, *ref, qp, "hq", o_k["qp_map"],
                                          True)
    for k in o_p:
        check(torch.equal(o_k[k], o_p[k]), f"K5 hq: {k} differs")
    check(bool(o_k["mb_intra"].any()), "K5 hq: no I16-in-P MB at the check")
    s_k = cavlc_p_device.p_frame_slots(o_k, qp)
    s_p = cavlc_p_device.p_frame_slots_plain(o_k, qp)
    for i, (a, b) in enumerate(zip(s_k, s_p)):
        check(torch.equal(a, b), f"K6 hq: output {i} differs")
    f_k = bitmerge.pack_p_frame(*s_k[:6], hv, hl, qp_sum=s_k[7])
    f_p = bitmerge.pack_p_frame_plain(*s_k[:6], hv, hl, qp_sum=s_k[7])
    check(torch.equal(f_k, f_p), "K7 hq: flat differs")
    resid = tuple(o_k[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"))
    c_args = (o_k["recon_y"], o_k["mv"], resid, o_k["mb_intra"])
    v_k, g_k = content_stats.frame_stats_full(pl[0], ref[0], 512, *c_args)
    v_p, g_p = content_stats.frame_stats_full_plain(pl[0], ref[0], 512, *c_args)
    ints = [1, 2, 3, 4, 9]
    check(torch.equal(g_k, g_p) and torch.equal(v_k[ints], v_p[ints]),
          f"K4 hq: {v_k} vs {v_p}")
    k4_err = float((v_k - v_p).abs().max())
    check(float(((v_k - v_p).abs() / v_p.abs().clamp(min=1)).max())
          <= FLOAT_REL_TOL, f"K4 hq: {v_k} vs {v_p}")
    check(v_k[4] > 0, "K4 hq: no intra MB counted")
    idr = planes_of(enc, frames[0])
    qp0 = qps[0]
    l_k = h264_device.encode_intra_frame_yuv(*idr, qp0, tune="hq")
    t0 = time.perf_counter()
    l_p = h264_device.encode_intra_frame_yuv_plain(*idr, qp0, "hq", l_k["qp_map"])
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    for k in l_p:
        check(torch.equal(l_k[k], l_p[k]), f"K1 hq: {k} differs")
    sl_k = cavlc_device.frame_block_slots(l_k, qp0)
    sl_p = cavlc_device.frame_block_slots_plain(l_k, qp0)
    for i, (a, b) in enumerate(zip(sl_k, sl_p)):
        check(torch.equal(a, b), f"K2 hq: output {i} differs")
    hv0, hl0 = enc._hdr_slots(toks[0][4][1], qp0 - enc.qp)
    fl_k = bitmerge.pack_frame(*sl_k[:4], hv0, hl0, qp_sum=sl_k[4])
    fl_p = bitmerge.pack_frame_plain(*sl_k[:4], hv0, hl0, qp_sum=sl_k[4])
    check(torch.equal(fl_k, fl_p), "K3 hq: flat differs")
    print(f"(a) tune full: K14, K1, K2, K3, K5 (three passes, {int(o_k['mb_intra'].sum())} "
          f"I16-in-P MBs), K6, K7 and K4 hq forms equal to their plain versions "
          f"at frame {pi} (qp {qp}) and the IDR (qp {qp0})")

    # -- (b) an IDR and two P frames against the plain path -------------------
    def plain_au_p(planes, pref, q, frame_num, e):
        hv_, hl_ = e._p_hdr_slots(frame_num, q - e.qp)
        tune_ = e._ktune
        qm = aq.qp_plane_plain(planes[0], q) if tune_ == "hq" else None
        out = h264_inter.encode_p_frame_plain(*planes, *pref, q, tune_, qm,
                                              e._p_intra)
        sl = cavlc_p_device.p_frame_slots_plain(out, q)
        flat = bitmerge.pack_p_frame_plain(
            *sl[:6], hv_, hl_, qp_sum=sl[7] if len(sl) > 7 else None).cpu().numpy()
        meta = cavlc_device.FlatMeta(flat, e.mb_h)
        check(not meta.overflow, "(b) tune: a P frame overflowed")
        au = cavlc_device.assemble_annexb(flat, meta, nal_type=syn.NAL_SLICE,
                                          ref_idc=2)
        return au, out, sl

    def plain_au_idr(planes, q, idr_pic_id, e, lv=None):
        hv_, hl_ = e._hdr_slots(idr_pic_id, q - e.qp)
        if lv is None:
            qm = aq.qp_plane_plain(planes[0], q) if e._ktune == "hq" else None
            lv = h264_device.encode_intra_frame_yuv_plain(*planes, q, e._ktune, qm)
        sl = cavlc_device.frame_block_slots_plain(lv, q)
        flat = bitmerge.pack_frame_plain(
            *sl[:4], hv_, hl_, qp_sum=sl[4] if len(sl) > 4 else None).cpu().numpy()
        meta = cavlc_device.FlatMeta(flat, e.mb_h)
        if meta.overflow:
            lvn = {k: v.cpu().numpy() for k, v in lv.items()
                   if not k.startswith("recon")}
            qm = lvn.pop("qp_map", None)
            return h264_entropy.encode_intra_picture(
                lvn, frame_num=0, idr_pic_id=idr_pic_id, sps=e._sps, pps=e._pps,
                with_headers=True, qp_delta=q - e.qp,
                deblocking_idc=e._deblock_idc, qp_map=qm, slice_qp=q), lv
        return cavlc_device.assemble_annexb(flat, meta, headers=e.headers()), lv

    au0, _ = plain_au_idr(idr, qp0, toks[0][4][1], enc, l_p)
    check(aus[0] == au0, "(b) tune full: the IDR differs from the plain path")
    pref = (l_p["recon_y"], l_p["recon_cb"], l_p["recon_cr"])
    for i in (1, 2):
        au, out, _ = plain_au_p(planes_of(enc, frames[i]), pref, qps[i],
                                toks[i][4][1], enc)
        check(aus[i] == au, f"(b) tune full: P frame {i} differs from the plain path")
        pref = (out["recon_y"], out["recon_cb"], out["recon_cr"])
    print("(b) tune full: the IDR and two P frames equal to the plain path")

    # -- (c) cv2 decodes the full tier's stream to its references --------------
    rep["full"]["cv2"] = cv2_luma_check("tune_full", aus, refs)

    # -- the full tier's ring with the lookahead -------------------------------
    rframes = tune_frames(TUNE_RING_FRAMES, seed=4)
    zero_counts(named)
    ring = H264Encoder(W, H, superstep_chunk=4, **full_kw)
    check(ring._ring_chunk == 4, "the full tier's ring is off")
    rtoks, raus, _ = drive(ring, rframes)
    torch.cuda.synchronize()
    r_launch = path_launches(named)
    check(dispatched_chunks(rtoks) == 2, "the full tier's ring did not replay two chunks")
    for k in ("qp_plane", "inter_hq", "inter_i16", "inter_merge", "cavlc_p_chain"):
        check(r_launch[k] >= 1, f"tune ring: {k} never launched {r_launch}")
    rqps = [token_qp(t) for t in rtoks]
    twin = flush_twin(H264Encoder(W, H, superstep_chunk=4,
                                  **dict(full_kw, bitrate_kbps=0)))
    # a ring asks for one qp a chunk: each frame's, by its index
    twin._eff_qp = lambda keyframe=True: rqps[twin.frame_index - 1]
    _, taus, _ = drive(twin, rframes)
    check(raus == taus, "(b) tune full ring: the AUs differ from the per-frame "
          "path with the lookahead at the ring's qps")
    print(f"(b) tune full ring: {len(raus)} AUs (two replayed chunks, a drained "
          f"frame) equal to the per-frame path with the lookahead; launches "
          f"through the graph {r_launch}")
    rep["full_ring"] = {"qps": rqps, "launches": r_launch}

    # -- main path, served tier: make_encoder with ENCODER_TUNE=hq --------------
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_TUNE": "hq"}
    zero_counts(named)
    srv, _ = make_encoder(from_env(env), W, H)
    check(srv._ktune == "hq_noaq" and srv.deblock and not srv._p_intra,
          "make_encoder did not serve the hq_noaq tier")
    srefs = []
    stoks, saus, _ = drive(srv, frames, depth=2, on_submit=lambda e, t: srefs.append(
        tuple(p.clone() for p in e._ref)))
    torch.cuda.synchronize()
    s_launch = path_launches(named)
    sqps = [token_qp(t) for t in stoks]
    for k in ("intra_hq", "inter_hq", "cavlc_p_off", "pack_p_off", "deblock",
              "content"):
        check(s_launch[k] >= 1, f"tune served: {k} never launched {s_launch}")
    check(s_launch["qp_plane"] == 0 and s_launch["inter_i16"] == 0,
          f"the served tier ran the full tier's kernels {s_launch}")
    print(f"tune served main: {len(saus)} frames, qp {sqps}, launches {s_launch}")
    # (a) K1 and K5 at hq_noaq against their plain versions
    sidr = planes_of(srv, frames[0])
    sl_k1 = h264_device.encode_intra_frame_yuv(*sidr, sqps[0], tune="hq_noaq")
    t0 = time.perf_counter()
    sl_p1 = h264_device.encode_intra_frame_yuv_plain(*sidr, sqps[0], "hq_noaq")
    torch.cuda.synchronize()
    k1n_plain_ms = (time.perf_counter() - t0) * 1e3
    for k in sl_p1:
        check(torch.equal(sl_k1[k], sl_p1[k]), f"K1 hq_noaq: {k} differs")
    spl = planes_of(srv, frames[pi])
    so_k = h264_inter.encode_p_frame(*spl, *srefs[pi - 1], sqps[pi], tune="hq_noaq")
    so_p = h264_inter.encode_p_frame_plain(*spl, *srefs[pi - 1], sqps[pi], "hq_noaq")
    for k in so_p:
        check(torch.equal(so_k[k], so_p[k]), f"K5 hq_noaq: {k} differs")
    # (b) the IDR and two P frames against the plain path (deblocked refs)
    au0, lv0 = plain_au_idr(sidr, sqps[0], stoks[0][4][1], srv, sl_p1)
    check(saus[0] == au0, "(b) tune served: the IDR differs from the plain path")
    pref = h264_deblock.deblock_frame_plain(lv0["recon_y"], lv0["recon_cb"],
                                            lv0["recon_cr"], sqps[0])
    for i in (1, 2):
        au, out, sl = plain_au_p(planes_of(srv, frames[i]), pref, sqps[i],
                                 stoks[i][4][1], srv)
        check(saus[i] == au, f"(b) tune served: P frame {i} differs")
        pref = h264_deblock.deblock_frame_plain(
            out["recon_y"], out["recon_cb"], out["recon_cr"], sqps[i],
            nnz_blk=sl[6], mv=out["mv"])
    print("(a)/(b) tune served: K1 and K5 hq_noaq equal to their plain versions; "
          "the IDR and two P frames equal to the plain path")
    rep["served"] = {"qps": sqps, "launches": s_launch,
                     "cv2": cv2_luma_check("tune_served", saus, srefs)}

    # the served tier's ring against the per-frame path at its qps
    renv = dict(env, ENCODER_SUPERSTEP_CHUNK="4")
    sring, _ = make_encoder(from_env(renv), W, H)
    check(sring._ring_chunk == 4, "the served tier's ring is off")
    srtoks, sraus, _ = drive(sring, rframes)
    check(dispatched_chunks(srtoks) == 2, "the served ring did not replay two chunks")
    per = pinned_per_frame(renv, W, H, [token_qp(t) for t in srtoks])
    _, spaus, _ = drive(per, rframes, depth=2)
    check(sraus == spaus, "(b) tune served ring: the AUs differ from the per-frame path")
    print(f"(b) tune served ring: {len(sraus)} AUs equal to the per-frame path")

    # CABAC's two routes under hq_noaq
    cab = {}
    for route in ("host", "device"):
        os.environ["ENCODER_CABAC_BINARIZE"] = route
        try:
            ce, codec = make_encoder(from_env(dict(env, ENCODER_ENTROPY="cabac")), W, H)
            check(codec == "h264_cabac" and ce._ktune == "hq_noaq"
                  and ce.cabac_device_binarize == (route == "device"),
                  f"CABAC {route} route not set up")
            crefs = []
            _, cab[route], _ = drive(ce, frames[:TUNE_CABAC_FRAMES], depth=2,
                                     on_submit=lambda e, t: crefs.append(
                                         tuple(p.clone() for p in e._ref)))
        finally:
            os.environ.pop("ENCODER_CABAC_BINARIZE", None)
    check(cab["host"] == cab["device"], "(b) tune CABAC: the routes differ")
    rep["cabac_cv2"] = cv2_luma_check("tune_cabac", cab["device"], crefs)
    print(f"(b) tune CABAC: both routes byte-identical over {TUNE_CABAC_FRAMES} frames")

    # -- times: K14; K1 and K5 per tier beside tune=off ------------------------
    out_rows = []
    nmb = enc.mb_h * enc.mb_w
    t_k1 = {t: cuda_ms(lambda t=t: h264_device.encode_intra_frame_yuv(
        *idr, qp0, tune=t), reps=10) for t in ("off", "hq_noaq", "hq")}
    t_k5 = {}
    for name, t, pi_ in (("off", "off", False), ("hq_noaq", "hq_noaq", False),
                         ("hq", "hq", False), ("hq+i16", "hq", True)):
        t_k5[name] = cuda_ms(lambda t=t, pi_=pi_: h264_inter.encode_p_frame(
            *pl, *ref, qp, tune=t, p_intra=pi_), reps=20)
    earlier = {r["name"]: r["ms"] for r in rows_before}
    print("tune times (CUDA events, ms): K1 " + ", ".join(
        f"{k} {v:.3f}" for k, v in t_k1.items()) + "; K5 " + ", ".join(
        f"{k} {v:.3f}" for k, v in t_k5.items()))
    print(f"tune ratios: K1 hq_noaq/off {t_k1['hq_noaq'] / t_k1['off']:.2f}, "
          f"hq/off {t_k1['hq'] / t_k1['off']:.2f}; K5 hq_noaq/off "
          f"{t_k5['hq_noaq'] / t_k5['off']:.2f}, hq/off {t_k5['hq'] / t_k5['off']:.2f}, "
          f"hq+I16-in-P/off {t_k5['hq+i16'] / t_k5['off']:.2f}")
    print(f"tune=off now against the earlier phases: K1 {t_k1['off']:.3f} vs "
          f"{earlier.get('intra', float('nan')):.3f} ms, K5 {t_k5['off']:.3f} vs "
          f"{earlier.get('inter', float('nan')):.3f} ms")
    rep.update(k1_ms=t_k1, k5_ms=t_k5, off_earlier={
        "intra": earlier.get("intra"), "inter": earlier.get("inter")})
    saved = {k: fn.launches for k, fn in named.items()}
    plain = lambda fn, reps=3: cuda_ms(fn, reps=reps)
    specs = [
        ("qp_plane", "aq.cu", "aq.py:115 qp_plane (:87 aq_offsets, :103 lookahead_bias)",
         lambda: aq.qp_plane(pl[0], qp, nxt), lambda: aq.qp_plane_plain(pl[0], qp, nxt),
         nbytes(pl[0], nxt, m_k), 0.0, 0.0, launches["qp_plane"]),
        ("intra_hq", "intra.cu", "h264_device.py:555 encode_intra_frame_yuv (tune=hq)",
         lambda: h264_device.encode_intra_frame_yuv(*idr, qp0, tune="hq"), None,
         nbytes(*idr) + nbytes(*l_k.values()), 0.0, 0.0, launches["intra_hq"]),
        ("cavlc_slots_hq", "cavlc.cu", "cavlc_device.py:416 frame_block_slots (qp chain :527-545)",
         lambda: cavlc_device.frame_block_slots(l_k, qp0),
         lambda: cavlc_device.frame_block_slots_plain(l_k, qp0),
         nbytes(*[l_k[k] for k in l_k if not k.startswith("recon")]) + nbytes(*sl_k),
         0.0, 0.0, launches["cavlc_chain"]),
        ("pack_hq", "pack.cu", "cavlc_device.py:629 pack_frame (qp_sum :707-708)",
         lambda: bitmerge.pack_frame(*sl_k[:4], hv0, hl0, qp_sum=sl_k[4]),
         lambda: bitmerge.pack_frame_plain(*sl_k[:4], hv0, hl0, qp_sum=sl_k[4]),
         pack_bytes(*sl_k[:4], (sl_k[4], hv0, hl0), 4096 + 4 * cavlc_device.FlatMeta(
             fl_k[:4096].cpu().numpy(), enc.mb_h).total_words), 0.0, 0.0,
         launches["pack_hq"]),
        ("inter_hq", "inter.cu", "h264_inter.py:300 encode_p_frame_padded_ref (tune=hq, p_intra)",
         lambda: h264_inter.encode_p_frame(*pl, *ref, qp, tune="hq", p_intra=True),
         lambda: h264_inter.encode_p_frame_plain(*pl, *ref, qp, "hq", o_k["qp_map"], True),
         nbytes(*pl, *ref, *o_k.values()), k5_hq_ops(nmb, True), 0.0,
         launches["inter_hq"]),
        ("cavlc_p_slots_hq", "cavlc.cu", "cavlc_p_device.py:158 p_frame_block_slots (27 blocks, qp chain)",
         lambda: cavlc_p_device.p_frame_slots(o_k, qp),
         lambda: cavlc_p_device.p_frame_slots_plain(o_k, qp),
         nbytes(*[o_k[k] for k in o_k if not k.startswith("recon")], *s_k), 0.0, 0.0,
         launches["cavlc_p_slots_hq"]),
        ("pack_p_hq", "pack.cu", "cavlc_p_device.py:298 pack_p_frame (27 blocks, qp_sum)",
         lambda: bitmerge.pack_p_frame(*s_k[:6], hv, hl, qp_sum=s_k[7]),
         lambda: bitmerge.pack_p_frame_plain(*s_k[:6], hv, hl, qp_sum=s_k[7]),
         pack_bytes(*s_k[:4], (*s_k[4:6], s_k[7], hv, hl), 4096 + 4 * cavlc_device.FlatMeta(
             f_k[:4096].cpu().numpy(), enc.mb_h).total_words), 0.0, 0.0,
         launches["pack_p_hq"]),
        ("content_stats_hq", "content.cu", "content_stats.py:156 frame_stats (mb_intra :100-120)",
         lambda: content_stats.frame_stats_full(pl[0], ref[0], 512, *c_args),
         lambda: content_stats.frame_stats_full_plain(pl[0], ref[0], 512, *c_args),
         nbytes(pl[0], ref[0], o_k["recon_y"], o_k["mv"], *resid, o_k["mb_intra"],
                v_k, g_k), 0.0, k4_err, launches["content_hq"]),
        ("intra_hq_noaq", "intra.cu", "h264_device.py:555 encode_intra_frame_yuv (tune=hq_noaq)",
         lambda: h264_device.encode_intra_frame_yuv(*sidr, sqps[0], tune="hq_noaq"),
         None, nbytes(*sidr) + nbytes(*sl_k1.values()), 0.0, 0.0, s_launch["intra_hq"]),
        ("inter_hq_noaq", "inter.cu", "h264_inter.py:300 encode_p_frame_padded_ref (tune=hq_noaq)",
         lambda: h264_inter.encode_p_frame(*spl, *srefs[pi - 1], sqps[pi], tune="hq_noaq"),
         lambda: h264_inter.encode_p_frame_plain(*spl, *srefs[pi - 1], sqps[pi], "hq_noaq"),
         nbytes(*spl, *srefs[pi - 1], *so_k.values()), k5_hq_ops(nmb, False), 0.0,
         s_launch["inter_hq"]),
    ]
    k1_plain = {"intra_hq": k1_plain_ms, "intra_hq_noaq": k1n_plain_ms}
    for name, src, replaces, fk, fp, nb, ops, err, n in specs:
        pm = plain(fp) if fp is not None else k1_plain[name]
        out_rows.append(kernel_row(name, src, replaces, n, err,
                                   cuda_ms(fk, reps=10), pm, nb, ops))
    # the I16-in-P launches alone, the frame form (the per-frame path and the
    # ring's nodes): their host call by CUDA events, their kernels by device
    # time; K5 hq with them was held equal to plain above (o_k)
    fk = lambda: h264_inter.encode_p_frame(*pl, *ref, qp, tune="hq", p_intra=True)
    kept = float(o_k["mb_intra"].sum())
    row = kernel_row(
        "inter_i16", "inter.cu", "h264_inter.py:688-782 I16-in-P (the frame form: "
        "the want launch, then the gate and merge launch)",
        launches["inter_i16"] + r_launch["inter_i16"], 0.0, i16_pass_ms(fk),
        next(r for r in out_rows if r["name"] == "inter_hq")["plain_ms"], i16_bytes(pl, o_k),
        I16_CAND_OPS * (o_k["mb_intra"].numel() + kept))
    split = kernel_split(fk)
    row["device_ms"] = sum(v for k, v in split.items() if "i16" in k) if split else None
    check(row["device_ms"] is None or row["device_ms"] >= row["bound_ms"],
          f"inter_i16: device time {row['device_ms']} ms under its bound")
    print(f"kernel inter_i16: {row['ms']:.4f} ms a host call, device "
          f"{row['device_ms'] if row['device_ms'] is None else round(row['device_ms'], 4)} "
          f"ms (bound {row['bound_ms']:.4f} ms by {row['bound_by']}; {kept:.0f} kept MBs; "
          f"{row['launches']} host calls on the full tier's path and ring)")
    out_rows.append(row)
    for k, fn in named.items():
        fn.launches = saved[k]
    k14 = next(r for r in out_rows if r["name"] == "qp_plane")
    for r in out_rows:
        print(f"kernel {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches on its tier's main path)")
    print(f"kernel qp_plane against its bound: {k14['ms'] / k14['bound_ms']:.1f}x")

    # -- frames/s of each tier against tune=off, alternating runs -------------
    confs = {
        "off": lambda: make_encoder(from_env({"SIZEW": str(W), "SIZEH": str(H)}),
                                    W, H)[0],
        "hq_noaq": lambda: make_encoder(from_env(env), W, H)[0],
        "off_nodeblock": lambda: H264Encoder(W, H, **dict(full_kw, tune="off")),
        "hq": lambda: H264Encoder(W, H, **full_kw),
    }
    timed = tune_frames(TUNE_TIMED_FRAMES, seed=6)
    fps = {k: [] for k in confs}
    for rnd in range(TUNE_ROUNDS):
        order = list(confs) if rnd % 2 == 0 else list(confs)[::-1]
        for k in order:
            e = confs[k]()
            drive(e, timed[:2], depth=2)            # warm: an IDR and a P
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive(e, timed, depth=2)
            torch.cuda.synchronize()
            fps[k].append(len(timed) / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in fps.items()}
    print("tune e2e frames/s (median of " + f"{TUNE_ROUNDS} alternating runs, "
          f"{TUNE_TIMED_FRAMES} frames, 2 in flight): " + ", ".join(
              f"{k} {v:.2f} {[round(x, 2) for x in fps[k]]}" for k, v in med.items())
          + f"; hq_noaq/off {med['hq_noaq'] / med['off']:.3f}, "
          f"hq/off(no deblock) {med['hq'] / med['off_nodeblock']:.3f}")
    rep.update(fps=fps, fps_median=med, phase_s=time.perf_counter() - t_phase)
    return out_rows


def mjpeg_frames(n: int, seed: int = 7):
    """A desktop whose text pane scrolls 12 pels a frame, a window that
    moves 16 pels a frame and a blinking cursor."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = desktop_base(rng)
    text = base[200:600, 900:1500].copy()
    frames = []
    for i in range(n):
        f = base.copy()
        f[200:600, 900:1500] = np.roll(text, -12 * i, axis=0)
        x0 = 100 + 16 * i
        f[650:900, x0:x0 + 420] = (236, 236, 230)
        f[650:674, x0:x0 + 420] = (50, 60, 140)
        f[700:880:18, x0 + 20:x0 + 380:3] = 20
        if i % 2:
            f[960:980, 300:310] = 0
        frames.append(f)
    return frames


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def decode_rgb(data: bytes):
    import cv2
    import numpy as np

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    check(bgr is not None, "cv2 could not decode a JPEG")
    return bgr[..., ::-1]


def hist_p50(name: str) -> float:
    """The p50 of a histogram of the port's metrics registry, linearly
    interpolated inside its bucket (as Prometheus' histogram_quantile)."""
    from docker_nvidia_glx_desktop_tpu_torch.obs import metrics as obsm

    (series,) = obsm.REGISTRY.snapshot()[name]["series"]
    edges = [float(e) for e in series["buckets"]]
    counts = list(series["buckets"].values())
    half, cum, lo = series["count"] / 2.0, 0, 0.0
    for e, c in zip(edges, counts):
        if c and cum + c >= half:
            return lo + (e - lo) * (half - cum) / c
        cum, lo = cum + c, e
    return float("inf")


def rfb_client_run(port: int, src, frames, w: int, h: int):
    """A raw-socket RFB 3.8 client: security None, SetEncodings [7, 0],
    then per frame: push it, ask for a full update, read one rect.
    Returns [(encoding, payload)] and the wall seconds of the updates."""
    import socket
    import struct

    def read(n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            check(chunk, "the RFB server closed the connection")
            buf += chunk
        return bytes(buf)

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        check(read(12).startswith(b"RFB 003.008"), "RFB version")
        sock.sendall(b"RFB 003.008\n")
        check(read(read(1)[0]) == b"\x01", "RFB security types")
        sock.sendall(b"\x01")
        check(struct.unpack(">I", read(4))[0] == 0, "RFB security result")
        sock.sendall(b"\x01")
        fw, fh = struct.unpack(">HH", read(4))
        check((fw, fh) == (w, h), f"RFB framebuffer {fw}x{fh}")
        read(16)
        read(struct.unpack(">I", read(4))[0])
        sock.sendall(struct.pack(">BxHii", 2, 2, 7, 0))
        rects = []
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            src.push(f)
            sock.sendall(struct.pack(">BBHHHH", 3, int(i > 0), 0, 0, w, h))
            check(read(4)[0] == 0, "not a FramebufferUpdate")
            x, y, rw, rh, enc = struct.unpack(">HHHHi", read(12))
            check((x, y, rw, rh) == (0, 0, w, h), "not a full-frame rect")
            if enc == 7:
                check(read(1)[0] == 0x90, "not a Tight-JPEG rect")
                n, shift = 0, 0
                for _ in range(3):
                    b = read(1)[0]
                    n |= (b & (0xFF if shift == 14 else 0x7F)) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                rects.append((enc, read(n)))
            else:
                rects.append((enc, read(rw * rh * 4)))
        return rects, time.perf_counter() - t0
    finally:
        sock.close()


def mjpeg_phase(report):
    """``WEBRTC_ENCODER=tpumjpegenc`` and the noVNC path's Tight-JPEG at
    1080p: (a) make_encoder's sticky tables, then per-frame tables (K16b
    every frame), each JPEG decoded by cv2, the first frames against the
    plain versions' bytes, K16a-c against their plain versions on this
    run's frames and levels; (b) RfbServer with a raw-socket client, each
    Tight rect the JPEG of a second encoder fed the same frames; (c) the
    session batch (S sessions x nx restart strips at 1920x1088) against
    the plain batch, each session assembled and decoded."""
    import asyncio
    import threading

    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import (
        JpegEncoder, _tables_from_hists)
    from docker_nvidia_glx_desktop_tpu_torch.obs import metrics as obsm
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
    from docker_nvidia_glx_desktop_tpu_torch.rfb.server import RfbServer
    from docker_nvidia_glx_desktop_tpu_torch.rfb.source import NumpySource
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    rep = report["mjpeg"] = {}
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    kernels = {"transform": jd.jpeg_transform, "analyze": jd.jpeg_analyze,
               "pack": jd.jpeg_pack}
    frames = mjpeg_frames(MJPEG_STICKY_FRAMES)
    pf_frames = mjpeg_frames(MJPEG_PER_FRAME_FRAMES, seed=8)

    def counted():
        return {k: fn.launches for k, fn in kernels.items()}

    def timed_encode(enc, fs):
        out, ms = [], []
        for f in fs:
            t = time.perf_counter()
            out.append(enc.encode(f).data)
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    # -- (a) main path: make_encoder (sticky tables), then per-frame tables --
    zero_counts(kernels)
    enc, codec = make_encoder(from_env({"SIZEW": str(W), "SIZEH": str(H),
                                        "WEBRTC_ENCODER": "tpumjpegenc"}), W, H)
    check(codec == "mjpeg" and isinstance(enc, JpegEncoder)
          and enc.device.type == "cuda" and enc.entropy == "device",
          "make_encoder(tpumjpegenc) is not the port's encoder on the card")
    sticky, sticky_ms = timed_encode(enc, frames)
    pf = JpegEncoder(W, H, table_mode="per_frame")
    per_frame, pf_ms = timed_encode(pf, pf_frames)
    torch.cuda.synchronize()
    launches = counted()
    n_all = len(frames) + len(pf_frames)
    print(f"mjpeg main: {len(frames)} frames sticky ({enc.table_builds} table "
          f"build), {len(pf_frames)} per frame ({pf.table_builds} builds) at "
          f"{W}x{H}; launches {launches}")
    check(launches == {"transform": n_all, "pack": n_all,
                       "analyze": 1 + len(pf_frames)},
          f"mjpeg launches {launches}")
    check(enc.table_builds == 1 and pf.table_builds == len(pf_frames),
          "table builds")
    quality = []
    for data, f in zip(sticky + per_frame, frames + pf_frames):
        quality.append(psnr(decode_rgb(data), f))
    check(min(quality) > MJPEG_MIN_PSNR, f"decoded PSNR {min(quality):.2f} dB")
    print(f"(c) mjpeg: {len(quality)} JPEGs decoded by cv2, PSNR "
          f"{min(quality):.2f}-{max(quality):.2f} dB, "
          f"{np.mean([len(d) for d in sticky]) / 1e3:.1f} kB a sticky frame")

    # (b) the same frames through the plain versions: the same bytes
    jd.jpeg_transform, jd.jpeg_analyze, jd.jpeg_pack = (
        jd.jpeg_transform_plain, jd.jpeg_analyze_plain, jd.jpeg_pack_plain)
    try:
        twin = JpegEncoder(W, H)
        want = [twin.encode(f).data for f in frames[:MJPEG_PLAIN_FRAMES]]
        twin_pf = JpegEncoder(W, H, table_mode="per_frame")
        want_pf = [twin_pf.encode(f).data
                   for f in pf_frames[:MJPEG_PLAIN_FRAMES]]
    finally:
        jd.jpeg_transform, jd.jpeg_analyze, jd.jpeg_pack = kernels.values()
    check(want == sticky[:MJPEG_PLAIN_FRAMES]
          and want_pf == per_frame[:MJPEG_PLAIN_FRAMES],
          "(b) mjpeg: the JPEGs differ from the plain versions' JPEGs")
    print(f"(b) mjpeg: {2 * MJPEG_PLAIN_FRAMES} JPEGs byte-identical to the "
          f"plain versions' (sticky and per-frame tables)")

    # (a) each kernel against its plain version on this run's inputs
    lq, cq = enc.luma_q, enc.chroma_q
    tabs = enc._table_dev
    for f in (frames[0], frames[-1], pf_frames[-1]):
        t = torch.from_numpy(f).to(dev)[None]
        lv = jd.jpeg_transform(t, lq, cq, enc.pad_h, enc.pad_w)
        lp = jd.jpeg_transform_plain(t, lq, cq, enc.pad_h, enc.pad_w)
        check(all(torch.equal(a, b) for a, b in zip(lv, lp)),
              "K16a differs from its plain version")
        check(torch.equal(jd.jpeg_analyze(*lv), jd.jpeg_analyze_plain(*lv)),
              "K16b differs from its plain version")
        for tt in (tabs, pf._table_dev):
            (got,), = jd.strip_bytes(*jd.jpeg_pack(*lv, tt))
            (want,), = jd.strip_bytes(*jd.jpeg_pack_plain(*lv, tt))
            check(got[1] == want[1] and np.array_equal(got[0], want[0]),
                  "K16c differs from its plain version")
    print("(a) mjpeg: K16a, K16b and K16c equal to their plain versions on 3 "
          "frames of this run (K16c with the sticky and per-frame tables)")
    st = sorted(sticky_ms[1:])
    pm = sorted(pf_ms[1:])
    rep.update(launches=launches, psnr_min=min(quality),
               sticky_ms=sticky_ms, per_frame_ms=pf_ms,
               sticky_p50_ms=statistics.median(st),
               per_frame_p50_ms=statistics.median(pm),
               sticky_fps=len(st) / (sum(st) / 1e3),
               per_frame_fps=len(pm) / (sum(pm) / 1e3),
               sticky_bytes=float(np.mean([len(d) for d in sticky])))
    print(f"mjpeg e2e at {W}x{H} (host clock, first frame excluded): sticky "
          f"{rep['sticky_fps']:.1f} frames/s, p50 encode "
          f"{rep['sticky_p50_ms']:.2f} ms; per-frame tables "
          f"{rep['per_frame_fps']:.1f} frames/s, p50 {rep['per_frame_p50_ms']:.2f} ms")
    rep["busy"] = device_busy(JpegEncoder(W, H), frames[:8], depth=1)

    # -- (b) RFB: Tight-JPEG rects through a raw-socket client ---------------
    rfb_frames = mjpeg_frames(RFB_FRAMES, seed=9)
    src = NumpySource(W, H)
    server = RfbServer(source=src, jpeg_quality=RFB_QUALITY)
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    snap = obsm.REGISTRY.snapshot

    def route(name, *labels):
        for s in snap().get(name, {}).get("series", []):
            if tuple(s["labels"].values()) == labels:
                return s["value"]
        return 0.0

    before = (route("dngd_rfb_jpeg_total", "cv2"),
              route("dngd_rfb_jpeg_errors_total"))
    try:
        asyncio.run_coroutine_threadsafe(
            server.start("127.0.0.1", 0), loop).result(60)
        zero_counts(kernels)
        rects, rfb_s = rfb_client_run(server.port, src, rfb_frames, W, H)
        torch.cuda.synchronize()
        rfb_launches = counted()
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
    tight = [d for e, d in rects if e == 7]
    check(len(tight) == len(rfb_frames) >= 10,
          f"{len(tight)} Tight rects of {len(rfb_frames)} updates")
    check(server._jpeg_enc is not None
          and server._jpeg_enc.device.type == "cuda"
          and server._jpeg_enc.frame_index == len(tight),
          "the Tight rects did not all come from the card's encoder")
    check((route("dngd_rfb_jpeg_total", "cv2"),
           route("dngd_rfb_jpeg_errors_total")) == before,
          "cv2 or an encode error served a Tight rect")
    check(all(v == len(tight) for k, v in rfb_launches.items()
              if k != "analyze") and rfb_launches["analyze"] == 1,
          f"RFB launches {rfb_launches}")
    twin = JpegEncoder(W, H, quality=RFB_QUALITY)
    for data, f in zip(tight, rfb_frames):
        check(data == twin.encode(f).data, "a Tight rect differs from the "
              "second encoder's JPEG of its frame")
        check(psnr(decode_rgb(data), f) > MJPEG_MIN_PSNR - 3,
              "a Tight rect decodes badly")
    rfb_p50 = hist_p50("dngd_rfb_jpeg_encode_ms")
    rep["rfb"] = {"rects": len(tight), "updates_per_s": len(tight) / rfb_s,
                  "jpeg_encode_ms_p50": rfb_p50, "launches": rfb_launches,
                  "bytes_mean": float(np.mean([len(d) for d in tight]))}
    print(f"rfb: {len(tight)} Tight-JPEG rects at {W}x{H} (quality "
          f"{RFB_QUALITY}) equal to a second encoder's JPEGs and decoded; "
          f"{rep['rfb']['updates_per_s']:.1f} updates/s (request to rect "
          f"read, raw socket on 127.0.0.1), dngd_rfb_jpeg_encode_ms p50 "
          f"{rfb_p50:.2f} ms (bucket-interpolated); launches {rfb_launches}")

    # -- (c) the session batch: S sessions x nx restart strips ----------------
    bframes = np.stack([np.pad(f, ((0, BATCH_H - H), (0, 0), (0, 0)), "edge")
                        for f in mjpeg_frames(BATCH_S, seed=10)])
    step = batch.batch_encode_step(BATCH_H, W, quality=85, spatial=BATCH_NX)
    lv0 = step.transform(bframes)
    hist0 = jd.split_hists(jd.jpeg_analyze(*lv0, BATCH_NX))
    tables = _tables_from_hists([h[0].cpu().numpy() for h in hist0],
                                smooth=True)
    arrays = jd.dense_tables(tables)
    zero_counts(kernels)
    packed, totals, hists = step(bframes, *arrays)
    strips = jd.strip_bytes(packed, totals)
    batch_launches = counted()
    check(batch_launches == {"transform": 1, "analyze": 1, "pack": 1},
          f"batch launches {batch_launches}")
    frames_t = torch.from_numpy(bframes).to(dev)
    lp = jd.jpeg_transform_plain(frames_t, step.luma_q, step.chroma_q,
                                 BATCH_H, W)
    tab_t = jd.table_tensor(arrays, dev)
    pp, tp = jd.jpeg_pack_plain(*lp, tab_t, BATCH_NX)
    check(all(torch.equal(a, b) for a, b in zip(lv0, lp)),
          "batched K16a differs from its plain version")
    check(torch.equal(torch.cat(hists, 1), jd.jpeg_analyze_plain(*lp, BATCH_NX)),
          "batched K16b differs from its plain version")
    plain_strips = jd.strip_bytes(pp, tp)
    check(all(a[1] == b[1] and np.array_equal(a[0], b[0])
              for ra, rb in zip(strips, plain_strips) for a, b in zip(ra, rb)),
          "batched K16c differs from its plain version")
    bq = []
    for i in range(BATCH_S):
        data = batch.assemble_session_jpeg([d for d, _ in strips[i]],
                                           [b for _, b in strips[i]], tables,
                                           W, BATCH_H, quality=85)
        check(data.count(b"\xff\xdd") == 1, "no DRI in a session's JPEG")
        bq.append(psnr(decode_rgb(data), bframes[i]))
    check(min(bq) > MJPEG_MIN_PSNR, f"a session decodes at {min(bq):.2f} dB")
    rep["batch"] = {"sessions": BATCH_S, "strips": BATCH_NX,
                    "launches": batch_launches, "psnr_min": min(bq)}
    print(f"(c) batch: {BATCH_S} sessions x {BATCH_NX} restart strips at "
          f"{W}x{BATCH_H} equal to the plain batch (levels, histograms, "
          f"strips); each session assembled with RSTn and decoded by cv2 at "
          f">= {min(bq):.2f} dB")

    # -- kernel rows: the single encoder's shapes, then the batch's ----------
    t1 = torch.from_numpy(frames[1]).to(dev)[None]
    lv = jd.jpeg_transform(t1, lq, cq, enc.pad_h, enc.pad_w)
    pk, tk = jd.jpeg_pack(*lv, tabs)
    scan_bytes = int((tk.sum() + 7) // 8)
    bt_bytes = int(((totals.long() + 7) // 8).sum())
    hist_b = 4 * jd.HIST_SYMBOLS
    lv_b = nbytes(*lv)
    blv_b = nbytes(*lv0)
    specs = [
        ("jpeg_transform", "models/mjpeg.py:36 _transform_stage",
         lambda: jd.jpeg_transform(t1, lq, cq, enc.pad_h, enc.pad_w),
         lambda: jd.jpeg_transform_plain(t1, lq, cq, enc.pad_h, enc.pad_w),
         nbytes(t1) + lv_b, launches["transform"]),
        ("jpeg_analyze", "jpeg_device.py:142 jpeg_analyze",
         lambda: jd.jpeg_analyze(*lv), lambda: jd.jpeg_analyze_plain(*lv),
         lv_b + hist_b, launches["analyze"]),
        ("jpeg_pack", "jpeg_device.py:154 jpeg_pack (bitpack.py:24 pack_bits)",
         lambda: jd.jpeg_pack(*lv, tabs), lambda: jd.jpeg_pack_plain(*lv, tabs),
         lv_b + 2 * hist_b + scan_bytes + 4, launches["pack"]),
        ("jpeg_transform_batch", "parallel/batch.py:173 _session_transform "
         "(S=4 sessions)",
         lambda: jd.jpeg_transform(frames_t, step.luma_q, step.chroma_q, BATCH_H, W),
         lambda: jd.jpeg_transform_plain(frames_t, step.luma_q, step.chroma_q,
                                         BATCH_H, W),
         nbytes(frames_t) + blv_b, batch_launches["transform"]),
        ("jpeg_analyze_batch", "parallel/batch.py:181 batch_encode_step "
         "(jpeg_analyze + psum, S=4, nx=4)",
         lambda: jd.jpeg_analyze(*lv0, BATCH_NX),
         lambda: jd.jpeg_analyze_plain(*lv0, BATCH_NX),
         blv_b + BATCH_S * hist_b, batch_launches["analyze"]),
        ("jpeg_pack_batch", "parallel/batch.py:181 batch_encode_step "
         "(jpeg_pack, S=4, nx=4)",
         lambda: jd.jpeg_pack(*lv0, tab_t, BATCH_NX),
         lambda: jd.jpeg_pack_plain(*lv0, tab_t, BATCH_NX),
         blv_b + 2 * hist_b + bt_bytes + 4 * BATCH_S * BATCH_NX,
         batch_launches["pack"]),
    ]
    out_rows = [kernel_row(name, "jpeg.cu", replaces, n, 0.0,
                           cuda_ms(fk, reps=20), cuda_ms(fp, reps=3), nb)
                for name, replaces, fk, fp, nb, n in specs]
    for r, t in ((out_rows[0], t1), (out_rows[3], frames_t)):   # K16a: FP64 too
        ops = K16A_FP64_OPS_PER_MCU * t.shape[0] * (-(-t.shape[1] // 16)) * (-(-t.shape[2] // 16))
        if ops / FP64_OPS_PER_S * 1e3 > r["bound_ms"]:
            r["bound_ms"], r["bound_by"] = ops / FP64_OPS_PER_S * 1e3, "operations"
    for r, (name, _, fk, *_) in zip(out_rows, specs):    # beside the eager ms
        r["device_ms"] = device_ms(fk, name, r["bound_ms"],    # the pack: memset + kernel
                                   2 if name.startswith("jpeg_pack") else 1)
    for r in out_rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches on its path)")
    rep["phase_s"] = time.perf_counter() - t_phase
    return out_rows


# -- sessions phase: multi-session H.264 serving (TPU_SESSIONS > 1) -----------

class SessionSource:
    """A seeded desktop for one session at any geometry: windows with
    glyph rows over a gradient, a text pane scrolling 6 pels a tick, a
    window moving (1, 3) pels a tick and a cursor; tick ``noisy_at`` is
    full noise (its P frame overflows the packer's caps).  ``frame()``
    returns the next tick's frame and its index."""

    def __init__(self, w: int, h: int, seed: int, noisy_at=None):
        import numpy as np

        self.width, self.height = w, h
        self.seed, self.noisy_at, self.t = seed, noisy_at, 0
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * 255 // (w - 1)), (yy * 255 // (h - 1)),
                         ((xx + yy + 40 * seed) * 255 // (w + h)) % 256],
                        axis=-1).astype(np.uint8)
        for _ in range(4):
            wh, ww = int(rng.integers(h // 6, h // 3)), int(rng.integers(w // 6, w // 3))
            y0, x0 = int(rng.integers(0, h - wh)), int(rng.integers(0, w - ww))
            base[y0:y0 + wh, x0:x0 + ww] = rng.integers(190, 250, 3)
            base[y0:y0 + 20, x0:x0 + ww] = rng.integers(40, 90, 3)
            for ty in range(y0 + 30, y0 + wh - 14, 16):
                marks = rng.random((ww - 24) // 8) < 0.7
                for j in np.flatnonzero(marks):
                    tx = x0 + 10 + 8 * int(j)
                    base[ty:ty + 8, tx:tx + 1 + int(rng.integers(1, 5))] = \
                        int(rng.integers(0, 60))
        self.base = base
        self.pane = (h // 5, w // 2, h // 3, w // 3)
        self.text = base[h // 5:h // 5 + h // 3, w // 2:w // 2 + w // 3].copy()
        self.noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def render(self, t: int):
        import numpy as np

        if t == self.noisy_at:
            return self.noise.copy()
        f = self.base.copy()
        y0, x0, ph, pw = self.pane
        f[y0:y0 + ph, x0:x0 + pw] = np.roll(self.text, -6 * t, axis=0)
        wy, wx = self.height // 2 + t, self.width // 8 + 3 * t
        f[wy:wy + self.height // 5, wx:wx + self.width // 6] = (40, 60, 110 + self.seed)
        f[wy + 24:wy + self.height // 5 - 8:6,
          wx + 8:wx + self.width // 6 - 8] = 220
        cy = (40 + 9 * t) % (self.height - 20)
        f[cy:cy + 18, self.width - 200:self.width - 190] = 255
        return f

    def frame(self):
        t = self.t
        self.t += 1
        return self.render(t), t


class _StepRecorder:
    """Wraps a manager's batched step: records each call's inputs (host
    planes, cloned references and slots) and outputs (flats on the host,
    cloned references) for the checks after the run."""

    def __init__(self, step, kind: str, calls: list):
        self.step, self.kind, self.calls = step, kind, calls

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args, **kw):
        import torch

        clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a.copy()
        rec = {"kind": self.kind, "args": [clone(a) for a in args], "kw": kw}
        out = self.step(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        rec["flat"] = outs[0].cpu()
        rec["refs"] = tuple(o.clone() for o in outs[1:])
        self.calls.append(rec)
        return out


def demux_fmp4(init: bytes, frags):
    """Annex-B access units from an fMP4 stream (``web/mp4``): the SPS
    and PPS from the init segment's avcC box, ahead of each IDR; each
    media segment's mdat of 4-byte length-prefixed NAL units."""
    import struct

    a = init.index(b"avcC") + 4
    n_sps = init[a + 5] & 0x1F
    q, params = a + 6, []
    for _ in range(n_sps):
        ln = struct.unpack(">H", init[q:q + 2])[0]
        params.append(init[q + 2:q + 2 + ln])
        q += 2 + ln
    for _ in range(init[q]):
        ln = struct.unpack(">H", init[q + 1:q + 3])[0]
        params.append(init[q + 3:q + 3 + ln])
        q += 2 + ln
    sc = b"\x00\x00\x00\x01"
    aus = []
    for frag in frags:
        pos, nals = 0, []
        while pos < len(frag):
            size, typ = struct.unpack(">I4s", frag[pos:pos + 8])
            if typ == b"mdat":
                body, q = frag[pos + 8:pos + size], 0
                while q < len(body):
                    n = struct.unpack(">I", body[q:q + 4])[0]
                    nals.append(body[q + 4:q + 4 + n])
                    q += 4 + n
            pos += size
        if nals and nals[0][0] & 0x1F == 5:
            nals = params + nals
        aus.append(b"".join(sc + x for x in nals))
    return aus


def sessions_run(chunk: int, ticks: int, kf_hub: int, kf_at: int):
    """One BucketedStreamManager on the card: SESS_S sessions at W x H and
    SESS_B2_N at SESS_B2, GOP 60, ``chunk`` (ENCODER_SUPERSTEP_CHUNK),
    subscribed, started, run for ``ticks`` ticks a bucket on its own
    encode threads, hub ``kf_hub`` asking for a keyframe after tick
    ``kf_at``.  Returns (manager, recorded step calls per bucket, each
    hub's received items, sources)."""
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    n = SESS_S + SESS_B2_N
    cfg = from_env({"SIZEW": str(W), "SIZEH": str(H), "TPU_SESSIONS": str(n),
                    "ENCODER_GOP": "60", "ENCODER_SUPERSTEP_CHUNK": str(chunk),
                    "REFRESH": "60"})
    sources = ([SessionSource(W, H, 20 + i, SESS_NOISY[1] if i == SESS_NOISY[0]
                              else None) for i in range(SESS_S)]
               + [SessionSource(*SESS_B2, 40 + i) for i in range(SESS_B2_N)])
    mgr = ms.BucketedStreamManager(cfg, sources)
    check(len(mgr.managers) == 2 and [len(m.sources) for m in mgr.managers]
          == [SESS_S, SESS_B2_N], "the sessions are not in two buckets")
    check(all(m.mesh_shape == (1, 1) and m.device.type == "cuda"
              for m in mgr.managers), "a bucket is not planned (1, 1) on the card")
    queues = [mgr.session(i).subscribe(maxsize=4 * ticks + 8) for i in range(n)]
    calls = []
    for m in mgr.managers:
        rec = []
        calls.append(rec)
        m.step = _StepRecorder(m.step, "intra", rec)
        m.p_step = _StepRecorder(m.p_step, "p", rec)
        if m.chunk_step is not None:
            m.chunk_step = _StepRecorder(m.chunk_step, "chunk", rec)
        orig, count = m._encode_tick, [0]

        def tick(ys, cbs, crs, _m=m, _orig=orig, _count=count):
            out = _orig(ys, cbs, crs)
            _count[0] += 1
            if _m is mgr.managers[0] and _count[0] == kf_at:
                mgr.session(kf_hub).request_keyframe()
            if _count[0] >= ticks:
                _m._stop.set()
            return out

        m._encode_tick = tick
        m._ticks = count
    mgr.start()
    t0 = time.perf_counter()
    while any(m._ticks[0] < ticks for m in mgr.managers):
        check(time.perf_counter() - t0 < 600, "the sessions run stalled")
        check(all(m._thread is not None and m._thread.is_alive()
                  or m._ticks[0] >= ticks for m in mgr.managers),
              "an encode thread died")
        time.sleep(0.05)
    mgr.stop()
    items = []
    for q in queues:
        got = []
        while not q.empty():
            got.append(q.get_nowait())
        items.append(got)
    return mgr, calls, items, sources


def verify_bucket(m, calls, qp: int, dev, expect_aus):
    """Every recorded batched call of one bucket against S single-session
    launches of the kernels (K1-K3 for 15b, K5-K7 for 15c, four chained
    K5-K7 per session for 15d, which must also equal four 15c calls);
    ``expect_aus[i]`` gathers session i's (AU, luma) in stream order, an
    overflowed frame left out.  Returns {kind: calls}."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
    from docker_nvidia_glx_desktop_tpu_torch.ops import (cavlc_device,
                                                         cavlc_p_device,
                                                         h264_device)

    S = len(m.sources)
    nr = m.rows_local
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    counts = {"intra": 0, "p": 0, "chunk": 0, "overflow": []}

    def deliver(i, flat, idr, luma):
        buf = flat.numpy()
        meta = cavlc_device.FlatMeta(buf, nr)
        if meta.overflow:
            counts["overflow"].append(i)
            return
        au = cavlc_device.assemble_annexb(
            buf, meta, headers=m._hub_headers[i] if idr else b"",
            nal_type=None if idr else syn.NAL_SLICE, ref_idc=3 if idr else 2)
        expect_aus[i].append((au, luma))

    def single_p(y, cb, cr, ref, hv, hl):
        flat, ny, ncb, ncr, _, _, _ = cavlc_p_device.encode_p_cavlc_frame(
            y, cb, cr, *ref, hv, hl, qp)
        return flat, (ny, ncb, ncr)

    for c in calls:
        counts[c["kind"]] += 1
        if c["kind"] == "intra":
            y, cb, cr = c["args"]
            hv, hl = m.step.slots[c["kw"].get("idr_parity", 0) & 1]
            for i in range(S):
                pl = [up(a[i]) for a in (y, cb, cr)]
                lv = h264_device.encode_intra_frame_yuv(*pl, qp)
                flat = cavlc_device.encode_levels(lv, hv, hl, qp)
                check(torch.equal(flat.cpu(), c["flat"][i, 0]),
                      f"15b session {i}: flat differs from the single-session kernels")
                rec = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
                check(all(torch.equal(a, b[i]) for a, b in zip(rec, c["refs"])),
                      f"15b session {i}: recon differs")
                deliver(i, c["flat"][i, 0], True, rec[0].cpu().numpy())
        elif c["kind"] == "p":
            y, cb, cr, ry, rcb, rcr, hv, hl = c["args"]
            hv_t, hl_t = up(hv.view(np.int32)), up(hl)
            for i in range(S):
                pl = [up(a[i]) for a in (y, cb, cr)]
                flat, ref = single_p(*pl, (ry[i], rcb[i], rcr[i]), hv_t, hl_t)
                check(torch.equal(flat.cpu(), c["flat"][i, 0]),
                      f"15c session {i}: flat differs from the single-session kernels")
                check(all(torch.equal(a, b[i]) for a, b in zip(ref, c["refs"])),
                      f"15c session {i}: reference differs")
                deliver(i, c["flat"][i, 0], False, ref[0].cpu().numpy())
        else:
            ys, cbs, crs, ry, rcb, rcr, hv, hl = c["args"]
            k = ys.shape[1]
            # four 15c calls on the same inputs
            refs = (ry, rcb, rcr)
            for j in range(k):
                f15c, *refs = m.p_step.step(ys[:, j], cbs[:, j], crs[:, j],
                                            *refs, hv[j], hl[j])
                check(torch.equal(f15c.cpu(), c["flat"][:, j]),
                      f"15d frame {j}: flats differ from the 15c step's")
            check(all(torch.equal(a, b) for a, b in zip(refs, c["refs"])),
                  "15d: references differ from four 15c calls'")
            for i in range(S):
                ref = (ry[i], rcb[i], rcr[i])
                for j in range(k):
                    pl = [up(a[i, j]) for a in (ys, cbs, crs)]
                    flat, ref = single_p(*pl, ref, up(hv[j].view(np.int32)),
                                         up(hl[j]))
                    check(torch.equal(flat.cpu(), c["flat"][i, j, 0]),
                          f"15d session {i} frame {j}: flat differs from the "
                          "single-session kernels")
                    deliver(i, c["flat"][i, j, 0], False, ref[0].cpu().numpy())
                check(all(torch.equal(a, b[i]) for a, b in zip(ref, c["refs"])),
                      f"15d session {i}: references differ")
    return counts


def decode_session(items, expect, w: int, h: int, label: str) -> int:
    """Session ``label``'s fMP4 fragments, demuxed to Annex-B: equal to
    the expected access units, decoded by cv2 with each luma plane equal
    to the expected reconstruction.  Returns the frames decoded."""
    import numpy as np

    init = next(it[1] for it in items if it[0] == "init")
    frags = [it[1] for it in items if it[0] == "frag"]
    aus = demux_fmp4(init, frags)
    check(len(aus) == len(expect) and all(a == e[0] for a, e in zip(aus, expect)),
          f"{label}: the hub's {len(aus)} access units differ from the "
          f"{len(expect)} checked ones")
    try:
        import cv2
    except ImportError:
        return 0
    path = os.path.join(HERE, "chiprun_out", f"session_{label}.264")
    with open(path, "wb") as f:
        f.write(b"".join(aus))
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, (_, luma) in enumerate(expect):
        ok, img = cap.read()
        check(ok, f"{label}: cv2 stopped decoding at frame {i}")
        check(np.array_equal(np.asarray(img).reshape(h, w), luma[:h, :w]),
              f"{label}: decoded luma {i} differs from the reconstruction")
    cap.release()
    os.remove(path)
    return len(expect)


def sessions_timed(s: int, chunk: int, ticks: int):
    """A BatchStreamManager of ``s`` sessions at W x H driven tick by tick
    on this thread (the body of its encode loop): tick submit and collect
    ms (its histograms' samples), the host clock's split of a tick into
    the synthetic sources' render, host colour and stacking, the step
    with its pull, and AU assembly with the fMP4 fragments, and frames/s
    with and without the render (which a real capture replaces); the
    first tick (IDR, builds, the capture) excluded."""
    import numpy as np

    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    class Tap:
        def __init__(self):
            self.v = []

        def observe(self, x):
            self.v.append(x)

    cfg = from_env({"SIZEW": str(W), "SIZEH": str(H), "TPU_SESSIONS": str(s),
                    "ENCODER_GOP": "60", "ENCODER_SUPERSTEP_CHUNK": str(chunk)})
    srcs = [SessionSource(W, H, 60 + i) for i in range(s)]
    m = ms.BatchStreamManager(cfg, srcs)
    saved = ms._M_BATCH_SUBMIT, ms._M_BATCH_COLLECT
    ms._M_BATCH_SUBMIT, ms._M_BATCH_COLLECT = sub, col = Tap(), Tap()
    split = {"render": 0.0, "colour": 0.0, "step": 0.0, "deliver": 0.0}
    try:
        for t in range(ticks):
            t0 = time.perf_counter()
            frames = [src.frame()[0] for src in srcs]
            t1 = time.perf_counter()
            pl = [m._planes(f, i) for i, f in enumerate(frames)]
            ys, cbs, crs = (np.stack([p[k] for p in pl]) for k in range(3))
            t2 = time.perf_counter()
            out = m._encode_tick(ys, cbs, crs)
            t3 = time.perf_counter()
            for flat, idr, jm in out:
                m._deliver_tick(flat, idr, 1.0, jm)
            t4 = time.perf_counter()
            if t:
                for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    split[k] += v
    finally:
        ms._M_BATCH_SUBMIT, ms._M_BATCH_COLLECT = saved
    pool = m.chunk_step.pool_bytes if m.chunk_step else 0
    m.close()
    n = (ticks - 1) * s
    wall = sum(split.values())
    return {"sessions": s, "chunk": chunk, "ticks": ticks,
            "submit_p50_ms": statistics.median(sub.v[1:]),
            "collect_p50_ms": statistics.median(col.v[1:]),
            "tick_split_ms": {k: v / (ticks - 1) * 1e3 for k, v in split.items()},
            "aggregate_fps": n / wall, "per_session_fps": n / wall / s,
            "serving_fps": n / (wall - split["render"]), "pool_bytes": pool}


def sessions_phase(report):
    """``TPU_SESSIONS`` > 1 at 1080p (BASELINE config 5: eight sessions)
    plus a second bucket of two 1280x720 sessions, served by
    ``BucketedStreamManager`` on its encode threads, GOP 60 per tick
    (chunk 0) and then in chunk rings of 4: every batched call held to
    the single-session kernels on every session (15b, 15c, 15d, and 15d
    to four 15c calls), the deblock form of 15c held the same way,
    session 0 of an IDR and a P tick and every session of one chunk to
    the plain versions, each hub's fMP4 stream demuxed, equal to the
    checked access units and decoded by cv2; the link probe (K17g) sets
    the ledger's rtt and is held to its plain loop."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.obs.budget import LEDGER
    from docker_nvidia_glx_desktop_tpu_torch.ops import (bitmerge, cavlc_device,
                                                         cavlc_p_device, devloop,
                                                         h264_deblock,
                                                         h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch

    rep = report["sessions"] = {}
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    steps = {"h264_batch_intra": batch.IntraBatchStep,
             "h264_batch_p": batch.PBatchStep,
             "h264_batch_p_chunk": batch.PChunkBatchStep,
             "link_probe": devloop.probe_loop}
    named = {"intra": h264_device.encode_intra_frame_yuv,
             "cavlc_slots": cavlc_device.frame_block_slots,
             "pack": bitmerge.pack_frame, "inter": h264_inter.encode_p_frame,
             "cavlc_p_slots": cavlc_p_device.p_frame_slots,
             "pack_p": bitmerge.pack_p_frame}

    # -- main path: both configurations and the probe, counted -----------------
    zero_counts(named)
    zero_counts(steps)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for chunk in (0, SESS_CHUNK):
        runs[chunk] = sessions_run(chunk, SESS_TICKS, SESS_KF_HUB, SESS_KF_AT)
    probe = LEDGER.probe_link()
    torch.cuda.synchronize()
    launches = path_launches(named)
    step_launches = {k: v.launches for k, v in steps.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    check(LEDGER.link_rtt_ms == probe["rtt_ms"], "the ledger's link rtt is not the probe's")
    print(f"sessions main: {SESS_S} x {W}x{H} + {SESS_B2_N} x {SESS_B2[0]}x"
          f"{SESS_B2[1]} sessions, {SESS_TICKS} ticks a bucket, chunk 0 and "
          f"{SESS_CHUNK}; step launches {step_launches}; kernel launches "
          f"{launches}; link rtt {probe['rtt_ms']:.3f} ms (step "
          f"{probe['step_us']:.3f} us)")

    # -- every batched call against the single-session kernels -----------------
    qp = runs[0][0].managers[0].step.qp
    totals = {"intra": 0, "p": 0, "chunk": 0}
    decoded = 0
    captures = 0
    for chunk, (mgr, calls, items, sources) in runs.items():
        for b, (m, c) in enumerate(zip(mgr.managers, calls)):
            expect = [[] for _ in m.sources]
            counts = verify_bucket(m, c, qp, dev, expect)
            for k in totals:
                totals[k] += counts[k]
            if m.chunk_step is not None and m.chunk_step.graph is not None:
                captures += 1
            base = 0 if b == 0 else SESS_S
            for i in range(len(m.sources)):
                decoded += decode_session(items[base + i], expect[i],
                                          m.sources[i].width,
                                          m.sources[i].height,
                                          f"c{chunk}b{b}s{i}")
            if b == 0:
                intras = counts["intra"]
                check(intras >= 3, f"chunk {chunk}: bucket 0 ran {intras} IDR "
                      "ticks (the join, the keyframe request, the overflow)")
                # the noise frame overflows; in a chunk, so may the frames
                # after it that predict from its recon (the re-key waits
                # for the chunk's end, as in the reference)
                ovf = counts["overflow"]
                check(ovf and set(ovf) == {SESS_NOISY[0]}
                      and (len(ovf) == 1 or chunk),
                      f"chunk {chunk}: overflowed frames in sessions {ovf}")
                n_frag = [sum(1 for it in items[i] if it[0] == "frag")
                          for i in range(SESS_S)]
                want_frag = [max(n_frag) - (len(ovf) if i == SESS_NOISY[0]
                                            else 0) for i in range(SESS_S)]
                check(n_frag == want_frag, f"chunk {chunk}: fragments per "
                      f"hub {n_frag}: an overflow dropped another session's "
                      "frame")
            else:
                check(counts["intra"] == 1 and not counts["overflow"],
                      f"chunk {chunk}: the second bucket was re-keyed")
            if chunk:
                check(counts["chunk"] >= 2, f"bucket {b}: {counts['chunk']} chunks")
        rep[f"chunk{chunk}"] = {
            "pool_bytes": [m.chunk_step.pool_bytes if m.chunk_step else 0
                           for m in mgr.managers]}
    print(f"(a) sessions: {totals['intra']} 15b, {totals['p']} 15c and "
          f"{totals['chunk']} 15d calls equal to the single-session kernels on "
          f"every session (flats and references; 15d also to four 15c calls); "
          f"{decoded} frames of {2 * (SESS_S + SESS_B2_N)} demuxed streams "
          "decoded by cv2 equal to the reconstructions")
    n_intra, n_p, n_chunk = totals["intra"], totals["p"], totals["chunk"]
    want = {"intra": n_intra, "cavlc_slots": n_intra, "pack": n_intra,
            "inter": n_p + SESS_CHUNK * (n_chunk + captures),
            "cavlc_p_slots": n_p + SESS_CHUNK * (n_chunk + captures),
            "pack_p": n_p + SESS_CHUNK * (n_chunk + captures)}
    check(launches == want, f"sessions launches {launches}, want {want}")
    check(step_launches["h264_batch_intra"] == n_intra
          and step_launches["h264_batch_p"] == n_p
          and step_launches["h264_batch_p_chunk"] == n_chunk
          and step_launches["link_probe"] >= 9,
          f"step launches {step_launches}")

    # -- session 0 against the plain versions; the deblock form of 15c ---------
    m0 = runs[0][0].managers[0]
    c0 = runs[0][1][0]
    ci = next(c for c in c0 if c["kind"] == "intra")
    cp = next(c for c in c0 if c["kind"] == "p")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    y8, cb8, cr8 = (up(a) for a in ci["args"])
    hv_i, hl_i = m0.step.slots[ci["kw"].get("idr_parity", 0) & 1]
    pi = batch.h264_intra_batch_plain(y8[:1], cb8[:1], cr8[:1], hv_i, hl_i, qp,
                                      with_recon=True)
    e15b = max_diff(zip(pi, [ci["flat"][:1]] + [r[:1] for r in ci["refs"]]))
    check(e15b == 0, f"15b session 0 differs from the plain version by {e15b}")
    py8, pcb8, pcr8, pry, prcb, prcr, phv, phl = cp["args"]
    pargs = [up(a) for a in (py8, pcb8, pcr8)] + [pry, prcb, prcr] + [
        up(phv.view(np.int32)), up(phl)]
    pp = batch.h264_p_batch_plain(*[a[:1] for a in pargs[:6]], *pargs[6:], qp)
    e15c = max_diff(zip(pp, [cp["flat"][:1]] + [r[:1] for r in cp["refs"]]))
    check(e15c == 0, f"15c session 0 differs from the plain version by {e15c}")
    dstep, _ = batch.h264_p_batch_step(H_PAD, W, qp=qp, deblock=True)
    dflat, *drefs = dstep(*pargs)
    for i in range(SESS_S):
        flat, ny, ncb, ncr, mv, nnz, _ = cavlc_p_device.encode_p_cavlc_frame(
            pargs[0][i], pargs[1][i], pargs[2][i], pry[i], prcb[i], prcr[i],
            pargs[6], pargs[7], qp)
        want_ref = h264_deblock.deblock_frame(ny, ncb, ncr, qp, nnz_blk=nnz, mv=mv)
        check(torch.equal(flat, dflat[i, 0])
              and all(torch.equal(a, b[i]) for a, b in zip(want_ref, drefs)),
              f"15c deblock session {i}: differs from the single-session K5-K8")
    # 15d: every session of one chunk through the plain 15c chain (timed
    # as the row's plain version)
    mc = runs[SESS_CHUNK][0].managers[0]
    cc = next(c for c in runs[SESS_CHUNK][1][0] if c["kind"] == "chunk")
    kys, kcbs, kcrs, kry, krcb, krcr, khv, khl = cc["args"]
    chain = []

    def plain_chain():
        ref, flats = (kry, krcb, krcr), []
        for j in range(SESS_CHUNK):
            f, *ref = batch.h264_p_batch_plain(
                up(kys[:, j]), up(kcbs[:, j]), up(kcrs[:, j]), *ref,
                up(khv[j].view(np.int32)), up(khl[j]), qp)
            flats.append(f)
        chain[:] = [torch.stack(flats, 1)] + ref

    d_plain = cuda_ms(plain_chain, reps=1, warm=0)
    e15d = max_diff(zip(chain, [cc["flat"]] + list(cc["refs"])))
    check(e15d == 0, f"15d differs from the plain 15c chain by {e15d}")
    print("(b) sessions: session 0 of an IDR tick and a P tick, and every "
          f"session of a chunk of {SESS_CHUNK}, equal to the plain versions; "
          f"15c with deblock=True equal to K5-K8 on all {SESS_S} sessions")

    # -- the encoder's prewarm: libraries loaded, the ring's graph captured
    # at the IDR, before the first chunk; the stream equal to a twin's -----
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    pcfg = from_env({"SIZEW": str(W), "SIZEH": str(H),
                     "ENCODER_SUPERSTEP_CHUNK": str(SESS_CHUNK)})
    warm, _ = make_encoder(pcfg, W, H)
    twin, _ = make_encoder(pcfg, W, H)
    th, stop = warm.prewarm_async()
    th.join(300)
    check(not th.is_alive() and warm._prewarm_ring
          and all(n in _cuda._libs for n in _cuda.KERNEL_SOURCES),
          "prewarm did not load every kernel library")
    pframes = [SessionSource(W, H, 90).render(t) for t in range(1 + SESS_CHUNK)]
    got = [warm.encode_submit(pframes[0])]
    check(warm._graphs.captures == 1, "prewarm: no graph captured at the IDR")
    got += [warm.encode_submit(f) for f in pframes[1:]]
    check(warm._graphs.captures == 1 and warm._graphs.replays == 1,
          "prewarm: the first chunk did not replay the prewarmed graph")
    twin_toks = [twin.encode_submit(f) for f in pframes]
    want = [twin.encode_collect(t).data for t in twin_toks]
    check([warm.encode_collect(t).data for t in got] == want,
          "prewarm: the stream differs from an encoder's without prewarm")
    print(f"(e) sessions: prewarm loaded {len(_cuda.KERNEL_SOURCES)} kernel "
          "libraries and captured the ring's graph at the IDR; the first "
          "chunk replayed it; the AUs equal a twin's without prewarm")

    # -- kernel rows at S = SESS_S, W x H_PAD --------------------------------
    nmb = (H_PAD // 16) * (W // 16)
    flat_used = lambda flats: sum(
        4096 + 4 * cavlc_device.FlatMeta(f.numpy(), H_PAD // 16).total_words
        for f in flats.reshape(-1, flats.shape[-1]))
    k_ms = cuda_ms(lambda: m0.step.step(y8, cb8, cr8), reps=10)
    k_plain = cuda_ms(lambda: batch.h264_intra_batch_plain(
        y8, cb8, cr8, hv_i, hl_i, qp, with_recon=True), reps=1, warm=0)
    r15b = kernel_row("h264_batch_intra", "", "parallel/batch.py:276 "
                      f"h264_batch_encode_step (S={SESS_S}, with_recon)",
                      step_launches["h264_batch_intra"], e15b, k_ms, k_plain,
                      nbytes(y8, cb8, cr8, *ci["refs"]) + flat_used(ci["flat"]))
    p_ms = cuda_ms(lambda: m0.p_step.step(*pargs), reps=10)
    p_plain = cuda_ms(lambda: batch.h264_p_batch_plain(*pargs, qp), reps=1,
                      warm=0)
    p_bytes = (nbytes(*pargs[:6], *cp["refs"]) + flat_used(cp["flat"]))
    r15c = kernel_row("h264_batch_p", "", "parallel/batch.py:376 "
                      f"h264_p_batch_step (S={SESS_S})",
                      step_launches["h264_batch_p"], e15c, p_ms, p_plain,
                      p_bytes, SESS_S * k5_ops(nmb))
    cstep = mc.chunk_step.step
    cstep.release()
    cstep(*cc["args"])
    g_ms = cuda_ms(cstep.graph.replay, reps=10)
    cys, ccbs, ccrs, chv, chl, cry, crcb, crcr = cstep.inputs
    e_ms = cuda_ms(lambda: cstep.body(cys, ccbs, ccrs, cry, crcb, crcr, chv,
                                      chl), reps=2)
    cstep.release()
    rep["eager_chunk_ms"] = e_ms
    r15d = kernel_row("h264_batch_p_chunk", "", "parallel/batch.py:470 "
                      f"h264_p_chunk_batch_step (S={SESS_S}, K={SESS_CHUNK}, "
                      "graph replay; plain: the plain 15c chain)",
                      step_launches["h264_batch_p_chunk"], e15d, g_ms, d_plain,
                      nbytes(*cstep.inputs, *cc["refs"]) + flat_used(cc["flat"]),
                      SESS_S * SESS_CHUNK * k5_ops(nmb))
    x = torch.arange(64, dtype=torch.uint8, device=dev).reshape(8, 8)
    xc = x.cpu()
    e17g = max_diff((devloop.probe_loop(x, k), devloop.probe_loop_plain(xc, k))
                    for k in (1, 9, 257))
    check(e17g == 0, f"K17g differs from its plain loop by {e17g}")
    pr_ms = cuda_ms(lambda: devloop.probe_loop(x, 1), reps=20)
    t = time.perf_counter()
    for _ in range(20):
        devloop.probe_loop_plain(xc, 1)
    pr_plain = (time.perf_counter() - t) / 20 * 1e3
    r17g = kernel_row("link_probe", "probe.cu", "devloop.py:406 _probe_loop "
                      "(:417 measure_link_rtt; ms includes the 4-byte pull)",
                      step_launches["link_probe"], e17g, pr_ms, pr_plain,
                      64 + 4, 1.0)
    for r in (r15b, r15c, r15d):
        r["source"] = "docker_nvidia_glx_desktop_tpu_torch/parallel/batch.py"
    rows = [r15b, r15c, r15d, r17g]
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches on its path; max abs err "
              f"{r['max_abs_err']})")
    print(f"kernel h264_batch_p_chunk: the eager body {e_ms:.4f} ms against "
          f"the replay {g_ms:.4f} ms [{smi_line()}]")

    # -- batched against S single-session launches: K1 and K5 ---------------------
    k1_b = cuda_ms(lambda: h264_device.encode_intra_frame_yuv(y8, cb8, cr8, qp), reps=10)
    k1_1 = cuda_ms(lambda: h264_device.encode_intra_frame_yuv(y8[0], cb8[0], cr8[0], qp),
                   reps=10)
    k5_b = cuda_ms(lambda: h264_inter.encode_p_frame(*pargs[:6], qp), reps=10)
    k5_1 = cuda_ms(lambda: h264_inter.encode_p_frame(*[a[0] for a in pargs[:6]], qp),
                   reps=10)
    rep["k1"] = {"batched_ms": k1_b, "single_ms": k1_1, "blocks": SESS_S * H_PAD // 16}
    rep["k5"] = {"batched_ms": k5_b, "single_ms": k5_1, "blocks": SESS_S * nmb}
    print(f"sessions K1 at S={SESS_S}: {k1_b:.3f} ms against {SESS_S} x "
          f"{k1_1:.3f} = {SESS_S * k1_1:.3f} ms single ({SESS_S * H_PAD // 16} "
          f"blocks a launch against 132 SMs; one session: {H_PAD // 16}); K5: "
          f"{k5_b:.3f} ms against {SESS_S} x {k5_1:.3f} = {SESS_S * k5_1:.3f} ms "
          f"({SESS_S * nmb} blocks; one session: {nmb}) [{smi_line()}]")

    # -- timed runs: S = 1, 2, 4, 8 per tick, and S = 8 in chunks ---------------
    timed = [sessions_timed(s, 0, SESS_TIMED_TICKS) for s in SESS_TIMED_S]
    timed.append(sessions_timed(SESS_S, SESS_CHUNK, 1 + 3 * SESS_CHUNK))
    rep["timed"] = timed
    card = smi_line()
    for tr in timed:
        sp = tr["tick_split_ms"]
        print(f"sessions timed S={tr['sessions']} chunk {tr['chunk']}: tick submit "
              f"p50 {tr['submit_p50_ms']:.2f} ms, collect p50 "
              f"{tr['collect_p50_ms']:.2f} ms; {tr['aggregate_fps']:.1f} frames/s "
              f"aggregate, {tr['per_session_fps']:.1f} per session, "
              f"{tr['serving_fps']:.1f} without the sources' render; a tick: "
              f"render {sp['render']:.2f}, colour {sp['colour']:.2f}, step "
              f"{sp['step']:.2f}, deliver {sp['deliver']:.2f} ms (host clock, "
              f"{tr['ticks'] - 1} ticks after the first) [{card}]")
    pools = {k: v["pool_bytes"] for k, v in rep.items() if k.startswith("chunk")}
    print(f"sessions: chunk graph pools per bucket {pools[f'chunk{SESS_CHUNK}']} "
          f"bytes; peak device memory {peak_mem / 2**20:.1f} MiB over the main "
          f"run; link rtt {probe['rtt_ms']:.3f} ms [{smi_line()}]")
    rep.update(launches=launches, step_launches=step_launches, probe=probe,
               peak_mem=peak_mem, decoded=decoded, phase_s=time.perf_counter() - t_phase)
    for mgr, *_ in runs.values():
        mgr.close()
    return rows


class StepRecorder:
    """A spatial step that records each call's inputs (CUDA tensors and
    host arrays, cloned) and outputs for the checks after the run."""

    def __init__(self, step, calls: list):
        self.step, self.calls = step, calls

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args):
        import torch

        clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a.copy()
        rec = {"args": [clone(a) for a in args], "qp": self.step.qp}
        out = self.step(*args)
        rec["out"] = out[:5]
        rec["levels"] = {k: v.clone() for k, v in out[5].items()}
        self.calls.append(rec)
        return out


def spatial_env(nx: int, **extra) -> dict:
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": str(SP_FRAMES)}
    if nx > 1:
        env["ENCODER_SPATIAL_SHARDS"] = str(nx)
    env.update(extra)
    return env


def spatial_encoder(nx: int, **extra):
    """``make_encoder`` at 1080p with ENCODER_SPATIAL_SHARDS=nx over the
    shard devices [cuda:0] * nx (nx = 1: the knob off)."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    from docker_nvidia_glx_desktop_tpu_torch.parallel.batch import indexed_device

    dev = torch.device(SP_DEVICE)
    enc, _ = make_encoder(from_env(spatial_env(nx, **extra)), W, H,
                          device=dev, spatial_devices=[indexed_device(dev)] * nx)
    check(enc._spatial_nx == nx, f"ENCODER_SPATIAL_SHARDS={nx}: the encoder "
          f"resolved {enc._spatial_nx} shards")
    return enc


def spatial_run(nx: int, frames, env_knobs=None, **extra):
    """One stream through a spatial encoder and through its unsharded
    twin (the knob off); returns (encoder, AUs, the twin's AUs)."""
    old = {k: os.environ.get(k) for k in (env_knobs or {})}
    os.environ.update(env_knobs or {})
    try:
        enc = spatial_encoder(nx, **extra)
        aus = drive(enc, frames)[1]
        twin = spatial_encoder(1, **extra)
        want = drive(twin, frames)[1]
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return enc, aus, want


def decoded_frames(aus) -> int:
    """Frames cv2 decodes from an Annex-B stream (-1 without cv2)."""
    try:
        import cv2
    except ImportError:
        return -1
    path = os.path.join(HERE, "chiprun_out", "spatial.h264")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(aus))
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def spatial_phase(report):
    """``ENCODER_SPATIAL_SHARDS`` at 1080p: first on one card with the
    default shard devices (the knob serves unsharded, as the reference's
    resolution gives there), then over the shard devices [cuda:0] * nx
    for nx = 2 and 4: CAVLC and CABAC with device binarization, deblock
    on, per frame and in a chunk-of-4 ring, the served tune tier, and a
    masked run on the damage frames — every stream byte-equal to the
    unsharded encoder's, one decoded by cv2.  Then 15e, 13s and K5p
    against their plain versions at 1080p shapes, one IDR of 15f, one P
    frame of 15g (and of the masked 15g) and one chunk of 15h against
    the plain steps, 15h's replay against its eager body, and frames/s
    and p50 at nx = 1, 2, 4."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import (damage_mask, devloop,
                                                         h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    rep = report["spatial"] = {}
    t_phase = time.perf_counter()
    dev = torch.device(SP_DEVICE)
    hp = -(-H // 16) * 16
    frames = gop_frames(SP_FRAMES, seed=21)

    # -- the repair: the knob on one card (the default shard devices) ------------
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    one, _ = make_encoder(from_env(spatial_env(2)), W, H, device=dev)
    check(one._spatial_nx == 1 and len(one.spatial_devices) == 1,
          f"ENCODER_SPATIAL_SHARDS=2 on one card resolved {one._spatial_nx} "
          f"shards over {one.spatial_devices}")
    plain_enc, _ = make_encoder(from_env(spatial_env(1)), W, H, device=dev)
    check(drive(one, frames[:3])[1] == drive(plain_enc, frames[:3])[1],
          "ENCODER_SPATIAL_SHARDS=2 on one card: AUs differ from the knob off")
    print("spatial: ENCODER_SPATIAL_SHARDS=2 on one card serves unsharded "
          "(one shard device), its AUs equal to the knob off")

    # -- main path: every configuration, counted -----------------------------
    named = {"halo_pad": batch.spatial_halo_pad,
             "force_skip": damage_mask.force_skip_rows,
             "inter_padded": h264_inter.encode_p_frame_padded_ref,
             "h264_sp_intra": batch.SpatialIntraStep,
             "h264_sp_p": batch.SpatialPStep,
             "h264_sp_chunk": devloop.ChunkStep.spatial}
    zero_counts(named)
    runs, masked_calls = {}, []
    dmg_frames = damage_frames(DAMAGE_FRAMES)
    for nx in SP_NX:
        runs[f"cavlc{nx}"] = spatial_run(nx, frames)
        runs[f"ring{nx}"] = spatial_run(nx, frames, ENCODER_SUPERSTEP_CHUNK="4")
        runs[f"cabac{nx}"] = spatial_run(
            nx, frames, {"ENCODER_CABAC_BINARIZE": "device"},
            ENCODER_ENTROPY="cabac")
    runs["cabac_ring2"] = spatial_run(
        2, frames, {"ENCODER_CABAC_BINARIZE": "device"},
        ENCODER_ENTROPY="cabac", ENCODER_SUPERSTEP_CHUNK="4")
    runs["hq2"] = spatial_run(2, frames, ENCODER_TUNE="hq")

    # the masked run records its P steps' calls
    os.environ["DNGD_DAMAGE_MASK"] = "true"
    try:
        menc = spatial_encoder(2, ENCODER_GOP=str(DAMAGE_FRAMES))
        orig = menc._sp_step

        def recorded(kind, qp):
            st = orig(kind, qp)
            return StepRecorder(st, masked_calls) if kind == "p_masked" else st

        menc._sp_step = recorded
        m_aus = drive(menc, dmg_frames)[1]
        mtwin = spatial_encoder(1, ENCODER_GOP=str(DAMAGE_FRAMES))
        m_want = drive(mtwin, dmg_frames)[1]
    finally:
        os.environ.pop("DNGD_DAMAGE_MASK", None)
    runs["masked2"] = (menc, m_aus, m_want)
    torch.cuda.synchronize()
    launches = path_launches(named)
    print(f"spatial main: {W}x{H}, nx {SP_NX}, {len(runs)} streams; launches "
          f"{launches}")
    for name, (enc, aus, want) in runs.items():
        check(len(aus) == len(want) and aus == want,
              f"spatial {name}: AUs differ from the unsharded encoder's")
    check(all(launches[k] > 0 for k in named), f"spatial: a kernel of the path "
          f"was not launched: {launches}")
    check(len(masked_calls) >= 2, f"spatial masked: {len(masked_calls)} masked P "
          "steps (the gate never ran)")
    n_dec = decoded_frames(runs["cavlc4"][1])
    check(n_dec in (-1, SP_FRAMES), f"spatial: cv2 decoded {n_dec} of "
          f"{SP_FRAMES} frames")
    print(f"(b) spatial: {len(runs)} sharded streams (CAVLC and CABAC-device at "
          f"nx {SP_NX}, per frame and in chunk-4 rings, hq_noaq, masked) "
          f"byte-equal to the unsharded encoder's; cv2 decoded {n_dec} frames "
          "of the nx=4 stream")

    # -- 15e, 13s and K5p against their plain versions at 1080p ------------------
    penc = runs["cavlc2"][0]
    ry, rcb, rcr = (p.clone() for p in penc._ref)
    cpu = lambda t: t.cpu()
    e15e = 0.0
    for nx in SP_NX:
        for halo in (True, False):
            got = batch.spatial_halo_pad(ry, rcb, rcr, nx, halo)
            want = batch.spatial_halo_pad_plain(cpu(ry), cpu(rcb), cpu(rcr), nx,
                                                halo)
            e15e = max(e15e, max_diff(zip(got, want)))
    check(e15e == 0, f"15e differs from its plain version by {e15e}")
    nx = 2
    pads = batch.spatial_halo_pad(ry, rcb, rcr, nx)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    y, cb, cr = (up(p) for p in rgb_to_yuv420_host(frames[-1], hp, W))
    sv = lambda t: t.view((nx, t.shape[0] // nx) + tuple(t.shape[1:]))
    qp = 26
    e5p = 0.0
    for tune, p_intra in (("off", False), ("hq_noaq", False), ("hq", True)):
        got = h264_inter.encode_p_frame_padded_ref(
            sv(y), sv(cb), sv(cr), *pads, qp, tune=tune, p_intra=p_intra)
        qmap = got.get("qp_map")
        want = [h264_inter.encode_p_frame_padded_ref_plain(
            cpu(sv(y)[s]), cpu(sv(cb)[s]), cpu(sv(cr)[s]),
            *(cpu(p[s]) for p in pads), qp, tune,
            None if qmap is None else cpu(qmap[s]), p_intra) for s in range(nx)]
        e5p = max(e5p, max_diff((got[k][s], want[s][k]) for k in want[0]
                                for s in range(nx)))
    check(e5p == 0, f"K5p differs from its plain version by {e5p}")
    core = h264_inter.encode_p_frame_padded_ref(sv(y), sv(cb), sv(cr), *pads, qp)
    out = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in core.items()}
    keep = torch.tensor([(r // 3) % 2 == 0 for r in range(hp // 16)],
                        device=dev)
    got = damage_mask.force_skip_rows({k: v.clone() for k, v in out.items()},
                                      keep, ry, rcb, rcr)
    want = damage_mask.force_skip_rows_plain(
        {k: cpu(v) for k, v in out.items()}, cpu(keep), cpu(ry), cpu(rcb),
        cpu(rcr))
    e13s = max_diff((got[k], want[k]) for k in want)
    check(e13s == 0, f"13s differs from its plain version by {e13s}")
    print(f"(a) spatial: 15e (nx {SP_NX}, halo on and off), K5p (tune off, "
          "hq_noaq, hq with I16-in-P) and 13s equal to their plain versions "
          "at 1080p")

    # -- 15f, 15g (and masked) and 15h against the plain steps -------------------
    mesh = batch.make_spatial_mesh(nx, [dev] * nx)
    hv_i, hl_i = penc._sp_hdr_slots(True, 0, 1, 0)
    hv_p, hl_p = penc._sp_hdr_slots(False, 1, 0, 0)
    istep, _ = batch.h264_spatial_intra_step(mesh, hp, W, qp, deblock=True)
    pstep, _ = batch.h264_spatial_step(mesh, hp, W, qp, deblock=True)
    t0 = time.perf_counter()
    iw = batch.h264_spatial_intra_plain(y, cb, cr, hv_i, hl_i, qp, nx,
                                        deblock=True)
    f_plain = (time.perf_counter() - t0) * 1e3
    ig = istep(y, cb, cr, hv_i, hl_i)
    e15f = max_diff(zip(ig, iw))
    check(e15f == 0, f"15f differs from the plain step by {e15f}")
    t0 = time.perf_counter()
    pw = batch.h264_spatial_p_plain(y, cb, cr, ry, rcb, rcr, hv_p, hl_p, qp, nx,
                                    deblock=True)
    g_plain = (time.perf_counter() - t0) * 1e3
    pg = pstep(y, cb, cr, ry, rcb, rcr, hv_p, hl_p)
    e15g = max(max_diff(zip(pg[:5], pw[:5])),
               max_diff((pg[5][k], pw[5][k]) for k in pw[5]))
    check(e15g == 0, f"15g differs from the plain step by {e15g}")
    mc = masked_calls[len(masked_calls) // 2]
    mw = batch.h264_spatial_p_plain(*mc["args"][:8], mc["qp"], nx,
                                    deblock=True, keep=mc["args"][8])
    e15m = max(max_diff(zip(mc["out"], mw[:5])),
               max_diff((mc["levels"][k], mw[5][k]) for k in mw[5]))
    check(e15m == 0, f"the masked 15g differs from the plain step by {e15m}")
    check(not bool(mc["args"][8].all()), "the checked masked step gated no row")

    class Holder:
        released = False

    K = 4
    cstep = batch.h264_spatial_chunk_step(mesh, hp, W, K, deblock=True)
    kframes = [rgb_to_yuv420_host(f, hp, W) for f in frames[1:1 + K]]
    khv, khl = penc._chunk_hdr_slots(tuple(range(1, K + 1)), 0)
    holder = Holder()
    devloop.ChunkStep.spatial.launches = 0
    hout = cstep(kframes, (ry, rcb, rcr), khv, khl, None, qp, owner=holder)
    check(devloop.ChunkStep.spatial.launches == 1 and cstep.instances,
          "15h: the chunk did not replay a captured graph")
    eout = cstep.run_eager(kframes, (ry, rcb, rcr), khv, khl, None, qp)
    e_rep = max(max_diff(zip(hout.flats, eout.flats)),
                max_diff(zip(hout.refs, eout.refs)),
                max_diff([(hout.mvs, eout.mvs)]),
                max_diff((hout.lvs[k], eout.lvs[k]) for k in eout.lvs))
    check(e_rep == 0, f"15h's replay differs from its eager body by {e_rep}")
    t0 = time.perf_counter()
    ref = (ry, rcb, rcr)
    chain = []
    for k in range(K):
        kp = [up(a) for a in kframes[k]]
        f, *ref = batch.h264_spatial_p_plain(*kp, *ref, khv[k], khl[k], qp, nx,
                                             deblock=True)[:4]
        chain.append(f)
    h_plain = (time.perf_counter() - t0) * 1e3
    e15h = max(max_diff(zip(hout.flats, chain)), max_diff(zip(hout.refs, ref)))
    check(e15h == 0, f"15h differs from the plain 15g chain by {e15h}")
    print("(a) spatial: one IDR of 15f, one P frame of 15g and of the masked "
          f"15g, and a chunk of {K} of 15h equal to the plain steps; 15h's "
          "replay equal to its eager body")

    # -- times against bounds ----------------------------------------------------
    nmb = (hp // 16) * (W // 16)
    flat_used = lambda flats: sum(
        4096 + 4 * batch_meta_words(f) for f in flats.reshape(-1, flats.shape[-1]))
    t0 = time.perf_counter()
    batch.spatial_halo_pad_plain(cpu(ry), cpu(rcb), cpu(rcr), nx)
    pad_plain = (time.perf_counter() - t0) * 1e3
    pad = lambda: batch.spatial_halo_pad(ry, rcb, rcr, nx)
    # the library call: one gather a plane by PyTorch indexing, the index
    # tensors built once; both one of 32 calls in a graph (a single replay
    # adds the graph's own launch) and one replay alone
    gidx = [halo_index(p.shape[0], p.shape[1], nx, dev) for p in (ry, rcb, rcr)]
    gather = lambda: [p.reshape(-1)[i] for p, i in zip((ry, rcb, rcr), gidx)]
    check(all(torch.equal(a, b) for a, b in zip(gather(), pads)),
          "15e: the gather differs from the kernel")
    pad_ms, pad_lib_ms = graph_each_ms(pad), graph_each_ms(gather)
    pad_one, lib_one = graph_ms(pad), graph_ms(gather)
    pad_bytes = nbytes(ry, rcb, rcr) + nbytes(*pads)
    pad_dev = device_ms(pad, "halo_pad", pad_bytes / HBM_BYTES_PER_S * 1e3, 1)
    print(f"15e (nx={nx}, 1080p): one of 32 in a graph {pad_ms:.4f} ms, the gather "
          f"{pad_lib_ms:.4f}; one replay {pad_one:.4f}, the gather {lib_one:.4f}; "
          f"device {pad_dev} ms; bound {pad_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms [{smi_line()}]")
    k5p_ms = cuda_ms(lambda: h264_inter.encode_p_frame_padded_ref(
        sv(y), sv(cb), sv(cr), *pads, qp), reps=10)
    k5_ms = cuda_ms(lambda: h264_inter.encode_p_frame(y, cb, cr, ry, rcb, rcr, qp),
                    reps=10)
    t0 = time.perf_counter()
    for s in range(nx):
        h264_inter.encode_p_frame_padded_ref_plain(
            cpu(sv(y)[s]), cpu(sv(cb)[s]), cpu(sv(cr)[s]),
            *(cpu(p[s]) for p in pads), qp)
    k5p_plain = (time.perf_counter() - t0) * 1e3
    gate = {k: v.clone() for k, v in out.items()}
    fs_ms = graph_ms(lambda: damage_mask.force_skip_rows(gate, keep, ry, rcb, rcr))
    t0 = time.perf_counter()
    damage_mask.force_skip_rows_plain({k: cpu(v) for k, v in out.items()},
                                      cpu(keep), cpu(ry), cpu(rcb), cpu(rcr))
    fs_plain = (time.perf_counter() - t0) * 1e3
    frac = float((~keep).float().mean())
    lv_bytes = nbytes(*(out[k] for k in ("mv", "luma", "cb_dc", "cb_ac",
                                         "cr_dc", "cr_ac")))
    fs_bytes = frac * (lv_bytes + 2 * nbytes(ry, rcb, rcr)) + keep.numel()
    f_ms = cuda_ms(lambda: istep(y, cb, cr, hv_i, hl_i), reps=10)
    g_ms = cuda_ms(lambda: pstep(y, cb, cr, ry, rcb, rcr, hv_p, hl_p), reps=10)
    inst = cstep.instances[0]
    h_ms = cuda_ms(inst.graph.replay, reps=10)
    he_ms = cuda_ms(lambda: cstep.run_eager(kframes, (ry, rcb, rcr), khv, khl,
                                            None, qp), reps=3)
    holder.released = True
    rows = [
        dict(kernel_row("halo_pad", "spatial.cu", "parallel/batch.py:609 "
                        f"_spatial_halo_pad (nx={nx}, 1080p, one of 32 in a graph)",
                        launches["halo_pad"], e15e, pad_ms, pad_plain, pad_bytes,
                        library_ms=pad_lib_ms),
             device_ms=pad_dev, replay_ms=pad_one, library_replay_ms=lib_one),
        kernel_row("force_skip", "spatial.cu", "damage_mask.py:312 "
                   f"force_skip_rows (1080p, {frac:.2f} of the rows gated, "
                   "graph replay)",
                   launches["force_skip"], e13s, fs_ms, fs_plain, fs_bytes),
        kernel_row("inter_padded", "inter.cu", "h264_inter.py:300 "
                   f"encode_p_frame_padded_ref (nx={nx} shards, 1080p)",
                   launches["inter_padded"], e5p, k5p_ms, k5p_plain,
                   nbytes(y, cb, cr, *pads) + nbytes(*(core[k] for k in core)),
                   k5_ops(nmb)),
        kernel_row("h264_sp_intra", "", "parallel/batch.py:651 "
                   f"h264_spatial_intra_step (nx={nx}, CAVLC, deblock)",
                   launches["h264_sp_intra"], e15f, f_ms, f_plain,
                   nbytes(y, cb, cr, *ig[1:]) + flat_used(ig[0])),
        kernel_row("h264_sp_p", "", "parallel/batch.py:829 h264_spatial_step "
                   f"(nx={nx}, CAVLC, deblock; max_abs_err also the masked "
                   "form's)", launches["h264_sp_p"], max(e15g, e15m), g_ms,
                   g_plain, nbytes(y, cb, cr, ry, rcb, rcr, *pg[1:4])
                   + flat_used(pg[0]), k5_ops(nmb)),
        kernel_row("h264_sp_chunk", "", "parallel/batch.py:908 "
                   f"h264_spatial_chunk_step (nx={nx}, K={K}, graph replay; "
                   "plain: the plain 15g chain)", launches["h264_sp_chunk"],
                   max(e15h, e_rep), h_ms, h_plain,
                   nbytes(*(up(a) for fr in kframes for a in fr), ry, rcb, rcr,
                          *hout.refs) + flat_used(torch.stack(hout.flats)),
                   K * k5_ops(nmb))]
    for r in rows[3:]:
        r["source"] = "docker_nvidia_glx_desktop_tpu_torch/parallel/batch.py"
    card = smi_line()
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches on its path; max abs err "
              f"{r['max_abs_err']}) [{card}]")
    print(f"spatial: K5p over {nx} shards {k5p_ms:.4f} ms against K5 on the "
          f"frame {k5_ms:.4f} ms; 15h replay {h_ms:.4f} ms against its eager "
          f"body {he_ms:.4f} ms [{card}]")
    rep.update(k5p_ms=k5p_ms, k5_ms=k5_ms, replay_ms=h_ms, eager_ms=he_ms)

    # -- frames/s and p50 at nx = 1, 2, 4 ------------------------------------
    tframes = gop_frames(SP_TIMED_FRAMES, seed=22)
    timed = {1: [], 2: [], 4: []}
    for r in range(SP_TIMED_ROUNDS):
        for n in ((1, 2, 4) if r % 2 == 0 else (4, 2, 1)):
            timed[n].append(spatial_timed(n, tframes))
    rep["timed"] = timed
    for n, runs_n in timed.items():
        print(f"spatial timed nx={n}: " + "; ".join(
            f"{t['fps']:.1f} frames/s, p50 {t['p50_ms']:.2f} ms" for t in runs_n)
            + f" ({SP_TIMED_FRAMES} frames, 2 in flight, host clock) [{card}]")
    rep.update(launches=launches, phase_s=time.perf_counter() - t_phase)
    return rows


def batch_meta_words(flat) -> int:
    """A flat buffer's total_words (its META word 1, big-endian)."""
    b = flat[4:8].cpu().numpy().astype(int)
    return int((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3])


def spatial_timed(nx: int, frames) -> dict:
    """One timed run: make_encoder at 1080p (GOP 60, CAVLC, deblock, rate
    control) over [cuda:0] * nx, two frames in flight; frames/s over the
    run and the p50 of submit-to-collect, host clock."""
    enc = spatial_encoder(nx, ENCODER_GOP="60")
    drive(enc, frames[:2])
    import torch

    torch.cuda.synchronize()
    lat, pend = [], []
    t0 = time.perf_counter()
    for f in frames:
        pend.append((time.perf_counter(), enc.encode_submit(f)))
        if len(pend) >= 2:
            ts, tok = pend.pop(0)
            enc.encode_collect(tok)
            lat.append(time.perf_counter() - ts)
    for ts, tok in pend:
        enc.encode_collect(tok)
        lat.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    return {"fps": len(frames) / wall, "p50_ms": statistics.median(lat) * 1e3}


# -- the bench phase: rows 14d and 17a-f -------------------------------------

BENCH_TIMEOUT_S = 120       # the port's bench main under a shortened budget
BENCH_DEVICE = "cuda"
LOOP_SMALL = (320, 192)     # the loops against their plain versions
LOOP_CASES = (              # (loop, options): every option on and off
    ("intra", {}), ("p", {"deblock": True}), ("p", {"deblock": False}),
    ("cabac_intra", {"binarize": False}), ("cabac_intra", {"binarize": True}),
    ("inter", {}), ("deblock", {}),
    ("cabac_p", {"deblock": True, "binarize": False}),
    ("cabac_p", {"deblock": False, "binarize": True}))
TIER_CLASSES = ("panning_motion", "scrolling")  # run_tier against plain
TIER_QPS = (26, 38)
# the options of the timed loops and of the 4K check
LOOP_TIMED = {"p": {"deblock": True}, "cabac_p": {"deblock": True}}
# steps of the 4K check: two for the loops that chain planes
LOOP_4K_STEPS = {"intra": 1, "cabac_intra": 1}
# each loop's body, as the kernel rows of the earlier phases (this run) that
# bound it, and the reference's line
LOOP_BODY = {
    "intra": (("intra", "cavlc_slots", "pack"), "devloop.py:41 intra_loop"),
    "p": (("inter", "cavlc_p_slots", "pack_p", "deblock"),
          "devloop.py:60 p_loop (deblock=True)"),
    "cabac_intra": (("intra", "level_pack"),
                    "devloop.py:88 cabac_intra_loop (binarize=False)"),
    "inter": (("inter",), "devloop.py:118 inter_loop"),
    "deblock": (("deblock",), "devloop.py:140 deblock_loop"),
    "cabac_p": (("inter", "deblock", "level_pack"),
                "devloop.py:161 cabac_p_loop (deblock=True, binarize=False)"),
}


def loop_call(name, opts, cur, ref, slots, k, qp=26, **kw):
    """One call of the port's loop ``name`` at ``k`` steps."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    fn = getattr(devloop, f"{name}_loop")
    if name == "intra":
        return fn(*cur, *slots[0], k, qp, **opts, **kw)
    if name == "p":
        return fn(*cur, *ref, *slots[1], k, qp, **opts, **kw)
    if name in ("inter", "cabac_p"):
        return fn(*cur, *ref, k, qp, **opts, **kw)
    return fn(*cur, k, qp, **opts, **kw)


def loop_inputs(w: int, h: int, dev, seed: int):
    """A frame's planes (the bench frame's colour conversion, tiled to
    the geometry), an unrelated reference and the encoder's slots."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder

    f = np.tile(bench.make_frames()[0], (3, 2, 1))[:h, :w]
    enc = H264Encoder(w, h, mode="cavlc", host_color=True, device=dev)
    cur = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
           for p in enc._host_yuv420(f)]
    rng = np.random.default_rng(seed)
    ref = [torch.from_numpy(rng.integers(0, 256, tuple(p.shape), np.uint8)).to(dev)
           for p in cur]
    return cur, ref, (enc._hdr_slots(0, 0), enc._p_hdr_slots(1, 0))


def walk_errors(obj, path=""):
    """Every key of a bench result naming an error, with its value."""
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if "error" in str(k):
                out.append((path + str(k), v))
            out += walk_errors(v, path + str(k) + ".")
    return out


def tiers_against_plain(bench, bd, dev) -> str:
    """``run_tier`` at the ``--bdrate --quick`` geometry on the card and on
    the host's CPU (the plain versions): every frame's bits and luma PSNR
    equal at each tier (K1 and K5 in their off, hq_noaq and hq forms), and
    the card's bits equal to the ``bdrate_main`` run's at that point."""
    w, h = (int(v) for v in bd["bdrate"]["geometry"].split("x"))
    n, qps = bd["bdrate"]["frames"], bd["bdrate"]["qps"]
    done = []
    for cls in TIER_CLASSES:
        frames = bench._bdrate_frames(cls, w, h, n)
        for qp in TIER_QPS:
            for tier in ("off", "hq_noaq", "hq"):
                g = bench.run_tier(frames, tier, qp, w, h, dev)
                p = bench.run_tier(frames, tier, qp, w, h, "cpu")
                check(g["frame_bits"] == p["frame_bits"],
                      f"run_tier {cls} qp {qp} {tier}: bits {g['frame_bits']} "
                      f"against the plain {p['frame_bits']}")
                check(g["frame_psnr_y"] == p["frame_psnr_y"],
                      f"run_tier {cls} qp {qp} {tier}: PSNR "
                      f"{g['frame_psnr_y']} against the plain "
                      f"{p['frame_psnr_y']}")
                want = bd["bdrate"]["classes"][cls]["tiers"][tier][
                    "rate_bits"][qps.index(qp)]
                check(g["bits"] == want, f"run_tier {cls} qp {qp} {tier}: "
                      f"{g['bits']} bits against the bdrate run's {want}")
                done.append(g["bits"])
    return (f"{len(done)} points ({', '.join(TIER_CLASSES)} x qp "
            f"{', '.join(map(str, TIER_QPS))} x off, hq_noaq, hq; {w}x{h}, "
            f"{n} frames) equal to the plain versions frame by frame, bits "
            "and PSNR, and to the bdrate run's bits")


def bench_phase(report, rows_before):
    """The port's bench (``docker_nvidia_glx_desktop_tpu_torch.bench``) as
    its user runs it: ``main`` under a shortened ``BENCH_TIMEOUT_S`` (the
    headline, gop, the device-only loops, CABAC and 4k blocks) and
    ``bdrate_main(quick=True)``, with K14d, K17p, K17c and each loop's
    graph replays counted, and ``run_tier`` at that geometry on the card
    against the plain versions; then K14d, K17p and K17c against their
    plain versions at 1080p (the full-scale SSE pair included), each
    loop's replay against its eager kernel loop at 1080p and against the
    plain loop at 320x192, 1080p (one step) and 4K, and each loop's
    device-only step ms at 1080p and 4K beside the sum of its body's
    kernel times.  A loop's max_abs_err is the largest difference of
    these comparisons, checksum included."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, devloop

    t_phase = time.perf_counter()
    dev = torch.device(BENCH_DEVICE)
    rep = report.setdefault("bench", {})
    saved_env = {k: v for k, v in os.environ.items()
                 if k.startswith(("ENCODER_", "DNGD_", "BENCH_"))}
    for k in saved_env:
        del os.environ[k]
    os.environ["BENCH_TIMEOUT_S"] = str(BENCH_TIMEOUT_S)
    named = {"perturb": devloop.perturb, "tick": devloop.tick,
             "sse_planes": aq.sse_planes}
    # the loops' body kernels, counted the same way (graph nodes times
    # replays) for the kernel table's launch column; not checks
    every = devloop.wrappers()
    body = {k: every[k] for k in ("intra", "cavlc_slots", "pack", "pack_levels",
                                  "binarize_intra", "inter", "deblock", "cavlc_p_slots",
                                  "pack_p", "binarize_p")}
    try:
        # -- main: the bench as its user runs it, every count from 0 --------
        zero_counts({**named, **body})
        t0 = time.perf_counter()
        res = json.loads(json.dumps(bench.main(dev)))
        main_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bd = json.loads(json.dumps(bench.bdrate_main(quick=True, device=dev)))
        bd_s = time.perf_counter() - t0
        launches = path_launches(named)
        rep["body_launches"] = path_launches(body)
        replays = dict(devloop.loop_replays)
        tiers = tiers_against_plain(bench, bd, dev)
    finally:
        del os.environ["BENCH_TIMEOUT_S"]
        os.environ.update(saved_env)
    print(f"bench main ({main_s:.1f} s, BENCH_TIMEOUT_S={BENCH_TIMEOUT_S}): "
          + json.dumps(res))
    print(f"bench --bdrate --quick ({bd_s:.1f} s): " + json.dumps(bd))
    rep.update({"main": res, "bdrate": bd, "main_s": main_s, "bdrate_s": bd_s,
                "launches": launches, "loop_replays": replays})
    errs = walk_errors(res) + walk_errors(bd)
    check(not errs, f"bench: error keys {errs}")
    for block in ("gop", "device_only", "cabac", "4k"):
        check(block in res, f"bench main: the {block} block was gated out")
    check(res["cabac"]["cavlc_host_code_ms"] > 0
          and res["4k"]["profile"]["me_step_ms_r5_fullline"] > 0,
          "bench main: the native CAVLC or full-line ME timing is missing")
    # the bench's own gate (hq never loses to off, its P step at most 1.5x
    # off's) on a line of its own, failed or not: its step cost ratio, a
    # host-clock ratio of ~1 ms P frames, flaps on this card around a
    # steady ~1.2 (ROADMAP queue 3, open fault 1; tools/bdrate_pairs.py
    # splits it), so it is printed and recorded, not checked
    gate = bd["bdrate"]
    rep["gate_ok"] = gate["ok"]
    print(f"bdrate gate: {'ok' if gate['ok'] else 'FAILED'} (worst gain "
          f"{gate['worst_gain_pct']}%, max step cost ratio "
          f"{gate['max_step_cost_ratio']}, bound 1.5)")
    check(res["device"]["kind"] == torch.cuda.get_device_name(0)
          and res["device"]["smi"], "bench main: no card in its device key")
    for name, n in launches.items():
        check(n > 0, f"bench: {name} never launched on the bench's path")
    for name in dict.fromkeys(n for n, _ in LOOP_CASES):
        check(replays.get(name, 0) > 0,
              f"bench: {name}_loop never replayed on the bench's path")
    print(f"bench path launches: {launches}; loop replays: {replays}; the loops' "
          f"body kernels (graph nodes x replays): {rep['body_launches']}")
    print(f"(d) run_tier at the --bdrate --quick geometry: {tiers}")

    # -- (a) K14d, K17p, K17c against their plain versions at 1080p --------
    cur, ref, slots = loop_inputs(W, H_PAD, dev, 5)
    y = cur[0]
    zeros = torch.zeros_like(y)
    full = torch.full_like(y, 255)
    odd = (torch.arange(17 * 23, device=dev) % 251).to(torch.uint8)
    pairs = [(y, ref[0]), (zeros, full), (y.view(-1)[1:], ref[0].view(-1)[:-1]),
             (odd.view(17, 23), odd.flip(0).view(17, 23))]
    e14 = 0
    for a, b in pairs:
        got, want = int(aq.sse_planes(a, b)), int(aq.sse_planes_plain(a, b))
        e14 = max(e14, abs(got - want))
    check(e14 == 0, f"K14d differs from its plain version by {e14}")
    check(aq.mse_planes(zeros, full) == 65025.0,
          "K14d: the full-scale pair's MSE is not 65025")
    i_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    sat = [p.clone() for p in cur]
    sat[0][:16] = 255
    e17p = 0.0
    for i in (0, 1, 3):
        i_dev.fill_(i)
        e17p = max(e17p, max_diff(zip(devloop.perturb(*sat, i_dev),
                                      devloop.perturb_plain(*sat, i))))
        e17p = max(e17p, max_diff(zip(
            devloop.perturb(odd.view(17, 23), odd[:40].view(5, 8),
                            odd[40:80].view(5, 8), i_dev),
            devloop.perturb_plain(odd.view(17, 23), odd[:40].view(5, 8),
                                  odd[40:80].view(5, 8), i))))
    check(e17p == 0, f"K17p differs from its plain version by {e17p}")
    words = torch.tensor([-5, 7, 2 ** 31 - 1], dtype=torch.int32, device=dev)
    acc_k, i_k = (torch.zeros(1, dtype=torch.int32, device=dev) for _ in "ab")
    acc_p, i_p = (torch.zeros(1, dtype=torch.int32, device=dev) for _ in "ab")
    for src, off in ((words, 0), (words, 2), (y, 5), (words, 1), (full, 9)):
        devloop.tick(acc_k, src, off, i_k)
        devloop.tick_plain(acc_p, int(src.reshape(-1)[off]), i_p)
    e17c = max_diff([(acc_k, acc_p), (i_k, i_p)])
    check(e17c == 0, f"K17c differs from its plain version by {e17c}")
    print("(a) K14d (four pairs, the full-scale one 65025.0, a misaligned view, "
          "17x23), K17p (i = 0, 1, 3; saturated rows; 17x23) and K17c (int32 "
          "and uint8 words) equal their plain versions")
    acc_t = torch.zeros(1, dtype=torch.int32, device=dev)
    out_p = [torch.empty_like(p) for p in cur]
    smi = smi_line()
    tiny = {"sse_planes": lambda: aq.sse_planes(y, ref[0]),
            "perturb": lambda: devloop.perturb(*cur, i_dev, out=out_p),
            "tick": lambda: devloop.tick(acc_t, words, 0, i_dev)}
    one = {k: graph_ms(fn) for k, fn in tiny.items()}
    each = {k: graph_each_ms(fn) for k, fn in tiny.items()}
    # a graph kernel node's own floor: an empty one-thread kernel (PyTorch's
    # spin kernel for 0 cycles), one of 32 in a graph (row 17k's bound)
    rep["node_floor_ms"] = graph_each_ms(lambda: torch.cuda._sleep(0))
    print(f"an empty one-thread kernel node, one of 32 in a graph: "
          f"{rep['node_floor_ms']:.4f} ms [{smi}]")
    rows = [
        kernel_row("sse_planes", "aq.cu", "aq.py:196 _mse_reduce (:204 "
                   "mse_planes, :216 psnr_planes; 1088x1920; one of 32 "
                   "launches in a graph)", launches["sse_planes"], float(e14),
                   each["sse_planes"],
                   cuda_ms(lambda: aq.sse_planes_plain(y, ref[0]), reps=5),
                   nbytes(y, ref[0]) + 8),
        kernel_row("perturb", "devloop.cu", "devloop.py:33 _perturb (three "
                   "1080p planes; one of 32 launches in a graph)",
                   launches["perturb"], e17p, each["perturb"],
                   cuda_ms(lambda: devloop.perturb_plain(*cur, 1), reps=5),
                   nbytes(*cur, *out_p)),
        kernel_row("tick", "devloop.cu", "devloop.py:49 the loops' carry "
                   "(acc + word.astype(uint32); one of 32 launches in a "
                   "graph)", launches["tick"], e17c, each["tick"],
                   cuda_ms(lambda: devloop.tick_plain(acc_t, -5, i_dev), reps=5),
                   0, floor_ms=rep["node_floor_ms"]),
    ]
    print("K14d / K17p / K17c: a graph of one launch " + ", ".join(
        f"{k} {v:.4f}" for k, v in one.items()) + " ms; one of 32 in a graph "
        + ", ".join(f"{k} {v:.4f}" for k, v in each.items()) + f" ms [{smi}]")
    rep["tiny_one_ms"], rep["tiny_each_ms"] = one, each
    by_name = {r["name"]: r for r in list(rows_before) + rows}

    # -- (b) each loop's replay against its eager kernel loop at 1080p -------
    loop_err = {}               # each loop's largest difference, checksum in

    def held(name, opts, got, want, what):
        if name.startswith("cabac"):       # K10 and K11: header and payload
            got, want = ((t[0], k11_words(t[1]), t[2]) for t in (got, want))
        d = max(float(abs(int(got[0]) - int(want[0]))),
                max_diff([(got[1], want[1])] + list(zip(got[2], want[2]))))
        loop_err[name] = max(loop_err.get(name, 0.0), d)
        check(d == 0, f"{name}_loop {opts}: checksum {got[0]} against "
              f"{want[0]} {what}, largest difference {d}")

    def on_cpu(c, r, sl):
        return ([p.cpu() for p in c], [p.cpu() for p in r],
                tuple(tuple(t.cpu() for t in s) for s in sl))

    for name, opts in LOOP_CASES:
        held(name, opts, loop_call(name, opts, cur, ref, slots, 3, full=True),
             loop_call(name, opts, cur, ref, slots, 3, full=True, eager=True),
             "(replay against eager at 1080p)")
    # ... and against the plain loop at 320x192 (the host's CPU)
    sw, sh = LOOP_SMALL
    s_cur, s_ref, s_slots = loop_inputs(sw, sh, dev, 6)
    c_small = on_cpu(s_cur, s_ref, s_slots)
    for name, opts in LOOP_CASES:
        held(name, opts,
             loop_call(name, opts, s_cur, s_ref, s_slots, 3, full=True),
             loop_call(name, opts, *c_small, 3, full=True),
             f"(replay against plain at {sw}x{sh})")
    print(f"(b) each loop ({len(LOOP_CASES)} configurations) replayed 3 steps "
          "equal to its eager kernel loop at 1080p and to its plain loop at "
          f"{sw}x{sh}: checksum, last transport, chained planes")

    # -- each loop's device-only step at 1080p and 4K, its plain step --------
    # (the plain 1080p step is held against one replayed step, and each
    # loop's replay against its plain loop at 4K, (c) below)
    k_cur, k_ref, k_slots = loop_inputs(*bench.FOURK, dev, 7)
    c_1080 = on_cpu(cur, ref, slots)
    steps = {}
    for name, _ in LOOP_CASES:
        if name in steps:
            continue
        opts = LOOP_TIMED.get(name, {})
        one = {}
        for geo, (c, r, sl) in (("1080p", (cur, ref, slots)),
                                ("4k", (k_cur, k_ref, k_slots))):
            one[geo] = devloop.measure_steady_state(
                lambda k: loop_call(name, opts, c, r, sl, k),
                budget_s=2.0)["step_ms"]
        one["eager_1080p"] = cuda_ms(lambda: loop_call(
            name, opts, cur, ref, slots, 1, eager=True), reps=5)
        t0 = time.perf_counter()
        pl = loop_call(name, opts, *c_1080, 1, full=True)
        one["plain_1080p"] = (time.perf_counter() - t0) * 1e3
        held(name, opts, loop_call(name, opts, cur, ref, slots, 1, full=True),
             pl, "(one replayed step against the plain step at 1080p)")
        body, replaces = LOOP_BODY[name]
        parts = [by_name.get(b) for b in body + ("perturb",)]
        one["kernels_ms"] = sum(p["ms"] for p in parts if p)
        bounds = [(p["bound_ms"], p["bound_by"]) for p in parts if p]
        steps[name] = one
        row = kernel_row(f"{name}_loop", "", replaces + " (1080p step, "
                         "graph replays; plain: one step on the host's CPU)",
                         replays.get(name, 0), None, one["1080p"],
                         one["plain_1080p"], 0)
        row.update({"source": "docker_nvidia_glx_desktop_tpu_torch/ops/devloop.py",
                    "bound_ms": sum(b for b, _ in bounds),
                    "bound_by": max(bounds)[1] if bounds else "bytes"})
        if len(bounds) < len(parts):
            print(f"kernel {name}_loop: bound counts {len(bounds)} of its "
                  f"{len(parts)} kernels (the others' rows are not in this run)")
        rows.append(row)
        print(f"loop {name}: step {one['1080p']:.3f} ms at 1080p, "
              f"{one['4k']:.3f} ms at 4K (replays, host-clock differencing); "
              f"eager one step {one['eager_1080p']:.3f} ms; its kernels' rows "
              f"{one['kernels_ms']:.3f} ms; plain one step "
              f"{one['plain_1080p']:.1f} ms, equal to one replayed step [{smi}]")

    # -- (c) each loop's replay against its plain loop at 4K ----------------
    t0 = time.perf_counter()
    c_4k = on_cpu(k_cur, k_ref, k_slots)
    for name in steps:
        opts, k = LOOP_TIMED.get(name, {}), LOOP_4K_STEPS.get(name, 2)
        held(name, opts, loop_call(name, opts, k_cur, k_ref, k_slots, k,
                                   full=True),
             loop_call(name, opts, *c_4k, k, full=True),
             f"(replay against plain at {k} steps, 4K)")
    w4, h4 = bench.FOURK
    print(f"(c) each loop replayed equal to its plain loop at {w4}x{h4} "
          f"({', '.join(f'{n} {LOOP_4K_STEPS.get(n, 2)}' for n in steps)} "
          f"steps): checksum, last transport, chained planes "
          f"({time.perf_counter() - t0:.1f} s)")
    for r in rows:
        if r["name"].endswith("_loop"):
            r["max_abs_err"] = loop_err[r["name"][:-len("_loop")]]
    rep["steps"] = steps
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
              f"{r['launches']} launches on the bench's path; max abs err "
              f"{r['max_abs_err']})")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"bench phase: {rep['phase_s']:.1f} s")
    return rows


# -- A/B timing of kernel sets across checkouts, and kernels by parts -------
#
# ``python3 chip_smoke.py pairs --set SET [--pairs N] NAME=PATH ...`` times
# one set of kernels (``PAIR_SETS``: ``k1k6``, ``k5k4``, ``k2k8``, ``k3k7``,
# ``k11k16``, ``k10k11i``) on each checkout;
# ``k1k6-pairs`` is ``pairs --set k1k6``.  For the k1k6 set it compares
# checkouts of the repository (say a commit's parent, unpacked with ``git
# archive`` into the git-ignored ``.tree/``, and this tree): every run is a
# fresh process that imports the port from PATH, round ``i`` runs the
# variants in order and round ``i + 1`` in reverse.  A run times at 1080p on
# this script's seeded desktops, medians of CUDA events over eager calls
# through the wrappers every checkout has: K1 at each tier on a desktop
# frame, tier 0 on a full-noise frame, on 8 stacked sessions and on a
# 3840x2176 frame; K2 on K1's levels (it shares the block coder with K6),
# also replayed; K6 on the P core's outputs of a moving desktop frame, of an
# all-skip frame and a noise frame, on 8 sessions and in the I16-in-P form
# without and with the qp chain; K1's and K6's kernels by device time
# (``torch.profiler``); the device-only intra and P steps (rows 17a, 17b).
# Each variant's build reports the intra and cavlc sources' ``-Xptxas -v``
# lines.  Writes ``chiprun_out/k1k6_pairs.json``.  The k5k4 set times
# ``k5k4_times``'s list (K5 per tier on three frames, S = 8, 4K, K5p, K5r,
# K4's forms, steps 17b and 17d, the GOP path) the same way and writes
# ``chiprun_out/k5k4_pairs.json``; ``k5k4-split`` cuts K5's stages and
# K4's last-block parts out of copies of their sources (``K5_VARIANTS``,
# ``K4_VARIANTS``).  The k2k8 set (``k2k8_times``: K2 and K8 in their
# forms, eager, replayed and by device time, 8 sessions, 4K, steps 17a,
# 17b and 17e) writes ``chiprun_out/k2k8_pairs.json``; ``k2k8-split`` cuts
# K8's and K2's stages out of copies of their sources (``K8_VARIANTS``,
# ``K2_VARIANTS``).  The k11k16 set (``k11k16_times``: K16c and K11p in
# each form and K16a, eager, replayed and by device time, each kernel's
# device time) writes ``chiprun_out/k11k16_pairs.json``; ``k11k16-split``
# cuts their stages out of copies (``K16C_VARIANTS``, ``K11P_VARIANTS``).
#
# ``python3 chip_smoke.py k1-variants`` builds copies of ``csrc/intra.cu``
# with one part of the chain pass cut out (wrong outputs: timing only) into
# ``.tree/k1_variants`` and times each copy's tier-0 launch at 1080p as
# graph replays: ``base``; ``no_i4`` (the I4 warps skip the I4 chain);
# ``noshfl_fwd`` / ``noshfl_inv`` (the I4 step's forward / inverse column
# pass without shuffles); ``no_bits_shfl``; ``no_pick``; ``no_sync`` (the
# I4 steps without syncs).  Writes ``chiprun_out/k1_variants.json``.

PAIRS_QP = 26
PAIRS_LOOP_BUDGET_S = 6.0
PKG = "docker_nvidia_glx_desktop_tpu_torch"


def ptxas_lines(log: str) -> list:
    """The compiler's per-function resource lines of one source."""
    keep = ("Compiling entry function", "bytes stack frame", "Used ", "spill")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]


def pair_planes(rgb, ph=None, pw=None):
    """A host RGB frame as the card's padded I420 planes."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)
    return [torch.from_numpy(np.ascontiguousarray(p)).to(torch.device("cuda"))
            for p in rgb_to_yuv420_host(rgb, ph or H_PAD, pw or W)]


def k1k6_times() -> dict:
    """The ``k1k6`` set: K1, K2, K6 and steps 17a-b."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        cavlc_device, cavlc_p_device, devloop, h264_device, h264_inter)

    dev, qp = torch.device("cuda"), PAIRS_QP
    planes = pair_planes

    gop = gop_frames(3, seed=2, noisy_at=2)
    desk, moved, noise = planes(gop[0]), planes(gop[1]), planes(gop[2])
    big = planes(np.tile(gop[0], (2, 2, 1)), 2 * H_PAD, 2 * W)
    sess = [planes(f) for f in desktop_frames(8, seed=4)[:8]]
    stacked = [torch.stack([s[i] for s in sess]) for i in range(3)]
    ev = lambda fn: cuda_ms(fn, reps=20)
    gr = lambda fn: graph_ms(fn, reps=20)
    k1 = lambda p, tune="off": (
        lambda: h264_device.encode_intra_frame_yuv(*p, qp, tune))
    out = {"k1_t0_ms": ev(k1(desk)), "k1_t0_graph_ms": gr(k1(desk)),
           "k1_t0_noise_ms": ev(k1(noise)), "k1_t1_ms": ev(k1(desk, "hq_noaq")),
           "k1_t2_ms": ev(k1(desk, "hq")), "k1_s8_ms": ev(k1(stacked)),
           "k1_4k_ms": ev(k1(big)), "k1_split": kernel_split(k1(desk))}
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    out["k2_ms"] = ev(lambda: cavlc_device.frame_block_slots(lv))
    out["k2_graph_ms"] = gr(lambda: cavlc_device.frame_block_slots(lv))

    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    o = h264_inter.encode_p_frame(*moved, *ref, qp)
    ohq = h264_inter.encode_p_frame(*moved, *ref, qp, tune="hq", p_intra=True)
    keys = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    os8 = [h264_inter.encode_p_frame(*s, *ref, qp) for s in sess]
    o8 = {k: torch.stack([x[k] for x in os8]) for k in keys}
    k6 = lambda x, q=None: (lambda: cavlc_p_device.p_frame_slots(x, q))
    out.update(
        k6_ms=ev(k6(o)), k6_graph_ms=gr(k6(o)),
        k6_skip_ms=ev(k6(h264_inter.encode_p_frame(*ref, *ref, qp))),
        k6_noise_ms=ev(k6(h264_inter.encode_p_frame(*noise, *ref, qp))),
        k6_i_ms=ev(k6({k: v for k, v in ohq.items() if k != "qp_map"})),
        k6_i_chain_ms=ev(k6(ohq, qp)), k6_s8_ms=ev(k6(o8)),
        k6_intra_mbs=int(ohq["mb_intra"].sum()), k6_split=kernel_split(k6(o)),
        k6_i_split=kernel_split(k6(ohq, qp)))

    enc = H264Encoder(W, H, mode="cavlc", entropy="device", host_color=True,
                      device=dev)
    d = planes(gop_frames(1, seed=5)[0])
    hv, hl = enc._hdr_slots(0, 0)
    hvp, hlp = enc._p_hdr_slots(1, 0)
    out["step17a_ms"] = devloop.measure_steady_state(
        lambda k: devloop.intra_loop(*d, hv, hl, k, qp),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    out["step17b_ms"] = devloop.measure_steady_state(
        lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp, deblock=True),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    return out


def k5k4_times() -> dict:
    """The ``k5k4`` set: K5 at each tier on a moving desktop, an unchanged
    and a noise frame, hq with I16-in-P, on 8 stacked sessions and at 4K;
    K5p at nx = 2; K5r at 1, 8 and 64 rows; K4 full, intra, ``mb_intra``
    and K4c at K = 4 (eager and replayed); their kernels by device time;
    steps 17b and 17d; the GOP path's frames/s and P p50 (one frame in
    flight, host clock)."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder, make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, content_stats, devloop, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    dev, qp = torch.device("cuda"), PAIRS_QP
    ev = lambda fn: cuda_ms(fn, reps=20)
    gr = lambda fn: graph_ms(fn, reps=20)
    gop = gop_frames(3, seed=2, noisy_at=2)
    desk, moving, noise = (pair_planes(f) for f in gop)
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    k5 = lambda cur, tune="off", pi=False, r=ref: (
        lambda: h264_inter.encode_p_frame(*cur, *r, qp, tune=tune, p_intra=pi))
    out = {}
    for label, cur in (("moving", moving), ("unchanged", ref), ("noise", noise)):
        for t, tune in enumerate(aq.TIERS):
            out[f"k5_t{t}_{label}_ms"] = ev(k5(cur, tune))
    out["k5_t0_graph_ms"] = gr(k5(moving))
    out["k5_t2_i16_ms"] = ev(k5(moving, "hq", True))
    out["k5_t2_i16_graph_ms"] = gr(k5(moving, "hq", True))
    sess = [pair_planes(f) for f in desktop_frames(8, seed=4)[:8]]
    st = [torch.stack([s[i] for s in sess]) for i in range(3)]
    sref = [torch.stack([p] * 8) for p in ref]
    out["k5_s8_ms"] = ev(k5(st, r=sref))
    big = pair_planes(np.tile(gop[1], (2, 2, 1)), 2 * H_PAD, 2 * W)
    bref = pair_planes(np.tile(gop[0], (2, 2, 1)), 2 * H_PAD, 2 * W)
    out["k5_4k_ms"] = ev(k5(big, r=bref))
    # K5p: two shards of 34 MB rows, each reference edge-padded
    shard = lambda p: torch.stack([p[:p.shape[0] // 2], p[p.shape[0] // 2:]])
    pads = [torch.stack([h264_inter._edge_pad(x.to(torch.int32), h264_inter._PAD)
                         .to(torch.uint8) for x in shard(p)]) for p in ref]
    cur2 = [shard(p) for p in moving]
    out["k5p_nx2_ms"] = ev(lambda: h264_inter.encode_p_frame_padded_ref(
        *cur2, *pads, qp))
    for n_rows in TUNE_MASK_ROWS:
        rows = torch.arange(2, 2 + n_rows, dtype=torch.int32, device=dev)
        fn = lambda rows=rows: h264_inter.encode_p_frame_rows(
            *moving, *ref, rows, qp)
        out[f"k5r_{n_rows}_ms"] = ev(fn)
        out[f"k5r_{n_rows}_graph_ms"] = gr(fn)
    out["k5_split"] = kernel_split(k5(moving))
    o = h264_inter.encode_p_frame(*moving, *ref, qp)
    ohq = h264_inter.encode_p_frame(*moving, *ref, qp, tune="hq", p_intra=True)
    keys = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    resid, resid_hq = (tuple(x[k] for k in keys) for x in (o, ohq))
    y, py = moving[0], desk[0]
    ys = torch.stack([py, y, py, y])
    st4 = lambda t: torch.stack([t] * 4)
    forms = {
        "full": lambda: content_stats.frame_stats_full(
            y, py, 512, o["recon_y"], o["mv"], resid),
        "intra": lambda: content_stats.frame_stats(y, py, 512),
        "mb_intra": lambda: content_stats.frame_stats_full(
            y, py, 512, ohq["recon_y"], ohq["mv"], resid_hq, ohq["mb_intra"]),
        "k4c": lambda: content_stats.chunk_stats(
            ys, py, 512, o["recon_y"], st4(o["mv"]), tuple(map(st4, resid))),
    }
    for name, fn in forms.items():
        out[f"k4_{name}_ms"] = ev(fn)
        out[f"k4_{name}_graph_ms"] = gr(fn)
    out["k4_split"] = kernel_split(forms["full"])
    out["k4_intra_split"] = kernel_split(forms["intra"])

    enc = H264Encoder(W, H, mode="cavlc", entropy="device", host_color=True,
                      device=dev)
    d = pair_planes(gop_frames(1, seed=5)[0])
    hvp, hlp = enc._p_hdr_slots(1, 0)
    out["step17b_ms"] = devloop.measure_steady_state(
        lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp, deblock=True),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    out["step17d_ms"] = devloop.measure_steady_state(
        lambda k: devloop.inter_loop(*d, *d, k, qp),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    # the GOP path (default config, one frame in flight)
    enc, _ = make_encoder(from_env({"SIZEW": str(W), "SIZEH": str(H)}), W, H)
    frames = gop_frames(TIMED_FRAMES + 1, seed=2)
    enc.encode_collect(enc.encode_submit(frames[0]))
    lat, kinds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[1:]:
        ts = time.perf_counter()
        tok = enc.encode_submit(f)
        enc.encode_collect(tok)
        lat.append((time.perf_counter() - ts) * 1e3)
        kinds.append(tok[0])
    out["gop_fps"] = len(lat) / (time.perf_counter() - t0)
    out["gop_p_p50_ms"] = statistics.median(
        m for m, k in zip(lat, kinds) if k == "p")
    return out


def k2k8_times() -> dict:
    """The ``k2k8`` set at 1080p: K2 on a desktop IDR's levels (eager,
    replayed, by device time), with the qp chain, on 8 stacked sessions
    and on 4K levels; K8 in its intra, P (``nnz_blk``) and ``luma`` forms
    (eager, replayed, by device time), with ``qp_dev``, on 8 stacked
    sessions and at 4K; steps 17a, 17b and 17e."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, cavlc_device, devloop, h264_deblock, h264_device)

    dev, qp = torch.device("cuda"), PAIRS_QP
    ev = lambda fn: cuda_ms(fn, reps=20)
    gr = lambda fn: graph_ms(fn, reps=20)
    x = k8_inputs(dev)
    keys = cavlc_device._LEVEL_KEYS
    lv = {k: x["levels"][k] for k in keys}
    lvq = dict(lv, qp_map=aq.qp_plane(x["intra"][0], qp))
    sess = [pair_planes(f) for f in desktop_frames(8, seed=4)[:8]]
    st = [torch.stack([s[i] for s in sess]) for i in range(3)]
    lv8 = h264_device.encode_intra_frame_yuv(*st, qp)
    lv8 = {k: lv8[k] for k in keys}
    big = pair_planes(np.tile(gop_frames(1, seed=2)[0], (2, 2, 1)), 2 * H_PAD, 2 * W)
    lv4k = h264_device.encode_intra_frame_yuv(*big, qp)
    rec4k = (lv4k["recon_y"], lv4k["recon_cb"], lv4k["recon_cr"])
    lv4k = {k: lv4k[k] for k in keys}
    k2 = cavlc_device.frame_block_slots
    k8 = h264_deblock.deblock_frame
    qd = torch.tensor([qp + 4], dtype=torch.int32, device=dev)
    forms = {
        "k2": lambda: k2(lv),
        "k2_chain": lambda: k2(lvq, qp),
        "k8_intra": lambda: k8(*x["intra"], qp),
        "k8_p": lambda: k8(*x["p"], qp, nnz_blk=x["nnz"], mv=x["mv"]),
        "k8_luma": lambda: k8(*x["p"], qp, luma=x["luma"], mv=x["mv"]),
    }
    out = {}
    for name, fn in forms.items():
        out[f"{name}_ms"] = ev(fn)
        out[f"{name}_graph_ms"] = gr(fn)
        split = kernel_split(fn)
        out[f"{name}_device_ms"] = float(sum(split.values())) if split else -1.0
        out[f"{name}_split"] = split
    out["k2_s8_ms"] = ev(lambda: k2(lv8))
    out["k2_4k_ms"] = ev(lambda: k2(lv4k))
    out["k8_qp_dev_ms"] = ev(lambda: k8(*x["p"], qp, luma=x["luma"], mv=x["mv"],
                                        qp_dev=qd))
    out["k8_s8_ms"] = ev(lambda: k8(*st, qp))
    out["k8_4k_ms"] = ev(lambda: k8(*rec4k, qp))
    enc = H264Encoder(W, H, mode="cavlc", entropy="device", host_color=True,
                      device=dev)
    d = pair_planes(gop_frames(1, seed=5)[0])
    hv, hl = enc._hdr_slots(0, 0)
    hvp, hlp = enc._p_hdr_slots(1, 0)
    out["step17a_ms"] = devloop.measure_steady_state(
        lambda k: devloop.intra_loop(*d, hv, hl, k, qp),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    out["step17b_ms"] = devloop.measure_steady_state(
        lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp, deblock=True),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    out["step17e_ms"] = devloop.measure_steady_state(
        lambda k: devloop.deblock_loop(*d, k, qp),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    return out


def k3k7_inputs(dev, qp: int = PAIRS_QP) -> dict:
    """The packers' 1080p inputs: K2's slots of a desktop IDR (K3; with
    the qp chain for the qp-sum form), K6's slots of a moving desktop P
    frame (K7; its hq form I16-in-P with 27 blocks and the qp sum), 8
    stacked sessions of each and K2's slots of a 4K IDR, with the
    encoder's slice-header slots."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        aq, cavlc_device, cavlc_p_device, h264_device, h264_inter)

    gop = gop_frames(2, seed=2)
    desk, moving = pair_planes(gop[0]), pair_planes(gop[1])
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    keys = cavlc_device._LEVEL_KEYS
    lvk = {k: lv[k] for k in keys}
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    o = h264_inter.encode_p_frame(*moving, *ref, qp)
    ohq = h264_inter.encode_p_frame(*moving, *ref, qp, tune="hq", p_intra=True)
    big = pair_planes(np.tile(gop[0], (2, 2, 1)), 2 * H_PAD, 2 * W)
    lv4k = h264_device.encode_intra_frame_yuv(*big, qp)
    enc = H264Encoder(W, H, mode="cavlc", entropy="device", host_color=True,
                      device=dev)
    enc4k = H264Encoder(2 * W, 2 * H_PAD, mode="cavlc", entropy="device",
                        host_color=True, device=dev)
    x = {"i": cavlc_device.frame_block_slots(lvk)[:4],
         "p": cavlc_p_device.p_frame_slots(o)[:6],
         "hdr": enc._hdr_slots(0, 0), "hdr_p": enc._p_hdr_slots(1, 0),
         "i4k": cavlc_device.frame_block_slots(
             {k: lv4k[k] for k in keys})[:4],
         "hdr4k": enc4k._hdr_slots(0, 0)}
    slq = cavlc_device.frame_block_slots(
        dict(lvk, qp_map=aq.qp_plane(desk[0], qp)), qp)
    x["i_hq"], x["i_qp_sum"] = slq[:4], slq[4]
    shq = cavlc_p_device.p_frame_slots(ohq, qp)
    x["p_hq"], x["p_qp_sum"] = shq[:6], shq[7]
    x["i8"] = [torch.stack([t] * 8) for t in x["i"]]
    x["p8"] = [torch.stack([t] * 8) for t in x["p"]]
    return x


def k3k7_forms(x: dict) -> dict:
    """The packers' forms on ``k3k7_inputs``, each a call of the wrapper
    a user's path makes."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge

    pf, ppf = bitmerge.pack_frame, bitmerge.pack_p_frame
    return {
        "k3": lambda: pf(*x["i"], *x["hdr"]),
        "k3_hq": lambda: pf(*x["i_hq"], *x["hdr"], qp_sum=x["i_qp_sum"]),
        "k7": lambda: ppf(*x["p"], *x["hdr_p"]),
        "k7_hq": lambda: ppf(*x["p_hq"], *x["hdr_p"], qp_sum=x["p_qp_sum"]),
        "k3_s8": lambda: pf(*x["i8"], *x["hdr"]),
        "k7_s8": lambda: ppf(*x["p8"], *x["hdr_p"]),
        "k3_4k": lambda: pf(*x["i4k"], *x["hdr4k"]),
    }


def k3k7_form_times(x: dict) -> dict:
    """Each of ``k3k7_forms(x)``: {"ms": CUDA-event ms of the wrapper's
    call, "graph_ms": replayed, "device_ms": the profiler's device time,
    "split": that time by kernel (the memset and each launch)}."""
    out = {}
    for name, fn in k3k7_forms(x).items():
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20)}
        split = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        r["split"] = split
    return out


def k3k7_times() -> dict:
    """The ``k3k7`` set at 1080p: K3 on a desktop IDR's slots and K7 on a
    moving desktop P frame's, each plain and in its qp-sum form (K7's
    with 27 blocks), eager, replayed and by device time; 8 stacked
    sessions of each and K3 at 4K; steps 17a and 17b."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    dev, qp = torch.device("cuda"), PAIRS_QP
    out = {f"{name}_{k}": v
           for name, r in k3k7_form_times(k3k7_inputs(dev)).items()
           for k, v in r.items()}
    enc = H264Encoder(W, H, mode="cavlc", entropy="device", host_color=True,
                      device=dev)
    d = pair_planes(gop_frames(1, seed=5)[0])
    hv, hl = enc._hdr_slots(0, 0)
    hvp, hlp = enc._p_hdr_slots(1, 0)
    out["step17a_ms"] = devloop.measure_steady_state(
        lambda k: devloop.intra_loop(*d, hv, hl, k, qp),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    out["step17b_ms"] = devloop.measure_steady_state(
        lambda k: devloop.p_loop(*d, *d, hvp, hlp, k, qp, deblock=True),
        budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    return out


def k11k16_inputs(dev, qp: int = PAIRS_QP) -> dict:
    """The K16c and K11p inputs at their main paths' shapes: K16a's levels
    of a 1080p desktop with the single encoder's sticky and per-frame
    tables, of the same desktop at 1919x1079, of S = 4 sessions x nx = 4
    strips at 1920x1088 with the batch's tables, and of a 4K desktop; the
    P core's outputs of a moving 1080p desktop frame (K11p's per-frame,
    ring and 17f form), of a full-noise frame (dense levels) and of one
    nx = 2 shard's 34 MB rows."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import (
        JpegEncoder, _tables_from_hists)
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device, h264_inter
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch

    frames = mjpeg_frames(2)
    x = {}
    for name, mode, fw, fh in (("j", "sticky", W, H), ("j_pf", "per_frame", W, H),
                               ("j_odd", "sticky", ODD_W, ODD_H)):
        enc = JpegEncoder(fw, fh, table_mode=mode)
        f = np.ascontiguousarray(frames[1][:fh, :fw])
        enc.encode(np.ascontiguousarray(frames[0][:fh, :fw]))
        enc.encode(f)
        t = (torch.from_numpy(f).to(dev)[None], enc.luma_q, enc.chroma_q, enc.pad_h,
             enc.pad_w)
        x[name] = (jd.jpeg_transform(*t), enc._table_dev, 1)
        if name == "j":
            x["j_t"] = t
    big = np.ascontiguousarray(np.tile(frames[1], (2, 2, 1)))
    x["j_4k"] = (jd.jpeg_transform(torch.from_numpy(big).to(dev)[None], enc.luma_q,
                                   enc.chroma_q, 2 * H, 2 * W), x["j"][1], 1)
    bframes = np.stack([np.pad(f, ((0, BATCH_H - H), (0, 0), (0, 0)), "edge")
                        for f in mjpeg_frames(BATCH_S, seed=10)])
    step = batch.batch_encode_step(BATCH_H, W, quality=85, spatial=BATCH_NX)
    lv = step.transform(bframes)
    hist = jd.split_hists(jd.jpeg_analyze(*lv, BATCH_NX))
    arrays = jd.dense_tables(_tables_from_hists([h[0].cpu().numpy() for h in hist],
                                                smooth=True))
    x["j_s4"] = (lv, jd.table_tensor(arrays, dev), BATCH_NX)

    gop = gop_frames(2, seed=2)
    desk, moving = pair_planes(gop[0]), pair_planes(gop[1])
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    keys = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    o = h264_inter.encode_p_frame(*moving, *ref, qp)
    x["p"] = [o[k] for k in keys]
    rng = np.random.default_rng(12)
    noise = pair_planes(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    on = h264_inter.encode_p_frame(*noise, *ref, qp)
    x["p_noise"] = [on[k] for k in keys]
    x["p_band"] = [t[:H_PAD // 32].contiguous() for t in x["p"]]
    return x


def k11k16_forms(x: dict) -> dict:
    """K16c's and K11p's forms on ``k11k16_inputs``, each a call of the
    wrapper a user's path makes."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import cabac_binarize
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    out = {}
    for name in ("j", "j_pf", "j_odd", "j_s4", "j_4k"):
        lv, tab, nx = x[name]
        out["k16c" + name[1:]] = lambda lv=lv, tab=tab, nx=nx: jd.jpeg_pack(*lv, tab, nx)
    for name in ("p", "p_noise", "p_band"):
        out["k11" + name] = lambda a=x[name]: cabac_binarize.binarize_p(*a)
    return out


def k11k16_form_times(x: dict) -> dict:
    """Each of ``k11k16_forms(x)``: eager, replayed and device ms, and the
    device time by kernel (``kernel_split``); K16a's 1080p transform too
    (its device time for the kernels line)."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    forms = dict(k11k16_forms(x), k16a=lambda: jd.jpeg_transform(*x["j_t"]))
    out = {}
    for name, fn in forms.items():
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20)}
        split = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        r["split"] = split
    return out


def form_numbers(times: dict) -> dict:
    """{form: {number: value, "split": {kernel: ms}}} as one flat dict of
    ``<form>_<number>`` and ``<form>_dev_<kernel>``: a pairs run's line."""
    out = {}
    for name, r in times.items():
        for k, v in r.items():
            if k == "split":
                out.update({f"{name}_dev_{s}": float(t) for s, t in v.items()})
            else:
                out[f"{name}_{k}"] = v
    return out


def k11k16_times() -> dict:
    """The ``k11k16`` set: K16c and K11p in each form, eager, replayed and
    by device time, and the device time of each of their kernels."""
    import torch

    return form_numbers(k11k16_form_times(k11k16_inputs(torch.device("cuda"))))


# -- K10 and K11i (the CABAC level transport and intra binarizer) -----------
#
# ``k10k11i_inputs`` holds their main paths' inputs; ``pairs --set
# k10k11i`` times ``k10k11i_times`` on each checkout (writes
# ``chiprun_out/k10k11i_pairs.json``); ``k10k11i-split`` gives each form's
# kernels by device time and, where the sources hold the segment kernels,
# copies with a stage cut out (``K10_VARIANTS``, ``K11I_VARIANTS``;
# ``chiprun_out/k10k11i_split.json``).  On the parent of the redesign the
# split times the wrappers only.

K11I_NOISE_QP = 18          # the noise IDR's qp: low, yet no MB over its cap
I_BIN_KEYS = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
              "pred_mode", "mb_i4", "i4_modes", "luma_i4")


def k10k11i_inputs(dev, qp: int = PAIRS_QP) -> dict:
    """K11i's and K10's inputs at their main paths' shapes: K1's levels of
    a 1080p desktop IDR (K11i's per-frame, ring and 17c form; K10's intra
    keys), of a full-noise IDR at ``K11I_NOISE_QP``, of the desktop with
    K1's I16-only mode set (every MB I_16x16), of a noise IDR at ``qp``
    with every MB made I_NxN (its I16 MBs' luma DC and AC zeroed; the
    share that K1 coded I_NxN is kept as ``i4_share``), and one nx = 2
    shard's 34 MB rows of the desktop; K10's intra keys of the noise IDR
    at ``qp`` and its P keys of the P core's outputs for a moving desktop
    frame and a full-noise frame."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device, h264_inter

    enc = h264_device.encode_intra_frame_yuv
    gop = gop_frames(2, seed=2)
    desk, moving = pair_planes(gop[0]), pair_planes(gop[1])
    rng = np.random.default_rng(12)
    noise = pair_planes(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    lv = enc(*desk, qp)
    lvq = enc(*noise, qp)
    i4 = dict(lvq, mb_i4=torch.ones_like(lvq["mb_i4"]),
              luma_dc=torch.zeros_like(lvq["luma_dc"]),
              luma_ac=torch.zeros_like(lvq["luma_ac"]))
    x = {"i4_share": float(lvq["mb_i4"].float().mean())}
    for name, levels in (("i", lv), ("i_noise", enc(*noise, K11I_NOISE_QP)),
                         ("i_i16", enc(*desk, qp, i16_modes="i16")), ("i_i4", i4)):
        x[name] = [levels[k] for k in I_BIN_KEYS]
    x["i_band"] = [t[:H_PAD // 32].contiguous() for t in x["i"]]
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    x["l_i"], x["l_i_noise"] = lv, lvq
    x["l_p"] = h264_inter.encode_p_frame(*moving, *ref, qp)
    x["l_p_noise"] = h264_inter.encode_p_frame(*noise, *ref, qp)
    return x


def k10k11i_forms(x: dict) -> dict:
    """K11i's and K10's forms on ``k10k11i_inputs``, each a call of the
    wrapper a user's path makes."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import cabac_binarize, level_pack

    out = {}
    for name in ("i", "i_noise", "i_i16", "i_i4", "i_band"):
        out["k11" + name] = lambda a=x[name]: cabac_binarize.binarize_intra(*a)
    for name in ("l_i", "l_i_noise", "l_p", "l_p_noise"):
        keys = level_pack.INTRA_KEYS if name.startswith("l_i") else level_pack.P_KEYS
        out["k10" + name[2:]] = lambda lv=x[name], keys=keys: level_pack.pack_levels(lv, keys)
    return out


def k10k11i_form_times(x: dict) -> dict:
    """Each of ``k10k11i_forms(x)``: eager, replayed and device ms, the
    device time by kernel (``kernel_split``), and its transport's payload
    words and overflow flag."""
    out = {}
    for name, fn in k10k11i_forms(x).items():
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20)}
        split = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        r["split"] = split
        buf = fn()
        r["words"], r["flag"] = float(buf[2]), float(buf[1])
    return out


def k10k11i_times() -> dict:
    """The ``k10k11i`` set: K11i and K10 in each form (eager, replayed,
    device time, each kernel's device time); steps 17c on both transports
    and 17f on K10 and K11p (a desktop's planes, its own reference); the
    bench's ``intra_device_binarize_step_ms`` (17c with K11i on the bench's
    frame at its encoder's qp)."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch import bench
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    dev, qp = torch.device("cuda"), PAIRS_QP
    out = form_numbers(k10k11i_form_times(k10k11i_inputs(dev)))
    d = pair_planes(gop_frames(1, seed=5)[0])
    steady = lambda fn: devloop.measure_steady_state(
        fn, budget_s=PAIRS_LOOP_BUDGET_S)["step_ms"]
    for binarize in (False, True):
        tag = "bin" if binarize else "k10"
        out[f"step17c_{tag}_ms"] = steady(
            lambda k, b=binarize: devloop.cabac_intra_loop(*d, k, qp, binarize=b))
        out[f"step17f_{tag}_ms"] = steady(
            lambda k, b=binarize: devloop.cabac_p_loop(*d, *d, k, qp, binarize=b))
    frames = bench.make_frames()
    cenc = H264Encoder(W, H, mode="cavlc", entropy="cabac", host_color=True, device=dev)
    db = bench._upload(cenc._host_yuv420(frames[0]), dev)
    out["bench_intra_device_binarize_step_ms"] = steady(
        lambda k: devloop.cabac_intra_loop(*db, k, cenc.qp, binarize=True))
    return out




def i16halo_inputs(dev, qp: int = PAIRS_QP) -> dict:
    """The I16-in-P passes' and 15e's inputs at their main paths' shapes:
    a moving desktop P frame and a full-noise P frame of 1080p over a
    desktop IDR's recon, the worklists of 1, 8 and 64 MB rows
    (``worklist_64``: scattered, the last a copy of the first), the IDR's
    planes as the full tier's lookahead frame; 15e pads the recon."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device

    gop = gop_frames(3, seed=2, noisy_at=2)
    desk, moving, noise = (pair_planes(f) for f in gop)
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    nr = H_PAD // 16
    r0 = min(20, nr - 8)
    lists = {1: [r0], 8: list(range(r0, r0 + 8)), 64: worklist_64(nr)}
    return {"desk": moving, "noise": noise, "next": desk[0],
            "ref": (lv["recon_y"], lv["recon_cb"], lv["recon_cr"]),
            "rows": {n: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
                     for n, v in lists.items()}}


def i16halo_forms(x: dict, qp: int = PAIRS_QP) -> dict:
    """{form: (call, the call without I16-in-P or None)}: the P core with
    its I16-in-P passes in the frame form at tiers 1 and 2 on the desktop
    and the noise P frame and in the worklist form at tier 2 (the full
    tier's masked path), and 15e at nx = 2 and 4, halo on and off."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch

    forms, ref = {}, x["ref"]
    for label in ("desk", "noise"):
        for t, tune in ((1, "hq_noaq"), (2, "hq")):
            call = lambda pi, cur=x[label], tune=tune: h264_inter.encode_p_frame(
                *cur, *ref, qp, tune=tune, p_intra=pi)
            forms[f"i16_{label}_t{t}"] = (lambda c=call: c(True), lambda c=call: c(False))
    for n, rows in x["rows"].items():
        call = lambda pi, rows=rows: h264_inter.encode_p_frame_rows(
            *x["desk"], *ref, rows, qp, tune="hq", next_y=x["next"], p_intra=pi)
        forms[f"i16_rows{n}"] = (lambda c=call: c(True), lambda c=call: c(False))
    for nx in (2, 4):
        for halo in (True, False):
            forms[f"halo_nx{nx}_{'on' if halo else 'off'}"] = (
                lambda nx=nx, halo=halo: batch.spatial_halo_pad(*ref, nx, halo), None)
    return forms


def i16_bytes(cur, out: dict, rows=None) -> float:
    """The bytes the I16-in-P passes must move: the current MBs, the inter
    score, the qp plane and the left recon columns read once, ``mb_intra``
    and the I16 keys written, and each kept MB's levels, MV and recon."""
    nb, nc = out["mb_intra"].shape
    frac = 1.0 if rows is None else nb / (cur[0].shape[0] // 16)
    kept = int(out["mb_intra"].sum())
    per_mb = 4 + (4 if "qp_map" in out else 0) + 32
    return (frac * nbytes(*cur) + nb * nc * per_mb
            + nbytes(out["mb_intra"], out["i16_dc"], out["i16_ac"])
            + kept * (1024 + 8 + 2 * 64 * 4 + 384))


def i16halo_form_times(x: dict) -> dict:
    """Each of ``i16halo_forms(x)``.  The passes: the whole call eager and
    replayed, the replay without I16-in-P, the passes' host call by CUDA
    events (``i16_pass_ms``), their kernels by device time (the profiler's
    kernels whose name holds ``i16``), the kept MBs and the bound.  15e:
    eager, replayed, one of 32 in a graph, device time, the bound, and
    (halo on) the gather a plane by PyTorch indexing, replayed."""
    out = {}
    for name, (fn, base) in i16halo_forms(x).items():
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20)}
        split = kernel_split(fn)
        r["split"] = split
        if base is not None:
            r["base_graph_ms"] = graph_ms(base, reps=20)
            r["pass_ms"] = i16_pass_ms(fn)
            r["device_ms"] = float(sum(v for k, v in split.items() if "i16" in k)) \
                if split else -1.0
            o = fn()
            rows = x["rows"].get(int(name[8:])) if name.startswith("i16_rows") else None
            cur = x["desk"] if rows is not None or "desk" in name else x["noise"]
            r["kept"] = float(o["mb_intra"].sum())
            r["bound_ms"] = max(i16_bytes(cur, o, rows) / HBM_BYTES_PER_S,
                                I16_CAND_OPS * (o["mb_intra"].numel() + r["kept"])
                                / SCALAR_OPS_PER_S) * 1e3
        else:
            nx = int(name[7])
            pads = fn()
            r["each_ms"] = graph_each_ms(fn)
            r["device_ms"] = float(sum(split.values())) if split else -1.0
            r["bound_ms"] = (nbytes(*x["ref"]) + nbytes(*pads)) / HBM_BYTES_PER_S * 1e3
            if name.endswith("_on"):
                gidx = [halo_index(p.shape[0], p.shape[1], nx, p.device) for p in x["ref"]]
                gather = lambda gidx=gidx: [p.reshape(-1)[i] for p, i in zip(x["ref"], gidx)]
                check(all(a.equal(b) for a, b in zip(gather(), pads)),
                      f"{name}: the gather differs from the kernel")
                r["lib_graph_ms"] = graph_ms(gather, reps=20)
    return out


def i16halo_times() -> dict:
    """The ``i16halo`` set: ``i16halo_form_times`` as ``form_numbers``."""
    import torch

    return form_numbers(i16halo_form_times(i16halo_inputs(torch.device("cuda"))))


# -- K16a and K14d (the JPEG transform and the SSE reduction) -----------------
#
# ``k16a14d_inputs`` holds their main paths' inputs; ``pairs --set k16a14d``
# times ``k16a14d_times`` on each checkout (``chiprun_out/k16a14d_pairs.json``);
# ``k16a14d-split`` adds K16a's stages cut out of copies of jpeg.cu
# (``K16A_OLD_VARIANTS`` or ``K16A_VARIANTS``, by the layout the source
# holds) and the device times of the next kernels of the ranking
# (``next_rows``; ``chiprun_out/k16a14d_split.json``).

K16A_FORMS = ("t1080", "t_s4", "t4k", "t_odd")
SSE_FORMS = ("sse1080", "sse4k")


def k16a14d_inputs(dev) -> dict:
    """K16a's inputs at its main paths' shapes: a 1080p desktop frame with
    quality 85's tables (``tpumjpegenc``, RFB), the session batch's S = 4
    frames at 1920x1088, the desktop tiled to 4K and cut to 1919x1079 (edge
    clamps); K14d's: a desktop IDR's luma against a moved frame's at
    1088x1920 (the bench's PSNR) and both tiled to a 3840x2160 plane."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import quant

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lq, cq = quant.jpeg_quality_tables(85)
    f = mjpeg_frames(2)[1]
    bframes = np.stack([np.pad(g, ((0, BATCH_H - H), (0, 0), (0, 0)), "edge")
                        for g in mjpeg_frames(BATCH_S, seed=10)])
    g = gop_frames(2, seed=2)
    y0, y1 = pair_planes(g[0])[0], pair_planes(g[1])[0]
    return {"t1080": (up(f)[None], lq, cq, H_PAD, W),
            "t_s4": (up(bframes), lq, cq, BATCH_H, W),
            "t4k": (up(np.tile(f, (2, 2, 1)))[None], lq, cq, 2 * H, 2 * W),
            "t_odd": (up(f[:ODD_H, :ODD_W])[None], lq, cq, -(-ODD_H // 16) * 16,
                      -(-ODD_W // 16) * 16),
            "sse1080": (y0, y1),
            "sse4k": (y0[:H].repeat(2, 2).contiguous(), y1[:H].repeat(2, 2).contiguous())}


def k16a_bound_ms(t) -> float:
    """K16a's bound on ``(rgbs, lq, cq, pad_h, pad_w)``: the larger of its
    bytes (the frames read once, the levels written) and its float64
    operations (``K16A_FP64_OPS_PER_MCU``) over the card's rate."""
    rgbs, _, _, ph, pw = t
    nmcu = rgbs.shape[0] * (ph // 16) * (pw // 16)
    return max((nbytes(rgbs) + nmcu * 384 * 4) / HBM_BYTES_PER_S,
               K16A_FP64_OPS_PER_MCU * nmcu / FP64_OPS_PER_S) * 1e3


def k16a14d_form_times(x: dict) -> dict:
    """K16a at each of ``K16A_FORMS`` and K14d at each of ``SSE_FORMS``:
    eager (CUDA events around the wrapper), one replay of a graph of one
    call, one of 32 calls in a graph, the profiler's device ms by kernel
    (K14d's memset apart where the source still issues one) and the
    bound."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import aq
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    out = {}
    for name in K16A_FORMS + SSE_FORMS:
        fn = ((lambda t=x[name]: jd.jpeg_transform(*t)) if name in K16A_FORMS
              else (lambda p=x[name]: aq.sse_planes(*p)))
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20),
                         "each_ms": graph_each_ms(fn)}
        split = r["split"] = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        if name in K16A_FORMS:
            r["bound_ms"] = k16a_bound_ms(x[name])
        else:
            r["bound_ms"] = (nbytes(*x[name]) + 8) / HBM_BYTES_PER_S * 1e3
            r["memset_ms"] = float(sum(v for k, v in split.items() if "emset" in k))
    return out


def k16a14d_times() -> dict:
    """The ``k16a14d`` set: ``k16a14d_form_times`` as ``form_numbers``."""
    import torch

    return form_numbers(k16a14d_form_times(k16a14d_inputs(torch.device("cuda"))))


# -- K16b and K14a/K14r (the JPEG histograms and the qp plane) --------------
#
# ``k16b14a_inputs`` holds their main paths' inputs; ``pairs --set k16b14a``
# times ``k16b14a_times`` on each checkout (``chiprun_out/k16b14a_pairs.json``);
# ``k16b14a-split`` adds their stages cut out of copies of jpeg.cu and aq.cu
# (``K16B_VARIANTS``, ``K14A_VARIANTS``, where the sources hold the redesign)
# and the device times of the next kernels of the ranking (``next_rows``;
# ``chiprun_out/k16b14a_split.json``).

K16B_FORMS = ("h1080", "h_s4", "h4k")
K14A_FORMS = ("q1080", "q1080_next", "q_rows8", "q4k_next")


def k16b14a_inputs(dev) -> dict:
    """K16b's inputs at its main paths' shapes, each (y, cb, cr, nx): the
    levels of a 1080p desktop at quality 85 (``tpumjpegenc``, RFB), the
    session batch's S = 4 frames at 1920x1088 in nx = 4 strips, the
    desktop tiled to 4K; K14a's, each (y, next_y, rows): a moved desktop
    P frame's luma at 1088x1920 (tune=hq) without and with the lookahead
    frame, over a worklist of 8 rows (K14r, the damage mask), and both
    tiled to 4K with the lookahead."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.ops import quant

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lq, cq = quant.jpeg_quality_tables(85)
    f = mjpeg_frames(2)[1]
    bframes = np.stack([np.pad(g, ((0, BATCH_H - H), (0, 0), (0, 0)), "edge")
                        for g in mjpeg_frames(BATCH_S, seed=10)])
    g = gop_frames(2, seed=2)
    desk, moving = pair_planes(g[0])[0], pair_planes(g[1])[0]
    tile = lambda t: t[:H].repeat(2, 2).contiguous()
    lv = lambda rgbs, ph, pw: tuple(jd.jpeg_transform(rgbs, lq, cq, ph, pw))
    return {"h1080": lv(up(f)[None], H_PAD, W) + (1,),
            "h_s4": lv(up(bframes), BATCH_H, W) + (BATCH_NX,),
            "h4k": lv(up(np.tile(f, (2, 2, 1)))[None], 2 * H, 2 * W) + (1,),
            "q1080": (moving, None, None),
            "q1080_next": (moving, desk, None),
            "q_rows8": (moving, desk, torch.arange(20, 28, dtype=torch.int32, device=dev)),
            "q4k_next": (tile(moving), tile(desk), None)}


def k16b_bytes(t) -> int:
    """K16b's bytes on ``(y, cb, cr, nx)``: the levels read once, the
    histograms written."""
    return nbytes(*t[:3]) + t[1].shape[0] * 4 * 546


def k14a_bytes(t) -> int:
    """K14a's bytes on ``(y, next_y, rows)``: the listed rows of the luma
    (and of the next frame) read once, the rows read, the map written."""
    y, nxt, rows = t
    nb = y.shape[0] // 16 if rows is None else rows.numel()
    return (nb * 16 * y.shape[1] * (1 if nxt is None else 2) + nb * (y.shape[1] // 16) * 4
            + (0 if rows is None else nbytes(rows)))


def k16b14a_call(name: str, t):
    """The wrapper call of form ``name`` on its inputs ``t``: K16b's
    histograms or K14a's qp plane at ``PAIRS_QP``."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import aq
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    if name in K16B_FORMS:
        return lambda: jd.jpeg_analyze(*t)
    return lambda: aq.qp_plane(t[0], PAIRS_QP, t[1], rows=t[2])


def k16b14a_form_times(x: dict) -> dict:
    """K16b at each of ``K16B_FORMS`` and K14a at each of ``K14A_FORMS``:
    eager (CUDA events around the wrapper), one replay of a graph of one
    call, one of 32 calls in a graph, the profiler's device ms by kernel
    (K16b's memset apart where the source still issues one) and the
    bytes bound."""
    out = {}
    for name in K16B_FORMS + K14A_FORMS:
        fn = k16b14a_call(name, x[name])
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20),
                         "each_ms": graph_each_ms(fn)}
        split = r["split"] = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        r["memset_ms"] = float(sum(v for k, v in split.items() if "emset" in k))
        r["bound_ms"] = ((k16b_bytes if name in K16B_FORMS else k14a_bytes)(x[name])
                         / HBM_BYTES_PER_S * 1e3)
    return out


def k16b14a_times() -> dict:
    """The ``k16b14a`` set: ``k16b14a_form_times`` as ``form_numbers``."""
    import torch

    return form_numbers(k16b14a_form_times(k16b14a_inputs(torch.device("cuda"))))


# -- 13s and K13 (the forced-skip row gate and the reference-row scatter) ----
#
# ``k13s13_inputs`` holds their main paths' inputs; ``pairs --set k13s13``
# times ``k13s13_times`` on each checkout (``chiprun_out/k13s13_pairs.json``);
# ``k13s13-split`` adds their sizes changed in copies of spatial.cu, damage.cu
# and rowcopy.cuh (``K13S_VARIANTS``, ``K13_VARIANTS``, where the sources
# hold the redesign) and the device times of the next kernels of the ranking
# (``next_rows``; ``chiprun_out/k13s13_split.json``).

K13S_FORMS = ("s1080", "s1080_i16", "s4k")
K13_FORMS = ("r1", "r8", "r68", "r4k")


def k13s13_inputs(dev) -> dict:
    """13s's inputs at its main path's shapes, each (out, keep, refs): the
    P core's outputs of a moved 1080p desktop P frame with every other MB
    row gated (S20's form), the same at tune=hq with I16-in-P, and both
    frames tiled to 4K; K13's, each (refs, recon stack, rows): an IDR's
    reference planes with the P core's recon rows of 1 (row 33), 8 (rows
    20-27) and all 68 MB rows of 1080p, and 8 rows of 4K."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device, h264_inter

    qp, g = PAIRS_QP, gop_frames(2, seed=2)
    desk, moving = pair_planes(g[0]), pair_planes(g[1])
    tile = lambda ps: [p.repeat(2, 2).contiguous() for p in ps]
    desk4, moving4 = tile(desk), tile(moving)

    def refs_of(planes):
        lv = h264_device.encode_intra_frame_yuv(*planes, qp)
        return (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])

    ref, ref4 = refs_of(desk), refs_of(desk4)
    keep = lambda nr: torch.arange(nr, device=dev) % 2 == 0
    x = {"s1080": (h264_inter.encode_p_frame(*moving, *ref, qp), keep(H_PAD // 16), ref),
         "s1080_i16": (h264_inter.encode_p_frame(*moving, *ref, qp, tune="hq", p_intra=True),
                       keep(H_PAD // 16), ref),
         "s4k": (h264_inter.encode_p_frame(*moving4, *ref4, qp), keep(H_PAD // 8), ref4)}
    recon = lambda o: (o["recon_y"], o["recon_cb"], o["recon_cr"])
    for name, rows, cur, rf in (("r1", [33], moving, ref), ("r8", range(20, 28), moving, ref),
                                ("r4k", range(20, 28), moving4, ref4)):
        rows = torch.tensor(list(rows), dtype=torch.int32, device=dev)
        x[name] = (rf, recon(h264_inter.encode_p_frame_rows(*cur, *rf, rows, qp)), rows)
    x["r68"] = (ref, recon(x["s1080"][0]),
                torch.arange(H_PAD // 16, dtype=torch.int32, device=dev))
    return x


def k13s_bytes(t) -> int:
    """13s's bytes on ``(out, keep, refs)``: each gated row's bytes of
    every present tensor written once, its reference rows read once, keep
    read."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask

    out, keep, refs = t
    frame = (nbytes(*(out[k] for k in damage_mask._SKIP_ZERO if k in out))
             + nbytes(*refs) + nbytes(*(out[k] for k in damage_mask._SKIP_RECON)))
    return int((~keep).sum()) * frame // keep.numel() + keep.numel()


def k13s_stores(t) -> int:
    """The bytes 13s stores on ``(out, keep, refs)``: each gated row's
    bytes of every present tensor."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask

    out, keep, _ = t
    frame = nbytes(*(out[k] for k in damage_mask._SKIP_ZERO + damage_mask._SKIP_RECON
                     if k in out))
    return int((~keep).sum()) * frame // keep.numel()


def k13_bytes(t) -> int:
    """K13's bytes on ``(refs, recon stack, rows)``: every output byte
    written once and read once (from the reference or the stack), the rows
    read."""
    return 2 * nbytes(*t[0]) + nbytes(t[2])


def k13s13_call(name: str, t):
    """The wrapper call of form ``name`` on its inputs ``t``: 13s gating
    ``out`` in place, or K13's new planes."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask

    if name in K13S_FORMS:
        return lambda: damage_mask.force_skip_rows(t[0], t[1], *t[2])
    return lambda: damage_mask.scatter_rows(*t[0], *t[1], t[2])


def k13_library_call(t):
    """K13's yardstick: ``torch.index_copy`` (new planes), one call a
    plane."""
    import torch

    refs, rec, rows = t
    idx, nr, nb = rows.long(), refs[0].shape[0] // 16, rows.numel()
    return lambda: [torch.index_copy(p.view(nr, n, -1), 0, idx, r.view(nb, n, -1))
                    for p, r, n in zip(refs, rec, (16, 8, 8))]


def k13s13_form_times(x: dict) -> dict:
    """13s at each of ``K13S_FORMS`` and K13 at each of ``K13_FORMS``:
    eager (CUDA events around the wrapper), one replay of a graph of one
    call, one of 32 calls in a graph, the profiler's device ms by kernel
    and the bytes bound; 13s's forms also a memset of the bytes it stores
    (``zero_``), K13's ``torch.index_copy``, each by device ms and one of
    32."""
    import torch

    out = {}
    for name in K13S_FORMS + K13_FORMS:
        fn = k13s13_call(name, x[name])
        r = out[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn, reps=20),
                         "each_ms": graph_each_ms(fn)}
        split = r["split"] = kernel_split(fn)
        r["device_ms"] = float(sum(split.values())) if split else -1.0
        r["bound_ms"] = ((k13s_bytes if name in K13S_FORMS else k13_bytes)(x[name])
                         / HBM_BYTES_PER_S * 1e3)
        if name in K13S_FORMS:
            # the stores' own floor: a memset of as many bytes as 13s stores
            zero = torch.empty(k13s_stores(x[name]), dtype=torch.uint8, device=x[name][1].device)
            ssplit = kernel_split(zero.zero_)
            r["store_device_ms"] = float(sum(ssplit.values())) if ssplit else -1.0
            r["store_each_ms"] = graph_each_ms(zero.zero_)
        if name in K13_FORMS:
            lib = k13_library_call(x[name])
            lsplit = kernel_split(lib)
            r["lib_device_ms"] = float(sum(lsplit.values())) if lsplit else -1.0
            r["lib_each_ms"] = graph_each_ms(lib)
            r["lib_ms"] = cuda_ms(lib, reps=20)
    return out


def k13s13_times() -> dict:
    """The ``k13s13`` set: ``k13s13_form_times`` as ``form_numbers``."""
    import torch

    return form_numbers(k13s13_form_times(k13s13_inputs(torch.device("cuda"))))


# the measured sets: (timing function, the sources whose ptxas lines a
# build prints, the output file's stem)
PAIR_SETS = {"k1k6": (k1k6_times, ("intra", "cavlc")),
             "k5k4": (k5k4_times, ("inter", "content")),
             "k2k8": (k2k8_times, ("cavlc", "deblock")),
             "k3k7": (k3k7_times, ("pack",)),
             "k11k16": (k11k16_times, ("jpeg", "cabac")),
             "k10k11i": (k10k11i_times, ("levelpack", "cabac")),
             "i16halo": (i16halo_times, ("inter", "spatial")),
             "k16a14d": (k16a14d_times, ("jpeg", "aq")),
             "k16b14a": (k16b14a_times, ("jpeg", "aq")),
             "k13s13": (k13s13_times, ("spatial", "damage"))}


def pairs_child(set_name: str, tree: str, build_only: bool) -> dict:
    """One run of a pairs set: import the port from ``tree``, then build
    (printing the set's ``-Xptxas -v`` lines) or time the set."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device")
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    mod = sys.modules[PKG]
    check(mod.__file__.startswith(os.path.abspath(tree)),
          f"imported {mod.__file__}, not the package of {tree}")
    times, srcs = PAIR_SETS[set_name]
    if build_only:
        logs = _cuda.build(verbose=True)
        return {"built": tree, "ptxas": {k: ptxas_lines(logs.get(k, ""))
                                         for k in srcs}}
    return times()


def pairs(argv, set_name=None) -> int:
    """``pairs --set NAME`` (``k1k6-pairs`` is ``--set k1k6``): the set's
    timings of each NAME=PATH checkout in alternating fresh processes;
    writes ``chiprun_out/<set>_pairs.json``."""
    import argparse

    import torch

    prog = "k1k6-pairs" if set_name else "pairs"
    ap = argparse.ArgumentParser(prog=f"chip_smoke.py {prog}")
    ap.add_argument("variants", nargs="*", help="NAME=PATH")
    ap.add_argument("--set", choices=sorted(PAIR_SETS), default=set_name or "k1k6")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(pairs_child(args.set, args.child, args.build_only)))
        return 0
    check(torch.cuda.is_available(), "no CUDA device")
    variants = []
    for v in args.variants:
        name, tree = v.split("=", 1)
        check(os.path.isdir(os.path.join(tree, PKG)), f"bad variant {v!r}")
        variants.append((name, tree))
    check(bool(variants), "give at least one NAME=PATH")

    def one(tree, build_only=False):
        cmd = [sys.executable, os.path.abspath(__file__), "pairs", "--set",
               args.set, "--child", tree] + (["--build-only"] if build_only else [])
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                           cwd=HERE)
        check(p.returncode == 0, f"run of {tree} failed:\n{p.stderr[-4000:]}")
        return json.loads(p.stdout.strip().splitlines()[-1])

    smi = smi_line()
    print(smi, flush=True)
    builds = {}
    for name, tree in variants:                 # builds, untimed
        builds[name] = one(tree, build_only=True)
        for src, lines in builds[name]["ptxas"].items():
            for ln in lines:
                print(f"ptxas {name} {src}: {ln}", flush=True)
    runs = []
    for i in range(args.pairs):
        for name, tree in (variants if i % 2 == 0 else variants[::-1]):
            r = dict(one(tree), variant=name, round=i)
            runs.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    for name, _ in variants:
        mine = [r for r in runs if r["variant"] == name]
        summary[name] = {k: statistics.median(r[k] for r in mine)
                         for k, v in mine[0].items() if isinstance(v, float)}
    print(json.dumps({"card": smi, "summary": summary}))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{args.set}_pairs.json"),
              "w") as f:
        json.dump({"card": smi, "builds": builds, "runs": runs,
                   "summary": summary}, f, indent=1)
    return 0


_SHFL = "__shfl_sync(FULL, {x}[v], base{o})"


def _quad(x: str) -> str:
    """intra.cu's four shuffles of ``x[v]`` across a candidate's lanes."""
    a = ", ".join(f"{x}{i} = " + _SHFL.format(x=x, o=f" + {i}" if i else "")
                  for i in range(2))
    b = ", ".join(f"{x}{i} = " + _SHFL.format(x=x, o=f" + {i}")
                  for i in range(2, 4))
    return f"      const int {a},\n                {b};"


def _fake(x: str) -> str:
    return (f"      const int {x}0 = {x}[v], {x}1 = {x}[v] + 1, "
            f"{x}2 = {x}[v] - 1, {x}3 = {x}[v] * 3;")


K1_VARIANTS = {
    "base": [],
    "no_i4": [("i4_mb<MODES, TIER>(s, par, left, has_left, Q, lam, i4);",
               "if (i4 == 0) s.bits4[par] = 0;")],
    "noshfl_fwd": [(_quad("t"), _fake("t"))],
    "noshfl_inv": [(_quad("f"), _fake("f"))],
    "no_bits_shfl": [("  bits += __shfl_xor_sync(FULL, bits, 1);\n"
                      "  bits += __shfl_xor_sync(FULL, bits, 2);", "")],
    "no_pick": [("    k = c1 < c0 ? 1 : 0;\n    k = c2 < (k ? c1 : c0) ? 2 : k;\n"
                 "  } else {", "    k = (c0 + c1 + c2) & 0;\n  } else {")],
    "no_sync": [("      __syncwarp();\n    }\n  }\n  i4_barrier();",
                 "    }\n  }\n  i4_barrier();"),
                ("lane < 24, left, has_left, Q, lam, lane);\n      i4_barrier();",
                 "lane < 24, left, has_left, Q, lam, lane);")],
}


def build_variants(src_name: str, variants: dict) -> dict:
    """Copies of ``csrc/<src_name>.cu`` and the headers with each
    variant's substitutions, (old, new) in the source or (header, old,
    new), built at once into ``.tree/<src_name>_variants/<name>``
    (timing only: a cut part leaves wrong outputs), each copy's
    ``-Xptxas -v`` register and spill lines printed.  Returns {name: the
    loaded library}."""
    import ctypes

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    csrc = _cuda.CSRC
    out_dir = os.path.join(HERE, ".tree", f"{src_name}_variants")
    files = [f"{src_name}.cu"] + [f for f in os.listdir(csrc) if f.endswith(".cuh")]
    procs = {}
    for name, subs in variants.items():
        texts = {f: open(os.path.join(csrc, f)).read() for f in files}
        for sub in subs:
            f, old, new = sub if len(sub) == 3 else (f"{src_name}.cu", *sub)
            check(old in texts[f], f"{name}: pattern not in {f}: {old[:60]!r}")
            texts[f] = texts[f].replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [_cuda.nvcc()] + _cuda._NVCC_FLAGS + ["-Xptxas", "-v"]
            + ["-o", os.path.join(d, "lib.so"),
               os.path.join(d, f"{src_name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        check(p.returncode == 0, f"{name}: nvcc failed\n{log[-3000:]}")
        for ln in ptxas_lines(log):
            if "Used" in ln or "spill" in ln:
                print(f"ptxas {src_name} {name}: {ln}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
    return libs


def k1_variants() -> int:
    import ctypes

    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops.h264_device import PRE_WORDS
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    smi = smi_line()
    print(smi, flush=True)
    libs = build_variants("intra", K1_VARIANTS)
    dev = torch.device("cuda")
    y, cb, cr = [torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in
                 rgb_to_yuv420_host(desktop_frames(2)[0], H_PAD, W)]
    nr, nc = H_PAD // 16, W // 16
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    ptrs = [y, cb, cr, i32(nr, nc, 16), i32(nr, nc, 16, 15), i32(nr, nc, 4),
            i32(nr, nc, 4, 15), i32(nr, nc, 4), i32(nr, nc, 4, 15),
            i32(nr, nc), torch.empty((nr, nc), dtype=torch.uint8, device=dev),
            i32(nr, nc, 16), i32(nr, nc, 16, 16), torch.empty_like(y),
            torch.empty_like(cb), torch.empty_like(cr),
            i32(nr * nc, PRE_WORDS)]
    res = {}
    for name in K1_VARIANTS:
        fn = libs[name].intra_frame_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])

        def call():
            err = fn(*[t.data_ptr() for t in ptrs], nr, nc, 26, 26, 0, 1,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{name}: CUDA error {err}")
        res[name] = graph_ms(call, reps=20)
        print(f"{name}: {res[name]:.4f} ms", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k1_variants.json"), "w") as f:
        json.dump({"card": smi, "ms": res}, f, indent=1)
    return 0


K5K4_QP = 26


def texture(h: int, w: int, dev, seed: int):
    """A smooth seeded texture with fine noise (uint8 (h, w)): every
    shift of it is distinct, so the search finds the true motion."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    lo = torch.randint(0, 256, (1, 1, h // 8 + 4, w // 8 + 4), generator=g)
    t = F.interpolate(lo.float(), scale_factor=8, mode="bicubic",
                      align_corners=False)[0, 0, :h, :w]
    t = t + torch.randint(-6, 7, (h, w), generator=g)
    return t.clamp(0, 255).to(torch.uint8).to(dev)


def moved(p, dy: int, dx: int):
    """``p`` moved by (dy, dx) pels, the edges replicated."""
    import torch

    h, w = p.shape
    iy = (torch.arange(h, device=p.device) - dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=p.device) - dx).clamp(0, w - 1)
    return p[iy][:, ix].contiguous()


def k4_frame(nr: int, nc: int, kinds, dev, seed: int):
    """A luma plane of nr x nc MBs whose MB i is flat (kind 0) or one of
    two fixed textures (kinds 1, 2): three activity values, in the
    numbers ``kinds`` gives, at shuffled places."""
    import torch

    g = torch.Generator().manual_seed(seed)
    tex = torch.randint(0, 256, (3, 16, 16), generator=g, dtype=torch.int64)
    tex[0] = 77                                     # activity 0
    tex[1] = tex[1] // 4 + 60                       # below kind 2's
    order = torch.randperm(nr * nc, generator=g)
    kind = torch.cat([torch.full((k,), i) for i, k in enumerate(kinds)])[order]
    mbs = tex[kind].reshape(nr, nc, 16, 16).permute(0, 2, 1, 3)
    return mbs.reshape(nr * 16, nc * 16).to(torch.uint8).to(dev)


def k5k4_phase(report):
    """K5 and K4 on the inputs that break their designs, against the plain
    versions.  K5 (1080p unless said): textures moved by (+-9, +-9) (the
    MV at the window's edge, every frame edge's window clamped), an
    unchanged flat frame and one lifted by 3 (all 81 coarse SADs tie),
    a flat frame over raised blocks (the four corner shifts tie: the first
    minimum decides),
    noise, 4K (3840x2176), each tier (I16-in-P at the hq tiers), eight
    stacked sessions, the padded form (K5p), refine="full" and K5r's
    worklists at the frame's edge rows and at 64 rows.  K4: a flat frame,
    one texture everywhere (every activity equal), three activities placed
    so that the p50 and p95 positions fall on either side of a run's end
    or inside it, synthetic MV fields with repeated magnitudes, the
    intra, full and mb_intra forms, 4K (n = 32640) and K4c at K = 4 with
    and without ``prev``."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, content_stats, h264_inter

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k5k4"] = {}
    qp = K5K4_QP
    k5 = h264_inter.encode_p_frame
    outs = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac", "recon_y",
            "recon_cb", "recon_cr")

    def yuv(y, seed):
        h, w = y.shape
        return [y, texture(h // 2, w // 2, dev, seed),
                texture(h // 2, w // 2, dev, seed + 1)]

    def same(label, got, want):
        for k in want:
            check(torch.equal(got[k], want[k]), f"{label}: {k} differs")

    def held(label, cur, ref, tune="off", qp_=qp, **kw):
        pi = tune != "off"
        got = k5(*cur, *ref, qp_, tune=tune, p_intra=pi, **kw)
        qm = got.get("qp_map")
        want = h264_inter.encode_p_frame_plain(*cur, *ref, qp_, tune, qm, pi,
                                               **kw)
        same(f"K5 {label} {tune}", got, want)
        return got

    base = texture(H_PAD, W, dev, 51)
    ref = yuv(base, 52)
    mvs = {}
    for dy, dx in ((9, 9), (-9, -9), (9, -9), (-9, 9)):
        cur = [moved(p, dy // (1 + (i > 0)), dx // (1 + (i > 0)))
               for i, p in enumerate(ref)]
        for tune in ("off",) if (dy, dx) != (9, 9) else aq.TIERS:
            got = held(f"moved ({dy}, {dx})", cur, ref, tune)
        # interior MBs find the move at the window's edge: -4 x (dy, dx)
        inner = got["mv"][2:-2, 2:-2].reshape(-1, 2)
        mvs[f"{dy},{dx}"] = float((inner == torch.tensor(
            [-4 * dy, -4 * dx], device=dev)).all(dim=1).float().mean())
    rep["moved_mv_share"] = mvs
    check(min(mvs.values()) > 0.5, f"K5: the moves were not found: {mvs}")
    flat = [torch.full_like(p, 128) for p in ref]
    lifted = [p + 3 for p in flat]
    held("unchanged flat", flat, flat)
    # raised 16x16 blocks at the MBs of even row and column on a flat
    # reference, a flat current frame: there the four corner shifts
    # (+-8, +-8) tie as the smallest coarse SAD and the first decides
    raised = flat[0].clone().view(H_PAD // 16, 16, W // 16, 16)
    raised[0::2, :, 0::2, :] += 60
    tie_ref = [raised.view(H_PAD, W)] + flat[1:]
    for tune in aq.TIERS:
        got = held("flat on raised blocks", flat, tie_ref, tune)
        held("flat +3", lifted, flat, tune)
        if tune == "off":
            rep["tie_mv"] = got["mv"][2, 2].tolist()
    g = torch.Generator().manual_seed(53)
    noise = [torch.randint(0, 256, p.shape, generator=g, dtype=torch.uint8)
             .to(dev) for p in ref]
    for tune in ("off", "hq"):
        held("noise", noise, ref, tune)
    big = texture(2 * H_PAD, 2 * W, dev, 54)
    bref = yuv(big, 55)
    bcur = [moved(p, 5 // (1 + (i > 0)), -3) for i, p in enumerate(bref)]
    held("4K", bcur, bref)
    held("4K", bcur, bref, "hq")
    # eight sessions stacked: the moves, the flat tie, noise and the desktop
    sess_c, sess_r = [], []
    for dy, dx in ((9, 9), (-9, -9), (9, -9), (-9, 9), (0, 0), (3, -2)):
        sess_c.append([moved(p, dy // (1 + (i > 0)), dx // (1 + (i > 0)))
                       for i, p in enumerate(ref)])
        sess_r.append(ref)
    sess_c += [lifted, noise]
    sess_r += [flat, ref]
    st = lambda ps, i: torch.stack([p[i] for p in ps])
    got = k5(*(st(sess_c, i) for i in range(3)), *(st(sess_r, i) for i in range(3)), qp)
    for s in range(8):
        want = h264_inter.encode_p_frame_plain(*sess_c[s], *sess_r[s], qp)
        same(f"K5 sessions, session {s}", {k: got[k][s] for k in outs}, want)
    # the padded form, refine="full" and the worklists
    cur = [moved(p, -9 // (1 + (i > 0)), 9 // (1 + (i > 0)))
           for i, p in enumerate(ref)]
    pads = [h264_inter._edge_pad(p.to(torch.int32), h264_inter._PAD)
            .to(torch.uint8).contiguous() for p in ref]
    for tune in aq.TIERS:
        pi = tune != "off"
        got = h264_inter.encode_p_frame_padded_ref(*cur, *pads, qp, tune=tune,
                                                   p_intra=pi)
        want = h264_inter.encode_p_frame_padded_ref_plain(
            *cur, *pads, qp, tune, got.get("qp_map"), pi)
        same(f"K5p {tune}", got, want)
        held("moved, refine=full", cur, ref, tune, refine="full")
    nr = H_PAD // 16
    for rows in ([0, nr - 1, nr // 2, 0], list(range(max(nr - 64, 0), nr))):
        rt = torch.tensor(rows, dtype=torch.int32, device=dev)
        for tune in aq.TIERS:
            pi = tune != "off"
            got = h264_inter.encode_p_frame_rows(*cur, *ref, rt, qp, tune,
                                                 p_intra=pi)
            want = h264_inter.encode_p_frame_rows_plain(
                *cur, *ref, rt, qp, tune, got.get("qp_map"), pi)
            same(f"K5r {len(rows)} rows {tune}", got, want)
    torch.cuda.synchronize()
    print("(a) k5k4: K5 equal to plain on moves of (+-9, +-9) (interior MV "
          f"at the window's edge: {mvs}), an unchanged flat frame, a flat "
          "frame +3 (all coarse SADs tie) and a flat frame on raised blocks "
          f"(four corner shifts tie; MV {rep['tie_mv']}), noise and 4K, at "
          "each tier; 8 stacked "
          "sessions; K5p, refine=full and K5r at edge rows and 64 rows at "
          "each tier")

    # -- K4 --------------------------------------------------------------
    errs = []

    def held4(label, ys, prev, recon=None, mvs=None, resid=None, mb_intra=None):
        args = (recon, mvs, resid, mb_intra)
        v_k, g_k = content_stats.chunk_stats(ys, prev, 512, *args)
        v_p, g_p = content_stats.chunk_stats_plain(ys, prev, 512, *args)
        check(torch.equal(g_k, g_p), f"K4 {label}: damage grid differs")
        ints = [1, 2, 3, 4, 9]
        check(torch.equal(v_k[:, ints], v_p[:, ints]),
              f"K4 {label}: integer fields differ {v_k} {v_p}")
        rel = ((v_k - v_p).abs() / v_p.abs().clamp(min=1)).max()
        check(float(rel) <= EXACT_REL_TOL, f"K4 {label}: {v_k} vs {v_p}")
        errs.append(float((v_k - v_p).abs().max()))
        return v_k

    def synth(nr, nc, seed):
        """An MV field of few magnitudes and sparse residual levels."""
        g = torch.Generator().manual_seed(seed)
        mv = torch.tensor([0, 4, -4, 9, -36, 12], dtype=torch.int32)[
            torch.randint(0, 6, (nr, nc, 2), generator=g)]
        res = []
        for shape in ((16, 16), (4,), (4, 15), (4,), (4, 15)):
            t = torch.randint(-1, 2, (nr, nc) + shape, generator=g,
                              dtype=torch.int32)
            t *= torch.rand((nr, nc) + (1,) * len(shape), generator=g) < 0.3
            res.append(t.to(dev))
        intra = (torch.rand((nr, nc), generator=g) < 0.1).to(dev)
        return mv.to(dev), tuple(res), intra

    nr, nc = H_PAD // 16, W // 16
    n = nr * nc
    p50_lo = (n - 1) // 2                 # floor(0.5 (n - 1))
    p95_lo = int(np.floor(np.float32(0.95) * np.float32(n - 1)))
    cases = {
        "flat": [n, 0, 0],
        "one texture": [0, n, 0],
        "runs end at both positions": [p50_lo + 1, p95_lo - p50_lo, n - p95_lo - 1],
        "runs hold both positions": [p50_lo + 3, p95_lo - p50_lo - 5, n - p95_lo + 2],
    }
    mv, resid, intra = synth(nr, nc, 56)
    prev = texture(H_PAD, W, dev, 57)
    for i, (label, kinds) in enumerate(cases.items()):
        y = k4_frame(nr, nc, kinds, dev, 60 + i)[None]
        one = lambda t: t[None]
        v = held4(f"{label}, intra form", y, prev)
        held4(f"{label}, full form", y, prev, y[0] ^ 1, one(mv),
              tuple(map(one, resid)))
        held4(f"{label}, mb_intra", y, prev, y[0] ^ 1, one(mv),
              tuple(map(one, resid)), one(intra))
        held4(f"{label}, no prev", y, None)
        rep.setdefault("act_pct", {})[label] = [float(v[0, 7]), float(v[0, 8])]
    by = k4_frame(2 * nr, 2 * nc, [2 * n, 2 * n - 7, 7], dev, 65)
    bmv, bres, bintra = synth(2 * nr, 2 * nc, 66)
    held4("4K", by[None], moved(by, 1, 1), by ^ 2, bmv[None],
          tuple(t[None] for t in bres), bintra[None])
    ys = torch.stack([k4_frame(nr, nc, kinds, dev, 70 + i)
                      for i, kinds in enumerate(cases.values())])
    st4 = lambda t: torch.stack([t] * 4)
    for pv in (None, prev):
        held4("K4c, K = 4", ys, pv, ys[-1] ^ 3, st4(mv),
              tuple(st4(t) for t in resid))
        held4("K4c, K = 4, intra form", ys, pv)
    rep["k4_max_abs_err"] = max(errs)
    rep["s"] = time.perf_counter() - t_phase
    print("(a) k5k4: K4 (intra, full, mb_intra, no prev) equal to plain on a "
          "flat frame, one texture everywhere and three activities whose runs "
          "end at or hold the p50/p95 positions (p50, p95: "
          f"{rep['act_pct']}), 4K, K4c at K = 4 with and without prev; max "
          f"abs err {max(errs):.3g}; {rep['s']:.1f} s")
    return []


K2K8_QP = 30


def k8_planes(h: int, w: int, dev, seed: int):
    """Planes whose MB rows cycle through four bands: a smooth texture,
    full noise, saturated 0/255 (alternate rows all 0, all 255, then a
    0/255 checkerboard: the clips) and flat areas with small steps at the
    4x4 and MB edges (the strong filter on both sides)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def one(hh, ww, mb, s):
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(ww, device=dev)[None, :]
        tex = texture(hh, ww, dev, s).to(torch.int64)
        noise = torch.randint(0, 256, (hh, ww), generator=g).to(dev)
        sat = torch.where((yy // mb) % 8 < 2, 0, torch.where(
            (yy // mb) % 8 < 4, 255, (yy + xx) % 2 * 255)).expand(hh, ww)
        flat = (120 + (xx // mb) % 2 * 2 + (xx // (mb // 4)) % 2).expand(hh, ww)
        band = ((yy // mb) % 4).expand(hh, ww)
        out = torch.where(band == 0, tex, torch.where(
            band == 1, noise, torch.where(band == 2, sat, flat)))
        return out.to(torch.uint8).contiguous()
    return [one(h, w, 16, seed), one(h // 2, w // 2, 8, seed + 1),
            one(h // 2, w // 2, 8, seed + 2)]


def k8_p_inputs(nr: int, nc: int, dev, seed: int, lead=()):
    """P-frame K8 inputs: coded flags at random (30%), and MVs whose step
    from the left MB is 0, 3 or 4 quarter pels in x or y (bS 1 exactly at
    4), with the luma levels whose coded blocks are those flags."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops.cavlc_device import _BLK_X, _BLK_Y

    g = torch.Generator().manual_seed(seed)
    nz = torch.rand(lead + (nr, nc, 4, 4), generator=g) < 0.3
    steps = torch.tensor([0, 3, -3, 4, -4], dtype=torch.int32)[
        torch.randint(0, 5, lead + (nr, nc, 2), generator=g)]
    steps *= torch.rand(lead + (nr, nc, 1), generator=g) < 0.5
    mv = steps.cumsum(-2).to(torch.int32)
    by, bx = torch.as_tensor(_BLK_Y).long(), torch.as_tensor(_BLK_X).long()
    lv = torch.randint(-2, 3, lead + (nr, nc, 16, 16), generator=g,
                       dtype=torch.int32)
    lv[..., 0] = torch.where(lv[..., 0] == 0, 1, lv[..., 0])
    lv *= nz[..., by, bx][..., None]
    return nz.to(dev), mv.to(dev), lv.to(dev)


def k2_levels(nr: int, nc: int, dev, seed: int, kind: str, lead=()):
    """Synthetic level tensors for K2: ``rand`` (sparse small levels, I4
    and I16 MBs mixed in every row), ``zero``, ``escape`` (every block
    dense, a fifth of the levels large enough for the escape codes,
    level_prefix 15-17), ``cdc`` (chroma DC only, no chroma AC) and
    ``cac`` (chroma AC, no luma)."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device

    g = torch.Generator().manual_seed(seed)
    big = torch.tensor([1, -1, 2, 40, -300, 2000, -5000, 9000, -12000],
                       dtype=torch.int32)
    out = {}
    for k, shape in cavlc_device._level_shapes(nr, nc).items():
        shape = lead + shape
        if k == "mb_i4":
            out[k] = torch.rand(shape, generator=g) < 0.5
        elif k == "i4_modes":
            out[k] = torch.randint(0, 9, shape, generator=g, dtype=torch.int32)
        elif k == "pred_mode":
            out[k] = torch.randint(0, 4, shape, generator=g, dtype=torch.int32)
        elif kind == "zero":
            out[k] = torch.zeros(shape, dtype=torch.int32)
        elif kind == "escape":
            t = torch.randint(1, 4, shape, generator=g, dtype=torch.int32)
            t *= torch.where(torch.rand(shape, generator=g) < 0.5, 1, -1).to(torch.int32)
            out[k] = torch.where(torch.rand(shape, generator=g) < 0.2, big[
                torch.randint(0, 9, shape, generator=g)], t)
        else:
            t = torch.randint(-2, 3, shape, generator=g, dtype=torch.int32)
            t *= torch.rand(shape, generator=g) < 0.3
            if (kind == "cdc" and k in ("cb_ac", "cr_ac")) or (
                    kind == "cac" and k.startswith("luma")):
                t.zero_()
            out[k] = t
    return {k: v.to(dev) for k, v in out.items()}


def k2k8_phase(report):
    """K2 and K8 on the inputs that break their designs, against the plain
    versions.  K8: intra frames at qp 15 (alpha 0: nothing filters), 30
    and 51 over bands of texture, noise, saturated 0/255 rows and flat
    areas (640x1088); a P frame with random coded flags and MV steps of
    exactly 3 and 4 quarter pels; the ``luma`` and ``qp_dev`` forms at a
    qp other than the host's; 8 stacked 1080p sessions, worklist frames of
    1, 8 and 68 rows and two shards of 34 rows (one plain pass over the
    sessions' rows holds them all); 4K.  K2: all-zero levels, dense
    levels with escape codes, rows mixing I4 and I16, chroma DC only and
    chroma AC, at widths of 1, 33, 120 and 240 MBs; K1's levels of a noise
    frame at qp 4; 8 stacked sessions; the qp chain over 1 and 4 bands."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        cavlc_device, h264_deblock, h264_device)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k2k8"] = {}
    k8, k8p = h264_deblock.deblock_frame, h264_deblock.deblock_frame_plain
    k2, k2p = cavlc_device.frame_block_slots, cavlc_device.frame_block_slots_plain
    saved = (k8.launches, k2.launches, k2.hq.launches)
    qp = K2K8_QP

    def same(label, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            check(torch.equal(a, b), f"{label}: output {i} differs")

    # -- K8 --------------------------------------------------------------
    narrow = k8_planes(1088, 640, dev, 80)
    nr, nc = 1088 // 16, 640 // 16
    for q in (15, 30, 51):
        same(f"K8 intra qp {q}", k8(*narrow, q), k8p(*narrow, q))
    nz, mv, lv = k8_p_inputs(nr, nc, dev, 81)
    same("K8 P (random flags, MV steps 3 and 4)",
         k8(*narrow, qp, nnz_blk=nz, mv=mv), k8p(*narrow, qp, nz, mv))
    qd = torch.tensor([38], dtype=torch.int32, device=dev)
    same("K8 luma + qp_dev 38 (host qp 30)",
         k8(*narrow, qp, mv=mv, luma=lv, qp_dev=qd), k8p(*narrow, 38, None, mv, lv))
    same("K8 intra + qp_dev 38", k8(*narrow, qp, qp_dev=qd), k8p(*narrow, 38))
    # 8 stacked 1080p sessions; one plain pass over their rows
    sess = [k8_planes(H_PAD, W, dev, 90 + i) for i in range(8)]
    st = [torch.stack([p[i] for p in sess]) for i in range(3)]
    nr, nc = H_PAD // 16, W // 16
    nz8, mv8, lv8 = k8_p_inputs(nr, nc, dev, 82, lead=(8,))
    tall = [t.reshape(-1, t.shape[-1]) for t in st]
    want = k8p(*tall, qp, nz8.reshape(-1, nc, 4, 4), mv8.reshape(-1, nc, 2))
    want = [w.reshape(t.shape) for w, t in zip(want, st)]
    got = k8(*st, qp, nnz_blk=nz8, mv=mv8)
    same("K8 8 sessions (nnz_blk)", got, want)
    same("K8 8 sessions (luma)", k8(*st, qp, mv=mv8, luma=lv8), want)
    for r0, b in ((5, 1), (20, 8), (0, 68)):      # worklist frames of b rows
        planes = [st[0][3, r0 * 16:(r0 + b) * 16].contiguous(),
                  st[1][3, r0 * 8:(r0 + b) * 8].contiguous(),
                  st[2][3, r0 * 8:(r0 + b) * 8].contiguous()]
        got = k8(*planes, qp, mv=mv8[3, r0:r0 + b].contiguous(),
                 luma=lv8[3, r0:r0 + b].contiguous())
        same(f"K8 worklist of {b} rows", got, [
            want[0][3, r0 * 16:(r0 + b) * 16], want[1][3, r0 * 8:(r0 + b) * 8],
            want[2][3, r0 * 8:(r0 + b) * 8]])
    shards = [t[5].reshape(2, t.shape[1] // 2, t.shape[2]) for t in st]
    got = k8(*shards, qp, nnz_blk=nz8[5].reshape(2, nr // 2, nc, 4, 4),
             mv=mv8[5].reshape(2, nr // 2, nc, 2))
    same("K8 nx = 2 shard rows", got, [w[5].reshape(g.shape) for w, g in zip(want, got)])
    big = k8_planes(2 * H_PAD, 2 * W, dev, 83)
    bnz, bmv, _ = k8_p_inputs(2 * nr, 2 * nc, dev, 84)
    same("K8 4K P", k8(*big, qp, nnz_blk=bnz, mv=bmv), k8p(*big, qp, bnz, bmv))
    torch.cuda.synchronize()
    rep["k8_s"] = time.perf_counter() - t_phase
    print("(a) k2k8: K8 equal to plain on intra frames at qp 15, 30 and 51 "
          "(texture, noise, saturated and flat bands, 640x1088), a P frame "
          "with random flags and MV steps of 3 and 4 quarter pels, the luma "
          "and qp_dev forms at qp 38 on a host qp of 30, 8 stacked 1080p "
          "sessions (nnz_blk and luma), worklist frames of 1, 8 and 68 rows, "
          f"nx = 2 shard rows and 4K; {rep['k8_s']:.1f} s")

    # -- K2 --------------------------------------------------------------
    t0 = time.perf_counter()
    n = 0
    for width in (1, 33, 120, 240):
        for i, kind in enumerate(("rand", "zero", "escape", "cdc", "cac")):
            lv = k2_levels(8, width, dev, 100 + i + width, kind)
            same(f"K2 {kind}, {width} MBs wide", k2(lv), k2p(lv))
            n += 1
    noise = [torch.randint(0, 256, p.shape, generator=torch.Generator()
                           .manual_seed(101 + i), dtype=torch.uint8).to(dev)
             for i, p in enumerate(pair_planes(gop_frames(1, seed=5)[0]))]
    ilv = h264_device.encode_intra_frame_yuv(*noise, 4)
    ilv = {k: ilv[k] for k in cavlc_device._LEVEL_KEYS}
    got = k2(ilv)
    same("K2 K1's levels of noise at qp 4", got, k2p(ilv))
    rep["k2_noise_max_len"] = int(got[1].max())
    lv8 = k2_levels(H_PAD // 16, W // 16, dev, 102, "rand", lead=(8,))
    got = k2(lv8)
    for i in range(8):
        same(f"K2 8 sessions, session {i}", [t[i] for t in got],
             k2p({k: v[i] for k, v in lv8.items()}))
    lvq = k2_levels(H_PAD // 16, W // 16, dev, 103, "rand")
    g = torch.Generator().manual_seed(104)
    lvq["qp_map"] = torch.randint(20, 41, (H_PAD // 16, W // 16), generator=g,
                                  dtype=torch.int32).to(dev)
    for sh in (1, 4):
        same(f"K2 with the qp chain, {sh} bands", k2(lvq, qp, sh), k2p(lvq, qp, sh))
    torch.cuda.synchronize()
    rep["k2_s"] = time.perf_counter() - t0
    rep["s"] = time.perf_counter() - t_phase
    k8.launches, k2.launches, k2.hq.launches = saved
    print(f"(a) k2k8: K2 equal to plain on {n} synthetic frames (random with "
          "I4 and I16 mixed, all-zero, escape codes, chroma DC only, chroma "
          "AC) at 1, 33, 120 and 240 MBs wide, K1's levels of noise at qp 4 "
          f"(longest slot {rep['k2_noise_max_len']} bits), 8 stacked 1080p "
          f"sessions and the qp chain over 1 and 4 bands; {rep['k2_s']:.1f} s; "
          f"phase {rep['s']:.1f} s")
    return []


def k3k7_call(x: dict, p: bool, fn_i, fn_p, qp: bool = False, sess=None):
    """A packer (``fn_i`` for K3, ``fn_p`` for K7) on ``k3k7_slots``'
    tensors: the session axis dropped where ``sess`` is given, the header
    slots squeezed where shared."""
    pick = (lambda t: t[sess]) if sess is not None else (lambda t: t)
    hv, hl = x["hdr_vals"], x["hdr_lens"]
    if hv.shape[0] == 1 or sess is not None:
        hv, hl = (h[0] if h.shape[0] == 1 else h[sess] for h in (hv, hl))
    q = None
    if qp:
        q = x["qp_sum"][sess:sess + 1] if sess is not None else x["qp_sum"]
    if p:
        return fn_p(*(pick(x[k]) for k in ("values", "lengths", "syn_vals",
                                            "syn_lens", "run_vals", "run_lens")),
                    hv, hl, qp_sum=q)
    return fn_i(*(pick(x[k]) for k in ("values", "lengths", "syn_vals",
                                        "syn_lens")), hv, hl, qp_sum=q)


def k3k7_phase(report):
    """K3 and K7 (26 blocks, and 27 with the qp sum) on synthetic slots
    that break the segment design (``tests/pack_slots.py``), against their plain
    versions on the card, whole flat buffers: widths of 1, 7, 9, 33, 120
    and 240 MBs; all-zero blocks and all-skip rows, 32-bit codewords,
    pieces of 256 and 257 bits, MBs of 2048 and 2049 and of all 32-bit
    slots, rows of pad 0 and 7; totals of exactly FLAT_CAP_WORDS and one
    over; 8 sessions with shared and per-session header slots; worklist
    frames of 1, 8 and 68 rows; nx = 2 bands; 4K; and the 1080p slots of
    ``k3k7_inputs`` (a desktop IDR, a moving P frame, their hq forms, 8
    sessions, a 4K IDR)."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from pack_slots import K3K7_FLAT_ROWS, k3k7_slots

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k3k7"] = {}
    pf, ppf = bitmerge.pack_frame, bitmerge.pack_p_frame
    saved = (pf.launches, pf.hq.launches, ppf.launches, ppf.hq.launches)
    forms = (("K3", 27, False, False), ("K7", 26, True, False),
             ("K7 27 + qp sum", 27, True, True))
    cases = [(w, 4, "rand", 1, False) for w in (1, 7, 9, 33, 120, 240)]
    cases += [(120, 8, k, 1, False) for k in (
        "zero", "wide32", "full", "cap256", "cap257", "mb2049", "pad")]
    cases += [(K3K7_FLAT_ROWS[1], K3K7_FLAT_ROWS[0], k, 1, False)
              for k in ("flat_cap", "flat_cap1")]
    cases += [(40, 6, "rand", 8, False), (40, 6, "pad", 8, True),
              (120, 1, "rand", 1, False), (120, 8, "rand", 1, False),
              (120, 68, "rand", 1, False), (120, 34, "rand", 2, True),
              (240, 136, "rand", 1, False)]
    n, flags = 0, {}
    for name, nb, p, qp in forms:
        for i, (nc, nr, kind, ns, hs) in enumerate(cases):
            x = k3k7_slots(nr, nc, nb, kind, 300 + i + 50 * nb + 7 * p, ns, hs, p)
            x = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
            if ns == 1:
                x = {k: v if k.startswith("hdr") else v[0] for k, v in x.items()}
            got = k3k7_call(x, p, pf, ppf, qp)
            for s in range(ns):
                want = k3k7_call(x, p, bitmerge.pack_frame_plain,
                                 bitmerge.pack_p_frame_plain, qp,
                                 s if ns > 1 else None)
                g = got[s] if ns > 1 else got
                check(torch.equal(g, want), f"{name} {kind} {nr}x{nc} "
                      f"session {s} of {ns} (shared headers {not hs}): "
                      "flat differs from plain")
                flags[f"{name} {kind}"] = bool(g[3])
            n += 1
    check(flags["K3 flat_cap1"] and not flags["K3 flat_cap"]
          and flags["K7 mb2049"] and flags["K7 cap257"]
          and not flags["K7 cap256"] and flags["K3 full"],
          f"the overflow flags: {flags}")
    torch.cuda.synchronize()
    rep["synthetic_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    x = k3k7_inputs(dev)
    plain = {"k3": lambda: bitmerge.pack_frame_plain(*x["i"], *x["hdr"]),
             "k3_hq": lambda: bitmerge.pack_frame_plain(
                 *x["i_hq"], *x["hdr"], qp_sum=x["i_qp_sum"]),
             "k7": lambda: bitmerge.pack_p_frame_plain(*x["p"], *x["hdr_p"]),
             "k7_hq": lambda: bitmerge.pack_p_frame_plain(
                 *x["p_hq"], *x["hdr_p"], qp_sum=x["p_qp_sum"]),
             "k3_4k": lambda: bitmerge.pack_frame_plain(*x["i4k"], *x["hdr4k"])}
    for name, fn in k3k7_forms(x).items():
        got = fn()
        if name.endswith("_s8"):
            want = plain[name[:2]]()
            check(all(torch.equal(got[s], want) for s in range(8)),
                  f"{name}: a session's flat differs from plain")
        else:
            check(torch.equal(got, plain[name]()), f"{name}: flat differs from plain")
    torch.cuda.synchronize()
    rep["real_s"] = time.perf_counter() - t0
    rep["s"] = time.perf_counter() - t_phase
    pf.launches, pf.hq.launches, ppf.launches, ppf.hq.launches = saved
    print(f"(a) k3k7: K3, K7 and K7's 27-block qp-sum form equal to plain "
          f"(whole flat buffers) on {n} synthetic frames (widths 1, 7, 9, 33, "
          "120 and 240 MBs; zero blocks and all-skip rows, 32-bit codewords, "
          "pieces of 256 and 257 bits, MBs of 2048, 2049 and all 32-bit "
          "slots, pad 0 and 7, totals at FLAT_CAP_WORDS and one over, 8 "
          "sessions with shared and per-session headers, 1, 8 and 68 rows, "
          f"nx = 2 bands, 4K; {rep['synthetic_s']:.1f} s) and on the 1080p "
          "desktop IDR, moving P frame, hq forms, 8 sessions and a 4K IDR "
          f"({rep['real_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


def k11_words(buf):
    """A K11 transport's meaningful words on the host: the header and the
    payload (the words past it are unspecified), clipped to the buffer."""
    h = buf.cpu()
    return h[:min(h.numel(), 8 + int(h[3]) + int(h[2]))]


def k16c_strips(packed, totals) -> list:
    """Each strip's (meaningful bytes, bits), as the encoders read them."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    return [(b.tobytes(), n) for row in jd.strip_bytes(packed, totals) for b, n in row]


def k11_over_cap(kind: str, args, cap: int):
    """K11i or K11p (``kind`` "intra" or "p") launched with a per-MB cap of
    ``cap`` words (the launcher's argument; the wrapper passes the static
    cap): its transport."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, cabac_binarize

    nr, nc = args[1].shape[:2]
    slots = cabac_binarize.layout(kind)[0]
    out_words = 8 + nr + nr * nc * cap
    fn = _cuda.library("cabac").binarize_buffer_words
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    buf = torch.empty(int(fn(out_words, nr, nc)), dtype=torch.int32, device=args[1].device)
    _cuda.launch("cabac", f"binarize_{kind}_launch", list(args) + [buf], [nr, nc, slots, cap],
                 args[1].device)
    return buf[:out_words]


def k11p_case(kind: str, nr: int, nc: int, dev, seed: int):
    """K11p's crafted inputs at (nr, nc) MBs: ``skip`` (skip runs: most
    MBs without levels and mv 0), ``dense`` (half the levels nonzero, up to
    +-60), ``mvd`` (an mvd past its bypass budget), ``level`` (a level past
    its suffix budget), ``cap`` (sparse levels, for a launch whose cap an
    MB passes)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shapes = {"mv": (2,), "luma": (16, 16), "cb_dc": (4,), "cb_ac": (4, 15),
              "cr_dc": (4,), "cr_ac": (4, 15)}
    dens, mag = {"skip": (0.003, 3), "dense": (0.5, 60), "mvd": (0.02, 3),
                 "level": (0.02, 3), "cap": (0.3, 60)}[kind]
    d = {}
    for k, shape in shapes.items():
        a = rng.integers(-mag, mag + 1, (nr, nc) + shape)
        d[k] = np.where(rng.random(a.shape) < dens, a, 0).astype(np.int32)
    d["mv"] = rng.integers(-40, 41, (nr, nc, 2)).astype(np.int32)
    d["mv"][rng.random((nr, nc)) < (0.97 if kind == "skip" else 0.4)] = 0
    if kind == "skip":
        keep = rng.random((nr, nc)) < 0.05
        for k in shapes:
            if k != "mv":
                d[k][~keep] = 0
    if kind == "mvd":
        d["mv"][nr // 2, nc // 3] = (0, 600)
    if kind == "level":
        d["luma"][nr - 1, nc - 1, 3, 0] = 500
    return [torch.from_numpy(d[k]).to(dev) for k in shapes]


def k11k16_phase(report):
    """K16c and K11p against their plain versions, byte for byte, on the
    crafted inputs that break their segment designs and on every form of
    their main paths.  K16c (``tests/jpeg_levels.py``): all-zero blocks,
    a nonzero only at position 63, DC differences of size 11, negative
    amplitudes, blocks of exactly 32 bits (``edge_tables``), noise at the
    worst case of bits a block and sparse random levels, at S = 1 x nx = 1
    of 1080p, S = 4 x nx = 4 of 1920x1088 and S = 2 x 40 MCUs at nx = 1, 2,
    4 (segments that start inside strips); then the single encoder's
    sticky and per-frame tables at 1080p, 1919x1079, RFB's encoder,
    the session batch and 4K.  K11p: skip runs, dense levels, mvd and
    level budget overflows (the flag set, the payload still equal) at
    1080p and at 1 x 7 and 34 x 120 MBs, an MB over its cap (a launch at
    a cap of 8 words: the header's flag set, its other words equal), and
    its forms (a moving desktop P frame, a noise frame, a shard's 34
    rows).  Launches made here leave the wrappers' counts as they were."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import (
        JpegEncoder, _tables_from_hists)
    from docker_nvidia_glx_desktop_tpu_torch.ops import cabac_binarize
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from jpeg_levels import KINDS, edge_tables, k16c_levels

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k11k16"] = {}
    saved = (jd.jpeg_pack.launches, jd.jpeg_transform.launches,
             jd.jpeg_analyze.launches, cabac_binarize.binarize_p.launches)

    def k16c_equal(lv, tab, nx, label):
        got = k16c_strips(*jd.jpeg_pack(*lv, tab, nx))
        want = k16c_strips(*jd.jpeg_pack_plain(*lv, tab, nx))
        check(got == want, f"K16c {label}: the strips differ from plain")
        return sum(n for _, n in got)

    n16 = 0
    bits = {}
    full = (H_PAD // 16) * (W // 16)            # 1080p's MCUs
    for kind in KINDS:
        for s, nmcu, nx in ((1, full, 1), (4, full, 4), (2, 40, 1), (2, 40, 2), (2, 40, 4)):
            lv = [torch.from_numpy(a).to(dev) for a in k16c_levels(kind, nmcu, s, seed=s + nx)]
            if kind == "edge":
                tab = jd.table_tensor(edge_tables(), dev)
            else:
                h = jd.split_hists(jd.jpeg_analyze_plain(*lv, nx))
                tab = jd.table_tensor(jd.dense_tables(_tables_from_hists(
                    [x[0].cpu().numpy() for x in h], smooth=True)), dev)
            bits[f"{kind} {s}x{nmcu}/{nx}"] = k16c_equal(lv, tab, nx, f"{kind} S={s} "
                                                        f"nmcu={nmcu} nx={nx}")
            n16 += 1
    check(min(bits.values()) > 0, f"K16c crafted totals {bits}")
    x = k11k16_inputs(dev)
    enc = JpegEncoder(W, H, quality=RFB_QUALITY)
    frame = mjpeg_frames(1, seed=9)[0]
    enc.encode(frame)
    x["j_rfb"] = (jd.jpeg_transform(torch.from_numpy(frame).to(dev)[None], enc.luma_q,
                                    enc.chroma_q, enc.pad_h, enc.pad_w), enc._table_dev, 1)
    for name in ("j", "j_pf", "j_odd", "j_rfb", "j_s4", "j_4k"):
        k16c_equal(*x[name], name)
        n16 += 1
    rep["k16c_cases"] = n16
    rep["k16c_s"] = time.perf_counter() - t_phase

    t1 = time.perf_counter()
    nr, nc = H_PAD // 16, W // 16
    n11 = 0
    flags = {}
    for kind in ("skip", "dense", "mvd", "level"):
        for i, (r, c) in enumerate(((nr, nc), (1, 7), (nr // 2, nc))):
            args = k11p_case(kind, r, c, dev, 40 + i)
            got = cabac_binarize.binarize_p(*args)
            want = cabac_binarize.binarize_p_plain(*args)
            check(torch.equal(k11_words(got), k11_words(want)),
                  f"K11p {kind} {r}x{c}: the transport differs from plain")
            flags[f"{kind} {r}x{c}"] = int(got[1])
            n11 += 1
    check(all(flags[f"{k} {nr}x{nc}"] for k in ("mvd", "level"))
          and not flags[f"skip {nr}x{nc}"] and not flags[f"dense {nr}x{nc}"],
          f"K11p overflow flags {flags}")
    args = k11p_case("cap", nr, nc, dev, 47)
    got, want = k11_over_cap("p", args, 8), cabac_binarize.binarize_p_plain(*args)
    keep = [0] + list(range(2, 8 + nr))
    check(int(got[1]) == 1 and int(want[1]) == 0
          and torch.equal(got[keep].cpu(), want[keep].cpu()),
          "K11p over its cap: the flag is not set or the header differs from plain")
    for name in ("p", "p_noise", "p_band"):
        got = cabac_binarize.binarize_p(*x[name])
        check(torch.equal(k11_words(got), k11_words(cabac_binarize.binarize_p_plain(*x[name]))),
              f"K11p {name}: the transport differs from plain")
        n11 += 1
    torch.cuda.synchronize()
    rep["k11p_cases"] = n11 + 1
    rep["k11p_s"] = time.perf_counter() - t1
    rep["s"] = time.perf_counter() - t_phase
    (jd.jpeg_pack.launches, jd.jpeg_transform.launches, jd.jpeg_analyze.launches,
     cabac_binarize.binarize_p.launches) = saved
    print(f"(a) k11k16: K16c's strips equal to plain on {n16} inputs ({', '.join(KINDS)} "
          "at S = 1 x nx = 1 of 1080p, S = 4 x nx = 4, S = 2 x 40 MCUs at nx = 1, 2, "
          "4; the single encoder's sticky and per-frame tables at 1080p, 1919x1079, "
          f"RFB's encoder, the batch and 4K; {rep['k16c_s']:.1f} s); K11p's header and "
          f"payload equal to plain on {rep['k11p_cases']} inputs (skip runs, dense "
          "levels, mvd and level overflows at 68x120, 1x7 and 34x120 MBs, an MB over "
          "a cap of 8 words, a desktop P frame, a noise frame, a shard's 34 rows; "
          f"{rep['k11p_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


def k10_words(buf):
    """A K10 transport's meaningful words on the host (the version-1
    header has K11's layout: word 2 the payload words, word 3 the rows):
    the header and the payload, clipped to the buffer."""
    check(int(buf[0]) == 1, f"not a K10 transport: version {int(buf[0])}")
    return k11_words(buf)


def k11i_case(kind: str, nr: int, nc: int, dev, seed: int):
    """K11i's crafted inputs at (nr, nc) MBs, in ``I_BIN_KEYS`` order:
    ``flat`` (no levels), ``sparse``, ``dense`` (half the levels nonzero,
    up to +-60), ``extreme`` (levels at the suffix budgets, a luma DC of
    16000), ``level`` (an I4 level past its budget), ``all_i4`` (every MB
    I_NxN), ``checker`` (I_16x16 and I_NxN MBs in a checkerboard, so every
    left neighbour's summary is of the other type); the MBs' types at
    random elsewhere, each type's other levels zero as K1 leaves them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dens, mag = {"flat": (0.0, 1), "sparse": (0.05, 3), "dense": (0.5, 60),
                 "extreme": (0.3, 141), "level": (0.05, 3), "all_i4": (0.3, 20),
                 "checker": (0.3, 20)}[kind]
    shapes = {"luma_dc": (16,), "luma_ac": (16, 15), "cb_dc": (4,), "cb_ac": (4, 15),
              "cr_dc": (4,), "cr_ac": (4, 15), "luma_i4": (16, 16)}
    d = {}
    for k, shape in shapes.items():
        a = rng.integers(-mag, mag + 1, (nr, nc) + shape)
        d[k] = np.where(rng.random(a.shape) < dens, a, 0).astype(np.int32)
    i4 = rng.random((nr, nc)) < 0.5
    if kind == "all_i4":
        i4[:] = True
    if kind == "checker":
        i4 = np.add.outer(np.arange(nr), np.arange(nc)) % 2 == 0
    i4[0, 0] = i4[0, 0] and kind != "extreme"      # an I_16x16 MB for the big DC
    i4[-1, -1] = i4[-1, -1] or kind == "level"       # an I_NxN MB for the big level
    d["luma_dc"][i4] = 0
    d["luma_ac"][i4] = 0
    d["luma_i4"][~i4] = 0
    d["mb_i4"] = i4
    d["pred_mode"] = rng.integers(0, 4, (nr, nc)).astype(np.int32)
    d["i4_modes"] = rng.integers(0, 9, (nr, nc, 16)).astype(np.int32)
    if kind == "extreme":
        d["luma_dc"][0, 0, :3] = (16000, -3000, 700)
    if kind == "level":
        d["luma_i4"][-1, -1, 2, 0] = -400
    return [torch.from_numpy(d[k]).to(dev) for k in I_BIN_KEYS]


def k10k11i_phase(report):
    """K11i and K10 against their plain versions, header and payload word
    for word and the overflow flag, on the crafted inputs that break their
    segment designs and on every form of their main paths.  K11i: flat,
    sparse, dense and extreme levels, a level past its budget (the flag
    set), an all-I_NxN frame and an I_16x16 / I_NxN checkerboard at 68 x
    120, 1 x 7 and 34 x 120 MBs, an MB over its cap (a launch at a cap of 8
    words: the flag set, the header's other words plain's), and
    ``k10k11i_inputs``'s forms (a desktop IDR, a noise IDR at a low qp,
    all I_16x16, all I_NxN, a shard's 34 rows).  K10, both key sets:
    ``tests/level_slots.py``'s slots (all-zero, all-nonzero, the range's
    edge values, values one past it (the flag set), zero and nonzero rows
    in turn, sparse) at 68 x 120, 1 x 7, 34 x 120 and 3 x 13 MBs (widths
    that are no multiple of a segment), sparse levels 4 bytes past a
    16-byte boundary (the 4-byte staging), and the intra keys of a desktop
    and a noise IDR, the P keys of a moving desktop and a noise P frame.
    Launches made here leave the wrappers' counts as they were."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import cabac_binarize, level_pack
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from level_slots import K10_KINDS, k10_slots

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k10k11i"] = {}
    saved = (level_pack.pack_levels.launches, cabac_binarize.binarize_intra.launches)
    nr, nc = H_PAD // 16, W // 16
    shapes = ((nr, nc), (1, 7), (nr // 2, nc), (3, 13))

    n10, flags10 = 0, {}
    for keys in (level_pack.INTRA_KEYS, level_pack.P_KEYS):
        s = sum(n for _, n, _ in keys)
        for kind in K10_KINDS:
            for i, (r, c) in enumerate(shapes):
                sl = torch.from_numpy(k10_slots(kind, r, c, s, seed=50 + i)).to(dev)
                lv, off = {}, 0
                for k, n, shape in keys:
                    lv[k] = sl[..., off:off + n].reshape((r, c) + shape).contiguous()
                    off += n
                got = level_pack.pack_levels(lv, keys)
                want = level_pack.pack_slots_plain(sl)
                label = f"K10 {s} slots {kind} {r}x{c}"
                check(torch.equal(k10_words(got), k10_words(want)),
                      f"{label}: the transport differs from plain")
                flags10[label] = int(got[1])
                check(int(got[1]) == int(kind == "over"), f"{label}: overflow flag {int(got[1])}")
                n10 += 1
    # levels 4 bytes past a 16-byte boundary (the staging's 4-byte path)
    for keys in (level_pack.INTRA_KEYS, level_pack.P_KEYS):
        s = sum(n for _, n, _ in keys)
        sl = torch.from_numpy(k10_slots("sparse", nr // 2, nc, s, seed=58)).to(dev)
        lv, off = {}, 0
        for k, n, shape in keys:
            t = torch.empty(sl[..., :n].numel() + 1, dtype=torch.int32, device=dev)[1:]
            lv[k] = t.view((nr // 2, nc) + shape).copy_(sl[..., off:off + n].reshape(
                (nr // 2, nc) + shape))
            off += n
        check(torch.equal(k10_words(level_pack.pack_levels(lv, keys)),
                          k10_words(level_pack.pack_slots_plain(sl))),
              f"K10 {s} slots off a 16-byte boundary: the transport differs from plain")
        n10 += 1
    x = k10k11i_inputs(dev)
    for name, fn in k10k11i_forms(x).items():
        if name.startswith("k10"):
            keys = level_pack.INTRA_KEYS if name.startswith("k10i") else level_pack.P_KEYS
            lv = x["l_" + name[3:]]
            want = level_pack.pack_slots_plain(level_pack.mb_slots(lv, keys))
            got = fn()
            check(torch.equal(k10_words(got), k10_words(want)) and int(got[1]) == 0,
                  f"K10 {name}: the transport differs from plain")
            n10 += 1
    rep["k10_cases"] = n10
    rep["k10_s"] = time.perf_counter() - t_phase

    t1 = time.perf_counter()
    n11, flags = 0, {}
    for kind in ("flat", "sparse", "dense", "extreme", "level", "all_i4", "checker"):
        for i, (r, c) in enumerate(shapes[:3]):
            args = k11i_case(kind, r, c, dev, 60 + i)
            got = cabac_binarize.binarize_intra(*args)
            want = cabac_binarize.binarize_intra_plain(*args)
            check(torch.equal(k11_words(got), k11_words(want)),
                  f"K11i {kind} {r}x{c}: the transport differs from plain")
            flags[f"{kind} {r}x{c}"] = int(got[1])
            n11 += 1
    check(all(v == int(k.startswith("level")) for k, v in flags.items()),
          f"K11i overflow flags {flags}")
    args = k11i_case("dense", nr, nc, dev, 67)
    got, want = k11_over_cap("intra", args, 8), cabac_binarize.binarize_intra_plain(*args)
    keep = [0] + list(range(2, 8 + nr))
    check(int(got[1]) == 1 and int(want[1]) == 0
          and torch.equal(got[keep].cpu(), want[keep].cpu()),
          "K11i over its cap: the flag is not set or the header differs from plain")
    n11 += 1
    for name, fn in k10k11i_forms(x).items():
        if name.startswith("k11"):
            got = fn()
            want = cabac_binarize.binarize_intra_plain(*x[name[3:]])
            check(torch.equal(k11_words(got), k11_words(want)) and int(got[1]) == 0,
                  f"K11i {name}: the transport differs from plain")
            n11 += 1
    torch.cuda.synchronize()
    rep["k11i_cases"] = n11
    rep["k11i_s"] = time.perf_counter() - t1
    rep["i4_share"] = x["i4_share"]
    rep["s"] = time.perf_counter() - t_phase
    level_pack.pack_levels.launches, cabac_binarize.binarize_intra.launches = saved
    print(f"(a) k10k11i: K10's header and payload equal to plain on {n10} inputs (both key "
          f"sets: {', '.join(K10_KINDS)} at 68x120, 1x7, 34x120 and 3x13 MBs, the flag set "
          "on values one past the range only; levels off a 16-byte boundary; a desktop and "
          "a noise IDR's intra keys, a "
          f"moving desktop and a noise P frame's P keys; {rep['k10_s']:.1f} s); K11i's on "
          f"{n11} inputs (flat, sparse, dense, extreme, a level past its budget, all "
          "I_NxN and a checkerboard at 68x120, 1x7 and 34x120 MBs, an MB over a cap of 8 "
          "words, a desktop IDR, a noise IDR at qp "
          f"{K11I_NOISE_QP}, all I_16x16, all I_NxN, a shard's 34 rows; "
          f"{rep['k11i_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


I16_WIDTHS = (1, 7, 9, 120)       # MBs a row of the passes' crafted frames
HALO_4K = (2176, 3840)            # 3840x2160 padded to MB rows of 16 * nx


def i16halo_phase(report):
    """15e and the I16-in-P passes against their plain versions on the
    inputs that break their designs.  15e: nx = 1, 2 and 4, halo on and
    off, at 1080p (1088 lines) and 4K (2176 lines), whose luma planes'
    sizes are no multiple of 16 bytes at nx = 2 and 4 (the tail words),
    and source planes 1 and 4 bytes off a 16-byte boundary (handled: the
    kernel's loads are aligned words).  The passes: the P core's outputs
    at tiers 1 and 2 (a random qp plane at tier 2) with inter scores that
    make every MB want, none, every other, runs across the 8-MB segments
    and random ones, at 1, 7, 9 and 120 MBs a row, in the frame form and
    over a worklist with duplicate rows, with and without ``qp_dev``,
    against ``i16_passes_plain`` (every output, the I16 keys first filled
    with garbage; the rows ``tests/i16_wants.py``'s, as inter scores of
    +inf where an MB wants and -inf where not); then the whole P core with I16-in-P against the plain
    one on a 1080p desktop P frame and a noise P frame at both tiers, a
    worklist with duplicate rows, ``qp_dev`` and K5p at nx = 2.  The
    streams through the passes and 15e (the tune phase's full tier and its
    ring, the masked hq stream, the spatial streams) are held byte-equal
    to the plain path by their own phases.  Launches made here leave the
    wrappers' counts as they were."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, devloop, h264_inter, quant
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from i16_wants import WANT_KINDS, crafted_want

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["i16halo"] = {}
    named = devloop.wrappers()
    saved = {k: fn.launches for k, fn in named.items()}
    rng = np.random.default_rng(18)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- 15e -----------------------------------------------------------------------
    n15, tails = 0, set()
    for h, w in ((H_PAD, W), HALO_4K):
        ref = [up(rng.integers(0, 256, s, dtype=np.uint8))
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        cpu = [p.cpu() for p in ref]
        for nx in (1, 2, 4):
            for halo in (True, False):
                got = batch.spatial_halo_pad(*ref, nx, halo)
                want = batch.spatial_halo_pad_plain(*cpu, nx, halo)
                check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                      f"15e {w}x{h} nx={nx} halo={halo}: differs from plain")
                tails |= {p.numel() % 16 for p in got}
                n15 += 1
    check(len(tails - {0}) > 0, "15e: no output plane with a tail word")
    for off in (1, 4):                  # source views off a 16-byte boundary
        ref = []
        for s in ((H_PAD, W), (H_PAD // 2, W // 2), (H_PAD // 2, W // 2)):
            buf = torch.empty(s[0] * s[1] + off, dtype=torch.uint8, device=dev)
            ref.append(buf[off:].view(s).copy_(up(rng.integers(0, 256, s, dtype=np.uint8))))
        check(ref[0].data_ptr() % 16 == off, "15e: the view is not off a 16-byte boundary")
        for halo in (True, False):
            got = batch.spatial_halo_pad(*ref, 2, halo)
            want = batch.spatial_halo_pad_plain(*(p.cpu() for p in ref), 2, halo)
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"15e: sources {off} bytes off a 16-byte boundary differ from plain")
            n15 += 1
    rep["halo_cases"], rep["halo_tails"] = n15, sorted(tails)
    rep["halo_s"] = time.perf_counter() - t_phase

    # -- the passes on crafted scores ----------------------------------------------
    t1 = time.perf_counter()
    qp, n16, kept = 26, 0, {}
    for nc in I16_WIDTHS:
        nr = H_PAD // 16 if nc == W // 16 else 8
        hh, ww = nr * 16, nc * 16
        cur = [up(rng.integers(0, 256, s, dtype=np.uint8))
               for s in ((hh, ww), (hh // 2, ww // 2), (hh // 2, ww // 2))]
        ref = [up(rng.integers(0, 256, tuple(p.shape), dtype=np.uint8)) for p in cur]
        cur[0][:, :ww // 2] = 100 + cur[0][:, :ww // 2] % 5      # flat: intra wins
        for tier, tune in ((1, "hq_noaq"), (2, "hq")):
            lam = aq.device_tables(tune, dev, 2)[0]
            for rows in (None, torch.tensor([nr - 1, 0, 0, 3 % nr, nr - 1],
                                            dtype=torch.int32, device=dev)):
                nb = nr if rows is None else rows.numel()
                qmap = (up(rng.integers(0, 52, (nb, nc)).astype(np.int32))
                        if tier == 2 else None)
                if rows is None:
                    res = h264_inter.encode_p_frame(*cur, *ref, qp, tune=tune)
                else:
                    res = h264_inter.encode_p_frame_rows(*cur, *ref, rows, qp, tune=tune)
                res.pop("qp_map", None)
                for qd in (None, 41):
                    qpd = None if qd is None else torch.tensor([qd], dtype=torch.int32,
                                                               device=dev)
                    for k, kind in enumerate(WANT_KINDS):
                        score = up(np.where(crafted_want(kind, nb, nc, seed=nc + k),
                                            np.inf, -np.inf).astype(np.float32))
                        out = {k2: v.clone() for k2, v in res.items()}
                        out["mb_intra"] = torch.ones((nb, nc), dtype=torch.bool, device=dev)
                        out["i16_dc"] = torch.full((nb, nc, 16), 12345, dtype=torch.int32,
                                                   device=dev)
                        out["i16_ac"] = torch.full((nb, nc, 16, 15), -777,
                                                   dtype=torch.int32, device=dev)
                        h264_inter._i16_passes(*cur, out, qpd, qmap, lam, score, nb, nc,
                                               [qp, quant.chroma_qp(qp)], tier, dev,
                                               rows=rows)
                        want = h264_inter.i16_passes_plain(
                            *cur, res, score, tune, qp if qd is None else qd, qmap, rows)
                        for key, v in want.items():
                            check(torch.equal(out[key], v),
                                  f"I16-in-P {kind} {nr}x{nc} tier {tier} rows "
                                  f"{rows is not None} qp_dev {qd}: {key} differs from plain")
                        kept[f"{kind} {nc}"] = int(want["mb_intra"].sum())
                        n16 += 1
    rep["passes_crafted"], rep["passes_crafted_s"] = n16, time.perf_counter() - t1

    # -- the whole P core with I16-in-P on 1080p frames -----------------------------
    t2 = time.perf_counter()
    x = i16halo_inputs(dev, qp)
    ref, n_core, fired = x["ref"], 0, {}

    def held(label, got, want):
        for key, v in want.items():
            check(torch.equal(got[key], v), f"I16-in-P {label}: {key} differs from plain")
        fired[label] = int(got["mb_intra"].sum())

    for label in ("desk", "noise"):
        for tune in ("hq_noaq", "hq"):
            o = h264_inter.encode_p_frame(*x[label], *ref, qp, tune=tune, p_intra=True)
            held(f"{label} {tune}", o, h264_inter.encode_p_frame_plain(
                *x[label], *ref, qp, tune, o.get("qp_map"), True))
            n_core += 1
    nr = H_PAD // 16
    rows = torch.tensor([5, 0, 0, 5, nr - 1, nr // 2, 5], dtype=torch.int32, device=dev)
    for tune in ("hq_noaq", "hq"):
        ny = x["next"] if tune == "hq" else None
        o = h264_inter.encode_p_frame_rows(*x["desk"], *ref, rows, qp, tune=tune,
                                           next_y=ny, p_intra=True)
        held(f"rows {tune}", o, h264_inter.encode_p_frame_rows_plain(
            *x["desk"], *ref, rows, qp, tune, o.get("qp_map"), True))
        n_core += 1
    qpd = torch.tensor([33], dtype=torch.int32, device=dev)
    for tune in ("hq_noaq", "hq"):
        o = h264_inter.encode_p_frame(*x["desk"], *ref, qp, tune=tune, p_intra=True,
                                      qp_dev=qpd)
        held(f"qp_dev {tune}", o, h264_inter.encode_p_frame_plain(
            *x["desk"], *ref, 33, tune, o.get("qp_map"), True))
        n_core += 1
    pads = batch.spatial_halo_pad(*ref, 2)
    sv = lambda t: t.view((2, t.shape[0] // 2) + tuple(t.shape[1:]))
    for tune in ("hq_noaq", "hq"):
        o = h264_inter.encode_p_frame_padded_ref(*(sv(p) for p in x["desk"]), *pads, qp,
                                                 tune=tune, p_intra=True)
        for s in range(2):
            held(f"K5p {tune} shard {s}", {k: v[s] for k, v in o.items()},
                 h264_inter.encode_p_frame_padded_ref_plain(
                     *(sv(p)[s] for p in x["desk"]), *(p[s] for p in pads), qp, tune,
                     o["qp_map"][s] if tune == "hq" else None, True))
        n_core += 1
    torch.cuda.synchronize()
    check(sum(fired.values()) > 0, f"I16-in-P never fired on the 1080p frames {fired}")
    for k, fn in named.items():
        fn.launches = saved[k]
    rep.update(passes_core=n_core, fired=fired, kept=kept,
               core_s=time.perf_counter() - t2, s=time.perf_counter() - t_phase)
    print(f"(a) i16halo: 15e equal to plain on {n15} inputs (nx 1, 2, 4, halo on and off, "
          f"1088x1920 and 2176x3840, plane sizes mod 16 {sorted(tails)}; sources 1 and 4 "
          f"bytes off a 16-byte boundary; {rep['halo_s']:.1f} s); the I16-in-P passes equal "
          f"to i16_passes_plain on {n16} crafted inputs ({', '.join(WANT_KINDS)} at "
          f"{', '.join(map(str, I16_WIDTHS))} MBs a row, tiers 1 and 2, frame and a worklist "
          f"with duplicate rows, with and without qp_dev; "
          f"{rep['passes_crafted_s']:.1f} s); the P core with I16-in-P equal to plain on "
          f"{n_core} 1080p forms (I16 MBs {fired}); phase {rep['s']:.1f} s")
    return []


K16A_TIE_SIZES = ((48, 64), (50, 70), (160, 192))   # tests/test_torch_jpeg.py's
SSE_SIZES = (0, 1, 15, 16, 17, 4095, 4097)          # K14d's short planes (bytes)


def jpeg_test_frames(h: int, w: int, seed: int):
    """``tests/test_torch_jpeg.py``'s frames: noise, a smooth gradient with
    glyph strokes, and a flat frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w, 1)], -1).astype(np.uint8)
    grad[h // 4:h // 2:3, 5:w - 5:2] = rng.integers(0, 60)
    return [noise, grad, np.full((h, w, 3), 200, np.uint8)]


def tie_tables(rgb, block: int):
    """Quant tables that put block ``block`` of the frame's Y and Cb
    planes on or next to a rounding tie: q = 2|c| (c / q = +-0.5 exactly,
    round half to even) and q = 2|c| / 3 rounded to float32 (c / q within
    an ulp of +-1.5), c the plain version's float32 coefficients; q = 1
    where 2|c| < 2^-14, so every level of the frame stays within 2^24."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import color, dct

    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    p = torch.from_numpy(np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), "edge"))
    y, cb, _ = color.rgb_to_yuv420_full(p)
    out = []
    for div in (1.0, 3.0):
        tabs = []
        for plane in (y, cb):
            c = dct.dct8x8(dct.to_blocks(plane - 128.0, 8, 8)).reshape(-1, 64)[block]
            q = (2.0 * c.abs().double() / div).to(torch.float32).numpy()
            tabs.append(np.where(q < 2.0 ** -14, np.float32(1), q).astype(np.float32)
                        .reshape(8, 8))
        out.append(tabs)
    return out


def k16a14d_phase(report):
    """K16a and K14d against their plain versions on the inputs that
    break their designs.  K16a, every level of y, cb and cr: S = 1 and 4 at
    1080p, 4K and 1919x1079 (the right and bottom edge clamps), the odd
    frame padded a further MCU row and two MCU columns (a ragged tile of
    MCUs), 16x16 and 17x33 frames, saturated colours and checkerboards,
    all-zero frames, each with quality 85's tables and with tables of
    ones; ``tests/test_torch_jpeg.py``'s frames (noise, a gradient with
    strokes, a flat frame) at its sizes with tables that put a block's
    every coefficient on a tie (``tie_tables``); two 1080p frames and a
    333x177 RFB rect through ``JpegEncoder`` byte-equal to the same
    encoders with the plain transform (the mjpeg phase holds the served
    streams, the Tight rects and the session batch likewise).  K14d, the
    exact int64 SSE: 0, 1, 15, 16, 17, 4095 and 4097 bytes, 1088x1920, a
    4K plane of zeros against 255 (5.4e11, past int32), views 3 and 7
    bytes off a 16-byte boundary, two calls in a row, one graph replayed
    32 times on new planes and a graph of 32 launches (the ticket resets).
    Launches made here leave the wrappers' counts as they were."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models.mjpeg import JpegEncoder
    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, quant
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.ops.devloop import graph_capture
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k16a14d"] = {}
    saved = (jd.jpeg_transform.launches, aq.sse_planes.launches)
    rng = np.random.default_rng(19)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lq, cq = quant.jpeg_quality_tables(85)
    ones = np.ones((8, 8), np.float32)
    n16 = 0

    def held(label, rgbs, lq_, cq_, ph, pw):
        nonlocal n16
        got = jd.jpeg_transform(rgbs, lq_, cq_, ph, pw)
        want = jd.jpeg_transform_plain(rgbs, lq_, cq_, ph, pw)
        for a, b, k in zip(got, want, ("y", "cb", "cr")):
            check(torch.equal(a, b), f"K16a {label}: {k} differs from plain in "
                  f"{int((a != b).sum())} levels")
        n16 += 1

    # -- K16a ----------------------------------------------------------------------
    x = k16a14d_inputs(dev)
    for name in K16A_FORMS:
        rgbs, _, _, ph, pw = x[name]
        for tabs, tn in (((lq, cq), "q85"), ((ones, ones), "ones")):
            held(f"{name} {tn}", rgbs, *tabs, ph, pw)
    odd = x["t_odd"][0]
    held("1919x1079 padded to 1104x1952", odd, lq, cq, 1104, 1952)
    for h, w in ((16, 16), (17, 33)):
        for s in (1, 4):
            f = up(rng.integers(0, 256, (s, h, w, 3), dtype=np.uint8))
            ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
            for tabs in ((lq, cq), (ones, ones)):
                held(f"{w}x{h} S={s}", f, *tabs, ph, pw)
    sat = np.zeros((4, 64, 96, 3), np.uint8)
    cols = np.array([(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 255),
                     (0, 0, 0), (255, 255, 0), (0, 255, 255), (255, 0, 255)], np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    sat[0] = cols[(yy // 16 * 6 + xx // 16) % 8]
    sat[1] = ((yy + xx) % 2 * 255)[..., None]                          # checkerboard
    sat[2] = rng.integers(0, 2, (64, 96, 3)).astype(np.uint8) * 255    # 0/255 noise
    blk = (yy // 8 * 12 + xx // 8) % 8                                 # 8x8 blocks
    sat[3] = np.where(((yy // 8 + xx // 8) % 2)[..., None] == 1, cols[blk], 255 - cols[blk])
    for tabs in ((lq, cq), (ones, ones)):
        held("saturated", up(sat), *tabs, 64, 96)
        held("all zero", torch.zeros((2, 48, 80, 3), dtype=torch.uint8, device=dev),
             *tabs, 48, 80)
    n_ties = 0
    for h, w in K16A_TIE_SIZES:
        for k, rgb in enumerate(jpeg_test_frames(h, w, 7)):
            for div, (tl, tc) in zip((1, 3), tie_tables(rgb, block=k)):
                held(f"ties {w}x{h} frame {k} q=2|c|/{div}", up(rgb)[None], tl, tc,
                     -(-h // 16) * 16, -(-w // 16) * 16)
                n_ties += 1
    f2 = mjpeg_frames(2)
    rect = np.ascontiguousarray(f2[1][301:478, 517:850])
    streams, kernel_transform = {}, jd.jpeg_transform
    for route in ("kernel", "plain"):
        if route == "plain":
            jd.jpeg_transform = jd.jpeg_transform_plain
        try:
            enc, enc_r = JpegEncoder(W, H), JpegEncoder(333, 177)
            streams[route] = [enc.encode(f).data for f in f2] + [enc_r.encode(rect).data]
        finally:
            jd.jpeg_transform = kernel_transform
    check(streams["kernel"] == streams["plain"],
          "K16a: the JPEGs differ from the plain transform's")
    rep["k16a_cases"], rep["k16a_ties"] = n16, n_ties
    rep["k16a_s"] = time.perf_counter() - t_phase

    # -- K14d ----------------------------------------------------------------------
    t1 = time.perf_counter()
    n14 = 0

    def sse_held(label, a, b, want=None):
        nonlocal n14
        got = int(aq.sse_planes(a, b))
        plain = int(aq.sse_planes_plain(a.cpu(), b.cpu()))
        check(got == plain and (want is None or got == want),
              f"K14d {label}: {got}, plain {plain}" + (f", want {want}" if want else ""))
        n14 += 1
        return got

    for n in SSE_SIZES:
        sse_held(f"{n} bytes", up(rng.integers(0, 256, n, dtype=np.uint8)),
                 up(rng.integers(0, 256, n, dtype=np.uint8)))
    a, b = x["sse1080"]
    first = sse_held("1088x1920", a, b)
    check(sse_held("1088x1920 again", a, b) == first, "K14d: two calls differ")
    z4 = torch.zeros((2160, 3840), dtype=torch.uint8, device=dev)
    full = sse_held("4K zeros against 255", z4, z4 + 255, want=2160 * 3840 * 255 ** 2)
    check(full > 2 ** 31, "K14d: the full-scale 4K SSE does not pass int32")
    for oa, ob in ((3, 3), (3, 7), (0, 5)):
        n = H_PAD * W
        ba = torch.empty(n + 16, dtype=torch.uint8, device=dev)
        bb = torch.empty(n + 16, dtype=torch.uint8, device=dev)
        va, vb = ba[oa:oa + n].view(H_PAD, W), bb[ob:ob + n].view(H_PAD, W)
        va.copy_(a)
        vb.copy_(b)
        check((va.data_ptr() % 16, vb.data_ptr() % 16) == (oa, ob),
              "K14d: the views are not where they should be")
        check(sse_held(f"views {oa} and {ob} bytes off 16", va, vb) == first,
              "K14d: a misaligned view differs")
    ga, gb = a.clone(), b.clone()
    g = torch.cuda.CUDAGraph()
    aq.sse_planes(ga, gb)
    torch.cuda.synchronize()
    with graph_capture(g):
        gout = aq.sse_planes(ga, gb)
    for i in range(32):
        ga.copy_(up(rng.integers(0, 256, (H_PAD, W), dtype=np.uint8)) if i % 2 else a)
        gb.copy_(b if i % 3 else up(rng.integers(0, 256, (H_PAD, W), dtype=np.uint8)))
        g.replay()
        check(int(gout) == int(aq.sse_planes_plain(ga.cpu(), gb.cpu())),
              f"K14d: replay {i} of one graph differs from plain")
    g32 = torch.cuda.CUDAGraph()
    with graph_capture(g32):
        outs = [aq.sse_planes(a, b) for _ in range(32)]
    for _ in range(2):
        g32.replay()
        check(all(int(o) == first for o in outs),
              "K14d: a launch of a graph of 32 differs from plain")
    torch.cuda.synchronize()
    jd.jpeg_transform.launches, aq.sse_planes.launches = saved
    rep.update(k14d_cases=n14, k14d_s=time.perf_counter() - t1,
               s=time.perf_counter() - t_phase)
    print(f"(a) k16a14d: K16a equal to plain, every level, on {n16} inputs (1080p, S = 4, "
          f"4K, 1919x1079, a ragged tile, 16x16 and 17x33 at S = 1 and 4, saturated, "
          f"all zero; quality 85 and tables of ones; {n_ties} at rounding ties), two "
          f"1080p JPEGs and a 333x177 rect byte-equal to the plain transform's "
          f"({rep['k16a_s']:.1f} s); K14d equal to plain on {n14} inputs ({SSE_SIZES} "
          f"bytes, 1088x1920 twice, the 4K full-scale pair {full}, views off a 16-byte "
          f"boundary), one graph replayed 32 times and a graph of 32 launches "
          f"({rep['k14d_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


K16B_RUNS = (0, 15, 16, 17, 31, 32, 47, 48, 62)     # zero runs before a nonzero


def k16b_crafted(nmcu: int, seed: int):
    """(y, cb, cr) int32 numpy levels, one session, that break K16b's
    design, block by block in turn: a nonzero after each run of
    ``K16B_RUNS`` (then a second nonzero), the last nonzero at 62 and at
    63, every size 1-15 at random positions, all-zero blocks, all 63 ACs
    at +-1023; DCs that step past size 16 (+-70000, +-2^20, +-2^30, the
    int32 extremes, whose differences wrap) beside small ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blocks = np.zeros((nmcu * 6, 64), np.int64)
    big = np.array([70000, -70000, 1 << 20, -(1 << 20), 1 << 30, -(1 << 30),
                    2 ** 31 - 1, -2 ** 31, 0, 5, -3, 1023])
    for i in range(nmcu * 6):
        blk, kind = blocks[i], i % 7
        blk[0] = big[rng.integers(0, len(big))] if rng.random() < 0.5 else rng.integers(-50, 50)
        if kind == 0:                                  # a run, then another nonzero
            run = K16B_RUNS[(i // 7) % len(K16B_RUNS)]
            k = 1 + run
            blk[k] = rng.choice([-1, 1]) * rng.integers(1, 1 << 15)
            if k + 1 + run < 64:
                blk[k + 1 + run] = rng.choice([-7, 9])
        elif kind == 1:
            blk[62 + (i // 7) % 2] = rng.choice([-1, 2])  # the last nonzero at 62 or 63
            blk[rng.integers(1, 40)] = 3
        elif kind == 2:                                # sizes 1-15
            for size in range(1, 16):
                blk[rng.integers(1, 64)] = rng.choice([-1, 1]) * ((1 << size) - rng.integers(0, 2))
        elif kind == 3:
            blk[1:] = 0                                # all zero but the DC
        elif kind == 4:
            blk[1:] = np.where(np.arange(63) % 2, 1023, -1024)
        elif kind == 5:                                # int32 extremes in the ACs
            blk[rng.integers(1, 64, 5)] = rng.choice([2 ** 31 - 1, -2 ** 31], 5)
        else:
            m = rng.random(63) < 0.2
            blk[1:] = np.where(m, rng.integers(-60, 61, 63), 0)
    b = blocks.astype(np.int32).reshape(1, nmcu, 6, 64)
    return (np.ascontiguousarray(b[:, :, :4]), np.ascontiguousarray(b[:, :, 4]),
            np.ascontiguousarray(b[:, :, 5]))


def sad_planes(dev):
    """A 32x64 luma pair (2 x 4 MBs) whose MBs' SADs against the next
    frame are 256, 257, 1535 and 1536 (the lookahead's thresholds, either
    side of each), then 0, 255, 1537 and 65280."""
    import torch

    y = torch.full((32, 64), 100, dtype=torch.int32)
    nxt = y.clone()
    for k, sad in enumerate((256, 257, 1535, 1536, 0, 255, 1537, 65280)):
        r, c = 16 * (k // 4), 16 * (k % 4)
        d = torch.zeros(256, dtype=torch.int32)
        if sad == 65280:
            y[r:r + 16, c:c + 16], d[:] = 0, 255
        else:
            q, rem = divmod(sad, 256)
            d[:] = q
            d[:rem] += 1
        nxt[r:r + 16, c:c + 16] = y[r:r + 16, c:c + 16] + d.view(16, 16)
    return y.to(torch.uint8).to(dev), nxt.to(torch.uint8).to(dev)


def k16b14a_phase(report):
    """K16b and K14a/K14r against their plain versions on the inputs that
    break their designs.  K16b, every bin: the forms' levels (1080p, the
    batch's S = 4 at 1920x1088, 4K) at nx = 1, 3 and 4, a 1919x1079 frame
    padded, all-zero and all-saturated levels, ``k16b_crafted``'s blocks
    (runs of 0-62 zeros, the last nonzero at 62 and 63, sizes 1-15, int32
    extremes, DC sizes past 16: counted nowhere) at 1, 3, 17 and 40 MCUs,
    S = 65 (two launches), a call twice, a graph of one replayed on new
    levels and a graph of 32 launches.  K14a, every MB: 1080p without and
    with the lookahead and with ``qp_dev``, 4K, 1919x1079 padded, all-255
    MBs and MBs of 200 +- 55 (256 s2 past int32), the SAD thresholds, odd
    MB columns (1, 3 and 5), planes 3 and 7 bytes off 16, worklists of 1,
    8 and 64 rows with duplicates (K14r), a graph of 32 launches replayed
    with ``qp_dev`` changed.  Launches made here leave the wrappers' counts
    as they were."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, quant
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.ops.devloop import graph_capture
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k16b14a"] = {}
    saved = (jd.jpeg_analyze.launches, aq.qp_plane.launches, aq.qp_plane.rows.launches)
    rng = np.random.default_rng(20)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n16 = n14 = 0

    def hheld(label, lv, nx=1, hist=None):
        nonlocal n16
        got = jd.jpeg_analyze(*lv, nx) if hist is None else hist
        want = jd.jpeg_analyze_plain(*lv, nx)
        check(torch.equal(got, want), f"K16b {label}: {int((got != want).sum())} bins "
              "differ from plain")
        n16 += 1
        return got

    # -- K16b ----------------------------------------------------------------------
    x = k16b14a_inputs(dev)
    for name in K16B_FORMS:
        *lv, nx0 = x[name]
        for nx in sorted({1, 3, 4, nx0}):
            hheld(f"{name} nx={nx}", lv, nx)
    lq, cq = quant.jpeg_quality_tables(85)
    odd = up(np.ascontiguousarray(mjpeg_frames(2)[1][:ODD_H, :ODD_W]))[None]
    hheld("1919x1079 padded", jd.jpeg_transform(odd, lq, cq, H_PAD, W))
    z = torch.zeros((2, 8160, 4, 64), dtype=torch.int32, device=dev)
    zc = torch.zeros((2, 8160, 64), dtype=torch.int32, device=dev)
    hheld("all zero", (z, zc, zc.clone()), 4)
    sat = lambda t, v: torch.where(torch.arange(64, device=dev) % 2 == 0, v, -v - 1).to(
        torch.int32).expand_as(t).contiguous()
    for v in (1023, 2 ** 31 - 1):
        hheld(f"saturated +-{v}", (sat(z, v), sat(zc, v), sat(zc, v)), 3)
    for nmcu, nx in ((1, 1), (3, 3), (17, 1), (40, 4), (40, 1)):
        for seed in range(3):
            lv = [up(a) for a in k16b_crafted(nmcu, seed + 7 * nmcu)]
            hheld(f"crafted {nmcu} MCUs nx={nx} seed {seed}", lv, nx)
    one = [up(a) for a in (np.array([[[[70000] + [0] * 63, [-70000] + [0] * 63,
                                        [0] * 64, [0] * 64]]], np.int32),
                            np.zeros((1, 1, 64), np.int32), np.zeros((1, 1, 64), np.int32))]
    rep_dc = hheld("DC sizes past 16 on one MCU", one)
    check(int(rep_dc[0, 0]) == 1 and int(rep_dc[0, 1:17].sum()) == 0,
          f"K16b: dc_y {rep_dc[0, :17].tolist()}, not the reference's [1, 0, ...]")
    big = [up(np.concatenate([a] * 65)) for a in k16b_crafted(3, 1)]
    hheld("S = 65 (two launches)", big, 3)
    lv = x["h1080"][:3]
    first = hheld("1080p again", lv)
    check(torch.equal(hheld("1080p a third time", lv), first), "K16b: two calls differ")
    gl = [t.clone() for t in lv]
    g = torch.cuda.CUDAGraph()
    jd.jpeg_analyze(*gl)
    torch.cuda.synchronize()
    with graph_capture(g):
        gout = jd.jpeg_analyze(*gl)
    other = x["h_s4"][:3]
    for i in range(4):
        for dst, a, b in zip(gl, lv, other):
            dst.copy_(a if i % 2 == 0 else b[i])
        g.replay()
        hheld(f"replay {i} of one graph", gl, 1, gout.clone())
    g32 = torch.cuda.CUDAGraph()
    with graph_capture(g32):
        outs = [jd.jpeg_analyze(*lv) for _ in range(32)]
    for _ in range(2):
        g32.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(o, first) for o in outs),
              "K16b: a launch of a graph of 32 differs from plain")
    rep["k16b_cases"], rep["k16b_s"] = n16, time.perf_counter() - t_phase

    # -- K14a / K14r ---------------------------------------------------------------
    t1 = time.perf_counter()
    qp = PAIRS_QP

    def qheld(label, y, nxt=None, rows=None, qp_dev=None, out=None):
        nonlocal n14
        got = aq.qp_plane(y, qp, nxt, qp_dev, out, rows)
        q = qp if qp_dev is None else int(qp_dev)
        want = aq.qp_plane_plain(y, q, nxt, rows)
        check(torch.equal(got, want), f"K14a {label}: {int((got != want).sum())} MBs "
              "differ from plain")
        n14 += 1
        return got

    qd = torch.tensor([38], dtype=torch.int32, device=dev)
    for name in K14A_FORMS:
        y, nxt, rows = x[name]
        qheld(name, y, nxt, rows)
        qheld(f"{name} qp_dev", y, nxt, rows, qd)
    ri = torch.arange(H_PAD, device=dev).clamp(max=ODD_H - 1)
    ci = torch.arange(W, device=dev).clamp(max=ODD_W - 1)
    edge = lambda t: t[ri][:, ci].contiguous()       # 1919x1079, edge-padded
    qheld("1919x1079 padded", edge(x["q1080"][0]), edge(x["q1080_next"][1]))
    hi = torch.full((64, 96), 255, dtype=torch.uint8, device=dev)
    pm = up((200 + 55 * rng.choice([-1, 1], (64, 96))).astype(np.uint8))
    mix = torch.cat([hi, pm], 0).contiguous()
    a = qheld("all-255 and 200 +- 55", mix, torch.flip(mix, [1]).contiguous())
    check(int(a.min()) >= 1, "K14a: qp below 1")
    sy, sn = sad_planes(dev)
    qheld("SAD thresholds", sy, sn)
    for nc in (1, 3, 5):
        r = up(rng.integers(0, 256, (48, 16 * nc), dtype=np.uint8))
        qheld(f"{nc} MB columns", r, up(rng.integers(0, 256, (48, 16 * nc), dtype=np.uint8)))
        qheld(f"{nc} MB columns, 2 of 3 rows", r, None,
              torch.tensor([2, 0], dtype=torch.int32, device=dev))
    y0, n0 = x["q1080_next"][:2]
    want = aq.qp_plane_plain(y0, qp, n0)
    for oa, ob in ((3, 3), (3, 7), (0, 5)):
        ba = torch.empty(y0.numel() + 16, dtype=torch.uint8, device=dev)
        bb = torch.empty(n0.numel() + 16, dtype=torch.uint8, device=dev)
        va, vb = ba[oa:oa + y0.numel()].view(y0.shape), bb[ob:ob + n0.numel()].view(n0.shape)
        va.copy_(y0)
        vb.copy_(n0)
        check((va.data_ptr() % 16, vb.data_ptr() % 16) == (oa, ob),
              "K14a: the views are not where they should be")
        check(torch.equal(qheld(f"views {oa} and {ob} bytes off 16", va, vb), want),
              "K14a: a view off 16 bytes differs")
    nr = y0.shape[0] // 16
    for nb in (1, 8, 64):
        rows = up(rng.integers(0, nr, nb).astype(np.int32))
        if nb > 1:
            rows[1] = rows[0]                          # a duplicate
        qheld(f"{nb} rows", y0, n0, rows)
        qheld(f"{nb} rows, no lookahead, qp_dev", y0, None, rows, qd)
    gq = torch.tensor([qp], dtype=torch.int32, device=dev)
    gouts = [torch.empty((nr, y0.shape[1] // 16), dtype=torch.int32, device=dev)
             for _ in range(32)]
    aq.qp_plane(y0, qp, n0, gq, gouts[0])
    torch.cuda.synchronize()
    g32 = torch.cuda.CUDAGraph()
    with graph_capture(g32):
        for k, o in enumerate(gouts):
            aq.qp_plane(y0, qp, n0 if k % 2 else None, gq, o)
    for q in (qp, 12, 51):
        gq.fill_(q)
        g32.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(o, aq.qp_plane_plain(y0, q, n0 if k % 2 else None))
                  for k, o in enumerate(gouts)),
              f"K14a: a launch of a graph of 32 at qp {q} differs from plain")
    torch.cuda.synchronize()
    jd.jpeg_analyze.launches, aq.qp_plane.launches, aq.qp_plane.rows.launches = saved
    rep.update(k14a_cases=n14, k14a_s=time.perf_counter() - t1,
               s=time.perf_counter() - t_phase)
    print(f"(a) k16b14a: K16b equal to plain, every bin, on {n16} inputs (1080p, S = 4, "
          f"4K at nx 1, 3, 4; 1919x1079; all zero; saturated; crafted runs, sizes and DC "
          f"sizes past 16 at 1-40 MCUs; S = 65; calls in a row, graph replays), dc_y of "
          f"the one-MCU case {rep_dc[0, :3].tolist()}... ({rep['k16b_s']:.1f} s); K14a/K14r "
          f"equal to plain on {n14} inputs (1080p with and without the lookahead, qp_dev, "
          f"4K, 1919x1079, activities past int32, SAD thresholds, 1-5 MB columns, views off "
          f"16 bytes, 1, 8 and 64 rows with duplicates), a graph of 32 launches at three "
          f"qp_dev ({rep['k14a_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


def skip_case(nr: int, nc: int, intra: bool, dev, rng, offs=None):
    """13s's inputs at the P core's shapes with random contents: ``out``
    (the I16-in-P tensors where ``intra``) and the reference planes, each
    tensor ``offs.get(key, 0)`` bytes past a 16-byte boundary."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask

    offs = offs or {}
    shapes = {"mv": (2,), "luma": (16, 16), "cb_dc": (4,), "cb_ac": (4, 15),
              "cr_dc": (4,), "cr_ac": (4, 15), "mb_intra": (), "i16_dc": (16,),
              "i16_ac": (16, 15)}
    out = {}
    for k in damage_mask._SKIP_ZERO:
        if k in ("mb_intra", "i16_dc", "i16_ac") and not intra:
            continue
        v = torch.from_numpy(rng.integers(-60, 60, (nr, nc) + shapes[k]).astype(np.int32))
        out[k] = at_offset(v > 0 if k == "mb_intra" else v, offs.get(k, 0), dev)
    planes = lambda: [rng.integers(0, 256, s, dtype=np.uint8)
                      for s in ((16 * nr, 16 * nc), (8 * nr, 8 * nc), (8 * nr, 8 * nc))]
    for k, p in zip(damage_mask._SKIP_RECON, planes()):
        out[k] = at_offset(torch.from_numpy(p), offs.get(k, 0), dev)
    refs = [at_offset(torch.from_numpy(p), offs.get("ref" + k[5:], 0), dev)
            for k, p in zip(damage_mask._SKIP_RECON, planes())]
    return out, refs


def at_offset(t, off: int, dev):
    """A contiguous copy of ``t`` on ``dev`` starting ``off`` bytes past a
    16-byte boundary (a view of a larger buffer)."""
    import torch

    n = t.numel() * t.element_size()
    buf = torch.empty(n + 32, dtype=torch.uint8, device=dev)
    base = (-buf.data_ptr()) % 16
    v = buf[base + off:base + off + n].view(t.dtype).view(t.shape)
    v.copy_(t.to(dev))
    check(v.data_ptr() % 16 == off % 16, "a view is not where it should be")
    return v


def k13s13_phase(report):
    """13s and K13 against their plain versions, ``torch.equal``, on the
    inputs that break their designs.  13s (in place, every tensor): the
    (r // 3) % 2 and every-other-row gates, all rows kept (nothing
    written), all gated, only the first or only the last row gated, tune
    off and tune=hq with I16-in-P, the frame view of nx = 2 and 4 shards of
    the padded-reference P core, 4K, 81 MBs a row (1296x720: mv's rows off
    16 bytes), tensors 1-15 bytes off a 16-byte boundary, a graph replayed
    on new gates.  K13 (new planes, the old reference untouched): 1, 8 and
    68 rows of 1080p, a worklist padded with duplicates, rows 0 and nr - 1,
    4K, W = 16 odd (1296x720: chroma lines of 648 bytes), recon stacks and
    planes that are views off 16 bytes, a graph replayed on new worklists.
    Launches made here leave the wrappers' counts as they were."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask, h264_inter
    from docker_nvidia_glx_desktop_tpu_torch.ops.devloop import graph_capture
    from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rep = report["k13s13"] = {}
    saved = (damage_mask.force_skip_rows.launches, damage_mask.scatter_rows.launches)
    rng = np.random.default_rng(21)
    n13s = n13 = 0

    def gate_held(label, out, keep, refs):
        nonlocal n13s
        want = damage_mask.force_skip_rows_plain({k: v.clone() for k, v in out.items()},
                                                 keep, *(r.clone() for r in refs))
        before = {k: v.clone() for k, v in out.items()}
        snap = [r.clone() for r in refs]
        got = damage_mask.force_skip_rows(out, keep, *refs)
        check(got is out, f"13s {label}: the gate did not return out")
        for k in want:
            check(torch.equal(got[k], want[k]), f"13s {label}: {k} differs from plain in "
                  f"{int((got[k] != want[k]).sum())} elements")
        check(all(torch.equal(a, b) for a, b in zip(refs, snap)),
              f"13s {label}: the reference changed")
        n13s += 1
        return before

    # -- 13s -----------------------------------------------------------------------
    x = k13s13_inputs(dev)
    for name in K13S_FORMS:
        out, keep, refs = x[name]
        gate_held(name, {k: v.clone() for k, v in out.items()}, keep, refs)
    patterns = {"(r // 3) % 2": lambda r, nr: (r // 3) % 2 == 0,
                "every other row": lambda r, nr: r % 2 == 0,
                "all kept": lambda r, nr: True, "all gated": lambda r, nr: False,
                "only the first gated": lambda r, nr: r != 0,
                "only the last gated": lambda r, nr: r != nr - 1}
    for nr, nc, label in ((H_PAD // 16, W // 16, "1080p"), (45, 81, "1296x720")):
        for intra in (False, True):
            for pname, f in patterns.items():
                out, refs = skip_case(nr, nc, intra, dev, rng)
                keep = torch.tensor([f(r, nr) for r in range(nr)], device=dev)
                before = gate_held(f"{label} {pname} i16={intra}", out, keep, refs)
                if pname == "all kept":
                    check(all(torch.equal(out[k], before[k]) for k in out),
                          "13s: all rows kept, yet the gate wrote")
    odd = {"mv": 4, "luma": 12, "cb_ac": 8, "mb_intra": 3, "i16_dc": 4, "i16_ac": 8,
           "recon_y": 5, "refy": 9, "recon_cb": 8, "refcb": 8, "recon_cr": 1, "refcr": 15}
    for nr, nc in ((H_PAD // 16, W // 16), (45, 81)):
        out, refs = skip_case(nr, nc, True, dev, rng, odd)
        keep = torch.tensor([(r // 3) % 2 == 0 for r in range(nr)], device=dev)
        gate_held(f"{nr}x{nc} MBs, tensors off 16 bytes", out, keep, refs)
    # the spatial step's frame view of the padded-reference core's shard stacks
    g = gop_frames(2, seed=4)
    cur, prev = pair_planes(g[1]), pair_planes(g[0])
    for nx in SP_NX:
        pads = batch.spatial_halo_pad(*prev, nx)
        sv = lambda t: t.view((nx, t.shape[0] // nx) + tuple(t.shape[1:]))
        for tune, p_intra in (("off", False), ("hq", True)):
            core = h264_inter.encode_p_frame_padded_ref(*(sv(p) for p in cur), *pads,
                                                        PAIRS_QP, tune=tune, p_intra=p_intra)
            out = {k: batch._frame_view(v) for k, v in core.items()}
            keep = torch.tensor([(r // 3) % 2 == 0 for r in range(H_PAD // 16)], device=dev)
            gate_held(f"frame view nx={nx} tune={tune}", out, keep, prev)
    # one graph, replayed on new gates and new outputs
    out, refs = skip_case(H_PAD // 16, W // 16, True, dev, rng)
    keep = torch.zeros(H_PAD // 16, dtype=torch.bool, device=dev)
    damage_mask.force_skip_rows({k: v.clone() for k, v in out.items()}, keep, *refs)
    torch.cuda.synchronize()
    gr = torch.cuda.CUDAGraph()
    with graph_capture(gr):
        damage_mask.force_skip_rows(out, keep, *refs)
    for i in range(3):
        fresh, _ = skip_case(H_PAD // 16, W // 16, True, dev, rng)
        for k in out:
            out[k].copy_(fresh[k])
        keep.copy_(torch.from_numpy(rng.random(H_PAD // 16) < 0.5))
        want = damage_mask.force_skip_rows_plain({k: v.clone() for k, v in out.items()},
                                                 keep, *refs)
        gr.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(out[k], want[k]) for k in want),
              f"13s: replay {i} of one graph differs from plain")
        n13s += 1
    rep["k13s_cases"], rep["k13s_s"] = n13s, time.perf_counter() - t_phase

    # -- K13 -----------------------------------------------------------------------
    t1 = time.perf_counter()

    def scatter_held(label, refs, rec, rows):
        nonlocal n13
        snap = [r.clone() for r in refs]
        got = damage_mask.scatter_rows(*refs, *rec, rows)
        want = damage_mask.scatter_rows_plain(*refs, *rec, rows)
        for p, a, b in zip(("y", "cb", "cr"), got, want):
            check(torch.equal(a, b), f"K13 {label}: {p} differs from plain in "
                  f"{int((a != b).sum())} bytes")
        check(all(torch.equal(a, b) for a, b in zip(refs, snap)),
              f"K13 {label}: the old reference changed")
        n13 += 1

    def k13_case(nr, nc, rows, offs=None):
        """Random planes of nr MB rows of nc MBs and a recon stack for
        ``rows`` (duplicates carry equal recon rows), each plane
        ``offs.get(key, 0)`` bytes past a 16-byte boundary."""
        offs = offs or {}
        rows = np.asarray(rows, np.int32)
        mk = lambda h, w, key, fill=None: at_offset(torch.from_numpy(
            rng.integers(0, 256, (h, w), dtype=np.uint8) if fill is None else fill),
            offs.get(key, 0), dev)
        refs = [mk(16 * nr, 16 * nc, "ry"), mk(8 * nr, 8 * nc, "rcb"), mk(8 * nr, 8 * nc, "rcr")]
        first = {int(r): i for i, r in reversed(list(enumerate(rows)))}
        rec = []
        for key, n, w in (("ey", 16, 16 * nc), ("ecb", 8, 8 * nc), ("ecr", 8, 8 * nc)):
            own = rng.integers(0, 256, (len(rows), n, w), dtype=np.uint8)
            own = own[[first[int(r)] for r in rows]].reshape(len(rows) * n, w)
            rec.append(mk(len(rows) * n, w, key, own))
        return refs, rec, torch.from_numpy(rows).to(dev)

    for name in K13_FORMS:
        scatter_held(name, *x[name])
    nr1 = H_PAD // 16
    for nr, nc, label in ((nr1, W // 16, "1080p"), (45, 81, "1296x720"),
                          (H_PAD // 8, W // 8, "4K")):
        for rows in ([0], [nr - 1], list(range(20, 28)), list(range(nr)),
                     [5, 9, 9, 9], [nr - 1, 0, 3, 3, 3, 3, 3, 3], list(range(nr - 1, -1, -1))):
            scatter_held(f"{label} rows {rows[:8]}", *k13_case(nr, nc, rows))
        for offs in ({"ry": 4, "rcb": 8, "ey": 12, "ecr": 3},
                     {"rcr": 1, "ecb": 7, "ey": 2, "ry": 15, "ecr": 8}):
            scatter_held(f"{label} planes off 16 bytes {offs}",
                         *k13_case(nr, nc, [nr - 1, 0, 7, 7], offs))
    # a recon stack that is a view of a larger stack
    refs, rec, rows = k13_case(nr1, W // 16, list(range(8)))
    big = [torch.cat([r, r.flip(0)]) for r in rec]
    scatter_held("recon stack a view of a larger one", refs,
                 [b[:r.shape[0]] for b, r in zip(big, rec)], rows)
    scatter_held("recon stack a view past its first half", refs,
                 [b[r.shape[0]:] for b, r in zip(big, rec)], rows.flip(0).contiguous())
    # one graph, replayed on new worklists and recon rows
    refs, rec, rows = k13_case(nr1, W // 16, list(range(8)))
    damage_mask.scatter_rows(*refs, *rec, rows)
    torch.cuda.synchronize()
    gr = torch.cuda.CUDAGraph()
    with graph_capture(gr):
        gout = damage_mask.scatter_rows(*refs, *rec, rows)
    for i in range(3):
        nrefs, nrec, nrows = k13_case(nr1, W // 16, sorted(rng.choice(nr1, 8, replace=False)))
        for a, b in zip(refs + rec, nrefs + nrec):
            a.copy_(b)
        rows.copy_(nrows)
        gr.replay()
        torch.cuda.synchronize()
        want = damage_mask.scatter_rows_plain(*refs, *rec, rows)
        check(all(torch.equal(a, b) for a, b in zip(gout, want)),
              f"K13: replay {i} of one graph differs from plain")
        n13 += 1
    torch.cuda.synchronize()
    damage_mask.force_skip_rows.launches, damage_mask.scatter_rows.launches = saved
    rep.update(k13_cases=n13, k13_s=time.perf_counter() - t1, s=time.perf_counter() - t_phase)
    print(f"(a) k13s13: 13s equal to plain, every tensor, on {n13s} inputs (S20's form, "
          f"I16-in-P, 4K; every-other, (r // 3) % 2, all kept (nothing written), all gated, "
          f"first or last gated at 1080p and 81 MBs a row, with and without I16-in-P; "
          f"tensors off 16 bytes; the frame views of nx {SP_NX} at two tiers; graph replays) "
          f"({rep['k13s_s']:.1f} s); K13 equal to plain, the old reference untouched, on "
          f"{n13} inputs (1, 8, 68 rows; duplicates; rows 0 and nr - 1; 4K; W = 16 x 81; "
          f"planes and recon stacks off 16 bytes; stack views; graph replays) "
          f"({rep['k13_s']:.1f} s); phase {rep['s']:.1f} s")
    return []


# K5's stages cut out of copies of inter.cu, one stage a copy (timing
# only: a cut stage leaves its outputs wrong but every index in range)
K5_VARIANTS = {
    "base": [],
    "no_coarse": [("  if (lane < 27) {", "  if (lane < 0) {"),
                  ("const int cy = -8 + 2 * (int)((key & 127) / 9), "
                   "cx = -8 + 2 * (int)((key & 127) % 9);",
                   "const int cy = 0, cx = 0;")],
    "no_rerank": [("    if (k < 9) {\n      const int oy = k ? nb_y(k - 1) : 0",
                   "    if (k < 0) {\n      const int oy = k ? nb_y(k - 1) : 0")],
    "no_planes": [("  if (lane < SRC_H) {", "  if (lane < 0) {"),
                  ("task < 4 * PW; task += 32)", "task < 0; task += 32)")],
    "no_half": [("    for (int tt = 0; tt < 4 / RS; ++tt) {\n"
                 "      const int i = RS * (g + 4 * tt);\n      uint32_t rw[4];",
                 "    for (int tt = 0; tt < 0; ++tt) {\n"
                 "      const int i = RS * (g + 4 * tt);\n      uint32_t rw[4];")],
    "no_quarter": [("    for (int tt = 0; tt < 4 / RS; ++tt) {\n"
                    "      const int i = RS * (g + 4 * tt);\n      uint4 pw;",
                    "    for (int tt = 0; tt < 0; ++tt) {\n"
                    "      const int i = RS * (g + 4 * tt);\n      uint4 pw;")],
    "no_residual": [("  residual<TIER>(ws, lane,", "  if (0) residual<TIER>(ws, lane,")],
}


# K4's last-block work cut out of copies of content.cu (timing only)
K4_VARIANTS = {
    "base": [],
    "no_select": [("  if (!last) return;\n", "  return;\n")],
    "no_sums": [("  for (int i0 = t; i0 < n; i0 += NT * B) {\n    int g[B]",
                 "  for (int i0 = t; i0 < 0; i0 += NT * B) {\n    int g[B]")],
    "no_digits": [("  for (int d = 3; d >= 0; --d) {", "  for (int d = 3; d >= 4; --d) {")],
}


def k5k4_split() -> int:
    """``python3 chip_smoke.py k5k4-split``: the inter and content sources'
    ``-Xptxas -v`` lines, K5's tier-0 launch at 1080p with each stage cut
    out (``K5_VARIANTS``, graph replays), and K4's kernels by device time
    (``kernel_split``) in its full, intra and ``mb_intra`` forms and K4c
    at K = 4, beside each form's CUDA-event ms.  Writes
    ``chiprun_out/k5k4_split.json``."""
    import ctypes

    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        _cuda, content_stats, h264_device, h264_inter)
    from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
        rgb_to_yuv420_host)

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    ptx = {k: ptxas_lines(logs.get(k, "")) for k in ("inter", "content")}
    for src, lines in ptx.items():
        for ln in lines:
            print(f"ptxas {src}: {ln}", flush=True)
    libs = build_variants("inter", K5_VARIANTS)
    dev = torch.device("cuda")

    def planes(rgb):
        return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in rgb_to_yuv420_host(rgb, H_PAD, W)]

    gop = gop_frames(3, seed=2)
    prev, cur = planes(gop[0]), planes(gop[1])
    lv = h264_device.encode_intra_frame_yuv(*prev, PAIRS_QP)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    nr, nc = H_PAD // 16, W // 16
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    ptrs = [*cur, *ref, None, None, i32(nr, nc, 2), i32(nr, nc, 16, 16),
            i32(nr, nc, 4), i32(nr, nc, 4, 15), i32(nr, nc, 4),
            i32(nr, nc, 4, 15), torch.empty_like(cur[0]),
            torch.empty_like(cur[1]), torch.empty_like(cur[2])]
    k5 = {}
    for name in K5_VARIANTS:
        fn = libs[name].inter_frame_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])

        def call():
            err = fn(*[None if t is None else t.data_ptr() for t in ptrs],
                     nr, nc, nr, PAIRS_QP, PAIRS_QP, 1,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{name}: CUDA error {err}")
        k5[name] = graph_ms(call, reps=20)
        print(f"K5 {name}: {k5[name]:.4f} ms", flush=True)

    o = h264_inter.encode_p_frame(*cur, *ref, PAIRS_QP)
    k4libs = build_variants("content", K4_VARIANTS)
    keys = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    vecs = torch.empty((1, 10), dtype=torch.float32, device=dev)
    grids = torch.empty((1, nr, nc), dtype=torch.uint8, device=dev)
    scr = torch.empty(4 * nr * nc, dtype=torch.int32, device=dev)
    k4cut = {}
    for form, opt in (("full", [o["recon_y"], o["mv"]] + [o[k] for k in keys]),
                      ("intra", [None] * 7)):
        ptrs4 = [cur[0], prev[0]] + opt + [None, vecs, grids, scr]
        for name in K4_VARIANTS:
            fn = k4libs[name].chunk_stats_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs4) + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])

            def call4():
                err = fn(*[None if t is None else t.data_ptr() for t in ptrs4],
                         1, nr, nc, 512, torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"{name}: CUDA error {err}")
            k4cut[f"{form}_{name}"] = graph_ms(call4, reps=20)
            print(f"K4 {form} {name}: {k4cut[form + '_' + name]:.4f} ms",
                  flush=True)

    ohq = h264_inter.encode_p_frame(*cur, *ref, PAIRS_QP, tune="hq",
                                    p_intra=True)
    keys = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
    resid, resid_hq = (tuple(x[k] for k in keys) for x in (o, ohq))
    y, py = cur[0], prev[0]
    ys = torch.stack([py, y, py, y])
    st = lambda t: torch.stack([t] * 4)
    forms = {
        "full": lambda: content_stats.frame_stats_full(
            y, py, 512, o["recon_y"], o["mv"], resid),
        "intra": lambda: content_stats.frame_stats(y, py, 512),
        "mb_intra": lambda: content_stats.frame_stats_full(
            y, py, 512, ohq["recon_y"], ohq["mv"], resid_hq, ohq["mb_intra"]),
        "k4c": lambda: content_stats.chunk_stats(
            ys, py, 512, o["recon_y"], st(o["mv"]),
            tuple(st(t) for t in resid)),
    }
    k4 = {}
    for name, fn in forms.items():
        k4[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn),
                    "split": kernel_split(fn)}
        print(f"K4 {name}: {json.dumps(k4[name])}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k5k4_split.json"), "w") as f:
        json.dump({"card": smi, "ptxas": ptx, "k5_cut_ms": k5,
                   "k4_cut_ms": k4cut, "k4": k4}, f, indent=1)
    return 0


# K8's stages cut out of copies of deblock.cu (timing only: a cut stage
# leaves its outputs wrong but every index in range).  The parent of the
# redesign cut its staging, walk and write-back the same way (PERF.md).
K8_VARIANTS = {
    "base": [],
    "no_prepass": [("    mb_bs(nz ? nz + c * 16 : nullptr, mv, r * nc + c, c, sbs + c * 8);\n",
                    "")],
    "no_filter": [("  const int p0 = pw >> 24, p1", "  return;\n  const int p0 = pw >> 24, p1")],
    "no_transpose": [("      lines_to_columns(tb, k, w, col);",
                      "      for (int q = 0; q < 4; ++q) col[q] = w[q];"),
                     ("      columns_to_lines(tb, k, col, w);",
                      "      for (int q = 0; q < 4; ++q) w[q] = col[q];")],
    "no_walk": [("  if (warp) return;", "  return;")],
}


# K2's stages cut out of copies of cavlc.cu (timing only), and "g8": the
# chunk of eight MBs at two CTAs an SM (outputs right, the other shape)
K2_VARIANTS = {
    "base": [],
    "g8": [("constexpr int I_G = 6;", "constexpr int I_G = 8;"),
           ("constexpr int I_MINB = 3;", "constexpr int I_MINB = 1;")],
    "no_stage": [("    stage_i4(&s.li4[m0][0][0], L.luma_i4 + first * 256, n);\n"
                  "    stage(s.lac[m0], L.luma_ac + first * 240, n * 240);\n", "")],
    "no_code": [("      code_block(lv, len, nc_ctx, is_cdc, max_coeff, gate, s.vals[m - 1][j], "
                 "s.lens[m - 1][j]);\n", "")],
    "no_copy_out": [("        bulk_store(vdst, &s.vals[0][0][0], bytes);\n"
                     "        bulk_store(ldst, &s.lens[0][0][0], bytes);\n", "")],
}


def k8_inputs(dev, qp: int = PAIRS_QP):
    """A 1080p P frame's K8 inputs: the P core's recon of a moving desktop
    frame, its MVs, coded flags and luma levels; and an IDR's recon."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device, h264_inter
    from docker_nvidia_glx_desktop_tpu_torch.ops.cavlc_p_device import nnz_raster

    gop = gop_frames(2, seed=2)
    desk, moving = pair_planes(gop[0]), pair_planes(gop[1])
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    o = h264_inter.encode_p_frame(*moving, *ref, qp)
    rec = (o["recon_y"], o["recon_cb"], o["recon_cr"])
    return {"levels": lv, "intra": ref, "p": rec, "mv": o["mv"],
            "nnz": nnz_raster(o["luma"]), "luma": o["luma"]}


def k8_launch_args(x: dict, form: str, dev, qp: int = PAIRS_QP):
    """deblock_launch's tensors and ints for a form (intra, p, luma) of
    ``k8_inputs``: the same arguments the wrapper passes."""
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_deblock

    planes = x["intra" if form == "intra" else "p"]
    outs = [torch.empty_like(p) for p in planes]
    opt = {"intra": [None, None, None], "p": [x["nnz"], x["mv"], None],
           "luma": [None, x["mv"], x["luma"]]}[form]
    tl, tc = h264_deblock._tables(qp)
    nr, nc = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    return (list(planes) + opt + [None] + outs,
            [nr, nc, tl[0], tl[1], *tl[2], tc[0], tc[1], *tc[2], 1])


def k2k8_split() -> int:
    """``python3 chip_smoke.py k2k8-split``: the cavlc and deblock sources'
    ``-Xptxas -v`` lines; K2's and K8's kernels by device time
    (``kernel_split``) beside each wrapper's CUDA-event and replayed ms,
    at 1080p on a desktop IDR's levels (K2, and K2 with the qp chain) and
    a P frame's recon (K8 intra, P with ``nnz_blk``, P with ``luma``);
    K8's launch with each stage cut out of a copy of ``deblock.cu``
    (``K8_VARIANTS``, graph replays).  Writes
    ``chiprun_out/k2k8_split.json``."""
    import ctypes

    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import (
        _cuda, aq, cavlc_device, h264_deblock, h264_device)

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    ptx = {k: ptxas_lines(logs.get(k, "")) for k in ("cavlc", "deblock")}
    for src, lines in ptx.items():
        for ln in lines:
            print(f"ptxas {src}: {ln}", flush=True)
    dev = torch.device("cuda")
    x = k8_inputs(dev)
    res = {"card": smi, "ptxas": ptx}
    lv = x["levels"]
    keys = cavlc_device._LEVEL_KEYS
    lvk = {k: lv[k] for k in keys}
    qmap = aq.qp_plane(x["intra"][0], PAIRS_QP)
    lvq = dict(lvk, qp_map=qmap)
    forms = {
        "k2": lambda: cavlc_device.frame_block_slots(lvk),
        "k2_chain": lambda: cavlc_device.frame_block_slots(lvq, PAIRS_QP),
        "k8_intra": lambda: h264_deblock.deblock_frame(*x["intra"], PAIRS_QP),
        "k8_p": lambda: h264_deblock.deblock_frame(
            *x["p"], PAIRS_QP, nnz_blk=x["nnz"], mv=x["mv"]),
        "k8_luma": lambda: h264_deblock.deblock_frame(
            *x["p"], PAIRS_QP, luma=x["luma"], mv=x["mv"]),
    }
    for name, fn in forms.items():
        res[name] = {"ms": cuda_ms(fn, reps=20), "graph_ms": graph_ms(fn),
                     "split": kernel_split(fn)}
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    libs = build_variants("deblock", K8_VARIANTS)
    cut = {}
    for form in ("intra", "p", "luma"):
        ts, ints = k8_launch_args(x, form, dev)
        for name in K8_VARIANTS:
            fn = libs[name].deblock_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * len(ts) + [ctypes.c_int] * len(ints)
                           + [ctypes.c_void_p])

            def call(fn=fn, ts=ts, ints=ints, name=name):
                err = fn(*[None if t is None else t.data_ptr() for t in ts],
                         *ints, torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"{name}: CUDA error {err}")
            cut[f"{form}_{name}"] = graph_ms(call, reps=20)
            print(f"K8 {form} {name}: {cut[form + '_' + name]:.4f} ms", flush=True)
    res["k8_cut_ms"] = cut
    libs = build_variants("cavlc", K2_VARIANTS)
    nr, nc = H_PAD // 16, W // 16
    i32 = lambda *sh: torch.empty(sh, dtype=torch.int32, device=dev)
    ts = [lvk[k] for k in keys] + [i32(nr, nc, 27, 34), i32(nr, nc, 27, 34),
                                   i32(nr, nc, 20), i32(nr, nc, 20), None]
    cut = {}
    for name in K2_VARIANTS:
        cavlc_device._upload_tables(libs[name])
        fn = libs[name].cavlc_slots_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * len(ts) + [ctypes.c_int] * 3 + [ctypes.c_void_p]

        def call2(fn=fn, name=name):
            err = fn(*[None if t is None else t.data_ptr() for t in ts], nr, nc, 1,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{name}: CUDA error {err}")
        cut[name] = graph_ms(call2, reps=20)
        print(f"K2 {name}: {cut[name]:.4f} ms", flush=True)
    res["k2_cut_ms"] = cut
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k2k8_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


# The packer's stages cut out of copies of pack.cu (timing only: a cut
# stage leaves its outputs wrong but every index in range).  The parent
# of the redesign has none of these lines: its split times the wrappers
# only.
K3K7_MARK = "seg_kernel"
K3K7_VARIANTS = {
    "base": [],
    "count_only": [("  if (warp == 0) {\n    const int b = lane < SEG",
                    "  return;\n  if (warp == 0) {\n    const int b = lane < SEG")],
    "no_wait": [("before += wait_for(seg_pub + q);", "before += q;"),
                ("w += wait_for(row_pub + q);", "w += q;")],
    "no_place": [("    if (own) {\n      // the live slots", "    if (false) {\n      // the live slots")],
}


def k3k7_split() -> int:
    """``python3 chip_smoke.py k3k7-split``: the pack source's ``-Xptxas
    -v`` lines; K3's and K7's forms (``k3k7_forms``) by device time
    (``kernel_split``: the memset and each kernel) beside each wrapper's
    CUDA-event and replayed ms, at 1080p; where ``csrc/pack.cu`` holds the
    segment kernel, its launch with a stage cut out of a copy
    (``K3K7_VARIANTS``, graph replays of K3 and K7).  Writes
    ``chiprun_out/k3k7_split.json``."""
    import ctypes

    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, bitmerge

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    ptx = ptxas_lines(logs.get("pack", ""))
    for ln in ptx:
        print(f"ptxas pack: {ln}", flush=True)
    dev = torch.device("cuda")
    x = k3k7_inputs(dev)
    res = {"card": smi, "ptxas": ptx}
    for name, r in k3k7_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    if K3K7_MARK in open(os.path.join(_cuda.CSRC, "pack.cu")).read():
        libs = build_variants("pack", K3K7_VARIANTS)
        nr, nc = H_PAD // 16, W // 16
        buf = lambda ns: torch.empty(bitmerge._buffer_bytes(nr, nc, ns),
                                     dtype=torch.uint8, device=dev)
        calls = {"k3": ("pack_frame_launch", [*x["i"], *x["hdr"], buf(1), None],
                        [nr, nc, 1, 0]),
                 "k7": ("pack_p_frame_launch", [*x["p"], *x["hdr_p"], buf(1), None],
                        [nr, nc, 26, 1, 0]),
                 "k3_s8": ("pack_frame_launch", [*x["i8"], *x["hdr"], buf(8), None],
                           [nr, nc, 8, 0])}
        cut = {}
        for form, (entry, ts, ints) in calls.items():
            for name in K3K7_VARIANTS:
                fn = libs[name][entry]
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * len(ts) + [ctypes.c_int] * len(ints)
                               + [ctypes.c_void_p])

                def call(fn=fn, ts=ts, ints=ints, name=name):
                    err = fn(*[None if t is None else t.data_ptr() for t in ts],
                             *ints, torch.cuda.current_stream().cuda_stream)
                    check(err == 0, f"{name}: CUDA error {err}")
                split = kernel_split(call)
                cut[f"{form}_{name}"] = {"graph_ms": graph_ms(call, reps=20),
                                         "device_ms": sum(split.values())}
                print(f"{form} {name}: {json.dumps(cut[form + '_' + name])}", flush=True)
        res["cut_ms"] = cut
    # the library's stream over K3's lengths: one read, and a read and a write
    lens = x["i"][1]
    res["library"] = {"sum_ms": cuda_ms(lambda: lens.sum(), reps=20),
                      "sum_device_ms": sum(kernel_split(lambda: lens.sum()).values()),
                      "clone_device_ms": sum(kernel_split(lambda: lens.clone()).values()),
                      "bytes": nbytes(lens)}
    print(f"library on K3's lengths: {json.dumps(res['library'])}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k3k7_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


# K16c's and K11p's stages cut out of copies of jpeg.cu and cabac.cu
# (timing only: a cut stage leaves its outputs wrong but every index in
# range).  The parent of the redesign has none of these lines: its split
# times the wrappers only.
K11K16_MARK = "SegmentStore"
_NO_FINISH = ("  if (tid == 0) out.finish(", "  if (false) out.finish(")
# the DONE waits of SegmentStore::finish (lookback.cuh)
_NO_DONE_WAIT = [("lookback.cuh", "      if (s > 0) wait_for(st + s - 1, DONE);\n", ""),
                 ("lookback.cuh", "        wait_for(st + s - 1, DONE);\n", "")]
K16C_VARIANTS = {
    "base": [],
    # counts and look-back; no words placed or stored
    "no_write": [("for (int lo = 0; lo < out.nwords; lo += WIN_WORDS) {",
                  "for (int lo = 0; lo < 0; lo += WIN_WORDS) {"), _NO_FINISH],
    # staging, tables and look-back only
    "stage_only": [("  for (int g = warp; g < nblk; g += PACK_WARPS) {\n    int prev;",
                    "  for (int g = warp; g < 0; g += PACK_WARPS) {\n    int prev;"),
                   ("for (int lo = 0; lo < out.nwords; lo += WIN_WORDS) {",
                    "for (int lo = 0; lo < 0; lo += WIN_WORDS) {"), _NO_FINISH],
    # no waits: made-up segment offsets, no DONE waits
    "no_wait": [("excl = lookback::look_back(st, sg);", "excl = sg * 1000LL;")] + _NO_DONE_WAIT,
    # the window loop without placing the codes (zeroed words stored)
    "no_place": [("    for (int g = warp; g < nblk; g += PACK_WARPS) {\n      int prev;",
                  "    for (int g = warp; g < 0; g += PACK_WARPS) {\n      int prev;")],
}
K11P_VARIANTS = {
    "base": [],
    "no_write": [("for (int lo = 0; lo < st.nwords; lo += WIN) {",
                  "for (int lo = 0; lo < 0; lo += WIN) {"),
                 ("  if (tid == 0) st.finish(", "  if (false) st.finish(")],
    "stage_only": [("for (int k = warp; k < ns; k += SEG) {\n    bool nz;",
                    "for (int k = warp; k < 0; k += SEG) {\n    bool nz;"),
                   ("  if (warp < n) {\n    bool ovf = false;", "  if (false) {\n    bool ovf = false;"),
                   ("for (int lo = 0; lo < st.nwords; lo += WIN) {",
                    "for (int lo = 0; lo < 0; lo += WIN) {"),
                   ("  if (tid == 0) st.finish(", "  if (false) st.finish(")],
    "no_wait": [("transport.cuh", "excl = look_back(st, s);", "excl = s * 1000LL;"),
                ("transport.cuh", "w += wait_for(S.row_pub + q, INCL) >> 2;", "w += q;")]
               + _NO_DONE_WAIT,
    # the window loop without the pieces' second walk; the second walk
    # only counting (no positions, no shared atomics)
    "no_place": [("    if (warp < n && lane < cabac_rec::P_PIECES && pbits > 0) {",
                  "    if (false) {")],
    "walk_count": [("        RunSink rs(sm.win, p, nwin);\n        cabac_rec::p_piece(x, lane, rs);\n"
                    "        rs.flush();",
                    "        CountSink rs;\n        cabac_rec::p_piece(x, lane, rs);\n"
                    "        if (rs.n == 123457) sm.win[0] = 1u;")],
}


def variant_cut_times(srcs: dict, calls: dict) -> dict:
    """Each variant of ``srcs`` ({source: {name: substitutions}}) launched
    on the forms of ``calls`` ({form: (source, entry, tensors, (size
    function, its args), ints)}; a None tensor is a null pointer; the size
    function gives the one buffer's int32 words, from a length and ints):
    device ms and graph replays."""
    import ctypes

    import torch

    cut = {}
    for src, variants in srcs.items():
        libs = build_variants(src, variants)
        for form, (lib_src, entry, ts, (size_fn, size_args), ints) in calls.items():
            if lib_src != src:
                continue
            dev = next(t for t in ts if t is not None).device
            for name in variants:
                sz = libs[name][size_fn]
                sz.restype = ctypes.c_longlong
                sz.argtypes = ([ctypes.c_int] if src == "jpeg" else [ctypes.c_longlong]) \
                    + [ctypes.c_int] * (len(size_args) - 1)
                buf = torch.empty(int(sz(*size_args)), dtype=torch.int32, device=dev)
                fn = libs[name][entry]
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * (len(ts) + 1) + [ctypes.c_int] * len(ints)
                               + [ctypes.c_void_p])

                def call(fn=fn, ts=ts + [buf], ints=ints, name=name):
                    err = fn(*[None if t is None else t.data_ptr() for t in ts], *ints,
                             torch.cuda.current_stream().cuda_stream)
                    check(err == 0, f"{name}: CUDA error {err}")
                split = kernel_split(call)
                cut[f"{form}_{name}"] = {"graph_ms": graph_ms(call, reps=20),
                                         "device_ms": sum(split.values())}
                print(f"{form} {name}: {json.dumps(cut[form + '_' + name])}", flush=True)
    return cut


def k11k16_cuts(x: dict) -> dict:
    """Each variant of ``K16C_VARIANTS`` / ``K11P_VARIANTS`` on the 1080p
    forms (and K16c at S = 4 x nx = 4): device ms and graph replays."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, cabac_binarize
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    srcs = {"jpeg": K16C_VARIANTS, "cabac": K11P_VARIANTS}
    if not all(K11K16_MARK in open(os.path.join(_cuda.CSRC, f"{s}.cu")).read()
               for s in srcs):
        return {}
    calls = {}
    for form in ("j", "j_s4"):
        lv, tab, nx = x[form]
        s_, nmcu = lv[1].shape[:2]
        sw = jd.shard_words(nmcu // nx * 6)
        calls["k16c" + form[1:]] = ("jpeg", "jpeg_pack_launch", list(lv) + [tab],
                                    ("jpeg_pack_buffer_words", [s_, nmcu, nx, sw]),
                                    [s_, nmcu, nx, sw])
    for form in ("p", "p_noise"):
        nr, nc = x[form][1].shape[:2]
        slots, cap = cabac_binarize.layout("p")
        calls["k11" + form] = ("cabac", "binarize_p_launch", list(x[form]),
                               ("binarize_buffer_words",
                                [cabac_binarize.buffer_words("p", nr, nc), nr, nc]),
                               [nr, nc, slots, cap])
    return variant_cut_times(srcs, calls)


def k11k16_split() -> int:
    """``python3 chip_smoke.py k11k16-split``: the jpeg and cabac sources'
    ``-Xptxas -v`` lines; K16c's and K11p's forms (``k11k16_forms``) and
    K16a's 1080p transform by device time (``kernel_split``: each memset
    and kernel) beside each wrapper's CUDA-event and replayed ms; where
    the sources hold the segment kernels, their launches with a stage cut
    out of a copy (``K11K16_VARIANTS``, device time and graph replays).
    Writes ``chiprun_out/k11k16_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src in ("jpeg", "cabac"):
        res["ptxas"][src] = ptxas_lines(logs.get(src, ""))
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    x = k11k16_inputs(torch.device("cuda"))
    for name, r in k11k16_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = k11k16_cuts(x)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k11k16_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


# K10's and K11i's stages cut out of copies of levelpack.cu and cabac.cu
# (timing only).  The waits sit in transport.cuh (the look-back and the
# earlier rows' words) and lookback.cuh (the DONE waits).
K10K11I_MARKS = {"levelpack": "place_segment", "cabac": "i_seg_kernel"}
_NO_SEG_WAIT = [("transport.cuh", "excl = look_back(st, s);", "excl = s * 1000LL;"),
                ("transport.cuh", "w += wait_for(S.row_pub + q, INCL) >> 2;", "w += q;")]
_NO_ST_FINISH = ("  if (tid == 0) st.finish(", "  if (false) st.finish(")
_NO_WINDOWS = ("for (int lo = 0; lo < st.nwords; lo += WIN) {", "for (int lo = 0; lo < 0; lo += WIN) {")
K10_VARIANTS = {
    "base": [],
    # staging, counts and look-back; no codes placed, no words stored
    "no_write": [_NO_WINDOWS, _NO_ST_FINISH],
    # staging and look-back only
    "stage_only": [("  if (warp < n) {\n    int bits = 0;", "  if (false) {\n    int bits = 0;"),
                   _NO_WINDOWS, _NO_ST_FINISH],
    # no waits: made-up segment and row offsets, no DONE waits
    "no_wait": _NO_SEG_WAIT + _NO_DONE_WAIT,
    # the zeroed windows stored, no codes ORed into them
    "no_place": [("    if (warp < n) {\n      const int pos = st.lead",
                  "    if (false) {\n      const int pos = st.lead")],
    # a window that holds any segment, no occupancy bound (two waves)
    "win_full": [("constexpr int WIN = 1280;", "constexpr int WIN = SEGL * MAX_SLOTS / 2 + 1;"),
                 ("constexpr int MIN_CTAS = 8;", "constexpr int MIN_CTAS = 1;")],
}
K11I_VARIANTS = {
    "base": [],
    "no_write": [_NO_WINDOWS, _NO_ST_FINISH],
    "stage_only": [("for (int k = warp; k < ns; k += SEG) {\n    const int* ldc",
                    "for (int k = warp; k < 0; k += SEG) {\n    const int* ldc"),
                   ("  if (warp < n) {\n    const cabac_rec::ICtx x",
                    "  if (false) {\n    const cabac_rec::ICtx x"), _NO_WINDOWS, _NO_ST_FINISH],
    "no_wait": _NO_SEG_WAIT + _NO_DONE_WAIT,
    # the window loop without the pieces' second walk; the second walk
    # only counting (no positions, no shared stores)
    "no_place": [("    if (warp < n && pbits > 0) {", "    if (false) {")],
    "walk_count": [("        RunSink rs(sm.win, p, nwin);\n        cabac_rec::i_piece(x, lane, rs);\n"
                    "        rs.flush();",
                    "        CountSink rs;\n        cabac_rec::i_piece(x, lane, rs);\n"
                    "        if (rs.n == 123457) sm.win[0] = 1u;")],
}


def k10k11i_cuts(x: dict) -> dict:
    """Each variant of ``K10_VARIANTS`` / ``K11I_VARIANTS`` on the 1080p
    desktop and noise forms: device ms and graph replays."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, cabac_binarize, level_pack

    if not all(mark in open(os.path.join(_cuda.CSRC, f"{src}.cu")).read()
               for src, mark in K10K11I_MARKS.items()):
        return {}
    calls = {}
    for form in ("i", "i_noise"):
        nr, nc = x[form][0].shape[:2]
        slots, cap = cabac_binarize.layout("intra")
        calls["k11" + form] = ("cabac", "binarize_intra_launch", list(x[form]),
                               ("binarize_buffer_words",
                                [cabac_binarize.buffer_words("intra", nr, nc), nr, nc]),
                               [nr, nc, slots, cap])
    for form, keys in (("l_i", level_pack.INTRA_KEYS), ("l_p", level_pack.P_KEYS)):
        ts = [x[form][k] for k, _, _ in keys]
        nr, nc = ts[0].shape[:2]
        n = [k[1] for k in keys]
        calls["k10" + form[2:]] = ("levelpack", "level_pack_launch",
                                   ts + [None] * (7 - len(ts)),
                                   ("level_pack_buffer_words",
                                    [level_pack.buffer_words(nr, nc, sum(n)), nr, nc]),
                                   [nr, nc] + n + [0] * (7 - len(n)))
    return variant_cut_times({"levelpack": K10_VARIANTS, "cabac": K11I_VARIANTS}, calls)


def k10k11i_split() -> int:
    """``python3 chip_smoke.py k10k11i-split``: the levelpack and cabac
    sources' ``-Xptxas -v`` lines; K11i's and K10's forms
    (``k10k11i_forms``) by device time (``kernel_split``: each memset and
    kernel) beside each wrapper's CUDA-event and replayed ms; where the
    sources hold the segment kernels, their launches with a stage cut out
    of a copy (``K10_VARIANTS``, ``K11I_VARIANTS``: device time and graph
    replays).  Writes ``chiprun_out/k10k11i_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src in ("levelpack", "cabac"):
        res["ptxas"][src] = ptxas_lines(logs.get(src, ""))
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    x = k10k11i_inputs(torch.device("cuda"))
    res["i4_share"] = x["i4_share"]
    for name, r in k10k11i_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = k10k11i_cuts(x)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k10k11i_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


I16_MARK = "i16_want_kernel"
# the I16-in-P launches with a part cut out of a copy of inter.cu (timing
# only: a cut part leaves the outputs wrong)
I16_VARIANTS = {
    "base": [],
    # every MB takes the zero path: no kept MB builds its candidate again
    "no_kept": [("  if (!keep) {                        // 60 + 4 zero int4",
                 "  if (true) {                         // 60 + 4 zero int4")],
    # the want launch alone
    "want_only": [("  if (e) return e;\n  if (tier == 2)\n    i16_merge_kernel<2>",
                   "  if (true) return e;\n  if (tier == 2)\n    i16_merge_kernel<2>")],
}


def kernel_lines(lines: list, marks) -> list:
    """``ptxas_lines`` of the entry functions whose mangled name holds one
    of ``marks``."""
    out, on = [], False
    for ln in lines:
        if "Compiling entry function" in ln:
            on = any(m in ln for m in marks)
        if on:
            out.append(ln)
    return out


def i16_pass_args(fn):
    """The arguments of the I16-in-P host call that ``fn()`` makes."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter

    orig, got = h264_inter._i16_passes, []

    def rec(*a, **k):
        got.append((a, k))
        orig(*a, **k)

    h264_inter._i16_passes = rec
    try:
        fn()
    finally:
        h264_inter._i16_passes = orig
    return got[-1]


def i16_cuts(x: dict) -> dict:
    """Each of ``I16_VARIANTS`` launched on the passes' inputs of the
    desktop and noise frames at tier 2 and the 64-row worklist: device ms
    and graph replays."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, h264_inter

    if I16_MARK not in open(os.path.join(_cuda.CSRC, "inter.cu")).read():
        return {}
    libs = build_variants("inter", I16_VARIANTS)
    forms = i16halo_forms(x)
    cut = {}
    for form in ("i16_desk_t2", "i16_noise_t2", "i16_rows64"):
        (y, cb, cr, res, qpd, qmap, lam, score, nr, nc, qpi, tier, dev), kw = \
            i16_pass_args(forms[form][0])
        want = torch.empty((nr, nc), dtype=torch.uint8, device=dev)
        ts = ([y, cb, cr, kw.get("rows"), qpd, qmap, lam, score, want]
              + [res[k] for k in h264_inter._OUT_KEYS]
              + [res["mb_intra"], res["i16_dc"], res["i16_ac"]])
        for name, lib in libs.items():
            fn = lib["inter_intra_launch"]
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * len(ts) + [ctypes.c_int] * 4 + [ctypes.c_void_p]

            def call(fn=fn, name=name):
                err = fn(*[None if t is None else t.data_ptr() for t in ts],
                         nr, nc, qpi[0], tier, torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"{name}: CUDA error {err}")
            split = kernel_split(call)
            cut[f"{form}_{name}"] = {"graph_ms": graph_ms(call, reps=20),
                                     "device_ms": sum(split.values())}
            print(f"{form} {name}: {json.dumps(cut[form + '_' + name])}", flush=True)
    return cut


def i16halo_split() -> int:
    """``python3 chip_smoke.py i16halo-split``: the ``-Xptxas -v`` lines of
    the I16-in-P and halo pad kernels; each of ``i16halo_forms`` by device
    time (``kernel_split``: each kernel) beside its CUDA-event, replayed and
    bound ms (``i16halo_form_times``); where inter.cu holds the two-launch
    passes, their launches with a part cut out of a copy
    (``I16_VARIANTS``).  Writes ``chiprun_out/i16halo_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src in ("inter", "spatial"):
        res["ptxas"][src] = kernel_lines(ptxas_lines(logs.get(src, "")),
                                         ("i16", "halo_pad"))
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    x = i16halo_inputs(torch.device("cuda"))
    for name, r in i16halo_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = i16_cuts(x)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "i16halo_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


K16A_OLD_MARK = "__shared__ double pix[3][16][16];"
_OLD_ROWS = ("    double acc = __dmul_rn(x[0], (double)dv[0]);\n"
             "    for (int j = 1; j < 8; ++j) acc = __dadd_rn(acc, __dmul_rn(x[j], (double)dv[j]));\n"
             "    tmp[bi][i * 8 + v] = acc;\n")
_OLD_COLS = ("    double acc = __dmul_rn((double)du[0], tmp[bi][v]);\n"
             "    for (int i = 1; i < 8; ++i) acc = __dadd_rn(acc, __dmul_rn((double)du[i], "
             "tmp[bi][i * 8 + v]));\n")
_OLD_WIDE = [("__shared__ float k[kConsts];", "__shared__ double k[kConsts];"),
             ("const float* m = k + kMat", "const double* m = k + kMat"),
             ("const float* dv = k + kDct", "const double* dv = k + kDct"),
             ("const float* du = k + kDct", "const double* du = k + kDct"),
             ("const float q = k[", "const float q = (float)k[")]
# K16a's stages cut out of copies of the PR 6 layout of jpeg.cu (a CTA an
# MCU; timing only, except ``widened``, whose levels are the same): the
# colour alone (with the quantize and the stores), the colour and the row
# pass, every stage with no store, and the constants widened to double
# once in shared memory (no float-to-double conversion a product), then
# also the pixels made double by an add instead of a conversion
K16A_OLD_VARIANTS = {
    "base": [],
    "colour_only": [(_OLD_ROWS, "    tmp[bi][i * 8 + v] = x[v];\n"),
                    (_OLD_COLS, "    double acc = tmp[bi][u * 8 + v];\n")],
    "colour_rows": [(_OLD_COLS, "    double acc = tmp[bi][u * 8 + v];\n")],
    "no_stores": [("    const int z = c_zpos[u * 8 + v];\n",
                   "    const int z = c_zpos[u * 8 + v];\n    if (level != 0x12345678) continue;\n")],
    "widened": _OLD_WIDE,
    "widened_i2f": _OLD_WIDE + [(
        "const double r = p[0], g = p[1], b = p[2];",
        "const double r = __dadd_rn(__hiloint2double(0x43300000, p[0]), -0x1p52),\n"
        "               g = __dadd_rn(__hiloint2double(0x43300000, p[1]), -0x1p52),\n"
        "               b = __dadd_rn(__hiloint2double(0x43300000, p[2]), -0x1p52);")],
}
K16A_MARK = "K16A_TILE"
_ROW_PASS = ("  for (int v = 0; v < 8; ++v) t[v] = __dmul_rn(x[0], c_dct[v * 8]);\n"
             "#pragma unroll\n"
             "  for (int j = 1; j < 8; ++j)\n"
             "#pragma unroll\n"
             "    for (int v = 0; v < 8; ++v) t[v] = __dadd_rn(t[v], __dmul_rn(x[j], "
             "c_dct[v * 8 + j]));\n")
_COL_PASS = ("      for (int u = 0; u < 8; ++u) c[u] = __dmul_rn(c_dct[u * 8], t[0]);\n"
             "#pragma unroll\n"
             "      for (int i = 1; i < 8; ++i)\n"
             "#pragma unroll\n"
             "        for (int u = 0; u < 8; ++u) c[u] = __dadd_rn(c[u], "
             "__dmul_rn(c_dct[u * 8 + i], t[i]));\n")
_NO_COLOUR = ("          double v = __dadd_rn(__dmul_rn(r, c_mat[3 * d]), __dmul_rn(g, "
              "c_mat[3 * d + 1]));\n          v = __dadd_rn(v, __dmul_rn(b, "
              "c_mat[3 * d + 2]));\n",
              "          const double v = d == 0 ? r : d == 1 ? g : b;\n")
# the same cuts of the redesigned layout (``transform_kernel``: a CTA a
# tile of MCUs, warp-uniform constants): the colour alone (the quads, the
# quantize and the stores kept), the colour and both row passes, and no
# global store
K16A_VARIANTS = {
    "base": [],
    "colour_only": [(_ROW_PASS, "  for (int v = 0; v < 8; ++v) t[v] = x[v];\n"),
                    (_COL_PASS, "      for (int u = 0; u < 8; ++u) c[u] = t[u];\n")],
    "colour_rows": [(_COL_PASS, "      for (int u = 0; u < 8; ++u) c[u] = t[u];\n")],
    "no_stores": [("    *dst = make_int4(", "    if (src[0] == 0x12345678) *dst = make_int4(")],
    # probes: the colour's products cut; no frame loads (the words made up);
    # the memory and shared-memory work alone (no colour products, no DCT);
    # three CTAs an SM (90 registers) in place of five (63)
    "no_colour": [_NO_COLOUR],
    "no_loads": [("        for (int i = 0; i < 6; ++i) wd[i] = __ldg(wp + i);\n"
                  "        wd[6] = sh ? __ldg(wp + 6) : 0u;\n",
                  "        for (int i = 0; i < 6; ++i) wd[i] = 0x01010101u * (i + x0);\n"
                  "        wd[6] = 0u;\n")],
    "memory_only": [_NO_COLOUR,
                    (_ROW_PASS, "  for (int v = 0; v < 8; ++v) t[v] = x[v];\n"),
                    (_COL_PASS, "      for (int u = 0; u < 8; ++u) c[u] = t[u];\n")],
    "lb3": [("__launch_bounds__(k16a::NT, 5)", "__launch_bounds__(k16a::NT, 3)")],
}


def k16a_cuts(x: dict) -> dict:
    """Each variant of K16a's layout (``K16A_OLD_VARIANTS`` or
    ``K16A_VARIANTS``) launched on ``K16A_FORMS``: device ms and graph
    replays, and whether its levels equal the source's (0 where a cut
    part leaves them wrong by design)."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    src = open(os.path.join(_cuda.CSRC, "jpeg.cu")).read()
    variants = (K16A_OLD_VARIANTS if K16A_OLD_MARK in src
                else K16A_VARIANTS if K16A_MARK in src else {})
    if not variants:
        return {}
    libs = build_variants("jpeg", variants)
    cut = {}
    for form in K16A_FORMS:
        rgbs, lq, cq, ph, pw = x[form]
        want = jd.jpeg_transform(*x[form])
        s, h, w = rgbs.shape[:3]
        outs = [torch.empty_like(t) for t in want]
        ts = [rgbs, jd._consts(lq, cq, rgbs.device)] + outs
        for name, lib in libs.items():
            fn = lib["jpeg_transform_launch"]
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

            def call(fn=fn, name=name):
                err = fn(*[t.data_ptr() for t in ts], s, h, w, ph, pw,
                         torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            split = kernel_split(call)
            cut[f"{form}_{name}"] = {
                "graph_ms": graph_ms(call, reps=20), "device_ms": sum(split.values()),
                "equal": float(all(torch.equal(a, b) for a, b in zip(outs, want)))}
            print(f"{form} {name}: {json.dumps(cut[form + '_' + name])}", flush=True)
    return cut


SSE_MARK = "SUM_BITS"
# K14d's loads in flight a thread (``SSE_U``) in copies of aq.cu: 1, 2, 4
# (the source's) and 8 16-byte loads of each plane
SSE_VARIANTS = {f"u{u}": [("constexpr int SSE_U = 4;", f"constexpr int SSE_U = {u};")]
                for u in (1, 2, 8)}
SSE_VARIANTS["base"] = []


def sse_cuts(x: dict) -> dict:
    """Each of ``SSE_VARIANTS`` launched on ``SSE_FORMS``: device ms, one
    of 32 launches in a graph and whether the sum equals the source's."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, aq

    if SSE_MARK not in open(os.path.join(_cuda.CSRC, "aq.cu")).read():
        return {}
    libs = build_variants("aq", SSE_VARIANTS)
    cut = {}
    for form in SSE_FORMS:
        a, b = x[form]
        want = int(aq.sse_planes(a, b))
        for name, lib in libs.items():
            fn = lib["sse_launch"]
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
            out = torch.empty(1, dtype=torch.int64, device=a.device)

            def call(fn=fn, name=name, out=out):
                err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                         torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"{name}: CUDA error {err}")
            call()
            split = kernel_split(call)
            cut[f"{form}_{name}"] = {"each_ms": graph_each_ms(call),
                                     "device_ms": sum(split.values()),
                                     "equal": float(int(out) == want)}
            print(f"{form} {name}: {json.dumps(cut[form + '_' + name])}", flush=True)
    return cut


def next_row_forms(dev) -> dict:
    """The kernels the ranking takes next, each a call at its main path's
    shapes: K13 (the
    reference-row scatter of 8 rows of 1080p), K14r (the qp plane over
    those rows with the lookahead frame), K14a (the qp plane with and
    without it), K16b (a 1080p desktop's histograms), K9 (1919x1079 RGB to
    padded I420), 9b (K9's frame axis, four 1080p frames), 13s (the
    forced-skip gate of every other MB row of a 1080p P frame), K17p (the
    loops' perturbation of a 1080p frame) and K17c (the loops' one-thread
    carry, row 17k)."""
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import aq, color, damage_mask, devloop
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device, h264_inter
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
    from docker_nvidia_glx_desktop_tpu_torch.ops import quant

    qp, g = PAIRS_QP, gop_frames(4, seed=2)
    desk, moving = pair_planes(g[0]), pair_planes(g[1])
    rows8 = torch.arange(20, 28, dtype=torch.int32, device=dev)
    lv = h264_device.encode_intra_frame_yuv(*desk, qp)
    ref = (lv["recon_y"], lv["recon_cb"], lv["recon_cr"])
    o8 = h264_inter.encode_p_frame_rows(*moving, *ref, rows8, qp)
    rec = (o8["recon_y"], o8["recon_cb"], o8["recon_cr"])
    out = h264_inter.encode_p_frame(*moving, *ref, qp)
    keep = torch.arange(H_PAD // 16, device=dev) % 2 == 0
    lq, cq = quant.jpeg_quality_tables(85)
    levels = jd.jpeg_transform(torch.from_numpy(mjpeg_frames(2)[1]).to(dev)[None],
                               lq, cq, H_PAD, W)
    odd = torch.from_numpy(np.ascontiguousarray(g[2][:ODD_H, :ODD_W])).to(dev)
    rgbs = torch.from_numpy(np.stack(g)).to(dev)
    i_dev = torch.zeros(1, dtype=torch.int32, device=dev)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    out_p = tuple(torch.empty_like(p) for p in desk)
    forms = {"k13": lambda: damage_mask.scatter_rows(*ref, *rec, rows8),
             "k14r": lambda: aq.qp_plane(moving[0], qp, desk[0], rows=rows8),
             "k14a": lambda: aq.qp_plane(moving[0], qp),
             "k14a_next": lambda: aq.qp_plane(moving[0], qp, desk[0]),
             "k16b": lambda: jd.jpeg_analyze(*levels),
             "k9": lambda: color.rgb_to_yuv420(odd, H_PAD, W),
             "k9b": lambda: color.rgb_to_yuv420_frames(rgbs, H_PAD, W),
             "k13s": lambda: damage_mask.force_skip_rows(out, keep, *ref),
             "k17p": lambda: devloop.perturb(*desk, i_dev, out=out_p),
             "k17k": lambda: devloop.tick(acc, desk[0], 0, i_dev)}
    return forms


def next_rows(dev, names=None) -> dict:
    """Each of ``next_row_forms`` (those in ``names`` where given): the
    profiler's device ms by kernel (``kernel_split``), one replay of a
    graph of one call, one of 32 in a graph and an eager call."""
    res = {}
    for name, fn in next_row_forms(dev).items():
        if names is not None and name not in names:
            continue
        split = kernel_split(fn)
        res[name] = {"device_ms": float(sum(split.values())) if split else -1.0,
                     "split": split, "graph_ms": graph_ms(fn, reps=20),
                     "each_ms": graph_each_ms(fn), "ms": cuda_ms(fn, reps=20)}
        print(f"next row {name}: {json.dumps(res[name])}", flush=True)
    return res


def k16a14d_split() -> int:
    """``python3 chip_smoke.py k16a14d-split``: the ``-Xptxas -v`` lines of
    K16a's and K14d's kernels; each of their forms (``k16a14d_form_times``)
    by device time beside its CUDA-event, replayed and one-of-32 ms and its
    bound; K16a's stages cut out of copies of jpeg.cu (``k16a_cuts``);
    K14d's loads in flight (``sse_cuts``); the next kernels of the ranking
    by device time (``next_rows``).  Writes
    ``chiprun_out/k16a14d_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src, marks in (("jpeg", ("transform",)), ("aq", ("sse",))):
        res["ptxas"][src] = kernel_lines(ptxas_lines(logs.get(src, "")), marks)
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    dev = torch.device("cuda")
    x = k16a14d_inputs(dev)
    for name, r in k16a14d_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = k16a_cuts(x)
    res["sse_cut_ms"] = sse_cuts(x)
    res["next_rows"] = next_rows(dev)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k16a14d_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


# K16b's and K14a's stages cut out of, or sizes changed in, copies of the
# redesigned sources (timing only: a cut leaves the outputs wrong)
K16B_MARK = "HIST_CTAS_PER_SM"
K16B_VARIANTS = {
    "base": [],
    "loads_only": [("    hist_count(cur, k, h, m, mps, lane);\n",
                    "    for (int c = 0; c < 6; ++c) k.dcl += cur.a[c] ^ cur.b[c];\n")],
    "no_syms": [("    if ((mk.lo >> lane) & 1) {", "    if (false) {"),
                ("    if (v.b[c]) {", "    if (false) {")],
    "no_flush": [("    if (h[i]) atomicAdd(acc + i, h[i]);", "    if (h[i] == 12345) acc[i] = 0;")],
    "ctas2": [("HIST_CTAS_PER_SM = 4;", "HIST_CTAS_PER_SM = 2;")],
    "ctas5": [("HIST_CTAS_PER_SM = 4;", "HIST_CTAS_PER_SM = 5;")],
    "streaming": [("    v.a[c] = __ldg(py + 64 * c);\n    v.b[c] = __ldg(py + 64 * c + 32);",
                   "    v.a[c] = __ldcs(py + 64 * c);\n    v.b[c] = __ldcs(py + 64 * c + 32);")],
}
K14A_MARK = "QP_WARPS"
K14A_VARIANTS = {
    "base": [],
    "warps4": [("QP_WARPS = 8,", "QP_WARPS = 4,")],
    "warps16": [("QP_WARPS = 8,", "QP_WARPS = 16,")],
    "no_compare": [("k < min(n_steps, MAX_STEPS) && act_h >= __ldg(steps + k)",
                    "k == 0 && act_h > 0")],
}


def k16b14a_cuts(x: dict) -> dict:
    """Each of ``K16B_VARIANTS`` on ``K16B_FORMS`` and ``K14A_VARIANTS`` on
    ``K14A_FORMS`` (where the sources hold the redesign): device ms, one
    replay of a graph of one call, and whether the output equals the
    source's (0 where a cut leaves it wrong by design)."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, aq
    from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd

    cut = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for src, mark, variants, forms in (("jpeg", K16B_MARK, K16B_VARIANTS, K16B_FORMS),
                                       ("aq", K14A_MARK, K14A_VARIANTS, K14A_FORMS)):
        if mark not in open(os.path.join(_cuda.CSRC, f"{src}.cu")).read():
            continue
        libs = build_variants(src, variants)
        for form in forms:
            t = x[form]
            want = k16b14a_call(form, t)()
            out = torch.empty_like(want)
            for name, lib in libs.items():
                if src == "jpeg":
                    fn = lib["jpeg_analyze_launch"]
                    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                    args = ([a.data_ptr() for a in t[:3]] + [out.data_ptr(), t[1].shape[0],
                                                              t[1].shape[1], t[3]])
                else:
                    y, nxt, rows = t
                    first, steps, st = aq._steps_on(y.device)
                    fn = lib["qp_plane_launch"]
                    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
                    ptr = lambda a: None if a is None else a.data_ptr()
                    args = ([ptr(y), ptr(nxt), ptr(rows), None, st.data_ptr(), out.data_ptr(),
                             y.shape[0] // 16, y.shape[1] // 16, out.shape[0], PAIRS_QP,
                             first, len(steps), aq.LOOKAHEAD_BIAS])
                fn.restype = ctypes.c_int

                def call(fn=fn, args=args, name=name):
                    err = fn(*args, stream())
                    check(err == 0, f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                split = kernel_split(call)
                key = f"{form}_{name}"
                cut[key] = {"graph_ms": graph_ms(call, reps=20),
                            "device_ms": sum(split.values()),
                            "equal": float(torch.equal(out, want))}
                print(f"{form} {name}: {json.dumps(cut[key])}", flush=True)
    return cut


def k16b14a_split() -> int:
    """``python3 chip_smoke.py k16b14a-split``: the ``-Xptxas -v`` lines of
    K16b's and K14a's kernels; each of their forms (``k16b14a_form_times``)
    by device time beside its CUDA-event, replayed and one-of-32 ms and its
    bound; their stages cut out of copies of the sources
    (``k16b14a_cuts``); the next kernels of the ranking by device time
    (``next_rows``: 13s, K13, 9b, K9).  Writes
    ``chiprun_out/k16b14a_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src, marks in (("jpeg", ("analyze",)), ("aq", ("qp_plane",))):
        res["ptxas"][src] = kernel_lines(ptxas_lines(logs.get(src, "")), marks)
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    dev = torch.device("cuda")
    x = k16b14a_inputs(dev)
    for name, r in k16b14a_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = k16b14a_cuts(x)
    res["next_rows"] = next_rows(dev, ("k13s", "k13", "k9b", "k9"))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k16b14a_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


# 13s's and K13's sizes changed in copies of the redesigned sources
# (timing only: a cut leaves the outputs wrong)
K13S_MARK = "SKIP_CHUNK"
K13S_VARIANTS = {
    "base": [],
    "u1": [("SKIP_U = 2;", "SKIP_U = 1;")],
    "u4": [("SKIP_U = 2;", "SKIP_U = 4;")],
    "nt128": [("SKIP_NT = 256;", "SKIP_NT = 128;")],
    "stream_stores": [("rowcopy.cuh", "    *reinterpret_cast<uint4*>(w.a) = v;\n",
                       "    __stcs(reinterpret_cast<uint4*>(w.a), v);\n")],
}
K13_MARK = "copy_line"
K13_VARIANTS = {
    "base": [],
    "line_u2": [("LINE_U = 4;", "LINE_U = 2;")],
    "line_u8": [("LINE_U = 4;", "LINE_U = 8;")],
    "nt128": [("SCATTER_NT = 256;", "SCATTER_NT = 128;")],
    "stream_stores": [("rowcopy.cuh", "    *reinterpret_cast<uint4*>(w.a) = v;\n",
                       "    __stcs(reinterpret_cast<uint4*>(w.a), v);\n")],
}


def k13s13_cuts(x: dict) -> dict:
    """Each of ``K13S_VARIANTS`` on ``K13S_FORMS`` and ``K13_VARIANTS`` on
    ``K13_FORMS`` (where the sources hold the redesign): device ms, one of
    32 in a graph, and whether the output equals the wrapper's (0 where a
    cut leaves it wrong by design)."""
    import ctypes

    import torch

    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda, damage_mask

    cut = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda a: None if a is None else a.data_ptr()
    for src, mark, variants, forms in (("spatial", K13S_MARK, K13S_VARIANTS, K13S_FORMS),
                                       ("damage", K13_MARK, K13_VARIANTS, K13_FORMS)):
        if mark not in open(os.path.join(_cuda.CSRC, f"{src}.cu")).read():
            continue
        libs = build_variants(src, variants)
        for form in forms:
            t = x[form]
            if src == "spatial":
                out0, keep, refs = t
                gated = damage_mask.force_skip_rows({k: v.clone() for k, v in out0.items()},
                                                    keep, *refs)
                out = {k: v.clone() for k, v in out0.items()}
                args = ([ptr(out.get(k)) for k in damage_mask._SKIP_ZERO]
                        + [ptr(out[k]) for k in damage_mask._SKIP_RECON]
                        + [ptr(r) for r in refs] + [keep.data_ptr(), keep.numel(),
                                                    out["mv"].shape[1]])
                entry, nptr = "force_skip_launch", 16
                pairs_ = [(out[k], gated[k], out0[k]) for k in gated]
            else:
                refs, rec, rows = t
                want = damage_mask.scatter_rows(*refs, *rec, rows)
                outs = [torch.empty_like(p) for p in refs]
                args = ([ptr(a) for a in (*refs, *rec, rows, *outs)]
                        + [refs[0].shape[0] // 16, rows.numel(), refs[0].shape[1]])
                entry, nptr = "scatter_rows_launch", 10
                pairs_ = [(o, w, torch.zeros_like(o)) for o, w in zip(outs, want)]
            for name, lib in libs.items():
                for o, _, first in pairs_:             # the inputs as they came
                    o.copy_(first)
                fn = lib[entry]
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * (len(args) - nptr) \
                    + [ctypes.c_void_p]

                def call(fn=fn, args=args, name=name):
                    err = fn(*args, stream())
                    check(err == 0, f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                equal = float(all(torch.equal(o, w) for o, w, _ in pairs_))
                split = kernel_split(call)
                key = f"{form}_{name}"
                cut[key] = {"each_ms": graph_each_ms(call), "device_ms": sum(split.values()),
                            "equal": equal}
                print(f"{form} {name}: {json.dumps(cut[key])}", flush=True)
    return cut


def k13s13_split() -> int:
    """``python3 chip_smoke.py k13s13-split``: the ``-Xptxas -v`` lines of
    13s's and K13's kernels; each of their forms (``k13s13_form_times``)
    by device time beside its CUDA-event, replayed and one-of-32 ms, its
    bound and K13's ``index_copy``; their sizes changed in copies of the
    sources (``k13s13_cuts``); the next kernels of the ranking by device
    time (``next_rows``: K9, 9b, 17p, 17k).  Writes
    ``chiprun_out/k13s13_split.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    logs = _cuda.build(verbose=True)
    res = {"card": smi, "ptxas": {}}
    for src, marks in (("spatial", ("force_skip",)), ("damage", ("scatter",))):
        res["ptxas"][src] = kernel_lines(ptxas_lines(logs.get(src, "")), marks)
        for ln in res["ptxas"][src]:
            print(f"ptxas {src}: {ln}", flush=True)
    dev = torch.device("cuda")
    x = k13s13_inputs(dev)
    for name, r in k13s13_form_times(x).items():
        res[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    res["cut_ms"] = k13s13_cuts(x)
    res["next_rows"] = next_rows(dev, ("k9", "k9b", "k17p", "k17k"))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k13s13_split.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


def phase_alone(key: str, phase, srcs) -> int:
    """``python3 chip_smoke.py modes`` / ``tune-mask``: the build (with the
    ptxas lines of ``srcs``), then the one phase alone; writes
    ``chiprun_out/<key>.json``."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib
    from docker_nvidia_glx_desktop_tpu_torch.ops import _cuda

    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build(verbose=True)
    native_lib.get_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src in srcs:
        for ln in ptxas_lines(logs.get(src, "")):
            print(f"ptxas {src}: {ln}")
    report = {}
    rows = phase(report)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{key}.json"), "w") as f:
        json.dump({"card": smi, key: report[key], "kernels": rows}, f,
                  indent=1, default=float)
    print(json.dumps({"kernels": rows}))
    print(smi)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    try:
        if argv[:1] == ["modes"]:
            return phase_alone("modes", modes_phase, ("intra", "inter"))
        if argv[:1] == ["tune-mask"]:
            return phase_alone("tune_mask", tune_mask_phase, ("inter", "aq"))
        if argv[:1] == ["k1k6-pairs"]:
            return pairs(argv[1:], "k1k6")
        if argv[:1] == ["pairs"]:
            return pairs(argv[1:])
        if argv[:1] == ["k1-variants"]:
            return k1_variants()
        if argv[:1] == ["k5k4-split"]:
            return k5k4_split()
        if argv[:1] == ["k2k8-split"]:
            return k2k8_split()
        if argv[:1] == ["k2k8"]:
            return phase_alone("k2k8", k2k8_phase, ("cavlc", "deblock"))
        if argv[:1] == ["k3k7-split"]:
            return k3k7_split()
        if argv[:1] == ["k3k7"]:
            return phase_alone("k3k7", k3k7_phase, ("pack",))
        if argv[:1] == ["k11k16-split"]:
            return k11k16_split()
        if argv[:1] == ["k11k16"]:
            return phase_alone("k11k16", k11k16_phase, ("jpeg", "cabac"))
        if argv[:1] == ["k10k11i-split"]:
            return k10k11i_split()
        if argv[:1] == ["k10k11i"]:
            return phase_alone("k10k11i", k10k11i_phase, ("levelpack", "cabac"))
        if argv[:1] == ["i16halo-split"]:
            return i16halo_split()
        if argv[:1] == ["i16halo"]:
            return phase_alone("i16halo", i16halo_phase, ("inter", "spatial"))
        if argv[:1] == ["k16a14d-split"]:
            return k16a14d_split()
        if argv[:1] == ["k16a14d"]:
            return phase_alone("k16a14d", k16a14d_phase, ("jpeg", "aq"))
        if argv[:1] == ["k16b14a-split"]:
            return k16b14a_split()
        if argv[:1] == ["k16b14a"]:
            return phase_alone("k16b14a", k16b14a_phase, ("jpeg", "aq"))
        if argv[:1] == ["k13s13-split"]:
            return k13s13_split()
        if argv[:1] == ["k13s13"]:
            return phase_alone("k13s13", k13s13_phase, ("spatial", "damage"))
        if argv[:1] == ["k5k4"]:
            return phase_alone("k5k4", k5k4_phase, ("inter", "content"))
        return run()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
