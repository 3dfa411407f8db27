"""H.264 encoder: device-entropy CAVLC or CABAC, all-intra (``gop ==
1``) or the GOP path (an IDR, then P frames, with the in-loop
deblocking filter).

Per frame one submit launches the device stage on the card:

- colour: with ``host_color`` (the serving default of ``make_encoder``)
  cv2 converts RGB to padded BT.601 YUV 4:2:0 on the host and the planes
  are uploaded; otherwise, and where cv2 is absent or the geometry is
  odd, the RGB frame is uploaded and converted on the card (K9,
  ``ops/color``);
- an IDR runs the intra core (K1, ``ops/h264_device``); a P frame the P
  core (K5, ``ops/h264_inter``);
- CAVLC: the slot coders and bit packers (K2/K3, K6/K7) write the slice
  bits on the card;
- CABAC (``entropy="cabac"``, Main profile): the levels are compacted on
  the card (K10, ``ops/level_pack``; ``ENCODER_CABAC_BINARIZE=host``,
  the default) or binarized into (bin, ctxIdx) records there (K11,
  ``ops/cabac_binarize``; ``=device``), and the port's native C++ coder
  (``native/cabac.cpp``) or arithmetic engine codes the slices on the
  host at collect;
- in GOP mode the recon, loop-filtered (K8, ``ops/h264_deblock``) when
  ``deblock`` is on, becomes the next frame's reference at submit time,
  so frame N+1 may be submitted before frame N is collected;
- every frame runs the content stats (K4, ``ops/content_stats``).

With ``superstep_chunk`` (``ENCODER_SUPERSTEP_CHUNK``, 2-6) P frames
are staged on the host and every K of them run as one replay of a
captured CUDA graph (``ops/devloop``: K9 over the chunk under rgb
ingest, then K5-K8 or K5/K11p/K8 per frame, the reference chained
through), their stats as one K4c launch; a partial chunk (an IDR due,
a drain) goes through the per-frame path, which gives the same bytes.
With ``damage_mask`` (``DNGD_DAMAGE_MASK``, device CAVLC with host
colour) a P frame's device work covers its damaged MB rows only
(``ops/damage_mask``: K5r at the encoder's kernel tier, with the qp plane
K14r and the I16-in-P passes over the rows where the tier has them,
K6-K8 on the compacted rows, the row scatter K13), per frame and inside
the chunk; the other rows go out as cached all-skip slices.

``spatial_shards`` (``ENCODER_SPATIAL_SHARDS``) splits one frame's MB
rows over the shard devices ``spatial_devices`` (every CUDA device by
default, ``[device]`` on the CPU; a list may repeat one device), resolved
as the reference resolves it: with one device the knob serves unsharded.
Sharded, each frame runs the spatial steps of ``parallel/batch`` (rows
15f-15h: per shard flats or record streams, the halo-padded P core, the
forced-skip row gate under the damage mask), and the access units equal
the unsharded ones byte for byte.

Collect pulls a bucketed prefix of the transport and builds the Annex-B
access unit.  A frame whose bits overflow the device stage's static caps
is coded on the host from its dense levels: a CAVLC IDR by running the
intra core again on the same planes, a CAVLC P frame and every CABAC
frame from the level tensors its device stage produced.  The bytes equal
the reference encoder's (``docker_nvidia_glx_desktop_tpu/models/
h264.py``) frame by frame.

``tune`` (``ENCODER_TUNE``) "hq" selects the reference's kernel tiers:
with the loop filter on (the config surface's ``make_encoder``) the
"hq_noaq" tier, Lagrangian mode decisions at the slice qp; with it off
the full "hq" tier, which adds the per-MB qp plane (K14, ``ops/aq``) with
the ring's 1-frame lookahead, the mb_qp_delta chain, the I16-in-P escape
(device CAVLC), the keyframe qp bias ``I_QP_BIAS`` and the rate model's
mean-coded-qp normalisation.  Full-tier CABAC takes the host transport
(K10 plus the qp plane), as in the reference.

``intra_modes`` (``ENCODER_INTRA_MODES``) picks K1's mode set: "auto",
"full" (all nine I4 modes), "i16" or "dc".  ``entropy="native"`` and
``"python"`` code CAVLC on the host, as the reference does (encode
returns when the frame is coded, no pipelining): an IDR is the intra
core on the device-converted frame, then the C coder
(``native/cavlc.cpp``) where the reference uses it (I16 DC at the slice
qp, no qp plane, no loop filter; ``native`` pins ``intra_modes="dc"``
and the loop filter off) and the Python coder otherwise; a P frame is
the P core, then the Python coder.  ``mode="pcm"`` (the reference's
default) sends every frame as I_PCM macroblocks of the device-converted
planes.

``ENCODER_SPATIAL_SHARDS=auto`` over several devices and shards on
distinct cards raise NotImplementedError naming their ROADMAP items;
nothing falls back quietly.
"""

from __future__ import annotations

import collections
import logging
import os
import time

import numpy as np
import torch

from ..bitstream import h264 as syn
from ..bitstream import h264_cabac, h264_entropy
from ..obs import content as obsc
from ..ops import (cabac_binarize, cavlc_device, cavlc_p_device, color,
                   content_stats, devloop, h264_deblock, h264_device,
                   h264_inter, level_pack)
from ..ops import damage_mask as dmg
from ..utils.hostcolor import rgb_to_yuv420_host
from ..utils.mathutil import round_up
from .base import EncodedFrame, Encoder


log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises (no quiet CPU
    fallback).  Pass ``"cpu"`` to run the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the encoder's plain PyTorch path")
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA encoder yet "
        f"(ROADMAP queue 1 item {item})")


def spatial_auto_shards(width: int, height: int, fps: float = 60.0,
                        n_devices: int = None) -> int:
    """Devices ONE session of this geometry should spread across
    (``ENCODER_SPATIAL_SHARDS=auto``).  With one device the answer is 1,
    as the reference's; over more devices it needs the reference's fleet
    capacity model, which is not ported (its prior is the TPU's)."""
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    if int(n_devices) <= 1:
        return 1
    raise _not_ported("ENCODER_SPATIAL_SHARDS=auto over several devices "
                      "(the fleet capacity model)", "14")


class RateController:
    """Leaky-bucket (VBV-style) qp control toward ENCODER_BITRATE_KBPS.

    The virtual buffer drains at the target rate and fills with each
    coded frame; qp is chosen BEFORE encoding from the buffer level plus
    a per-frame-type size prediction (intra frames run ~3-6x a P frame:
    exactly the burst a pure average-tracking controller lets through,
    flooding the client at every GOP boundary or scene cut).

    qp still moves on a quantized ladder within [base-6, base+18] so the
    jit cache sees a small bounded set of distinct qp values (each
    distinct qp is one compile of the static-qp device stage).  Size
    prediction uses per-type EMAs normalized to base qp via the standard
    +6-qp-halves-bits model, so a scene cut's oversized frame raises the
    NEXT frames' qp immediately, and the pre-encode VBV check raises qp
    for a frame the prediction says would overflow the buffer.
    """

    STEPS = (-6, -4, -2, 0, 2, 4, 6, 8, 10, 12, 14, 16, 18)
    TARGET_FILL = 0.5           # steer the bucket toward half full
    DRAIN_FRAMES = 30           # spread fill-error correction over ~0.5-1 s
    MAX_INFLIGHT = 8            # > any pipeline depth; deeper = orphans

    def __init__(self, base_qp: int, bitrate_kbps: int, fps: float,
                 vbv_s: float = 0.75):
        import collections

        self.base_qp = base_qp
        self.target_bits = bitrate_kbps * 1000.0 / max(fps, 1.0)
        self.vbv_cap = bitrate_kbps * 1000.0 * vbv_s
        self.level = 0.0                        # bucket fill (bits)
        self._ema = {True: None, False: None}   # per-type, base-qp units
        self._step_idx = self.STEPS.index(0)
        self._avg = None                        # long-term bits/frame EMA
        # (keyframe, step_idx) per in-flight frame: the pipelined serving
        # loop calls qp_for(N+1) before update(N) arrives from collect
        self._pending = collections.deque()
        # damage-driven encode (ops/damage_mask): rolling damage
        # fraction fed by the gating plan so a calm->spike transition
        # can pre-empt the burst (see note_damage)
        self._damage_ema = None

    def note_damage(self, frac: float, spike: float = 0.85) -> None:
        """Damage-plane consumer: after a long-calm stretch (the masked
        encoder has been emitting near-empty frames, so the per-type
        size EMAs and the VBV level have drifted toward 'P frames are
        free'), a full-frame damage spike lands an intra-sized P burst
        BEFORE update() can react.  Seeing the spike at SUBMIT time —
        the damage grid is computed host-side before qp_for — lets the
        controller take one ladder step from the NEXT frame on (a
        pipeline-depth's worth of frames earlier than the collect-side
        update loop would).  Rises jump the EMA
        immediately (spike detection must not lag); decays are slow
        (spike-recovery headroom, mirroring the capacity charge)."""
        frac = min(max(float(frac), 0.0), 1.0)
        prev = self._damage_ema
        calm = prev is not None and prev < spike / 4.0
        self._damage_ema = (frac if prev is None or frac >= prev
                            else 0.9 * prev + 0.1 * frac)
        if calm and frac >= spike \
                and self._step_idx < len(self.STEPS) - 1:
            self._step_idx += 1

    def _eff_step(self, step_idx: int) -> int:
        """The qp offset ACTUALLY applied at this ladder step after the
        [0, 51] clamp — size scaling must use the coded qp, not the
        nominal ladder value (base qp near either end otherwise skews the
        EMAs by up to the full clamp distance)."""
        return min(51, max(0, self.base_qp + self.STEPS[step_idx])) \
            - self.base_qp

    def _norm(self, bits: float, qp: float) -> float:
        """Measured bits -> equivalent at base_qp (+6 qp halves bits)."""
        return bits * 2.0 ** ((qp - self.base_qp) / 6.0)

    def _predict(self, keyframe: bool, step_idx: int) -> float:
        ema = self._ema[keyframe]
        if ema is None:
            # no sample yet: assume intra ~4x the per-frame budget
            ema = self.target_bits * (4.0 if keyframe else 1.0)
        return ema * 2.0 ** (-self._eff_step(step_idx) / 6.0)

    def qp_for(self, keyframe: bool) -> int:
        """qp for the NEXT frame; remembers the type for update()."""
        idx = self._step_idx
        # pre-encode VBV guard: this frame's allowance is the per-frame
        # budget plus a share of the bucket's distance from its target
        # fill — an over-full bucket (a scene cut just landed) DEMANDS
        # under-budget frames until it drains, not merely on-budget ones.
        allowed = max(
            self.target_bits
            + (self.TARGET_FILL * self.vbv_cap - self.level)
            / self.DRAIN_FRAMES,
            0.1 * self.target_bits)
        while (idx < len(self.STEPS) - 1
               and self._predict(keyframe, idx) > allowed):
            idx += 1
        self._pending.append((keyframe, idx))
        # a failed encode never reaches update(), which is what pops; an
        # entry deeper than any possible pipeline is an orphan — resync so
        # one swallowed exception can't shift keyframe/P attribution of
        # the size EMAs for the rest of the session
        while len(self._pending) > self.MAX_INFLIGHT:
            self._pending.popleft()
        return min(51, max(0, self.base_qp + self.STEPS[idx]))

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def mark(self) -> int:
        """Snapshot the in-flight reservation depth before an encode
        attempt; pass to :meth:`rollback_to` if the attempt raises."""
        return len(self._pending)

    def rollback_to(self, n: int) -> None:
        """Forget reservations made since :meth:`mark` returned ``n`` —
        the failed attempt never reaches update(), and an orphaned entry
        would shift keyframe/P attribution of the size EMAs for the rest
        of the session."""
        while len(self._pending) > n:
            self._pending.pop()

    def repeat_last_reservation(self) -> None:
        """Duplicate the newest in-flight reservation — the super-step
        ring stages a whole GOP-chunk at ONE qp (qp is a static jit arg,
        so per-frame qp movement inside a chunk would recompile), and
        each staged frame still needs its own reservation so the
        per-frame update() pops stay aligned with keyframe/P
        attribution."""
        if self._pending:
            self._pending.append(self._pending[-1])
            while len(self._pending) > self.MAX_INFLIGHT:
                self._pending.popleft()

    def drop_oldest_pending(self) -> None:
        """Forget the OLDEST in-flight reservation after a collect-side
        failure — collects complete in FIFO order, so the frame that just
        failed is the deque head.  (Submit-side failures roll back via
        mark()/rollback_to instead: they must not pop when qp_for was
        never reached.)"""
        if self._pending:
            self._pending.popleft()

    @property
    def qp(self) -> int:
        return min(51, max(0, self.base_qp + self.STEPS[self._step_idx]))

    def update(self, frame_bits: int, mean_qp: float = None) -> None:
        """Fold a coded frame into the model.  ``mean_qp`` (tune=hq):
        the frame's MEAN CODED qp — adaptive quantization moves the
        coded plane away from the nominal ladder value, and the
        +6-qp-halves-bits normalization must use what was actually
        coded or the per-type EMAs skew by the AQ offset."""
        import math

        kf, used_idx = (self._pending.popleft() if self._pending
                        else (True, self._step_idx))
        used_qp = (float(mean_qp) if mean_qp is not None
                   else self.base_qp + self._eff_step(used_idx))
        norm = self._norm(frame_bits, used_qp)
        prev = self._ema[kf]
        self._ema[kf] = norm if prev is None else 0.7 * prev + 0.3 * norm
        self.level = max(0.0, self.level + frame_bits - self.target_bits)

        # long-term trend: hold the MIX (GOP-weighted average) on budget
        self._avg = (frame_bits if self._avg is None
                     else 0.85 * self._avg + 0.15 * frame_bits)
        err = math.log2(max(self._avg, 1.0) / max(self.target_bits, 1.0))
        if err > 0.25 and self._step_idx < len(self.STEPS) - 1:
            self._step_idx += 1                 # over budget -> coarser
        elif err < -0.25 and self._step_idx > 0:
            self._step_idx -= 1                 # under budget -> finer


def _pinned_prefetch(t: torch.Tensor):
    """Start the device->host copy of a pull prefix at submit time; the
    collect then waits on its event instead of a blocking pull."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _wait(prefetched) -> np.ndarray:
    """The host array of a :func:`_pinned_prefetch`, once it landed."""
    host, ev = prefetched
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class _Ring:
    """A super-step chunk being staged, then its dispatched outputs.
    ``frames`` the staged host frames (until dispatch), ``fns`` their
    frame_nums, ``plans`` their damage worklists (masked chunks), ``res``
    the step's :class:`devloop.ChunkOut`, ``prefix`` each slot's pull,
    ``pf`` the per-frame tokens of a flushed ring.  ``released`` once
    every slot was collected: the step may then overwrite the outputs."""

    def __init__(self, kind: str, ingest: str, qp: int, plans):
        self.kind, self.ingest, self.qp = kind, ingest, qp
        self.frames, self.fns, self.plans = [], [], plans
        self.res = self.prefix = self.pf = self.dmg = None
        self.content = self.content_np = self.content_pf = None
        self.chunk_id = None         # set at dispatch (journey identity)
        self.error = False
        self.collected = 0
        self.released = False


class H264Encoder(Encoder):
    codec = "h264"

    def __init__(self, width: int, height: int, qp: int = 26,
                 mode: str = "pcm", entropy: str = "device",
                 keep_recon: bool = False, host_color: bool = False,
                 gop: int = 1, bitrate_kbps: int = 0, fps: float = 60.0,
                 deblock: bool = False, intra_modes: str = None,
                 superstep_chunk: int = None, spatial_shards=None,
                 tune: str = None, damage_mask: bool = None, device=None,
                 spatial_devices=None):
        """Same arguments as the reference encoder, plus ``device``
        (``None`` = the card) and ``spatial_devices``, the devices
        ``spatial_shards`` counts and shards over (every CUDA device for a
        card encoder, ``[device]`` on the CPU; a list may repeat one
        device, the counterpart of the reference's forced host-platform
        devices).  ``mode`` "pcm" (the default, as the reference's) or
        "cavlc"; ``entropy`` "device", "cabac", "native" or "python";
        ``intra_modes`` "auto", "full", "i16" or "dc": see the module
        docstring for what raises."""
        super().__init__(width, height)
        if mode not in ("pcm", "cavlc"):
            raise NotImplementedError(f"h264 mode {mode!r} not built yet")
        if entropy not in ("device", "native", "python", "cabac"):
            raise ValueError(f"unknown entropy {entropy!r}")
        if mode == "pcm" and entropy == "cabac":
            # I_PCM macroblocks are plain bits: a cabac=1 PPS would make
            # the stream undecodable
            raise ValueError("mode='pcm' does not support entropy='cabac'")
        if intra_modes not in (None,) + h264_device.I16_MODES:
            raise ValueError(f"unknown intra_modes {intra_modes!r}")
        if tune is None:
            tune = os.environ.get("ENCODER_TUNE", "off") or "off"
        if superstep_chunk is None:
            superstep_chunk = int(
                os.environ.get("ENCODER_SUPERSTEP_CHUNK", "0") or 0)
        if damage_mask is None:
            damage_mask = dmg.enabled()
        # the native C coder has no deblocking-idc plumbing
        self.deblock = bool(deblock) and entropy != "native"
        # the tuning tier: "hq" runs the kernel tier "hq_noaq" (lambda
        # decisions at the slice qp) under the loop filter, whose
        # thresholds are per slice qp; "hq_noaq" is also a tier of its
        # own; anything else warns and serves "off"
        if tune not in ("off", "hq", "hq_noaq"):
            log.warning("unknown ENCODER_TUNE %r: serving tune=off", tune)
            tune = "off"
        self.tune = tune
        if tune == "hq" and self.deblock:
            log.warning(
                "ENCODER_TUNE=hq with deblock on: per-MB adaptive "
                "quantization is disabled (lambda mode decisions stay "
                "active) — the loop-filter thresholds are per-slice-qp "
                "in v1")
            self._ktune = "hq_noaq"
        else:
            self._ktune = tune
        # I16-in-P: device or Python CAVLC with the loop filter off
        self._p_intra = (self._ktune != "off" and not self.deblock
                         and mode == "cavlc"
                         and entropy in ("device", "python"))
        # the native C coder has no per-MB mode plumbing: it codes I16 DC
        # pictures only, so "auto" (the config default) pins "dc" there
        if entropy == "native" and intra_modes in (None, "auto"):
            from ..native import lib as native_lib
            self.i16_modes = "dc" if native_lib.has_cavlc() else "auto"
        else:
            self.i16_modes = intra_modes or "auto"
        self._mean_qp_pending = None     # the frame's mean coded qp (hq)
        self.device = resolve_device(device)
        self.qp = qp
        self.mode = mode
        self.entropy = entropy
        self.keep_recon = keep_recon
        self.host_color = bool(host_color)
        self.gop = max(int(gop), 1)
        self._deblock_idc = 2 if self.deblock else 1
        self.last_recon = None
        self.last_mv = None
        self.pad_w = round_up(width, 16)
        self.pad_h = round_up(height, 16)
        self.mb_w = self.pad_w // 16
        self.mb_h = self.pad_h // 16
        cabac = entropy == "cabac"
        if cabac:
            # fail at construction, not frame by frame in the serving
            # loop: the native coder must build (the reference checks its
            # CABAC tables here for the same reason)
            from ..native import lib as native_lib
            native_lib.get_lib()
        self._sps = syn.sps_rbsp(width, height,
                                 profile="main" if cabac else "baseline")
        self._pps = syn.pps_rbsp(init_qp=qp, cabac=cabac)
        self._hdr_slots_cache = {}
        # GOP / reference state: the reference planes live on the device
        # and advance at submit time
        self._ref = None
        self._frame_num = 0
        self._gop_pos = 0
        self._force_idr = False
        self._idr_count = 0
        self._rate = (RateController(qp, bitrate_kbps, fps)
                      if bitrate_kbps > 0 else None)
        self.degrade_qp_offset = 0
        # recent pull sizes -> decaying max: the pull prefix must cover
        # the largest recent frame, or a mispredict costs a second pull
        self._pull_hist = collections.deque(maxlen=8)
        self._p_pull_hist = collections.deque(maxlen=8)
        self._pull_guess = None
        self._p_pull_guess = None
        # the same for the four CABAC transports, in words
        self._cabac_dev_bin = None
        for kind in ("", "_bin", "_p", "_p_bin"):
            setattr(self, f"_cabac{kind}_pull_hist",
                    collections.deque(maxlen=8))
            setattr(self, f"_cabac{kind}_pull_guess", None)
        # content plane: previous ingest luma, per-frame stats handles
        # keyed by frame index, the last collected frame's stats dict
        self._content_prev_y = None
        self._content_last = None
        self._content_pending = {}
        self._content_meta = None
        self._content_n = 0
        # super-step ring (ops/devloop): P frames staged on the host, a
        # chunk of them dispatched as one graph replay; eligibility is
        # resolved at first use (_ring_chunk)
        self.superstep_chunk = int(superstep_chunk)
        self._ring = None
        self._ring_chunk_cached = None
        self._chunk_hdr_cache = {}
        self._chunk_steps = {}
        self._graphs = devloop.GraphBudget()
        # damage-driven encode (ops/damage_mask): the host luma chain the
        # gating grid diffs, advanced on every host-converted frame
        self.damage_mask = bool(damage_mask)
        self._damage_prev_y = None
        self._damage_cur_y = None
        self._damage_frac = None
        # dispatch accounting (obs/budget 'dispatch' stage) and the last
        # collected frame's chunk identity (obs/journey), popped by the
        # serving session once per frame
        self._disp_count = 0
        self._disp_gap_ms = 0.0
        self._disp_seen = 0
        self._disp_gap_seen = 0.0
        self._journey_meta = None
        self._chunk_seq = 0
        self._prewarm_ring = False
        # spatial shards (ENCODER_SPATIAL_SHARDS): one frame's MB rows over
        # the shard devices (parallel/batch rows 15f-15h); resolved here,
        # so that what is not ported raises at construction
        self.fps = float(fps)
        self._spatial_req = spatial_shards
        if spatial_devices is None:
            spatial_devices = ([torch.device("cuda", i) for i in
                                range(torch.cuda.device_count())]
                               if self.device.type == "cuda"
                               else [self.device])
        self.spatial_devices = [torch.device(d) for d in spatial_devices]
        self._spatial_nx_cached = None
        self._sp_steps = {}
        self._sp_hdr_cache = {}
        self._sp_mesh = None
        if self._spatial_nx > 1:
            from ..parallel import batch
            self._sp_mesh = batch.make_spatial_mesh(self._spatial_nx,
                                                    self.spatial_devices)
            if self._sp_mesh[0] != batch.indexed_device(self.device):
                raise ValueError(f"shard devices {self._sp_mesh} for an "
                                 f"encoder on {self.device}")

    def headers(self) -> bytes:
        return (syn.nal_unit(syn.NAL_SPS, self._sps)
                + syn.nal_unit(syn.NAL_PPS, self._pps))

    # -- dispatch accounting and journey identity ----------------------

    def _count_dispatch(self, t0: float) -> None:
        """One host -> device dispatch (a frame's launches, or a chunk's
        graph replay); ``t0`` the submit path's entry, so the summed gap
        is the submit-to-launch cost."""
        self._disp_count += 1
        self._disp_gap_ms += (time.perf_counter() - t0) * 1e3

    def pop_dispatch_sample(self):
        """(dispatches, gap_ms) since the last pop: the session calls this
        once per submitted frame and feeds the budget ledger.  A staged
        ring frame costs 0 dispatches; the frame that fills the chunk
        carries the chunk's one replay."""
        delta = self._disp_count - self._disp_seen
        gap = self._disp_gap_ms - self._disp_gap_seen
        self._disp_seen = self._disp_count
        self._disp_gap_seen = self._disp_gap_ms
        return delta, gap

    def pop_journey_meta(self):
        """Chunk identity of the last collected frame (set by
        encode_collect, cleared by this pop): ``chunk_id`` None for a
        per-frame dispatch (a flushed partial ring included), ``chunk_len``
        > 1 for a frame of a replayed chunk, ``shards`` the spatial shard
        count (1 unsharded)."""
        meta = self._journey_meta
        self._journey_meta = None
        return meta

    # -- spatial shards (parallel/batch rows 15f-15h) --------------------
    # One session's frame over the shard devices: per shard CAVLC flats
    # (joined NAL by NAL) or CABAC record streams (stitched row-wise), the
    # reference advancing at submit time as on the unsharded path.

    @property
    def _spatial_nx(self) -> int:
        """Resolved shard count (1 = off), the reference's rule: eligible
        are device CAVLC and CABAC with device binarization without
        ``keep_recon``; "0", "1" and "off" mean off; a value that does not
        parse warns and serves unsharded; with one device the count is 1
        (before ``auto`` would read the capacity model); otherwise
        ``feasible_spatial_shards`` clamps the request to the geometry."""
        n = self._spatial_nx_cached
        if n is None:
            n = 1
            req = self._spatial_req
            if req is None:
                req = os.environ.get("ENCODER_SPATIAL_SHARDS", "0")
            req = str(req).strip() or "0"
            eligible = (self.mode == "cavlc" and not self.keep_recon
                        and (self.entropy == "device"
                             or (self.entropy == "cabac"
                                 and self.cabac_device_binarize)))
            if eligible and req not in ("0", "1", "off"):
                ndev = len(self.spatial_devices)
                if req == "auto":
                    want = spatial_auto_shards(self.width, self.height,
                                               self.fps, n_devices=ndev)
                else:
                    try:
                        want = int(req)
                    except ValueError:
                        log.warning("ENCODER_SPATIAL_SHARDS=%r not "
                                    "understood; spatial sharding off", req)
                        want = 1
                if want > 1 and ndev > 1:
                    from ..parallel import batch
                    n = batch.feasible_spatial_shards(self.pad_h, want, ndev)
            self._spatial_nx_cached = n
        return n

    def _sp_rows_local(self) -> int:
        return self.mb_h // self._spatial_nx

    def _sp_step(self, kind: str, qp: int):
        """The spatial step of ``kind`` ("intra", "p", "p_masked") at
        ``qp``, built once."""
        key = (kind, qp)
        got = self._sp_steps.get(key)
        if got is None:
            from ..parallel import batch
            ent = "cabac" if self.entropy == "cabac" else "cavlc"
            if kind == "intra":
                got, _ = batch.h264_spatial_intra_step(
                    self._sp_mesh, self.pad_h, self.pad_w, qp, entropy=ent,
                    deblock=self.deblock, with_recon=self.gop > 1,
                    tune=self._ktune, i16_modes=self.i16_modes)
            else:
                got, _ = batch.h264_spatial_step(
                    self._sp_mesh, self.pad_h, self.pad_w, qp,
                    deblock=self.deblock, entropy=ent, tune=self._ktune,
                    p_intra=self._p_intra, masked=kind == "p_masked")
            self._sp_steps[key] = got
        return got

    def _sp_hdr_slots(self, idr: bool, frame_num: int, idr_pic_id: int,
                      qp_delta: int):
        """The frame's slice-header slots (R, 3) on the device, cached;
        the steps give each shard its rows'."""
        key = (idr, frame_num, idr_pic_id, qp_delta)
        got = self._sp_hdr_cache.get(key)
        if got is None:
            if idr:
                hv, hl = cavlc_device.slice_header_slots(
                    self.mb_h, self.mb_w, frame_num=0,
                    idr_pic_id=idr_pic_id, qp_delta=qp_delta,
                    deblocking_idc=self._deblock_idc)
                hv = hv.view(np.int32)
            else:
                hv, hl = self._p_hdr_slots_np(frame_num, qp_delta)
            got = (torch.from_numpy(np.ascontiguousarray(hv)).to(self.device),
                   torch.from_numpy(np.ascontiguousarray(hl)).to(self.device))
            self._sp_hdr_cache[key] = got
        return got

    def _sp_record_stitch(self, t0: float) -> None:
        """The host's shard assembly cost (obs/budget ``bitstream-stitch``
        stage, ``dngd_stitch_ms``)."""
        from ..obs.budget import LEDGER
        LEDGER.record_spatial(stitch_ms=(time.perf_counter() - t0) * 1e3)

    def _sp_prefix(self, buf, hdr: int, guess: int):
        """Start the pull of every shard's header and guessed payload."""
        return _pinned_prefetch(buf[:, :hdr + guess].contiguous())

    def _sp_submit_intra(self, rgb, idr_pic_id: int):
        qp = self._eff_qp()
        step = self._sp_step("intra", qp)
        y, cb, cr = self._planes_device(rgb)
        if self.entropy == "cabac":
            out = step(y, cb, cr)
            if self.gop > 1:
                buf, ry, rcb, rcr, lv = out
                self._ref = (ry, rcb, rcr)
            else:
                buf, lv = out
            # shard-local layouts: damage and activity only
            self._content_submit(y, frame_type="intra")
            hdrw = cabac_binarize.header_words(self._sp_rows_local())
            prefix = self._sp_prefix(buf, hdrw, self._cabac_bin_pull_guess
                                     or 8 * self._CABAC_PULL_WORDS)
            return ("sp_bin", "intra", qp, idr_pic_id, 0, buf, prefix, lv)
        hv, hl = self._sp_hdr_slots(True, 0, idr_pic_id, qp - self.qp)
        out = step(y, cb, cr, hv, hl)
        if self.gop > 1:
            flat, ry, rcb, rcr = out
            self._ref = (ry, rcb, rcr)
        else:
            flat = out
        self._content_submit(y, frame_type="intra")
        prefix = self._sp_prefix(flat, cavlc_device.META_WORDS * 4,
                                 self._pull_guess or 4 * self._PULL_BUCKET)
        return ("sp", "intra", qp, idr_pic_id, 0, flat, prefix, None)

    def _sp_submit_p(self, planes, qp: int, frame_num: int = None):
        frame_num = self._frame_num if frame_num is None else frame_num
        y, cb, cr = planes
        if self.entropy == "cabac":
            buf, ry, rcb, rcr, mv, lv = self._sp_step("p", qp)(
                y, cb, cr, *self._ref)
            self._ref = (ry, rcb, rcr)
            self._content_submit(y)
            hdrw = cabac_binarize.header_words(self._sp_rows_local())
            prefix = self._sp_prefix(buf, hdrw, self._cabac_p_bin_pull_guess
                                     or 4 * self._CABAC_PULL_WORDS)
            return ("sp_bin", "p", qp, 0, frame_num, buf, prefix, (lv, mv))
        hv, hl = self._sp_hdr_slots(False, frame_num, 0, qp - self.qp)
        keep = self._sp_damage_keep()
        if keep is not None:
            flat, ry, rcb, rcr, mv, lv = self._sp_step("p_masked", qp)(
                y, cb, cr, *self._ref, hv, hl, keep)
        else:
            flat, ry, rcb, rcr, mv, lv = self._sp_step("p", qp)(
                y, cb, cr, *self._ref, hv, hl)
        self._ref = (ry, rcb, rcr)
        self._content_submit(y)
        prefix = self._sp_prefix(flat, cavlc_device.META_WORDS * 4,
                                 self._p_pull_guess or 2 * self._PULL_BUCKET)
        return ("sp", "p", qp, 0, frame_num, flat, prefix, (lv, mv))

    def _sp_damage_keep(self):
        """The masked spatial step's (R,) keep mask, or None for the
        unmasked step (mask off, CABAC, no host luma chain, or every row
        damaged: the bytes are the same).  Shards cannot compact a
        worklist, so masking gates rows (K13s).  Feeds the rate
        controller's damage consumer as :meth:`_damage_plan` does."""
        if (not self.damage_mask or self.entropy == "cabac"
                or self._damage_cur_y is None
                or self._damage_cur_y.shape != (self.pad_h, self.pad_w)):
            return None
        grid = dmg.damage_grid_np(self._damage_cur_y, self._damage_prev_y)
        self._damage_frac = float(grid.mean())
        if self._rate is not None:
            self._rate.note_damage(self._damage_frac)
        rowmask = grid.any(axis=1)
        return None if rowmask.all() else torch.from_numpy(rowmask).to(
            self.device)

    def _sp_collect(self, submitted) -> bytes:
        marker, kind, qp, idr_pic_id, frame_num, buf, prefix, lv_mv = \
            submitted
        if marker == "sp":
            return self._sp_collect_flat(kind, qp, idr_pic_id, frame_num,
                                         buf, _wait(prefix), lv_mv)
        return self._sp_collect_bin(kind, qp, idr_pic_id, frame_num, buf,
                                    _wait(prefix), lv_mv)

    def _sp_collect_flat(self, kind: str, qp: int, idr_pic_id: int,
                         frame_num: int, flat, bufs, lv_mv) -> bytes:
        """A sharded CAVLC AU: each shard's FlatMeta and NALs joined in
        shard order (slice per MB row: the shards are self-contained), the
        pull-guess, short-read and overflow protocol per shard."""
        rows_l = self._sp_rows_local()
        base = cavlc_device.META_WORDS * 4
        t0 = time.perf_counter()
        metas = [cavlc_device.FlatMeta(bufs[i], rows_l)
                 for i in range(len(bufs))]
        if any(m.overflow for m in metas):
            if kind == "p" and lv_mv is not None:
                # the sharded stage's own level tensors, coded on the host
                lv, mv = lv_mv
                pulled = {k: _np(v) for k, v in lv.items()}
                pulled["mv"] = _np(mv)
                return self._encode_p_pulled(pulled, qp, frame_num)
            raise RuntimeError("spatial intra shard overflow")
        self._note_qp_sum(sum(m.qp_sum for m in metas))
        need = max(4 * m.total_words for m in metas)
        bucket = self._PULL_BUCKET
        hist = self._pull_hist if kind == "intra" else self._p_pull_hist
        hist.append(need)
        guess = -(-max(hist) // bucket) * bucket
        if kind == "intra":
            self._pull_guess = guess
        else:
            self._p_pull_guess = guess
        full = None
        parts = [self.headers()] if kind == "intra" else []
        for i, m in enumerate(metas):
            buf_i = bufs[i]
            if 4 * m.total_words > len(buf_i) - base:
                if full is None:
                    extra = -(-need // bucket) * bucket
                    full = flat[:, :base + extra].cpu().numpy()
                buf_i = full[i]
            parts.append(cavlc_device.assemble_annexb(
                buf_i, m, nal_type=None if kind == "intra" else syn.NAL_SLICE,
                ref_idc=3 if kind == "intra" else 2))
        au = b"".join(parts)
        self._sp_record_stitch(t0)
        return au

    def _sp_collect_bin(self, kind: str, qp: int, idr_pic_id: int,
                        frame_num: int, buf, heads, lv_mv) -> bytes:
        """A sharded CABAC AU: each shard's record stream pulled, the
        streams stitched row-wise into one transport
        (``cabac_binarize.stitch_rows``), then the unsharded engine."""
        rows_l = self._sp_rows_local()
        hdrw = cabac_binarize.header_words(rows_l)
        heads = heads.view(np.uint32)
        t0 = time.perf_counter()
        kname = "_bin" if kind == "intra" else "_p_bin"
        hist = getattr(self, f"_cabac{kname}_pull_hist")
        bucket = self._CABAC_PULL_WORDS
        shard_bufs, overflow, need_max = [], False, 0
        for i in range(len(heads)):
            head = heads[i]
            if head[1]:
                overflow = True
                break
            total = cabac_binarize.payload_words(head)
            need_max = max(need_max, total)
            if hdrw + total > head.shape[0]:
                extra = -(-total // bucket) * bucket
                head = buf[i, :hdrw + extra].cpu().numpy().view(np.uint32)
            shard_bufs.append(head)
        au = None
        if not overflow:
            hist.append(need_max)
            setattr(self, f"_cabac{kname}_pull_guess",
                    -(-max(hist) // bucket) * bucket)
            stitched = cabac_binarize.stitch_rows(shard_bufs, rows_l)
            if kind == "intra":
                au = h264_cabac.encode_intra_from_binstream(
                    stitched, nr=self.mb_h, nc_mb=self.mb_w, qp=qp,
                    frame_num=0, idr_pic_id=idr_pic_id, sps=self._sps,
                    pps=self._pps, with_headers=True, qp_delta=qp - self.qp,
                    deblocking_idc=self._deblock_idc)
            else:
                au = h264_cabac.encode_p_from_binstream(
                    stitched, nr=self.mb_h, nc_mb=self.mb_w, qp=qp,
                    frame_num=frame_num, qp_delta=qp - self.qp,
                    deblocking_idc=self._deblock_idc)
        if au is not None:
            self._sp_record_stitch(t0)
            return au
        # overflow (the packed stream or the engine's cap): the dense
        # levels of the sharded stage
        if kind == "intra":
            dense = {k: _np(lv_mv[k]) for k, _, _ in level_pack.INTRA_KEYS}
            dense.update({k: _np(lv_mv[k])
                          for k in ("pred_mode", "mb_i4", "i4_modes")})
            return h264_cabac.encode_intra_picture(
                dense, qp=qp, frame_num=0, idr_pic_id=idr_pic_id,
                sps=self._sps, pps=self._pps, with_headers=True,
                qp_delta=qp - self.qp, deblocking_idc=self._deblock_idc)
        lv, mv = lv_mv
        dense = {k: _np(v) for k, v in lv.items()}
        dense["mv"] = _np(mv).astype(np.int32)
        return h264_cabac.encode_p_picture(
            dense, qp=qp, frame_num=frame_num, qp_delta=qp - self.qp,
            deblocking_idc=self._deblock_idc)

    # -- prewarm -------------------------------------------------------

    def prewarm(self, qps=None, stop=None) -> int:
        """Build and load the CUDA kernel libraries (``ops/_cuda``; no
        CUDA call, so it is safe beside a serving thread) and, with the
        super-step ring on, ask the serving thread to capture the ring's
        graph at the next IDR submit, before the first chunk.  The
        kernels take the qp as an argument or from device memory, so
        there is no qp ladder to walk (``qps`` is accepted for the
        reference's signature).  Returns the number of libraries loaded;
        on the CPU, 0."""
        if self.device.type != "cuda":
            return 0
        from ..ops import _cuda

        _cuda.build()
        done = 0
        for name in _cuda.KERNEL_SOURCES:
            if stop is not None and stop.is_set():
                break
            _cuda.library(name)
            done += 1
        if self._ring_chunk:
            self._prewarm_ring = True
        return done

    def prewarm_async(self, qps=None):
        """Run :meth:`prewarm` in a daemon thread; returns (thread,
        stop_event)."""
        import threading
        stop = threading.Event()
        t = threading.Thread(target=self.prewarm, kwargs={
            "qps": qps, "stop": stop}, daemon=True, name="h264-prewarm")
        t.start()
        return t, stop

    def _capture_ring(self) -> None:
        """Capture the unmasked ring step's graph on zero frames against
        the reference just set (on the serving thread, at an IDR submit):
        the first chunk then replays it."""
        self._prewarm_ring = False
        zero = np.zeros((self.height, self.width, 3), np.uint8)
        planes = None
        if self.host_color:
            chain = (self._damage_prev_y, self._damage_cur_y)
            planes = self._host_yuv420(zero)
            # the damage chain must not see the zero frame
            self._damage_prev_y, self._damage_cur_y = chain
        kind = "cabac" if self.entropy == "cabac" else "cavlc"
        frame, ingest = (planes, "yuv") if planes is not None \
            else (zero, "rgb")
        k = self._ring_chunk
        hv = hl = None
        if kind == "cavlc":
            hv, hl = self._chunk_hdr_slots(tuple(range(1, k + 1)), 0)
        step = self._chunk_step(kind, ingest, 0)
        if not step.instances:
            step.warm([frame] * k, self._ref, hv, hl, self.qp)

    # -- content & quality telemetry -----------------------------------

    def _content_submit(self, y: torch.Tensor, recon_y=None, mv=None,
                        resid=None, frame_type: str = "p",
                        mb_intra=None) -> None:
        """Launch the stats kernel for one frame; sets ``_content_last``
        to a device-handle dict (None when disabled or cadence-skipped).
        ``recon_y`` (and for a P frame ``mv`` and the residual tensors)
        select the full form.  A kernel fault raises and fails the
        frame."""
        self._content_last = None
        if not obsc.enabled():
            self._content_prev_y = None
            return
        self._content_n += 1
        prev = self._content_prev_y
        # the previous ingest advances even on skipped frames, so damage
        # stays strictly frame-to-frame
        self._content_prev_y = y
        if (self._content_n - 1) % obsc.sample_every():
            return
        # the first ingest has no reference: self-diff so activity still
        # lands, and null the damage fields at finish
        first = prev is None or tuple(prev.shape) != tuple(y.shape)
        if recon_y is None:
            vec, grid = content_stats.frame_stats(
                y, y if first else prev, obsc.damage_thr_sad())
        else:
            vec, grid = content_stats.frame_stats_full(
                y, y if first else prev, obsc.damage_thr_sad(), recon_y,
                mv, resid, mb_intra)
        self._content_last = {"vec": vec, "grid": grid,
                              "frame_type": frame_type, "first": first}

    def _content_stash(self, idx: int) -> None:
        h = self._content_last
        self._content_last = None
        if h is not None:
            if len(self._content_pending) > 32:
                self._content_pending.clear()
            self._content_pending[idx] = h

    def _content_ring_dispatch(self, ring, out, masked: bool) -> None:
        """Chunk twin of :meth:`_content_submit`: one K4c launch for the
        chunk's ingest luma, the SSE against its last reference, and
        (unmasked chunks) the MV and mode fields per slot.  A kernel
        fault raises and fails the chunk."""
        if not obsc.enabled():
            self._content_prev_y = None
            return
        prev = self._content_prev_y
        # a copy: the next replay overwrites the step's static input
        self._content_prev_y = out.ys[-1].clone()
        self._content_n += len(ring.fns)
        if prev is None or tuple(prev.shape) != tuple(out.ys.shape[1:]):
            return
        if self._spatial_nx > 1:
            # as the reference's: damage and activity only under shards
            ring.content = content_stats.chunk_stats(
                out.ys, prev, obsc.damage_thr_sad())
            return
        ring.content = content_stats.chunk_stats(
            out.ys, prev, obsc.damage_thr_sad(), out.refs[0],
            None if masked else out.mvs,
            None if masked else tuple(out.lvs[k] for k in (
                "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")))

    def _content_finish(self, token, data: bytes) -> None:
        self._content_meta = None
        if not obsc.enabled():
            return
        if token[0] == "ring":
            ring, slot = token[4]
            h = None
            if ring.pf is not None:
                h = ring.content_pf[slot]
            elif ring.content is not None:
                if ring.content_np is None:
                    ring.content_np = tuple(_np(t) for t in ring.content)
                h = {"vec": ring.content_np[0][slot],
                     "grid": ring.content_np[1][slot], "frame_type": "p"}
        else:
            h = self._content_pending.pop(token[1], None)
        if h is None:
            return
        stats = content_stats.vec_to_stats(_np(h["vec"]), _np(h["grid"]),
                                           self.pad_h * self.pad_w)
        if h.get("first"):
            stats["damage_fraction"] = None
            stats["damage_grid"] = None
        if stats.get("mode") is None and stats.get("mbs"):
            # intra frames carry no mode tensors: every MB is intra
            stats["mode"] = {"skip": 0.0, "inter": 0.0, "intra": 1.0}
        stats["frame_type"] = h["frame_type"]
        stats["au_bytes"] = len(data)
        stats["tier"] = self._ktune
        self._content_meta = stats

    def pop_content_stats(self):
        """Content stats of the LAST collected frame (cleared by the pop)."""
        m = self._content_meta
        self._content_meta = None
        return m

    # -- device entropy path -------------------------------------------

    # Pull granularity for the flat buffer (64 KiB prefix buckets).
    _PULL_BUCKET = 1 << 16

    _host_yuv_ok = None                            # class-level cv2 probe

    def _host_yuv420(self, rgb):
        """Padded (y, cb, cr) uint8 planes from the host converter (cv2),
        or None when cv2 is unavailable or the geometry resists 4:2:0 (the
        device conversion takes over)."""
        cls = type(self)
        if cls._host_yuv_ok is False:
            return None
        h, w = rgb.shape[:2]
        if h % 2 or w % 2:
            return None
        planes = rgb_to_yuv420_host(rgb, self.pad_h, self.pad_w,
                                    float_fallback=False)
        cls._host_yuv_ok = planes is not None
        if planes is not None and self.damage_mask:
            # the damage gating's luma chain advances on every
            # host-converted frame (IDR, staged, per-frame alike), so the
            # grid always diffs frame to frame
            self._damage_prev_y = self._damage_cur_y
            self._damage_cur_y = np.array(planes[0], copy=True)
        return planes

    def _device_colour(self, rgb):
        """K9 on the uploaded RGB frame."""
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        return color.rgb_to_yuv420(rgb_t, self.pad_h, self.pad_w)

    def _planes_device(self, rgb):
        """The frame as padded YUV planes on the encoder's device: the
        host converter's, uploaded, under ``host_color``; else (and where
        the host gives none) the device conversion (K9) of the uploaded
        RGB frame."""
        planes = self._host_yuv420(rgb) if self.host_color else None
        if planes is not None:
            return self._upload(planes)
        return self._device_colour(rgb)

    # tune=hq GOP-aware I/P split: the IDR is every P frame's transitive
    # reference, so the full tier codes it I_QP_BIAS finer (gated on the
    # kernel tier: hq_noaq has no qp-sum meta to normalise a biased IDR)
    I_QP_BIAS = 3

    def _eff_qp(self, keyframe: bool = True) -> int:
        qp = self.qp if self._rate is None else self._rate.qp_for(keyframe)
        if keyframe and self._ktune == "hq" and self.gop > 1:
            qp = max(qp - self.I_QP_BIAS, 1)
        off = self.degrade_qp_offset
        return min(51, max(0, qp + off)) if off else qp

    def _hdr_slots(self, idr_pic_id: int, qp_delta: int = 0):
        key = (0, idr_pic_id, qp_delta)  # (frame_num, idr_pic_id, qp_delta)
        slots = self._hdr_slots_cache.get(key)
        if slots is None:
            hv, hl = cavlc_device.slice_header_slots(
                self.mb_h, self.mb_w, frame_num=key[0], idr_pic_id=key[1],
                qp_delta=qp_delta, deblocking_idc=self._deblock_idc)
            slots = (torch.from_numpy(hv.view(np.int32)).to(self.device),
                     torch.from_numpy(hl).to(self.device))
            self._hdr_slots_cache[key] = slots
        return slots

    def _p_hdr_slots(self, frame_num: int, qp_delta: int):
        key = ("p", frame_num, qp_delta)
        slots = self._hdr_slots_cache.get(key)
        if slots is None:
            slots = tuple(torch.from_numpy(a).to(self.device) for a in
                          self._p_hdr_slots_np(frame_num, qp_delta))
            self._hdr_slots_cache[key] = slots
        return slots

    def _upload(self, planes):
        return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                     for p in planes)

    def _set_ref(self, recon, qp: int, nnz=None, mv=None,
                 luma=None) -> None:
        """The next frame's reference: the recon, loop-filtered when
        deblocking is on (new planes; the recon itself stays as it is).
        A P frame's coded blocks come as ``nnz`` or as its ``luma``
        levels."""
        self._ref = (h264_deblock.deblock_frame(*recon, qp, nnz_blk=nnz,
                                                mv=mv, luma=luma)
                     if self.deblock else tuple(recon))

    def _submit_device(self, rgb, idr_pic_id: int):
        """Launch the device stage without waiting for it."""
        qp = self._eff_qp()
        hv, hl = self._hdr_slots(idr_pic_id, qp_delta=qp - self.qp)
        planes = y, cb, cr = self._planes_device(rgb)
        levels = h264_device.encode_intra_frame_yuv(
            y, cb, cr, qp, tune=self._ktune, i16_modes=self.i16_modes)
        flat = cavlc_device.encode_levels(levels, hv, hl, qp)
        recon = tuple(levels[k] for k in ("recon_y", "recon_cb", "recon_cr"))
        if self.gop > 1:
            # the reference advances at SUBMIT time: a pipelined P frame
            # submitted before this IDR is collected must see it
            self._set_ref(recon, qp)
        with_recon = self.keep_recon or self.gop > 1
        self._content_submit(y, recon_y=recon[0] if with_recon else None,
                             frame_type="intra")
        # the pre-deblock recon, pulled at submit
        recon = (tuple(p.cpu().numpy() for p in recon) if self.keep_recon
                 else None)
        guess = self._pull_guess or 4 * self._PULL_BUCKET
        prefix = _pinned_prefetch(flat[:cavlc_device.META_WORDS * 4 + guess])
        return (rgb, idr_pic_id, qp, planes, flat, prefix, recon)

    def _collect_device(self, submitted, in_pipeline: bool = False) -> bytes:
        """Wait for the device stage and assemble the Annex-B access unit.
        ``in_pipeline``: a later frame may already have been submitted, so
        an overflow fallback must not move the reference chain."""
        rgb, idr_pic_id, qp, planes, flat, (prefix, ev), recon = submitted
        if recon is not None:
            self.last_recon = recon
        if ev is not None:
            ev.synchronize()
        base = cavlc_device.META_WORDS * 4
        buf = prefix.numpy()
        meta = cavlc_device.FlatMeta(buf, self.mb_h)
        if meta.overflow:
            # reuse the exact device inputs (planes + rate-controlled qp)
            return self._encode_host_entropy(idr_pic_id, planes, qp,
                                             update_ref=not in_pipeline)
        self._note_qp_sum(meta.qp_sum)
        need = 4 * meta.total_words
        bucket = self._PULL_BUCKET
        self._pull_hist.append(need)
        self._pull_guess = -(-max(self._pull_hist) // bucket) * bucket
        if need > len(buf) - base:
            extra = -(-need // bucket) * bucket
            buf = flat[:base + extra].cpu().numpy()
        return cavlc_device.assemble_annexb(buf, meta, headers=self.headers())

    def _encode_host_entropy(self, idr_pic_id: int, planes, qp: int,
                             update_ref: bool = True) -> bytes:
        """A host-entropy IDR (``entropy`` "native" or "python") and the
        device path's overflow fallback: the intra core on the device
        planes at ``qp``, then CAVLC on the host, by the C coder where the
        reference takes it (qp delta 0, I16 DC only, no qp plane, no loop
        filter; not under ``entropy="python"``), else the Python coder.
        ``update_ref=False`` leaves a pipeline's reference chain as the
        submit set it."""
        from ..native import lib as native_lib

        levels = h264_device.encode_intra_frame_yuv(
            *planes, qp, tune=self._ktune, i16_modes=self.i16_modes)
        if self.gop > 1 and update_ref:
            self._set_ref(tuple(levels[k] for k in
                                ("recon_y", "recon_cb", "recon_cr")), qp)
        if self.keep_recon:
            self.last_recon = tuple(levels[k].cpu().numpy()
                                    for k in ("recon_y", "recon_cb",
                                              "recon_cr"))
        levels = {k: v.cpu().numpy() for k, v in levels.items()
                  if not k.startswith("recon")}
        qp_map = levels.pop("qp_map", None)
        self._note_qp_map(qp_map, levels=levels, slice_qp=qp, intra=True)
        uses_modes = bool((levels["pred_mode"] != 2).any()
                          or levels["mb_i4"].any())
        if (qp == self.qp and not uses_modes and self.entropy != "python"
                and qp_map is None and not self.deblock
                and native_lib.has_cavlc()):
            return self.headers() + native_lib.h264_encode_intra_picture(
                levels, frame_num=0, idr_pic_id=idr_pic_id)
        return h264_entropy.encode_intra_picture(
            levels, frame_num=0, idr_pic_id=idr_pic_id,
            sps=self._sps, pps=self._pps, with_headers=True,
            qp_delta=qp - self.qp, deblocking_idc=self._deblock_idc,
            qp_map=qp_map, slice_qp=qp)

    def _encode_p_host(self, planes, qp: int) -> bytes:
        """A P frame of the host-entropy modes: the P core on the device
        planes, the next reference (loop-filtered with the deblock), then
        the Python CAVLC coder on the pulled levels."""
        out = h264_inter.encode_p_frame(*planes, *self._ref, qp,
                                        tune=self._ktune,
                                        p_intra=self._p_intra)
        recon = tuple(out[k] for k in self._RECON_KEYS)
        self._set_ref(recon, qp, mv=out["mv"], luma=out["luma"])
        if self.keep_recon:
            self.last_recon = tuple(p.cpu().numpy() for p in recon)
        pulled = {k: v.cpu().numpy() for k, v in out.items()
                  if not k.startswith("recon")}
        self.last_mv = pulled["mv"]
        return self._encode_p_pulled(pulled, qp, self._frame_num)

    def _encode_pcm(self, rgb) -> bytes:
        """An IDR of I_PCM macroblocks: the device colour conversion (K9),
        then every MB's samples as bytes (the reference's
        ``_encode_pcm``)."""
        from ..bitstream.bitwriter import BitWriter

        y, cb, cr = (p.cpu().numpy() for p in self._device_colour(rgb))
        bw = BitWriter()
        syn.slice_header(bw, first_mb=0, slice_type=7, frame_num=0,
                         idr=True, idr_pic_id=self.frame_index % 2)
        syn.write_ue(bw, 25)                   # mb_type I_PCM
        bw.pad_to_byte(0)                      # pcm_alignment_zero_bits
        head = bytes(bw.buf)

        def tiles(plane, n):                   # (MBs, n * n), raster MBs
            h, w = plane.shape
            return plane.reshape(h // n, n, w // n, n).swapaxes(1, 2) \
                .reshape(-1, n * n)
        y_mb, cb_mb, cr_mb = tiles(y, 16), tiles(cb, 8), tiles(cr, 8)
        # every later MB starts byte-aligned: ue(25) is 9 bits, then 7
        # alignment zeros: the bytes 0x0D 0x00
        prefix = np.tile(np.array([0x0D, 0x00], np.uint8), (len(y_mb), 1))
        body = np.concatenate([prefix, y_mb, cb_mb, cr_mb],
                              axis=1).reshape(-1)[2:]
        rbsp = head + body.tobytes() + b"\x80"    # rbsp_trailing_bits
        return self.headers() + syn.nal_unit(syn.NAL_IDR, rbsp)

    # -- mean coded qp (tune=hq): the rate model's normalisation ---------

    def _note_qp_sum(self, qp_sum: int) -> None:
        """A frame's summed per-MB effective qp (the flat buffer's meta
        word; 0 = the uniform slice qp of the other tiers)."""
        if qp_sum:
            self._mean_qp_pending = qp_sum / float(self.mb_w * self.mb_h)

    def _note_qp_map(self, qp_map, levels=None, slice_qp=None,
                     intra: bool = False) -> None:
        """Host-path twin of :meth:`_note_qp_sum`: the mean effective qp
        of the mb_qp_delta chain the levels emit (the plane's mean
        without levels)."""
        if qp_map is None:
            return
        if levels is None:
            self._mean_qp_pending = float(np.mean(qp_map))
            return
        f = (h264_entropy.intra_mean_coded_qp if intra
             else h264_entropy.p_mean_coded_qp)
        self._mean_qp_pending = f(levels, qp_map, slice_qp)

    def _take_mean_qp(self):
        m = self._mean_qp_pending
        self._mean_qp_pending = None
        return m

    # -- CABAC path ------------------------------------------------------
    # The device stage's levels leave the card compacted (K10) or
    # binarized into records (K11); the native coder or engine codes the
    # slices on the host at collect, so the session loop overlaps the
    # next frame's device stage with this frame's entropy coding.

    _CABAC_PULL_WORDS = 1 << 14          # pull-guess bucket, in words
    _RECON_KEYS = ("recon_y", "recon_cb", "recon_cr")
    _BIN_INTRA_KEYS = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc",
                       "cr_ac", "pred_mode", "mb_i4", "i4_modes", "luma_i4")
    _BIN_P_KEYS = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")

    @property
    def cabac_device_binarize(self) -> bool:
        """Binarize on the card (K11, ``ENCODER_CABAC_BINARIZE=device``)
        instead of compacting the levels (K10, ``host``, the default);
        read once per encoder.  Both routes give the same bytes."""
        if self._cabac_dev_bin is None:
            v = os.environ.get("ENCODER_CABAC_BINARIZE", "host") == "device"
            if v and self._ktune == "hq":
                # the record stream has no per-MB qp: the full tier
                # codes CABAC through the level transport and the host
                log.warning(
                    "ENCODER_CABAC_BINARIZE=device has no per-MB qp "
                    "plumbing; ENCODER_TUNE=hq uses the dense host CABAC "
                    "path")
                v = False
            self._cabac_dev_bin = v
        return self._cabac_dev_bin

    def _cabac_prefix(self, buf, hdr_words: int, kind: str, default: int):
        """Start the pull of a transport's header and guessed payload."""
        guess = getattr(self, f"_cabac{kind}_pull_guess") or default
        return _pinned_prefetch(buf[:hdr_words + guess])

    def _pull_transport(self, buf, prefix, hdr_words: int, kind: str):
        """Wait for a transport's prefix; re-pull on a short read.  Returns
        the host uint32 words covering header + payload, or None on the
        overflow flag.  The next guess is the decaying max of recent
        payloads, ceiled to the bucket."""
        host, ev = prefix
        if ev is not None:
            ev.synchronize()
        head = host.numpy().view(np.uint32)
        if head[1]:
            return None
        total = int(head[2])
        hist = getattr(self, f"_cabac{kind}_pull_hist")
        bucket = self._CABAC_PULL_WORDS
        hist.append(total)
        setattr(self, f"_cabac{kind}_pull_guess",
                -(-max(hist) // bucket) * bucket)
        if hdr_words + total > len(head):
            extra = -(-total // bucket) * bucket
            head = buf[:hdr_words + extra].cpu().numpy().view(np.uint32)
        return head

    def _pull_packed(self, buf, prefix, keys, kind: str):
        """Dense level arrays from a K10 transport, or None on overflow."""
        head = self._pull_transport(buf, prefix,
                                    level_pack.header_words(self.mb_h), kind)
        if head is None:
            return None
        return level_pack.unpack_levels(head, self.mb_h, self.mb_w, keys)

    def _pull_binstream(self, buf, prefix, kind: str):
        """A K11 transport on the host, or None on overflow."""
        return self._pull_transport(
            buf, prefix, cabac_binarize.header_words(self.mb_h), kind)

    def _submit_cabac_intra(self, rgb, idr_pic_id: int):
        qp = self._eff_qp()
        y, cb, cr = self._planes_device(rgb)
        levels = h264_device.encode_intra_frame_yuv(
            y, cb, cr, qp, tune=self._ktune, i16_modes=self.i16_modes)
        if self.gop > 1:
            self._set_ref(tuple(levels[k] for k in self._RECON_KEYS), qp)
        self._content_submit(y, recon_y=levels["recon_y"],
                             frame_type="intra")
        if self.cabac_device_binarize:
            buf = cabac_binarize.binarize_intra(
                *(levels[k] for k in self._BIN_INTRA_KEYS))
            prefix = self._cabac_prefix(
                buf, cabac_binarize.header_words(self.mb_h), "_bin",
                8 * self._CABAC_PULL_WORDS)
            return ("bin", levels, buf, prefix, None, qp, idr_pic_id)
        buf = level_pack.pack_levels(levels, level_pack.INTRA_KEYS)
        small = {k: _pinned_prefetch(levels[k].to(torch.int8))
                 for k in ("pred_mode", "mb_i4", "i4_modes", "qp_map")
                 if k in levels}
        prefix = self._cabac_prefix(buf, level_pack.header_words(self.mb_h),
                                    "", 8 * self._CABAC_PULL_WORDS)
        return ("lv", levels, buf, prefix, small, qp, idr_pic_id)

    def _collect_cabac_intra(self, submitted) -> bytes:
        kind, levels, buf, prefix, small, qp, idr_pic_id = submitted
        if self.keep_recon:
            self.last_recon = tuple(levels[k].cpu().numpy()
                                    for k in self._RECON_KEYS)
        args = dict(qp=qp, frame_num=0, idr_pic_id=idr_pic_id, sps=self._sps,
                    pps=self._pps, with_headers=True, qp_delta=qp - self.qp,
                    deblocking_idc=self._deblock_idc)
        dense = None
        if kind == "bin":
            head = self._pull_binstream(buf, prefix, "_bin")
            if head is not None:
                au = h264_cabac.encode_intra_from_binstream(
                    head, nr=self.mb_h, nc_mb=self.mb_w, **args)
                if au is not None:
                    return au
            modes = {k: levels[k].cpu().numpy()
                     for k in ("pred_mode", "mb_i4", "i4_modes")}
        else:
            dense = self._pull_packed(buf, prefix, level_pack.INTRA_KEYS, "")
            modes = {k: _wait(v) for k, v in small.items()}
        if dense is None:      # overflow: the dense levels
            dense = {k: levels[k].cpu().numpy()
                     for k, _, _ in level_pack.INTRA_KEYS}
        dense.update(modes)
        qp_map = dense.pop("qp_map", None)
        if qp_map is not None:
            qp_map = qp_map.astype(np.int32)
            self._note_qp_map(qp_map, levels=dense, slice_qp=qp, intra=True)
        return h264_cabac.encode_intra_picture(dense, qp_map=qp_map, **args)

    def _submit_cabac_p(self, planes, qp: int, frame_num: int = None,
                        next_y=None):
        """The P core (K5), the reference's loop filter (K8) and the
        level transport (K10) or records (K11p), without waiting.
        ``next_y``: the full tier's lookahead luma (a ring flush)."""
        frame_num = self._frame_num if frame_num is None else frame_num
        y, cb, cr = planes
        out = h264_inter.encode_p_frame(y, cb, cr, *self._ref, qp,
                                        tune=self._ktune, next_y=next_y)
        self._content_submit(
            y, recon_y=out["recon_y"], mv=out["mv"],
            resid=tuple(out[k] for k in ("luma", "cb_dc", "cb_ac", "cr_dc",
                                         "cr_ac")),
            frame_type="p")
        self._set_ref(tuple(out[k] for k in self._RECON_KEYS), qp,
                      mv=out["mv"], luma=out["luma"])
        if self.cabac_device_binarize:
            buf = cabac_binarize.binarize_p(
                *(out[k] for k in self._BIN_P_KEYS))
            prefix = self._cabac_prefix(
                buf, cabac_binarize.header_words(self.mb_h), "_p_bin",
                4 * self._CABAC_PULL_WORDS)
            return ("bin", out, buf, prefix, None, qp, frame_num)
        buf = level_pack.pack_levels(out, level_pack.P_KEYS)
        mv = _pinned_prefetch(out["mv"])
        prefix = self._cabac_prefix(buf, level_pack.header_words(self.mb_h),
                                    "_p", 4 * self._CABAC_PULL_WORDS)
        return ("lv", out, buf, prefix, mv, qp, frame_num)

    def _collect_cabac_p(self, submitted) -> bytes:
        kind, out, buf, prefix, mv, qp, frame_num = submitted
        if self.keep_recon:
            self.last_recon = tuple(out[k].cpu().numpy()
                                    for k in self._RECON_KEYS)
            self.last_mv = out["mv"].cpu().numpy()
        args = dict(qp=qp, frame_num=frame_num, qp_delta=qp - self.qp,
                    deblocking_idc=self._deblock_idc)
        dense = None
        if kind == "bin":
            head = self._pull_binstream(buf, prefix, "_p_bin")
            if head is not None:
                au = h264_cabac.encode_p_from_binstream(
                    head, nr=self.mb_h, nc_mb=self.mb_w, **args)
                if au is not None:
                    return au
            mv = out["mv"].cpu().numpy()
        else:
            dense = self._pull_packed(buf, prefix, level_pack.P_KEYS, "_p")
            mv = _wait(mv)
        if dense is None:      # overflow: the dense levels
            dense = {k: out[k].cpu().numpy() for k, _, _ in level_pack.P_KEYS}
        dense["mv"] = mv
        qp_map = _np(out["qp_map"]) if "qp_map" in out else None
        self._note_qp_map(qp_map, levels=dense, slice_qp=qp)
        return h264_cabac.encode_p_picture(dense, qp_map=qp_map, **args)

    # -- P frames --------------------------------------------------------

    def _submit_p(self, rgb):
        """(token kind, submitted) of a P frame.  The damage plan is taken
        from the host planes before they are uploaded."""
        t0 = time.perf_counter()
        qp = self._eff_qp(keyframe=False)
        host = self._host_yuv420(rgb) if self.host_color else None
        if self._spatial_nx > 1:
            planes = (self._upload(host) if host is not None
                      else self._device_colour(rgb))
            got = "sp", self._sp_submit_p(planes, qp)
            self._count_dispatch(t0)
            return got
        plan = self._damage_plan(None if host is None else host[0])
        planes = (self._upload(host) if host is not None
                  else self._device_colour(rgb))
        if self.entropy in ("native", "python"):
            got = "host", self._encode_p_host(planes, qp)
        elif self.entropy == "cabac":
            got = "cabac_p", self._submit_cabac_p(planes, qp)
        else:
            got = self._submit_p_cavlc(planes, qp, self._frame_num, plan)
        self._count_dispatch(t0)
        return got

    def _submit_p_cavlc(self, planes, qp: int, frame_num: int, plan,
                        next_y=None):
        """A device-CAVLC P frame: masked over ``plan``'s rows where it
        leaves some out, else the full frame."""
        if plan is not None and not plan.full:
            return "p_masked", self._submit_p_masked(planes, qp, frame_num,
                                                     plan, next_y)
        return "p", self._submit_p_device(planes, qp, frame_num, next_y)

    def _submit_p_device(self, planes, qp: int, frame_num: int = None,
                         next_y=None):
        """Launch the P stage on the device planes without waiting for
        it; ``self._ref`` advances now, so the next frame can submit
        before this one is collected.  The old reference is only read:
        the recon goes to new planes.  ``next_y``: the full tier's
        lookahead luma (a ring flush)."""
        frame_num = self._frame_num if frame_num is None else frame_num
        hv, hl = self._p_hdr_slots(frame_num, qp - self.qp)
        y, cb, cr = planes
        flat, ry, rcb, rcr, mv, nnz, levels = \
            cavlc_p_device.encode_p_cavlc_frame(
                y, cb, cr, *self._ref, hv, hl, qp, tune=self._ktune,
                next_y=next_y, p_intra=self._p_intra)
        self._content_submit(
            y, recon_y=ry, mv=mv,
            resid=tuple(levels[k] for k in ("luma", "cb_dc", "cb_ac",
                                            "cr_dc", "cr_ac")),
            frame_type="p", mb_intra=levels.get("mb_intra"))
        self._set_ref((ry, rcb, rcr), qp, nnz, mv)
        recon = None
        if self.keep_recon:
            # THIS frame's pre-deblock recon, pulled at submit
            recon = (tuple(p.cpu().numpy() for p in (ry, rcb, rcr)),
                     mv.cpu().numpy())
        guess = self._p_pull_guess or 2 * self._PULL_BUCKET
        prefix = _pinned_prefetch(flat[:cavlc_device.META_WORDS * 4 + guess])
        return (qp, frame_num, levels, recon, flat, prefix, mv)

    def _collect_p_device(self, submitted) -> bytes:
        qp, frame_num, levels, recon, flat, (prefix, ev), mv = submitted
        if recon is not None:
            self.last_recon, self.last_mv = recon
        if ev is not None:
            ev.synchronize()
        buf = prefix.numpy()
        meta = cavlc_device.FlatMeta(buf, self.mb_h)
        if meta.overflow:
            # host-code the SAME level tensors the device stage produced:
            # the reference chain already moved past this frame
            pulled = {k: v.cpu().numpy() for k, v in levels.items()}
            pulled["mv"] = mv.cpu().numpy()
            self.last_mv = pulled["mv"]
            return self._encode_p_pulled(pulled, qp, frame_num)
        self._note_qp_sum(meta.qp_sum)
        buf = self._pull_flat(flat, buf, meta)
        return cavlc_device.assemble_annexb(buf, meta, nal_type=syn.NAL_SLICE,
                                            ref_idc=2)

    def _encode_p_pulled(self, pulled: dict, qp: int, frame_num: int):
        """A P frame's pulled levels (with the full tier's qp plane and
        the I16-in-P tensors) coded on the host."""
        qp_map = pulled.pop("qp_map", None)
        self._note_qp_map(qp_map, levels=pulled, slice_qp=qp)
        return h264_entropy.encode_p_picture(
            pulled, frame_num=frame_num, qp_delta=qp - self.qp,
            deblocking_idc=self._deblock_idc, qp_map=qp_map, slice_qp=qp)

    # -- damage-driven encode (ops/damage_mask) --------------------------
    # The host twin of the content plane's damage grid compacts a P frame
    # to its damaged MB rows; the others go out as cached all-skip slices,
    # which a decoder reconstructs as the reference rows.

    def _damage_plan(self, y):
        """RowPlan of the current host-converted frame ``y``, or None
        where the masked path cannot serve it (mask off, device colour,
        PCM, host or CABAC entropy, ``keep_recon``: the frame is served
        unmasked).  Feeds the rate controller's damage consumer."""
        if (not self.damage_mask or self.mode != "cavlc"
                or self.entropy != "device" or self.keep_recon or y is None
                or self._damage_cur_y is None):
            return None
        prev = self._damage_prev_y
        if prev is not None and prev.shape != y.shape:
            prev = None                   # after a resize: all damaged
        plan = dmg.plan_rows(dmg.damage_grid_np(np.asarray(y), prev))
        self._damage_frac = plan.frac
        if self._rate is not None:
            self._rate.note_damage(plan.frac)
        return plan

    def _p_hdr_slots_np(self, frame_num: int, qp_delta: int):
        """Host copies of the P slice-header slots (int32 views), for
        gathering a worklist's rows before the upload."""
        key = ("p_np", frame_num, qp_delta)
        slots = self._hdr_slots_cache.get(key)
        if slots is None:
            hv, hl = cavlc_device.slice_header_slots(
                self.mb_h, self.mb_w, frame_num=frame_num,
                qp_delta=qp_delta, slice_type=5, idr=False,
                deblocking_idc=self._deblock_idc)
            slots = (hv.view(np.int32), hl)
            self._hdr_slots_cache[key] = slots
        return slots

    def _submit_p_masked(self, planes, qp: int, frame_num: int, plan,
                         next_y=None):
        """The masked P stage over ``plan``'s worklist (damage_mask.
        row_core) at the encoder's kernel tier (``next_y``: the full
        tier's lookahead luma, in a ring flush); the scattered reference
        planes become the next reference.  The content stats take the
        full luma and the new reference (no MV or mode fields: the
        untouched rows are skip by construction)."""
        hv, hl = self._p_hdr_slots_np(frame_num, qp - self.qp)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        y, cb, cr = planes
        flat, ry, rcb, rcr, mv, _, levels = dmg.row_core(
            y, cb, cr, *self._ref, up(plan.padded), up(hv[plan.padded]),
            up(hl[plan.padded]), qp, tune=self._ktune, next_y=next_y,
            p_intra=self._p_intra, deblock=self.deblock)
        self._ref = (ry, rcb, rcr)
        self._content_submit(y, recon_y=ry, frame_type="p")
        guess = self._p_pull_guess or 2 * self._PULL_BUCKET
        prefix = _pinned_prefetch(flat[:cavlc_device.META_WORDS * 4 + guess])
        return (qp, frame_num, levels, flat, prefix, mv, plan)

    def _masked_overflow(self, levels, mv, rows, qp: int, frame_num: int,
                         note_mv: bool = False) -> bytes:
        """A compacted frame past the flat cap: its levels scattered to
        full-frame shapes (the other rows skip), coded on the host.  The
        full tier's qp plane becomes the frame's: the slice qp on the
        untouched rows (they code no mb_qp_delta), the worklist's rows
        where they lie.  ``note_mv`` (the per-frame path, as the
        reference's) keeps the scattered MVs as ``last_mv``."""
        pulled = {k: _np(v) for k, v in levels.items()}
        qp_map = pulled.pop("qp_map", None)
        full_lv, full_mv = dmg.scatter_levels_np(pulled, _np(mv), rows,
                                                 self.mb_h)
        full_lv["mv"] = full_mv
        if qp_map is not None:
            fq = np.full((self.mb_h,) + qp_map.shape[1:], qp, qp_map.dtype)
            fq[rows] = qp_map
            qp_map = fq
        if note_mv:
            self.last_mv = full_mv
        self._note_qp_map(qp_map, levels=full_lv, slice_qp=qp)
        return h264_entropy.encode_p_picture(
            full_lv, frame_num=frame_num, qp_delta=qp - self.qp,
            deblocking_idc=self._deblock_idc, qp_map=qp_map, slice_qp=qp)

    def _note_masked_qp_sum(self, qp_sum: int, qp: int, bucket: int) -> None:
        """The rate model's mean coded qp of a masked frame: the meta sums
        the worklist's rows (padded copies included, as the reference's
        sum: they bias it by less than a row of qp), and the untouched
        rows decode at the slice qp."""
        if qp_sum:
            self._note_qp_sum(int(qp_sum)
                              + qp * self.mb_w * (self.mb_h - bucket))

    def _pull_flat(self, flat, buf: np.ndarray, meta) -> np.ndarray:
        """The P pull protocol: update the guess from this frame's size,
        re-pull on a short prefix."""
        base = cavlc_device.META_WORDS * 4
        need = 4 * meta.total_words
        bucket = self._PULL_BUCKET
        self._p_pull_hist.append(need)
        self._p_pull_guess = -(-max(self._p_pull_hist) // bucket) * bucket
        if need > len(buf) - base:
            extra = -(-need // bucket) * bucket
            buf = flat[:base + extra].cpu().numpy()
        return buf

    def _collect_p_masked(self, submitted) -> bytes:
        qp, frame_num, levels, flat, prefix, mv, plan = submitted
        buf = _wait(prefix)
        meta = cavlc_device.FlatMeta(buf, plan.bucket)
        if meta.overflow:
            return self._masked_overflow(levels, mv, plan.padded, qp,
                                         frame_num, note_mv=True)
        self._note_masked_qp_sum(meta.qp_sum, qp, plan.bucket)
        buf = self._pull_flat(flat, buf, meta)
        return dmg.assemble_masked_au(
            buf, meta, plan.rows, self.mb_h, self.mb_w, frame_num=frame_num,
            qp_delta=qp - self.qp, deblocking_idc=self._deblock_idc)

    def _collect(self, kind: str, payload, in_pipeline: bool = False):
        if kind == "host":              # coded at submit
            return payload
        if kind == "ring":
            return self._ring_collect(payload)
        if kind == "sp":
            return self._sp_collect(payload)
        if kind == "p_masked":
            return self._collect_p_masked(payload)
        if kind == "p":
            return self._collect_p_device(payload)
        if kind == "cabac_p":
            return self._collect_cabac_p(payload)
        if kind == "cabac_intra":
            return self._collect_cabac_intra(payload)
        return self._collect_device(payload, in_pipeline=in_pipeline)

    def _submit_idr(self, rgb, idr_pic_id: int):
        """(token kind, submitted) of an IDR."""
        t0 = time.perf_counter()
        if self._spatial_nx > 1:
            got = "sp", self._sp_submit_intra(rgb, idr_pic_id)
        elif self.entropy in ("native", "python"):
            # the reference codes these IDRs from its device colour stage
            got = "host", self._encode_host_entropy(
                idr_pic_id, self._device_colour(rgb), self._eff_qp())
        elif self.entropy == "cabac":
            got = "cabac_intra", self._submit_cabac_intra(rgb, idr_pic_id)
        else:
            got = "intra", self._submit_device(rgb, idr_pic_id)
        self._count_dispatch(t0)
        if self._prewarm_ring and self.gop > 1 and self._ref is not None:
            self._capture_ring()
        return got

    def _next_is_idr(self) -> bool:
        return self._gop_pos == 0 or self._force_idr or self._ref is None

    def _start_idr(self) -> int:
        """GOP state of a new IDR; returns its idr_pic_id (consecutive
        IDRs must differ)."""
        self._force_idr = False
        self._gop_pos = 0
        self._frame_num = 0
        self._idr_count += 1
        return self._idr_count % 2

    def _gop_step(self, rgb):
        """One GOP state-machine step -> (data, keyframe)."""
        idr = self._next_is_idr()
        n0 = self._rate.mark() if self._rate is not None else 0
        try:
            if idr:
                data = self._collect(*self._submit_idr(rgb, self._start_idr()))
            else:
                self._frame_num = (self._frame_num + 1) % 16
                data = self._collect(*self._submit_p(rgb))
        except Exception:
            if self._rate is not None:
                self._rate.rollback_to(n0)
            self._force_idr = True   # ref chain may be ahead of the client
            raise
        self._gop_pos = (self._gop_pos + 1) % self.gop
        if self._rate is not None:
            self._rate.update(len(data) * 8, mean_qp=self._take_mean_qp())
        return data, idr

    def request_keyframe(self) -> None:
        """Resume semantics: the next frame becomes an IDR."""
        self._force_idr = True

    # -- super-step ring (ops/devloop) ---------------------------------
    # P frames stage on the host without any device work; a full chunk
    # runs as one replay of a captured graph.  The chunk's bytes equal the
    # per-frame path's, so a partial chunk (an IDR due, a drain) flushes
    # through the per-frame path with no trace in the stream.

    @property
    def _ring_chunk(self) -> int:
        """Frames per chunk (0 = ring off): a GOP, device CAVLC or CABAC
        with device binarization, and no per-frame recon pulls
        (``keep_recon``).  At most 6, so ring and pipeline stay inside
        the rate controller's in-flight window."""
        c = self._ring_chunk_cached
        if c is None:
            c = 0
            if (self.superstep_chunk >= 2 and self.gop > 1
                    and not self.keep_recon
                    and (self.entropy == "device"
                         or self.cabac_device_binarize)):
                c = max(2, min(self.superstep_chunk, 6))
            self._ring_chunk_cached = c
        return c

    @property
    def pipeline_depth(self) -> int:
        """Frames a serving loop keeps in flight: chunk + 1 with the ring
        (chunk N's collect overlaps chunk N+1's staging), else 2."""
        c = self._ring_chunk
        return c + 1 if c else 2

    def _ring_stage(self, rgb, idx: int, t0: float):
        """Stage one P frame; dispatch the chunk when it is full.
        Returns the frame's token."""
        ring = self._ring
        if ring is None:
            qp = self._eff_qp(keyframe=False)
            planes = self._host_yuv420(rgb) if self.host_color else None
            if self._spatial_nx > 1 and planes is None:
                # the spatial chunk stages host YUV planes; without them
                # the session serves per-frame spatial, as the reference's
                self._ring_chunk_cached = 0
                got = self._sp_submit_p(self._device_colour(rgb), qp)
                self._count_dispatch(t0)
                return ("sp", idx, t0, False, got)
            kind = "cabac" if self.entropy == "cabac" else "cavlc"
            ingest = "yuv" if planes is not None else "rgb"
            # a masked chunk takes each frame's plan while that frame is
            # the newest of the host luma chain
            plans = ([] if self.damage_mask and kind == "cavlc"
                     and ingest == "yuv" else None)
            ring = self._ring = _Ring(kind, ingest, qp, plans)
        else:
            planes = (self._host_yuv420(rgb) if ring.ingest == "yuv"
                      else None)
            if self._rate is not None:
                # one qp for the chunk; a reservation per frame keeps the
                # rate controller's per-frame updates aligned
                self._rate.repeat_last_reservation()
        ring.frames.append(planes if planes is not None
                           else np.ascontiguousarray(rgb))
        ring.fns.append(self._frame_num)
        if ring.plans is not None:
            if self._damage_cur_y is None:
                ring.plans = None
            else:
                plan = dmg.plan_rows(dmg.damage_grid_np(
                    self._damage_cur_y, self._damage_prev_y))
                self._damage_frac = plan.frac
                if self._rate is not None:
                    self._rate.note_damage(plan.frac)
                ring.plans.append(plan)
        token = ("ring", idx, t0, False, (ring, len(ring.frames) - 1))
        if len(ring.frames) >= self._ring_chunk:
            try:
                self._ring_dispatch(ring)
            except Exception:
                ring.error = ring.released = True
                raise
            finally:
                self._ring = None
        return token

    def _chunk_hdr_slots(self, fns: tuple, qp_delta: int):
        """The chunk's P slice-header slots, (K, R, 3) on the device,
        cached (frame_num cycles mod 16)."""
        key = (fns, qp_delta)
        got = self._chunk_hdr_cache.get(key)
        if got is None:
            slots = [self._p_hdr_slots_np(fn, qp_delta) for fn in fns]
            got = tuple(torch.from_numpy(np.stack([s[i] for s in slots])).to(
                self.device) for i in (0, 1))
            self._chunk_hdr_cache[key] = got
        return got

    def _chunk_step(self, kind: str, ingest: str, bucket: int):
        # the kernel tier and p_intra are fixed for the encoder: each step
        # is built with them, and the key needs only the rest
        key = (kind, ingest, bucket)
        step = self._chunk_steps.get(key)
        if step is None:
            step = self._chunk_steps[key] = devloop.ChunkStep(
                chunk=self._ring_chunk, pad_h=self.pad_h, pad_w=self.pad_w,
                deblock=self.deblock, entropy=kind, ingest=ingest,
                damage_bucket=bucket, device=self.device,
                budget=self._graphs, tune=self._ktune,
                p_intra=self._p_intra, spatial_shards=self._spatial_nx)
        return step

    def _ring_dispatch(self, ring) -> None:
        """Run the chunk: one step call (a graph replay on the card), the
        chunk's content stats, and each slot's prefix pull started."""
        t0 = time.perf_counter()
        qp = ring.qp
        hv = hl = rows = None
        if ring.kind == "cavlc":
            plen = (cavlc_device.META_WORDS * 4
                    + (self._p_pull_guess or 2 * self._PULL_BUCKET))
            hv, hl = self._chunk_hdr_slots(tuple(ring.fns), qp - self.qp)
        else:
            plen = (cabac_binarize.header_words(self.mb_h
                                                // self._spatial_nx)
                    + (self._cabac_p_bin_pull_guess
                       or 4 * self._CABAC_PULL_WORDS))
        # a masked chunk shares the bucket of its most damaged frame; one
        # whose bucket covers the frame runs the full-frame chunk (the
        # same bytes)
        bucket = 0
        if ring.plans and len(ring.plans) == len(ring.frames):
            b = dmg._bucket_for(max(p.rows.size for p in ring.plans),
                                self.mb_h)
            if b < self.mb_h:
                bucket = b
        if bucket:
            padded, hvs, hls = [], [], []
            for p, fn in zip(ring.plans, ring.fns):
                pr = np.concatenate([p.rows, np.full(
                    bucket - p.rows.size, p.rows[-1], np.int32)])
                v, l = self._p_hdr_slots_np(fn, qp - self.qp)
                padded.append(pr)
                hvs.append(v[pr])
                hls.append(l[pr])
            hv, hl, rows = np.stack(hvs), np.stack(hls), np.stack(padded)
            ring.dmg = (bucket, padded)
        step = self._chunk_step(ring.kind, ring.ingest, bucket)
        out = step(ring.frames, self._ref, hv, hl, rows, qp, owner=ring)
        self._ref = out.refs
        self._content_ring_dispatch(ring, out, masked=bool(bucket))
        ring.prefix = [_pinned_prefetch(f[..., :plen].contiguous())
                       for f in out.flats]
        ring.frames = None
        ring.res = out
        self._chunk_seq += 1
        ring.chunk_id = self._chunk_seq
        self._count_dispatch(t0)

    def _ring_flush(self) -> None:
        """Push a partial chunk through the per-frame path (an IDR due, or
        a collect reaching a frame whose chunk never filled)."""
        ring = self._ring
        self._ring = None
        if ring is None or ring.res is not None:
            return
        toks, cstats = [], []
        planes = [self._upload(fr) if ring.ingest == "yuv"
                  else self._device_colour(fr) for fr in ring.frames]
        for i, pl in enumerate(planes):
            t0 = time.perf_counter()
            fn = ring.fns[i]
            # the chunk's lookahead shift: frame k sees frame k + 1, the
            # last staged frame itself
            next_y = (planes[min(i + 1, len(planes) - 1)][0]
                      if self._ktune == "hq" else None)
            if self._spatial_nx > 1:
                # as the reference's: the per-frame spatial step, no
                # lookahead, the row gate from the host chain's newest pair
                toks.append(("sp", self._sp_submit_p(pl, ring.qp, fn)))
            elif ring.kind == "cavlc":
                plan = (ring.plans[i] if ring.plans and len(ring.plans) > i
                        else None)
                toks.append(self._submit_p_cavlc(pl, ring.qp, fn, plan,
                                                 next_y))
            else:
                toks.append(("cabac_p", self._submit_cabac_p(
                    pl, ring.qp, frame_num=fn, next_y=next_y)))
            self._count_dispatch(t0)
            cstats.append(self._content_last)
            self._content_last = None
        ring.frames = None
        ring.pf = toks
        ring.content_pf = cstats

    def _ring_collect(self, payload) -> bytes:
        ring, slot = payload
        try:
            if ring.error:
                raise RuntimeError("super-step chunk dispatch failed; frame "
                                   "lost (an IDR resync follows)")
            if ring.res is None and ring.pf is None:
                self._ring_flush()       # the chunk never filled: drain
            if ring.pf is not None:
                return self._collect(*ring.pf[slot])
            fn = ring.fns[slot]
            if ring.kind == "cabac":
                return self._ring_collect_cabac(ring, slot, fn)
            if ring.dmg is not None:
                return self._ring_collect_masked(ring, slot, fn)
            return self._ring_collect_cavlc(ring, slot, fn)
        finally:
            ring.collected += 1
            if ring.collected >= len(ring.fns):
                ring.released = True

    def _ring_collect_cavlc(self, ring, slot: int, frame_num: int) -> bytes:
        qp, out = ring.qp, ring.res
        buf = _wait(ring.prefix[slot])
        if self._spatial_nx > 1:
            return self._sp_collect_flat("p", qp, 0, frame_num,
                                         out.flats[slot], buf,
                                         (out.levels(slot), out.mvs[slot]))
        meta = cavlc_device.FlatMeta(buf, self.mb_h)
        if meta.overflow:
            # the chunk's own level tensors of this frame, host-coded
            pulled = {k: _np(v) for k, v in out.levels(slot).items()}
            pulled["mv"] = _np(out.mvs[slot])
            return self._encode_p_pulled(pulled, qp, frame_num)
        self._note_qp_sum(meta.qp_sum)
        buf = self._pull_flat(out.flats[slot], buf, meta)
        return cavlc_device.assemble_annexb(buf, meta, nal_type=syn.NAL_SLICE,
                                            ref_idc=2)

    def _ring_collect_masked(self, ring, slot: int, frame_num: int) -> bytes:
        qp, out = ring.qp, ring.res
        bucket, padded = ring.dmg
        buf = _wait(ring.prefix[slot])
        meta = cavlc_device.FlatMeta(buf, bucket)
        if meta.overflow:
            return self._masked_overflow(out.levels(slot), out.mvs[slot],
                                         padded[slot], qp, frame_num)
        self._note_masked_qp_sum(meta.qp_sum, qp, bucket)
        buf = self._pull_flat(out.flats[slot], buf, meta)
        return dmg.assemble_masked_au(
            buf, meta, padded[slot], self.mb_h, self.mb_w,
            frame_num=frame_num, qp_delta=qp - self.qp,
            deblocking_idc=self._deblock_idc)

    def _ring_collect_cabac(self, ring, slot: int, frame_num: int) -> bytes:
        qp, out = ring.qp, ring.res
        if self._spatial_nx > 1:
            return self._sp_collect_bin("p", qp, 0, frame_num,
                                        out.flats[slot],
                                        _wait(ring.prefix[slot]),
                                        (out.levels(slot), out.mvs[slot]))
        args = dict(qp=qp, frame_num=frame_num, qp_delta=qp - self.qp,
                    deblocking_idc=self._deblock_idc)
        head = self._pull_binstream(out.flats[slot], ring.prefix[slot],
                                    "_p_bin")
        if head is not None:
            au = h264_cabac.encode_p_from_binstream(
                head, nr=self.mb_h, nc_mb=self.mb_w, **args)
            if au is not None:
                return au
        dense = {k: _np(v) for k, v in out.levels(slot).items()}
        dense["mv"] = _np(out.mvs[slot])
        return h264_cabac.encode_p_picture(dense, **args)

    # -- checkpoint/restore --------------------------------------------

    def export_state(self) -> dict:
        """Host-side stream lineage (schema ``models/base.CKPT_SCHEMA``):
        the reference encoder's keys, so either side imports the other's."""
        st = super().export_state()
        st.update({
            "gop_pos": self._gop_pos,
            "frame_num": self._frame_num,
            "idr_count": self._idr_count,
            "qp_offset": self.degrade_qp_offset,
            "pull_guess": self._pull_guess,
            "p_pull_guess": self._p_pull_guess,
        })
        if self._rate is not None:
            st["rate"] = {
                "level": self._rate.level,
                "ema_key": self._rate._ema[True],
                "ema_p": self._rate._ema[False],
                "step_idx": self._rate._step_idx,
                "avg": self._rate._avg,
            }
        if self._ref is not None and self.gop > 1:
            st["ref"] = tuple(p.cpu().numpy() for p in self._ref)
        return st

    def import_state(self, state: dict) -> None:
        super().import_state(state)        # geometry check + force IDR
        self._gop_pos = int(state.get("gop_pos", 0))
        self._frame_num = int(state.get("frame_num", 0))
        self._idr_count = int(state.get("idr_count", 0))
        self.degrade_qp_offset = int(state.get("qp_offset", 0))
        if state.get("pull_guess"):
            self._pull_guess = int(state["pull_guess"])
        if state.get("p_pull_guess"):
            self._p_pull_guess = int(state["p_pull_guess"])
        rate = state.get("rate")
        if rate is not None and self._rate is not None:
            self._rate.level = float(rate["level"])
            self._rate._ema[True] = rate["ema_key"]
            self._rate._ema[False] = rate["ema_p"]
            self._rate._step_idx = int(rate["step_idx"])
            self._rate._avg = rate["avg"]
            self._rate._pending.clear()    # in-flight frames are gone
        ref = state.get("ref")
        if ref is not None and self.gop > 1:
            self._ref = self._upload([np.array(p) for p in ref])

    # -- entry points ----------------------------------------------------

    def encode(self, rgb) -> EncodedFrame:
        t0 = time.perf_counter()
        if self.mode == "pcm":
            data, key = self._encode_pcm(rgb), True
        elif self.gop > 1:
            data, key = self._gop_step(rgb)
        else:
            n0 = self._rate.mark() if self._rate is not None else 0
            try:
                data = self._collect(*self._submit_idr(rgb,
                                                       self.frame_index % 2))
            except Exception:
                if self._rate is not None:
                    self._rate.rollback_to(n0)
                raise
            key = True
            if self._rate is not None:
                self._rate.update(len(data) * 8,
                                  mean_qp=self._take_mean_qp())
        ms = (time.perf_counter() - t0) * 1e3
        ef = EncodedFrame(data=data, keyframe=key,
                          frame_index=self.frame_index, codec=self.codec,
                          width=self.width, height=self.height, encode_ms=ms)
        self.frame_index += 1
        return ef

    def encode_submit(self, rgb):
        """Start encoding a frame; returns an opaque token.  The device
        work runs while the caller prepares the next frame.  PCM and the
        host-entropy modes encode the frame here, as the reference does
        (no stats contract on that path)."""
        if self.mode != "cavlc" or self.entropy not in ("device", "cabac"):
            ef = self.encode(rgb)
            self._content_last = None
            return ("sync", None, None, True, ef)
        idx = self.frame_index
        self.frame_index += 1
        t0 = time.perf_counter()
        n0 = self._rate.mark() if self._rate is not None else 0
        try:
            if self.gop == 1 or self._next_is_idr():
                if self._ring is not None:
                    # a partial chunk ahead of an IDR goes per frame: a
                    # chunk never straddles a reference-chain reset
                    self._ring_flush()
                pic_id = idx % 2 if self.gop == 1 else self._start_idr()
                kind, sub = self._submit_idr(rgb, pic_id)
                tok = (kind, idx, t0, True, sub)
            else:
                self._frame_num = (self._frame_num + 1) % 16
                if self._ring_chunk:
                    tok = self._ring_stage(rgb, idx, t0)
                else:
                    kind, sub = self._submit_p(rgb)
                    tok = (kind, idx, t0, False, sub)
        except Exception:
            if self._rate is not None:
                self._rate.rollback_to(n0)
            # a P submit may have advanced the reference already: the
            # decoder never gets this frame, so resync with an IDR
            self._force_idr = True
            raise
        if self.gop > 1:
            self._gop_pos = (self._gop_pos + 1) % self.gop
        self._content_stash(idx)
        return tok

    def encode_collect(self, token) -> EncodedFrame:
        kind, idx, t0, key, payload = token
        if kind == "sync":
            return payload
        try:
            data = self._collect(kind, payload, in_pipeline=self.gop > 1)
        except Exception:
            if self._rate is not None:
                self._rate.drop_oldest_pending()
            self._force_idr = True
            raise
        if self._rate is not None:
            self._rate.update(len(data) * 8, mean_qp=self._take_mean_qp())
        self._content_finish(token, data)
        # journey identity: a ring frame that rode a replayed chunk carries
        # the chunk's; a flushed partial ring went per frame
        chunked = (kind == "ring" and payload[0].pf is None
                   and payload[0].chunk_id is not None)
        self._journey_meta = {
            "chunk_id": payload[0].chunk_id if chunked else None,
            "slot": payload[1] if kind == "ring" else 0,
            "chunk_len": len(payload[0].fns) if chunked else 1,
            "shards": self._spatial_nx}
        ms = (time.perf_counter() - t0) * 1e3
        return EncodedFrame(data=data, keyframe=key, frame_index=idx,
                            codec=self.codec, width=self.width,
                            height=self.height, encode_ms=ms)
