"""The reference's ``ops/devloop.py`` on the card: the super-step chunk
(K P frames in one dispatch, as a captured CUDA graph: :class:`ChunkStep`,
the port of ``build_p_chunk_step``), the device-only timing loops and the
link probe.

:func:`chunk_body` is the chunk as one Python function of the port's
kernels: the ingest (under rgb ingest K9 converts all K frames in one
launch), then per frame the P stage and the loop filter, the reference
chained from each frame to the next.  Per frame the P stage is

- device CAVLC: the P core (K5), slots (K6) and packer (K7);
- CABAC: the P core and the record stream (K11p);
- damage-masked (CAVLC, yuv ingest): ``damage_mask.row_core`` over the
  frame's worklist of ``damage_bucket`` rows (K5r at the chunk's tier,
  with K14r's qp plane and the I16-in-P passes over the rows where the
  tier has them, K6, K7, K8 on the compacted stack, the row scatter K13);
- spatially sharded (``spatial_shards`` > 1, yuv ingest, row 15h): the
  spatial P body of ``parallel/batch`` (the halo pad 15e, K5p, K6 and K7
  with the shard axis or K11p per shard, K8), each frame's transport
  (nx, L), the reference's ``h264_spatial_chunk_step``.

Under ``tune`` (the kernel tier) the P stages run their hq forms; the
full tier (CAVLC only) also runs the qp plane (K14) per frame with the
1-frame lookahead over the staged luma (frame k sees frame k+1, the last
frame itself), reading the slice qp from device memory like K5, and
``p_intra`` (deblock off) the I16-in-P passes.

:class:`ChunkStep` is one chunk configuration.  On the card the step
captures the body once into a ``torch.cuda.CUDAGraph`` and replays
it for each chunk: the staged frames, the reference, the slice-header
slots, the worklists and the qp are static device tensors filled by
``copy_`` before a replay (qp through device memory, which K5 and K8
read, so one graph serves every qp).  Nothing in the body synchronises
with the host, and the library loads, nvcc builds and the CAVLC table
upload happen in a warm-up run of the body before the capture.  On the
CPU the step runs the body eagerly: that is the plain version.

A replay writes the same output tensors as the one before it, and the
encoder's pipeline dispatches chunk N+1 before chunk N's last frame is
collected; so each step keeps instances (a graph with its own static
tensors and memory pool) and replays one whose previous owner has let
its outputs go, capturing another when none has (at most
``MAX_INSTANCES``).  An encoder's steps share one :class:`GraphBudget`,
which holds their instances to ``MAX_GRAPHS`` together: a damage-masked
session has a step per bucket it visits, and a capture past the budget
first drops the least recently replayed free instance (an idle bucket's,
before the active key's).  A failed capture or replay raises: no quiet
eager or per-frame fallback.  Every capture runs through
:func:`graph_capture`, which holds Python's cycle collector off for its
duration: a dead graph (one left in a reference cycle, as a dropped
encoder's steps are) that a collection destroys mid-capture invalidates
the capture.

:func:`intra_loop`, :func:`p_loop`, :func:`cabac_intra_loop`,
:func:`inter_loop`, :func:`deblock_loop` and :func:`cabac_p_loop` are the
device-only timing loops (rows 17a-f, the reference's loops of the same
names): ``steps`` encodes of one stage on the input planes perturbed by
the loop index (K17p), a chained stage's output the next step's
reference, and a uint32 checksum summed on the card (K17c) as the only
result.  On the card one step is captured into a CUDA graph (two, one
per direction of the chained planes' ping-pong) and replayed ``steps``
times, and the checksum's 4 bytes are pulled; on the CPU the step runs
as plain calls.  :func:`measure_steady_state` differences two trip
counts into a step ms, as the reference does.

:func:`measure_link_rtt` is the link probe (row 17g): one-thread kernel
launches of a trivial loop (K17g, ``csrc/probe.cu``), timed on the host
with the 4-byte result pulled, as the reference's ``_probe_loop``.

Launch accounting: a wrapper's ``launches`` also counts the launches it
records into a graph at capture, which do not run.  :data:`captured`
holds those, :data:`replayed` the kernel launches that the replays ran
(a graph's nodes per wrapper, times its replays), so the kernels a run
launched are ``launches - captured + replayed``; :data:`loop_replays`
counts the timing loops' replayed steps by loop.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
import weakref

import numpy as np
import torch

from . import _cuda

MAX_INSTANCES = 4         # per step (graph key)
MAX_GRAPHS = 6            # per budget: an encoder's steps together

# wrapper name -> launches recorded at capture / run by replays
captured: collections.Counter = collections.Counter()
replayed: collections.Counter = collections.Counter()
# timing loop name ("intra", "p", ...) -> its captured steps replayed
loop_replays: collections.Counter = collections.Counter()


def wrappers() -> dict:
    """The kernel wrappers a captured graph (a chunk body, a timing
    loop's step) may call, by name."""
    from . import (bitmerge, cabac_binarize, cavlc_device, cavlc_p_device,
                   color, damage_mask, h264_deblock, h264_device, h264_inter,
                   level_pack)
    from . import aq
    from ..parallel import batch
    return {"intra": h264_device.encode_intra_frame_yuv,
            "cavlc_slots": cavlc_device.frame_block_slots,
            "pack": bitmerge.pack_frame,
            "pack_levels": level_pack.pack_levels,
            "binarize_intra": cabac_binarize.binarize_intra,
            "perturb": perturb,
            "tick": tick,
            "color_frames": color.rgb_to_yuv420_frames,
            "inter": h264_inter.encode_p_frame,
            "inter_rows": h264_inter.encode_p_frame_rows,
            "inter_padded": h264_inter.encode_p_frame_padded_ref,
            "halo_pad": batch.spatial_halo_pad,
            "force_skip": damage_mask.force_skip_rows,
            "cavlc_p_slots": cavlc_p_device.p_frame_slots,
            "pack_p": bitmerge.pack_p_frame,
            "binarize_p": cabac_binarize.binarize_p,
            "deblock": h264_deblock.deblock_frame,
            "scatter_rows": damage_mask.scatter_rows,
            "qp_plane": aq.qp_plane,
            "qp_plane_rows": aq.qp_plane.rows,
            "inter_rows_hq": h264_inter.encode_p_frame_rows.hq,
            "inter_rows_i16": h264_inter.encode_p_frame_rows.i16,
            "inter_hq": h264_inter.encode_p_frame.hq,
            "inter_i16": h264_inter.encode_p_frame.i16,
            "inter_merge": h264_inter.encode_p_frame.merge,
            "cavlc_p_slots_hq": cavlc_p_device.p_frame_slots.hq,
            "cavlc_p_chain": cavlc_p_device.p_frame_slots.chain,
            "pack_p_hq": bitmerge.pack_p_frame.hq,
            "intra_full": h264_device.encode_intra_frame_yuv.full,
            "intra_full_hq": h264_device.encode_intra_frame_yuv.full.hq,
            "intra_i16": h264_device.encode_intra_frame_yuv.i16,
            "intra_i16_hq": h264_device.encode_intra_frame_yuv.i16.hq,
            "intra_dc": h264_device.encode_intra_frame_yuv.dc,
            "intra_dc_hq": h264_device.encode_intra_frame_yuv.dc.hq,
            "inter_full": h264_inter.encode_p_frame.full,
            "inter_full_hq": h264_inter.encode_p_frame.full.hq,
            "inter_padded_full": h264_inter.encode_p_frame_padded_ref.full,
            "inter_padded_full_hq":
                h264_inter.encode_p_frame_padded_ref.full.hq}


def reset_counts() -> None:
    captured.clear()
    replayed.clear()
    loop_replays.clear()


class ChunkOut:
    """One chunk's outputs: ``flats`` K transport buffers (CAVLC flats or
    CABAC record streams), ``ys`` the (K, H, W) ingest luma, ``refs`` the
    reference after the last frame, and the MVs (``mvs[i]``) and level
    tensors (``levels(i)``) the host coder takes on an overflow.  Full
    frames keep them as (K, ...) stacks (``mvs``, ``lvs``, the content
    stats' inputs); a masked chunk's are per-frame compacted tensors."""

    __slots__ = ("flats", "ys", "refs", "mvs", "lvs")

    def __init__(self, flats, ys, refs, mvs, lvs):
        self.flats, self.ys, self.refs, self.mvs, self.lvs = \
            flats, ys, refs, mvs, lvs

    def levels(self, i: int) -> dict:
        if isinstance(self.lvs, dict):
            return {k: v[i] for k, v in self.lvs.items()}
        return self.lvs[i]


_LEVEL_KEYS = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")


def chunk_body(frames, ref_y, ref_cb, ref_cr, hv, hl, rows, qp: int, *,
               deblock: bool, entropy: str, ingest: str, pad_h: int,
               pad_w: int, qp_dev=None, tune: str = "off",
               p_intra: bool = False, spatial_shards: int = 1) -> ChunkOut:
    """The chunk as the port's kernels: ``frames`` is ``(rgbs,)`` (K, h,
    w, 3) under rgb ingest, else ``(ys, cbs, crs)`` padded planes;
    ``hv``/``hl`` the K frames' slice-header slots (K, rows, 3) (None
    under CABAC); ``rows`` (K, b) the damage worklists or None; ``tune``
    and ``p_intra`` the P stage's kernel tier; ``spatial_shards`` the
    shards of the spatial P body (1 = unsharded)."""
    from . import (cabac_binarize, cavlc_p_device, color, damage_mask,
                   h264_deblock, h264_inter)

    if ingest == "rgb":
        ys, cbs, crs = color.rgb_to_yuv420_frames(frames[0], pad_h, pad_w)
    else:
        ys, cbs, crs = frames
    k = ys.shape[0]
    nr, nc = pad_h // 16, pad_w // 16
    dev = ys.device
    ry, rcb, rcr = ref_y, ref_cb, ref_cr
    flats = []
    if rows is not None:
        mvs, lvs = [], []
        for i in range(k):
            # the full tier's lookahead: frame i sees i + 1, the last itself
            next_y = ys[min(i + 1, k - 1)] if tune == "hq" else None
            flat, ry, rcb, rcr, mv, _, lv = damage_mask.row_core(
                ys[i], cbs[i], crs[i], ry, rcb, rcr, rows[i], hv[i], hl[i],
                qp, tune=tune, next_y=next_y, p_intra=p_intra,
                deblock=deblock, qp_dev=qp_dev)
            flats.append(flat)
            mvs.append(mv)
            lvs.append(lv)
        return ChunkOut(flats, ys, (ry, rcb, rcr), mvs, lvs)
    i32 = dict(dtype=torch.int32, device=dev)
    mvs = torch.empty((k, nr, nc, 2), **i32)
    lvs = {"luma": torch.empty((k, nr, nc, 16, 16), **i32),
           "cb_dc": torch.empty((k, nr, nc, 4), **i32),
           "cb_ac": torch.empty((k, nr, nc, 4, 15), **i32),
           "cr_dc": torch.empty((k, nr, nc, 4), **i32),
           "cr_ac": torch.empty((k, nr, nc, 4, 15), **i32)}
    if tune == "hq":
        lvs["qp_map"] = torch.empty((k, nr, nc), **i32)
    if p_intra:
        lvs["mb_intra"] = torch.empty((k, nr, nc), dtype=torch.bool,
                                      device=dev)
        lvs["i16_dc"] = torch.empty((k, nr, nc, 16), **i32)
        lvs["i16_ac"] = torch.empty((k, nr, nc, 16, 15), **i32)
    spatial = None
    if spatial_shards > 1:
        from ..parallel import batch
        spatial = batch._spatial_encode_frame(entropy, deblock, qp,
                                              spatial_shards, tune=tune,
                                              p_intra=p_intra)
    for i in range(k):
        out = dict({key: v[i] for key, v in lvs.items()}, mv=mvs[i])
        # the full tier's lookahead: frame i sees i + 1, the last itself
        next_y = ys[min(i + 1, k - 1)] if tune == "hq" else None
        if spatial is not None:
            flat, ry, rcb, rcr, _, _ = spatial(
                ys[i], cbs[i], crs[i], ry, rcb, rcr,
                None if hv is None else hv[i], None if hl is None else hl[i],
                next_y=next_y, qp_dev=qp_dev, out=out)
            flats.append(flat)
            continue
        if entropy == "cavlc":
            flat, ny, ncb, ncr, mv, nnz, _ = \
                cavlc_p_device.encode_p_cavlc_frame(
                    ys[i], cbs[i], crs[i], ry, rcb, rcr, hv[i], hl[i], qp,
                    qp_dev=qp_dev, out=out, tune=tune, next_y=next_y,
                    p_intra=p_intra)
            filt = dict(nnz_blk=nnz)
        else:
            o = h264_inter.encode_p_frame(ys[i], cbs[i], crs[i], ry, rcb,
                                          rcr, qp, qp_dev=qp_dev, out=out,
                                          tune=tune)
            flat = cabac_binarize.binarize_p(
                o["mv"], *(o[key] for key in _LEVEL_KEYS))
            ny, ncb, ncr, mv = (o["recon_y"], o["recon_cb"], o["recon_cr"],
                                o["mv"])
            filt = dict(luma=o["luma"])
        if deblock:
            ny, ncb, ncr = h264_deblock.deblock_frame(
                ny, ncb, ncr, qp, mv=mv, qp_dev=qp_dev, **filt)
        ry, rcb, rcr = ny, ncb, ncr
        flats.append(flat)
    return ChunkOut(flats, ys, (ry, rcb, rcr), mvs, lvs)


@contextlib.contextmanager
def graph_capture(g):
    """``torch.cuda.graph(g)`` with the cycle collector off until the
    capture ends: destroying a CUDA graph while a stream captures is not
    permitted, and a collection that frees a dead one (held only by a
    reference cycle) would invalidate this capture."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g):
            yield
    finally:
        if was_on:
            gc.enable()


def capture_graph(device, run):
    """Capture ``run()`` (a body of the kernel wrappers on static device
    tensors) into a CUDA graph on ``device``: one uncaptured warm-up on a
    side stream first, where the library loads, builds, table uploads and
    K8's shared-memory attribute may synchronise (its outputs are
    dropped).  Returns (graph, out, nodes, pool_bytes): the captured
    outputs, the launches recorded per wrapper (added to
    :data:`captured`) and the growth of the reserved memory, the graph's
    pool."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    named = wrappers()
    before = {n: fn.launches for n, fn in named.items()}
    # the capture empties the allocator's cache first; so does this, so
    # that the growth below is the graph's pool
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    g = torch.cuda.CUDAGraph()
    with graph_capture(g):
        out = run()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    nodes = {n: fn.launches - before[n] for n, fn in named.items()
             if fn.launches != before[n]}
    captured.update(nodes)
    return g, out, nodes, pool_bytes


class _Instance:
    """A captured graph with its static inputs and outputs."""

    def __init__(self, step):
        self.step = step
        self.graph = None
        self.inputs = None       # (frames tuple, refs, hv, hl, rows, qp_t)
        self.out = None
        self.nodes = {}
        self.pool_bytes = 0
        self.owner = None        # weakref to the ring holding the outputs
        self.replays = 0

    def free(self) -> bool:
        o = self.owner() if self.owner is not None else None
        return o is None or getattr(o, "released", False)


class GraphBudget:
    """The captured instances of one encoder's steps, least recently
    replayed first, at most ``limit`` of them.  ``peak_bytes`` is the
    largest sum of their memory pools seen; ``captures``, ``replays``
    and ``evicted`` count over the budget's life."""

    def __init__(self, limit: int = MAX_GRAPHS):
        self.limit = int(limit)
        self.live = []
        self.captures = self.replays = self.evicted = 0
        self.peak_bytes = 0

    @property
    def pool_bytes(self) -> int:
        return sum(i.pool_bytes for i in self.live)

    def make_room(self) -> None:
        """Drop free instances, least recently replayed first, until a
        capture fits; raise when every instance is still held."""
        while len(self.live) >= self.limit:
            victim = next((i for i in self.live if i.free()), None)
            if victim is None:
                raise RuntimeError(
                    f"{len(self.live)} chunk graphs are still held "
                    "uncollected: collect (or drop) earlier tokens first")
            self.live.remove(victim)
            victim.step.instances.remove(victim)
            victim.graph = victim.inputs = victim.out = None
            self.evicted += 1

    def add(self, inst) -> None:
        self.live.append(inst)
        self.captures += 1
        self.peak_bytes = max(self.peak_bytes, self.pool_bytes)

    def use(self, inst) -> None:
        self.live.remove(inst)
        self.live.append(inst)
        self.replays += 1


class ChunkStep:
    """One chunk configuration's step: ``step(frames, refs, hv, hl, rows,
    qp, owner)`` -> :class:`ChunkOut`.  ``frames`` holds the K staged
    frames (host arrays: (y, cb, cr) padded planes under yuv ingest,
    (h, w, 3) RGB under rgb); ``refs`` the device reference planes;
    ``hv``/``hl`` the slots (K, rows, 3) and ``rows`` the worklists
    (K, b), tensors or host arrays; ``owner`` the object whose
    ``released`` attribute (or its end) frees the outputs for a later
    replay.  The caller keeps the step: its graphs hold device memory,
    within ``budget`` (a :class:`GraphBudget` shared by the caller's
    steps; a step of its own by default)."""

    def __init__(self, *, chunk: int, pad_h: int, pad_w: int,
                 deblock: bool = True, entropy: str = "cavlc",
                 ingest: str = "yuv", damage_bucket: int = 0, device=None,
                 budget: GraphBudget = None, tune: str = "off",
                 p_intra: bool = False, spatial_shards: int = 1):
        if entropy not in ("cavlc", "cabac"):
            raise ValueError(f"unknown chunk entropy {entropy!r}")
        if ingest not in ("yuv", "rgb"):
            raise ValueError(f"unknown chunk ingest {ingest!r}")
        if damage_bucket > 0 and (entropy != "cavlc" or ingest != "yuv"):
            raise ValueError("a masked chunk requires cavlc entropy and yuv "
                             "ingest")
        if tune not in ("off", "hq_noaq", "hq"):
            raise ValueError(f"unknown tune {tune!r}")
        if tune == "hq" and entropy == "cabac":
            # the record stream has no qp plumbing: the encoder keeps
            # full-tier CABAC on the per-frame host route
            raise ValueError("a tune=hq chunk requires cavlc entropy")
        if p_intra and (entropy != "cavlc" or deblock or tune == "off"):
            raise ValueError("p_intra requires tune=hq/hq_noaq, cavlc "
                             "entropy and deblock off")
        if spatial_shards > 1 and (ingest != "yuv" or damage_bucket > 0):
            raise ValueError("a spatial chunk requires yuv ingest and no "
                             "damage bucket (a masked chunk takes a single "
                             "shard)")
        self.tune, self.p_intra = tune, bool(p_intra)
        self.spatial_shards = int(spatial_shards)
        self.chunk = int(chunk)
        self.pad_h, self.pad_w = pad_h, pad_w
        self.deblock = bool(deblock)
        self.entropy, self.ingest = entropy, ingest
        self.damage_bucket = int(damage_bucket)
        self.device = torch.device(device or "cpu")
        self.budget = budget if budget is not None else GraphBudget()
        self.instances = []

    # -- inputs ----------------------------------------------------------

    def _host_inputs(self, frames, hv, hl, rows):
        """The step's inputs as CPU tensors."""
        if self.ingest == "rgb":
            fr = (torch.from_numpy(np.stack(frames)),)
        else:
            fr = tuple(torch.from_numpy(np.stack([f[i] for f in frames]))
                       for i in range(3))
        t = lambda a: None if a is None else torch.as_tensor(a)
        return fr, t(hv), t(hl), t(rows)

    def _body(self, frames, refs, hv, hl, rows, qp, qp_dev=None):
        return chunk_body(frames, *refs, hv, hl, rows, qp,
                          deblock=self.deblock, entropy=self.entropy,
                          ingest=self.ingest, pad_h=self.pad_h,
                          pad_w=self.pad_w, qp_dev=qp_dev, tune=self.tune,
                          p_intra=self.p_intra,
                          spatial_shards=self.spatial_shards)

    def run_eager(self, frames, refs, hv, hl, rows, qp: int) -> ChunkOut:
        """The body on the step's device without a graph (the plain
        version on the CPU; on the card, the reference for a replay)."""
        fr, hv, hl, rows = self._host_inputs(frames, hv, hl, rows)
        to = lambda a: None if a is None else a.to(self.device)
        return self._body(tuple(to(f) for f in fr), refs, to(hv), to(hl),
                          to(rows), int(qp))

    # -- the graph -------------------------------------------------------

    def _load(self, inst: _Instance, frames, refs, hv, hl, rows, qp: int):
        fr_t, refs_t, hv_t, hl_t, rows_t, qp_t = inst.inputs
        if self.ingest == "rgb":
            for i, f in enumerate(frames):
                fr_t[0][i].copy_(torch.from_numpy(np.ascontiguousarray(f)))
        else:
            for i, f in enumerate(frames):
                for p in range(3):
                    fr_t[p][i].copy_(torch.from_numpy(
                        np.ascontiguousarray(f[p])))
        for dst, src in zip(refs_t, refs):
            dst.copy_(src)
        for dst, src in ((hv_t, hv), (hl_t, hl), (rows_t, rows)):
            if dst is not None:
                dst.copy_(torch.as_tensor(src))
        qp_t.fill_(int(qp))

    def _capture(self, frames, refs, hv, hl, rows, qp: int) -> _Instance:
        dev = self.device
        self.budget.make_room()
        inst = _Instance(self)
        fr, hv_h, hl_h, rows_h = self._host_inputs(frames, hv, hl, rows)
        empty = lambda a: None if a is None else torch.empty(
            a.shape, dtype=a.dtype, device=dev)
        inst.inputs = (tuple(empty(f) for f in fr),
                       tuple(torch.empty_like(p) for p in refs),
                       empty(hv_h), empty(hl_h), empty(rows_h),
                       torch.empty(1, dtype=torch.int32, device=dev))
        self._load(inst, frames, refs, hv, hl, rows, qp)
        fr_t, refs_t, hv_t, hl_t, rows_t, qp_t = inst.inputs
        inst.graph, inst.out, inst.nodes, inst.pool_bytes = capture_graph(
            dev, lambda: self._body(fr_t, refs_t, hv_t, hl_t, rows_t, qp,
                                    qp_t))
        self.instances.append(inst)
        self.budget.add(inst)
        return inst

    def warm(self, frames, refs, hv, hl, qp: int) -> None:
        """Capture an unmasked instance ahead of the first chunk (the
        encoder's prewarm, on its serving thread; the card only): the
        first call then replays it.  ``refs`` are only read."""
        if self.device.type == "cuda" and not self.instances:
            self._capture(frames, refs, hv, hl, None, qp)

    def __call__(self, frames, refs, hv, hl, rows, qp: int,
                 owner) -> ChunkOut:
        if len(frames) != self.chunk:
            raise ValueError(f"{len(frames)} frames for a chunk of "
                             f"{self.chunk}")
        if self.device.type != "cuda":
            return self.run_eager(frames, refs, hv, hl, rows, qp)
        inst = next((i for i in self.instances if i.free()), None)
        if inst is None:
            if len(self.instances) >= MAX_INSTANCES:
                raise RuntimeError(
                    f"{MAX_INSTANCES} chunks of this step are still held "
                    "uncollected: collect (or drop) earlier tokens first")
            inst = self._capture(frames, refs, hv, hl, rows, qp)
        else:
            self._load(inst, frames, refs, hv, hl, rows, qp)
        inst.graph.replay()
        inst.replays += 1
        if self.spatial_shards > 1:
            ChunkStep.spatial.launches += 1
        self.budget.use(inst)
        replayed.update({n: c for n, c in inst.nodes.items()})
        inst.owner = weakref.ref(owner)
        return inst.out

    @property
    def pool_bytes(self) -> int:
        return sum(i.pool_bytes for i in self.instances)


# the spatial chunk's replays (row 15h): a graph of its bodies' kernels
ChunkStep.spatial = _cuda.Counter()


# ---------------------------------------------------------------------------
# The link probe (row 17g)
# ---------------------------------------------------------------------------

def probe_loop_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of K17g: ``steps`` adds of ``x[i % 8, i % 8]`` into
    a uint32 (as int64, masked), a one-element tensor on ``x``'s device."""
    acc = 0
    flat = x.reshape(-1).tolist()
    for i in range(int(steps)):
        acc += flat[(i % 8) * 8 + i % 8]
    return torch.tensor([acc & 0xFFFFFFFF], dtype=torch.int64)


def probe_loop(x: torch.Tensor, steps: int) -> torch.Tensor:
    """K17g: the trivial device loop of the link probe over ``x`` (8, 8)
    uint8 -> one uint32 sum (returned as int64).  CUDA tensors launch the
    one-thread kernel and pull the 4-byte result; CPU tensors run the
    plain version."""
    if tuple(x.shape) != (8, 8) or x.dtype != torch.uint8:
        raise ValueError("x must be (8, 8) uint8")
    if x.device.type == "cpu":
        return probe_loop_plain(x, steps)
    from . import _cuda
    out = torch.empty(1, dtype=torch.int32, device=x.device)
    _cuda.launch("probe", "probe_loop_launch", [x.contiguous(), out],
                 [int(steps)], x.device)
    probe_loop.launches += 1
    return out.cpu().to(torch.int64) & 0xFFFFFFFF


probe_loop.launches = 0


def measure_link_rtt(reps: int = 7, k_hi: int = 257, device=None) -> dict:
    """The host<->device round trip of one dispatch and pull: the
    reference's differencing, ``t(k) = rtt + k * step`` from a median of
    ``reps`` k=1 calls and one k=``k_hi`` call.  ``device`` None is the
    card (raises without CUDA); ``"cpu"`` times the plain loop.  Returns
    {"rtt_ms", "step_us", "samples"}.  A failing launch raises."""
    from ..models.h264 import resolve_device

    dev = resolve_device(device)
    x = torch.zeros((8, 8), dtype=torch.uint8, device=dev)
    probe_loop(x, 1)                                  # build + warm
    lo = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe_loop(x, 1)
        lo.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    probe_loop(x, k_hi)
    t_hi = time.perf_counter() - t0
    lo_sorted = sorted(lo)
    t_lo = lo_sorted[len(lo_sorted) // 2]             # median: RTT jitters
    step_s = max((t_hi - t_lo) / (k_hi - 1), 0.0)
    rtt_s = max(t_lo - step_s, 0.0)
    return {"rtt_ms": round(rtt_s * 1e3, 3),
            "step_us": round(step_s * 1e6, 3),
            "samples": [round(v * 1e3, 3) for v in lo_sorted]}


# ---------------------------------------------------------------------------
# The device-only timing loops (rows 17a-f) and their kernels K17p, K17c
# ---------------------------------------------------------------------------

def perturb_plain(y, cb, cr, i: int, out=None):
    """Plain version of K17p: ``(x + (i & 1)).clip(0, 255)`` per plane."""
    res = tuple((p.to(torch.int32) + (int(i) & 1)).clamp(0, 255)
                .to(torch.uint8) for p in (y, cb, cr))
    if out is None:
        return res
    return tuple(o.copy_(r) for o, r in zip(out, res))


def perturb(y, cb, cr, i_dev: torch.Tensor, out=None):
    """K17p: the three uint8 planes with the loop index's low bit added
    (saturating at 255), the index ``i_dev`` one int32 on the planes'
    device.  Returns new planes (``out``'s where given).  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    planes = (y, cb, cr)
    if any(p.dtype != torch.uint8 or not p.is_contiguous()
           or p.device != y.device for p in planes) or cb.shape != cr.shape:
        raise ValueError("perturb takes three contiguous uint8 planes on one "
                         "device, cb and cr of one shape")
    if i_dev.dtype != torch.int32 or i_dev.numel() != 1 \
            or i_dev.device != y.device:
        raise ValueError("i_dev must be one int32 on the planes' device")
    if y.device.type == "cpu":
        return perturb_plain(y, cb, cr, int(i_dev.reshape(-1)[0]), out)
    out = tuple(torch.empty_like(p) for p in planes) if out is None else out
    _cuda.launch("devloop", "perturb_launch", [*planes, *out, i_dev],
                 [y.numel(), cb.numel()], y.device)
    perturb.launches += 1
    return out


perturb.launches = 0


def tick_plain(acc: torch.Tensor, word: int, i_dev: torch.Tensor) -> None:
    """Plain version of K17c, in place: ``acc += word`` as uint32 (``acc``
    one int32 holding the bits) and ``i += 1``."""
    v = (int(acc.reshape(-1)[0]) + int(word)) & 0xFFFFFFFF
    acc.fill_(v - (1 << 32) if v >= 1 << 31 else v)
    i_dev.add_(1)


def tick(acc: torch.Tensor, src: torch.Tensor, offset: int,
         i_dev: torch.Tensor) -> None:
    """K17c: add element ``offset`` of the flattened ``src`` (uint8, or
    int32 taken as uint32) into the uint32 accumulator ``acc`` and advance
    the loop index ``i_dev`` (each one int32 on ``src``'s device).  CUDA
    tensors launch the one-thread kernel; CPU tensors run the plain
    version."""
    if src.dtype not in (torch.uint8, torch.int32) or not src.is_contiguous():
        raise ValueError("src must be a contiguous uint8 or int32 tensor")
    if not 0 <= offset < src.numel():
        raise ValueError(f"offset {offset} outside src")
    if src.device.type == "cpu":
        tick_plain(acc, int(src.reshape(-1)[offset]), i_dev)
        return
    _cuda.launch("devloop", "tick_launch", [src, acc, i_dev],
                 [int(offset), int(src.dtype == torch.uint8)], src.device)
    tick.launches += 1


tick.launches = 0

MAX_LOOP_GRAPHS = 8       # loop entries kept captured (LRU)
_loop_graphs: collections.OrderedDict = collections.OrderedDict()
_RECON = ("recon_y", "recon_cb", "recon_cr")


def _planes_of(ts):
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError("the loops take tensors on the device they run on")
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("every input must be on one device")
    return dev


def _run_loop(name: str, static: tuple, body, inputs, refs, steps: int,
              eager: bool, full: bool):
    """``steps`` runs of ``body(i_dev, acc, src_refs, dst_refs) ->
    transport``, the chained planes ping-ponged between two sets (the
    caller's ``refs``, copied first, are never written).  On the card one
    step is captured as a CUDA graph (two, one per ping-pong direction,
    for a chained loop), kept for later calls on the same tensors, and
    replayed ``steps`` times; then the 4-byte checksum is pulled.  On the
    CPU, or with ``eager``, the step runs as kernel (or plain) calls.
    Returns the uint32 checksum; with ``full``, (checksum, the last
    step's transport, the final chained planes), copies."""
    steps = int(steps)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    dev = _planes_of(list(inputs) + list(refs))
    i32 = dict(dtype=torch.int32, device=dev)
    if dev.type == "cpu" or eager:
        acc, i_dev = torch.zeros(1, **i32), torch.zeros(1, **i32)
        sets = [tuple(r.clone() for r in refs),
                tuple(torch.empty_like(r) for r in refs)]
        last = None
        for k in range(steps):
            last = body(i_dev, acc, sets[k % 2], sets[(k + 1) % 2])
        final = sets[steps % 2]
    else:
        key = (name, static, dev) + tuple(
            (t.data_ptr(), tuple(t.shape), t.dtype)
            for t in list(inputs) + list(refs))
        entry = _loop_graphs.pop(key, None)
        if entry is None:
            while len(_loop_graphs) >= MAX_LOOP_GRAPHS:
                _loop_graphs.popitem(last=False)
            acc, i_dev = torch.zeros(1, **i32), torch.zeros(1, **i32)
            sets = [tuple(torch.empty_like(r) for r in refs)
                    for _ in range(2)]
            graphs = []
            for g in range(2 if refs else 1):
                graphs.append(capture_graph(
                    dev, lambda g=g: body(i_dev, acc, sets[g], sets[1 - g]))
                    [:3])
            # the inputs are held so that their addresses stay theirs
            entry = (graphs, acc, i_dev, sets, tuple(inputs) + tuple(refs))
        _loop_graphs[key] = entry
        graphs, acc, i_dev, sets, _ = entry
        acc.zero_()
        i_dev.zero_()
        for dst, src in zip(sets[0], refs):
            dst.copy_(src)
        for k in range(steps):
            graphs[k % len(graphs)][0].replay()
        loop_replays[name] += steps
        for g, (_, _, nodes) in enumerate(graphs):
            reps = (steps - g + len(graphs) - 1) // len(graphs)
            replayed.update({n: c * reps for n, c in nodes.items()})
        last = graphs[(steps - 1) % len(graphs)][1] if steps else None
        final = sets[steps % 2]
    value = np.uint32(int(acc.reshape(-1)[0]) & 0xFFFFFFFF)   # the pull
    if full:
        return (value, None if last is None else last.clone(),
                tuple(t.clone() for t in final))
    return value


def intra_loop(y, cb, cr, hv, hl, steps: int, qp: int,
               i16_modes: str = "auto", *, eager: bool = False,
               full: bool = False):
    """Row 17a: ``steps`` intra CAVLC frame encodes (K17p, K1, K2, K3,
    K17c a step) of the perturbed planes; returns the uint32 sum of each
    step's flat byte ``META_WORDS * 4`` (the reference's checksum).
    ``i16_modes``: K1's mode set.  ``eager`` runs the kernels without the
    graph (on the card, the replay's reference)."""
    from . import cavlc_device, h264_device
    from .bitmerge import META_WORDS

    def body(i_dev, acc, src, dst):
        lv = h264_device.encode_intra_frame_yuv(*perturb(y, cb, cr, i_dev),
                                                qp, i16_modes=i16_modes)
        flat = cavlc_device.encode_levels(lv, hv, hl, qp)
        tick(acc, flat, META_WORDS * 4, i_dev)
        return flat

    return _run_loop("intra", (qp, i16_modes), body, (y, cb, cr, hv, hl), (),
                     steps, eager, full)


def p_loop(y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl, steps: int, qp: int,
           deblock: bool = True, *, eager: bool = False,
           full: bool = False):
    """Row 17b: ``steps`` P CAVLC frame encodes (K17p, K5, K6, K7, K8
    with ``deblock``, K17c a step), each step's (filtered) recon the next
    step's reference; the checksum sums flat byte ``META_WORDS * 4``.
    The caller's references are only read (the reference measures two
    trip counts from the same ones)."""
    from . import cavlc_p_device, h264_deblock
    from .bitmerge import META_WORDS

    def body(i_dev, acc, src, dst):
        keep = None if deblock else dict(zip(_RECON, dst))
        flat, ry, rcb, rcr, mv, nnz, _ = cavlc_p_device.encode_p_cavlc_frame(
            *perturb(y, cb, cr, i_dev), *src, hv, hl, qp, out=keep)
        if deblock:
            h264_deblock.deblock_frame(ry, rcb, rcr, qp, nnz_blk=nnz, mv=mv,
                                       out=dst)
        tick(acc, flat, META_WORDS * 4, i_dev)
        return flat

    return _run_loop("p", (qp, bool(deblock)), body, (y, cb, cr, hv, hl),
                     (ref_y, ref_cb, ref_cr), steps, eager, full)


def cabac_intra_loop(y, cb, cr, steps: int, qp: int, i16_modes: str = "auto",
                     binarize: bool = False, *, eager: bool = False,
                     full: bool = False):
    """Row 17c: ``steps`` CABAC device stages of an intra frame (K17p, K1,
    then K10 ``pack_levels`` or, with ``binarize``, K11i, and K17c); the
    checksum sums each transport's word 2 (its payload words);
    ``i16_modes``: K1's mode set."""
    from . import cabac_binarize, h264_device, level_pack

    def body(i_dev, acc, src, dst):
        lv = h264_device.encode_intra_frame_yuv(*perturb(y, cb, cr, i_dev),
                                                qp, i16_modes=i16_modes)
        if binarize:
            buf = cabac_binarize.binarize_intra(
                lv["luma_dc"], lv["luma_ac"], lv["cb_dc"], lv["cb_ac"],
                lv["cr_dc"], lv["cr_ac"], lv["pred_mode"], lv["mb_i4"],
                lv["i4_modes"], lv["luma_i4"])
        else:
            buf = level_pack.pack_levels(lv, level_pack.INTRA_KEYS)
        tick(acc, buf, 2, i_dev)
        return buf

    return _run_loop("cabac_intra", (qp, i16_modes, bool(binarize)), body,
                     (y, cb, cr), (), steps, eager, full)


def inter_loop(y, cb, cr, ref_y, ref_cb, ref_cr, steps: int, qp: int,
               refine: str = "alt", *, eager: bool = False,
               full: bool = False):
    """Row 17d: ``steps`` P cores alone (K17p, K5, K17c), the recon
    chained as the next reference; the checksum sums each step's luma
    level ``[0, 0, 0, 0]`` (MB (0, 0), 4x4 block 0, coefficient 0) as
    uint32.  ``refine="full"``: the reference's round-5 refinement (every
    luma line in the re-rank and subpel stages)."""
    from . import h264_inter

    def body(i_dev, acc, src, dst):
        out = h264_inter.encode_p_frame(*perturb(y, cb, cr, i_dev), *src, qp,
                                        refine=refine,
                                        out=dict(zip(_RECON, dst)))
        tick(acc, out["luma"], 0, i_dev)
        return out["luma"]

    return _run_loop("inter", (qp, refine), body, (y, cb, cr),
                     (ref_y, ref_cb, ref_cr), steps, eager, full)


def deblock_loop(y, cb, cr, steps: int, qp: int, group: int = 0, *,
                 eager: bool = False, full: bool = False):
    """Row 17e: ``steps`` loop-filter passes with intra bS (K17p, K8,
    K17c), each on the previous pass's perturbed output; the checksum
    sums each output's luma ``[0, 0]``.  ``group`` takes the reference's
    values (0 auto, 1 the per-column scan, >1 a wavefront group): they
    are TPU schedules of one function, and K8 has one schedule, so every
    value gives the same output."""
    from . import h264_deblock

    if int(group) < 0:
        raise ValueError("group must be >= 0")

    def body(i_dev, acc, src, dst):
        h264_deblock.deblock_frame(*perturb(*src, i_dev), qp, out=dst)
        tick(acc, dst[0], 0, i_dev)
        return dst[0]

    return _run_loop("deblock", (qp,), body, (), (y, cb, cr), steps, eager,
                     full)


def cabac_p_loop(y, cb, cr, ref_y, ref_cb, ref_cr, steps: int, qp: int,
                 deblock: bool = True, binarize: bool = False, *,
                 eager: bool = False, full: bool = False):
    """Row 17f: ``steps`` CABAC device stages of a P frame (K17p, K5, K8
    with ``deblock``, then K10 or, with ``binarize``, K11p, and K17c),
    recon-chained like :func:`p_loop`; the checksum sums each transport's
    word 2."""
    from . import cabac_binarize, h264_deblock, h264_inter, level_pack

    def body(i_dev, acc, src, dst):
        out = h264_inter.encode_p_frame(
            *perturb(y, cb, cr, i_dev), *src, qp,
            out=None if deblock else dict(zip(_RECON, dst)))
        if deblock:
            h264_deblock.deblock_frame(*(out[k] for k in _RECON), qp,
                                       mv=out["mv"], luma=out["luma"],
                                       out=dst)
        if binarize:
            buf = cabac_binarize.binarize_p(
                out["mv"], out["luma"], out["cb_dc"], out["cb_ac"],
                out["cr_dc"], out["cr_ac"])
        else:
            buf = level_pack.pack_levels(out, level_pack.P_KEYS)
        tick(acc, buf, 2, i_dev)
        return buf

    return _run_loop("cabac_p", (qp, bool(deblock), bool(binarize)), body,
                     (y, cb, cr), (ref_y, ref_cb, ref_cr), steps, eager,
                     full)


def measure_steady_state(loop_fn, *, budget_s: float = 60.0,
                         k_lo: int = 4) -> dict:
    """Run ``loop_fn(steps) -> checksum`` at two trip counts and difference
    (the reference's host code): ``t(k) = fixed + k * step``.
    ``loop_fn`` must block until the checksum is on the host.  Returns
    {"step_ms", "fps", "k_hi"}; the trip counts fit ``budget_s``."""
    loop_fn(1)                                   # build, capture, warm
    t0 = time.perf_counter()
    loop_fn(k_lo)
    t_lo_probe = time.perf_counter() - t0
    # the two timed() calls below run ~2 * 2 * k_hi steps: one k_hi call
    # is sized at ~budget/5, never above what the budget buys
    per_step_guess = max(t_lo_probe / k_lo, 1e-5)
    k_budget = int(0.2 * budget_s / per_step_guess)
    k_hi = max(k_lo + 1, min(k_budget, 4096))

    def timed(k, reps=2):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            loop_fn(k)
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo = timed(k_lo)
    t_hi = timed(k_hi)
    step_s = max((t_hi - t_lo) / (k_hi - k_lo), 1e-9)
    return {"step_ms": round(step_s * 1e3, 3),
            "fps": round(1.0 / step_s, 1),
            "k_hi": k_hi}
