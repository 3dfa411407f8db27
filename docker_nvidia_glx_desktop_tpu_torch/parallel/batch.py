"""Multi-session batches on one card: the MJPEG session batch and the
H.264 session steps (rows 15b-15d).

The port of the reference's ``parallel/batch.py``.  There, sessions and
restart strips (or MB-row shards) are the axes of a device mesh; a
single device plans the mesh (1, 1), every session on it.  Here the
session axis is a grid axis of the kernels themselves.

MJPEG (``_session_transform``, ``batch_encode_step``,
``assemble_session_jpeg``): on one
card they are grid axes of the same three kernels as the single encoder
(``ops/jpeg_device``: K16a over S frames, K16b and K16c over S sessions
of ``spatial`` strips each).  Each strip starts its DC predictors at 0 and
packs into its own buffer, exactly JPEG's restart-interval contract, so a
session's JPEG is its strips joined with RSTn markers; the strips'
histograms are summed per session (the reference's psum over its spatial
axis), so every strip of a session packs with one set of tables.

H.264 (``h264_batch_encode_step``, ``h264_p_batch_step``,
``h264_p_chunk_batch_step``): S sessions' frames stacked (S, H, W) run
through the single-session kernels with a session grid axis — the intra
core K1, slot coder K2 and packer K3 for an IDR tick (15b); the P core
K5, P slot coder K6, P packer K7 and, where asked, the loop filter K8
for a P tick (15c) — and a chunk of K P ticks is one replay of a
captured CUDA graph of K such bodies (15d).  Each session packs into its
own flat buffer (its own overflow flag and caps) under one set of slice
headers; on one device the reference's halo is edge padding, which is
what the P core's clamped search already does.  The steps run at one
fixed qp and no rate control or content stats, as the reference's.
CPU tensors run the plain versions session by session
(:func:`h264_intra_batch_plain`, :func:`h264_p_batch_plain`).

Single-session spatial shards (rows 15e-15h, ``make_spatial_mesh`` ...
``h264_spatial_chunk_step``): one frame's MB rows over shard devices
that may repeat one card; see the section's comment below.

The host helpers (``geometry_bucket`` ... ``feasible_spatial_shards``)
are the reference's arithmetic, copied.
"""

from __future__ import annotations

import threading
import time
from typing import Tuple

import numpy as np
import torch

from ..models.h264 import resolve_device
from ..models.mjpeg import headers
from ..obs import metrics as obsm
from ..obs.trace import next_frame_id, tracer
from ..ops import _cuda, bitpack, jpeg_device, quant

# Per-step dispatch histogram: how long the host spends handing one
# batched tick to the device (the first call includes the kernel build
# and, for a chunk step, the graph capture).
_M_DISPATCH = obsm.histogram(
    "dngd_batch_step_dispatch_ms",
    "Host-side dispatch time of one batched device step", ("step",))

# Batched-path spans land in their own trace track ('batch'), which the
# serving-budget ledger accounts when a batch path is what serves.
_TRACER = tracer("batch")


# One process, one card, one legacy default stream: a CUDA graph capture
# fails if another thread launches or copies on the card meanwhile.  The
# batch managers (one encode thread per geometry bucket) hold this lock
# around each tick's launches and pulls; the buckets' device work
# serializes anyway, their host work (capture, colour, muxing) does not.
DEVICE_LOCK = threading.RLock()


# -- degraded-geometry buckets (resilience/degrade) ----------------------
# Batched serving groups sessions by PADDED geometry (one step per
# bucket, see web/multisession.BucketedStreamManager), so degraded
# geometries are drawn from a fixed scale ladder and snapped to the MB
# grid: every session degraded to the same level shares one bucket.

DEGRADE_SCALES: Tuple[float, ...] = (1.0, 0.75, 0.5)


def geometry_bucket(width: int, height: int) -> Tuple[int, int]:
    """The (pad_h, pad_w) bucket key a raw geometry encodes under —
    the same MB padding the batch managers group sessions by."""
    return (-(-height // 16) * 16, -(-width // 16) * 16)


def degraded_geometry(width: int, height: int, level: int,
                      min_dim: int = 64) -> Tuple[int, int]:
    """The (w, h) for degradation ``level`` (0 = native) of a native
    geometry: scaled by :data:`DEGRADE_SCALES`, floored to the MB grid,
    and clamped to ``min_dim``."""
    scale = DEGRADE_SCALES[max(0, min(level, len(DEGRADE_SCALES) - 1))]
    if scale >= 1.0:
        # level 0 IS the native geometry
        return width, height
    w = max(min_dim, int(width * scale) // 16 * 16)
    h = max(min_dim, int(height * scale) // 16 * 16)
    return w, h


# -- elastic failover planning (resilience/continuity) --------------------

def replan_mesh(n_sessions: int, n_devices: int, pad_h: int,
                want_nx: int = 1) -> Tuple[int, int]:
    """The N->N-1 re-bucketing rule: the largest (ns, nx) shape that
    fits ``n_devices`` surviving devices, with ``ns`` dividing the
    session batch and the MB rows splitting over ``nx``.  Prefers the
    spatial extent the caller had (``want_nx``)."""
    if n_devices < 1:
        raise ValueError("no surviving devices to replan onto")
    best = (1, 1)
    for nx in range(min(max(want_nx, 1), n_devices), 0, -1):
        if pad_h % (16 * nx):
            continue
        ns = n_devices // nx
        while ns > 1 and n_sessions % ns:
            ns -= 1
        if ns * nx > best[0] * best[1]:
            best = (ns, nx)
    return best


def elastic_degrade_level(n_sessions: int, n_chips: int) -> int:
    """Recommended degradation-ladder level after device loss: 0 while
    devices >= sessions; one level per halving of the device:session
    ratio after that, capped at the ladder depth."""
    if n_chips >= n_sessions or n_chips < 1:
        return 0
    level = 0
    while n_chips * (2 ** level) < n_sessions \
            and level < len(DEGRADE_SCALES) - 1:
        level += 1
    return level


def p_halo_feasible(frame_h: int, nx: int) -> bool:
    """True when every spatial shard is tall enough to donate the chroma
    halo the P step's motion window needs."""
    from ..ops.h264_inter import _PAD

    rows_local = (frame_h // 16) // max(nx, 1)
    return nx == 1 or 8 * rows_local >= _PAD


def feasible_spatial_shards(pad_h: int, want: int,
                            n_devices: int) -> int:
    """Clamp a requested spatial shard count to what the geometry
    supports: ``nx`` must divide the MB rows evenly and leave each shard
    tall enough for the P halo.  Prefers the smallest feasible count >=
    ``want``, else the largest feasible one below it."""
    rows = max(pad_h // 16, 1)
    want = max(int(want), 1)
    cands = [n for n in range(1, max(int(n_devices), 1) + 1)
             if rows % n == 0 and p_halo_feasible(pad_h, n)]
    up = [n for n in cands if n >= want]
    return min(up) if up else max(cands)


class BatchStep:
    """``step(frames, *tables) -> (packed, totals, hists)`` for S frames
    of one geometry; ``transform`` and ``entropy`` are its two halves."""

    def __init__(self, frame_h: int, frame_w: int, quality: int, spatial: int,
                 device):
        self.frame_h, self.frame_w, self.spatial = frame_h, frame_w, spatial
        self.device = device
        self.luma_q, self.chroma_q = quant.jpeg_quality_tables(quality)

    def transform(self, frames):
        """(S, H, W, 3) uint8 frames -> levels (``ops/jpeg_device``
        layout): K16a over the session axis (the reference's vmapped
        ``_session_transform``; its strips are whole MCU rows, so one
        transform of the frame gives every strip's levels)."""
        t = torch.as_tensor(np.ascontiguousarray(frames, np.uint8)) \
            if not isinstance(frames, torch.Tensor) else frames
        t = t.to(self.device).contiguous()
        if tuple(t.shape[1:]) != (self.frame_h, self.frame_w, 3):
            raise ValueError(f"frames {tuple(t.shape)} are not "
                             f"(S, {self.frame_h}, {self.frame_w}, 3)")
        return jpeg_device.jpeg_transform(t, self.luma_q, self.chroma_q,
                                          self.frame_h, self.frame_w)

    def entropy(self, y, cb, cr, *tables):
        """Given levels and the 8 dense table arrays: (packed (S, nx,
        bytes) uint8, totals (S, nx) int32, histograms (dc_y, ac_y, dc_c,
        ac_c), each (S, n), summed over a session's strips)."""
        tab = jpeg_device.table_tensor(tables, self.device)
        hist = jpeg_device.jpeg_analyze(y, cb, cr, self.spatial)
        packed, totals = jpeg_device.jpeg_pack(y, cb, cr, tab, self.spatial)
        return packed, totals, jpeg_device.split_hists(hist)

    def __call__(self, frames, *tables):
        return self.entropy(*self.transform(frames), *tables)


def batch_encode_step(frame_h: int, frame_w: int, quality: int = 85,
                      spatial: int = 1, device=None) -> BatchStep:
    """The multi-session MJPEG step on one card (the card by default;
    ``"cpu"`` runs the plain versions).

    Returns step(frames, *tables) -> (packed, totals, hists): frames
    (S, H, W, 3) uint8; tables the 8 dense arrays of
    ``ops/jpeg_device.dense_tables``; packed (S, spatial, bytes) with
    each strip's first ``ceil(totals / 8)`` bytes meaningful."""
    if frame_h % (16 * spatial):
        raise ValueError("frame height must split into MCU rows")
    if frame_w % 16:
        raise ValueError("frame width must be a multiple of 16")
    return BatchStep(frame_h, frame_w, quality, spatial,
                     resolve_device(device))


def assemble_session_jpeg(packed_shards, totals, tables, width: int,
                          height: int, quality: int = 85) -> bytes:
    """One session's JPEG from its strips: each strip 1-padded to a byte
    and 0xFF-stuffed, joined with RST0..RST7 markers (cycling) under a
    DRI of one strip's MCUs."""
    nx = len(packed_shards)
    restart_interval = (width // 16) * ((height // 16) // nx) if nx > 1 else 0
    luma_q, chroma_q = quant.jpeg_quality_tables(quality)
    parts = [headers(width, height, luma_q, chroma_q, tables,
                     restart_interval)]
    for i, (shard, nbits) in enumerate(zip(packed_shards, totals)):
        scan = bitpack.finalize_bytes(shard, int(nbits), pad_bit=1)
        parts.append(bitpack.jpeg_stuff_bytes(scan))
        if i < nx - 1:
            parts.append(bytes([0xFF, 0xD0 + (i % 8)]))
    parts.append(b"\xff\xd9")
    return b"".join(parts)


# ---------------------------------------------------------------------------
# H.264 session steps (rows 15b-15d)
# ---------------------------------------------------------------------------

class ShardOverflow(ValueError):
    """A session's flat buffer overflowed the static caps: its AU cannot
    be assembled from the device bits (the manager drops the frame)."""


def _planes(a, device) -> torch.Tensor:
    """A host array or tensor -> a contiguous uint8 tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, np.uint8))
    return t.to(device).contiguous()


def _slots(a, device) -> torch.Tensor:
    """Header slots (uint32 values or int32 lengths) -> int32 on
    ``device`` (values keep their bit patterns)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


class _Step:
    """A batched step: ``__call__`` times the dispatch into the
    ``dngd_batch_step_dispatch_ms`` histogram and the 'batch' trace
    track (the reference's ``_timed_step``)."""

    kind = ""

    def __init__(self, frame_h: int, frame_w: int, qp: int, device):
        if frame_h % 16 or frame_w % 16:
            raise ValueError("frame geometry must be MB-aligned")
        if not 0 <= int(qp) <= 51:
            raise ValueError(f"qp {qp} outside 0..51")
        self.frame_h, self.frame_w, self.qp = frame_h, frame_w, int(qp)
        self.nr, self.nc = frame_h // 16, frame_w // 16
        self.device = resolve_device(device)
        self._child = _M_DISPATCH.labels(self.kind)
        self._stage = f"batch-dispatch-{self.kind}"

    def _check(self, y) -> None:
        want = (self.frame_h, self.frame_w)
        if y.dim() != 3 or tuple(y.shape[1:]) != want:
            raise ValueError(f"planes {tuple(y.shape)} are not (S, "
                             f"{want[0]}, {want[1]})")

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._run(*args, **kwargs)
        dur = time.perf_counter() - t0
        self._child.observe(dur * 1e3)
        _TRACER.record_span(self._stage, t0, dur, next_frame_id())
        return out


def _intra_body(y, cb, cr, hv, hl, qp: int, with_recon: bool):
    """15b on stacked planes: K1, K2 and K3 with the session axis."""
    from ..ops import bitmerge, cavlc_device, h264_device

    lv = h264_device.encode_intra_frame_yuv(y, cb, cr, qp)
    slots = cavlc_device.frame_block_slots(
        {k: lv[k] for k in cavlc_device._LEVEL_KEYS})
    flat = bitmerge.pack_frame(*slots, hv, hl)[:, None]
    if with_recon:
        return flat, lv["recon_y"], lv["recon_cb"], lv["recon_cr"]
    return flat


def _p_body(y, cb, cr, ry, rcb, rcr, hv, hl, qp: int, deblock: bool):
    """15c on stacked planes: K5, K6, K7 (and K8) with the session axis.
    The references are only read; the new ones are new tensors."""
    from ..ops import bitmerge, cavlc_p_device, h264_deblock, h264_inter

    out = h264_inter.encode_p_frame(y, cb, cr, ry, rcb, rcr, qp)
    slots = cavlc_p_device.p_frame_slots(out)
    flat = bitmerge.pack_p_frame(*slots[:6], hv, hl)[:, None]
    ny, ncb, ncr = out["recon_y"], out["recon_cb"], out["recon_cr"]
    if deblock:
        ny, ncb, ncr = h264_deblock.deblock_frame(
            ny, ncb, ncr, qp, nnz_blk=slots[6], mv=out["mv"])
    return flat, ny, ncb, ncr


class IntraBatchStep(_Step):
    """Row 15b: ``step(y, cb, cr, idr_parity=0)`` -> flats (S, 1, L)
    uint8 — each session's flat buffer (``ops/bitmerge`` layout) — and,
    ``with_recon``, the recon planes (S, H, W), (S, H/2, W/2) x 2 on the
    device.  Two header-slot sets alternate ``idr_pic_id`` between
    consecutive IDR ticks (``idr_parity``), both on the device."""

    kind = "h264_intra"
    launches = 0

    def __init__(self, frame_h, frame_w, qp, with_recon, device):
        super().__init__(frame_h, frame_w, qp, device)
        from ..ops import cavlc_device

        self.with_recon = bool(with_recon)
        self.slots = []
        for pid in (0, 1):
            hv, hl = cavlc_device.slice_header_slots(
                self.nr, self.nc, frame_num=0, idr_pic_id=pid)
            self.slots.append((_slots(hv, self.device),
                               _slots(hl, self.device)))

    def _run(self, y, cb, cr, idr_parity: int = 0):
        y, cb, cr = (_planes(a, self.device) for a in (y, cb, cr))
        self._check(y)
        hv, hl = self.slots[idr_parity & 1]
        out = _intra_body(y, cb, cr, hv, hl, self.qp, self.with_recon)
        if self.device.type == "cuda":
            IntraBatchStep.launches += 1
        return out


class PBatchStep(_Step):
    """Row 15c: ``step(y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl)`` ->
    (flats (S, 1, L), ref_y', ref_cb', ref_cr'): every session's P frame
    against its own reference, the new references left on the device
    (loop-filtered with ``deblock``)."""

    kind = "h264_p"
    launches = 0

    def __init__(self, frame_h, frame_w, qp, deblock, device):
        super().__init__(frame_h, frame_w, qp, device)
        self.deblock = bool(deblock)

    def _run(self, y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl):
        dev = self.device
        y, cb, cr, ref_y, ref_cb, ref_cr = (
            _planes(a, dev) for a in (y, cb, cr, ref_y, ref_cb, ref_cr))
        self._check(y)
        out = _p_body(y, cb, cr, ref_y, ref_cb, ref_cr, _slots(hv, dev),
                      _slots(hl, dev), self.qp, self.deblock)
        if dev.type == "cuda":
            PBatchStep.launches += 1
        return out


class PChunkBatchStep(_Step):
    """Row 15d: ``step(ys, cbs, crs, ref_y, ref_cb, ref_cr, hv, hl)`` ->
    (flats (S, K, 1, L), ref_y', ref_cb', ref_cr'), ``ys`` (S, K, H, W)
    and ``hv``/``hl`` the K frames' slots (K, R, 3); equal to K calls of
    :class:`PBatchStep`.

    On the card the K bodies are captured once into a CUDA graph (after
    an uncaptured warm-up that builds and loads the kernels, uploads the
    CAVLC tables and raises K8's shared-memory limit) and each call is a
    replay: the frames, references and slots are copied into the graph's
    static inputs first.  The references are double-buffered: the graph
    reads its input planes and writes its output planes, never the same
    memory.  A replay overwrites the previous replay's outputs, so a call
    raises while the previous chunk is still held — its caller pulls the
    flats and calls :meth:`release` first.  On the CPU the body runs
    eagerly (the plain version)."""

    kind = "h264_p_chunk"
    launches = 0

    def __init__(self, frame_h, frame_w, chunk, qp, deblock, device):
        super().__init__(frame_h, frame_w, qp, device)
        if int(chunk) < 1:
            raise ValueError("a chunk takes at least one frame")
        self.chunk = int(chunk)
        self.deblock = bool(deblock)
        self.graph = None
        self.inputs = None
        self.out = None
        self.nodes = {}
        self.pool_bytes = 0
        self.replays = 0
        self.held = False
        self.sessions = None

    def body(self, ys, cbs, crs, ry, rcb, rcr, hv, hl):
        """The K bodies on the stacks ``ys`` (S, K, H, W): frame k's
        planes are gathered into (S, H, W) on the device."""
        flats = []
        for k in range(ys.shape[1]):
            flat, ry, rcb, rcr = _p_body(
                ys[:, k].contiguous(), cbs[:, k].contiguous(),
                crs[:, k].contiguous(), ry, rcb, rcr, hv[k], hl[k], self.qp,
                self.deblock)
            flats.append(flat)
        return torch.stack(flats, 1), ry, rcb, rcr

    def release(self) -> None:
        """The caller has pulled the last chunk's flats: the next replay
        may overwrite them."""
        self.held = False

    def _host(self, ys, cbs, crs, hv, hl):
        """The host inputs as tensors: (S, K, ...) planes, int32 slots."""
        fm = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint8))
        if (np.shape(ys)[1] != self.chunk
                or tuple(np.shape(ys)[2:]) != (self.frame_h, self.frame_w)):
            raise ValueError(f"frames {np.shape(ys)} are not (S, "
                             f"{self.chunk}, {self.frame_h}, "
                             f"{self.frame_w})")
        return (fm(ys), fm(cbs), fm(crs), _slots(hv, "cpu"),
                _slots(hl, "cpu"))

    def _capture(self, host, refs) -> None:
        from ..ops import devloop

        dev = self.device
        self.inputs = tuple(torch.empty(h.shape, dtype=h.dtype, device=dev)
                            for h in host) \
            + tuple(torch.empty_like(r) for r in refs)
        self._load(host, refs)
        ys, cbs, crs, hv, hl, ry, rcb, rcr = self.inputs
        self.graph, self.out, self.nodes, self.pool_bytes = \
            devloop.capture_graph(dev, lambda: self.body(
                ys, cbs, crs, ry, rcb, rcr, hv, hl))

    def _load(self, host, refs) -> None:
        for dst, src in zip(self.inputs, tuple(host) + tuple(refs)):
            dst.copy_(src)

    def _run(self, ys, cbs, crs, ref_y, ref_cb, ref_cr, hv, hl):
        if self.held:
            raise RuntimeError(
                "the previous chunk's flats are still held: pull them and "
                "release() the step before the next replay overwrites them")
        host = self._host(ys, cbs, crs, hv, hl)
        refs = tuple(_planes(r, self.device)
                     for r in (ref_y, ref_cb, ref_cr))
        if self.device.type != "cuda":
            self.held = True
            return self.body(*host[:3], *refs, *host[3:])
        from ..ops import devloop

        s = host[0].shape[0]
        if self.graph is not None and s != self.sessions:
            raise ValueError(f"{s} sessions for a step captured with "
                             f"{self.sessions}")
        if self.graph is None:
            self._capture(host, refs)
            self.sessions = s
        else:
            self._load(host, refs)
        self.graph.replay()
        self.replays += 1
        devloop.replayed.update(self.nodes)
        PChunkBatchStep.launches += 1
        self.held = True
        return self.out


def h264_batch_encode_step(frame_h: int, frame_w: int, qp: int = 26,
                           with_recon: bool = False, device=None):
    """The multi-session H.264 CAVLC IDR step (row 15b) on one card (the
    card by default; ``"cpu"`` runs the plain versions).  Returns
    (step, rows_local): see :class:`IntraBatchStep`; ``rows_local`` is
    every MB row (one device, one spatial shard)."""
    step = IntraBatchStep(frame_h, frame_w, qp, with_recon, device)
    return step, step.nr


def h264_p_batch_step(frame_h: int, frame_w: int, qp: int = 26,
                      deblock: bool = False, device=None):
    """The multi-session P step (row 15c): (step, rows_local), see
    :class:`PBatchStep`."""
    step = PBatchStep(frame_h, frame_w, qp, deblock, device)
    return step, step.nr


def h264_p_chunk_batch_step(frame_h: int, frame_w: int, chunk: int,
                            qp: int = 26, deblock: bool = False,
                            device=None):
    """The multi-session chunk step (row 15d): (step, rows_local), see
    :class:`PChunkBatchStep`."""
    step = PChunkBatchStep(frame_h, frame_w, chunk, qp, deblock, device)
    return step, step.nr


def h264_intra_batch_plain(y, cb, cr, hv, hl, qp: int,
                           with_recon: bool = False):
    """Plain version of 15b: the single-session plain functions session
    by session, stacked (any device; the step's inputs and outputs)."""
    from ..ops import bitmerge, cavlc_device, h264_device

    flats, recon = [], []
    for i in range(y.shape[0]):
        lv = h264_device.encode_intra_frame_yuv_plain(y[i], cb[i], cr[i],
                                                      int(qp))
        slots = cavlc_device.frame_block_slots_plain(lv)
        flats.append(bitmerge.pack_frame_plain(*slots, hv, hl)[None])
        recon.append((lv["recon_y"], lv["recon_cb"], lv["recon_cr"]))
    flat = torch.stack(flats)
    if not with_recon:
        return flat
    return (flat,) + tuple(torch.stack(list(p)) for p in zip(*recon))


def h264_p_batch_plain(y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl, qp: int,
                       deblock: bool = False):
    """Plain version of 15c, session by session, stacked."""
    from ..ops import bitmerge, cavlc_p_device, h264_deblock, h264_inter

    flats, refs = [], []
    for i in range(y.shape[0]):
        out = h264_inter.encode_p_frame_plain(
            y[i], cb[i], cr[i], ref_y[i], ref_cb[i], ref_cr[i], int(qp))
        slots = cavlc_p_device.p_frame_slots_plain(out)
        flats.append(bitmerge.pack_p_frame_plain(*slots[:6], hv, hl)[None])
        rec = (out["recon_y"], out["recon_cb"], out["recon_cr"])
        if deblock:
            rec = h264_deblock.deblock_frame_plain(
                *rec, int(qp), nnz_blk=slots[6], mv=out["mv"])
        refs.append(rec)
    return (torch.stack(flats),) + tuple(torch.stack(list(p))
                                         for p in zip(*refs))


def assemble_session_h264(flat_shards, rows_local: int,
                          headers: bytes = b"", nal_type: int = None,
                          ref_idc: int = 3) -> bytes:
    """One session's Annex-B access unit from its flat buffer(s) (one per
    spatial shard; one on one device).  Raises :class:`ShardOverflow`
    when a buffer overflowed its static caps."""
    from ..ops import cavlc_device

    parts = [headers]
    for shard in flat_shards:
        buf = shard.cpu().numpy() if isinstance(shard, torch.Tensor) \
            else np.asarray(shard)
        meta = cavlc_device.FlatMeta(buf, rows_local)
        if meta.overflow:
            raise ShardOverflow("static cap overflow in batch encode")
        parts.append(cavlc_device.assemble_annexb(
            buf, meta, nal_type=nal_type, ref_idc=ref_idc))
    return b"".join(parts)


# ---------------------------------------------------------------------------
# Single-session spatial shards (rows 15e-15h)
# ---------------------------------------------------------------------------
# The reference splits ONE frame's MB rows over nx devices: slice per MB
# row makes each shard's rows a self-contained set of slices, the motion
# search crosses a seam through the reference halo, the loop filter (idc
# 2) never crosses a row, and each shard emits its own entropy (CAVLC
# flats joined NAL by NAL, CABAC record streams stitched row-wise on the
# host), so the access unit equals the unsharded one byte for byte.
#
# Here the shard devices may repeat one device, the port's counterpart of
# the reference's forced host-platform devices; on one card the shard is a
# grid axis.  A shard's rows are rows s * rows_local + r of the frame, so
# the kernels whose MB rows are independent (the intra core K1, the slot
# coders K2/K6 with the qp chain, the loop filter K8, the qp plane K14,
# the I16-in-P passes) run once over the frame's rows; the packers K3/K7
# take the shard axis as sessions (each shard's flat, META and header
# slots its own); the P core runs in its padded-reference form K5p over
# each shard's halo-padded reference (15e); K11 runs once per shard on
# its row range; the masked step gates rows with K13s.  Shards on
# distinct cards (the peer copy of the halo rows) are ROADMAP item 11m.

def indexed_device(d) -> torch.device:
    """``d`` as a torch.device, "cuda" without an index as the current
    CUDA device's."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_spatial_mesh(nx: int, devices=None) -> list:
    """The ``nx`` shard devices of one spatially sharded session: the
    first ``nx`` of ``devices`` (every CUDA device by default).  The list
    may repeat one device (``[torch.device("cpu")] * nx``, ``["cuda:0"] *
    nx``); distinct CUDA devices raise, naming ROADMAP item 11m."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [indexed_device(d) for d in list(devices)[:int(nx)]]
    if nx < 1 or len(devs) < nx:
        raise ValueError(f"{nx} spatial shards over {len(devs)} devices")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            "spatial shards on distinct devices (the peer copy of the halo "
            "rows) are not ported to the PyTorch/CUDA encoder yet (ROADMAP "
            "queue 1 item 11m)")
    return devs


def spatial_halo_pad_plain(ref_y, ref_cb, ref_cr, nx: int,
                           halo: bool = True):
    """Plain version of 15e, in the reference's order per shard: the
    neighbour shards' ``_PAD`` rows above and below (edge copies at the
    frame's top and bottom), or with ``halo=False`` the shard's own edge
    rows, then ``_PAD`` edge columns at each side.  Returns the padded
    luma (nx, H/nx + 26, W + 26) and chroma planes, uint8."""
    from ..ops.h264_inter import _PAD

    out = []
    for ref in (ref_y, ref_cb, ref_cr):
        h, w = ref.shape
        hl = h // nx
        shards = []
        for s in range(nx):
            local = ref[s * hl:(s + 1) * hl]
            if halo and nx > 1:
                top = (local[:1].expand(_PAD, w) if s == 0
                       else ref[s * hl - _PAD:s * hl])
                bot = (local[-1:].expand(_PAD, w) if s == nx - 1
                       else ref[(s + 1) * hl:(s + 1) * hl + _PAD])
            else:
                top, bot = local[:1].expand(_PAD, w), local[-1:].expand(_PAD, w)
            rows = torch.cat([top, local, bot])
            shards.append(torch.cat([rows[:, :1].expand(-1, _PAD), rows,
                                     rows[:, -1:].expand(-1, _PAD)], dim=1))
        out.append(torch.stack(shards).contiguous())
    return tuple(out)


def spatial_halo_pad(ref_y, ref_cb, ref_cr, nx: int, halo: bool = True):
    """Row 15e: each of ``nx`` shards' reference planes padded by
    ``_PAD`` (the reference's ``_spatial_halo_pad``, whose shards'
    ``P("spatial", None)`` layout is here ``cavlc_device.shard_view`` of
    the frame's planes and rows): the neighbour
    shard's rows at an interior seam, edge copies at the frame's edges;
    ``halo=False`` (the measurement twin) copies the shard's own edge
    rows at every seam.  ``ref_*`` are the whole frame's uint8 planes
    (H, W), (H/2, W/2); returns (nx, H/nx + 26, W + 26) and (nx, H/(2 nx)
    + 26, W/2 + 26) uint8 planes.  CUDA tensors launch ``csrc/spatial.cu``
    (a thread per output byte); CPU tensors run the plain version."""
    from ..ops.h264_device import _check_planes
    from ..ops.h264_inter import _PAD

    _check_planes(ref_y, ref_cb, ref_cr)
    h, w = ref_y.shape
    if nx < 1 or h % (16 * nx):
        raise ValueError(f"{h} lines do not split into {nx} shards of MB "
                         "rows")
    if ref_y.device.type == "cpu":
        return spatial_halo_pad_plain(ref_y, ref_cb, ref_cr, nx, halo)
    dev = ref_y.device
    out = (torch.empty((nx, h // nx + 2 * _PAD, w + 2 * _PAD),
                       dtype=torch.uint8, device=dev),) + tuple(
        torch.empty((nx, h // (2 * nx) + 2 * _PAD, w // 2 + 2 * _PAD),
                    dtype=torch.uint8, device=dev) for _ in range(2))
    _cuda.launch("spatial", "halo_pad_launch",
                 [ref_y, ref_cb, ref_cr, *out], [h, w, nx, int(halo)], dev)
    spatial_halo_pad.launches += 1
    return out


spatial_halo_pad.launches = 0


def _frame_view(t: torch.Tensor) -> torch.Tensor:
    """(nx, R/nx, ...) shard stacks -> the frame's (R, ...), a view."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


# P-path levels keys: the host coder's overflow fallback tensors
_P_LEVEL_KEYS = ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
_INTRA_BIN_KEYS = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
                   "pred_mode", "mb_i4", "i4_modes", "luma_i4")


def _binarize_shards(fn, nx: int, tensors) -> torch.Tensor:
    """K11 once per shard on its row range: the shards' record streams
    (nx, words), each with its own header over its rows."""
    rows = tensors[0].shape[0] // nx
    return torch.stack([fn(*(t[s * rows:(s + 1) * rows] for t in tensors))
                        for s in range(nx)])


def _spatial_intra_body(y, cb, cr, hv, hl, qp: int, nx: int, entropy: str,
                        deblock: bool, with_recon: bool, tune: str,
                        i16_modes: str = "auto"):
    """15f on one frame's planes: the intra core (K1, its mode set
    ``i16_modes``) over the frame's rows, then per shard the CAVLC slots
    and packer (K2, K3 with the shard axis, ``hv``/``hl`` the shards'
    (nx, R/nx, 3) header slots) or the record stream (K11i), and the loop
    filter (K8)."""
    from ..ops import cabac_binarize, cavlc_device, h264_deblock, h264_device

    lv = h264_device.encode_intra_frame_yuv(y, cb, cr, qp, tune=tune,
                                            i16_modes=i16_modes)
    recon = tuple(lv[k] for k in ("recon_y", "recon_cb", "recon_cr"))
    if deblock and with_recon:
        recon = h264_deblock.deblock_frame(*recon, qp)
    if entropy == "cavlc":
        flat = cavlc_device.encode_levels(lv, hv, hl, qp, shards=nx)
        return (flat,) + recon if with_recon else flat
    buf = _binarize_shards(cabac_binarize.binarize_intra, nx,
                           [lv[k] for k in _INTRA_BIN_KEYS])
    small = {k: lv[k] for k in _INTRA_BIN_KEYS}
    return (buf,) + (recon if with_recon else ()) + (small,)


def _spatial_encode_frame(entropy: str, deblock: bool, qp: int, nx: int,
                          halo: bool = True, tune: str = "off",
                          p_intra: bool = False):
    """The P body both spatial builders run (the per-frame step and the
    chunk graph): the halo pad (15e), the padded-reference P core (K5p)
    with the shard axis, [the forced-skip gate (K13s)], per shard the
    CAVLC slots and packer (K6 over the frame's rows, K7 with the shard
    axis) or the record stream (K11p), and the loop filter (K8).

    Returns fn(y, cb, cr, ry, rcb, rcr, hv, hl, next_y=None, keep=None,
    qp_dev=None, out=None) -> (flat (nx, L), ry', rcb', rcr', mv, levels)
    over the frame's (H, W) planes; ``hv``/``hl`` the frame's (R, 3)
    header slots (CAVLC), ``keep`` the (R,) bool row gate (CAVLC, the
    masked step), ``out`` frame-shaped tensors for the P core's MVs and
    levels (a chunk's stacks)."""
    from ..ops import (cabac_binarize, cavlc_p_device, damage_mask,
                       h264_deblock, h264_inter)
    from ..ops.cavlc_device import shard_view

    if tune == "hq" and entropy == "cabac":
        raise ValueError("tune=hq has no device-binarize qp plumbing (use "
                         "dense CABAC)")
    if p_intra and (entropy != "cavlc" or deblock):
        raise ValueError("p_intra requires cavlc entropy, deblock off")
    sv = lambda t: None if t is None else shard_view(t, nx)

    def encode_one(y, cb, cr, ry, rcb, rcr, hv, hl, next_y=None, keep=None,
                   qp_dev=None, out=None):
        pads = spatial_halo_pad(ry, rcb, rcr, nx, halo)
        o = h264_inter.encode_p_frame_padded_ref(
            sv(y), sv(cb), sv(cr), *pads, qp, tune=tune, next_y=sv(next_y),
            p_intra=p_intra, qp_dev=qp_dev,
            out=None if out is None else {k: sv(v) for k, v in out.items()})
        o = {k: _frame_view(v) for k, v in o.items()}
        if entropy == "cavlc":
            if keep is not None:
                damage_mask.force_skip_rows(o, keep, ry, rcb, rcr)
            flat, ny, ncb, ncr, mv, nnz, lv = cavlc_p_device._finish_p(
                o, sv(hv), sv(hl), slice_qp=qp, qp_dev=qp_dev, shards=nx)
            filt = dict(nnz_blk=nnz)
        else:
            mv = o["mv"]
            flat = _binarize_shards(cabac_binarize.binarize_p, nx,
                                    [mv] + [o[k] for k in _P_LEVEL_KEYS])
            ny, ncb, ncr = o["recon_y"], o["recon_cb"], o["recon_cr"]
            lv = {k: o[k] for k in _P_LEVEL_KEYS}
            filt = dict(luma=o["luma"])
        if deblock:
            ny, ncb, ncr = h264_deblock.deblock_frame(
                ny, ncb, ncr, qp, mv=mv, qp_dev=qp_dev, **filt)
        return flat, ny, ncb, ncr, mv, lv

    return encode_one


def _check_spatial(mesh, frame_h: int, frame_w: int, entropy: str,
                   tune: str, p: bool) -> int:
    nx = len(mesh)
    if frame_h % (16 * nx) or frame_w % 16:
        raise ValueError("MB rows must split across the shards")
    if p and not p_halo_feasible(frame_h, nx):
        raise ValueError("shards too short for the halo")
    if entropy not in ("cavlc", "cabac"):
        raise ValueError(f"unknown spatial entropy {entropy!r}")
    if tune == "hq" and entropy == "cabac":
        raise ValueError("tune=hq has no device-binarize qp plumbing (use "
                         "dense CABAC)")
    return nx


class SpatialIntraStep(_Step):
    """Row 15f: ``step(y, cb, cr, hv, hl)`` (CAVLC) -> flats (nx, L)
    [+ recon planes (H, W), (H/2, W/2) x 2, on the device, loop-filtered
    with ``deblock``]; ``step(y, cb, cr)`` (CABAC) -> (record streams
    (nx, Lb)[, recon planes], levels), the levels the frame's
    (R, C, ...) tensors the dense fallback takes.  ``hv``/``hl`` are the
    frame's (R, 3) slice-header slots; shard s packs rows s * R/nx ..."""

    kind = "h264_sp_intra"
    launches = 0

    def __init__(self, mesh, frame_h, frame_w, qp, entropy, deblock,
                 with_recon, tune, i16_modes="auto"):
        super().__init__(frame_h, frame_w, qp, mesh[0])
        self.nx = _check_spatial(mesh, frame_h, frame_w, entropy, tune,
                                 False)
        self.entropy, self.tune, self.i16_modes = entropy, tune, i16_modes
        self.deblock, self.with_recon = bool(deblock), bool(with_recon)

    def _run(self, y, cb, cr, hv=None, hl=None):
        dev = self.device
        y, cb, cr = (_planes(a, dev) for a in (y, cb, cr))
        if tuple(y.shape) != (self.frame_h, self.frame_w):
            raise ValueError(f"planes {tuple(y.shape)} are not "
                             f"({self.frame_h}, {self.frame_w})")
        view = lambda t: _slots(t, dev).view(self.nx, self.nr // self.nx, 3)
        if self.entropy == "cavlc":
            hv, hl = view(hv), view(hl)
        out = _spatial_intra_body(y, cb, cr, hv, hl, self.qp, self.nx,
                                  self.entropy, self.deblock,
                                  self.with_recon, self.tune, self.i16_modes)
        if dev.type == "cuda":
            SpatialIntraStep.launches += 1
        return out


class SpatialPStep(_Step):
    """Row 15g: ``step(y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl[, keep])``
    (CAVLC; ``keep`` the masked step's (R,) bool row gate) or ``step(y,
    cb, cr, ref_y, ref_cb, ref_cr)`` (CABAC) -> (flats (nx, L) or record
    streams (nx, Lb), ref_y', ref_cb', ref_cr', mv (R, C, 2), levels): the
    P frame over the shards, the references only read, the new ones on
    the device.  ``halo=False`` builds the measurement twin (edge copies
    at the seams: other bytes, the same work)."""

    kind = "h264_sp_p"
    launches = 0

    def __init__(self, mesh, frame_h, frame_w, qp, deblock, entropy, halo,
                 tune, p_intra, masked):
        super().__init__(frame_h, frame_w, qp, mesh[0])
        self.nx = _check_spatial(mesh, frame_h, frame_w, entropy, tune, True)
        if masked and entropy != "cavlc":
            raise ValueError("the masked spatial step takes cavlc entropy")
        self.entropy, self.masked = entropy, bool(masked)
        self.body = _spatial_encode_frame(entropy, deblock, self.qp, self.nx,
                                          halo=halo, tune=tune,
                                          p_intra=p_intra)

    def _run(self, y, cb, cr, ref_y, ref_cb, ref_cr, hv=None, hl=None,
             keep=None):
        dev = self.device
        planes = [_planes(a, dev) for a in (y, cb, cr, ref_y, ref_cb,
                                            ref_cr)]
        if tuple(planes[0].shape) != (self.frame_h, self.frame_w):
            raise ValueError(f"planes {tuple(planes[0].shape)} are not "
                             f"({self.frame_h}, {self.frame_w})")
        if self.entropy == "cavlc":
            hv, hl = _slots(hv, dev), _slots(hl, dev)
        if self.masked != (keep is not None):
            raise ValueError("the masked step takes a keep mask, the "
                             "others none")
        if keep is not None:
            if not isinstance(keep, torch.Tensor):
                keep = torch.from_numpy(np.asarray(keep, bool))
            keep = keep.to(dev, torch.bool)
        out = self.body(*planes, hv, hl, keep=keep)
        if dev.type == "cuda":
            SpatialPStep.launches += 1
        return out


def h264_spatial_intra_step(mesh, frame_h: int, frame_w: int, qp: int = 26,
                            entropy: str = "cavlc", i16_modes: str = "auto",
                            deblock: bool = False, with_recon: bool = True,
                            tune: str = "off"):
    """The single-session spatial IDR step (row 15f) over the shard
    devices ``mesh`` (:func:`make_spatial_mesh`): (step, rows_local), see
    :class:`SpatialIntraStep`."""
    step = SpatialIntraStep(mesh, frame_h, frame_w, qp, entropy, deblock,
                            with_recon, tune, i16_modes)
    return step, step.nr // step.nx


def h264_spatial_step(mesh, frame_h: int, frame_w: int, qp: int = 26,
                      deblock: bool = False, entropy: str = "cavlc",
                      halo: bool = True, tune: str = "off",
                      p_intra: bool = False, masked: bool = False):
    """The single-session spatial P step (row 15g): (step, rows_local),
    see :class:`SpatialPStep`."""
    step = SpatialPStep(mesh, frame_h, frame_w, qp, deblock, entropy, halo,
                        tune, p_intra, masked)
    return step, step.nr // step.nx


def h264_spatial_chunk_step(mesh, frame_h: int, frame_w: int, chunk: int,
                            deblock: bool = False, entropy: str = "cavlc",
                            tune: str = "off", p_intra: bool = False,
                            budget=None):
    """The single-session spatial chunk step (row 15h): ``ops/devloop``'s
    :class:`ChunkStep` with the spatial P body per frame (the reference's
    ``h264_spatial_chunk_step``, to which its ``build_p_chunk_step``
    delegates under ``spatial_shards > 1``).  On the card, one replay of a
    captured CUDA graph of ``chunk`` bodies, the halo pad and the loop
    filter inside; ``step(frames, refs, hv, hl, None, qp, owner)`` ->
    ``ChunkOut`` whose ``flats[k]`` are frame k's (nx, L) shard buffers.
    Unlike the reference's builder it takes the geometry and the chunk
    (a graph is shape-specialized when it is captured) and the qp per
    call (from device memory inside the graph)."""
    from ..ops import devloop

    nx = _check_spatial(mesh, frame_h, frame_w, entropy, tune, True)
    return devloop.ChunkStep(
        chunk=chunk, pad_h=frame_h, pad_w=frame_w, deblock=deblock,
        entropy=entropy, ingest="yuv", device=mesh[0], budget=budget,
        tune=tune, p_intra=p_intra, spatial_shards=nx)


def h264_spatial_intra_plain(y, cb, cr, hv, hl, qp: int, nx: int,
                             entropy: str = "cavlc", deblock: bool = False,
                             with_recon: bool = True, tune: str = "off",
                             i16_modes: str = "auto"):
    """Plain version of 15f: the same body with every kernel's plain
    version (the planes moved to the CPU)."""
    cpu = lambda t: None if t is None else t.cpu()
    return _spatial_intra_body(
        *(cpu(t) for t in (y, cb, cr)),
        None if hv is None else cpu(hv).view(nx, -1, 3),
        None if hl is None else cpu(hl).view(nx, -1, 3), int(qp), nx,
        entropy, deblock, with_recon, tune, i16_modes)


def h264_spatial_p_plain(y, cb, cr, ref_y, ref_cb, ref_cr, hv, hl, qp: int,
                         nx: int, entropy: str = "cavlc",
                         deblock: bool = False, halo: bool = True,
                         tune: str = "off", p_intra: bool = False,
                         keep=None, next_y=None):
    """Plain version of 15g (and of one body of 15h): the same body with
    every kernel's plain version, on the CPU."""
    cpu = lambda t: None if t is None else t.cpu()
    body = _spatial_encode_frame(entropy, deblock, int(qp), nx, halo=halo,
                                 tune=tune, p_intra=p_intra)
    return body(*(cpu(t) for t in (y, cb, cr, ref_y, ref_cb, ref_cr, hv,
                                    hl)), next_y=cpu(next_y), keep=cpu(keep))
