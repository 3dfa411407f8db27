"""The H.264 session steps (the reference's ``parallel/batch.py`` rows
15b-15d) on the port, against the reference's steps on a (1, 1) mesh of
one CPU device (the shape the reference's manager plans on one device):
every session's access unit (through ``assemble_session_h264``), the
recon and reference planes, both ``idr_parity`` values, over two GOPs;
the P step with the loop filter off and on, and the chunk step.  Then the
host helpers against the reference's on a sweep of geometries and device
counts."""

import jax
import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.bitstream import h264 as j_syn
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cd
from docker_nvidia_glx_desktop_tpu.parallel import batch as j_batch
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device as t_cd
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch as t_batch

QP = 26
GEOMS = [(48, 64, 3), (64, 96, 2)]      # (pad_h, pad_w, sessions)


def planes(s: int, h: int, w: int, t: int):
    """S sessions' seeded desktop-like YUV 4:2:0 planes at tick ``t``: a
    gradient, a window moving 2 pels a tick, a text band scrolling, each
    session its own offsets."""
    ys, cbs, crs = [], [], []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(s):
        rng = np.random.default_rng(100 + i)
        y = ((xx * 3 + yy * 2 + 37 * i) % 200 + 20).astype(np.uint8)
        x0 = (2 * t + 7 * i) % (w // 2)
        y[h // 4:h // 2, x0:x0 + w // 4] = 235 - 10 * i
        band = (rng.integers(0, 2, (4, w)) * 120 + 60).astype(np.uint8)
        y[h // 2 + 4:h // 2 + 8] = np.roll(band, 3 * t, axis=1)
        cb = (y[::2, ::2] // 2 + 50 + 5 * i).astype(np.uint8)
        cr = (200 - y[::2, ::2] // 3).astype(np.uint8)
        ys.append(y)
        cbs.append(cb)
        crs.append(cr)
    return np.stack(ys), np.stack(cbs), np.stack(crs)


def p_slots(nr: int, nc: int, frame_num: int):
    return j_cd.slice_header_slots(nr, nc, frame_num=frame_num,
                                   slice_type=5, idr=False)


@pytest.fixture(scope="module")
def mesh():
    return j_batch.make_mesh((1, 1), jax.devices()[:1])


_J_STEPS = {}


def j_step(mesh, kind: str, h: int, w: int, **kw):
    """The reference's step, built once per configuration (each build is
    a new jit: its first call compiles)."""
    key = (kind, h, w) + tuple(sorted(kw.items()))
    if key not in _J_STEPS:
        build = {"intra": j_batch.h264_batch_encode_step,
                 "p": j_batch.h264_p_batch_step,
                 "chunk": j_batch.h264_p_chunk_batch_step}[kind]
        _J_STEPS[key] = build(mesh, h, w, **kw)
    return _J_STEPS[key]


def aus(batch_mod, flat, rows_local, idr: bool):
    """Every session's AU from a step's flats (S, 1, L)."""
    flat = flat.cpu().numpy() if isinstance(flat, torch.Tensor) \
        else np.asarray(flat)
    return [batch_mod.assemble_session_h264(
        flat[i], rows_local, nal_type=None if idr else j_syn.NAL_SLICE,
        ref_idc=3 if idr else 2) for i in range(flat.shape[0])]


def same_planes(j_planes, t_planes) -> bool:
    return all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(j_planes, t_planes))


def two_gops(geom, mesh):
    """IDR (parity 0), three P ticks, IDR (parity 1), three P ticks: AUs
    and planes equal at every tick, each side chaining its own refs."""
    h, w, s = geom
    nr, nc = h // 16, w // 16
    j_intra, j_rows = j_step(mesh, "intra", h, w, qp=QP, with_recon=True)
    j_p, _ = j_step(mesh, "p", h, w, qp=QP)
    t_intra, t_rows = t_batch.h264_batch_encode_step(h, w, qp=QP,
                                                     with_recon=True,
                                                     device="cpu")
    t_p, _ = t_batch.h264_p_batch_step(h, w, qp=QP, device="cpu")
    assert t_rows == j_rows == nr
    t = 0
    for parity in (0, 1):
        y, cb, cr = planes(s, h, w, t)
        jf, *j_refs = j_intra(y, cb, cr, idr_parity=parity)
        tf, *t_refs = t_intra(y, cb, cr, idr_parity=parity)
        assert aus(t_batch, tf, t_rows, True) == aus(j_batch, jf, j_rows, True)
        assert same_planes(j_refs, t_refs)
        for fn in (1, 2, 3):
            t += 1
            y, cb, cr = planes(s, h, w, t)
            hv, hl = p_slots(nr, nc, fn)
            jf, *j_refs = j_p(y, cb, cr, *j_refs, hv, hl)
            tf, *t_refs = t_p(y, cb, cr, *t_refs, hv, hl)
            assert aus(t_batch, tf, t_rows, False) == \
                aus(j_batch, jf, j_rows, False)
            assert same_planes(j_refs, t_refs)
        t += 1
    # the two parities give different IDR slice headers
    y, cb, cr = planes(s, h, w, 0)
    assert aus(t_batch, t_intra(y, cb, cr, 0)[0], t_rows, True) != \
        aus(t_batch, t_intra(y, cb, cr, 1)[0], t_rows, True)


def test_intra_and_p_steps_equal_the_reference_over_two_gops(mesh):
    """The first geometry (64x48, 3 sessions); the second (96x64, 2
    sessions) is ``test_torch_batch_h264_bucket2.py``'s, so each file's
    reference compiles stay few."""
    two_gops(GEOMS[0], mesh)


def test_p_step_with_the_loop_filter_equals_the_reference(mesh):
    h, w, s = GEOMS[0]
    nr, nc = h // 16, w // 16
    j_intra, rows = j_step(mesh, "intra", h, w, qp=QP, with_recon=True)
    j_p, _ = j_step(mesh, "p", h, w, qp=QP, deblock=True)
    t_p, _ = t_batch.h264_p_batch_step(h, w, qp=QP, deblock=True,
                                       device="cpu")
    _, *j_refs = j_intra(*planes(s, h, w, 0))
    t_refs = [torch.from_numpy(np.array(r)) for r in j_refs]
    for fn in (1, 2, 3):
        y, cb, cr = planes(s, h, w, fn)
        hv, hl = p_slots(nr, nc, fn)
        jf, *j_refs = j_p(y, cb, cr, *j_refs, hv, hl)
        tf, *t_refs = t_p(y, cb, cr, *t_refs, hv, hl)
        assert aus(t_batch, tf, rows, False) == aus(j_batch, jf, rows, False)
        assert same_planes(j_refs, t_refs)


def test_chunk_step_equals_the_reference_and_k_p_steps(mesh):
    """Two chunks of 3 P frames: the port's chunk step against the
    reference's chunk step, and against three of its own P steps; a call
    while the previous chunk is still held raises."""
    h, w, s = GEOMS[0]
    nr, nc, k = h // 16, w // 16, 3
    j_intra, rows = j_step(mesh, "intra", h, w, qp=QP, with_recon=True)
    j_c, _ = j_step(mesh, "chunk", h, w, chunk=k, qp=QP)
    t_c, _ = t_batch.h264_p_chunk_batch_step(h, w, k, qp=QP, device="cpu")
    t_p, _ = t_batch.h264_p_batch_step(h, w, qp=QP, device="cpu")
    _, *j_refs = j_intra(*planes(s, h, w, 0))
    t_refs = [torch.from_numpy(np.array(r)) for r in j_refs]
    p_refs = list(t_refs)
    for c in range(2):
        fns = [1 + c * k + j for j in range(k)]
        pl = [planes(s, h, w, fn) for fn in fns]
        ys, cbs, crs = (np.stack([p[i] for p in pl], axis=1) for i in range(3))
        slots = [p_slots(nr, nc, fn) for fn in fns]
        hv = np.stack([a for a, _ in slots])
        hl = np.stack([b for _, b in slots])
        jf, *j_refs = j_c(ys, cbs, crs, *j_refs, hv, hl)
        tf, *t_refs = t_c(ys, cbs, crs, *t_refs, hv, hl)
        assert tuple(tf.shape[:3]) == (s, k, 1)
        with pytest.raises(RuntimeError, match="still held"):
            t_c(ys, cbs, crs, *t_refs, hv, hl)
        t_c.release()
        jf = np.asarray(jf)
        for j in range(k):
            want = aus(j_batch, jf[:, j], rows, False)
            assert aus(t_batch, tf[:, j], rows, False) == want
            pf, *p_refs = t_p(ys[:, j], cbs[:, j], crs[:, j], *p_refs,
                              hv[j], hl[j])
            assert aus(t_batch, pf, rows, False) == want
        assert same_planes(j_refs, t_refs)
        assert all(torch.equal(a, b) for a, b in zip(p_refs, t_refs))


def test_one_sessions_overflow_leaves_the_others_flats_intact():
    """A full-noise frame in session 1 overflows its flat buffer's caps:
    assembling it raises ShardOverflow, the other sessions' flats equal
    their flats from a batch without the noise."""
    h, w, s = GEOMS[0]
    step, rows = t_batch.h264_batch_encode_step(h, w, qp=QP, device="cpu")
    y, cb, cr = planes(s, h, w, 0)
    noisy = [a.copy() for a in (y, cb, cr)]
    rng = np.random.default_rng(5)
    for a in noisy:
        a[1] = rng.integers(0, 256, a[1].shape, dtype=np.uint8)
    clean = step(y, cb, cr)
    dirty = step(*noisy)
    with pytest.raises(t_batch.ShardOverflow):
        t_batch.assemble_session_h264(dirty[1], rows)
    for i in (0, 2):
        assert torch.equal(dirty[i], clean[i])
        assert t_batch.assemble_session_h264(dirty[i], rows)


def test_steps_refuse_unaligned_or_mismatched_planes():
    with pytest.raises(ValueError, match="MB-aligned"):
        t_batch.h264_batch_encode_step(50, 64, device="cpu")
    step, _ = t_batch.h264_batch_encode_step(48, 64, device="cpu")
    y, cb, cr = planes(2, 64, 64, 0)
    with pytest.raises(ValueError, match="not"):
        step(y, cb, cr)
    with pytest.raises(ValueError, match="qp"):
        t_batch.h264_p_batch_step(48, 64, qp=60, device="cpu")


# -- the host helpers against the reference's ------------------------------

SWEEP_H = [48, 64, 720, 1080, 1088, 1440, 2160]
SWEEP_N = [1, 2, 3, 4, 8]


@pytest.mark.parametrize("h", SWEEP_H)
def test_geometry_helpers_equal_the_reference(h):
    for w in (64, 1280, 1919, 1920, 3840):
        assert t_batch.geometry_bucket(w, h) == j_batch.geometry_bucket(w, h)
        for level in range(-1, 5):
            assert t_batch.degraded_geometry(w, h, level) == \
                j_batch.degraded_geometry(w, h, level)
    assert t_batch.DEGRADE_SCALES == j_batch.DEGRADE_SCALES


@pytest.mark.parametrize("n_dev", SWEEP_N)
def test_mesh_planning_helpers_equal_the_reference(n_dev):
    for h in SWEEP_H:
        pad_h = -(-h // 16) * 16
        for nx in (1, 2, 3, 4, 5, 8):
            assert t_batch.p_halo_feasible(pad_h, nx) == \
                j_batch.p_halo_feasible(pad_h, nx)
        for want in range(1, 9):
            assert t_batch.feasible_spatial_shards(pad_h, want, n_dev) == \
                j_batch.feasible_spatial_shards(pad_h, want, n_dev)
            for sessions in (1, 2, 3, 8):
                assert t_batch.replan_mesh(sessions, n_dev, pad_h, want) == \
                    j_batch.replan_mesh(sessions, n_dev, pad_h, want)
    for sessions in range(0, 17):
        assert t_batch.elastic_degrade_level(sessions, n_dev) == \
            j_batch.elastic_degrade_level(sessions, n_dev)
    with pytest.raises(ValueError):
        t_batch.replan_mesh(2, 0, 1088)


def test_flat_metadata_layout_matches_the_reference():
    """The port's FlatMeta reads the same header words as the
    reference's (the managers assemble with either)."""
    assert (t_cd.META_WORDS, t_cd.MAX_META_ROWS) == \
        (j_cd.META_WORDS, j_cd.MAX_META_ROWS)
