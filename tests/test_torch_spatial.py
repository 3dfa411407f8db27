"""The single-session spatial shards of the port (rows 15e-15h, 13s and
the padded-reference P core K5p) against the reference's programs on the
CPU's forced devices: the halo pad, the forced-skip row gate, the P core
over padded references at each tier, and the spatial IDR, P (and masked
P) and chunk steps on ``make_spatial_mesh(nx)`` against the port's on
``[cpu] * nx``, over an IDR and three P frames: every shard's flat or
record stream, the recon and reference planes, the MVs and the levels.
The geometries are the reference's tests' ((64, 64) with nx = 2, (128,
64) with nx = 4), the qp fixed, and every comparison exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import conftest  # noqa: F401  (the 8 forced CPU devices)
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cd
from docker_nvidia_glx_desktop_tpu.ops import damage_mask as j_dmg
from docker_nvidia_glx_desktop_tpu.ops import h264_inter as j_inter
from docker_nvidia_glx_desktop_tpu.ops import devloop as j_devloop
from docker_nvidia_glx_desktop_tpu.parallel import batch as j_batch
from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as t_dmg
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter as t_inter
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch as t_batch

QP = 24
GEOMS = {2: (64, 64), 4: (128, 64)}          # nx -> (pad_h, pad_w)
CPU = torch.device("cpu")


def planes(h: int, w: int, t: int, seed: int = 1):
    """Seeded desktop-like YUV 4:2:0 planes at time ``t``: a gradient, a
    window moving 2 pels a frame, noise whose amplitude alternates."""
    r = np.random.default_rng(seed + 7 * t)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2 + 5 * t) % 200 + 20).astype(np.int32)
    x0 = (2 * t) % (w // 2)
    y[h // 4:h // 2, x0:x0 + w // 4] = 235
    y = np.clip(y + r.integers(-8, 8, (h, w)) * (t % 2 + 1), 0, 255)
    y = y.astype(np.uint8)
    cb = (y[::2, ::2] // 2 + 50).astype(np.uint8)
    cr = (200 - y[::2, ::2] // 3).astype(np.uint8)
    return y, cb, cr


def ten(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def same(j, t) -> bool:
    j = np.asarray(j)
    if j.dtype == np.uint32:           # the record streams' words
        j = j.view(np.int32)
    t = t.numpy()
    if t.dtype == np.bool_:
        j = j.astype(bool)
    return j.shape == t.shape and np.array_equal(j, t.astype(j.dtype))


def p_slots(nr: int, nc: int, fn: int, deblock: bool):
    return j_cd.slice_header_slots(nr, nc, frame_num=fn, slice_type=5,
                                   idr=False, qp_delta=QP - 26,
                                   deblocking_idc=2 if deblock else 1)


def idr_slots(nr: int, nc: int, deblock: bool):
    return j_cd.slice_header_slots(nr, nc, frame_num=0, idr_pic_id=1,
                                   qp_delta=QP - 26,
                                   deblocking_idc=2 if deblock else 1)


# -- 15e: the halo pad ----------------------------------------------------

@pytest.mark.parametrize("nx", [2, 4])
@pytest.mark.parametrize("halo", [True, False])
def test_halo_pad_equals_the_reference(nx, halo):
    h, w = GEOMS[nx]
    pad = j_batch._spatial_halo_pad(nx, halo)
    mesh = j_batch.make_spatial_mesh(nx)
    run = jax.jit(j_batch.shard_map(
        lambda r: pad(r.astype(jnp.int32))[None], mesh=mesh,
        in_specs=P("spatial", None), out_specs=P("spatial", None, None),
        check_vma=False))
    y, cb, cr = planes(h, w, 3)
    got = t_batch.spatial_halo_pad(*ten(y, cb, cr), nx, halo)
    for ref, t in zip((y, cb, cr), got):
        assert t.dtype == torch.uint8
        assert same(run(ref), t)


# -- 13s: the forced-skip row gate ------------------------------------------

@pytest.mark.parametrize("intra", [False, True])
def test_force_skip_rows_equals_the_reference(intra):
    h, w = GEOMS[2]
    nr, nc = h // 16, w // 16
    r = np.random.default_rng(5)
    out = {"mv": r.integers(-40, 40, (nr, nc, 2)),
           "luma": r.integers(-9, 9, (nr, nc, 16, 16)),
           "cb_dc": r.integers(-9, 9, (nr, nc, 4)),
           "cb_ac": r.integers(-9, 9, (nr, nc, 4, 15)),
           "cr_dc": r.integers(-9, 9, (nr, nc, 4)),
           "cr_ac": r.integers(-9, 9, (nr, nc, 4, 15))}
    if intra:
        out.update(mb_intra=r.integers(0, 2, (nr, nc)).astype(bool),
                   i16_dc=r.integers(-9, 9, (nr, nc, 16)),
                   i16_ac=r.integers(-9, 9, (nr, nc, 16, 15)))
    out = {k: v.astype(np.int32) if v.dtype != bool else v
           for k, v in out.items()}
    rec = planes(h, w, 1)
    ref = planes(h, w, 2)
    out.update(recon_y=rec[0], recon_cb=rec[1], recon_cr=rec[2])
    keep = np.array([True, False, False, True])
    want = j_dmg.force_skip_rows({k: jnp.asarray(v) for k, v in out.items()},
                                 keep, *ref)
    t_out = {k: torch.from_numpy(v.copy()) for k, v in out.items()}
    got = t_dmg.force_skip_rows(t_out, torch.from_numpy(keep), *ten(*ref))
    assert got is t_out
    assert set(got) == set(want)
    for k in want:
        assert same(want[k], got[k]), k


# -- K5p: the P core over padded references ---------------------------------

@pytest.mark.parametrize("tune,p_intra", [("off", False), ("hq_noaq", False),
                                          ("hq", True)])
def test_padded_ref_core_equals_the_reference(tune, p_intra):
    h, w = 64, 64
    y, cb, cr = planes(h, w, 2)
    ref = planes(h, w, 1)
    r = np.random.default_rng(3)
    # a padded reference whose padding is not edge copies: other rows
    pads = [np.pad(p, j_inter._PAD, mode="reflect")
            + r.integers(0, 2, (p.shape[0] + 26, p.shape[1] + 26)).astype(
                np.uint8) for p in ref]
    run = jax.jit(functools.partial(j_inter.encode_p_frame_padded_ref,
                                    qp=QP, tune=tune, p_intra=p_intra))
    want = run(y, cb, cr, *(p.astype(np.int32) for p in pads))
    got = t_inter.encode_p_frame_padded_ref(*ten(y, cb, cr), *ten(*pads),
                                            QP, tune=tune, p_intra=p_intra)
    assert set(got) == set(want)
    for k in want:
        assert same(want[k], got[k]), k
    # a stack of two shards is two single calls
    both = t_inter.encode_p_frame_padded_ref(
        *(torch.stack([a, a]) for a in ten(y, cb, cr)),
        *(torch.stack([a, a]) for a in ten(*pads)), QP, tune=tune,
        p_intra=p_intra)
    for k in want:
        assert torch.equal(both[k][1], got[k]), k


# -- 15f, 15g and the masked 15g: the steps over an IDR and three P frames --

_J_STEPS = {}


def j_step(kind: str, nx: int, **kw):
    key = (kind, nx) + tuple(sorted(kw.items()))
    if key not in _J_STEPS:
        h, w = GEOMS[nx]
        mesh = j_batch.make_spatial_mesh(nx)
        build = (j_batch.h264_spatial_intra_step if kind == "intra"
                 else j_batch.h264_spatial_step)
        _J_STEPS[key] = build(mesh, h, w, QP, **kw)[0]
    return _J_STEPS[key]


def gop(nx: int, entropy: str = "cavlc", deblock: bool = True,
        tune: str = "off", p_intra: bool = False, masked: bool = False):
    h, w = GEOMS[nx]
    nr, nc = h // 16, w // 16
    mesh = t_batch.make_spatial_mesh(nx, [CPU] * nx)
    ji = j_step("intra", nx, entropy=entropy, deblock=deblock, tune=tune)
    jp = j_step("p", nx, entropy=entropy, deblock=deblock, tune=tune,
                p_intra=p_intra, masked=masked)
    ti, rows = t_batch.h264_spatial_intra_step(mesh, h, w, QP,
                                               entropy=entropy,
                                               deblock=deblock, tune=tune)
    tp, _ = t_batch.h264_spatial_step(mesh, h, w, QP, entropy=entropy,
                                      deblock=deblock, tune=tune,
                                      p_intra=p_intra, masked=masked)
    assert rows == nr // nx
    cavlc = entropy == "cavlc"
    args = idr_slots(nr, nc, deblock) if cavlc else ()
    y, cb, cr = planes(h, w, 0)
    jo, to = ji(y, cb, cr, *args), ti(y, cb, cr, *args)
    assert len(jo) == len(to)
    for a, b in zip(jo[:4], to[:4]):
        assert same(a, b)
    if not cavlc:
        assert set(jo[4]) == set(to[4])
        assert all(same(jo[4][k], to[4][k]) for k in jo[4])
    jref, tref = jo[1:4], to[1:4]
    for fn in (1, 2, 3):
        y, cb, cr = planes(h, w, fn)
        args = p_slots(nr, nc, fn, deblock) if cavlc else ()
        if masked:
            args = args + ((np.arange(nr) + fn) % 3 != 0,)
        jo = jp(y, cb, cr, *jref, *args)
        to = tp(y, cb, cr, *tref, *args)
        for i, (a, b) in enumerate(zip(jo[:5], to[:5])):
            assert same(a, b), f"P frame {fn}, output {i}"
        assert set(jo[5]) == set(to[5])
        for k in jo[5]:
            assert same(jo[5][k], to[5][k]), f"P frame {fn}, levels {k}"
        jref, tref = jo[1:4], to[1:4]


@pytest.mark.parametrize("nx", [2, 4])
def test_cavlc_steps_equal_the_reference(nx):
    gop(nx)


def test_cabac_steps_equal_the_reference():
    gop(2, entropy="cabac")


def test_masked_step_equals_the_reference():
    gop(2, masked=True)


def test_full_tier_steps_with_i16_in_p_equal_the_reference():
    gop(4, deblock=False, tune="hq", p_intra=True)


# -- 15h: the chunk step ----------------------------------------------------

@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_chunk_step_equals_the_reference(entropy):
    nx, k = 2, 3
    h, w = GEOMS[nx]
    nr, nc = h // 16, w // 16
    cavlc = entropy == "cavlc"
    ji = j_step("intra", nx, entropy=entropy, deblock=True)
    args = idr_slots(nr, nc, True) if cavlc else ()
    jo = ji(*planes(h, w, 0), *args)
    refs = [np.asarray(r) for r in jo[1:4]]
    frames = [planes(h, w, t) for t in range(1, k + 1)]
    hv = hl = None
    if cavlc:
        slots = [p_slots(nr, nc, fn, True) for fn in range(1, k + 1)]
        hv = np.stack([s[0] for s in slots])
        hl = np.stack([s[1] for s in slots])
    jstep = j_devloop.build_p_chunk_step(QP, deblock=True, entropy=entropy,
                                         spatial_shards=nx)
    stacks = [np.stack([f[i] for f in frames]) for i in range(3)]
    jx = jstep(*stacks, *refs, *((hv, hl) if cavlc else ()))
    tstep = t_batch.h264_spatial_chunk_step(
        t_batch.make_spatial_mesh(nx, [CPU] * nx), h, w, k, deblock=True,
        entropy=entropy)
    out = tstep(frames, ten(*refs), hv.view(np.int32) if cavlc else None,
                hl if cavlc else None, None, QP, owner=object())
    jflats, _, jry, jrcb, jrcr, jmvs, jlvs = jx
    assert np.asarray(jflats).shape[:2] == (k, nx)
    for i in range(k):
        assert same(np.asarray(jflats)[i], out.flats[i]), f"frame {i}"
    for a, b in zip((jry, jrcb, jrcr), out.refs):
        assert same(a, b)
    assert same(jmvs, out.mvs)
    for key in jlvs:
        assert same(jlvs[key], out.lvs[key]), key


# -- the shard devices ------------------------------------------------------

def test_spatial_mesh_repeats_one_device_and_refuses_distinct_cards():
    assert t_batch.make_spatial_mesh(4, [CPU] * 8) == [CPU] * 4
    with pytest.raises(ValueError):
        t_batch.make_spatial_mesh(3, [CPU] * 2)
    with pytest.raises(NotImplementedError, match="item 11m"):
        t_batch.make_spatial_mesh(
            2, [torch.device("cuda", 0), torch.device("cuda", 1)])
