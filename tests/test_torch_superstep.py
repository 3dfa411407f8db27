"""The super-step chunk ring in the port against the reference: AUs of
``ENCODER_SUPERSTEP_CHUNK`` byte-equal to the JAX ring's and to the
port's own per-frame path, pipelined at the encoder's depth, with the
RateController moving qp, a partial chunk flushed at a requested IDR, a
drain flush and a flat-cap overflow inside a chunk; on CABAC with device
binarization and on rgb ingest; a mid-GOP JAX state continued by a ring
encoder; and the chunk's kernels' plain versions (K9's frame axis, K4c)
against the reference's programs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models import h264 as j_h264
from docker_nvidia_glx_desktop_tpu.ops import content_stats as j_cs
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import (cavlc_device, color,
                                                     content_stats, devloop)
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

import conftest
from test_torch_encoder import _same_stats

W, H = 64, 48
# qp 20 base with rate control: a few distinct qps (each a compile of the
# reference's chunk program), low enough for a noise frame to overflow
RING_ENV = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": "9",
            "ENCODER_BITRATE_KBPS": "500", "ENCODER_QP": "20",
            "ENCODER_SUPERSTEP_CHUNK": "4"}


def _frames(n, w=W, h=H, seed=3, step=2, noisy_at=None):
    r = np.random.default_rng(seed)
    base = conftest.make_test_frame(h, w, seed=seed)
    out = [np.ascontiguousarray(np.roll(base, step * i, axis=1))
           for i in range(n)]
    if noisy_at is not None:
        out[noisy_at] = r.integers(0, 256, (h, w, 3), np.uint8)
    return out


def _drive(enc, frames, keyframe_at=(), depth=None):
    """The serving loop at the encoder's preferred depth."""
    depth = depth or getattr(enc, "pipeline_depth", 2)
    out, pend, toks = [], [], []
    for i, f in enumerate(frames):
        if i in keyframe_at:
            enc.request_keyframe()
        pend.append(enc.encode_submit(f))
        toks.append(pend[-1])
        while len(pend) >= depth:
            out.append(enc.encode_collect(pend.pop(0)))
    while pend:
        out.append(enc.encode_collect(pend.pop(0)))
    return out, toks


def _token_qp(tok) -> int:
    kind, payload = tok[0], tok[4]
    if kind == "ring":
        return payload[0].qp
    return payload[2] if kind == "intra" else payload[0]


def _pinned_per_frame(env, w, h, qps):
    """The port's per-frame path at the qps a ring run coded (the ring
    holds one qp per chunk where the rate controller moves it per
    frame): rate control off, each frame's qp taken from ``qps``."""
    enc = t_make(t_env(dict(env, ENCODER_SUPERSTEP_CHUNK="0",
                            ENCODER_BITRATE_KBPS="0")), w, h,
                 device="cpu")[0]
    it = iter(qps)
    enc._eff_qp = lambda keyframe=True: next(it)
    assert enc._ring_chunk == 0
    return enc


@pytest.fixture(scope="module")
def ring_run():
    """The JAX ring and the port's ring over two GOPs and more (gop 9,
    chunk 4), pipelined at depth 5, the RateController moving qp between
    chunks: a noise P frame inside the first chunk overflows the packer,
    a keyframe is requested with a chunk half staged, and the run ends
    on a partial chunk that the drain flushes.  Then the port's
    per-frame path at the ring's qps."""
    je = j_make(j_env(RING_ENV), W, H)[0]
    te = t_make(t_env(RING_ENV), W, H, device="cpu")[0]
    assert te._ring_chunk == 4 and te.pipeline_depth == 5
    assert je._ring_chunk == 4
    frames = _frames(23, noisy_at=3)
    kf = (15,)
    run = {"te": te, "frames": frames, "stats": [], "qps": []}
    # collect both rings in lockstep to compare the content stats too
    pj, pt, want, got = [], [], [], []
    for i, f in enumerate(frames + [None]):
        if f is not None:
            if i in kf:
                je.request_keyframe()
                te.request_keyframe()
            pj.append(je.encode_submit(f))
            pt.append(te.encode_submit(f))
            run["qps"].append(_token_qp(pt[-1]))
        while len(pj) >= 5 or (f is None and pj):
            a, b = je.encode_collect(pj.pop(0)), te.encode_collect(pt.pop(0))
            want.append(a)
            got.append(b)
            run["stats"].append((je.pop_content_stats(),
                                 te.pop_content_stats()))
    run["want"], run["got"] = want, got
    tp = _pinned_per_frame(RING_ENV, W, H, run["qps"])
    run["per"], run["per_toks"] = _drive(tp, frames, kf)
    return run


def test_ring_aus_equal_the_reference_and_the_per_frame_path(ring_run):
    want, got = ring_run["want"], ring_run["got"]
    per = ring_run["per"]
    assert len(want) == len(got) == len(per) == 23
    for i, (a, b, c) in enumerate(zip(want, got, per)):
        assert a.data == b.data, f"frame {i}: ring differs from JAX's"
        assert b.data == c.data, f"frame {i}: ring differs from per-frame"
        assert a.keyframe == b.keyframe == c.keyframe
        assert a.frame_index == b.frame_index == i
    assert [e.keyframe for e in got] == [i in (0, 9, 15)
                                         for i in range(23)]
    te = ring_run["te"]
    assert te._rate.pending_count == 0
    # the chunks ran through the step (the eager body on the CPU)
    assert list(te._chunk_steps) == [("cavlc", "yuv", 0)]


def test_ring_covers_overflow_rate_control_and_flushes(ring_run):
    toks = ring_run["per_toks"]
    kinds = [t[0] for t in toks]
    assert kinds[3] == "p"
    # the per-frame twin's noise frame overflowed: the ring coded it from
    # the chunk's levels, with the same bytes (above)
    prefix = toks[3][4][5][0]
    assert cavlc_device.FlatMeta(prefix.numpy(), 3).overflow
    p_qps = {q for q, k in zip(ring_run["qps"], kinds) if k == "p"}
    assert len(p_qps) > 1, ring_run["qps"]


def test_ring_content_stats_equal_the_reference(ring_run):
    for i, (a, b) in enumerate(ring_run["stats"]):
        _same_stats(a, b)
    assert any(a is not None and a["frame_type"] == "p"
               for a, _ in ring_run["stats"])


def test_cabac_device_binarize_ring_equals_the_reference(monkeypatch):
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")
    env = {"SIZEW": "48", "SIZEH": "32", "ENCODER_GOP": "8",
           "ENCODER_ENTROPY": "cabac", "ENCODER_BITRATE_KBPS": "0",
           "ENCODER_QP": "24", "ENCODER_SUPERSTEP_CHUNK": "3"}
    je = j_make(j_env(env), 48, 32)[0]
    te = t_make(t_env(env), 48, 32, device="cpu")[0]
    tp = t_make(t_env(dict(env, ENCODER_SUPERSTEP_CHUNK="0")), 48, 32,
                device="cpu")[0]
    assert te._ring_chunk == je._ring_chunk == 3
    frames = _frames(10, w=48, h=32, seed=9)
    a, b, c = (_drive(e, frames)[0] for e in (je, te, tp))
    for i, (x, y, z) in enumerate(zip(a, b, c)):
        assert x.data == y.data == z.data, f"frame {i}"
    assert ("cabac", "yuv", 0) in te._chunk_steps


def test_rgb_ingest_ring_equals_the_reference():
    """host_color=False: K9's frame axis converts the staged chunk."""
    kw = dict(mode="cavlc", entropy="device", host_color=False, gop=9,
              deblock=True, superstep_chunk=4)
    je = j_h264.H264Encoder(W, H, **kw)
    te = TEnc(W, H, device="cpu", **kw)
    tp = TEnc(W, H, device="cpu", **dict(kw, superstep_chunk=0))
    frames = _frames(11, seed=5)
    launches = color.rgb_to_yuv420_frames.launches
    a, b, c = (_drive(e, frames)[0] for e in (je, te, tp))
    for i, (x, y, z) in enumerate(zip(a, b, c)):
        assert x.data == y.data == z.data, f"frame {i}"
    assert ("cavlc", "rgb", 0) in te._chunk_steps
    assert color.rgb_to_yuv420_frames.launches == launches   # CPU: plain


def test_mid_gop_reference_state_continues_in_the_ring():
    env = dict(RING_ENV, ENCODER_GOP="12")
    frames = _frames(14, seed=7)
    je = j_make(j_env(env), W, H)[0]
    for f in frames[:4]:
        je.encode(f)
    state = je.export_state()
    assert state["gop_pos"] == 4 and state["frame_num"] == 3
    j2 = j_make(j_env(env), W, H)[0]
    te = t_make(t_env(env), W, H, device="cpu")[0]
    j2.import_state(state)
    te.import_state(state)
    a, _ = _drive(j2, frames[4:])
    b, _ = _drive(te, frames[4:])
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.data == y.data and x.frame_index == y.frame_index, i
    st = te.export_state()
    for k in ("gop_pos", "frame_num", "idr_count", "frame_index", "rate"):
        assert st[k] == j2.export_state()[k], k


# -- the chunk's kernels: plain versions against the reference -------------

def test_k9_frame_axis_equals_stack_luma():
    rng = np.random.default_rng(2)
    rgbs = rng.integers(0, 256, (3, 46, 62, 3), np.uint8)
    rgbs[1] = rgbs[1] // 8 * 8                    # flat-ish frame
    ys, cbs, crs = color.rgb_to_yuv420_frames(torch.from_numpy(rgbs), 48, 64)
    want = np.asarray(j_h264._stack_luma(jnp.asarray(rgbs), 48, 64))
    np.testing.assert_array_equal(ys.numpy(), want)
    for i in range(3):
        one = color.rgb_to_yuv420(torch.from_numpy(rgbs[i]), 48, 64)
        for a, b in zip((ys, cbs, crs), one):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("form", ["full", "recon", "bare", "no-prev"])
def test_k4c_plain_equals_chunk_stats(form):
    rng = np.random.default_rng(4)
    k, r, c = 3, 3, 4
    ys = rng.integers(0, 256, (k, 16 * r, 16 * c), np.uint8)
    ys[1] = ys[0]
    ys[1, :16, :16] ^= 0x40                       # one damaged MB
    prev = None if form == "no-prev" else ys[2].copy()
    recon = (ys[-1] ^ 3).astype(np.uint8) if form in ("full", "recon") \
        else None
    mvs = resid = None
    if form == "full":
        mvs = rng.integers(-12, 13, (k, r, c, 2), np.int32)
        mvs[0, 0, 0] = 0
        resid = tuple(np.where(rng.random(s) < 0.1,
                               rng.integers(-3, 4, s), 0).astype(np.int32)
                      for s in ((k, r, c, 16, 16), (k, r, c, 4),
                                (k, r, c, 4, 15), (k, r, c, 4),
                                (k, r, c, 4, 15)))
        for t in resid:
            t[0, 0, 0] = 0
    t = lambda a: None if a is None else torch.from_numpy(a)
    vecs, grids = content_stats.chunk_stats(
        t(ys), t(prev), 512, t(recon), t(mvs),
        None if resid is None else tuple(t(a) for a in resid))
    j = lambda a: None if a is None else jnp.asarray(a)
    wv, wg = j_cs.chunk_stats(j(ys), j(prev), j(recon), j(mvs),
                              None if resid is None
                              else tuple(j(a) for a in resid), thr_sad=512)
    np.testing.assert_array_equal(grids.numpy(), np.asarray(wg))
    wv = np.asarray(wv)
    got = vecs.numpy()
    ints = [1, 2, 3, 4, 9]
    np.testing.assert_array_equal(got[:, ints], wv[:, ints])
    np.testing.assert_allclose(got, wv, rtol=1e-5)


def test_chunk_step_checks_its_configuration():
    kw = dict(chunk=4, pad_h=48, pad_w=64)
    with pytest.raises(ValueError):
        devloop.ChunkStep(entropy="native", **kw)
    with pytest.raises(ValueError):
        devloop.ChunkStep(ingest="bgr", **kw)
    with pytest.raises(ValueError):
        devloop.ChunkStep(entropy="cabac", damage_bucket=2, **kw)
    with pytest.raises(ValueError):
        devloop.ChunkStep(ingest="rgb", damage_bucket=2, **kw)
    step = devloop.ChunkStep(**kw)
    with pytest.raises(ValueError):
        step([], None, None, None, None, 26, owner=None)


def test_a_graph_instance_is_free_once_its_owner_lets_go():
    """A replay overwrites its instance's outputs: the step reuses an
    instance only when the ring holding them released it or is gone."""
    import weakref

    class Ring:
        released = False

    inst = devloop._Instance(None)
    assert inst.free()                       # never replayed
    ring = Ring()
    inst.owner = weakref.ref(ring)
    assert not inst.free()
    ring.released = True
    assert inst.free()
    ring2 = Ring()
    inst.owner = weakref.ref(ring2)
    del ring2                                # the tokens were dropped
    assert inst.free()


def test_graph_budget_drops_the_least_recently_replayed_free_instance():
    """An encoder's steps share a budget of instances: a capture past it
    drops the free instance replayed longest ago (an idle damage
    bucket's), never one whose outputs are still held."""
    import weakref

    class Ring:
        released = False

    budget = devloop.GraphBudget(limit=3)
    steps = [devloop.ChunkStep(chunk=4, pad_h=48, pad_w=64,
                               damage_bucket=b, budget=budget)
             for b in (0, 1, 2)]
    rings, insts = [], []
    for i, step in enumerate(steps):
        inst = devloop._Instance(step)
        inst.pool_bytes = 10 * (i + 1)
        step.instances.append(inst)
        budget.add(inst)
        rings.append(Ring())
        inst.owner = weakref.ref(rings[-1])
        insts.append(inst)
    assert budget.pool_bytes == budget.peak_bytes == 60
    with pytest.raises(RuntimeError):        # every instance still held
        budget.make_room()
    budget.use(insts[0])                     # the full-frame key stays hot
    for ring in rings:
        ring.released = True
    budget.make_room()
    assert budget.live == [insts[2], insts[0]] and budget.evicted == 1
    assert steps[1].instances == [] and insts[1].graph is None
    assert budget.pool_bytes == 40 and budget.peak_bytes == 60
    assert (budget.captures, budget.replays) == (3, 1)


def test_ring_eligibility_follows_the_reference():
    for kw in (dict(gop=1), dict(keep_recon=True), dict(superstep_chunk=1),
               dict(entropy="cabac")):
        args = dict(dict(gop=9, superstep_chunk=4, host_color=True), **kw)
        te = TEnc(W, H, mode="cavlc", device="cpu", **args)
        je = j_h264.H264Encoder(W, H, mode="cavlc", **args)
        if args.get("entropy") == "cabac":
            te._cabac_dev_bin = je._cabac_dev_bin = False
        assert te._ring_chunk == je._ring_chunk == 0, kw
        assert te.pipeline_depth == je.pipeline_depth == 2
    te = TEnc(W, H, mode="cavlc", device="cpu", gop=9, superstep_chunk=9)
    assert te._ring_chunk == 6 and te.pipeline_depth == 7
