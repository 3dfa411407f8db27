"""The device-only timing loops (rows 17a-f) and the distortion reduction
(row 14d) in the port against the reference on the CPU: each loop's
checksum at 1, 2 and 3 steps with its options on and off, the chained
loops' final planes against the reference's body unrolled, the loops'
kernels K17p and K17c plain against the reference's perturbation and
carry, and the SSE, MSE and PSNR on seeded planes, with the reference's
int32 overflow pinned as the known difference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
from docker_nvidia_glx_desktop_tpu.ops import cavlc_p_device as j_cp
from docker_nvidia_glx_desktop_tpu.ops import devloop as j_loop
from docker_nvidia_glx_desktop_tpu.ops import h264_deblock as j_db
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import aq as t_aq
from docker_nvidia_glx_desktop_tpu_torch.ops import devloop as t_loop

W, H = 64, 48
QP = 26


def _planes(seed, w=W, h=H):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (h, w), np.uint8),
            r.integers(0, 256, (h // 2, w // 2), np.uint8),
            r.integers(0, 256, (h // 2, w // 2), np.uint8))


@pytest.fixture(scope="module")
def data():
    """Seeded noise planes with a 255 run (the saturating perturbation),
    an unrelated reference (nonzero residuals everywhere) and both
    encoders' slice-header slots."""
    cur = _planes(7)
    cur[0][:2, :] = 255
    ref = _planes(8)
    je = JEnc(W, H, mode="cavlc", entropy="device")
    te = TEnc(W, H, mode="cavlc", entropy="device", device="cpu")
    return {
        "j": [jnp.asarray(a) for a in cur], "jr": [jnp.asarray(a) for a in ref],
        "t": [torch.from_numpy(a.copy()) for a in cur],
        "tr": [torch.from_numpy(a.copy()) for a in ref],
        "ref_np": ref,
        "j_i": je._hdr_slots(0, 0), "t_i": te._hdr_slots(0, 0),
        "j_p": je._p_hdr_slots(1, 0), "t_p": te._p_hdr_slots(1, 0)}


def _call(d, side, loop, k, opts):
    """One loop call on the reference (``side`` "j", steps a traced int32)
    or the port ("t")."""
    mod = j_loop if side == "j" else t_loop
    steps = jnp.int32(k) if side == "j" else k
    cur, ref = d[side], d[side + "r"]
    if loop == "intra":
        out = mod.intra_loop(*cur, *d[side + "_i"], steps, QP)
    elif loop == "p":
        out = mod.p_loop(*cur, *ref, *d[side + "_p"], steps, QP, **opts)
    elif loop == "cabac_intra":
        out = mod.cabac_intra_loop(*cur, steps, QP, **opts)
    elif loop == "inter":
        out = mod.inter_loop(*cur, *ref, steps, QP)
    elif loop == "deblock":
        out = mod.deblock_loop(*cur, steps, QP, **opts)
    else:
        out = mod.cabac_p_loop(*cur, *ref, steps, QP, **opts)
    return int(np.asarray(out))


# every option on and off (each reference configuration is one compile)
LOOPS = [("intra", {}), ("p", {"deblock": True}), ("p", {"deblock": False}),
         ("cabac_intra", {"binarize": False}),
         ("cabac_intra", {"binarize": True}), ("inter", {}), ("deblock", {}),
         ("cabac_p", {"deblock": True, "binarize": False}),
         ("cabac_p", {"deblock": False, "binarize": True})]


@pytest.mark.parametrize("loop,opts", LOOPS, ids=[
    f"{n}-" + "-".join(f"{k}={v}" for k, v in o.items()) for n, o in LOOPS])
def test_loop_checksum_equals_the_reference(data, loop, opts):
    got = [_call(data, "t", loop, k, opts) for k in (1, 2, 3)]
    want = [_call(data, "j", loop, k, opts) for k in (1, 2, 3)]
    assert got == want


@pytest.mark.parametrize("group", [1, 8])
def test_deblock_loop_groups_are_one_function(data, group):
    """The reference's wavefront groups are schedules of one filter: every
    value gives the group-0 reference's checksum."""
    want = [_call(data, "j", "deblock", k, {}) for k in (1, 2, 3)]
    assert [_call(data, "t", "deblock", k, {"group": group})
            for k in (1, 2, 3)] == want


def test_the_inter_checksum_is_a_level_of_the_p_core(data):
    """The inter loop's checksum is the first luma level of the P core's
    first step (nonzero here: the reference is unrelated noise)."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter

    i0 = torch.zeros(1, dtype=torch.int32)
    lv = h264_inter.encode_p_frame(*t_loop.perturb(*data["t"], i0),
                                   *data["tr"], QP)["luma"]
    want = int(lv[0, 0, 0, 0]) & 0xFFFFFFFF
    assert want != 0 and _call(data, "t", "inter", 1, {}) == want


def _j_perturb(planes, i):
    return [j_loop._perturb(p, jnp.int32(i)) for p in planes]


def test_p_loop_final_planes_equal_the_reference_chain(data):
    """Two steps of the reference's P body unrolled (P CAVLC stage, loop
    filter, the recon as the next reference) against the port's final
    chained planes; the caller's reference planes stay as they were."""
    ry, rcb, rcr = data["jr"]
    for i in range(2):
        _, ry, rcb, rcr, mv, nnz, _ = j_cp.encode_p_cavlc_frame(
            *_j_perturb(data["j"], i), ry, rcb, rcr, *data["j_p"], QP)
        ry, rcb, rcr = j_db.deblock_frame(ry, rcb, rcr, QP, nnz_blk=nnz,
                                          mv=mv)
    _, flat, final = t_loop.p_loop(*data["t"], *data["tr"], *data["t_p"], 2,
                                   QP, full=True)
    for got, want in zip(final, (ry, rcb, rcr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert flat.dtype == torch.uint8
    for t, a in zip(data["tr"], data["ref_np"]):
        np.testing.assert_array_equal(t.numpy(), a)


def test_deblock_loop_final_planes_equal_the_reference_chain(data):
    fy, fcb, fcr = data["j"]
    for i in range(3):
        fy, fcb, fcr = j_db.deblock_frame(*_j_perturb((fy, fcb, fcr), i), QP)
    _, last, final = t_loop.deblock_loop(*data["t"], 3, QP, full=True)
    for got, want in zip(final, (fy, fcb, fcr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(last, final[0])


def test_zero_steps_and_the_unported_options(data):
    assert int(t_loop.intra_loop(*data["t"], *data["t_i"], 0, QP)) == 0
    # the options serve now (tests/test_torch_intra_modes.py holds their
    # checksums against the reference's loops); unknown values raise
    with pytest.raises(ValueError, match="unknown refine"):
        t_loop.inter_loop(*data["t"], *data["tr"], 1, QP, refine="half")
    with pytest.raises(ValueError, match="unknown i16_modes"):
        t_loop.intra_loop(*data["t"], *data["t_i"], 1, QP, i16_modes="nine")
    with pytest.raises(ValueError, match="unknown i16_modes"):
        t_loop.cabac_intra_loop(*data["t"], 1, QP, i16_modes="i4")
    with pytest.raises(TypeError):
        t_loop.deblock_loop(*[np.asarray(p) for p in data["t"]], 1, QP)


@pytest.mark.parametrize("i", [0, 1, 2, 7])
def test_perturb_plain_equals_the_reference(data, i):
    got = t_loop.perturb(*data["t"], torch.tensor([i], dtype=torch.int32))
    for g, w in zip(got, _j_perturb(data["j"], i)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert t_loop.perturb.launches == 0       # CPU tensors: the plain path


def test_tick_plain_is_the_references_uint32_carry():
    """K17c plain: int32 words (negative levels) and uint8 bytes summed as
    uint32 with wraparound, the index advanced once a call."""
    acc = torch.zeros(1, dtype=torch.int32)
    i_dev = torch.zeros(1, dtype=torch.int32)
    words = [torch.tensor([-5, 3], dtype=torch.int32),
             torch.tensor([2**31 - 1], dtype=torch.int32),
             torch.tensor([250, 7], dtype=torch.uint8)]
    want = jnp.uint32(0)
    for w, off in zip(words, (0, 0, 0)):
        t_loop.tick(acc, w, off, i_dev)
        want = want + jnp.asarray(w.numpy()[off]).astype(jnp.uint32)
    assert int(acc) & 0xFFFFFFFF == int(want) and int(i_dev) == 3
    with pytest.raises(ValueError):
        t_loop.tick(acc, words[0], 2, i_dev)


def test_measure_steady_state_differences_two_trip_counts(data):
    calls = []

    def run(k):
        calls.append(k)
        return t_loop.deblock_loop(*data["t"], k, QP)

    out = t_loop.measure_steady_state(run, budget_s=1.0)
    assert set(out) == {"step_ms", "fps", "k_hi"} and out["fps"] > 0
    assert calls[:2] == [1, 4] and calls.count(out["k_hi"]) == 2


# -- row 14d: SSE, MSE, PSNR ---------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((48, 64), 1), ((17, 23), 2),
                                        ((1088, 1920), 3)])
def test_sse_mse_psnr_equal_the_reference(shape, seed):
    r = np.random.default_rng(seed)
    a = r.integers(0, 256, shape, np.uint8)
    b = np.clip(a.astype(np.int32) + r.integers(-6, 7, shape), 0,
                255).astype(np.uint8)
    want_sse = int(((a.astype(np.int64) - b) ** 2).sum())
    assert int(t_aq.sse_planes(a, b, device="cpu")) == want_sse
    assert t_aq.mse_planes(a, b, device="cpu") == j_aq.mse_planes(a, b)
    assert t_aq.psnr_planes(a, b, device="cpu") == j_aq.psnr_planes(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert t_aq.psnr_planes(ta, tb) == j_aq.psnr_planes(a, b)
    assert t_aq.psnr_planes(a, a, device="cpu") == 99.0 \
        == j_aq.psnr_planes(a, a)


def test_full_scale_sse_is_exact_where_the_reference_wraps():
    """Zeros against 255 at 1088x1920: 255^2 a pixel.  The port's int64 sum
    gives 65025; the reference's int32 sum wraps (x64 off) and gives
    -768.004, the known difference (ROADMAP "Known differences")."""
    a = np.zeros((1088, 1920), np.uint8)
    b = np.full((1088, 1920), 255, np.uint8)
    sse = int(((a.astype(np.int64) - b) ** 2).sum())
    assert t_aq.mse_planes(a, b, device="cpu") == 65025.0
    assert int(t_aq.sse_planes(a, b, device="cpu")) == sse
    wrapped = (sse + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert j_aq.mse_planes(a, b) == wrapped / a.size
    assert round(j_aq.mse_planes(a, b), 1) == -768.0


def test_the_distortion_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_aq.psnr_planes(a, a)
    with pytest.raises(ValueError, match="uint8"):
        t_aq.sse_planes(a.astype(np.int32), a, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        t_aq.sse_planes(a, a[:8], device="cpu")


@pytest.mark.parametrize("fail", [False, True], ids=["ends", "raises"])
def test_graph_capture_holds_the_cycle_collector_off(monkeypatch, fail):
    """A collection inside a capture that destroys a dead CUDA graph (one
    held only by a reference cycle) invalidates the capture, so every
    capture runs with the collector off and turns it back on afterwards,
    also when the body raises.  ``torch.cuda.graph`` is stood in for here:
    the capture itself needs the card."""
    import contextlib
    import gc

    seen = []

    @contextlib.contextmanager
    def fake_graph(g):
        seen.append(("enter", g, gc.isenabled()))
        yield
        seen.append(("exit", g, gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    assert gc.isenabled()
    graph = object()
    with contextlib.suppress(RuntimeError):
        with t_loop.graph_capture(graph):
            seen.append(("body", None, gc.isenabled()))
            if fail:
                raise RuntimeError("a kernel failed to launch")
    assert gc.isenabled()
    want = [("enter", graph, False), ("body", None, False)]
    assert seen == (want if fail else want + [("exit", graph, False)])
