"""The port's bench entry point (``docker_nvidia_glx_desktop_tpu_torch.
bench``) against the reference's ``bench.py`` on the CPU: the host helpers
(the bench frames, the BD-rate content classes, the Bjontegaard delta),
one BD-rate point's bits and PSNR frame by frame against the JAX encoder
and ``aq.psnr_planes``, the default bench driven end to end at a small
geometry, and the refusals: no CUDA without ``--device cpu``, and each
unported mode naming its ROADMAP item."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.models.h264 import _yuv_stage
from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
from docker_nvidia_glx_desktop_tpu_torch import bench as tb

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jb():
    """The reference's bench.py as a module (its top level imports only
    the standard library)."""
    spec = importlib.util.spec_from_file_location("reference_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_frames_equal_the_reference(jb):
    got, want = tb.make_frames(), jb.make_frames()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["desktop_text", "natural_gradients",
                                  "panning_motion", "scrolling"])
def test_bdrate_frames_equal_the_reference(jb, kind):
    got = tb._bdrate_frames(kind, 80, 48, 3)
    want = jb._bdrate_frames(kind, 80, 48, 3)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tb._bdrate_frames("nope", 80, 48, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bd_rate_pct_equals_the_reference(jb, seed):
    r = np.random.default_rng(seed)
    psnr_a = np.sort(r.uniform(28, 42, 4))
    psnr_b = np.sort(r.uniform(28, 42, 4))
    rate_a = np.sort(r.uniform(1e3, 1e5, 4))
    rate_b = np.sort(r.uniform(1e3, 1e5, 4))
    assert tb._bd_rate_pct(rate_a, psnr_a, rate_b, psnr_b) == \
        jb._bd_rate_pct(rate_a, psnr_a, rate_b, psnr_b)
    assert tb._bd_rate_pct(rate_a, psnr_a, rate_a, psnr_a) == 0.0


@pytest.mark.parametrize("tier,qp", [("off", 26), ("off", 38), ("hq", 26),
                                     ("hq", 38)])
def test_run_tier_bits_and_psnr_equal_the_reference(tier, qp):
    """One BD-rate point (3 frames of one class as one GOP, keep_recon):
    each frame's bits and luma PSNR (reconstruction against the colour
    stage's source luma) against the JAX encoder and aq.psnr_planes."""
    w, h = 64, 48
    frames = tb._bdrate_frames("desktop_text", w, h, 3)
    enc = JEnc(w, h, qp=qp, mode="cavlc", entropy="device", gop=3,
               keep_recon=True, tune=tier)
    bits, psnr = [], []
    for f in frames:
        src = np.asarray(_yuv_stage(jnp.asarray(f), enc.pad_h,
                                    enc.pad_w)[0])
        bits.append(len(enc.encode(f).data) * 8)
        psnr.append(j_aq.psnr_planes(enc.last_recon[0], src))
    got = tb.run_tier(frames, tier, qp, w, h, device="cpu")
    assert got["frame_bits"] == bits and got["bits"] == sum(bits)
    assert got["frame_psnr_y"] == psnr
    assert got["psnr_y"] == round(float(np.mean(psnr)), 3)
    assert got["energy"]["frames"] == 3
    assert tb.run_tier(frames, tier, qp, w, h, device="cpu",
                       warm_only=True) is None


def test_main_drives_every_block_on_the_cpu(monkeypatch):
    """The default bench end to end with the plain versions at a small
    geometry (the bench frames cut to 64x48, 4K cut to 128x96, few
    frames): every block fills its keys and none reports an error."""
    full = tb.make_frames()
    monkeypatch.setattr(tb, "make_frames",
                        lambda: [np.ascontiguousarray(f[500:548, :64])
                                 for f in full])
    monkeypatch.setattr(tb, "FOURK", (128, 96))
    monkeypatch.setenv("BENCH_TIMEOUT_S", "100000")
    monkeypatch.setenv("BENCH_FRAMES", "4")
    monkeypatch.setenv("BENCH_FRAMES_GOP", "3")
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    def two_calls(loop_fn, budget_s=0.0, k_lo=4):
        loop_fn(1)
        loop_fn(2)
        return {"step_ms": 1.0, "fps": 1000.0, "k_hi": 2}

    monkeypatch.setattr(devloop, "measure_steady_state", two_calls)
    res = tb.main(device="cpu")
    assert res["metric"] == "h264_cavlc_1080p_intra_encode_fps_per_chip"
    assert res["value"] > 0 and res["device"] == {"platform": "cpu"}
    assert res["gop"]["fps"] > 0
    assert set(res["device_only"]) == {"intra_fps", "intra_step_ms", "p_fps",
                                       "p_step_ms", "p_deblock_in_loop"}
    cab = res["cabac"]
    assert "error" not in cab and "binarize_error" not in cab
    assert cab["cavlc_host_code_ms"] > 0
    assert cab["cavlc_host_code_ms_per_row"] > 0
    assert {"intra_device_step_ms", "host_unpack_ms", "intra_host_code_ms",
            "intra_device_binarize_step_ms", "intra_host_engine_ms",
            "p_device_step_ms"} <= set(cab)
    k = res["4k"]
    assert not any(key.endswith("error") for key in k), k
    assert k["profile"]["me_step_ms_r5_fullline"] > 0
    # K8 has one schedule: the loop filter is timed once, under one key
    assert set(k["profile"]) == {"me_step_ms", "me_step_ms_r5_fullline",
                                 "me_improvement_pct", "deblock_step_ms",
                                 "entropy_step_ms_est"}
    assert set(k["budget_attribution"]) == {"device-me", "device-deblock",
                                            "device-entropy"}
    assert k["sharded"] == {"skipped": "single-device backend"}


def test_the_bench_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.bdrate_main(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.cli(["--bdrate", "--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.run_tier([], "off", 26, 64, 48)


@pytest.mark.parametrize("argv,item", [
    (["--spatial"], "11m"), (["--serving-budget"], "6b"), (["--chaos"], "6b"),
    (["--fleet"], "14"), (["--quick"], "15b"),
    (["--spatial", "--quick"], "11m")])
def test_unported_modes_raise_naming_the_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tb.cli(argv + ["--device", "cpu"])
