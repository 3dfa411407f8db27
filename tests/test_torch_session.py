"""The single-session serving core on the port (``web/session``:
``StreamSession``, ``SubscriberSet``, ``keyframe_requester``; the obs and
resilience modules it stands on) against the reference's session on the
same seeded frames: the access units, the dispatch samples the budget
ledger gets and the journeys' chunk identity, per frame and in the chunk
ring.  The port's session runs in a subprocess with JAX blocked; the
reference's JAX package is imported inside the tests only."""

import asyncio
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent

# CQP (no rate control): the reference compiles one program per qp
CONFIGS = {
    "gop": ({"ENCODER_GOP": "4", "ENCODER_BITRATE_KBPS": "0"}, 9),
    "ring": ({"ENCODER_GOP": "8", "ENCODER_SUPERSTEP_CHUNK": "3",
              "ENCODER_BITRATE_KBPS": "0"}, 10),
}


class ScriptSource:
    """``n`` seeded desktop frames, then the last one again with the same
    sequence number (an idle desktop: the session drains and waits)."""

    def __init__(self, w: int, h: int, n: int, seed: int = 0):
        self.width, self.height, self.n = w, h, n
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        self.base = np.stack([(xx * 255 // (w - 1)), (yy * 255 // (h - 1)),
                              ((xx + yy) * 3) % 256], -1).astype(np.uint8)
        self.band = (rng.integers(0, 2, (6, w // 4, 3)) * 170
                     + 40).astype(np.uint8).repeat(4, 1)
        self.t = 0

    def render(self, t: int):
        f = self.base.copy()
        x0 = (3 * t) % (self.width // 2)
        f[self.height // 4:self.height // 2, x0:x0 + self.width // 4] = 230
        f[self.height // 2:self.height // 2 + 6] = np.roll(self.band, 2 * t, 1)
        return f

    def frame(self):
        t = min(self.t, self.n - 1)
        self.t += 1
        return self.render(t), t


def _published(sess) -> int:
    return sum(d["t_publish"] is not None for d in sess.journeys.recent(64))


def run_session(session_mod, from_env, budget, name: str, **kw) -> dict:
    """One StreamSession on its encode thread until every frame's AU came
    out and its journey completed: the AUs, the dispatch samples and the
    journeys' chunk identity.

    The budget ledger is process-wide: another session of the same process
    (one that an earlier test stopped while its thread was still inside a
    submit) may record a dispatch at any time, so only the samples that
    this session's encode thread records are kept; the rest go on to the
    ledger.  The session calls its AU listeners before it completes the
    frame's journey, so the run ends once both counts are ``n``."""
    env, n = CONFIGS[name]
    cfg = from_env(dict({"SIZEW": "64", "SIZEH": "48", "REFRESH": "60"}, **env))
    src = ScriptSource(64, 48, n)
    sess = session_mod.StreamSession(cfg, src, **kw)
    aus, disp = [], []
    sess.add_au_listener(lambda au, key, pts: aus.append((bytes(au), key)))
    orig = budget.LEDGER.record_dispatch

    def record(c, g):
        if threading.current_thread() is sess._thread:
            disp.append(int(c))
        else:
            orig(c, g)

    budget.LEDGER.record_dispatch = record
    try:
        sess.start()
        deadline = time.monotonic() + 300
        while ((len(aus) < n or _published(sess) < n)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        sess.stop()
    finally:
        budget.LEDGER.record_dispatch = orig
    # one sample a frame: the thread filter kept this session's dispatches
    assert len(disp) == n, (name, disp)
    journeys = [(d.get("chunk_len", 1), d.get("slot", 0), d["shards"],
                 d.get("chunk_id") is not None)
                for d in sess.journeys.recent(64)]
    out = {"aus": aus, "dispatch": disp, "journeys": journeys,
           "codec": sess.codec_name,
           "stats": sess.stats_summary()["frames_total"]}
    sess.close()
    return out


def port_main(out_path: str) -> None:
    """The subprocess: the port's sessions on the CPU with JAX blocked."""
    from docker_nvidia_glx_desktop_tpu_torch.obs import budget
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.web import session

    res = {name: run_session(session, from_env, budget, name, device="cpu")
           for name in CONFIGS}
    res["leaked"] = sorted(m for m in sys.modules
                           if m == "docker_nvidia_glx_desktop_tpu"
                           or m.startswith("docker_nvidia_glx_desktop_tpu."))
    res["jax"] = sys.modules.get("jax", "absent")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


_RUNNER = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
sys.path.insert(0, {here!r})
import test_torch_session as T
T.port_main({out!r})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from docker_nvidia_glx_desktop_tpu.obs import budget
    from docker_nvidia_glx_desktop_tpu.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu.web import session

    out = tmp_path_factory.mktemp("sess") / "out.pkl"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUNNER.format(repo=str(REPO), here=str(HERE),
                                              out=str(out))],
        cwd=str(REPO.parent), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = {name: run_session(session, from_env, budget, name)
           for name in CONFIGS}
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        port = pickle.load(f)
    return ref, port


@pytest.mark.parametrize("name", list(CONFIGS))
def test_session_access_units_equal_the_reference(runs, name):
    ref, port = runs
    n = CONFIGS[name][1]
    assert len(port[name]["aus"]) == n
    assert port[name]["aus"] == ref[name]["aus"]
    assert port[name]["codec"] == ref[name]["codec"] == "h264_cavlc"
    assert port[name]["stats"] == ref[name]["stats"] == n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dispatch_and_journey_hooks_equal_the_reference(runs, name):
    """The budget ledger's dispatch samples (a ring frame costs 0, the
    frame that fills a chunk 1) and the journeys' chunk identity."""
    ref, port = runs
    assert port[name]["dispatch"] == ref[name]["dispatch"]
    assert port[name]["journeys"] == ref[name]["journeys"]
    if name == "ring":
        assert 0 in port[name]["dispatch"]
        assert {j[0] for j in port[name]["journeys"]} == {1, 3}


def test_the_port_session_ran_with_jax_blocked(runs):
    _, port = runs
    assert port["leaked"] == [] and port["jax"] is None


def test_encoder_hooks_equal_the_reference_frame_by_frame():
    """H264Encoder.pop_dispatch_sample / pop_journey_meta, pipelined at
    the ring's depth, on the same frames as the reference encoder."""
    from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as J
    from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as P

    kw = dict(qp=26, mode="cavlc", entropy="device", gop=8, deblock=True,
              host_color=True, superstep_chunk=3)
    encs = [J(64, 48, **kw), P(64, 48, device="cpu", **kw)]
    src = ScriptSource(64, 48, 10)
    seen = [[], []]
    for e, out in zip(encs, seen):
        pending = []
        for t in range(10):
            pending.append(e.encode_submit(src.render(t)))
            out.append(("d", e.pop_dispatch_sample()[0]))
            if len(pending) > e.pipeline_depth - 1:
                ef = e.encode_collect(pending.pop(0))
                out.append(("j", e.pop_journey_meta(), ef.data))
        while pending:
            ef = e.encode_collect(pending.pop(0))
            out.append(("j", e.pop_journey_meta(), ef.data))
    assert seen[1] == seen[0]
    assert encs[1].pop_journey_meta() is None


# -- the port alone ---------------------------------------------------------

def _cfg(**env):
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    return from_env(dict({"SIZEW": "64", "SIZEH": "48"}, **env))


def test_the_session_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.web.session import StreamSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamSession(_cfg(), ScriptSource(64, 48, 1))
    sess = StreamSession(_cfg(ENCODER_BITRATE_KBPS="0"),
                         ScriptSource(64, 48, 1), device="cpu")
    assert sess.encoder.device.type == "cpu"
    assert sess.COMPILE_GRACE_S == 180.0
    sess.close()


def test_restore_encoder_round_trips_the_device_and_imports_the_lineage():
    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.resilience import continuity

    cfg = _cfg(ENCODER_GOP="4", ENCODER_BITRATE_KBPS="0")
    enc, _ = make_encoder(cfg, 64, 48, device="cpu")
    src = ScriptSource(64, 48, 3)
    for t in range(3):
        enc.encode(src.render(t))
    ckpt = enc.export_state()
    new, codec = continuity.restore_encoder(cfg, 64, 48, ckpt, device="cpu")
    assert codec == "h264_cavlc" and new.frame_index == 3
    assert new._gop_pos == enc._gop_pos and new._force_idr
    assert new.encode(src.render(3)).keyframe


def test_prewarm_and_the_link_probe_on_the_cpu(monkeypatch):
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.obs.budget import LEDGER

    enc = H264Encoder(64, 48, mode="cavlc", gop=8, superstep_chunk=3,
                      device="cpu")
    th, stop = enc.prewarm_async()
    th.join(30)
    assert not th.is_alive() and enc.prewarm() == 0
    res = LEDGER.probe_link(device="cpu")
    assert LEDGER.link_rtt_ms == res["rtt_ms"] >= 0
    assert len(res["samples"]) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LEDGER.probe_link()


def test_probe_loop_sums_like_the_reference_loop():
    import jax.numpy as jnp
    import torch

    from docker_nvidia_glx_desktop_tpu.ops.devloop import _probe_loop
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    xs = np.arange(64, dtype=np.uint8).reshape(8, 8)
    x = torch.from_numpy(xs)
    for k in (0, 1, 9, 257):
        want = int(np.asarray(_probe_loop(jnp.asarray(xs), jnp.int32(k))))
        assert int(devloop.probe_loop(x, k)[0]) == want
    with pytest.raises(ValueError):
        devloop.probe_loop(torch.zeros(4, 4, dtype=torch.uint8), 1)


@pytest.mark.parametrize("fill", [2, 8, 40])
def test_subscriber_set_gates_until_a_keyframe_and_sheds_the_oldest(fill):
    from docker_nvidia_glx_desktop_tpu_torch.web.session import SubscriberSet

    async def go():
        subs = SubscriberSet()
        q = subs.subscribe([("init", b"i")], maxsize=4, want_key=True)
        assert not subs.publish(("frag", b"p", False, 1), keyframe=False)
        assert q.qsize() == 1                     # P withheld before an IDR
        subs.publish(("frag", b"k", True, 2), keyframe=True)
        need = False
        for i in range(fill):
            need |= subs.publish(("frag", b"p%d" % i, False, 3 + i),
                                 keyframe=False)
        items = []
        while not q.empty():
            items.append(q.get_nowait())
        subs.close()
        return items, need

    items, need = asyncio.run(go())
    assert len(items) <= 4
    if fill <= 2:
        assert items[1][1] == b"k" and not need
    else:
        # the keyframe was shed: the queue re-gates and asks for an IDR
        assert need and all(it[0] != "frag" or it[2] for it in items)


def test_keyframe_requester_prefers_the_rate_limited_path():
    from docker_nvidia_glx_desktop_tpu_torch.web.session import (
        keyframe_requester)

    class Limited:
        def request_idr(self, reason):
            return reason

    class Legacy:
        calls = 0

        def request_keyframe(self):
            Legacy.calls += 1

    assert keyframe_requester(Limited())("pli") == "pli"
    keyframe_requester(Legacy())("pli")
    assert Legacy.calls == 1 and keyframe_requester(object()) is None


def test_content_plane_takes_the_encoders_stats():
    from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
    from docker_nvidia_glx_desktop_tpu_torch.obs.content import PLANE

    enc = H264Encoder(64, 48, mode="cavlc", gop=4, deblock=True,
                      host_color=True, device="cpu")
    src = ScriptSource(64, 48, 3)
    for t in range(3):
        enc.encode_collect(enc.encode_submit(src.render(t)))
        stats = enc.pop_content_stats()
        assert stats is not None
        PLANE.record("port-test", stats)
    snap = PLANE.snapshot()["sessions"]["port-test"]
    assert snap["frames"] == 3 and snap["last"] is not None
    PLANE.drop("port-test")


def test_procstats_without_the_compile_cache_counters():
    from docker_nvidia_glx_desktop_tpu_torch.obs import metrics, procstats

    st = procstats.log_startup()
    assert st["peak_rss_mb"] > 0 and set(st) == {"peak_rss_mb"}
    procstats.register_energy_gauges()
    m = procstats.CpuEnergyMeter()
    assert m.publish(10, tune="off")["frames"] == 10
    assert metrics.REGISTRY.get("jax_compile_cache_hits_total") is None
