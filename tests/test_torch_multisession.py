"""Multi-session serving on the port (``web/multisession``:
``BucketedStreamManager`` over ``BatchStreamManager``) against the
reference's managers on the same seeded frames, tick by tick: each hub's
access units byte-equal per tick and chunked, in one and two geometry
buckets, after a forced re-key and an overflow, and after a state carried
over from the reference's manager mid-GOP.  The port runs in a
subprocess with JAX blocked (``sys.modules['jax'] = None``); its fMP4
fragments decode with cv2.  The reference's JAX package is imported
inside the tests only, so the subprocess can import this module."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent

# name -> (sessions' (w, h), env, ticks, {tick: hub asking for an IDR
# after it}, {(session, tick)} full-noise frames, export-state tick)
CONFIGS = {
    "per_tick": ([(64, 48)] * 2,
                 {"TPU_SESSIONS": "2", "ENCODER_GOP": "4",
                  "ENCODER_SUPERSTEP_CHUNK": "0"},
                 10, {5: 1}, {(0, 7)}, 2),
    "chunk_two_buckets": ([(64, 48), (64, 48), (96, 64)],
                          {"TPU_SESSIONS": "3", "ENCODER_GOP": "30",
                           "ENCODER_SUPERSTEP_CHUNK": "3"},
                          18, {7: 0}, {(1, 12)}, None),
}


class Src:
    """A seeded desktop for one session: a gradient, a window moving 3
    pels a tick, a band of 4-pel glyphs scrolling; ``t`` is set by
    ``run_ticks``, so both managers see the same frame at the same
    tick."""

    def __init__(self, w: int, h: int, seed: int, noisy=()):
        self.width, self.height, self.seed = w, h, seed
        self.noisy = set(noisy)
        self.t = 0
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        self.base = np.stack([(xx * 255 // (w - 1)), (yy * 255 // (h - 1)),
                              ((xx + yy) * 3 + 40 * seed) % 256],
                             -1).astype(np.uint8)
        self.band = (rng.integers(0, 2, (6, w // 4, 3)) * 170
                     + 40).astype(np.uint8).repeat(4, 1)
        self.noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def frame(self):
        t = self.t
        if t in self.noisy:
            return self.noise.copy(), t
        f = self.base.copy()
        x0 = (3 * t + 5 * self.seed) % (self.width // 2)
        f[self.height // 4:self.height // 2, x0:x0 + self.width // 4] = (
            230, 220 - 20 * self.seed, 200)
        f[self.height // 2:self.height // 2 + 6] = np.roll(self.band, 2 * t, 1)
        return f, t


def sources(name: str):
    geoms, _, _, _, noisy, _ = CONFIGS[name]
    return [Src(w, h, i, {t for s, t in noisy if s == i})
            for i, (w, h) in enumerate(geoms)]


def drive(mgr, srcs, ticks, kf, start=0, on_tick=None):
    """Tick the manager's buckets by hand (the body of their encode
    loop): every source's frame at tick t, host colour, the step, the
    hubs' fragments.  Returns per session the delivered (tick, AU,
    keyframe) and the hub's queued items."""
    n = len(srcs)
    hubs = [mgr.session(i) for i in range(n)]
    queues = [h.subscribe(maxsize=4 * ticks + 8) for h in hubs]
    aus = [[] for _ in range(n)]
    now = [start]
    for i, hub in enumerate(hubs):
        orig = hub.muxer.fragment

        def rec(au, keyframe=True, _o=orig, _i=i, **kw):
            aus[_i].append((now[0], bytes(au), bool(keyframe)))
            return _o(au, keyframe=keyframe, **kw)

        hub.muxer.fragment = rec
    return hubs, queues, aus, now


def run_ticks(mgr, srcs, state, ticks, kf, start, on_tick=None):
    hubs, queues, aus, now = state
    mgrs = getattr(mgr, "managers", None) or [mgr]
    for t in range(start, ticks):
        now[0] = t
        for s in srcs:
            s.t = t
        for m in mgrs:
            frames = [s.frame()[0] for s in m.sources]
            pl = [m._planes(f, i) for i, f in enumerate(frames)]
            ys, cbs, crs = (np.stack([p[k] for p in pl]) for k in range(3))
            for flat, idr, jm in m._encode_tick(ys, cbs, crs):
                m._deliver_tick(flat, idr, 1.0, jm)
        if t in kf:
            hubs[kf[t]].request_keyframe()
        if on_tick is not None:
            on_tick(t)
    items = []
    for q in queues:
        got = []
        while not q.empty():
            got.append(q.get_nowait())
        items.append(got)
    journeys = [[(d.get("chunk_len", 1), d.get("slot", 0), d["shards"],
                  d.get("chunk_id") is not None) for d in h.journeys.recent(64)]
                for h in hubs]
    return {"aus": aus, "items": items, "journeys": journeys,
            "buckets": [len(m.sources) for m in mgrs]}


def run_config(ms, from_env, name, device_kw, state_in=None, export=None):
    geoms, env, ticks, kf, _, export_at = CONFIGS[name]
    srcs = sources(name)
    # qp 16: a full-noise frame overflows the packer's caps at these
    # sizes, the desktop frames do not
    cfg = from_env(dict({"SIZEW": "64", "SIZEH": "48", "ENCODER_QP": "16"},
                        **env))
    mgr = ms.BucketedStreamManager(cfg, srcs, **device_kw)
    st = drive(mgr, srcs, ticks, kf)
    start = 0
    if state_in is not None:
        ms.import_batch_state(mgr, state_in)
        start = export_at + 1
    on_tick = None
    if export is not None:
        def on_tick(t):
            if t == export_at:
                # the port's reader takes either manager's attributes
                from docker_nvidia_glx_desktop_tpu_torch.web.multisession \
                    import export_batch_state
                export.extend(export_batch_state(mgr))
    out = run_ticks(mgr, srcs, st, ticks, kf, start, on_tick)
    mgr.close()
    return out


def port_main(spec_path: str, out_path: str) -> None:
    """The subprocess: the port's managers on the CPU with JAX blocked."""
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    res = {name: run_config(ms, from_env, name, {"device": "cpu"})
           for name in CONFIGS}
    res["state"] = run_config(ms, from_env, "per_tick", {"device": "cpu"},
                              state_in=spec["state"])
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
import test_torch_multisession as T
T.port_main({spec!r}, {out!r})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's managers here, the port's in the subprocess
    (started after the reference's run exports its mid-GOP state)."""
    from docker_nvidia_glx_desktop_tpu.utils.config import from_env
    from docker_nvidia_glx_desktop_tpu.web import multisession as ms

    tmp = tmp_path_factory.mktemp("ms")
    state = []
    ref = {"per_tick": run_config(ms, from_env, "per_tick", {},
                                  export=state)}
    spec, out = tmp / "spec.pkl", tmp / "out.pkl"
    with open(spec, "wb") as f:
        pickle.dump({"state": state}, f)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUNNER.format(repo=str(REPO), here=str(HERE),
                                              spec=str(spec), out=str(out))],
        cwd=str(REPO.parent), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref["chunk_two_buckets"] = run_config(ms, from_env, "chunk_two_buckets",
                                          {})
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        port = pickle.load(f)
    return ref, port, tmp


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hubs_access_units_equal_the_reference_tick_by_tick(runs, name):
    ref, port, _ = runs
    assert port[name]["buckets"] == ref[name]["buckets"]
    for got, want in zip(port[name]["aus"], ref[name]["aus"]):
        assert len(got) == len(want) >= CONFIGS[name][2] - 4
        assert got == want


def test_the_port_ran_with_jax_blocked(runs):
    _, port, _ = runs
    assert port["leaked"] == [] and port["jax"] is None


def test_a_keyframe_request_rekeys_only_its_bucket(runs):
    """Hub 0 asks after tick 7: every session of its bucket (0 and 1)
    gets an IDR at tick 8, the other bucket's session does not."""
    _, port, _ = runs
    aus = port["chunk_two_buckets"]["aus"]
    key_ticks = [{t for t, _, k in a if k} for a in aus]
    assert 8 in key_ticks[0] and 8 in key_ticks[1]
    assert key_ticks[2] == {0}
    # per tick: the per-tick run's hub 1 asks after tick 5 -> IDR at 6
    assert all(6 in {t for t, _, k in a if k}
               for a in port["per_tick"]["aus"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_an_overflow_drops_only_that_sessions_frame(runs, name):
    """The full-noise frame overflows its session's flat buffer: that hub
    misses that tick (in a chunk, also the chunk's later frames, which
    predict from the noise), its bucket-mates miss nothing, and the
    bucket re-keys at the next tick it encodes."""
    _, port, _ = runs
    (s, t_noisy), = CONFIGS[name][4]
    aus = port[name]["aus"]
    ticks = [[t for t, _, _ in a] for a in aus]
    mate = 1 - s
    missed = sorted(set(ticks[mate]) - set(ticks[s]))
    assert missed[0] == t_noisy and set(ticks[s]) < set(ticks[mate])
    assert missed == list(range(t_noisy, missed[-1] + 1))
    rekey = [min(t for t, _, k in a if k and t > t_noisy)
             for a in (aus[s], aus[mate])]
    assert rekey[0] == rekey[1] > missed[-1]
    if name == "per_tick":
        assert missed == [t_noisy] and rekey[0] == t_noisy + 1


def test_fmp4_fragments_decode_with_cv2(runs):
    cv2 = pytest.importorskip("cv2")
    _, port, tmp = runs
    for name in CONFIGS:
        for i, items in enumerate(port[name]["items"]):
            init = [it[1] for it in items if it[0] == "init"]
            frags = [it[1] for it in items if it[0] == "frag"]
            assert len(init) == 1 and len(frags) == len(port[name]["aus"][i])
            path = tmp / f"{name}_{i}.mp4"
            path.write_bytes(init[0] + b"".join(frags))
            cap = cv2.VideoCapture(str(path))
            n = 0
            while True:
                ok, img = cap.read()
                if not ok:
                    break
                assert img.shape[:2] == (CONFIGS[name][0][i][1],
                                         CONFIGS[name][0][i][0])
                n += 1
            cap.release()
            # the overflow's re-key starts a new decodable GOP
            assert n == len(frags), (name, i, n, len(frags))


def test_journey_chunk_identity_equals_the_reference(runs):
    """Each hub's journeys carry the reference's chunk identity (chunk
    length, slot, shards; a flushed partial chunk is unchunked)."""
    ref, port, _ = runs
    for name in CONFIGS:
        assert port[name]["journeys"] == ref[name]["journeys"]
    lens = {j[0] for js in port["chunk_two_buckets"]["journeys"] for j in js}
    assert lens == {1, 3}


def test_state_from_the_reference_manager_continues_with_its_bytes(runs):
    """The reference's GOP counters and references after tick 2, set on a
    fresh port manager: from tick 3 on, the port's AUs are the
    reference's."""
    ref, port, _ = runs
    start = CONFIGS["per_tick"][5] + 1
    for got, want in zip(port["state"]["aus"], ref["per_tick"]["aus"]):
        assert got and all(t >= start for t, _, _ in got)
        assert not got[0][2]                        # a P frame, mid-GOP
        assert got == [a for a in want if a[0] >= start]


# -- the port alone ---------------------------------------------------------

def _cfg(**env):
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    return from_env(dict({"SIZEW": "64", "SIZEH": "48"}, **env))


def test_spatial_shards_over_several_devices_raise_naming_item_11():
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="2",
                                     ENCODER_SPATIAL_SHARDS="2"),
                                [Src(64, 48, 0), Src(64, 48, 1)],
                                device="cpu")
    assert mgr.mesh_shape == (1, 1)       # one device: the shape stands
    cfg = _cfg(ENCODER_SPATIAL_SHARDS="2")
    with pytest.raises(NotImplementedError, match="item 11"):
        mgr._plan_spatial_extent(cfg, mgr._probe, (1, 1), 4)
    with pytest.raises(NotImplementedError, match="item 11"):
        mgr._check_plan((2, 1))
    mgr.close()


def test_one_device_keeps_its_plan_when_marked_dead_and_answers_probes():
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="2"),
                                [Src(64, 48, 0), Src(64, 48, 1)],
                                device="cpu")
    step = mgr.step
    mgr.mark_chip_dead()
    assert mgr.step is step and mgr._dead_devices == []
    assert mgr.surviving_chips() == 1 and mgr._probe_dead_chip() == -1
    assert mgr.stats_summary()["mesh"] == [1, 1]
    mgr.close()


def test_other_codecs_serve_cavlc_with_a_warning(caplog):
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="1",
                                     WEBRTC_ENCODER="tpumjpegenc"),
                                [Src(64, 48, 0)], device="cpu")
    assert mgr.hubs[0].codec_name == "h264_cavlc"
    assert "not batchable" in caplog.text
    mgr.close()


def test_the_managers_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.BucketedStreamManager(_cfg(TPU_SESSIONS="1"), [Src(64, 48, 0)])


def test_state_import_refuses_a_staged_chunk_or_another_geometry():
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="2", ENCODER_GOP="8",
                                     ENCODER_SUPERSTEP_CHUNK="3"),
                                [Src(64, 48, 0), Src(64, 48, 1)],
                                device="cpu")
    srcs = mgr.sources
    st = drive(mgr, srcs, 3, {})
    run_ticks(mgr, srcs, st, 3, {}, 0)        # IDR, then two staged
    with pytest.raises(ValueError, match="staged"):
        ms.export_batch_state(mgr)
    bad = [{"gop_pos": 1, "frame_num": 1, "idr_count": 1,
            "refs": tuple(np.zeros((2, 64, 64), np.uint8) for _ in range(3))}]
    with pytest.raises(ValueError, match="do not fit"):
        ms.import_batch_state(mgr, bad)
    with pytest.raises(ValueError, match="bucket states"):
        ms.import_batch_state(mgr, bad * 2)
    mgr.close()


def test_a_held_chunk_fails_loudly_in_the_manager():
    """The manager pulls and releases every chunk before the next: a
    chunk step still holding its outputs refuses the next replay."""
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="1", ENCODER_GOP="8",
                                     ENCODER_SUPERSTEP_CHUNK="2"),
                                [Src(64, 48, 0)], device="cpu")
    srcs = mgr.sources
    st = drive(mgr, srcs, 3, {})
    run_ticks(mgr, srcs, st, 3, {}, 0)        # IDR and one chunk of 2
    assert not mgr.chunk_step.held
    mgr.chunk_step.held = True                # a chunk nobody pulled
    ys = np.zeros((1, 2, 48, 64), np.uint8)
    cs = np.zeros((1, 2, 24, 32), np.uint8)
    hv, hl = mgr._chunk_hdrs((3, 4))
    with pytest.raises(RuntimeError, match="still held"):
        mgr.chunk_step(ys, cs, cs, *mgr._refs, hv, hl)
    mgr.close()


def test_a_failed_pull_releases_the_chunk_and_the_bucket_recovers(monkeypatch):
    """A chunk whose flats fail to reach the host is dropped, but the
    step is released: after the encode loop's recovery (the stage
    cleared, an IDR forced) the next chunk replays and delivers."""
    from docker_nvidia_glx_desktop_tpu_torch.web import multisession as ms

    mgr = ms.BatchStreamManager(_cfg(TPU_SESSIONS="1", ENCODER_GOP="8",
                                     ENCODER_SUPERSTEP_CHUNK="2"),
                                [Src(64, 48, 0)], device="cpu")
    src = mgr.sources[0]

    def tick(t):
        src.t = t
        y, cb, cr = mgr._planes(src.frame()[0], 0)
        return mgr._encode_tick(y[None], cb[None], cr[None])

    assert tick(0)[0][1] and tick(1) == []     # the IDR; one P staged
    real = ms._host

    def fail(t):
        if t.dim() == 4:                       # the chunk's (S, K, 1, L)
            raise RuntimeError("injected pull failure")
        return real(t)

    monkeypatch.setattr(ms, "_host", fail)
    with pytest.raises(RuntimeError, match="injected"):
        tick(2)
    assert not mgr.chunk_step.held
    monkeypatch.setattr(ms, "_host", real)
    mgr._stage.clear()                        # the loop's error path
    mgr._force_idr = True
    out = tick(3)
    assert len(out) == 1 and out[0][1]         # the recovery IDR
    assert tick(4) == [] and [idr for _, idr, _ in tick(5)] == [False, False]
    assert not mgr.chunk_step.held
    mgr.close()
