"""The PyTorch/CUDA port stands alone: it imports with JAX blocked, never
touches the JAX package, and its entry points refuse to run on the CPU
unless asked to."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "docker_nvidia_glx_desktop_tpu_torch"

_BLOCKED_IMPORT = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48",
                                     "ENCODER_GOP": "1"}}), 64, 48,
                          device="cpu")
ef = enc.encode(np.full((48, 64, 3), 90, np.uint8))
assert ef.data.startswith(b"\\x00\\x00\\x00\\x01") and ef.keyframe
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_GOP = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
# the default configuration: GOP 60, deblock on, rate control on
enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48"}}), 64, 48,
                          device="cpu")
assert enc.gop == 60 and enc.deblock and enc._rate is not None
frame = np.full((48, 64, 3), 90, np.uint8)
keys = []
for i in range(3):
    frame[8:24, 4 * i:4 * i + 16] = 200
    keys.append(enc.encode_collect(enc.encode_submit(frame)).keyframe)
assert keys == [True, False, False], keys
# ENCODER_TUNE=hq: the kernel tier hq_noaq under the loop filter, and the
# full tier (qp plane, qp chain, I16-in-P) with it off
from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48",
                                     "ENCODER_TUNE": "hq"}}), 64, 48,
                          device="cpu")
full = H264Encoder(64, 48, mode="cavlc", deblock=False, tune="hq", gop=60,
                   bitrate_kbps=300, device="cpu")
assert (enc._ktune, full._ktune, full._p_intra) == ("hq_noaq", "hq", True)
for e in (enc, full):
    for i in range(3):
        frame[24:40, 4 * i:4 * i + 16] = 30 + 40 * i
        assert e.encode_collect(e.encode_submit(frame)).data
# the other intra mode sets and the host CAVLC coders (the C coder for
# ENCODER_ENTROPY=native's IDRs at the slice qp)
from docker_nvidia_glx_desktop_tpu_torch.native import lib
for knobs in ({{"ENCODER_INTRA_MODES": "full"}},
              {{"ENCODER_ENTROPY": "native", "ENCODER_BITRATE_KBPS": "0"}}):
    e, codec = make_encoder(from_env(dict({{"SIZEW": "64", "SIZEH": "48"}},
                                          **knobs)), 64, 48, device="cpu")
    assert codec == "h264_cavlc"
    keys = []
    for i in range(3):
        frame[8:40, 4 * i:4 * i + 16] = 60 + 50 * i
        keys.append(e.encode_collect(e.encode_submit(frame)).keyframe)
    assert keys == [True, False, False], keys
assert e.i16_modes == "dc" and lib.calls["h264_encode_intra_picture"] == 1
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_CABAC = """
import os, sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_cabac
from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder, make_encoder
from docker_nvidia_glx_desktop_tpu_torch.native import lib
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
frame = np.full((48, 64, 3), 90, np.uint8)
for route in ("host", "device"):
    os.environ["ENCODER_CABAC_BINARIZE"] = route
    enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48",
                                         "ENCODER_ENTROPY": "cabac"}}),
                              64, 48, device="cpu")
    assert codec == "h264_cabac"
    for i in range(3):
        frame[8:24, 4 * i:4 * i + 16] = 200
        enc.encode_collect(enc.encode_submit(frame))
# the reference's default colour path: the device conversion (K9)
enc = H264Encoder(64, 48, mode="cavlc", gop=4, deblock=True, device="cpu")
assert not enc.host_color
for i in range(2):
    enc.encode(frame)
assert h264_cabac.python_pictures == 0 and lib.calls["h264_cabac_p_slices"]
assert lib.calls["h264_cabac_engine_rows"] and lib.calls["level_unpack_rows"]
print("SO", lib._so_path())
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_RING_DAMAGE = """
import os, sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.ops import devloop
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
# the deployed manifest's chunk ring, then damage-driven encode in it
for mask in ("false", "true"):
    os.environ["DNGD_DAMAGE_MASK"] = mask
    frame = np.full((48, 64, 3), 90, np.uint8)
    enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48",
                                         "ENCODER_SUPERSTEP_CHUNK": "4"}}),
                              64, 48, device="cpu")
    assert enc._ring_chunk == 4 and enc.damage_mask == (mask == "true")
    toks = []
    for i in range(6):
        frame[8:24, 4 * i:4 * i + 16] = 200
        toks.append(enc.encode_submit(frame))
    kinds = [t[0] for t in toks]
    assert kinds == ["intra"] + ["ring"] * 5, kinds
    assert all(enc.encode_collect(t).data for t in toks)
    assert list(enc._chunk_steps) == [("cavlc", "yuv", 2 if mask == "true"
                                       else 0)], enc._chunk_steps
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_MJPEG_RFB = """
import asyncio, struct, sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
from docker_nvidia_glx_desktop_tpu_torch.rfb import server_main
from docker_nvidia_glx_desktop_tpu_torch.rfb.server import RfbServer
from docker_nvidia_glx_desktop_tpu_torch.rfb.source import NumpySource
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
enc, codec = make_encoder(from_env({{"SIZEW": "64", "SIZEH": "48",
                                     "WEBRTC_ENCODER": "tpumjpegenc"}}),
                          64, 48, device="cpu")
frame = np.full((48, 64, 3), 90, np.uint8)
frame[8:24, 4:20] = 200
ef = enc.encode(frame)
assert codec == "mjpeg" and ef.data[:2] == b"\\xff\\xd8" and ef.keyframe
step = batch.batch_encode_step(64, 64, spatial=2, device="cpu")
y, cb, cr = step.transform(np.zeros((2, 64, 64, 3), np.uint8))
assert tuple(y.shape) == (2, 16, 4, 64)
src = NumpySource(64, 48)
src.push(frame)
server = RfbServer(source=src, device="cpu")

async def go():
    await server.start(port=0)
    r, w = await asyncio.open_connection("127.0.0.1", server.port)
    await r.readexactly(12)
    w.write(b"RFB 003.008\\n")
    await r.readexactly(2)
    w.write(b"\\x01")
    await r.readexactly(4)
    w.write(b"\\x01")
    await r.readexactly(20)
    await r.readexactly(struct.unpack(">I", await r.readexactly(4))[0])
    w.write(struct.pack(">BxHii", 2, 2, 7, 0))
    w.write(struct.pack(">BBHHHH", 3, 0, 0, 0, 64, 48))
    head = await r.readexactly(16)
    w.close()
    await server.close()
    return struct.unpack(">i", head[12:16])[0]

assert asyncio.run(go()) == 7
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_SESSIONS = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from docker_nvidia_glx_desktop_tpu_torch.obs import (budget, content, events,
                                                     flight, journey, metrics,
                                                     procstats, trace)
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
from docker_nvidia_glx_desktop_tpu_torch.resilience import (continuity, faults,
                                                            handoff, policy)
from docker_nvidia_glx_desktop_tpu_torch.utils import timing
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env
from docker_nvidia_glx_desktop_tpu_torch.web import (clock, mp4, multisession,
                                                     session)


class Src:
    def __init__(self, w, h):
        self.width, self.height = w, h

    def frame(self):
        return np.full((self.height, self.width, 3), 90, np.uint8), 0


cfg = from_env({{"SIZEW": "64", "SIZEH": "48", "TPU_SESSIONS": "3"}})
mgr = multisession.BucketedStreamManager(
    cfg, [Src(64, 48), Src(64, 48), Src(96, 64)], device="cpu")
assert [len(m.sources) for m in mgr.managers] == [2, 1]
for m in mgr.managers:
    pl = [m._planes(s.frame()[0], i) for i, s in enumerate(m.sources)]
    ys, cbs, crs = (np.stack([p[k] for p in pl]) for k in range(3))
    (flat, idr, _), = m._encode_tick(ys, cbs, crs)
    assert idr and flat.shape[:2] == (len(m.sources), 1)
    assert m._deliver_tick(flat, idr, 1.0)
mgr.close()
sess = session.StreamSession(from_env({{"SIZEW": "64", "SIZEH": "48"}}),
                             Src(64, 48), device="cpu")
assert sess.codec_name == "h264_cavlc"
sess.close()
assert budget.LEDGER.probe_link(device="cpu")["rtt_ms"] >= 0
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_SPATIAL = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
# two shards on the CPU, per frame and in the chunk ring, CAVLC and the
# masked row gate
for chunk, mask in ((0, False), (4, False), (0, True)):
    enc = H264Encoder(64, 64, mode="cavlc", gop=9, deblock=True,
                      host_color=True,
                      superstep_chunk=chunk, spatial_shards=2,
                      damage_mask=mask, device="cpu",
                      spatial_devices=[torch.device("cpu")] * 2)
    assert enc._spatial_nx == 2
    frame = np.full((64, 64, 3), 90, np.uint8)
    toks = []
    for i in range(5):
        frame[8:24, 4 * i:4 * i + 16] = 200
        toks.append(enc.encode_submit(frame))
    assert all(enc.encode_collect(t).data for t in toks)
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


_BLOCKED_BENCH = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from docker_nvidia_glx_desktop_tpu_torch import bench
from docker_nvidia_glx_desktop_tpu_torch.models import H264Encoder
from docker_nvidia_glx_desktop_tpu_torch.ops import aq, devloop
enc = H264Encoder(64, 48, mode="cavlc", device="cpu")
r = np.random.default_rng(0)
cur = [torch.from_numpy(r.integers(0, 256, s, np.uint8))
       for s in ((48, 64), (24, 32), (24, 32))]
ref = [p.flip(0).contiguous() for p in cur]
sums = [devloop.intra_loop(*cur, *enc._hdr_slots(0, 0), 1, 26),
        devloop.p_loop(*cur, *ref, *enc._p_hdr_slots(1, 0), 1, 26),
        devloop.cabac_intra_loop(*cur, 1, 26, binarize=True),
        devloop.inter_loop(*cur, *ref, 1, 26),
        devloop.deblock_loop(*cur, 1, 26),
        devloop.cabac_p_loop(*cur, *ref, 1, 26)]
assert all(isinstance(s, np.uint32) for s in sums), sums
assert aq.psnr_planes(cur[0], ref[0]) > 0
assert bench._bdrate_frames("scrolling", 64, 48, 2)[0].shape == (48, 64, 3)
bad = sorted(m for m in sys.modules
             if m == "docker_nvidia_glx_desktop_tpu"
             or m.startswith("docker_nvidia_glx_desktop_tpu."))
print("LEAKED", bad)
"""


def _run(code: str, cwd=None, timeout=120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_encodes_with_jax_blocked_and_no_reference_module():
    out = _run(_BLOCKED_IMPORT.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_encodes_a_gop_with_jax_blocked():
    out = _run(_BLOCKED_GOP.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_encodes_the_chunk_ring_and_the_damage_mask_with_jax_blocked():
    out = _run(_BLOCKED_RING_DAMAGE.format(repo=str(REPO)),
               cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_encodes_spatial_shards_with_jax_blocked():
    out = _run(_BLOCKED_SPATIAL.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_encodes_mjpeg_and_serves_rfb_with_jax_blocked():
    out = _run(_BLOCKED_MJPEG_RFB.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_serves_sessions_with_jax_blocked():
    """Every module of the serving slice imports with JAX blocked, and a
    two-bucket multi-session tick and a StreamSession run on the CPU."""
    out = _run(_BLOCKED_SESSIONS.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_bench_loops_and_distortion_run_with_jax_blocked():
    """The bench module imports, one step of each device-only loop and the
    PSNR run on the CPU with JAX blocked."""
    out = _run(_BLOCKED_BENCH.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout


def test_port_encodes_cabac_and_device_colour_with_jax_blocked():
    out = _run(_BLOCKED_CABAC.format(repo=str(REPO)), cwd=str(REPO.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout
    so = pathlib.Path(out.stdout.split("SO ")[1].split()[0])
    assert so.parent == PORT / "build" and so.exists()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (PORT / "native").iterdir()
    if p.suffix in (".cpp", ".py")))
def test_native_sources_are_the_ports_own(path):
    """The port's native library builds from its own sources into its
    own build/, never the reference's (or its cache directory)."""
    src = (REPO / path).read_text()
    assert ".cache" not in src and "TPUDESKTOP_CACHE" not in src, path
    for inc in re.findall(r'^#include\s+"([^"]+)"', src, re.M):
        assert (REPO / path).parent.joinpath(inc).exists(), (path, inc)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_no_port_source_imports_jax_or_the_reference(path):
    src = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    assert not re.search(
        r"^\s*(import|from)\s+docker_nvidia_glx_desktop_tpu(?!_torch)\b",
        src, re.M), path
    assert "import_module" not in src and "__import__" not in src, path


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import (H264Encoder,
                                                           make_encoder)
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = from_env({"SIZEW": "64", "SIZEH": "48", "ENCODER_GOP": "1"})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_encoder(cfg, 64, 48)
    with pytest.raises(RuntimeError, match="CUDA"):
        H264Encoder(64, 48, device=None)
    enc, _ = make_encoder(cfg, 64, 48, device="cpu")
    assert enc.device.type == "cpu"


@pytest.mark.parametrize("env,item", [
    # tune=hq under the damage mask serves now (item 10m), its AUs equal
    # the reference encoder's (the id is the one the case had when it
    # pinned a refusal; the masked frames themselves are held in
    # tests/test_torch_damage_tune*.py)
    pytest.param({"ENCODER_GOP": "60", "ENCODER_TUNE": "hq",
                  "ENCODER_BITRATE_KBPS": "0",
                  "DNGD_DAMAGE_MASK": "true"}, None, id="env0-item 10"),
    # the item 17 settings serve now, their AUs equal the reference
    # encoder's (the ids are the ones the cases had when they pinned a
    # refusal)
    pytest.param({"ENCODER_GOP": "1", "ENCODER_ENTROPY": "native"}, None,
                 id="env1-item 17"),
    # ENCODER_SPATIAL_SHARDS on one device: the reference resolves the
    # knob to one shard there, so these serve (item None), their AUs equal
    # the reference encoder's with the same knob (the ids are the ones the
    # cases had when they pinned a refusal)
    pytest.param({"ENCODER_GOP": "60", "ENCODER_TUNE": "hq",
                  "ENCODER_BITRATE_KBPS": "0",
                  "ENCODER_SPATIAL_SHARDS": "2"}, None, id="env2-item 11"),
    pytest.param({"ENCODER_GOP": "60", "ENCODER_SUPERSTEP_CHUNK": "4",
                  "ENCODER_BITRATE_KBPS": "0",
                  "ENCODER_SPATIAL_SHARDS": "2"}, None, id="env3-item 11"),
    pytest.param({"ENCODER_GOP": "1", "ENCODER_BITRATE_KBPS": "0",
                  "ENCODER_SPATIAL_SHARDS": "2"}, None, id="env4-item 11"),
    pytest.param({"ENCODER_GOP": "1", "ENCODER_INTRA_MODES": "full"}, None,
                 id="env5-item 17"),
    ({"WEBRTC_ENCODER": "tpuvp8enc"}, "item 13"),
    # what stays unported over several shard devices
    ({"ENCODER_GOP": "60", "ENCODER_SPATIAL_SHARDS": "auto",
      "_devices": "cpu,cpu"}, "item 14"),
    ({"ENCODER_GOP": "60", "ENCODER_SPATIAL_SHARDS": "2", "SIZEH": "64",
      "_devices": "cuda:0,cuda:1"}, "item 11m"),
])
def test_unported_settings_raise_naming_the_roadmap_item(env, item,
                                                         monkeypatch):
    import numpy as np
    import torch

    from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder
    from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env

    env = dict(env)
    devices = env.pop("_devices", None)
    if devices is not None:
        devices = [torch.device(d) for d in devices.split(",")]
    for k, v in env.items():            # the process-wide knobs
        if k.startswith("DNGD_"):
            monkeypatch.setenv(k, v)
    env = dict({"SIZEW": "64", "SIZEH": "48"}, **env)
    w, h = int(env["SIZEW"]), int(env["SIZEH"])
    cfg = from_env(env)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            make_encoder(cfg, w, h, device="cpu", spatial_devices=devices)
        return
    from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
    from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env

    enc, _ = make_encoder(cfg, w, h, device="cpu")
    assert enc._spatial_nx == 1 and len(enc.spatial_devices) == 1
    ref, _ = j_make(j_env(env), w, h)
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (h, w, 3), np.uint8)
    for i in range(5):
        frame = np.ascontiguousarray(np.roll(base, 2 * i, axis=1))
        assert enc.encode(frame).data == ref.encode(frame).data, i


def test_chip_smoke_fails_without_cuda_and_outside_the_repo(tmp_path):
    out = _run(f"import runpy, sys; sys.argv = ['chip_smoke.py']; "
               f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, "
               f"run_name='__main__')", cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    out = _run("import runpy, sys; sys.argv = ['chip_smoke.py']; "
               "runpy.run_path('chip_smoke.py', run_name='__main__')",
               cwd=str(alone))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
