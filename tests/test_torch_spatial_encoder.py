"""The port's H.264 encoder with ``spatial_shards`` (shard devices
``[cpu] * nx``) against the reference's spatial encoder on the CPU's
forced devices, GOP-deep through the submit/collect pipeline: CAVLC with
the loop filter on and off at nx = 2 and 4, CABAC with device
binarization, all-intra, and the damage-masked row gate; each stream
also equal to the port's own unsharded one, one decoded by cv2.  A JAX
spatial encoder's state taken mid-GOP continues byte-exact in a port
spatial encoder.  On one device the knob serves unsharded, as the
reference's resolution gives there; what is not ported raises naming its
item.  The ring and the tune tiers are ``test_torch_spatial_ring.py``'s."""

import logging

import numpy as np
import pytest
import torch

import conftest
from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

W, H = 64, 64          # 4 MB rows: nx = 2 leaves 2 rows a shard
W4, H4 = 64, 128       # 8 MB rows: nx = 4 leaves 2 rows a shard
CPU = torch.device("cpu")
_KW = dict(mode="cavlc", entropy="device", host_color=True)


def frames(n, w=W, h=H, seed=3, step=2):
    """The reference's spatial test frames: a noise desktop with a
    two-level band, shifted ``step`` pels right and down a frame."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    base[h // 2: h // 2 + h // 8] = (
        r.integers(0, 2, size=(h // 8, w, 3)) * 220).astype(np.uint8)
    return [np.ascontiguousarray(np.roll(np.roll(base, step * i, axis=1),
                                         (step * i) % 5, axis=0))
            for i in range(n)]


def dirty_rows(n, w=W, h=H, seed=11):
    """Each frame the one before with one MB row of fresh noise: the
    damage mask keeps that row and gates the rest."""
    r = np.random.default_rng(seed)
    f = conftest.make_test_frame(h, w, seed=seed)
    out = [f.copy()]
    for i in range(1, n):
        f = f.copy()
        mr = i % (h // 16)
        f[mr * 16:(mr + 1) * 16] = r.integers(0, 256, (16, w, 3), np.uint8)
        out.append(f)
    return out


def drive(enc, fs):
    """The serving loop at the encoder's preferred depth: the AUs."""
    depth = getattr(enc, "pipeline_depth", 2)
    out, pend = [], []
    for f in fs:
        pend.append(enc.encode_submit(f))
        while len(pend) >= depth:
            out.append(enc.encode_collect(pend.pop(0)).data)
    while pend:
        out.append(enc.encode_collect(pend.pop(0)).data)
    return out


def trio(nx, w, h, fs, **kw):
    """AUs of the reference's spatial encoder, the port's on [cpu] * nx
    and the port's unsharded one."""
    j = JEnc(w, h, spatial_shards=nx, **kw)
    t = TEnc(w, h, spatial_shards=nx, device="cpu",
             spatial_devices=[CPU] * nx, **kw)
    u = TEnc(w, h, device="cpu", **kw)
    if kw.get("entropy") == "cabac":
        j._cabac_dev_bin = True
    assert j._spatial_nx == t._spatial_nx == nx and u._spatial_nx == 1
    return drive(j, fs), drive(t, fs), drive(u, fs)


def decode_count(aus, tmp_path) -> int:
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "sp.h264"
    path.write_bytes(b"".join(aus))
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.fixture
def cabac_device(monkeypatch):
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")


@pytest.mark.parametrize("nx,w,h,deblock", [(2, W, H, True),
                                            (2, W, H, False),
                                            (4, W4, H4, True)])
def test_cavlc_gop_deep(nx, w, h, deblock, tmp_path):
    fs = frames(6, w=w, h=h, seed=5 + nx)
    j, t, u = trio(nx, w, h, fs, gop=6, deblock=deblock, **_KW)
    assert t == j
    assert t == u
    if nx == 4:
        assert decode_count(t, tmp_path) == len(fs)


def test_cabac_device_binarize_gop_deep(cabac_device):
    fs = frames(5, seed=13)
    kw = dict(_KW, entropy="cabac")
    j, t, u = trio(2, W, H, fs, gop=5, deblock=True, **kw)
    assert t == j
    assert t == u


def test_all_intra():
    fs = frames(3, seed=17)
    j, t, u = trio(2, W, H, fs, **_KW)
    assert t == j == u


def test_masked_row_gate(monkeypatch):
    monkeypatch.setenv("DNGD_DAMAGE_MASK", "true")
    fs = dirty_rows(6)
    j, t, u = trio(2, W, H, fs, gop=6, deblock=True, damage_mask=True, **_KW)
    assert t == j
    # the unsharded masked path compacts rows; its bytes are the gate's
    assert t == u


def test_jax_spatial_state_continues_in_the_port():
    """A JAX spatial encoder's mid-GOP state imported into a port spatial
    encoder: the recovery IDR and the P frames after it equal a JAX
    spatial encoder's that imported the same snapshot."""
    fs = frames(7, seed=23)
    kw = dict(_KW, gop=12, deblock=True)
    src = JEnc(W, H, spatial_shards=2, **kw)
    for f in fs[:3]:
        src.encode(f)
    st = src.export_state()
    assert st["ref"] is not None
    j = JEnc(W, H, spatial_shards=2, **kw)
    t = TEnc(W, H, spatial_shards=2, device="cpu",
             spatial_devices=[CPU] * 2, **kw)
    j.import_state(st)
    t.import_state(st)
    a, b = drive(j, fs[3:]), drive(t, fs[3:])
    assert b == a
    assert t.pop_journey_meta()["shards"] == 2


# -- the knob on one device ------------------------------------------------

@pytest.mark.parametrize("value", ["auto", "sixteen"])
def test_knob_serves_unsharded_on_one_device(value, caplog):
    """``make_encoder`` with ENCODER_SPATIAL_SHARDS=auto or a value that
    does not parse serves on one device, its AUs equal to the reference
    encoder's with the same knob; the bad value warns."""
    env = {"SIZEW": "64", "SIZEH": "48", "ENCODER_GOP": "4",
           "ENCODER_SPATIAL_SHARDS": value}
    fs = frames(4, w=64, h=48, seed=29)
    with caplog.at_level(logging.WARNING):
        t, _ = t_make(t_env(env), 64, 48, device="cpu")
    assert t._spatial_nx == 1 and t.spatial_devices == [CPU]
    if value != "auto":
        assert any("not understood" in r.message for r in caplog.records)
    j, _ = j_make(j_env(env), 64, 48)
    assert drive(t, fs) == drive(j, fs)


def test_refusals_name_their_items(monkeypatch):
    monkeypatch.delenv("ENCODER_CABAC_BINARIZE", raising=False)
    two = [CPU, CPU]
    with pytest.raises(NotImplementedError, match="item 14"):
        TEnc(W, H, gop=4, spatial_shards="auto", device="cpu",
             spatial_devices=two, **_KW)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(NotImplementedError, match="item 11m"):
        TEnc(W, H, gop=4, spatial_shards=2, device="cpu",
             spatial_devices=cards, **_KW)
    # ineligible settings ignore the knob, as the reference's
    assert TEnc(W, H, gop=4, spatial_shards=2, device="cpu",
                spatial_devices=two, keep_recon=True,
                **_KW)._spatial_nx == 1
    assert TEnc(W, H, gop=4, spatial_shards=2, device="cpu",
                spatial_devices=two,
                **dict(_KW, entropy="cabac"))._spatial_nx == 1
