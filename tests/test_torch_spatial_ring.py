"""The port's spatially sharded encoder (shard devices ``[cpu] * nx``) in
the super-step ring and under the tune tiers, against the reference's
spatial encoder on the CPU's forced devices: the chunk ring (row 15h's
graph body, eager on the CPU) on CAVLC and on CABAC with device
binarization, the served tier (``make_encoder`` with ``ENCODER_TUNE=hq``:
hq_noaq under the loop filter) and the full tier with I16-in-P, per
frame and in the ring with the 1-frame lookahead.  Each stream also
equals the port's unsharded one where the reference's two agree."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

from test_torch_spatial_encoder import CPU, H, W, _KW, drive, frames


def test_cavlc_chunk_ring():
    """GOP 9 in chunks of 4: the IDR and two chunk dispatches, byte-equal
    to the reference's spatial ring and to the port's unsharded
    per-frame path."""
    fs = frames(9, seed=13, step=3)
    kw = dict(_KW, gop=9, deblock=True)
    j = JEnc(W, H, spatial_shards=2, superstep_chunk=4, **kw)
    t = TEnc(W, H, spatial_shards=2, superstep_chunk=4, device="cpu",
             spatial_devices=[CPU] * 2, **kw)
    u = TEnc(W, H, device="cpu", **kw)
    assert t._ring_chunk == 4 and t._spatial_nx == 2
    a, b, c = drive(j, fs), drive(t, fs), drive(u, fs)
    assert b == a
    assert b == c
    assert t._disp_count == 1 + 2


def test_cabac_chunk_ring(monkeypatch):
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")
    fs = frames(7, seed=19, step=3)
    kw = dict(_KW, entropy="cabac", gop=7, deblock=True)
    j = JEnc(W, H, spatial_shards=2, superstep_chunk=3, **kw)
    j._cabac_dev_bin = True
    t = TEnc(W, H, spatial_shards=2, superstep_chunk=3, device="cpu",
             spatial_devices=[CPU] * 2, **kw)
    assert t._ring_chunk == 3 and t._spatial_nx == 2
    assert drive(t, fs) == drive(j, fs)


def test_served_tier_through_make_encoder():
    """``ENCODER_TUNE=hq`` with ``ENCODER_SPATIAL_SHARDS=2``: hq_noaq
    under the loop filter, per frame."""
    env = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_GOP": "6",
           "ENCODER_BITRATE_KBPS": "0", "ENCODER_TUNE": "hq",
           "ENCODER_SPATIAL_SHARDS": "2"}
    fs = frames(5, seed=31)
    t, _ = t_make(t_env(env), W, H, device="cpu", spatial_devices=[CPU] * 2)
    j, _ = j_make(j_env(env), W, H)
    assert t._ktune == "hq_noaq" and t._spatial_nx == j._spatial_nx == 2
    assert drive(t, fs) == drive(j, fs)


@pytest.mark.parametrize("chunk", [0, 3])
def test_full_tier_with_i16_in_p(chunk):
    """The full tier (deblock off): the qp plane, the mb_qp_delta chain
    with each shard's qp sum, I16-in-P; in the ring the lookahead."""
    fs = frames(7, seed=37)
    kw = dict(_KW, gop=7, deblock=False, tune="hq", superstep_chunk=chunk)
    j = JEnc(W, H, spatial_shards=2, **kw)
    t = TEnc(W, H, spatial_shards=2, device="cpu",
             spatial_devices=[CPU] * 2, **kw)
    assert t._p_intra and t._spatial_nx == 2
    assert t._ring_chunk == (3 if chunk else 0)
    assert drive(t, fs) == drive(j, fs)
