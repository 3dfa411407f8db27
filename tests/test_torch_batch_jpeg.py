"""The MJPEG session batch (the reference's ``parallel/batch.py``
``batch_encode_step``) on the port: its entropy half, fed the reference's
levels, against the reference's step on (session, spatial) meshes of the
CPU devices, exactly; and the port's whole step, each session assembled
with restart markers, decoding within 0.05 dB of the reference's."""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from docker_nvidia_glx_desktop_tpu.bitstream import jpeg_huffman as j_jh
from docker_nvidia_glx_desktop_tpu.models.mjpeg import _transform_stage
from docker_nvidia_glx_desktop_tpu.parallel import batch as j_batch
from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as t_jd
from docker_nvidia_glx_desktop_tpu_torch.ops import quant
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch as t_batch

import conftest

PSNR_TOL_DB = 0.05


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def session_frames(s, h, w):
    return np.stack([conftest.make_test_frame(h, w, seed=i) for i in range(s)])


def tables_of(frame, h, w):
    """+1-smoothed tables from one frame's histograms (the reference
    test's recipe), as HuffmanTables and the 8 dense arrays."""
    lq, cq = quant.jpeg_quality_tables(85)
    y, cb, cr = [np.asarray(a) for a in _transform_stage(
        jnp.asarray(frame), jnp.asarray(lq, jnp.float32),
        jnp.asarray(cq, jnp.float32), h, w)]
    _, dc, ac = j_jh.frame_symbols([y.reshape(-1, 64), cb, cr], [0, 1, 1])
    for hist in (dc, ac):
        hist[0] += 1
        hist[1] += 1
    tables = (j_jh.HuffmanTable(dc[0][:12]), j_jh.HuffmanTable(ac[0]),
              j_jh.HuffmanTable(dc[1][:12]), j_jh.HuffmanTable(ac[1]))
    return tables, t_jd.dense_tables(tables)


@functools.lru_cache(maxsize=None)
def _strip_transform(h, w):
    lq, cq = quant.jpeg_quality_tables(85)
    return jax.jit(lambda f: j_batch._session_transform(
        f, jnp.asarray(lq, jnp.float32), jnp.asarray(cq, jnp.float32), h, w))


def reference_levels(frames, nx):
    """The reference's levels as its step computes them: each strip of
    MCU rows transformed alone (vmapped over sessions), joined in MCU
    order into the port's layout."""
    s, h, w = frames.shape[:3]
    hs = h // nx
    parts = [[np.asarray(a) for a in _strip_transform(hs, w)(
        jnp.asarray(frames[:, k * hs:(k + 1) * hs]))] for k in range(nx)]
    y = np.concatenate([p[0] for p in parts], axis=1)
    cb = np.concatenate([p[1] for p in parts], axis=1)
    cr = np.concatenate([p[2] for p in parts], axis=1)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, cb, cr)]


@pytest.mark.parametrize("ns,nx", [(2, 4), (4, 2)])
def test_entropy_half_equals_the_reference_step(ns, nx):
    h, w = 16 * 4 * 3, 160
    frames = session_frames(ns * 2, h, w)
    tables, arrays = tables_of(frames[0], h, w)
    step = j_batch.batch_encode_step(j_batch.make_mesh((ns, nx)), h, w,
                                     quality=85)
    packed, totals, hists = step(frames, *arrays)
    packed, totals = np.asarray(packed), np.asarray(totals)

    port = t_batch.batch_encode_step(h, w, quality=85, spatial=nx,
                                     device="cpu")
    got_p, got_t, got_h = port.entropy(*reference_levels(frames, nx), *arrays)
    np.testing.assert_array_equal(got_t.numpy(), totals)
    for a, b in zip(hists, got_h):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    strips = t_jd.strip_bytes(got_p, got_t)
    for i in range(ns * 2):
        for k in range(nx):
            data, bits = strips[i][k]
            assert bits == totals[i, k]
            np.testing.assert_array_equal(data, packed[i, k, :len(data)])
        want = j_batch.assemble_session_jpeg(packed[i], totals[i], tables,
                                             w, h, quality=85)
        assert t_batch.assemble_session_jpeg(
            [d for d, _ in strips[i]], totals[i], tables, w, h,
            quality=85) == want


def test_whole_step_sessions_decode_like_the_reference():
    ns, nx = 2, 4
    h, w = 16 * nx * 3, 160
    frames = session_frames(ns * 2, h, w)
    tables, arrays = tables_of(frames[0], h, w)
    step = j_batch.batch_encode_step(j_batch.make_mesh((ns, nx)), h, w,
                                     quality=85)
    packed, totals, _ = step(frames, *arrays)
    port = t_batch.batch_encode_step(h, w, quality=85, spatial=nx,
                                     device="cpu")
    got_p, got_t, got_h = port(frames, *arrays)
    assert got_p.shape[:2] == (ns * 2, nx) and got_h[1].shape == (ns * 2, 256)
    for i in range(ns * 2):
        want = j_batch.assemble_session_jpeg(
            np.asarray(packed[i]), np.asarray(totals[i]), tables, w, h, 85)
        got = t_batch.assemble_session_jpeg(got_p[i], got_t[i], tables, w, h,
                                            85)
        assert got.count(b"\xff\xdd") == 1
        ref = np.asarray(Image.open(io.BytesIO(want)).convert("RGB"))
        dec = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
        assert abs(psnr(frames[i], dec) - psnr(frames[i], ref)) < PSNR_TOL_DB


def test_step_preconditions():
    with pytest.raises(ValueError, match="MCU rows"):
        t_batch.batch_encode_step(16 * 3, 160, spatial=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        t_batch.batch_encode_step(64, 150, device="cpu")
    step = t_batch.batch_encode_step(64, 64, spatial=2, device="cpu")
    with pytest.raises(ValueError):
        step(np.zeros((1, 48, 64, 3), np.uint8), *t_jd.dense_tables(
            tables_of(np.zeros((64, 64, 3), np.uint8), 64, 64)[0]))
