"""Intra core (K1): the plain PyTorch version against the reference's
``encode_intra_frame_yuv`` — every output key exact."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_intra
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device as t_intra
from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
    rgb_to_yuv420_host)

import conftest


def _planes(h, w, seed, noise=False):
    frame = conftest.make_test_frame(h, w, seed=seed)
    # sawtooth columns: vertical edges inside MBs, where I4x4's vertical
    # modes win over I16
    frame[:, :w // 2] = ((np.arange(w // 2) * 37) % 256)[None, :, None]
    if noise:
        frame = np.random.default_rng(seed).integers(0, 256, frame.shape,
                                                     dtype=np.uint8)
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    return [np.ascontiguousarray(p)
            for p in rgb_to_yuv420_host(frame, ph, pw)]


@pytest.mark.parametrize("h,w,qp,noise", [
    (48, 64, 26, False),      # 3 MB rows
    (48, 64, 6, True),        # low qp on noise: large levels, escapes
    (40, 72, 38, False),      # cropped geometry (padded to 48 x 80)
])
def test_plain_intra_core_equals_reference(h, w, qp, noise):
    y, cb, cr = _planes(h, w, seed=qp, noise=noise)
    ref = j_intra.encode_intra_frame_yuv(y, cb, cr, qp)
    before = t_intra.encode_intra_frame_yuv.launches
    got = t_intra.encode_intra_frame_yuv(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr), qp)
    assert t_intra.encode_intra_frame_yuv.launches == before  # plain path
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == torch.from_numpy(r).dtype, k
        np.testing.assert_array_equal(r, got[k].numpy(), err_msg=k)
    # the mode decisions are exercised, not trivially constant
    assert np.asarray(ref["mb_i4"]).any() or noise
    assert (np.asarray(ref["pred_mode"]) == 1).any() or noise


def test_wrapper_checks_its_inputs():
    y = torch.zeros((32, 32), dtype=torch.uint8)
    c = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        t_intra.encode_intra_frame_yuv(y.to(torch.int32), c, c, 26)
    with pytest.raises(ValueError):
        t_intra.encode_intra_frame_yuv(y[:, :24].contiguous(), c, c, 26)
    with pytest.raises(ValueError):
        t_intra.encode_intra_frame_yuv(y, c, c, 52)
    with pytest.raises(ValueError):
        t_intra.encode_intra_frame_yuv(y, c[:, :8], c, 26)


def _chain_planes(kind):
    """48x64 planes the CUDA chain pass is sensitive to: ``saturated``
    (one MB row each of all 0, all 255 and a 0/255 checkerboard),
    ``all_i4`` (diagonal stripes: every MB picks I4) and ``all_h``
    (constant rows: every MB with a left neighbour picks I16 H)."""
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    if kind == "saturated":
        y = np.where(yy < 16, 0, np.where(yy < 32, 255, (yy + xx) % 2 * 255))
        cb = np.where(cy < 8, 0, np.where(cy < 16, 255, (cy + cx) % 2 * 255))
        cr = 255 - cb
    elif kind == "all_i4":
        y = (xx + yy) * 29 % 256
        cb, cr = (cx * 7 + cy * 3) % 256, (cx * 5 + 90) % 256
    else:
        y = yy * 53 % 256 + 0 * xx
        cb, cr = cy * 11 % 256 + 0 * cx, (cy * 5 + 60) % 256 + 0 * cx
    return [np.ascontiguousarray(p.astype(np.uint8)) for p in (y, cb, cr)]


@pytest.mark.parametrize("kind", ["saturated", "all_i4", "all_h"])
def test_plain_intra_core_on_the_chain_cases(kind):
    y, cb, cr = _chain_planes(kind)
    ref = j_intra.encode_intra_frame_yuv(y, cb, cr, 26)
    got = t_intra.encode_intra_frame_yuv(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr), 26)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(),
                                      err_msg=k)
    if kind == "all_i4":
        assert got["mb_i4"].all()
        assert len(torch.unique(got["i4_modes"])) > 2
    elif kind == "all_h":
        assert not got["mb_i4"].any() and (got["pred_mode"][:, 1:] == 1).all()


def test_transform_is_linear_over_extreme_inputs():
    """What the CUDA pre-pass relies on: fdct(src - pred) equals
    fdct(src) - fdct(pred) exactly, so the quantised levels are equal, for
    every 0/255 source block against constant, row-, column-constant and
    0/255 predictions."""
    from docker_nvidia_glx_desktop_tpu_torch.ops import dct, quant

    bits = torch.arange(1 << 16)[:, None] >> torch.arange(16) & 1
    src = (bits * 255).to(torch.int32).reshape(-1, 4, 4)
    rng = np.random.default_rng(0)
    line = torch.from_numpy(
        rng.choice([0, 255], (len(src), 4)).astype(np.int32))
    preds = [torch.full_like(src, 255), line[:, :, None].expand(-1, 4, 4),
             line[:, None, :].expand(-1, 4, 4), 255 - src.flip(0)]
    for pred in preds:
        pred = pred.contiguous()
        whole = dct.fdct4x4(src - pred)
        np.testing.assert_array_equal(
            whole.numpy(), (dct.fdct4x4(src) - dct.fdct4x4(pred)).numpy())
        for qp in (0, 26, 51):
            np.testing.assert_array_equal(
                quant.h264_quantize_4x4(whole, qp, intra=True).numpy(),
                quant.h264_quantize_4x4(dct.fdct4x4(src) - dct.fdct4x4(pred),
                                        qp, intra=True).numpy())
