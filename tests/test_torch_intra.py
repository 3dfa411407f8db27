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
