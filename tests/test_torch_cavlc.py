"""CAVLC slot coder (K2) and bit packer (K3): the plain PyTorch versions
against the reference's ``frame_block_slots`` / ``_finish_cavlc`` — slots
exact, flat-buffer prefix exact, equal FlatMeta and Annex-B bytes."""

import jax
import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cavlc
from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_intra
from docker_nvidia_glx_desktop_tpu_torch.ops import bitmerge as t_pack
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device as t_cavlc

import conftest


def _levels(h, w, qp, noise):
    rng = np.random.default_rng(qp)
    if noise:
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cb = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
        cr = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    else:
        f = conftest.make_test_frame(h, w, seed=qp).astype(np.int32)
        y = ((f[..., 0] * 2 + f[..., 1] * 5 + f[..., 2]) // 8).astype(np.uint8)
        y[:, :w // 2] = ((np.arange(w // 2) * 37) % 256)[None, :]
        cb = y[::2, ::2] // 2 + 40
        cr = 255 - y[1::2, 1::2]
    return j_intra.encode_intra_frame_yuv(y, cb, cr, qp)


@pytest.mark.parametrize("h,w,qp,noise", [
    (48, 64, 26, False),
    (48, 80, 34, False),
    (48, 64, 1, True),        # low-qp noise: both raise the overflow flag
])
def test_plain_slots_and_pack_equal_reference(h, w, qp, noise):
    nr, nc = h // 16, w // 16
    lv = _levels(h, w, qp, noise)
    hv, hl = j_cavlc.slice_header_slots(nr, nc, frame_num=0, idr_pic_id=1,
                                        qp_delta=qp - 26, deblocking_idc=2)
    flat_j, ref_slots = jax.jit(lambda l, a, b: (
        j_cavlc._finish_cavlc(l, a, b, False, qp),
        j_cavlc.frame_block_slots(l)[:4]))(lv, hv, hl)
    flat_j = np.asarray(flat_j)

    tl = {k: torch.from_numpy(np.array(v)) for k, v in lv.items()}
    before = (t_cavlc.frame_block_slots.launches, t_pack.pack_frame.launches)
    slots = t_cavlc.frame_block_slots(tl)
    for name, a, b in zip(("values", "lengths", "syn_vals", "syn_lens"),
                          ref_slots, slots):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64), err_msg=name)
    flat_t = t_pack.pack_frame(*slots, torch.from_numpy(hv.view(np.int32)),
                               torch.from_numpy(hl)).numpy()
    assert (t_cavlc.frame_block_slots.launches,
            t_pack.pack_frame.launches) == before       # plain path on CPU
    assert flat_t.dtype == np.uint8 and flat_t.shape == flat_j.shape

    mj = j_cavlc.FlatMeta(flat_j, nr)
    mt = t_cavlc.FlatMeta(flat_t, nr)
    assert mj.overflow == mt.overflow == noise
    np.testing.assert_array_equal(flat_j[:4 * j_cavlc.META_WORDS],
                                  flat_t[:4 * t_cavlc.META_WORDS])
    assert (mj.total_words, mj.qp_sum) == (mt.total_words, mt.qp_sum)
    assert (mj.row_bytes == mt.row_bytes).all()
    assert (mj.word_off == mt.word_off).all()
    if noise:
        return
    n = 4 * (j_cavlc.META_WORDS + mj.total_words)
    np.testing.assert_array_equal(flat_j[:n], flat_t[:n])
    assert not flat_t[n:].any()
    hdr = b"\x00\x00\x00\x01\x67"
    assert (j_cavlc.assemble_annexb(flat_j, mj, headers=hdr)
            == t_cavlc.assemble_annexb(flat_t, mt, headers=hdr))


def test_pack_rejects_bad_shapes():
    z = torch.zeros((2, 3, 27, 34), dtype=torch.int32)
    s = torch.zeros((2, 3, 20), dtype=torch.int32)
    h = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_pack.pack_frame(z, z, s, s, h[:1], h)
    with pytest.raises(ValueError):
        t_pack.pack_frame(z.to(torch.int64), z, s, s, h, h)
    flat = t_pack.pack_frame(z, z, s, s, h, h).numpy()
    meta = t_cavlc.FlatMeta(flat, 2)
    # empty rows: just the stop bit and its alignment, one byte each
    assert not meta.overflow and list(meta.row_bytes) == [1, 1]
    assert flat[4096] == 0x80 and flat[4100] == 0x80
