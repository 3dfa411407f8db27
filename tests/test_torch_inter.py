"""P core (K5): the plain PyTorch version against the reference's
``encode_p_frame`` — MVs, every level tensor and the recon planes exact,
on sub-pel motion, integer motion and MVs that reach off the frame."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import h264_inter as j_inter
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter as t_inter

H, W = 64, 96


def _scene(t, h=H, w=W):
    """Smooth texture drifting by (1.25 t, -2.5 t) pels: sub-pel motion
    everywhere, edge MBs matching partly outside the frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    b = ((xx * 3 + yy * 2) % 256).astype(np.float64)
    b += 40 * np.sin((xx + 2.5 * t) / 5.0) * np.cos((yy - 1.25 * t) / 7.0)
    return np.clip(b, 0, 255).astype(np.uint8)


def _frames(kind, seed):
    rng = np.random.default_rng(seed)
    ref_c = [rng.integers(0, 256, (H // 2, W // 2), np.uint8) for _ in "uv"]
    if kind == "subpel":
        ref_y, cur_y = _scene(0), _scene(1)
        cur_c = [np.roll(ref_c[0], 3, axis=1), np.roll(ref_c[1], -2, axis=0)]
    else:                                   # integer shift of a rich frame
        ref_y = rng.integers(0, 256, (H, W), np.uint8)
        cur_y = np.roll(ref_y, (4, -6), axis=(0, 1))
        cur_c = [np.roll(c, (1, -2), axis=(0, 1)) for c in ref_c]
    cur_y[:16] = ref_y[:16]                 # a static row: zero MVs
    return ([np.ascontiguousarray(a) for a in [cur_y] + cur_c],
            [np.ascontiguousarray(a) for a in [ref_y] + ref_c])


@pytest.mark.parametrize("kind,qp", [("subpel", 30), ("subpel", 12),
                                     ("integer", 44)])
def test_plain_p_core_equals_reference(kind, qp):
    cur, ref = _frames(kind, seed=qp)
    want = j_inter.encode_p_frame(*cur, *ref, qp)
    before = t_inter.encode_p_frame.launches
    got = t_inter.encode_p_frame(*map(torch.from_numpy, cur),
                                 *map(torch.from_numpy, ref), qp)
    assert t_inter.encode_p_frame.launches == before      # plain path
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == (torch.uint8 if k.startswith("recon")
                                else torch.int32), k
        np.testing.assert_array_equal(np.asarray(want[k]).astype(np.int64),
                                      got[k].numpy().astype(np.int64),
                                      err_msg=k)
    mv = got["mv"].numpy()
    assert (mv[0] == 0).all()                               # static row
    if kind == "subpel":
        assert (mv % 4 != 0).any()                          # sub-pel MVs
    else:
        assert (mv[1:] == (-16, 24)).all(axis=-1).any()     # (4, -6) pels
    # some prediction reaches past the frame edge (clamped reads)
    r, c = np.mgrid[0:H // 16, 0:W // 16]
    y0, x0 = 16 * r + mv[..., 0] / 4, 16 * c + mv[..., 1] / 4
    assert ((y0 < 0) | (y0 > H - 16) | (x0 < 0) | (x0 > W - 16)).any()
    assert any(np.asarray(want[k]).any() for k in ("luma", "cb_ac"))


def test_options_outside_the_slice_raise():
    z = torch.zeros((32, 32), dtype=torch.uint8)
    c = torch.zeros((16, 16), dtype=torch.uint8)
    # refine="full" serves now (tests/test_torch_intra_modes.py holds it
    # against the reference); an unknown refine raises
    assert t_inter.encode_p_frame(z, c, c, z, c, c, 26, refine="full")[
        "mv"].shape == (2, 2, 2)
    with pytest.raises(ValueError, match="unknown refine"):
        t_inter.encode_p_frame(z, c, c, z, c, c, 26, refine="half")
    with pytest.raises(ValueError, match="p_intra requires"):
        t_inter.encode_p_frame(z, c, c, z, c, c, 26, p_intra=True)
    with pytest.raises(ValueError, match="unknown tune"):
        t_inter.encode_p_frame(z, c, c, z, c, c, 26, tune="hq2")
    with pytest.raises(ValueError):
        t_inter.encode_p_frame(z, c, c, z[:16].contiguous(), c[:8], c[:8], 26)


def test_constants_and_tables_equal_reference():
    for k in ("SEARCH_R", "ZERO_MV_BIAS", "HALF_BIAS", "QUARTER_BIAS",
              "_PAD"):
        assert getattr(t_inter, k) == getattr(j_inter, k), k
    np.testing.assert_array_equal(t_inter._candidate_shifts(),
                                  j_inter._candidate_shifts())
    pad = np.pad(_scene(0).astype(np.int32), j_inter._PAD, mode="edge")
    for a, b in zip(j_inter._halfpel_planes(pad),
                    t_inter._halfpel_planes(torch.from_numpy(pad))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
