"""The damage mask's row-compacted P stage at the tune tiers in the port
against the reference: ``row_core`` (K5r's plain version at hq_noaq and
at hq with and without I16-in-P, the qp plane of the worklist's rows
with and without the lookahead, the slot coder's qp chain over the
compacted rows, the loop filter on the stack, the row scatter) against
the reference's ``damage_mask.encode_p_rows`` on worklists with and
without padded duplicates, and K14r's plain version against the
reference's ``qp_plane`` of each row band.  The masked encoders at
these tiers are ``test_torch_damage_tune_full.py`` and
``test_torch_damage_tune_served.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cavlc
from docker_nvidia_glx_desktop_tpu.ops import damage_mask as j_dmg
from docker_nvidia_glx_desktop_tpu_torch.ops import aq, cavlc_device
from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter

# 4 x 7 MBs: a geometry of its own, so that no reference program here is
# one that the masked encoders' tests (4 x 6 MBs) compile at the same time
# in another worker
W, H = 64, 112
ROWS, COLS = H // 16, W // 16
# one qp family for every reference program here (each qp, tier and
# bucket is a slow compile of the reference's hq program)
QP = 20


def _planes(rng, h=H, w=W):
    """Gradients with mild noise."""
    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        g = (yy * 3 + xx * 2) % 256 + rng.integers(-6, 7, (ph, pw))
        return np.clip(g, 0, 255).astype(np.uint8)
    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


def _frame_pair(seed):
    """A reference and a current frame: the reference moved by a few pels
    with noise, and in MB rows 0, 3 and 5 a new flat panel motion search
    cannot follow (where I16-in-P fires), a different shade in each."""
    rng = np.random.default_rng(seed)
    ref = _planes(rng)
    cur = [np.clip(np.roll(p, (1, 3), (0, 1)).astype(int)
                   + rng.integers(-3, 4, p.shape), 0, 255).astype(np.uint8)
           for p in ref]
    for r, shade in ((0, 60), (3, 140), (5, 210)):
        cur[0][r * 16 + 2:r * 16 + 14, 12:44] = shade
        cur[1][r * 8 + 1:r * 8 + 7, 6:22] = 128 - shade // 8
        cur[2][r * 8 + 1:r * 8 + 7, 6:22] = 120 + shade // 8
    nxt = np.clip(cur[0].astype(int) + rng.integers(-2, 3, cur[0].shape)
                  + np.where(np.arange(H)[:, None] // 16 == 5, 40, 0),
                  0, 255).astype(np.uint8)
    return tuple(cur), ref, nxt


# (tune, p_intra, deblock, lookahead): the served tier (deblock on), the
# full tier, the full tier with I16-in-P
TIERS = [("hq_noaq", False, True, False), ("hq", False, False, True),
         ("hq", True, False, None)]


@pytest.mark.parametrize("rows", [[3], [5, 0, 0, 5]])
@pytest.mark.parametrize("tune,p_intra,deblock,lookahead", TIERS)
def test_row_core_at_the_tune_tiers_equals_the_reference(
        tune, p_intra, deblock, lookahead, rows):
    """row_core's outputs (flat, scattered references, MVs, nnz, every
    level tensor with the qp plane and the I16-in-P tensors) equal the
    reference's encode_p_rows."""
    cur, ref, nxt = _frame_pair(len(rows) + 7)
    if lookahead is None:           # the I16-in-P cases: one of each
        lookahead = len(rows) > 1
    hv, hl = cavlc_device.slice_header_slots(
        ROWS, COLS, frame_num=3, qp_delta=-6, slice_type=5, idr=False,
        deblocking_idc=2 if deblock else 1)
    pr = np.asarray(rows, np.int32)
    got = dmg.row_core(*(torch.from_numpy(p) for p in cur + ref),
                       torch.from_numpy(pr),
                       torch.from_numpy(hv.view(np.int32)[pr]),
                       torch.from_numpy(hl[pr]), QP, tune=tune,
                       next_y=torch.from_numpy(nxt) if lookahead else None,
                       p_intra=p_intra, deblock=deblock)
    jhv, jhl = j_cavlc.slice_header_slots(
        ROWS, COLS, frame_num=3, qp_delta=-6, slice_type=5, idr=False,
        deblocking_idc=2 if deblock else 1)
    want = j_dmg.encode_p_rows(
        *(jnp.asarray(p) for p in cur + ref), jnp.asarray(pr),
        jnp.asarray(np.asarray(jhv)[pr]), jnp.asarray(np.asarray(jhl)[pr]),
        QP, tune=tune, next_y=jnp.asarray(nxt) if lookahead else None,
        p_intra=p_intra, deblock=deblock)
    flat, wflat = got[0].numpy(), np.asarray(want[0])
    meta = cavlc_device.FlatMeta(flat, len(rows))
    n = cavlc_device.META_WORDS * 4 + 4 * meta.total_words
    assert not meta.overflow
    np.testing.assert_array_equal(flat[:n], wflat[:n])
    assert not wflat[n:].any() and not flat[n:].any()
    assert bool(meta.qp_sum) == (tune == "hq")
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f"output {i}")
    np.testing.assert_array_equal(
        got[5].numpy().reshape(len(rows), COLS, 16),
        np.asarray(want[5]).reshape(len(rows), COLS, 16))
    assert set(got[6]) == set(want[6])
    for k, v in got[6].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[6][k]),
                                      err_msg=k)
    if tune == "hq":
        assert got[6]["qp_map"].shape == (len(rows), COLS)
    if p_intra:
        assert bool(got[6]["mb_intra"].any()), "no I16-in-P MB"


@pytest.mark.parametrize("lookahead", [False, True])
def test_k14r_plain_equals_the_reference_bands(lookahead):
    """K14r's plain version: the worklist's (b, C) qp plane equals the
    reference's qp_plane of each row band (with the same rows of the next
    frame), and the frame's plane gathered at the rows."""
    rng = np.random.default_rng(5)
    # each MB's noise amplitude from flat to full scale: activities across
    # the delta's breakpoints, next-frame SADs across the bias thresholds
    amp = rng.choice([0, 1, 2, 4, 8, 16, 40, 127], (ROWS, COLS))
    a = np.kron(amp, np.ones((16, 16), int))
    y_np = np.clip(128 + rng.integers(-a, a + 1), 0, 255).astype(np.uint8)
    d = np.kron(rng.choice([0, 1, 3, 9], (ROWS, COLS)), np.ones((16, 16), int))
    nxt = np.clip(y_np + rng.integers(-d, d + 1), 0, 255).astype(np.uint8)
    cur = (y_np,)
    y = torch.from_numpy(y_np)
    ny = torch.from_numpy(nxt) if lookahead else None
    rows = torch.tensor([5, 0, 0, 2, 5], dtype=torch.int32)
    got = aq.qp_plane(y, QP, ny, rows=rows)
    want = np.concatenate([np.asarray(j_aq.qp_plane(
        jnp.asarray(cur[0][r * 16:r * 16 + 16]), QP,
        None if ny is None else jnp.asarray(nxt[r * 16:r * 16 + 16])))
        for r in rows.tolist()])
    np.testing.assert_array_equal(got.numpy(), want)
    full = aq.qp_plane(y, QP, ny)
    assert torch.equal(got, full[rows.long()])
    assert len(set(got.flatten().tolist())) > 1
    out = torch.empty((5, COLS), dtype=torch.int32)
    assert aq.qp_plane(y, QP, ny, out=out, rows=rows) is out
    with pytest.raises(ValueError):
        aq.qp_plane(y, QP, ny, rows=rows[None])
    with pytest.raises(ValueError):
        aq.qp_plane(y, QP, ny, out=torch.empty((ROWS, COLS),
                                               dtype=torch.int32),
                    rows=rows)


@pytest.mark.parametrize("tune,p_intra", [("hq_noaq", False),
                                          ("hq", False), ("hq", True)])
def test_k5r_tune_rows_equal_the_full_frame_rows(tune, p_intra):
    """Without I16-in-P a listed row's P core at the tune tiers equals the
    full frame's row (the search clamps at the frame's edges, the qp
    plane is per MB); I16-in-P predicts from the left MB of its own row,
    which the stack keeps."""
    cur, ref, nxt = _frame_pair(3)
    t = [torch.from_numpy(p) for p in cur + ref]
    ny = torch.from_numpy(nxt)
    qp_map = aq.qp_plane(t[0], QP, ny) if tune == "hq" else None
    full = h264_inter.encode_p_frame_plain(*t, QP, tune, qp_map, p_intra)
    rows = torch.tensor([5, 0, 2, 2], dtype=torch.int32)
    got = h264_inter.encode_p_frame_rows(*t, rows, QP, tune=tune, next_y=ny,
                                         p_intra=p_intra)
    assert set(got) == set(full)
    idx = rows.long()
    for k, v in got.items():
        if k.startswith("recon"):
            n = v.shape[0] // len(rows)
            want = full[k].view(ROWS, n, -1)[idx].reshape(v.shape)
        else:
            want = full[k][idx]
        assert torch.equal(v, want), k


def test_k5r_rows_refuse_what_the_full_frame_refuses():
    cur, ref, _ = _frame_pair(3)
    t = [torch.from_numpy(p) for p in cur + ref]
    rows = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="p_intra"):
        h264_inter.encode_p_frame_rows(*t, rows, QP, p_intra=True)
    with pytest.raises(ValueError, match="tune"):
        h264_inter.encode_p_frame_rows(*t, rows, QP, tune="hq2")
    with pytest.raises(ValueError):
        h264_inter.encode_p_frame_rows(
            *t, torch.tensor([ROWS], dtype=torch.int32), QP, tune="hq")
