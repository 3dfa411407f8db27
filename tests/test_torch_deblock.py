"""Loop filter (K8): the plain PyTorch version against the reference's
``deblock_frame`` for intra and P bS at low (alpha = 0), mid and high qp,
and the port's constant tables against the reference's recovered ones."""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import h264_deblock as j_db
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_deblock as t_db

H, W = 48, 64


def _planes(seed):
    """Blocky planes with small noise: most 4x4 edges are real steps
    the filter smooths, some too large for it."""
    rng = np.random.default_rng(seed)

    def plane(h, w, blk):
        steps = rng.integers(70, 190, (h // blk, w // blk))
        p = np.kron(steps, np.ones((blk, blk))) + rng.integers(-3, 4, (h, w))
        return np.clip(p, 0, 255).astype(np.uint8)

    return plane(H, W, 4), plane(H // 2, W // 2, 2), plane(H // 2, W // 2, 4)


def test_tables_equal_the_reference_recovery():
    alpha, beta, tc0 = j_db.load_tables()
    np.testing.assert_array_equal(alpha, t_db.ALPHA)
    np.testing.assert_array_equal(beta, t_db.BETA)
    np.testing.assert_array_equal(tc0, t_db.TC0)


@pytest.mark.parametrize("qp", [12, 30, 46])
@pytest.mark.parametrize("intra", [True, False])
def test_plain_deblock_equals_reference(qp, intra):
    y, cb, cr = _planes(qp)
    rng = np.random.default_rng(qp + 1)
    nnz = rng.random((H // 16, W // 16, 4, 4)) < 0.4
    mv = rng.integers(-9, 10, (H // 16, W // 16, 2)).astype(np.int32)
    mv[:, 1] = mv[:, 0] + 3           # |dmv| < 4 at some MB edges: bS 0
    if intra:
        want = j_db.deblock_frame(y, cb, cr, qp)
        kw = {}
    else:
        want = j_db.deblock_frame(y, cb, cr, qp, nnz_blk=nnz, mv=mv)
        kw = {"nnz_blk": torch.from_numpy(nnz), "mv": torch.from_numpy(mv)}
    before = t_db.deblock_frame.launches
    ins = [torch.from_numpy(p) for p in (y, cb, cr)]
    got = t_db.deblock_frame(*ins, qp, **kw)
    assert t_db.deblock_frame.launches == before             # plain path
    for name, a, b, src, t in zip(("y", "cb", "cr"), want, got,
                                  (y, cb, cr), ins):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        assert np.array_equal(t.numpy(), src)                # inputs intact
        # alpha(12) = 0 filters nothing; higher qps do filter
        assert (not np.array_equal(b.numpy(), src)) == (qp > 15), name


def test_bs_grids_equal_the_reference():
    rng = np.random.default_rng(3)
    nnz = rng.random((2, 3, 4, 4)) < 0.5
    mv = rng.integers(-8, 9, (2, 3, 2)).astype(np.int32)
    for want, got in ((j_db.intra_bs(2, 3), t_db.bs_grids(2, 3)),
                      (j_db.p_bs(nnz, mv),
                       t_db.bs_grids(2, 3, torch.from_numpy(nnz),
                                     torch.from_numpy(mv)))):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b.numpy())


def test_deblock_checks_its_inputs():
    y = torch.zeros((32, 32), dtype=torch.uint8)
    c = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        t_db.deblock_frame(y, c, c, 26, nnz_blk=torch.zeros((2, 2, 4, 4)),
                           mv=torch.zeros((2, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        t_db.deblock_frame(y, c, c, 52)
