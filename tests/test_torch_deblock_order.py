"""Loop filter (K8): a NumPy model of the kernel's schedule against the
reference's ``deblock_frame`` and the port's ``deblock_frame_plain``.

The kernel (``csrc/deblock.cu``) first works out each MB row's bS into a
table of 8 words of 4 bytes an MB (the pre-pass), then walks the row with
luma, Cb and Cr as separate chains (their lanes never exchange samples)
on a branch-free filter.  The model below does the same: the pre-pass's
table, the planes' chains apart, the filter with both results selected.
With ``lag`` it also moves the horizontal pass off the chain: the
horizontal edges of MB n's last four columns (the ones MB n+1's x = 0
edge reads) run before MB n+1's vertical edges, and those of columns
0-11 (0-3 for chroma) one MB later.  Exact equality with the reference
at every qp shows that these orders are the spec's."""

import functools

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import h264_deblock as j_db
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_deblock as t_db

GEOMETRY = {"random": (48, 96), "saturated": (32, 64)}


def bs_table(nr, nc, nnz=None, mv=None):
    """The pre-pass: (R, C, 8, 4) uint8, word e (0-3) the vertical edge
    x = 4e and word 4 + e (0-2) the horizontal edge y = 4(e + 1), byte g
    the 4-line (vertical) or 4-column (horizontal) group g."""
    t = np.zeros((nr, nc, 8, 4), np.uint8)
    if nnz is None:
        t[:, 1:, 0] = 4
        t[:, :, 1:7] = 3
        return t
    nz = nnz.astype(bool)                                   # [by][bx]
    mvd = np.zeros((nr, nc), bool)
    mvd[:, 1:] = (np.abs(mv[:, 1:] - mv[:, :-1]) >= 4).any(axis=-1)
    left = np.zeros((nr, nc, 4), bool)
    left[:, 1:] = nz[:, :-1, :, 3]
    t[:, :, 0] = np.where(left | nz[:, :, :, 0], 2,
                          np.where(mvd[:, :, None], 1, 0))
    t[:, 0, 0] = 0
    for e in (1, 2, 3):
        t[:, :, e] = 2 * (nz[:, :, :, e - 1] | nz[:, :, :, e])
        t[:, :, 3 + e] = 2 * (nz[:, :, e - 1, :] | nz[:, :, e, :])
    return t


def filt(p, q, bs, tab, chroma):
    """The kernel's branch-free line filter: p, q (4, n) with index 0
    nearest the edge, bs (n,); both filters computed, then selected."""
    alpha, beta, tc0 = tab
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q
    ad = np.abs(p0 - q0)
    fil = ((bs > 0) & (ad < alpha) & (np.abs(p1 - p0) < beta)
           & (np.abs(q1 - q0) < beta))
    ap, aq = np.abs(p2 - p0) < beta, np.abs(q2 - q0) < beta
    t0 = np.where(bs >= 3, tc0[2], np.where(bs == 2, tc0[1], tc0[0]))
    tc = t0 + 1 if chroma else t0 + ap + aq
    d = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    avg = (p0 + q0 + 1) >> 1
    np0, nq0 = np.clip(p0 + d, 0, 255), np.clip(q0 - d, 0, 255)
    np1 = np.where(ap & (not chroma),
                   p1 + np.clip((p2 + avg - 2 * p1) >> 1, -t0, t0), p1)
    nq1 = np.where(aq & (not chroma),
                   q1 + np.clip((q2 + avg - 2 * q1) >> 1, -t0, t0), q1)
    strong = ad < ((alpha >> 2) + 2)
    sp, sq = strong & ap & (not chroma), strong & aq & (not chroma)
    sp0 = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   (2 * p1 + p0 + q1 + 2) >> 2)
    sq0 = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   (2 * q1 + q0 + p1 + 2) >> 2)
    sp1 = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sq1 = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sp2 = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq2 = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    b4 = bs == 4
    pick = lambda s, n, o: np.where(fil, np.where(b4, s, n), o)
    return (np.stack([pick(sp0, np0, p0), pick(sp1, np1, p1),
                      pick(sp2, p2, p2), p3]),
            np.stack([pick(sq0, nq0, q0), pick(sq1, nq1, q1),
                      pick(sq2, q2, q2), q3]))


def _edge_v(rows, x, bs, tab, chroma):
    """Vertical edge at column x of (L, W): a lane a line."""
    p = rows[:, [x - 1, x - 2, x - 3, x - 4]].T
    q = rows[:, [x, x + 1, x + 2, x + 3]].T
    p, q = filt(p, q, bs, tab, chroma)
    rows[:, [x - 1, x - 2, x - 3]] = p[:3].T
    rows[:, [x, x + 1, x + 2]] = q[:3].T


def _edge_h(rows, y, cols, bs, tab, chroma):
    """Horizontal edge at row y of (L, W) on the columns ``cols``."""
    p = rows[[y - 1, y - 2, y - 3, y - 4]][:, cols]
    q = rows[[y, y + 1, y + 2, y + 3]][:, cols]
    p, q = filt(p, q, bs, tab, chroma)
    for i in range(3):
        rows[y - 1 - i, cols] = p[i]
        rows[y + i, cols] = q[i]


def walk_row(rows, t_row, tab, chroma, lag):
    """One plane's chain over one MB row, in place: ``rows`` (16 or 8, W)
    int64, ``t_row`` (C, 8, 4) the row's bS table.  A chroma lane k reads
    group k >> 1 of the luma words (its luma line or column is 2k)."""
    n = 8 if chroma else 16
    g = np.arange(n) // (2 if chroma else 4)
    v_words = (0, 2) if chroma else (0, 1, 2, 3)
    h_words = ((5, 4),) if chroma else ((4, 4), (5, 8), (6, 12))
    tail = np.arange(n - 4, n)                    # read by the next x = 0 edge

    def h_pass(c, cols):
        for word, y in h_words:
            _edge_h(rows, y, c * n + cols, t_row[c, word][cols // (
                2 if chroma else 4)], tab, chroma)

    nc = len(t_row)
    for c in range(nc):
        for i, word in enumerate(v_words):
            if c or i:
                _edge_v(rows, c * n + 4 * i, t_row[c, word][g], tab, chroma)
        if not lag:
            h_pass(c, np.arange(n))
            continue
        h_pass(c, tail)
        if c:
            h_pass(c - 1, np.arange(n - 4))       # a step behind
    if lag:
        h_pass(nc - 1, np.arange(n - 4))


def model_deblock(y, cb, cr, qp, nnz=None, mv=None, lag=False):
    """K8's schedule: the pre-pass's table, then each row's three chains."""
    h, w = y.shape
    nr, nc = h // 16, w // 16
    table = bs_table(nr, nc, nnz, mv)
    tl, tc = t_db._tables(qp)
    out = [p.astype(np.int64).copy() for p in (y, cb, cr)]
    for r in range(nr):
        walk_row(out[0][16 * r:16 * r + 16], table[r], tl, False, lag)
        for p in out[1:]:
            walk_row(p[8 * r:8 * r + 8], table[r], tc, True, lag)
    return [p.astype(np.uint8) for p in out]


def _planes(kind, seed):
    h, w = GEOMETRY[kind]
    rng = np.random.default_rng(seed)

    def plane(hh, ww, blk):
        if kind == "random":
            steps = rng.integers(40, 220, (hh // blk, ww // blk))
            p = (np.kron(steps, np.ones((blk, blk)))
                 + rng.integers(-4, 5, (hh, ww)))
        else:
            # bands of rows: 0, 255, flat near each end with small steps
            # at the 4x4 edges (strong filter, clips), a 0/255 checkerboard
            yy, xx = np.mgrid[0:hh, 0:ww]
            band = (yy // 4) % 5
            step = (xx // 4) % 2 * 3
            p = np.select([band == 0, band == 1, band == 2, band == 3],
                          [0 * xx, 255 + 0 * xx, 2 + step, 252 - step],
                          (yy + xx) % 2 * 255)
        return np.clip(p, 0, 255).astype(np.uint8)

    return plane(h, w, 4), plane(h // 2, w // 2, 2), plane(h // 2, w // 2, 4)


def _p_side(kind, seed):
    h, w = GEOMETRY[kind]
    rng = np.random.default_rng(seed)
    nnz = rng.random((h // 16, w // 16, 4, 4)) < 0.4
    step = rng.choice([0, 3, -3, 4, -4], (h // 16, w // 16, 2))
    return nnz, np.cumsum(step, axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(kind, qp, intra):
    y, cb, cr = _planes(kind, qp)
    kw = {} if intra else dict(zip(("nnz_blk", "mv"), _p_side(kind, qp + 1)))
    return [np.asarray(p) for p in j_db.deblock_frame(y, cb, cr, qp, **kw)]


@pytest.mark.parametrize("intra", [True, False])
def test_bs_table_expands_to_the_reference_bs(intra):
    """The pre-pass's table, byte g of word e, is the per-line bS of the
    reference's and the plain version's grids."""
    nr, nc = 3, 5
    rng = np.random.default_rng(7)
    nnz = None if intra else rng.random((nr, nc, 4, 4)) < 0.4
    mv = None if intra else rng.choice([0, 3, 4, -4], (nr, nc, 2)).cumsum(1)
    t = bs_table(nr, nc, nnz, mv)
    lines = np.arange(16) // 4
    bs_v = t[:, :, 0:4][..., lines]
    bs_h = t[:, :, 4:7][..., lines]
    ref = j_db.intra_bs(nr, nc) if intra else j_db.p_bs(nnz, mv)
    plain = (t_db.bs_grids(nr, nc) if intra else t_db.bs_grids(
        nr, nc, torch.from_numpy(nnz), torch.from_numpy(mv.astype(np.int32))))
    for got, want, p in zip((bs_v, bs_h), ref, plain):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, p.numpy())


@pytest.mark.parametrize("lag", [False, True], ids=["in_step", "lagged"])
@pytest.mark.parametrize("kind", ["random", "saturated"])
@pytest.mark.parametrize("intra", [True, False], ids=["intra", "p"])
@pytest.mark.parametrize("qp", [15, 30, 51])
def test_schedule_equals_the_reference(qp, intra, kind, lag):
    y, cb, cr = _planes(kind, qp)
    nnz, mv = (None, None) if intra else _p_side(kind, qp + 1)
    got = model_deblock(y, cb, cr, qp, nnz, mv, lag)
    want = _reference(kind, qp, intra)
    kw = {} if intra else {"nnz_blk": torch.from_numpy(nnz),
                           "mv": torch.from_numpy(mv)}
    plain = t_db.deblock_frame_plain(*(torch.from_numpy(p) for p in (y, cb, cr)),
                                     qp, **kw)
    for name, a, b, c, src in zip(("y", "cb", "cr"), got, want, plain,
                                  (y, cb, cr)):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c.numpy(), err_msg=name)
        if name == "y":     # alpha(15) = 0 filters nothing; 30, 51 do
            assert (not np.array_equal(a, src)) == (qp > 15)
