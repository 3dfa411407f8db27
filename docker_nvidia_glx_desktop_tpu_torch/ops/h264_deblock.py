"""H.264 in-loop deblocking filter (K8, spec 8.7) under slice-per-row.

Replaces the reference's ``ops/h264_deblock.py`` ``deblock_frame``.
With ``disable_deblocking_filter_idc=2`` the filter never crosses a
slice, and the slices are the MB rows: only the vertical edges (x = 0,
4, 8, 12 of each MB; none left of column 0) and the internal horizontal
edges (y = 4, 8, 12) are filtered, chroma its MB edge, x = 4 and y = 4.
Rows are independent; inside a row the MBs go left to right, because
MB n's x=0 edge rewrites the last columns of MB n-1 after n-1 finished.

The alpha/beta (Table 8-16) and tC0 (Table 8-17) tables are constants
here.  The reference recovers them from the system libx264 at run time;
the port has no run-time dependency on libx264, and the tests pin these
constants equal to the reference's recovered tables.

:func:`deblock_frame` launches ``csrc/deblock.cu`` for CUDA tensors and
runs :func:`deblock_frame_plain` for CPU tensors.  Both return new
planes and leave their inputs as they were.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, quant

# indexA -> alpha' and indexB -> beta' (Table 8-16), qp 0..51
ALPHA = np.array(
    [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32,
                36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162,
                182, 203, 226, 255, 255], dtype=np.int32)
BETA = np.array(
    [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
                11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18,
                18], dtype=np.int32)
# indexA -> tC0 for bS = 1, 2, 3 (Table 8-17)
TC0 = np.array(
    [(0, 0, 0)] * 17
    + [(0, 0, 1)] * 4 + [(0, 1, 1)] * 2 + [(1, 1, 1)] * 4 + [(1, 1, 2)] * 4
    + [(1, 2, 3)] * 2
    + [(2, 2, 3), (2, 2, 4), (2, 3, 4), (2, 3, 4), (3, 3, 5), (3, 4, 6),
       (3, 4, 6), (4, 5, 7), (4, 5, 8), (4, 6, 9), (5, 7, 10), (6, 8, 11),
       (6, 8, 13), (7, 10, 14), (8, 11, 16), (9, 12, 18), (10, 13, 20),
       (11, 15, 23), (13, 17, 25)], dtype=np.int32)
assert ALPHA.shape == BETA.shape == (52,) and TC0.shape == (52, 3)
_MAX_NC = 512               # MBs a row the kernel takes (csrc/deblock.cu MAX_NC)


def _tables(qp: int):
    """((alpha, beta, tc0) luma, (alpha, beta, tc0) chroma) at ``qp``."""
    qc = quant.chroma_qp(qp)
    return ((int(ALPHA[qp]), int(BETA[qp]), tuple(int(v) for v in TC0[qp])),
            (int(ALPHA[qc]), int(BETA[qc]), tuple(int(v) for v in TC0[qc])))


def _filter_lines(p, q, bs, alpha, beta, tc0, chroma: bool):
    """Spec 8.7.2.3/8.7.2.4 over line bundles: p, q (..., 4) int32 with
    index 0 nearest the edge, bs (...,).  Returns (p_new, q_new)."""
    p0, p1, p2, p3 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    fil = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
           & ((q1 - q0).abs() < beta) & (bs > 0))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    # bS < 4
    t0 = torch.where(bs <= 1, tc0[0], torch.where(bs == 2, tc0[1], tc0[2]))
    tc = t0 + 1 if chroma else t0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.maximum(torch.minimum(
        ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, tc), -tc)
    n_p0 = torch.clamp(p0 + delta, 0, 255)
    n_q0 = torch.clamp(q0 - delta, 0, 255)
    if chroma:
        n_p1, n_q1 = p1, q1
    else:
        avg = (p0 + q0 + 1) >> 1
        dp1 = torch.maximum(torch.minimum((p2 + avg - 2 * p1) >> 1, t0), -t0)
        dq1 = torch.maximum(torch.minimum((q2 + avg - 2 * q1) >> 1, t0), -t0)
        n_p1 = torch.where(ap, p1 + dp1, p1)
        n_q1 = torch.where(aq, q1 + dq1, q1)
    n_p2, n_q2 = p2, q2

    # bS == 4
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    s_p0 = (2 * p1 + p0 + q1 + 2) >> 2
    s_q0 = (2 * q1 + q0 + p1 + 2) >> 2
    s_p1, s_p2, s_q1, s_q2 = p1, p2, q1, q2
    if not chroma:
        use_p = strong & ap
        use_q = strong & aq
        s_p0 = torch.where(use_p, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                           s_p0)
        s_p1 = torch.where(use_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        s_p2 = torch.where(use_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        s_q0 = torch.where(use_q, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                           s_q0)
        s_q1 = torch.where(use_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        s_q2 = torch.where(use_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    bs4 = bs == 4

    def out(s, n, o):
        return torch.where(fil, torch.where(bs4, s, n), o)

    p_new = torch.stack([out(s_p0, n_p0, p0), out(s_p1, n_p1, p1),
                         out(s_p2, n_p2, p2), p3], dim=-1)
    q_new = torch.stack([out(s_q0, n_q0, q0), out(s_q1, n_q1, q1),
                         out(s_q2, n_q2, q2), q3], dim=-1)
    return p_new.to(p.dtype), q_new.to(q.dtype)


def _edge_v(mb, x, bs, tabs, chroma):
    """Filter the vertical edge at column ``x`` of (..., n, W) in place."""
    p = mb[..., [x - 1, x - 2, x - 3, x - 4]]
    q = mb[..., [x, x + 1, x + 2, x + 3]]
    p, q = _filter_lines(p, q, bs, *tabs, chroma)
    mb[..., [x - 1, x - 2, x - 3]] = p[..., :3]
    mb[..., [x, x + 1, x + 2]] = q[..., :3]


def _edge_h(mb, y, bs, tabs, chroma):
    """Filter the horizontal edge at row ``y`` of (..., H, W) in place."""
    p = mb[..., [y - 1, y - 2, y - 3, y - 4], :].transpose(-1, -2)
    q = mb[..., [y, y + 1, y + 2, y + 3], :].transpose(-1, -2)
    p, q = _filter_lines(p, q, bs, *tabs, chroma)
    mb[..., [y - 1, y - 2, y - 3], :] = p[..., :3].transpose(-1, -2)
    mb[..., [y, y + 1, y + 2], :] = q[..., :3].transpose(-1, -2)


def bs_grids(nr: int, nc: int, nnz_blk=None, mv=None, device="cpu"):
    """Per-line bS: (bs_v (R, C, 4, 16) for x = 0, 4, 8, 12 per luma
    line, bs_h (R, C, 3, 16) for y = 4, 8, 12 per luma column).  Intra
    when ``nnz_blk`` is None; P from ``nnz_blk`` (R, C, 4, 4) bool
    (raster [by][bx]) and ``mv`` (R, C, 2) quarter-pel otherwise."""
    if nnz_blk is None:
        bs_v = torch.full((nr, nc, 4, 16), 3, dtype=torch.int32, device=device)
        bs_v[:, :, 0] = 4
        bs_h = torch.full((nr, nc, 3, 16), 3, dtype=torch.int32, device=device)
    else:
        nz = nnz_blk.to(torch.int32)
        nz16y = nz.repeat_interleave(4, dim=2)               # (R, C, 16, 4)
        bs_v = torch.zeros((nr, nc, 4, 16), dtype=torch.int32,
                           device=nz.device)
        for bx in (1, 2, 3):
            bs_v[:, :, bx] = (nz16y[..., bx - 1] | nz16y[..., bx]) * 2
        left = torch.zeros_like(nz16y[..., 0])
        left[:, 1:] = nz16y[:, :-1, :, 3]
        mvd = torch.zeros((nr, nc), dtype=torch.bool, device=nz.device)
        mvd[:, 1:] = ((mv[:, 1:] - mv[:, :-1]).abs() >= 4).any(dim=-1)
        bs_v[:, :, 0] = torch.where((left | nz16y[..., 0]) > 0, 2,
                                    torch.where(mvd[:, :, None], 1, 0))
        nz16x = nz.repeat_interleave(4, dim=3)               # (R, C, 4, 16)
        bs_h = torch.stack([(nz16x[:, :, by - 1] | nz16x[:, :, by]) * 2
                            for by in (1, 2, 3)], dim=2).to(torch.int32)
    bs_v[:, 0, 0] = 0                                        # no left MB
    return bs_v, bs_h


def deblock_frame_plain(y, cb, cr, qp: int, nnz_blk=None, mv=None,
                        luma=None):
    """Plain PyTorch version of K8: a loop over MB columns, vectorized
    over MB rows and edge lines.  Same contract as :func:`deblock_frame`."""
    if luma is not None:
        from .cavlc_p_device import nnz_raster
        nnz_blk = nnz_raster(luma)
    tl, tc = _tables(qp)
    h, w = y.shape
    nr, nc = h // 16, w // 16
    bs_v, bs_h = bs_grids(nr, nc, nnz_blk, mv, y.device)
    yp = y.to(torch.int32).reshape(nr, 16, w)
    cp = [p.to(torch.int32).reshape(nr, 8, w // 2) for p in (cb, cr)]
    for c in range(nc):
        x0 = 16 * c
        for e in range(4):
            if c or e:
                _edge_v(yp, x0 + 4 * e, bs_v[:, c, e], tl, False)
        for p in cp:
            if c:
                _edge_v(p, x0 // 2, bs_v[:, c, 0, 0::2], tc, True)
            _edge_v(p, x0 // 2 + 4, bs_v[:, c, 2, 0::2], tc, True)
        own = yp[:, :, x0:x0 + 16]
        for e in range(3):
            _edge_h(own, 4 * (e + 1), bs_h[:, c, e], tl, False)
        for p in cp:
            _edge_h(p[:, :, x0 // 2:x0 // 2 + 8], 4, bs_h[:, c, 1, 0::2], tc,
                    True)
    u8 = lambda a, s: a.reshape(s).to(torch.uint8)
    return u8(yp, y.shape), u8(cp[0], cb.shape), u8(cp[1], cr.shape)


def deblock_frame(y, cb, cr, qp: int, nnz_blk=None, mv=None, luma=None,
                  qp_dev=None, out=None):
    """Loop-filter one frame's uint8 recon planes (MB-padded) at slice
    qp ``qp``: intra bS when ``nnz_blk`` and ``luma`` are None, P bS from
    ``mv`` (R, C, 2) int32 and either ``nnz_blk`` (R, C, 4, 4) bool or
    the P core's ``luma`` levels (R, C, 16, 16) int32, whose nonzero
    blocks are the coded ones.  Returns new filtered planes, or ``out``'s
    (three planes shaped as the input's, not the input's own) where given.

    CUDA tensors launch the kernel (one CUDA block per MB row: its
    threads work out the row's bS, then one warp walks its MBs with the
    samples in registers, luma and chroma on separate lanes; rows of up
    to 512 MBs); CPU tensors run the plain version.  ``qp_dev`` (CUDA
    only: one int32 on the card) makes the kernel take the slice qp, and
    its tables, from device memory.

    Planes stacked (S, H, W), with the flags and MVs stacked alike, filter
    S sessions' frames in one launch (the session the grid's second
    axis)."""
    from .h264_device import _check_planes, stack_sessions

    ns = _check_planes(y, cb, cr, sessions=True)
    if not 0 <= int(qp) <= 51:
        raise ValueError(f"qp {qp} outside 0..51")
    lead = tuple(y.shape[:-2])
    nr, nc = y.shape[-2] // 16, y.shape[-1] // 16
    if nnz_blk is not None and luma is not None:
        raise ValueError("pass nnz_blk or luma, not both")
    if nnz_blk is not None or luma is not None:
        if ((nnz_blk is not None
             and (tuple(nnz_blk.shape) != lead + (nr, nc, 4, 4)
                  or nnz_blk.dtype != torch.bool))
                or (luma is not None
                    and (tuple(luma.shape) != lead + (nr, nc, 16, 16)
                         or luma.dtype != torch.int32))
                or mv is None or tuple(mv.shape) != lead + (nr, nc, 2)
                or mv.dtype != torch.int32):
            raise ValueError("nnz_blk must be (R, C, 4, 4) bool (or luma "
                             "(R, C, 16, 16) int32) and mv (R, C, 2) int32")
    if qp_dev is not None and (qp_dev.dtype != torch.int32
                               or qp_dev.numel() != 1
                               or qp_dev.device != y.device):
        raise ValueError("qp_dev must be one int32 on the planes' device")
    if out is not None and any(
            o.shape != p.shape or o.dtype != torch.uint8 or o.device != p.device
            or not o.is_contiguous() or o.data_ptr() == p.data_ptr()
            for o, p in zip(out, (y, cb, cr))):
        raise ValueError("out must be three contiguous uint8 planes shaped "
                         "as the input's, on its device, not the input")
    if y.device.type == "cpu":
        if ns:
            at = lambda t, i: None if t is None else t[i]
            res = stack_sessions([deblock_frame_plain(
                y[i], cb[i], cr[i], int(qp), at(nnz_blk, i), at(mv, i),
                at(luma, i)) for i in range(ns)])
        else:
            res = deblock_frame_plain(y, cb, cr, int(qp), nnz_blk, mv, luma)
        if out is None:
            return res
        return tuple(o.copy_(r) for o, r in zip(out, res))
    outs = (list(out) if out is not None
            else [torch.empty_like(p) for p in (y, cb, cr)])
    for t in (y, cb, cr, *outs) + ((luma,) if luma is not None else ()):
        if t.data_ptr() % 16:
            raise ValueError("planes (and luma) must be 16-byte aligned")
    if nc > _MAX_NC:
        raise ValueError(f"{nc} MBs a row: the kernel takes at most {_MAX_NC}")
    tl, tc = _tables(int(qp))
    _cuda.launch("deblock", "deblock_launch",
                 [y, cb, cr, nnz_blk, mv, luma, qp_dev] + outs,
                 [nr, nc, tl[0], tl[1], *tl[2], tc[0], tc[1], *tc[2],
                  ns or 1], y.device)
    deblock_frame.launches += 1
    return tuple(outs)


deblock_frame.launches = 0
