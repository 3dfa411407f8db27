"""The H.264 session steps at the second test geometry (96x64, two
sessions; the reference's managers bucket such a geometry apart), against
the reference's steps on a (1, 1) mesh over two GOPs, and the plain
batched versions against the steps.  The helpers and the first
geometry are ``test_torch_batch_h264.py``'s."""

import numpy as np
import torch

from docker_nvidia_glx_desktop_tpu_torch.parallel import batch as t_batch
from test_torch_batch_h264 import GEOMS, QP, mesh, p_slots, planes, two_gops  # noqa: F401


def test_intra_and_p_steps_equal_the_reference_over_two_gops(mesh):  # noqa: F811
    two_gops(GEOMS[1], mesh)


def test_plain_versions_equal_the_steps_session_by_session():
    h, w, s = GEOMS[1]
    nr, nc = h // 16, w // 16
    y, cb, cr = (torch.from_numpy(a) for a in planes(s, h, w, 0))
    step, rows = t_batch.h264_batch_encode_step(h, w, qp=QP, with_recon=True,
                                                device="cpu")
    hv, hl = step.slots[1]
    got = step(y, cb, cr, idr_parity=1)
    want = t_batch.h264_intra_batch_plain(y, cb, cr, hv, hl, QP,
                                          with_recon=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y2, cb2, cr2 = (torch.from_numpy(a) for a in planes(s, h, w, 1))
    phv, phl = (torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                 else a) for a in p_slots(nr, nc, 1))
    for deblock in (False, True):
        p, _ = t_batch.h264_p_batch_step(h, w, qp=QP, deblock=deblock,
                                         device="cpu")
        got = p(y2, cb2, cr2, *want[1:], phv, phl)
        plain = t_batch.h264_p_batch_plain(y2, cb2, cr2, *want[1:], phv,
                                           phl, QP, deblock=deblock)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
