"""NumPy models of two schedules of the port's H100 kernels, held equal to
their plain versions.

- The I16-in-P passes' gate (``csrc/inter.cu`` ``i16_merge_kernel``): a
  block a segment of MPB MBs of a stack row, a warp an MB; a wanting MB
  finds the last MB to its left that does not want by ballots over the
  row's ``want`` bytes, 32 at a time, and is kept at the even positions
  of its run.  Held equal to the port's plain run-parity gate
  (``h264_inter._run_parity_gate``) on crafted rows; a schedule that
  scans only its own segment is caught.  ``i16_passes_plain``, the card
  phase's reference for the passes on crafted scores, is held equal to
  the plain P core with I16-in-P.  The crafted rows are
  ``tests/i16_wants.py``'s, which the card's i16halo phase uses too.
- The halo pad 15e (``csrc/spatial.cu`` ``halo_pad_kernel``): one launch
  flat over the three planes' 16-byte output words, a word inside one
  padded row with every column inside the frame copied from five aligned
  32-bit source words by a funnel shift, every other word gathered byte
  by byte from the aligned words that hold them, a plane's last word
  storing only its bytes.  Held equal to ``spatial_halo_pad_plain`` at
  nx 1, 2 and 4, halo on and off, 1080p and 4K, with sources at byte
  offsets off a 16-byte boundary and the wrapper's buffer layout (the gap
  after a plane's last byte untouched)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu_torch.ops import aq, h264_inter
from docker_nvidia_glx_desktop_tpu_torch.ops.h264_device import (
    _level_bits_est, fma32)
from docker_nvidia_glx_desktop_tpu_torch.parallel import batch
from tests.i16_wants import WANT_KINDS, crafted_want

_CSRC = pathlib.Path(h264_inter.__file__).parent.parent / "csrc"
_INTER = (_CSRC / "inter.cu").read_text()
MPB = int(re.search(r"constexpr int NT = (\d+);", _INTER).group(1)) // 32
PAD = int(re.search(r"constexpr int PAD = (\d+);",
                    (_CSRC / "spatial.cu").read_text()).group(1))


# --- the I16-in-P gate -----------------------------------------------------

def gate_model(want: np.ndarray, segment_only: bool = False) -> np.ndarray:
    """The merge launch's gate over a (b, C) stack of want bytes: a block
    a segment of MPB MBs, a warp an MB; ``segment_only`` stops the scan at
    the segment's first MB (a wrong schedule the test must catch)."""
    nb, nc = want.shape
    keep = np.zeros_like(want)
    for r in range(nb):
        for seg in range(-(-nc // MPB)):
            for c in range(seg * MPB, min(nc, seg * MPB + MPB)):
                if not want[r, c]:
                    continue
                stop = seg * MPB - 1 if segment_only else -1
                last, e = None, c - 1
                while last is None:
                    p = e - np.arange(32)
                    vote = (p <= stop) | ~want[r, np.maximum(p, 0)]
                    if vote.any():
                        last = e - int(np.argmax(vote))      # __ffs - 1
                    e -= 32
                keep[r, c] = (c - last - 1) % 2 == 0
    return keep


@pytest.mark.parametrize("nc", [1, 7, 9, 120, 240])
@pytest.mark.parametrize("kind", WANT_KINDS)
def test_gate_schedule_equals_the_plain_gate(kind, nc):
    want = crafted_want(kind, 4, nc, seed=nc, seg=MPB)
    keep = gate_model(want)
    plain = h264_inter._run_parity_gate(torch.from_numpy(want)).numpy()
    np.testing.assert_array_equal(keep, plain)
    # a kept MB's left neighbour is never kept: the merge launch rewrites
    # no recon column that a kept candidate reads
    assert not (keep[:, 1:] & keep[:, :-1]).any()


def test_gate_schedule_over_a_worklist_with_duplicate_rows():
    frame = np.concatenate([crafted_want(k, 2, 120, seed=i, seg=MPB)
                            for i, k in enumerate(WANT_KINDS)])
    rows = np.array([5, 0, 0, 5, 13, 7, 13, 2, 2], np.int64)
    keep = gate_model(frame[rows])
    plain = h264_inter._run_parity_gate(torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(keep, plain[rows])


def test_a_segment_local_scan_is_caught():
    want = crafted_want("edges", 2, 120, seed=0, seg=MPB)
    plain = h264_inter._run_parity_gate(torch.from_numpy(want)).numpy()
    assert (gate_model(want, segment_only=True) != plain).any()


def _p_score(res, tune, qp, qp_map, cur, rows=None):
    """The inter score pass 1 leaves, from its outputs: a zero-MV MB with
    no nonzero level was forced to P_Skip (SSD + lam), every other MB
    scores SSD + lam * (bits + 12)."""
    nr, nc = res["mv"].shape[:2]
    fr = torch.arange(nr) if rows is None else rows.long()

    def mbs(p, k, lines):
        p = p.to(torch.int32)
        if lines:
            p = p.reshape(-1, k, p.shape[-1])[fr].reshape(nr * k, -1)
        return p.reshape(nr, k, nc, k).permute(0, 2, 1, 3)

    d = sum(h264_inter._mb_ssd(mbs(res[f"recon_{k}"], n, False), mbs(c, n, True))
            for k, n, c in (("y", 16, cur[0]), ("cb", 8, cur[1]),
                            ("cr", 8, cur[2])))
    lv = {k: res[k] for k in ("luma", "cb_ac", "cb_dc", "cr_ac", "cr_dc")}
    bits = (_level_bits_est(lv["luma"], (2, 3))
            + _level_bits_est(lv["cb_ac"], (2, 3)) + _level_bits_est(lv["cb_dc"], (2,))
            + _level_bits_est(lv["cr_ac"], (2, 3))
            + _level_bits_est(lv["cr_dc"], (2,))).float()
    qi = (qp_map.long() if tune == "hq"
          else torch.full((nr, nc), qp, dtype=torch.long))
    lam = torch.as_tensor(aq.lam_tables(tune)[0])[qi]
    zero = (res["mv"] == 0).all(-1)
    for v in lv.values():
        zero &= (v == 0).reshape(nr, nc, -1).all(-1)
    return torch.where(zero, d + lam, fma32(lam, bits + 12, d))


@pytest.mark.parametrize("worklist", [False, True])
@pytest.mark.parametrize("tune", ["hq_noaq", "hq"])
def test_i16_passes_plain_equals_the_plain_core(tune, worklist):
    rng = np.random.default_rng(18)
    h, w = 64, 160
    cur = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    cur[0][:, :64] = 100 + cur[0][:, :64] % 4              # flat: intra wins
    ref = [torch.roll(c, (1, 3), (0, 1)).contiguous() for c in cur]
    rows = torch.tensor([3, 0, 0, 2, 3], dtype=torch.int32) if worklist else None
    nb = 4 if rows is None else 5
    qmap = torch.from_numpy(rng.integers(14, 40, (nb, w // 16)).astype(np.int32))
    qm = qmap if tune == "hq" else None
    if worklist:
        core = lambda pi: h264_inter.encode_p_frame_rows_plain(
            *cur, *ref, rows, 26, tune, qm, pi)
    else:
        core = lambda pi: h264_inter.encode_p_frame_plain(*cur, *ref, 26, tune, qm, pi)
    pass1, whole = core(False), core(True)
    pass1.pop("qp_map", None)
    got = h264_inter.i16_passes_plain(
        *cur, pass1, _p_score(pass1, tune, 26, qmap, cur, rows), tune, 26, qm, rows)
    assert int(whole["mb_intra"].sum()) > 0
    for k, v in got.items():
        assert torch.equal(v, whole[k]), k


# --- the halo pad ----------------------------------------------------------

def pad_layout(h: int, w: int, nx: int):
    """The wrapper's one buffer: each plane's (h, w) source, its padded
    shape and its 16-byte aligned start."""
    out, start = [], 0
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        shape = (nx, ph // nx + 2 * PAD, pw + 2 * PAD)
        out.append(((ph, pw), shape, start))
        start += -(-int(np.prod(shape)) // 16) * 16
    return out, start


def halo_model(mem: np.ndarray, offs, h: int, w: int, nx: int,
               halo: bool) -> np.ndarray:
    """The kernel's words over a buffer of garbage: ``mem`` holds the three
    source planes at byte offsets ``offs`` (any alignment)."""
    layout, size = pad_layout(h, w, nx)
    out = np.full(size, 0xA5, np.uint8)
    words = np.zeros(-(-mem.size // 4) + 2, np.uint32)
    words.view(np.uint8)[:mem.size] = mem
    w64 = words.astype(np.uint64)
    for ((sh_, sw), (_, ph, pw), start), off in zip(layout, offs):
        hl, per = sh_ // nx, ph * pw
        nbytes = nx * per
        b0 = np.arange(-(-nbytes // 16), dtype=np.int64) * 16
        n = np.minimum(16, nbytes - b0)

        def where(b):
            s = b // per
            u = (b - s * per) // pw
            return s, u, b - s * per - u * pw

        def src_row(s, u):
            lo = np.zeros_like(s) if halo else s * hl
            hi = np.full_like(s, sh_ - 1) if halo else s * hl + hl - 1
            return np.clip(s * hl - PAD + u, lo, hi)

        s, u, v = where(b0)
        fast = (n == 16) & (v >= PAD) & (v + 16 <= PAD + sw)
        # fast words: five aligned words funnel-shifted by the byte offset
        a = off + src_row(s, u)[fast] * sw + v[fast] - PAD
        q, shift = a >> 2, ((a & 3) * 8).astype(np.uint64)
        fw = np.stack([((w64[q + i + 1] << np.uint64(32) | w64[q + i]) >> shift)
                       & np.uint64(0xFFFFFFFF) for i in range(4)], axis=1)
        dst = start + b0[fast][:, None] + np.arange(16)
        out[dst] = fw.astype(np.uint32).view(np.uint8).reshape(-1, 16)
        # every other word: each byte from the aligned word that holds it
        bs = b0[~fast][:, None] + np.arange(16)
        live = np.arange(16) < n[~fast][:, None]
        bs = bs[live]
        s, u, v = where(bs)
        a = off + src_row(s, u) * sw + np.clip(v - PAD, 0, sw - 1)
        out[start + bs] = (words[a >> 2] >> ((a & 3) * 8).astype(np.uint32)) & 255
    return out


HALO_SHAPES = {"1080p": (1088, 1920), "4k": (2176, 3840)}


@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("nx", [1, 2, 4])
@pytest.mark.parametrize("size", ["1080p", "4k"])
def test_halo_words_equal_the_plain_pad(size, nx, halo):
    h, w = HALO_SHAPES[size]
    _check_halo(h, w, nx, halo, (0, 0, 0), seed=nx + 7 * halo)


def test_halo_planes_end_inside_a_word():
    # the cases above include planes whose last word is partial
    tails = {(size, nx): [int(np.prod(s)) % 16 for _, s, _ in pad_layout(*hw, nx)[0]]
             for size, hw in HALO_SHAPES.items() for nx in (1, 2, 4)}
    assert tails[("1080p", 2)][0] and tails[("4k", 1)][0] and tails[("4k", 2)][0]


@pytest.mark.parametrize("offs", [(1, 2, 3), (4, 4, 4), (13, 7, 8)])
def test_halo_words_from_sources_off_a_16_byte_boundary(offs):
    _check_halo(1088, 1920, 2, True, offs, seed=sum(offs))


def _check_halo(h, w, nx, halo, offs, seed):
    rng = np.random.default_rng(seed)
    sizes = (h * w, h * w // 4, h * w // 4)
    mem, at = [], []
    for n, o in zip(sizes, offs):
        start = sum(len(m) for m in mem) + o
        at.append(start)
        mem += [rng.integers(0, 256, o, dtype=np.uint8),
                rng.integers(0, 256, n, dtype=np.uint8)]
    mem = np.concatenate(mem)
    got = halo_model(mem, at, h, w, nx, halo)
    planes = [torch.from_numpy(mem[a:a + n].reshape(s)) for a, n, s in
              zip(at, sizes, ((h, w), (h // 2, w // 2), (h // 2, w // 2)))]
    want = batch.spatial_halo_pad_plain(*planes, nx, halo)
    layout, size = pad_layout(h, w, nx)
    covered = np.zeros(size, bool)
    for (_, shape, start), p in zip(layout, want):
        n = int(np.prod(shape))
        np.testing.assert_array_equal(got[start:start + n].reshape(shape), p.numpy())
        covered[start:start + n] = True
    assert (got[~covered] == 0xA5).all()       # tail words store only their bytes
