"""K10's segment schedule (``csrc/levelpack.cu`` ``seg_kernel``) as a
NumPy model, held equal to the plain version (``pack_slots_plain``, which
``tests/test_torch_cabac.py`` holds equal to the reference) on the header
and the payload: each MB's bits from a ballot of each 32 slots' nonzeros
(the slots plus 15 x the popcount), the overflow vote, segments of SEGL
MBs of a row placed by a look-back over random AGG / INCL states, each
row from a word boundary, each nonzero slot's 16-bit code ORed into its
segment's window at the lanes-before-it position, and the windows stored
over a buffer of garbage in a random order: a segment's own words and its
last word, then it is DONE; its first word, where it holds earlier bits,
ORed once its predecessor is DONE.  The crafted slots are
``tests/level_slots.py``'s, which the card's k10k11i phase uses too."""

import pathlib
import re

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu_torch.ops import level_pack
from tests.level_slots import K10_KINDS, k10_slots

_CU = (pathlib.Path(level_pack.__file__).parent.parent / "csrc"
       / "levelpack.cu").read_text()
SEGL = int(re.search(r"constexpr int SEGL = (\d+);", _CU).group(1))
MAX_SLOTS = int(re.search(r"constexpr int MAX_SLOTS = (\d+);", _CU).group(1))
WIN = int(re.search(r"constexpr int WIN = (\d+);", _CU).group(1))
KEYS = {"intra": level_pack.INTRA_KEYS, "p": level_pack.P_KEYS}
META = level_pack.META_WORDS


def code_parts(pos, code):
    """16-bit codes at bit positions ``pos`` of MSB-first uint32 words, as
    the kernel's lanes OR them: (word, value) pairs, one word or a high
    and a low part."""
    w, sh = pos >> 5, pos & 31
    one = sh <= 16
    two = ~one
    return (np.concatenate([w[one], w[two], w[two] + 1]),
            np.concatenate([(code[one] << (16 - sh[one])) & 0xFFFFFFFF,
                            code[two] >> (sh[two] - 16),
                            (code[two] << (48 - sh[two])) & 0xFFFFFFFF]))


def k10_model(slots3: np.ndarray, segl: int, win: int, seed: int) -> np.ndarray:
    """The transport the kernel's schedule writes over a buffer of
    garbage (uint32, ``buffer_words`` long), a segment's words built
    ``win`` words at a time."""
    rng = np.random.default_rng(seed)
    nr, nc, s = slots3.shape
    v = slots3.astype(np.int64)
    nch = -(-s // 32)
    lanes = np.zeros((nr, nc, nch * 32), np.int64)
    lanes[..., :s] = v
    lanes = lanes.reshape(nr, nc, nch, 32)
    nz = lanes != 0
    valid = np.minimum(32, s - 32 * np.arange(nch))
    chunk_bits = valid + 15 * nz.sum(-1)                 # each ballot's count
    mb_bits = chunk_bits.sum(-1)
    flag = int(((v > 16383) | (v < -16384)).any())       # the warps' vote

    nseg = -(-nc // segl)
    seg_of = np.arange(nc) // segl
    seg_bits = np.zeros((nr, nseg), np.int64)
    np.add.at(seg_bits, (slice(None), seg_of), mb_bits)
    mb_off = np.zeros((nr, nc), np.int64)                # warp 0's scan
    for sg in range(nseg):
        cols = slice(sg * segl, min(nc, (sg + 1) * segl))
        mb_off[:, cols] = np.cumsum(mb_bits[:, cols], 1) - mb_bits[:, cols]
    excl = np.zeros((nr, nseg), np.int64)                # the look-back
    for r in range(nr):
        state = rng.integers(1, 3, nseg)                 # 1 AGG, 2 INCL
        for sg in range(nseg):
            e = 0
            for q in range(sg - 1, -1, -1):
                if state[q] == 2:
                    e += seg_bits[r, :q + 1].sum()
                    break
                e += seg_bits[r, q]
            excl[r, sg] = e
    row_bits = excl[:, -1] + seg_bits[:, -1]
    row_words = (row_bits + 31) >> 5
    row_w = np.concatenate([[0], np.cumsum(row_words)])

    n = level_pack.buffer_words(nr, nc, s)
    out = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    out[:META] = (1, flag, row_w[-1], nr, s, 0, 0, 0)
    out[META:META + nr] = row_words

    # each segment's words, window by window (a part outside the window
    # is dropped, as the kernel's lanes drop it), all segments back to back
    lead = excl & 31
    nwords = (lead + seg_bits + 31) >> 5
    wbase = np.concatenate([[0], np.cumsum(nwords.ravel())])[:-1].reshape(nr, nseg)
    segw = np.zeros(int(nwords.sum()), np.int64)
    chunk_off = np.cumsum(chunk_bits, -1) - chunk_bits
    before = np.cumsum(nz, -1) - nz                      # nonzero lanes before a lane
    pos = (chunk_off[..., None] + np.arange(32) + 15 * before
           + (mb_off + lead[:, seg_of])[..., None, None])  # in the segment's words
    seg = np.broadcast_to((np.arange(nr)[:, None] * nseg + seg_of)[..., None, None], pos.shape)
    code = 0x8000 | (lanes & 0x7FFF)
    for lo in range(0, int(nwords.max()), win):
        window = np.zeros((nr * nseg, win), np.int64)
        p = pos[nz] - 32 * lo
        w, val = code_parts(p, code[nz])
        sg = np.concatenate([seg[nz][(p & 31) <= 16], seg[nz][(p & 31) > 16],
                             seg[nz][(p & 31) > 16]])
        keep = (w >= 0) & (w < win)
        np.bitwise_or.at(window, (sg[keep], w[keep]), val[keep])
        for i in range(nr * nseg):
            n_here = min(win, int(nwords.ravel()[i]) - lo)
            if n_here > 0:
                b = int(wbase.ravel()[i]) + lo
                segw[b:b + n_here] = window[i, :n_here]

    # the stores, in a random order that keeps the edge-word rule
    done = np.zeros((nr, nseg), bool)
    ready = [(0, r, sg) for r in range(nr) for sg in range(nseg)]
    waiting = {}
    while ready:
        i = int(rng.integers(len(ready)))
        ready[i], ready[-1] = ready[-1], ready[i]
        kind, r, sg = ready.pop()
        w0 = META + nr + row_w[r] + (excl[r, sg] >> 5)
        words = segw[wbase[r, sg]:wbase[r, sg] + nwords[r, sg]].astype(np.uint64)
        shared = int(lead[r, sg] != 0)
        if kind == 0:
            out[w0 + shared:w0 + len(words)] = words[shared:]
            if shared and len(words) == 1:               # DONE only after its OR
                pass
            else:
                done[r, sg] = True
            if shared:
                ev = (1, r, sg)
                if sg == 0 or done[r, sg - 1]:
                    ready.append(ev)
                else:
                    waiting[(r, sg - 1)] = ev
        else:
            out[w0] |= words[0]
            done[r, sg] = True
        if done[r, sg] and (r, sg) in waiting:
            ready.append(waiting.pop((r, sg)))
    assert not waiting and done.all()
    return out.astype(np.uint32)


def _held(slots3, segl, win, seed):
    want = level_pack.pack_slots_plain(torch.from_numpy(slots3)).numpy().view(np.uint32)
    got = k10_model(slots3, segl, win, seed)
    n = META + slots3.shape[0] + int(want[2])
    np.testing.assert_array_equal(got[:n], want[:n])
    return int(got[1])


@pytest.mark.parametrize("segl,win", [(SEGL, WIN), (3, 5)])
@pytest.mark.parametrize("nr,nc", [(3, 13), (2, 8), (1, 7)])
@pytest.mark.parametrize("kind", K10_KINDS)
@pytest.mark.parametrize("keys", ["intra", "p"])
def test_segment_schedule_equals_the_plain_version(keys, kind, nr, nc, segl, win):
    """Segments of SEGL MBs in windows of WIN words (a dense segment
    takes several), and of 3 MBs in windows of 5 words (codes across
    every window's edges)."""
    s = sum(n for _, n, _ in KEYS[keys])
    assert s <= MAX_SLOTS
    slots3 = k10_slots(kind, nr, nc, s, seed=nr * 100 + nc)
    assert _held(slots3, segl, win, seed=segl) == int(kind == "over")


@pytest.mark.parametrize("kind", ["rows", "over"])
@pytest.mark.parametrize("keys", ["intra", "p"])
def test_segment_schedule_on_a_1919x1079_frame(keys, kind):
    """68 x 120 MBs (1919x1079 padded): 15 segments a row, rows of
    all-nonzero slots (the window full) between all-zero rows."""
    s = sum(n for _, n, _ in KEYS[keys])
    slots3 = k10_slots(kind, 68, 120, s, seed=5)
    assert _held(slots3, SEGL, WIN, seed=1) == int(kind == "over")


def test_model_catches_a_misplaced_code():
    """The model is sensitive: one nonzero slot's code a bit late is a
    different payload."""
    slots3 = k10_slots("sparse", 2, 9, 384, seed=2)
    want = level_pack.pack_slots_plain(torch.from_numpy(slots3)).numpy().view(np.uint32)
    moved = slots3.copy()
    at = tuple(np.argwhere(moved != 0)[0])
    moved[at], moved[at[:2] + (at[2] + 1,)] = 0, moved[at]
    got = k10_model(moved, SEGL, WIN, seed=0)
    n = META + 2 + int(want[2])
    assert not np.array_equal(got[:n], want[:n])
