"""NumPy models of the work split of 13s (the forced-skip row gate,
``csrc/spatial.cu`` ``force_skip_kernel``) and of K13 (the reference-row
scatter, ``csrc/damage.cu`` ``scatter_rows_kernel``), against the plain
versions and JAX's eager ``force_skip_rows`` and ``.at[rows].set``.

Both kernels store spans of bytes (a gated MB row of one tensor, a line
of one plane) as the 16-byte words that overlap them (``rowcopy.cuh``):
a word inside its span with a 16-byte aligned source is one 16-byte move,
any other word moves by 8-byte halves or bytes.  13s: a grid of (chunk,
MB row), the launcher cutting each present tensor's row into chunks of
at most ``SKIP_CHUNK`` words (more where a row would need more than
``MAX_CHUNKS``), a thread's words ``SKIP_NT`` apart, ``SKIP_U`` at once; a
kept row's CTAs return.  K13: a warp a unit, the units the frame's lines
and then the recon stack's, a lane every 32nd word, ``LINE_U`` at once; a
frame line stores where its MB row is in no worklist entry, a stack line
at its entry's row.  The models place every tensor at a chosen offset
from a 16-byte boundary in one byte array standing in for device memory,
walk the threads' words as the kernels do, and hold that every byte of
a span is written as often as the design says (once, or once for each
duplicate of a worklist row, with equal bytes) and no other byte at all.
The thread, chunk and unroll constants are read from the sources."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from docker_nvidia_glx_desktop_tpu.ops import damage_mask as j_dmg
from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg
from test_torch_k16a_k14d_order import cu_ints

S = cu_ints("spatial", ("SKIP_NT", "SKIP_U", "SKIP_CHUNK", "MAX_CHUNKS", "JOBS"))
D = cu_ints("damage", ("SCATTER_NT", "LINE_U"))

# the launcher's order of the gated tensors: key, elements an MB (int32,
# or bytes for mb_intra), and for the recon planes the bytes an MB row
ZERO = (("mv", 2), ("luma", 256), ("cb_dc", 4), ("cb_ac", 60), ("cr_dc", 4),
        ("cr_ac", 60), ("mb_intra", 1), ("i16_dc", 16), ("i16_ac", 240))
RECON = (("recon_y", 256), ("recon_cb", 64), ("recon_cr", 64))


# -- rowcopy.cuh: the words of a span --------------------------------------------

def span_slots(base: int, nbytes: int) -> int:
    x = base | nbytes | 16
    al = x & -x
    return (nbytes + 31 - al) // 16


def span_word(lo: int, nbytes: int, src, slot: int):
    """(word address, first byte, end byte, kind) of slot ``slot`` of the
    span at ``lo``, kind 16 for one 16-byte move, else the halves' kinds
    (8 or 1 per half, 0 for a half with no byte of the span)."""
    a = (lo & ~15) + 16 * slot
    b0 = max(lo - a, 0)
    b1 = 16 if lo + nbytes >= a + 16 else max(lo + nbytes - a, 0)
    s = None if src is None else src + (a - lo)
    if b0 == 0 and b1 == 16 and (s is None or s % 16 == 0):
        return a, b0, b1, (16,)
    kinds = []
    for h in (0, 8):
        if b0 <= h and b1 >= h + 8 and (s is None or s % 8 == 0):
            kinds.append(8)
        else:
            kinds.append(1 if max(b0, h) < min(b1, h + 8) else 0)
    return a, b0, b1, tuple(kinds)


class Memory:
    """One byte array standing in for device memory; ``place`` puts a
    tensor's bytes ``off`` bytes past the next 16-byte boundary."""

    def __init__(self):
        self.buf = np.zeros(0, np.uint8)

    def place(self, a: np.ndarray, off: int) -> int:
        start = -(-self.buf.size // 16) * 16 + off
        raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        self.buf = np.concatenate([self.buf, np.zeros(start - self.buf.size, np.uint8), raw,
                                   np.zeros(32, np.uint8)])
        return start

    def read(self, addr: int, like: np.ndarray) -> np.ndarray:
        n = like.size * like.itemsize
        return self.buf[addr:addr + n].copy().view(like.dtype).reshape(like.shape)


# -- 13s -----------------------------------------------------------------------

def gate_case(nr: int, nc: int, intra: bool, seed: int):
    r = np.random.default_rng(seed)
    out = {}
    for k, per in ZERO:
        if k in ("mb_intra", "i16_dc", "i16_ac") and not intra:
            continue
        shape = (nr, nc) + {"mv": (2,), "luma": (16, 16), "cb_ac": (4, 15), "cr_ac": (4, 15),
                            "i16_ac": (16, 15), "mb_intra": ()}.get(k, (per,))
        out[k] = (r.integers(0, 2, shape).astype(bool) if k == "mb_intra"
                  else r.integers(-60, 60, shape).astype(np.int32))
    planes = lambda: [r.integers(0, 256, s, dtype=np.uint8)
                      for s in ((16 * nr, 16 * nc), (8 * nr, 8 * nc), (8 * nr, 8 * nc))]
    out.update(zip((k for k, _ in RECON), planes()))
    return out, planes()


def chunk_table(jobs) -> list:
    """The launcher's chunks (tensor, first word, end word) of a row."""
    slots = [span_slots(d, b) for d, _, b in jobs]
    per_row, ck = sum(slots), S["SKIP_CHUNK"]
    cw = ck * -(-per_row // (ck * (S["MAX_CHUNKS"] - S["JOBS"])))
    table = [(t, s0, min(s0 + cw, n)) for t, n in enumerate(slots) for s0 in range(0, n, cw)]
    assert len(table) <= S["MAX_CHUNKS"]
    return table


def gate_model(out: dict, keep: np.ndarray, refs, offs: dict):
    """13s on the memory model: returns the gated tensors and the kinds
    of the words stored."""
    nr, nc = out["mv"].shape[:2]
    mem = Memory()
    addr = {k: mem.place(v, offs.get(k, 0)) for k, v in out.items()}
    ref_addr = [mem.place(p, offs.get("ref" + k[5:], 0)) for (k, _), p in zip(RECON, refs)]
    jobs = []                                  # (dst, src, bytes an MB row)
    for k, per in ZERO:
        if k in out:
            jobs.append((addr[k], None, nc * per * (1 if k == "mb_intra" else 4)))
    for (k, per), ra in zip(RECON, ref_addr):
        jobs.append((addr[k], ra, nc * per))
    writes = np.zeros(mem.buf.size, np.int32)
    kinds = {}
    nt, u = S["SKIP_NT"], S["SKIP_U"]
    for t, s0, s1 in chunk_table(jobs):          # the grid: (chunk, row)
        dst, src, nb = jobs[t]
        for r in range(nr):
            if keep[r]:
                continue                          # the CTA returns
            off = r * nb
            for thread in range(nt):
                for s in range(s0 + thread, s1, S["SKIP_CHUNK"]):
                    for k in range(u):
                        if s + k * nt >= s1:
                            continue
                        word = span_word(dst + off, nb, None if src is None else src + off,
                                         s + k * nt)
                        kinds[word[3]] = kinds.get(word[3], 0) + 1
                        a, b0, b1, _ = word
                        if b1 > b0:
                            if src is None:
                                mem.buf[a + b0:a + b1] = 0
                            else:
                                sa = src + (a - dst)
                                mem.buf[a + b0:a + b1] = mem.buf[sa + b0:sa + b1]
                            writes[a + b0:a + b1] += 1
    # every gated row's bytes once, nothing else
    want = np.zeros_like(writes)
    for dst, _, nb in jobs:
        for r in np.flatnonzero(~keep):
            want[dst + r * nb:dst + (r + 1) * nb] = 1
    assert np.array_equal(writes, want)
    return {k: mem.read(addr[k], v) for k, v in out.items()}, kinds


PATTERNS = {"r3": lambda r, nr: (r // 3) % 2 == 0, "alt": lambda r, nr: r % 2 == 0,
            "all_kept": lambda r, nr: True, "all_gated": lambda r, nr: False,
            "first": lambda r, nr: r != 0, "last": lambda r, nr: r != nr - 1}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("nr,nc,intra", [(6, 3, False), (5, 1, True), (9, 4, True)])
def test_the_gate_model_equals_plain_and_jax(pattern, nr, nc, intra):
    out, refs = gate_case(nr, nc, intra, seed=nr * 10 + nc)
    keep = np.array([PATTERNS[pattern](r, nr) for r in range(nr)])
    got, kinds = gate_model(out, keep, refs, {})
    want = dmg.force_skip_rows_plain({k: torch.from_numpy(v.copy()) for k, v in out.items()},
                                     torch.from_numpy(keep), *map(torch.from_numpy, refs))
    jax_want = j_dmg.force_skip_rows({k: jnp.asarray(v) for k, v in out.items()}, keep, *refs)
    for k in out:
        assert np.array_equal(got[k], want[k].numpy()), k
        assert np.array_equal(got[k], np.asarray(jax_want[k])), k
    if pattern == "all_kept":
        assert not kinds                     # nothing stored
    if nc % 2 == 0 and not intra:            # every span on 16-byte boundaries
        assert set(kinds) <= {(16,)}


@pytest.mark.parametrize("offs", [
    {"mv": 4, "luma": 12, "cb_ac": 8, "mb_intra": 3, "i16_ac": 8, "recon_y": 5, "refy": 9,
     "recon_cb": 8, "refcb": 8, "recon_cr": 1, "refcr": 15},
    {"mv": 8, "mb_intra": 15, "i16_dc": 4, "recon_cr": 4, "refcr": 12, "refy": 4}])
@pytest.mark.parametrize("nc", [1, 3, 81])
def test_the_gate_takes_tensors_at_any_offset(offs, nc):
    nr = 4 if nc == 81 else 7
    out, refs = gate_case(nr, nc, True, seed=nc)
    keep = np.array([(r // 3) % 2 == 0 for r in range(nr)])
    got, kinds = gate_model(out, keep, refs, offs)
    want = dmg.force_skip_rows_plain({k: torch.from_numpy(v.copy()) for k, v in out.items()},
                                     torch.from_numpy(keep), *map(torch.from_numpy, refs))
    for k in out:
        assert np.array_equal(got[k], want[k].numpy()), k
    assert any(1 in k for k in kinds) and any(8 in k for k in kinds)


def test_mv_rows_of_an_odd_width_store_their_heads_and_tails_in_halves():
    """mv's rows are 8 nc bytes: at nc odd every other row starts 8 bytes
    into a word, and its head and tail are 8-byte halves, never bytes."""
    nr, nc = 4, 81
    mv = np.arange(nr * nc * 2, dtype=np.int32).reshape(nr, nc, 2)
    base = 0
    kinds = set()
    for r in range(nr):
        lo = base + r * nc * 8
        for s in range(span_slots(base, nc * 8)):
            kinds.add(span_word(lo, nc * 8, None, s)[3])
    assert kinds <= {(16,), (0, 8), (8, 0), (0, 0)} and (0, 8) in kinds and (8, 0) in kinds
    assert mv.nbytes == nr * nc * 8


@pytest.mark.parametrize("nbytes", [1, 3, 8, 24, 60, 81, 120, 648, 960, 3840])
def test_the_slots_cover_every_span_and_no_more(nbytes):
    """``span_slots`` is the most words any span of the tensor overlaps:
    every span fits, and some span needs them all."""
    for base in range(16):
        need = [len({(base + k * nbytes + j) // 16 for j in range(nbytes)}) for k in range(16)]
        assert max(need) == span_slots(base, nbytes), base


@pytest.mark.parametrize("nc", [1, 120, 240, 480, 1000])
def test_the_chunk_table_fits_and_covers_every_row_word_once(nc):
    """Every tensor's row words fall in exactly one chunk, a chunk holds
    at most the words its CTA walks, and a row of any width fits in
    ``MAX_CHUNKS`` chunks (wide rows take longer chunks, walked in
    ``SKIP_CHUNK`` steps)."""
    jobs = [(0, None, nc * per * (1 if k == "mb_intra" else 4)) for k, per in ZERO] + \
        [(0, 0, nc * per) for _, per in RECON]
    table = chunk_table(jobs)
    for t, (_, _, nb) in enumerate(jobs):
        spans = sorted((s0, s1) for tt, s0, s1 in table if tt == t)
        assert spans[0][0] == 0 and spans[-1][1] == span_slots(0, nb)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if nc <= 120:                            # 1080p and narrower: one step a chunk
        assert max(s1 - s0 for _, s0, s1 in table) <= S["SKIP_CHUNK"]


# -- K13 -----------------------------------------------------------------------

def scatter_case(nr: int, nc: int, rows, seed: int):
    r = np.random.default_rng(seed)
    shapes = ((16 * nr, 16 * nc), (8 * nr, 8 * nc), (8 * nr, 8 * nc))
    refs = [r.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    rows = np.asarray(rows, np.int32)
    first = [int(np.flatnonzero(rows == x)[0]) for x in rows]
    rec = []
    for n, (_, w) in zip((16, 8, 8), shapes):
        own = r.integers(0, 256, (rows.size, n, w), dtype=np.uint8)[first]
        rec.append(own.reshape(rows.size * n, w))
    return refs, rec, rows


def scatter_model(refs, rec, rows, offs: dict):
    """K13 on the memory model: the new planes and the word kinds."""
    nr, W = refs[0].shape[0] // 16, refs[0].shape[1]
    nb = rows.size
    mem = Memory()
    keys = ("y", "cb", "cr")
    ref_a = [mem.place(p, offs.get("r" + k, 0)) for k, p in zip(keys, refs)]
    rec_a = [mem.place(p, offs.get("e" + k, 0)) for k, p in zip(keys, rec)]
    out_a = [mem.place(np.zeros_like(p), offs.get("o" + k, 0)) for k, p in zip(keys, refs)]
    bytes_, shift = (W, W // 2, W // 2), (4, 3, 3)
    slots = [span_slots(a, b) for a, b in zip(out_a, bytes_)]
    writes = np.zeros(mem.buf.size, np.int32)
    kinds = {}
    for u in range(32 * (nr + nb)):              # a warp a unit
        stack = u >= 32 * nr
        n, g = (nb, u - 32 * nr) if stack else (nr, u)
        p = 0 if g < 16 * n else (1 if g < 24 * n else 2)
        ln = g - (0, 16 * n, 24 * n)[p]
        m, b = ln >> shift[p], bytes_[p]
        if stack:
            r = int(rows[m])
            if not 0 <= r < nr:
                continue
            src = rec_a[p] + ln * b
            dst = out_a[p] + ((r << shift[p]) + (ln & ((1 << shift[p]) - 1))) * b
        else:
            # the ballot: the first 32 entries held, then 32 a step
            hit = any(int(x) == m for x in rows[:32])
            for i0 in range(32, nb, 32):
                hit = hit or any(int(x) == m for x in rows[i0:i0 + 32])
            if hit:
                continue
            src, dst = ref_a[p] + ln * b, out_a[p] + ln * b
        for s0 in range(0, slots[p], 32 * D["LINE_U"]):
            for lane in range(32):
                for k in range(D["LINE_U"]):
                    s = s0 + lane + 32 * k
                    if s >= slots[p]:
                        continue
                    a, b0, b1, kind = span_word(dst, b, src, s)
                    kinds[kind] = kinds.get(kind, 0) + 1
                    if b1 > b0:
                        sa = src + (a - dst)
                        mem.buf[a + b0:a + b1] = mem.buf[sa + b0:sa + b1]
                        writes[a + b0:a + b1] += 1
    # an undamaged row's lines once, a damaged row's once for each entry
    want = np.zeros_like(writes)
    for p, (a, b) in enumerate(zip(out_a, bytes_)):
        per_row = b << shift[p]
        for r in range(nr):
            want[a + r * per_row:a + (r + 1) * per_row] = max(1, int((rows == r).sum()))
    assert np.array_equal(writes, want)
    return [mem.read(a, p) for a, p in zip(out_a, refs)], kinds


def scatter_jax(refs, rec, rows):
    """JAX's ``row_core`` scatter: ``.at[rows].set`` of each plane."""
    h, w = refs[0].shape
    return [jnp.asarray(p).reshape(h // 16, n, -1).at[rows].set(
        jnp.asarray(q).reshape(rows.size, n, -1)).reshape(p.shape)
        for p, q, n in zip(refs, rec, (16, 8, 8))]


@pytest.mark.parametrize("rows", [[0], [4], [1, 0, 0], [4, 0, 2, 2], [0, 1, 2, 3, 4],
                                  [3, 1, 1, 1, 1, 1, 1, 1]])
@pytest.mark.parametrize("nc", [4, 3, 1])
def test_the_scatter_model_equals_plain_and_jax(rows, nc):
    nr = 5
    refs, rec, rows = scatter_case(nr, nc, rows, seed=len(rows) + nc)
    got, kinds = scatter_model(refs, rec, rows, {})
    want = dmg.scatter_rows_plain(*map(torch.from_numpy, refs), *map(torch.from_numpy, rec),
                                  torch.from_numpy(rows))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    if nc == 4:                                  # one width held against JAX too
        for g, j in zip(got, scatter_jax(refs, rec, rows)):
            assert np.array_equal(g, np.asarray(j))
    if nc % 2:                                   # W = 16 odd: chroma lines end in halves
        assert (0, 8) in kinds or (8, 0) in kinds
        assert not any(1 in k for k in kinds)
    else:
        assert set(kinds) <= {(16,)}


@pytest.mark.parametrize("offs", [{"ry": 4, "rcb": 8, "ey": 12, "ecr": 3, "ocb": 8},
                                  {"rcr": 1, "ecb": 7, "ey": 2, "ry": 15, "ecr": 8, "oy": 4}])
@pytest.mark.parametrize("nc", [3, 81])
def test_the_scatter_takes_planes_at_any_offset(offs, nc):
    nr = 3 if nc == 81 else 6
    refs, rec, rows = scatter_case(nr, nc, [nr - 1, 0, 1, 1], seed=nc)
    got, _ = scatter_model(refs, rec, rows, offs)
    want = dmg.scatter_rows_plain(*map(torch.from_numpy, refs), *map(torch.from_numpy, rec),
                                  torch.from_numpy(rows))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


def test_a_worklist_past_32_entries_takes_the_ballot_steps():
    """More than 32 entries: a frame line's row is found in a later step
    of the ballot, and duplicates write their equal lines again."""
    nr = 40
    rows = list(range(39, -1, -1)) + [5] * 24
    refs, rec, rows = scatter_case(nr, 1, rows, seed=3)
    got, _ = scatter_model(refs, rec, rows, {})
    want = dmg.scatter_rows_plain(*map(torch.from_numpy, refs), *map(torch.from_numpy, rec),
                                  torch.from_numpy(rows))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
