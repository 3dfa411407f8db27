"""NumPy models of the work split of K16b (the JPEG symbol histograms,
``csrc/jpeg.cu`` ``analyze_kernel``) and of K14a/K14r (the tune=hq qp
plane, ``csrc/aq.cu`` ``qp_plane_kernel``), against the plain versions.

K16b: a warp a block, lane l holding zigzag positions l and l + 32; the
symbols from the block's 64-bit nonzero mask (the run since the previous
nonzero by the highest set bit below it, the ZRLs, EOB where bit 63 is
clear); a grid of about ``HIST_CTAS_PER_SM`` CTAs an SM, a CTA a span of
a session's MCUs and a warp a part of it, the DC chains carried in
registers and read from memory at a warp's first MCU, reset at each
strip's first MCU; DC sizes counted by lane (a size past 16 matches no
lane below 17: dropped, as the reference's scatter drops it), EOBs and
ZRLs in registers, an AC symbol a shared add, the CTA's nonzero bins into
the session's accumulator, the last CTA to arrive taking the sums out and
zeroing them.  K14a: a warp two MBs of a row, lane
2 row + m a 16-byte row word of MB m, the sums by dp4a, four xor-shuffles,
the breakpoints compared a lane each and counted by a ballot.  The warp,
tile and step constants are read from the sources."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from docker_nvidia_glx_desktop_tpu.ops import jpeg_device as j_jd
from docker_nvidia_glx_desktop_tpu_torch.ops import aq
from docker_nvidia_glx_desktop_tpu_torch.ops import jpeg_device as jd
from test_torch_k16a_k14d_order import SMS, cu_ints

H = cu_ints("jpeg", ("kDcL", "kAcL", "kDcC", "kAcC", "kSyms", "HIST_WARPS", "HIST_NT",
                     "HIST_CTAS_PER_SM", "HIST_MAX_S"))
Q = cu_ints("aq", ("QP_WARPS", "QP_NT", "MAX_STEPS"))
RUNS = (0, 15, 16, 17, 31, 32, 47, 48, 62)
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def bit_length32(v: int) -> int:
    """The kernel's bit_length(abs(v)) on an int32: abs(INT_MIN) stays
    INT_MIN, whose bit length is 32."""
    return 32 if v == I32_MIN else abs(v).bit_length()


def wrap32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


# -- K16b: a block's symbols from its mask ---------------------------------------

def ac_mask(zz):
    """Two ballots (lane l: positions l and l + 32), bit 0 (the DC) cleared:
    the mask's halves (lo, hi)."""
    lo = sum(1 << lane for lane in range(1, 32) if zz[lane] != 0)
    hi = sum(1 << lane for lane in range(32) if zz[lane + 32] != 0)
    return lo, hi


def clz32(x: int) -> int:
    return 32 - x.bit_length()


def ac_symbol(lo: int, hi: int, lane: int, high: bool, v: int):
    """(symbol, zrl) of the nonzero level v at position lane (+ 32 where
    ``high``), as ``ac_symbol<HI>`` derives them from the mask's halves."""
    below = (hi if high else lo) & ((1 << lane) - 1)
    prev = 31 - clz32(below)
    if high:
        prev = prev + 32 if below else 31 - clz32(lo)
    run = (32 + lane if high else lane) - max(prev, 0) - 1
    return ((run & 15) << 4) | bit_length32(v), run >> 4


def block_model(zz):
    """Each lane's items (position, symbol, zrl), in position order, and
    the EOB, as the warp derives them."""
    lo, hi = ac_mask(zz)
    items = []
    for lane in range(32):
        if (lo >> lane) & 1:
            items.append((lane,) + ac_symbol(lo, hi, lane, False, int(zz[lane])))
        if (hi >> lane) & 1:
            items.append((32 + lane,) + ac_symbol(lo, hi, lane, True, int(zz[32 + lane])))
    return sorted(items), not hi >> 31


def crafted_blocks(rng):
    """Blocks with a nonzero after each run of ``RUNS`` zeros (and a
    second after it), the last nonzero at 62 and at 63, every size 1-15,
    all zero, int32 extremes."""
    out = []
    for run in RUNS:
        b = np.zeros(64, np.int64)
        b[1 + run] = rng.choice([-1, 1]) * int(rng.integers(1, 1 << 14))
        if 2 + 2 * run < 64:
            b[2 + 2 * run] = 5
        out.append(b)
    for last in (62, 63):
        b = np.zeros(64, np.int64)
        b[last], b[3] = -2, 1
        out.append(b)
    b = np.zeros(64, np.int64)
    pos = rng.permutation(np.arange(1, 64))[:15]
    b[pos] = [(1 << s) - 1 if s % 2 else -(1 << (s - 1)) for s in range(1, 16)]
    out.append(b)
    out.append(np.zeros(64, np.int64))
    b = np.zeros(64, np.int64)
    b[[1, 17, 40]] = [I32_MIN, I32_MAX, -1]
    out.append(b)
    out.append(np.where(np.arange(64) % 2, 1023, -1024))
    return np.stack(out).astype(np.int32)


def test_the_symbols_from_the_mask_equal_the_plain_walk():
    blocks = crafted_blocks(np.random.default_rng(0))
    sy = jd.component_symbols(torch.from_numpy(blocks),
                              torch.ones(len(blocks), dtype=torch.bool))
    for i, zz in enumerate(blocks):
        items, eob = block_model(zz)
        m = sy["mask"][i].numpy()
        assert [k for k, _, _ in items] == [k for k in range(1, 64) if m[k - 1]]
        for k, sym, zrl in items:
            assert sym == int(sy["sym"][i, k - 1]) and sym < 256
            assert zrl == int(sy["nzrl"][i, k - 1])
        assert eob == bool(sy["eob"][i])
    # the runs themselves: a nonzero after r zeros is symbol (r % 16) << 4 | size
    for r, zz in zip(RUNS, blocks):
        k, sym, zrl = block_model(zz)[0][0]
        assert (k, sym >> 4, zrl) == (1 + r, r % 16, r // 16)


# -- K16b: the work split, the DC chain and the counts ---------------------------

def hist_ctas(nmcu: int, ns: int, sms: int = SMS) -> int:
    """CTAs a session of the launch, as ``jpeg_analyze_launch`` sizes the
    grid: about HIST_CTAS_PER_SM an SM over the launch's ``ns`` sessions,
    each warp at least an MCU."""
    most = -(-nmcu // H["HIST_WARPS"])
    return max(1, min(most, -(-(sms * H["HIST_CTAS_PER_SM"]) // ns)))


def warp_spans(nmcu: int, ctas: int):
    """(CTA, first MCU, end) of every warp with work, as the kernel's
    index arithmetic gives them."""
    per_cta = -(-nmcu // ctas)
    per_warp = -(-per_cta // H["HIST_WARPS"])
    for cta in range(ctas):
        c0 = cta * per_cta
        c1 = min(c0 + per_cta, nmcu)
        for w in range(H["HIST_WARPS"]):
            w0 = c0 + w * per_warp
            w1 = min(w0 + per_warp, c1)
            if w0 < w1:
                yield cta, w0, w1


def cta_bins(y, cb, cr, mps: int, w0: int, w1: int, h: np.ndarray):
    """One warp's MCUs [w0, w1) into the CTA's bins ``h``: the DC chains in
    registers, read from memory for the first MCU (a size counted by lane:
    lanes 17-31 are never flushed), EOB and ZRL counts in registers, an AC
    symbol an add."""
    prev = [0, 0, 0] if w0 % mps == 0 else [int(y[w0 - 1, 3, 0]), int(cb[w0 - 1, 0]),
                                            int(cr[w0 - 1, 0])]
    dc_lanes = np.zeros((2, 32), np.int64)
    eob, zrl = np.zeros(2, np.int64), np.zeros(2, np.int64)
    for m in range(w0, w1):
        if m % mps == 0:
            prev = [0, 0, 0]
        for c in range(6):
            zz = y[m, c] if c < 4 else (cb[m] if c == 4 else cr[m])
            comp, chain = int(c >= 4), 0 if c < 4 else c - 3
            size = bit_length32(wrap32(int(zz[0]) - prev[chain]))
            prev[chain] = int(zz[0])
            if size < 32:
                dc_lanes[comp, size] += 1
            items, e = block_model(zz)
            eob[comp] += e
            base = H["kAcC"] if comp else H["kAcL"]
            for _, sym, _ in items:
                h[base + sym] += 1
            zrl[comp] += sum(z for _, _, z in items)
    for comp, base in ((0, H["kDcL"]), (1, H["kDcC"])):
        h[base:base + 17] += dc_lanes[comp, :17]
    h[H["kAcL"]] += eob[0]
    h[H["kAcC"]] += eob[1]
    h[H["kAcL"] + 0xF0] += zrl[0]
    h[H["kAcC"] + 0xF0] += zrl[1]


def k16b_model(y, cb, cr, nx: int, rng, acc=None, arrive=None, ctas=None):
    """The histograms (S, 546) a launch sequence gives: sessions in slots
    of at most HIST_MAX_S a launch; each CTA (in a random order) adds its
    nonzero bins to its slot's accumulator and arrives; the last to arrive
    swaps the sums out.  ``acc``/``arrive`` are the device's state, left
    at zero; ``ctas`` replaces the launcher's grid (the kernel's split
    holds for any)."""
    s, nmcu = cb.shape[:2]
    acc = np.zeros((H["HIST_MAX_S"], H["kSyms"]), np.int64) if acc is None else acc
    arrive = np.zeros(H["HIST_MAX_S"], np.int64) if arrive is None else arrive
    out = np.full((s, H["kSyms"]), -1, np.int64)
    for s0 in range(0, s, H["HIST_MAX_S"]):
        ns = min(H["HIST_MAX_S"], s - s0)
        ctas = ctas or hist_ctas(nmcu, ns)
        spans = list(warp_spans(nmcu, ctas))
        order = [(slot, cta) for slot in range(ns) for cta in range(ctas)]
        for i in rng.permutation(len(order)):
            slot, cta = order[i]
            h = np.zeros(H["kSyms"], np.int64)
            for c, w0, w1 in spans:
                if c == cta:
                    cta_bins(y[s0 + slot], cb[s0 + slot], cr[s0 + slot], nmcu // nx, w0, w1, h)
            acc[slot] += h                   # only the nonzero bins move
            arrive[slot] += 1
            if arrive[slot] == ctas:
                out[s0 + slot], acc[slot], arrive[slot] = acc[slot], 0, 0
    return out


@pytest.mark.parametrize("nmcu,ns", [(1, 1), (7, 1), (17, 1), (45, 3), (8160, 1), (8160, 4),
                                     (32400, 1), (130, 64)])
def test_the_warps_take_every_mcu_once(nmcu, ns):
    """The grid of the main paths' shapes (1080p, the batch's four
    sessions, 4K) and of short ones: every MCU in one warp's span, in
    order, and about HIST_CTAS_PER_SM CTAs an SM."""
    ctas = hist_ctas(nmcu, ns)
    got = [m for _, w0, w1 in warp_spans(nmcu, ctas) for m in range(w0, w1)]
    assert got == list(range(nmcu))
    assert ctas * ns <= max(ns, SMS * H["HIST_CTAS_PER_SM"] + ns)
    assert H["HIST_NT"] == 32 * H["HIST_WARPS"]


def crafted_levels(s: int, nmcu: int, seed: int):
    """(y, cb, cr) numpy int32: ``crafted_blocks`` and sparse random blocks,
    DCs that step by small amounts and past size 16."""
    rng = np.random.default_rng(seed)
    pool = crafted_blocks(rng)
    blocks = np.zeros((s, nmcu, 6, 64), np.int64)
    for i in np.ndindex(s, nmcu, 6):
        if rng.random() < 0.5:
            blocks[i] = pool[rng.integers(0, len(pool))]
        else:
            blocks[i][1:] = np.where(rng.random(63) < 0.15, rng.integers(-40, 41, 63), 0)
        blocks[i][0] = rng.choice([0, 3, -7, 70000, -70000, 1 << 20, I32_MAX, I32_MIN])
    b = blocks.astype(np.int32)
    return (np.ascontiguousarray(b[:, :, :4]), np.ascontiguousarray(b[:, :, 4]),
            np.ascontiguousarray(b[:, :, 5]))


@pytest.mark.parametrize("ctas", [None, 1, 3])
@pytest.mark.parametrize("s,nmcu,nx", [(1, 1, 1), (1, 45, 1), (1, 45, 3), (2, 52, 4),
                                       (1, 36, 4), (1, 17, 1)])
def test_the_chains_and_counts_give_the_plain_histograms(s, nmcu, nx, ctas):
    """The launcher's grid and grids of 1 and 3 CTAs (a warp up to 6 MCUs,
    as at 1080p and past it): strip resets mid-warp and mid-CTA (15 and 13
    MCUs a strip), the chains carried across a warp's MCUs, DC sizes past
    16 dropped."""
    y, cb, cr = crafted_levels(s, nmcu, seed=nmcu * 10 + nx)
    want = jd.jpeg_analyze_plain(*[torch.from_numpy(a) for a in (y, cb, cr)], nx).numpy()
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(k16b_model(y, cb, cr, nx, rng, ctas=ctas), want)


def test_the_accumulators_return_to_zero_across_launches():
    """A session count past HIST_MAX_S takes two launches; the device's
    accumulators and arrivals are zero after each call, so a second call
    gives the same histograms."""
    s = H["HIST_MAX_S"] + 2
    y, cb, cr = crafted_levels(1, 3, seed=5)
    y, cb, cr = (np.concatenate([a] * s) for a in (y, cb, cr))
    acc = np.zeros((H["HIST_MAX_S"], H["kSyms"]), np.int64)
    arrive = np.zeros(H["HIST_MAX_S"], np.int64)
    rng = np.random.default_rng(2)
    first = k16b_model(y, cb, cr, 3, rng, acc, arrive)
    assert not acc.any() and not arrive.any()
    np.testing.assert_array_equal(k16b_model(y, cb, cr, 3, rng, acc, arrive), first)
    want = jd.jpeg_analyze_plain(*[torch.from_numpy(a) for a in (y[:1], cb[:1], cr[:1])], 3)
    np.testing.assert_array_equal(first, np.repeat(want.numpy(), s, 0))


@pytest.mark.parametrize("comp", ["y", "c"])
def test_a_dc_size_past_16_is_dropped_as_the_reference_drops_it(comp):
    """One MCU whose DC levels 70000, -70000, 0, 0 step past size 16 (in
    Y00-Y11, or in Cb with Cr small): JAX's ``jpeg_analyze`` drops those
    updates; the plain version and the kernel's model (no lane below 17
    matches) agree with it, where the old clamp added them to bin 16."""
    y = np.zeros((1, 1, 4, 64), np.int32)
    cb = np.zeros((1, 1, 64), np.int32)
    cr = np.zeros((1, 1, 64), np.int32)
    if comp == "y":
        y[0, 0, :, 0] = [70000, -70000, 0, 0]
    else:
        cb[0, 0, 0], cr[0, 0, 0] = 70000, 3
    ref = [np.asarray(a) for a in j_jd.jpeg_analyze(
        jnp.asarray(y.reshape(-1, 64)), jnp.asarray(cb[0]), jnp.asarray(cr[0]))]
    plain = jd.split_hists(jd.jpeg_analyze_plain(
        *[torch.from_numpy(a) for a in (y, cb, cr)]))
    model = jd.split_hists(torch.from_numpy(
        k16b_model(y, cb, cr, 1, np.random.default_rng(0))))
    for r, p, m in zip(ref, plain, model):
        np.testing.assert_array_equal(p[0].numpy(), r)
        np.testing.assert_array_equal(m[0].numpy(), r)
    dc = ref[0] if comp == "y" else ref[2]     # Y: sizes 17, 18, 17, 0; Cb 17, Cr 2
    assert dc[0 if comp == "y" else 2] == 1 and dc.sum() == 1


# -- K14a / K14r -----------------------------------------------------------------

def dp4a(a: int, b: int, c: int) -> int:
    return c + sum(((a >> 8 * k) & 255) * ((b >> 8 * k) & 255) for k in range(4))


def vabsdiffu4(a: int, b: int) -> int:
    return sum(abs(((a >> 8 * k) & 255) - ((b >> 8 * k) & 255)) << 8 * k for k in range(4))


def warp_sums(y: np.ndarray, nxt, r: int, p: int, nc: int):
    """The sums (s, s2, sad) each lane of warp (row r, pair p) holds after
    the four xor-shuffles: lane 2 row + m loads row ``row`` of MB 2p + m as
    four little-endian words."""
    lanes = []
    for lane in range(32):
        m, row = lane & 1, lane >> 1
        c = 2 * p + m
        s = s2 = sad = 0
        if c < nc:
            seg = y[r * 16 + row, c * 16:c * 16 + 16].astype(np.uint32)
            w = [int(seg[4 * k] | seg[4 * k + 1] << 8 | seg[4 * k + 2] << 16
                     | seg[4 * k + 3] << 24) for k in range(4)]
            for x in w:
                s, s2 = dp4a(x, 0x01010101, s), dp4a(x, x, s2)
            if nxt is not None:
                sn = nxt[r * 16 + row, c * 16:c * 16 + 16].astype(np.uint32)
                wn = [int(sn[4 * k] | sn[4 * k + 1] << 8 | sn[4 * k + 2] << 16
                          | sn[4 * k + 3] << 24) for k in range(4)]
                for x, z in zip(w, wn):
                    sad = dp4a(vabsdiffu4(x, z), 0x01010101, sad)
        lanes.append([s, s2, sad])
    for o in (2, 4, 8, 16):
        lanes = [[a + b for a, b in zip(lanes[i], lanes[i ^ o])] for i in range(32)]
    return lanes


def ballot_delta(act_by_mb, first: int, steps, n_steps: int):
    """Lane k of half-warp h compares MB h's activity with steps[k]
    (steps padded to 16 with 2^31 - 1, lanes past n_steps masked); the
    popcount of each half is MB h's delta."""
    padded = list(steps) + [I32_MAX] * (16 - len(steps))
    bits = [lane % 16 < min(n_steps, Q["MAX_STEPS"])
            and act_by_mb[lane // 16] >= padded[lane % 16] for lane in range(32)]
    return [first + sum(bits[16 * h:16 * h + 16]) for h in (0, 1)]


def qp_model(y: np.ndarray, qp: int, nxt=None, rows=None):
    nr, nc = y.shape[0] // 16, y.shape[1] // 16
    first, steps = aq.aq_steps()
    rows = list(range(nr)) if rows is None else list(rows)
    np_ = (nc + 1) // 2
    warps = len(rows) * np_
    ctas = -(-warps // Q["QP_WARPS"])
    out = np.full((len(rows), nc), -1, np.int64)
    for gw in range(ctas * Q["QP_WARPS"]):
        i = gw // np_
        if i >= len(rows):
            continue
        p = gw - i * np_
        lanes = warp_sums(y, nxt, rows[i], p, nc)
        acts = [max(wrap32(256 * lanes[m][1] - lanes[m][0] * lanes[m][0]), 0) for m in (0, 1)]
        d = ballot_delta(acts, first, steps, len(steps))
        for m in (0, 1):
            c = 2 * p + m
            if c < nc:
                assert out[i, c] == -1
                sad = lanes[m][2]
                dd = d[m] + (0 if nxt is None else -aq.LOOKAHEAD_BIAS if sad <= 256
                             else 1 if sad >= 6 * 256 else 0)
                out[i, c] = min(max(qp + dd, 1), 51)
    assert (out >= 0).all()
    return out


def test_the_sums_are_exact_in_32_bits():
    """The bounds the kernel's comment states: s <= 65280, s2 <= 16,646,400,
    SAD <= 65280; 256 s2 wraps past 2^31 and the activity wraps as the
    reference's int32 products do."""
    y = np.full((16, 32), 255, np.uint8)
    lanes = warp_sums(y, np.zeros_like(y), 0, 0, 2)
    assert lanes[0] == [65280, 16646400, 65280] == lanes[1]
    assert 256 * lanes[0][1] >= 2 ** 31 and lanes[0][1] < 2 ** 32


def breakpoint_activities(steps):
    return sorted({0, 1, I32_MAX} | {v + d for v in steps for d in (-1, 0, 1)})


@pytest.mark.parametrize("knobs", [None, (2.0, 4), (0.5, 2), (1.5, 6)])
def test_the_ballot_compare_counts_the_breakpoints(knobs):
    """Every activity at, below and above each breakpoint, and 2^31 - 1
    (which equals the padding): the ballot's popcount is ``first + #(steps
    <= act)`` for the default table and for knobs with fewer breakpoints."""
    first, steps = aq.aq_steps(*knobs) if knobs else aq.aq_steps()
    assert len(steps) < 16
    for a in breakpoint_activities(steps):
        want = first + sum(a >= s for s in steps)
        assert ballot_delta([a, a], first, steps, len(steps)) == [want, want]
    # unmasked, the padding would count at 2^31 - 1
    padded = list(steps) + [I32_MAX] * (16 - len(steps))
    assert sum(I32_MAX >= s for s in padded) == 16


def aq_planes(kind: str, seed: int):
    """(y, next_y) uint8 planes of 2 x 3 MBs (an odd count of MB columns:
    the last pair holds one MB)."""
    rng = np.random.default_rng(seed)
    if kind == "sat":                     # all 255, and 200 +- 55
        y = np.full((32, 48), 255, np.uint8)
        y[16:] = 200 + 55 * rng.choice([-1, 1], (16, 48))
        return y, y[:, ::-1].copy()
    if kind == "sad":                     # SADs 256, 257, 1535, 1536, 0, 65280
        y = np.full((32, 48), 100, np.int64)
        nxt = y.copy()
        for k, sad in enumerate((256, 257, 1535, 1536, 0, 65280)):
            r, c = 16 * (k // 3), 16 * (k % 3)
            d = np.zeros(256, np.int64)
            if sad == 65280:
                y[r:r + 16, c:c + 16], d[:] = 0, 255
            else:
                d[:] = sad // 256
                d[:sad % 256] += 1
            nxt[r:r + 16, c:c + 16] = y[r:r + 16, c:c + 16] + d.reshape(16, 16)
        return y.astype(np.uint8), nxt.astype(np.uint8)
    y = rng.integers(0, 256, (32, 48), dtype=np.uint8)
    y[:16, :16] = rng.integers(100, 104, (16, 16))       # low activity
    return y, np.clip(y.astype(np.int64) + rng.integers(-1, 2, y.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["sat", "sad", "rand"])
@pytest.mark.parametrize("lookahead", [False, True])
def test_the_warp_model_equals_the_plain_qp_plane(kind, lookahead):
    y, nxt = aq_planes(kind, seed=3)
    nxt = nxt if lookahead else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    for qp in (1, 26, 51):
        want = aq.qp_plane_plain(t(y), qp, t(nxt)).numpy()
        np.testing.assert_array_equal(qp_model(y, qp, nxt), want)
    if kind == "sad" and lookahead:       # the thresholds, either side of each
        d = qp_model(y, 26, nxt) - qp_model(y, 26)
        assert d[0].tolist() == [-aq.LOOKAHEAD_BIAS, 0, 0] and d[1, 0] == 1


def test_a_worklist_with_duplicates_maps_each_output_mb_once():
    y, nxt = aq_planes("rand", seed=4)
    rows = [1, 0, 1]
    want = aq.qp_plane_plain(torch.from_numpy(y), 30, torch.from_numpy(nxt),
                             torch.tensor(rows, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(qp_model(y, 30, nxt, rows), want)
    assert Q["QP_NT"] == 32 * Q["QP_WARPS"]
