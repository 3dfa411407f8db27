"""Synthetic slots for the bit packers (K3, K7): the crafted frames that
break the packer's segment design.  ``tests/test_torch_pack_order.py``
holds its model of the kernel's schedule to them on the CPU, and
``chip_smoke.py``'s k3k7 phase holds the kernel to them on the card."""

import numpy as np


K3K7_FLAT_ROWS = (18, 120)        # the frames at FLAT_CAP_WORDS: 2160 MBs


def k3k7_slots(nr: int, nc: int, nb: int, kind: str, seed: int, ns: int = 1,
               hdr_sess: bool = False, p: bool = False) -> dict:
    """Synthetic packer inputs (numpy, a leading session axis of ``ns``):
    ``values``/``lengths`` (S, R, C, nb, 34), ``syn_vals``/``syn_lens``
    (S, R, C, 20 for K3 or 7 for K7 with ``p``), ``hdr_vals``/``hdr_lens``
    (S or 1, R, 3), ``run_vals``/``run_lens`` (S, R) with ``p``, and
    ``qp_sum`` (S,).  Values fit their lengths (a 32-bit one may set bit
    31); a zero-length slot holds a random value, which no packer reads.
    Kinds: ``rand`` (sparse blocks, 1-16 bits a slot, some 32: codewords
    crossing words at any offset, so segment edges fall inside words),
    ``zero`` (no block bits; K7 all-skip rows: headers and runs only),
    ``wide32`` (every live slot 32 bits), ``full`` (every slot 32 bits:
    30,016 bits an MB, overflowing), ``cap256`` (pieces of exactly 256
    bits, an MB of exactly 2048), ``cap257`` (a piece of 257), ``mb2049``
    (an MB of 2049, every piece at most 256), ``pad`` (rows alternating
    pad 0 and pad 7), ``flat_cap`` / ``flat_cap1`` (at K3K7_FLAT_ROWS: a
    total of exactly FLAT_CAP_WORDS, and one word over)."""
    rng = np.random.default_rng(seed)
    ns_syn = 7 if p else 20
    blk = (ns, nr, nc, nb, 34)
    syn = (ns, nr, nc, ns_syn)
    hdr = (ns if hdr_sess else 1, nr, 3)
    lens = np.zeros(blk, np.int64)
    slen = np.zeros(syn, np.int64)
    hlen = rng.integers(0, 33, hdr)
    rlen = rng.integers(0, 16, (ns, nr)) * (rng.random((ns, nr)) < 0.7) if p \
        else np.zeros((ns, nr), np.int64)
    if kind in ("rand", "pad", "cap256", "cap257", "mb2049"):
        busy = rng.random(blk[:-1] + (1,), np.float32) < 0.5
        u = rng.random(blk, np.float32)            # live below 0.12, 32 bits below 0.006
        lens = np.where(busy & (u < 0.12), rng.integers(1, 17, blk, np.int32), 0)
        lens = np.where(busy & (u < 0.006), 32, lens)
        slen = np.where(rng.random(syn) < 0.4, rng.integers(1, 10, syn), 0)
    elif kind == "zero":
        if not p:
            slen = np.where(rng.random(syn) < 0.4, rng.integers(1, 10, syn), 0)
        rlen = rng.integers(1, 16, (ns, nr))
    elif kind == "wide32":
        lens = np.where(rng.random(blk) < 0.03, 32, 0)
        slen = np.where(rng.random(syn) < 0.2, 32, 0)
    elif kind == "full":
        lens[:] = 32
        slen[:] = 32
    elif kind in ("flat_cap", "flat_cap1"):
        if (nr, nc) != K3K7_FLAT_ROWS:
            raise ValueError(f"{kind} is {K3K7_FLAT_ROWS}")
        hlen[:] = 0
        hlen[..., 0] = 24                      # 24 + 32m body bits: pad 7
        rlen[:] = 0
        # 64 words an MB (8 blocks of 8 slots of 32 bits: at the caps, not
        # over), less the deficit at the frame's end; a row's words are its
        # MBs' and one
        target = (1 << 17) + (kind == "flat_cap1")
        words = np.full(nr * nc, 64)
        deficit = nr * nc * 64 - (target - nr)
        words[nr * nc - deficit // 64:] = 0
        words[nr * nc - deficit // 64 - 1] -= deficit % 64
        on = np.zeros((nr * nc, 8, 34), bool)     # slot j: block j // 8, slot j % 8
        on[:, :, :8] = (np.arange(64)[None, :] < words[:, None]).reshape(-1, 8, 8)
        lens[:, :, :, :8] = np.where(on.reshape(nr, nc, 8, 34), 32, 0)[None]
    else:
        raise ValueError(kind)
    if kind in ("cap256", "cap257", "mb2049"):
        c = min(3, nc - 1)
        lens[:, 0, c] = 0
        slen[:, 0, c] = 0
        lens[:, 0, c, :8, :8] = 32                 # 8 pieces of 256: 2048
        if kind == "cap257":
            lens[:, 0, c, 0, 8] = 1
        elif kind == "mb2049":
            slen[:, 0, c, 0] = 1
        if nr > 1:                                 # a lone piece of 256 too
            lens[:, 1, 0, min(1, nb - 1)] = 0
            lens[:, 1, 0, min(1, nb - 1), :8] = 32
    if kind == "pad":
        # the row's first MB's last syntax slot sets its row's pad
        slen[:, :, 0, -1] = 0
        body = (hlen.sum(-1) + lens.sum((2, 3, 4)) + slen.sum((2, 3)) + rlen)
        want = np.where(np.arange(nr) % 2 == 0, 7, 0)  # body % 8 of pad 0 / 7
        slen[:, :, 0, -1] = (want - body) % 8 + 8 * ((want - body) % 8 == 0)
    def vals(shape, ln):
        r = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
        mask = (np.uint64(1) << ln.astype(np.uint64)) - np.uint64(1)
        return np.where(ln > 0, r & mask, r).astype(np.uint32).view(np.int32)

    i32 = lambda a: a.astype(np.int32)
    out = {"values": vals(blk, lens), "lengths": i32(lens),
           "syn_vals": vals(syn, slen), "syn_lens": i32(slen),
           "hdr_vals": vals(hdr, hlen), "hdr_lens": i32(hlen),
           "qp_sum": i32(rng.integers(0, 1 << 31, ns))}
    if p:
        out["run_vals"], out["run_lens"] = vals((ns, nr), rlen), i32(rlen)
    return out
