"""Crafted JPEG levels and tables for the bit pack K16c: the cases that
break a segment packer (the CPU tests and ``chip_smoke.py``'s k11k16
phase both import this module).

Levels come in the port's layout: ``y (S, nmcu, 4, 64)``, ``cb``, ``cr
(S, nmcu, 64)`` int32, zigzagged.  Kinds:

- ``zero``: all-zero blocks (DC and EOB only);
- ``last63``: one nonzero AC at position 63 (three ZRLs, no EOB);
- ``dc11``: DC differences of size 11 (DC alternating -1024 / 1023);
- ``neg``: sparse negative amplitudes of every size to 10;
- ``edge``: all-zero blocks and a few one-coefficient blocks, packed with
  :func:`edge_tables`, where an all-zero block is exactly 32 bits, so
  blocks, segments and strips end on word edges;
- ``noise``: every AC at size 10 and DC differences of size 11, the worst
  case of bits a block;
- ``rand``: sparse random levels.
"""

import numpy as np

KINDS = ("zero", "last63", "dc11", "neg", "edge", "noise", "rand")
TABLE_SIZES = (17, 256, 17, 256)       # dc_l, ac_l, dc_c, ac_c


def k16c_levels(kind: str, nmcu: int, s: int = 1, seed: int = 0):
    """(y, cb, cr) numpy int32 of ``s`` sessions of ``nmcu`` MCUs."""
    rng = np.random.default_rng(seed + 17 * KINDS.index(kind))
    blocks = np.zeros((s, nmcu, 6, 64), np.int32)
    if kind == "last63":
        blocks[..., 63] = rng.choice([-1, 1, 5], blocks.shape[:-1])
        blocks[..., 0] = rng.integers(-3, 4, blocks.shape[:-1])
    elif kind == "dc11":
        blocks[..., 0] = np.where(np.arange(nmcu)[:, None] % 2, 1023, -1024)
        blocks[..., 5] = -1
    elif kind == "neg":
        for size in range(1, 11):
            blocks[..., 6 * size - 5] = np.where(
                rng.random(blocks.shape[:-1]) < 0.5, -((1 << size) - 1), 0)
        blocks[..., 0] = -rng.integers(0, 1000, blocks.shape[:-1])
    elif kind == "edge":
        pick = rng.random(blocks.shape[:-1]) < 0.1
        blocks[..., 1] = np.where(pick, rng.integers(1, 4, pick.shape), 0)
    elif kind == "noise":
        blocks[..., 1:] = (rng.integers(512, 1024, blocks[..., 1:].shape)
                           * rng.choice([-1, 1], blocks[..., 1:].shape))
        blocks[..., 0] = np.where(np.arange(6)[None, None, :] % 2
                                  ^ (np.arange(nmcu)[None, :, None] % 2),
                                  1023, -1024)
    elif kind == "rand":
        m = rng.random(blocks.shape) < 0.12
        blocks[...] = np.where(m, rng.integers(-60, 61, blocks.shape), 0)
        blocks[..., 0] = rng.integers(-500, 500, blocks.shape[:-1])
    elif kind != "zero":
        raise ValueError(kind)
    return (np.ascontiguousarray(blocks[:, :, :4]),
            np.ascontiguousarray(blocks[:, :, 4]),
            np.ascontiguousarray(blocks[:, :, 5]))


def edge_tables():
    """8 dense arrays (codes, lengths per table, ``dense_tables`` order)
    in which DC category 0 and EOB are 16-bit codes, so an all-zero block
    is 32 bits; every other symbol has a code of 4-16 bits (the values are
    arbitrary bits: the packer does not decode them)."""
    rng = np.random.default_rng(99)
    out = []
    for n in TABLE_SIZES:
        lens = rng.integers(4, 17, n).astype(np.int32)
        lens[0] = 16
        codes = (rng.integers(0, 1 << 16, n) & ((1 << lens) - 1)).astype(np.uint32)
        out.extend([codes, lens])
    return out
