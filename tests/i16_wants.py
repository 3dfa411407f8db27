"""Crafted ``want`` rows for the I16-in-P passes' gate: the CPU test
``tests/test_torch_i16_gate_order.py`` holds its model of the gate on
them and the card's i16halo phase drives the kernels with them (as inter
scores of +inf and -inf)."""

import numpy as np

WANT_KINDS = ("all", "none", "alternate", "alternate_odd", "runs", "edges",
              "random")


def crafted_want(kind: str, nb: int, nc: int, seed: int, seg: int = 8) -> np.ndarray:
    """(nb, nc) bool: every MB wants, none, every other (from 0 or 1), runs
    of 1 to 3 * ``seg`` at every offset, runs that start just before each
    ``seg``-MB segment edge, or 60% at random."""
    rng = np.random.default_rng(seed)
    w = np.zeros((nb, nc), bool)
    if kind == "all":
        w[:] = True
    elif kind == "alternate":
        w[:, ::2] = True
    elif kind == "alternate_odd":
        w[:, 1::2] = True
    elif kind == "runs":
        for r in range(nb):
            c = r % (seg + 1)
            while c < nc:
                n = int(rng.integers(1, 3 * seg))
                w[r, c:c + n] = True
                c += n + 1 + int(rng.integers(0, 3))
    elif kind == "edges":
        for e in range(seg, nc, seg):
            w[:, max(0, e - 3):e + 2 + e % 5] = True
    elif kind == "random":
        w = rng.random((nb, nc)) < 0.6
    return w
