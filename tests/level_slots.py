"""Crafted level slots for K10 (the CABAC level transport,
``csrc/levelpack.cu``): the inputs that break its segment design, as
(R, C, S) int32 slot matrices in wire order.  Used by
``tests/test_torch_level_pack_order.py`` (a NumPy model of the kernel's
schedule) and by ``chip_smoke.py``'s k10k11i phase (the kernel against
its plain version on the card)."""

import numpy as np

# zero: every slot 0 (1 bit each); full: every slot nonzero (16 bits);
# edge: only the range's edge values 16383, -16383, -16384 and +-1 among
# zeros; over: sparse levels with 16384 and -16385 (the flag set); rows:
# all-zero and all-nonzero rows in turn; sparse: 3% small levels
K10_KINDS = ("zero", "full", "edge", "over", "rows", "sparse")


def k10_slots(kind: str, nr: int, nc: int, s: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (nr, nc, s)
    if kind == "zero":
        return np.zeros(shape, np.int32)
    if kind in ("full", "rows"):
        v = rng.integers(1, 16384, shape) * rng.choice((-1, 1), shape)
        v[rng.random(shape) < 0.01] = -16384
        if kind == "rows":
            v[::2] = 0
        return v.astype(np.int32)
    if kind == "edge":
        v = rng.choice(np.array((16383, -16383, -16384, 1, -1), np.int32), shape)
        return np.where(rng.random(shape) < 0.5, v, 0).astype(np.int32)
    v = rng.integers(-3, 4, shape)
    v[rng.random(shape) > 0.03] = 0
    if kind == "over":
        v[nr // 2, nc // 3, s // 2] = 16384
        v[nr - 1, nc - 1, s - 1] = -16385
    return v.astype(np.int32)
