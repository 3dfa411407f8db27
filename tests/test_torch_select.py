"""NumPy models of two steps the redesigned K4 and K5 kernels carry,
held against what they replace.

- K4 (``csrc/content.cu`` ``frame_vec``) no longer sorts: it
  radix-selects the floor rank of each percentile, 8 bits a pass over
  four passes, takes the ceil rank's value from the selected value's run
  or, past its end, the least larger value, and interpolates in float32.
  The model below repeats those steps and must equal ``np.sort`` with
  the port's plain interpolation (``content_stats._percentiles_f32``).
- K5 (``csrc/inter.cu``) takes each stage's first minimum as the
  minimum of one unsigned key a candidate, ``(SAD - bias + 2^16) << 7 |
  k``; its index must be ``_first_argmin``'s over the biased SADs,
  negative ones included.

Both run in milliseconds and compile no JAX program.
"""

import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu_torch.ops.content_stats import _percentiles_f32
from docker_nvidia_glx_desktop_tpu_torch.ops.h264_inter import _first_argmin

KEY_OFF = 1 << 16      # inter.cu KEY_OFF
KEY_SHIFT = 7          # room for 81 candidates


def radix_select(vals: np.ndarray, k: int):
    """content.cu's select of rank ``k`` of the uint32 ``vals``: (value,
    its rank among the equal values, how many equal it)."""
    prefix = 0
    for d in range(3, -1, -1):
        mask = 0 if d == 3 else (0xFFFFFFFF << (8 * d + 8)) & 0xFFFFFFFF
        hit = vals[((vals ^ prefix) & mask) == 0]
        hist = np.bincount((hit >> (8 * d)) & 255, minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, k, side="right"))
        before = int(cum[b - 1]) if b else 0
        prefix |= b << (8 * d)
        k -= before
        eq = int(hist[b])
    return prefix, k, eq


def percentile_model(vals: np.ndarray, q: float, is_float: bool) -> np.float32:
    """content.cu's percentile of the uint32 ``vals`` (float bits where
    ``is_float``): jnp.percentile's float32 position and weights."""
    n = vals.size
    f32 = np.float32
    pos = f32(f32(q) / f32(100.0)) * f32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    hw = f32(pos - low)
    lw = f32(f32(1.0) - hw)
    li = min(max(int(low), 0), n - 1)
    hi = min(max(int(high), 0), n - 1)
    vlo, k_res, eq = radix_select(vals, li)
    vhi = vlo if hi == li or k_res + 1 < eq else int(vals[vals > vlo].min())

    def as_f(v):
        return (np.array([v], np.uint32).view(np.float32)[0] if is_float
                else f32(np.int32(v)))
    return f32(f32(as_f(vlo) * lw) + f32(as_f(vhi) * hw))


def _cases():
    rng = np.random.default_rng(7)
    runs = np.concatenate([np.zeros(4080), np.full(3672, 5000), np.full(408, 9)])
    mags = np.sqrt(np.float32(rng.choice([0, 16, 81, 1296, 1440], 8160)))
    return {
        "n=1": np.array([12345]),
        "n=2": np.array([7, 3]),
        "all equal": np.full(8160, 4242),
        "all zero": np.zeros(8160),
        "runs across p50 and p95": rng.permutation(runs),
        "activities up to 2^31-1": rng.integers(0, 2 ** 31, 8160),
        "top values": np.concatenate([np.full(8150, 2 ** 31 - 1),
                                      rng.integers(0, 2 ** 31, 10)]),
        "few distinct, 4K": rng.choice([0, 1, 255, 256, 65536, 2 ** 24],
                                       32640),
        "|MV| float bits": mags,
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_radix_select_percentiles_equal_sort(name):
    vals = _cases()[name]
    is_float = vals.dtype == np.float32
    bits = (vals.view(np.uint32) if is_float
            else vals.astype(np.int64).astype(np.uint32))
    srt = np.sort(bits)
    for k in sorted({0, bits.size // 2, bits.size - 1, (bits.size * 19) // 20}):
        assert radix_select(bits, k)[0] == srt[k]
    want = _percentiles_f32(torch.from_numpy(
        vals.astype(np.float32) if is_float else vals.astype(np.int64)),
        (50.0, 95.0)).numpy()
    got = [percentile_model(bits, q, is_float) for q in (50.0, 95.0)]
    assert np.array_equal(np.array(got, np.float32), want), (got, want)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_argmin_key_is_the_first_minimum(seed, ties):
    rng = np.random.default_rng(seed)
    for n, hi, bias_at in ((81, 256 * 255, 40), (9, 128 * 255, 0), (8, 255, None)):
        sads = rng.integers(0, 4 if ties else hi + 1, (64, n))
        bias = np.zeros_like(sads)
        if bias_at is not None:
            bias[:, bias_at] = rng.integers(0, 1336, 64)  # margins up to 1335
        biased = sads - bias
        keys = (((biased + KEY_OFF).astype(np.uint64) << KEY_SHIFT)
                | np.arange(n, dtype=np.uint64))
        assert keys.max() < 2 ** 32
        k = keys.min(axis=1)
        idx, val = _first_argmin(torch.from_numpy(biased.T.copy()))
        assert np.array_equal(k & 127, idx.numpy())
        assert np.array_equal((k >> KEY_SHIFT).astype(np.int64) - KEY_OFF,
                              val.numpy())
