"""The CABAC path's pieces against the reference: the engine and
context-init tables, the level transport (plain K10 against
``ops/level_pack.pack_levels``, and the host decoder round trip, native
and NumPy) and the record streams (plain K11i / K11p against
``ops/cabac_binarize.binarize_intra`` / ``binarize_p``), word for word
over the header and the payload, overflow cases included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.bitstream import cabac_tables as j_tab
from docker_nvidia_glx_desktop_tpu.ops import cabac_binarize as j_bin
from docker_nvidia_glx_desktop_tpu.ops import level_pack as j_lp
from docker_nvidia_glx_desktop_tpu_torch.bitstream import cabac_tables
from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib
from docker_nvidia_glx_desktop_tpu_torch.ops import cabac_binarize, level_pack

NR, NC = 3, 7          # one shape: one compile of each reference program


def test_engine_and_context_tables_equal_the_reference():
    for a, b in zip(j_tab.engine_tables(), cabac_tables.engine_tables()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(j_tab.context_init_tables(),
                                  cabac_tables.context_init_tables())
    for idx in range(4):
        for qp in (0, 17, 26, 51):
            for a, b in zip(j_tab.init_contexts(idx, qp),
                            cabac_tables.init_contexts(idx, qp)):
                np.testing.assert_array_equal(a, b)


def _levels(keys, dens, mag, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, _, shape in keys:
        a = rng.integers(-mag, mag + 1, (NR, NC) + shape).astype(np.int32)
        a[rng.random(a.shape) > dens] = 0
        out[k] = a
    return out


def _words(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["intra", "p"])
@pytest.mark.parametrize("dens,mag", [(0.0, 1), (0.03, 4), (0.4, 300),
                                      (1.0, 16383), (0.2, 20000)])
def test_level_pack_equals_reference_and_round_trips(kind, dens, mag):
    keys = level_pack.INTRA_KEYS if kind == "intra" else level_pack.P_KEYS
    assert keys == (j_lp.INTRA_KEYS if kind == "intra" else j_lp.P_KEYS)
    lv = _levels(keys, dens, mag, seed=int(dens * 100) + mag)
    want = np.asarray(j_lp.pack_levels({k: jnp.asarray(v)
                                        for k, v in lv.items()}, keys))
    got = _words(level_pack.pack_levels({k: torch.from_numpy(v)
                                         for k, v in lv.items()}, keys))
    n = level_pack.header_words(NR) + level_pack.payload_words(got)
    np.testing.assert_array_equal(want[:n], got[:n])
    assert not got[n:].any()
    overflow = mag > 16383
    assert bool(got[1]) == overflow
    for native in (True, False):
        dense = level_pack.unpack_levels(got[:n], NR, NC, keys,
                                         use_native=native)
        if overflow:
            assert dense is None
            continue
        for k, v in lv.items():
            np.testing.assert_array_equal(dense[k], v, err_msg=k)


def test_native_level_decoder_counts_its_calls():
    lv = _levels(level_pack.P_KEYS, 0.1, 9, seed=3)
    buf = _words(level_pack.pack_levels({k: torch.from_numpy(v)
                                         for k, v in lv.items()},
                                        level_pack.P_KEYS))
    before = native_lib.calls["level_unpack_rows"]
    level_pack.unpack_levels(buf, NR, NC, level_pack.P_KEYS)
    assert native_lib.calls["level_unpack_rows"] == before + 1


P_ORDER = ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")
I_ORDER = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac",
           "pred_mode", "mb_i4", "i4_modes", "luma_i4")


def _p_case(case):
    rng = np.random.default_rng(len(case))
    dens, mag = {"skip": (0.0, 1), "sparse": (0.04, 3), "dense": (0.5, 60),
                 "extreme": (0.3, 141), "level_overflow": (0.05, 3),
                 "mvd_overflow": (0.05, 3)}[case]
    lv = _levels(level_pack.P_KEYS, dens, mag, seed=7 + len(case))
    mv = rng.integers(-40, 41, (NR, NC, 2)).astype(np.int32)
    mv[rng.random((NR, NC)) < 0.4] = 0
    if case in ("skip", "sparse"):
        for k in lv:                       # skip runs: no levels, mv 0
            lv[k][:, 1:4] = 0
        mv[:, 1:4] = 0
    if case == "extreme":
        mv[2, 0] = (39, -39)
        mv[1, 1:4] = [(0, 0), (-500, 500), (-490, 490)]   # mvd <= 512
        lv["luma"][2, 1, 0, 0] = 141       # largest AC level in budget
        lv["luma"][2, 1, 0, 5] = -141
        lv["cb_dc"][1, 1] = (1000, -5000, 2, 0)
    if case == "level_overflow":
        lv["luma"][0, 0, 0, 0] = 500
    if case == "mvd_overflow":
        mv[1, 3] = (0, 600)
    return dict(lv, mv=mv)


def _i_case(case):
    rng = np.random.default_rng(len(case) + 100)
    dens, mag = {"flat": (0.0, 1), "sparse": (0.05, 3), "dense": (0.5, 60),
                 "extreme": (0.3, 141), "level_overflow": (0.05, 3)}[case]
    lv = _levels(level_pack.INTRA_KEYS, dens, mag, seed=len(case))
    mb_i4 = rng.random((NR, NC)) < 0.5
    lv["luma_ac"][mb_i4] = 0
    lv["luma_dc"][mb_i4] = 0
    lv["luma_i4"][~mb_i4] = 0
    lv["pred_mode"] = rng.integers(0, 4, (NR, NC)).astype(np.int32)
    lv["mb_i4"] = mb_i4
    lv["i4_modes"] = rng.integers(0, 9, (NR, NC, 16)).astype(np.int32)
    if case == "extreme":
        i16 = np.argwhere(~mb_i4)[0]
        lv["luma_dc"][tuple(i16)][:3] = (16000, -3000, 700)
    if case == "level_overflow":
        i4 = np.argwhere(mb_i4)[0]
        lv["luma_i4"][tuple(i4)][2, 0] = -400
    return lv


def _same_transport(want, got):
    n = cabac_binarize.header_words(NR) + cabac_binarize.payload_words(got)
    np.testing.assert_array_equal(want[:n], got[:n])
    assert not got[n:].any()
    return bool(got[1])


@pytest.mark.parametrize("case", ["skip", "sparse", "dense", "extreme",
                                  "level_overflow", "mvd_overflow"])
def test_binarize_p_equals_reference(case):
    d = _p_case(case)
    want = np.asarray(j_bin.binarize_p(*[jnp.asarray(d[k]) for k in P_ORDER]))
    got = _words(cabac_binarize.binarize_p(
        *[torch.from_numpy(d[k]) for k in P_ORDER]))
    assert _same_transport(want, got) == case.endswith("overflow")
    split = cabac_binarize.split_rows(got, NR)
    if split is None:
        return
    payload, row_off, row_bits = split
    for r in range(NR):
        words = payload[row_off[r]:row_off[r + 1]]
        assert (cabac_binarize.decode_records_py(words, int(row_bits[r]))
                == j_bin.decode_records_py(words, int(row_bits[r])))


def test_malformed_record_stream_raises_and_is_not_counted():
    """A row whose records do not end at its bit count is a binarizer
    fault: the engine refuses it and the port raises rather than code
    the frame from the dense levels."""
    from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_cabac

    d = _p_case("sparse")
    buf = _words(cabac_binarize.binarize_p(
        *[torch.from_numpy(d[k]) for k in P_ORDER])).copy()
    head = cabac_binarize.META_WORDS
    args = dict(nr=NR, nc_mb=NC, qp=26, frame_num=1)
    assert h264_cabac.encode_p_from_binstream(buf, **args)
    # one more bit in a row that keeps its word count: a zero pad bit
    # reads as the start of a decision record that the row cannot hold
    r = next(r for r in range(NR) if buf[head + r] % 32)
    buf[head + r] += 1
    before = native_lib.calls["h264_cabac_engine_rows"]
    with pytest.raises(RuntimeError, match="malformed"):
        h264_cabac.encode_p_from_binstream(buf, **args)
    assert native_lib.calls["h264_cabac_engine_rows"] == before


@pytest.mark.parametrize("case", ["flat", "sparse", "dense", "extreme",
                                  "level_overflow"])
def test_binarize_intra_equals_reference(case):
    d = _i_case(case)
    want = np.asarray(j_bin.binarize_intra(*[jnp.asarray(d[k])
                                             for k in I_ORDER]))
    got = _words(cabac_binarize.binarize_intra(
        *[torch.from_numpy(d[k]) for k in I_ORDER]))
    assert _same_transport(want, got) == (case == "level_overflow")


def test_record_layout_is_the_references():
    """Header slot counts and the per-MB caps the kernel is launched
    with follow from the reference's slot layout."""
    d = _p_case("skip")
    want = np.asarray(j_bin.binarize_p(*[jnp.asarray(d[k]) for k in P_ORDER]))
    assert int(want[4]) == cabac_binarize.layout("p")[0]
    d = _i_case("flat")
    want = np.asarray(j_bin.binarize_intra(*[jnp.asarray(d[k])
                                             for k in I_ORDER]))
    assert int(want[4]) == cabac_binarize.layout("intra")[0]


# The kernel's per-MB syntax walk (csrc/cabac_records.cuh) has no CUDA
# dependency: compiled for the host with the packing of csrc/cabac.cu
# done sequentially, it must give the plain version's transport.
_HOST_WALK = r"""
#include <cstddef>
#include <vector>
#include "cabac_records.cuh"
using namespace cabac_rec;
template <class In, class Walk>
static void run(const In& in, Walk walk, uint32_t* out, int nr, int nc,
                int slots, int cap) {
  const int nmb = nr * nc;
  std::vector<uint32_t> words((size_t)nmb * cap);
  std::vector<long long> bits(nmb), mb_off(nmb), row_woff(nr);
  int flag = 0;
  for (int mb = 0; mb < nmb; ++mb) {
    WordSink s(words.data() + (size_t)mb * cap, cap);
    const bool ovf = walk(in, mb / nc, mb % nc, s);
    s.flush();
    bits[mb] = s.n;
    flag |= (ovf ? 1 : 0) | (s.n > 32LL * cap ? 2 : 0);
  }
  long long total = 0;
  for (int r = 0; r < nr; ++r) {
    long long acc = 0;
    for (int c = 0; c < nc; ++c) { mb_off[r * nc + c] = acc; acc += bits[r * nc + c]; }
    out[8 + r] = (uint32_t)acc;
    row_woff[r] = total;
    total += (acc + 31) >> 5;
  }
  out[0] = 2; out[1] = flag ? 1 : 0; out[2] = (uint32_t)total; out[3] = nr;
  out[4] = slots;
  if (flag & 2) return;
  for (int mb = 0; mb < nmb; ++mb) {
    const long long base = 32LL * (8 + nr + row_woff[mb / nc]) + mb_off[mb];
    const int lead = base & 31, nsrc = (bits[mb] + 31) >> 5;
    const int nw = (lead + bits[mb] + 31) >> 5;
    const uint32_t* src = words.data() + (size_t)mb * cap;
    for (int i = 0; i < nw; ++i) {
      const uint32_t lo = i < nsrc ? src[i] : 0u;
      const uint32_t hi = (i > 0 && i - 1 < nsrc) ? src[i - 1] : 0u;
      out[(base >> 5) + i] |= lead ? (hi << (32 - lead)) | (lo >> lead) : lo;
    }
  }
}
extern "C" void walk_p(const int* mv, const int* luma, const int* cbd,
                       const int* cba, const int* crd, const int* cra,
                       uint32_t* out, int nr, int nc, int slots, int cap) {
  PIn in{mv, luma, cbd, cba, crd, cra, nc};
  run(in, [](const PIn& i, int r, int c, WordSink& s) { return p_mb(i, r, c, s); },
      out, nr, nc, slots, cap);
}
extern "C" void walk_intra(const int* ldc, const int* lac, const int* cbd,
                           const int* cba, const int* crd, const int* cra,
                           const int* pm, const uint8_t* i4, const int* modes,
                           const int* li4, uint32_t* out, int nr, int nc,
                           int slots, int cap) {
  IIn in{ldc, lac, cbd, cba, crd, cra, pm, i4, modes, li4, nc};
  run(in, [](const IIn& i, int r, int c, WordSink& s) { return intra_mb(i, r, c, s); },
      out, nr, nc, slots, cap);
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    import ctypes
    import pathlib
    import subprocess

    d = tmp_path_factory.mktemp("walk")
    src, so = d / "walk.cpp", d / "libwalk.so"
    src.write_text(_HOST_WALK)
    csrc = pathlib.Path(cabac_binarize.__file__).parent.parent / "csrc"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{csrc}", "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("kind,case", [
    ("p", c) for c in ("skip", "sparse", "dense", "extreme", "level_overflow",
                       "mvd_overflow")] + [
    ("intra", c) for c in ("flat", "sparse", "dense", "extreme",
                           "level_overflow")])
def test_kernel_record_walk_equals_the_plain_version_on_the_host(
        host_walk, kind, case):
    import ctypes

    d = _p_case(case) if kind == "p" else _i_case(case)
    order = P_ORDER if kind == "p" else I_ORDER
    arrays = [np.ascontiguousarray(d[k], np.uint8 if k == "mb_i4" else np.int32)
              for k in order]
    plain = (cabac_binarize.binarize_p if kind == "p"
             else cabac_binarize.binarize_intra)
    want = _words(plain(*[torch.from_numpy(d[k]) for k in order]))
    got = np.zeros_like(want)
    slots, cap = cabac_binarize.layout(kind)
    fn = host_walk.walk_p if kind == "p" else host_walk.walk_intra
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrays + [got]],
       NR, NC, slots, cap)
    np.testing.assert_array_equal(want, got)
