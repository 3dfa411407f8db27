"""The CABAC path's pieces against the reference: the engine and
context-init tables, the level transport (plain K10 against
``ops/level_pack.pack_levels``, and the host decoder round trip, native
and NumPy) and the record streams (plain K11i / K11p against
``ops/cabac_binarize.binarize_intra`` / ``binarize_p``), word for word
over the header and the payload, overflow cases included."""

import pathlib
import re

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
                 "extreme": (0.3, 141), "level_overflow": (0.05, 3),
                 "all_i4": (0.3, 20), "checker": (0.3, 20)}[case]
    lv = _levels(level_pack.INTRA_KEYS, dens, mag, seed=len(case))
    mb_i4 = rng.random((NR, NC)) < 0.5
    if case == "all_i4":
        mb_i4[:] = True
    if case == "checker":                  # I16 and I4 left neighbours
        mb_i4 = np.add.outer(np.arange(NR), np.arange(NC)) % 2 == 0
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
// Bits of a record stream, MSB-first into words; counts every bit but
// writes only the first ``cap_words`` words.
struct WordSink {
  uint32_t* w;
  int cap_words;
  long long n = 0;
  unsigned long long acc = 0;
  int have = 0, widx = 0;
  WordSink(uint32_t* words, int cap) : w(words), cap_words(cap) {}
  void put(uint32_t v, int len) {
    if (len <= 0) return;
    if (len < 32) v &= (1u << len) - 1u;
    acc = (acc << len) | v;
    have += len;
    n += len;
    while (have >= 32) {
      have -= 32;
      const uint32_t word = (uint32_t)(acc >> have);
      if (widx < cap_words) w[widx] = word;
      ++widx;
      acc &= (1ull << have) - 1ull;
    }
  }
  void flush() {
    if (have > 0 && widx < cap_words) w[widx] = (uint32_t)(acc << (32 - have));
  }
};
// A P frame's inputs and each MB's pieces' context: the summaries from
// its nonzero word (the kernel's warp ballot).
struct PKind {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  int nc;
  static constexpr int pieces = P_PIECES;
  PSum sum(int mb) const {
    return p_sum_from(p_nz_bits(luma + mb * 256, cb_dc + mb * 4, cb_ac + mb * 60,
                                cr_dc + mb * 4, cr_ac + mb * 60),
                      mv[mb * 2], mv[mb * 2 + 1]);
  }
  PCtx ctx(int r, int c) const {
    const int mb = r * nc + c;
    const PSum cur = sum(mb);
    PSum L{};
    if (c > 0) L = sum(mb - 1);
    return p_ctx(cur, c > 0 ? &L : nullptr, c > 1 ? mv + (mb - 2) * 2 : nullptr, c == nc - 1,
                 luma + mb * 256, cb_dc + mb * 4, cb_ac + mb * 60, cr_dc + mb * 4,
                 cr_ac + mb * 60);
  }
  template <class Sink> bool piece(const PCtx& x, int k, Sink& s) const {
    return p_piece(x, k, s);
  }
};
// An I frame's inputs; an MB's two nonzero words lane by lane, as the
// kernel's two ballots give them.
struct IKind {
  const int *luma_dc, *luma_ac, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *pred_mode;
  const uint8_t* mb_i4;
  const int *i4_modes, *luma_i4;
  int nc;
  static constexpr int pieces = I_PIECES;
  ISum sum(int mb) const {
    uint32_t w[2] = {0, 0};
    for (int word = 0; word < 2; ++word)
      for (int l = 0; l < 32; ++l)
        w[word] |= i_lane_nz(word, l, luma_dc + mb * 16, luma_ac + mb * 240, luma_i4 + mb * 256,
                             cb_dc + mb * 4, cb_ac + mb * 60, cr_dc + mb * 4, cr_ac + mb * 60)
                       ? 1u << l : 0u;
    return i_sum_from(w[0], w[1], mb_i4[mb]);
  }
  ICtx ctx(int r, int c) const {
    const int mb = r * nc + c;
    const ISum cur = sum(mb);
    ISum L{};
    if (c > 0) L = sum(mb - 1);
    return i_ctx(cur, c > 0 ? &L : nullptr, c == nc - 1, pred_mode[mb], i4_modes + mb * 16,
                 c > 0 ? i4_modes + (mb - 1) * 16 : nullptr, luma_dc + mb * 16,
                 luma_ac + mb * 240, luma_i4 + mb * 256, cb_dc + mb * 4, cb_ac + mb * 60,
                 cr_dc + mb * 4, cr_ac + mb * 60);
  }
  template <class Sink> bool piece(const ICtx& x, int k, Sink& s) const {
    return i_piece(x, k, s);
  }
};
// Each MB's records: its pieces in order; the packing done sequentially
// (the first version of the kernels: a bit string an MB, a scan along
// each row and over the rows, each MB's bits shifted into place).
template <class Kind>
static void run(const Kind& kind, uint32_t* out, int nr, int nc, int slots, int cap) {
  const int nmb = nr * nc;
  std::vector<uint32_t> words((size_t)nmb * cap);
  std::vector<long long> bits(nmb), mb_off(nmb), row_woff(nr);
  int flag = 0;
  for (int mb = 0; mb < nmb; ++mb) {
    WordSink s(words.data() + (size_t)mb * cap, cap);
    const auto x = kind.ctx(mb / nc, mb % nc);
    bool ovf = false;
    for (int k = 0; k < Kind::pieces; ++k) ovf |= kind.piece(x, k, s);
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
  run(PKind{mv, luma, cbd, cba, crd, cra, nc}, out, nr, nc, slots, cap);
}
extern "C" void walk_intra(const int* ldc, const int* lac, const int* cbd,
                           const int* cba, const int* crd, const int* cra,
                           const int* pm, const uint8_t* i4, const int* modes,
                           const int* li4, uint32_t* out, int nr, int nc,
                           int slots, int cap) {
  run(IKind{ldc, lac, cbd, cba, crd, cra, pm, i4, modes, li4, nc}, out, nr, nc, slots, cap);
}
// The segment schedule of K11p and K11i (csrc/cabac.cu p_seg_kernel,
// i_seg_kernel), sequential: each MB's pieces in lane order counted and
// offset by a scan, segments of ``segp`` MBs of a row whose offsets come
// from a look-back over random AGG / INCL states, the row's word offsets,
// the header, then each segment's words built window by window (``win``
// words, a RunSink a piece) and stored over ``out`` (which holds garbage)
// in a random order: a segment's own words and last word, then it is
// DONE; its first word, when it holds earlier bits, ORed once its
// predecessor is DONE.
template <class Kind>
static void seg_run(const Kind& kind, uint32_t* out, int nr, int nc, int slots, int cap,
                    int segp, int win, unsigned seed) {
  constexpr int NP = Kind::pieces;
  const long long out_words = 8 + nr + (long long)nr * nc * cap;
  auto rnd = [&seed]() { seed = seed * 1103515245u + 12345u; return seed >> 8; };
  const int nseg = (nc + segp - 1) / segp;
  std::vector<long long> poff((size_t)nr * nc * NP), mb_off(nr * nc), seg_bits(nr * nseg),
      excl(nr * nseg), row_w(nr + 1, 0);
  int flags = 0;
  for (int r = 0; r < nr; ++r) {
    for (int s = 0; s < nseg; ++s) {
      long long acc = 0;
      for (int c = s * segp; c < nc && c < (s + 1) * segp; ++c) {
        const auto x = kind.ctx(r, c);
        long long pos = 0;
        for (int k = 0; k < NP; ++k) {
          CountSink cs;
          flags |= kind.piece(x, k, cs) ? 1 : 0;
          poff[(size_t)(r * nc + c) * NP + k] = pos;
          pos += cs.n;
        }
        flags |= pos > 32LL * cap ? 2 : 0;
        mb_off[r * nc + c] = acc;
        acc += pos;
      }
      seg_bits[r * nseg + s] = acc;
    }
    // the look-back: predecessors publish AGG (their bits) or INCL
    std::vector<int> state(nseg);
    for (auto& st : state) st = 1 + (int)(rnd() % 2);
    for (int s = 0; s < nseg; ++s) {
      long long e = 0;
      for (int q = s - 1; q >= 0; --q) {
        if (state[q] == 2) {
          long long incl = 0;
          for (int t = 0; t <= q; ++t) incl += seg_bits[r * nseg + t];
          e += incl;
          break;
        }
        e += seg_bits[r * nseg + q];
      }
      excl[r * nseg + s] = e;
    }
    const long long row_bits = excl[r * nseg + nseg - 1] + seg_bits[r * nseg + nseg - 1];
    out[8 + r] = (uint32_t)row_bits;
    row_w[r + 1] = row_w[r] + ((row_bits + 31) >> 5);
  }
  out[0] = 2; out[1] = flags ? 1 : 0; out[2] = (uint32_t)row_w[nr]; out[3] = nr;
  out[4] = slots; out[5] = out[6] = out[7] = 0;
  struct Ev { int kind, r, s; };            // 0: own words + last, then DONE; 1: OR first
  std::vector<Ev> pending;
  std::vector<std::vector<uint32_t>> segw(nr * nseg);
  std::vector<char> done(nr * nseg, 0);
  for (int r = 0; r < nr; ++r) {
    for (int s = 0; s < nseg; ++s) {
      const long long e = excl[r * nseg + s], sb = seg_bits[r * nseg + s];
      const int lead = (int)(e & 31);
      const int nwords = sb > 0 ? (int)((lead + sb + 31) >> 5) : 0;
      std::vector<uint32_t>& w = segw[r * nseg + s];
      w.assign(nwords, 0u);
      for (int lo = 0; lo < nwords; lo += win) {
        const int n = nwords - lo < win ? nwords - lo : win;
        std::vector<uint32_t> buf(n, 0u);
        for (int c = s * segp; c < nc && c < (s + 1) * segp; ++c) {
          const auto x = kind.ctx(r, c);
          for (int k = 0; k < NP; ++k) {
            RunSink rs(buf.data(), lead + mb_off[r * nc + c]
                                       + poff[(size_t)(r * nc + c) * NP + k] - 32LL * lo, n);
            kind.piece(x, k, rs);
            rs.flush();
          }
        }
        for (int i = 0; i < n; ++i) w[lo + i] = buf[i];
      }
      pending.push_back({0, r, s});
    }
  }
  while (!pending.empty()) {
    std::vector<size_t> ready;
    for (size_t i = 0; i < pending.size(); ++i)
      if (pending[i].kind == 0 || done[pending[i].r * nseg + pending[i].s - 1]) ready.push_back(i);
    const size_t at = ready[rnd() % ready.size()];
    const Ev ev = pending[at];
    pending.erase(pending.begin() + at);
    const int i = ev.r * nseg + ev.s;
    const long long e = excl[i];
    const long long w0 = 8 + nr + row_w[ev.r] + (e >> 5);
    const std::vector<uint32_t>& w = segw[i];
    const bool shared = (e & 31) != 0;
    const int nw = (int)w.size();
    if (ev.kind == 0) {
      for (int j = 0; j < nw; ++j)
        if (!(j == 0 && shared) && w0 + j < out_words) out[w0 + j] = w[j];
      if (shared && nw > 0 && w0 < out_words) {
        pending.push_back({1, ev.r, ev.s});
        if (nw == 1) continue;
      }
      done[i] = 1;
    } else {
      out[w0] |= w[0];
      done[i] = 1;
    }
  }
}
extern "C" void walk_p_seg(const int* mv, const int* luma, const int* cbd,
                           const int* cba, const int* crd, const int* cra,
                           uint32_t* out, int nr, int nc, int slots, int cap,
                           int segp, int win, unsigned seed) {
  seg_run(PKind{mv, luma, cbd, cba, crd, cra, nc}, out, nr, nc, slots, cap, segp, win, seed);
}
extern "C" void walk_intra_seg(const int* ldc, const int* lac, const int* cbd,
                               const int* cba, const int* crd, const int* cra,
                               const int* pm, const uint8_t* i4, const int* modes,
                               const int* li4, uint32_t* out, int nr, int nc,
                               int slots, int cap, int segp, int win, unsigned seed) {
  seg_run(IKind{ldc, lac, cbd, cba, crd, cra, pm, i4, modes, li4, nc}, out, nr, nc, slots, cap,
          segp, win, seed);
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
                           "level_overflow", "all_i4", "checker")])
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


_CABAC_CU = (pathlib.Path(cabac_binarize.__file__).parent.parent / "csrc"
             / "cabac.cu").read_text()
SEG = int(re.search(r"constexpr int SEG = (\d+);", _CABAC_CU).group(1))
P_WIN = int(re.search(r"constexpr int P_WIN = (\d+);", _CABAC_CU).group(1))
I_WIN = int(re.search(r"constexpr int I_WIN = (\d+);", _CABAC_CU).group(1))
I_CASES = ("flat", "sparse", "dense", "extreme", "level_overflow", "all_i4",
           "checker", "over_cap")


@pytest.mark.parametrize("segp,win", [(SEG, P_WIN), (2, P_WIN), (3, 2)])
@pytest.mark.parametrize("case", ["skip", "sparse", "dense", "extreme",
                                  "level_overflow", "mvd_overflow",
                                  "over_cap"] + [f"intra_{c}" for c in I_CASES])
def test_segment_schedule_equals_the_plain_version_on_the_host(
        host_walk, case, segp, win):
    """K11p's and K11i's pieces in the warp's lane order and their segment
    schedule (segments of ``segp`` MBs, windows of ``win`` words, the
    boundary words in random orders over a buffer of garbage): the header
    and payload equal the plain version's.  ``over_cap``: the dense case
    launched with a cap of 8 words an MB, which MBs pass: the flag set,
    the header's other words the plain version's.  An intra case's full
    window is K11i's own (``I_WIN``); NC = 7 is a multiple of no
    segment."""
    import ctypes

    kind = "intra" if case.startswith("intra_") else "p"
    case = case.removeprefix("intra_")
    over = case == "over_cap"
    d = (_p_case if kind == "p" else _i_case)("dense" if over else case)
    order = P_ORDER if kind == "p" else I_ORDER
    arrays = [np.ascontiguousarray(d[k], np.uint8 if k == "mb_i4" else np.int32)
              for k in order]
    plain = (cabac_binarize.binarize_p if kind == "p"
             else cabac_binarize.binarize_intra)
    want = _words(plain(*[torch.from_numpy(d[k]) for k in order]))
    slots, cap = cabac_binarize.layout(kind)
    if over:
        cap = 8
    if kind == "intra" and win == P_WIN:
        win = I_WIN
    got = np.random.default_rng(segp).integers(
        0, 1 << 32, 8 + NR + NR * NC * cap, dtype=np.uint64).astype(np.uint32)
    fn = host_walk.walk_p_seg if kind == "p" else host_walk.walk_intra_seg
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrays + [got]],
       NR, NC, slots, cap, segp, win, ctypes.c_uint(7 + segp))
    head = 8 + NR
    if over:
        assert got[1] == 1 and want[1] == 0
        np.testing.assert_array_equal(np.delete(got[:head], 1),
                                      np.delete(want[:head], 1))
        return
    n = head + int(want[2])
    np.testing.assert_array_equal(got[:n], want[:n])
    assert bool(got[1]) == case.endswith("overflow")
