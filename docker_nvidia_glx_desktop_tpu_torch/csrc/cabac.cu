// K11i / K11p — CABAC binarization and context-index derivation: a frame's
// levels (and modes or motion vectors) -> the version-2 transport of
// (bin, ctxIdx, bypass) records, per-row bit counts in the header.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/cabac_binarize.py:490
// binarize_intra and :415 binarize_p (their _pack_stream :368 on the
// ops/bitmerge.py trees).  Header and payload equal the reference's word
// for word; the overflow flag trips where it does (a level or mvd beyond
// its bypass budget, an MB above the static cap of ``cap`` words).
//
// What bounds it: bytes (the levels are read once: ~21 MB intra, ~13 MB
// P at 1080p).
//
// Both kinds, one design for Hopper: one memset of the look-back state (a
// ticket, the flags, the rows' word counts, a status word a segment;
// transport.cuh) and one launch, no scratch; the words past the payload
// are left as they were.  A CTA takes a segment of 8 MBs of one row by an
// atomic ticket:
//  - it stages the segment's inputs, and its left MB's, by 16-byte
//    cp.async (lookback.cuh): K11i the levels, the I4 modes and the
//    prediction modes (~2.6 KB an MB), K11p the levels and the mvs of the
//    two MBs left of the segment too;
//  - a warp an MB: ballots over its blocks give each staged MB's nonzero
//    words, the coded_block_flag contexts of the MB and, for the next MB,
//    of its left neighbour (cabac_rec::i_sum_from / p_sum_from; the top MB
//    is never available under a slice per row);
//  - lane k walks piece k of the MB and counts its bits (cabac_rec::
//    i_piece: mb_type, the I4 modes, the chroma mode, CBP and
//    mb_qp_delta, luma DC, each of the 16 luma and 10 chroma blocks,
//    end_of_slice; cabac_rec::p_piece: the skip flag and mb_type, each mvd
//    component, CBP and mb_qp_delta, the blocks, end_of_slice); a warp
//    scan gives each piece's offset, a vote the value overflow (bit 0),
//    the MB's total against ``cap`` bit 1;
//  - warp 0 places the segment (transport::place_segment): its MBs'
//    offsets, a look-back over the row's earlier segments, the row's bit
//    count and words published by its last segment, the header by the
//    last row's last segment;
//  - each lane walks its piece again into a window of the segment's words
//    in shared memory (RunSink: whole words stored, the edge words ORed),
//    and the CTA stores the words coalesced: the last word by a plain
//    store before the segment is DONE, the first one, when it holds
//    earlier bits, ORed after the predecessor is DONE (lookback.cuh
//    SegmentStore), so nothing but the state is zeroed.  Words past the
//    buffer (only where an MB passes its cap) are dropped.
#include "cabac_records.cuh"
#include "transport.cuh"

namespace {

constexpr int SEG = 8;                         // MBs a segment, a warp each
constexpr int NT = 32 * SEG;
constexpr int P_WIN = 8192;                    // a window of the segment's words: SEG MBs at the P cap (981 words)
constexpr int I_WIN = 4096;                    // K11i's (staging takes the rest of 48 KB)
using lookback::FULL;

inline int segments(int nc) { return (nc + SEG - 1) / SEG; }

// A warp's counts of its MB: lane j's piece bits and offset, the MB's bits
// to lane 0's shared slot and its flags to the CTA's.
__device__ __forceinline__ int piece_offset(int pbits, bool ovf, int cap, int* mb_bits,
                                            int* flags) {
  const int lane = threadIdx.x & 31;
  int incl = pbits;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int mbits = __shfl_sync(FULL, incl, 31);
  const int f = (__any_sync(FULL, ovf) ? 1 : 0) | (mbits > 32LL * cap ? 2 : 0);
  if (lane == 0) {
    *mb_bits = mbits;
    if (f) atomicOr(flags, f);
  }
  return incl - pbits;
}

// Segment and row of a CTA's ticket, the CTA's common shared fields.
struct SegHead {
  long long excl, roww;
  int ticket, flags, seg_bits;
  int mb_bits[SEG], mb_off[SEG];
};

__device__ __forceinline__ void take_ticket(SegHead& h, int* istate) {
  if (threadIdx.x == 0) {
    h.ticket = atomicAdd(istate, 1);
    h.flags = 0;
  }
}

// Warp 0 after the counts: place the segment, keep where it goes.
__device__ __forceinline__ void place(SegHead& h, const transport::State& S, unsigned* out,
                                      int r, int s, int nseg, int nr, int n, int slots) {
  const int lane = threadIdx.x & 31;
  const transport::Place pl = transport::place_segment(
      S, out, r, s, nseg, nr, 2, slots, lane < n ? h.mb_bits[lane] : 0, lane < n, h.mb_off,
      h.flags);
  if (lane == 0) {
    h.excl = pl.excl;
    h.roww = pl.row_words;
    h.seg_bits = pl.seg_bits;
  }
}

// The words, window by window: ``walk(sink window, nwin, lo)`` ORs each
// lane's piece into the zeroed window of words lo .. lo + nwin; the CTA
// stores them with the edge words in SegmentStore's order.
template <int WIN, class Walk>
__device__ __forceinline__ void store_segment(const SegHead& h, unsigned* win, unsigned* out,
                                              long long out_words, int nr, int s,
                                              const transport::State& S, int r, int nseg,
                                              Walk walk) {
  const int tid = threadIdx.x;
  const long long w0 = transport::META_WORDS + nr + h.roww;
  lookback::SegmentStore<lookback::Plain> st(out + w0, out_words - w0, h.excl, h.seg_bits);
  for (int lo = 0; lo < st.nwords; lo += WIN) {
    const int nwin = min(st.nwords - lo, WIN);
    for (int i = tid; i < nwin; i += NT) win[i] = 0;
    __syncthreads();
    walk(st.lead, nwin, lo);
    __syncthreads();
    st.store(win, lo, nwin, NT);
    __syncthreads();
  }
  if (tid == 0) st.finish(S.st + static_cast<size_t>(r) * nseg, s, h.excl + h.seg_bits);
}

// ---------------------------------------------------------------------------
// K11p

struct PArgs {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  unsigned* out;                               // the transport
  long long out_words;                         // its length
  transport::State S;
  int nr, nc, nseg, slots, cap;
};

struct PSmem {
  // the staged levels of the segment's MBs and its left neighbour; the mv
  // of the two MBs left of the segment too (stage: n + 3 ints)
  int luma[(SEG + 1) * 256 + 4];
  int cb_dc[(SEG + 1) * 4 + 4], cr_dc[(SEG + 1) * 4 + 4];
  int cb_ac[(SEG + 1) * 60 + 4], cr_ac[(SEG + 1) * 60 + 4];
  int mv[(SEG + 2) * 2 + 4];
  unsigned win[P_WIN];
  unsigned nz[SEG + 1];                        // cabac_rec::p_nz_bits of each staged MB
  SegHead h;
};

struct PStaged {
  const int *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *mv;
  int lft, mvl;                                // staged MBs before the segment's first
};

// The pieces' context of the segment's MB w (warp w).
__device__ __forceinline__ cabac_rec::PCtx p_seg_ctx(const PSmem& sm, const PStaged& g, int w,
                                                     int c, int nc) {
  const int k = w + g.lft, m = w + g.mvl;
  const cabac_rec::PSum cur = cabac_rec::p_sum_from(sm.nz[k], g.mv[2 * m], g.mv[2 * m + 1]);
  cabac_rec::PSum left{};
  if (c > 0) left = cabac_rec::p_sum_from(sm.nz[k - 1], g.mv[2 * m - 2], g.mv[2 * m - 1]);
  return cabac_rec::p_ctx(cur, c > 0 ? &left : nullptr, c > 1 ? g.mv + 2 * m - 4 : nullptr,
                          c == nc - 1, g.luma + k * 256, g.cb_dc + k * 4, g.cb_ac + k * 60,
                          g.cr_dc + k * 4, g.cr_ac + k * 60);
}

__global__ void __launch_bounds__(NT, 4) p_seg_kernel(const PArgs a) {
  __shared__ __align__(16) PSmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  take_ticket(sm.h, a.S.istate);
  __syncthreads();
  const int r = sm.h.ticket / a.nseg, s = sm.h.ticket - r * a.nseg;
  const int c0 = s * SEG, n = min(SEG, a.nc - c0);
  PStaged g;
  g.lft = c0 > 0 ? 1 : 0;
  g.mvl = min(c0, 2);
  const int ns = n + g.lft;
  const size_t mb = static_cast<size_t>(r) * a.nc + c0 - g.lft;
  g.luma = lookback::stage(sm.luma, a.luma + mb * 256, ns * 256, NT);
  g.cb_dc = lookback::stage(sm.cb_dc, a.cb_dc + mb * 4, ns * 4, NT);
  g.cr_dc = lookback::stage(sm.cr_dc, a.cr_dc + mb * 4, ns * 4, NT);
  g.cb_ac = lookback::stage(sm.cb_ac, a.cb_ac + mb * 60, ns * 60, NT);
  g.cr_ac = lookback::stage(sm.cr_ac, a.cr_ac + mb * 60, ns * 60, NT);
  g.mv = lookback::stage(sm.mv, a.mv + (static_cast<size_t>(r) * a.nc + c0 - g.mvl) * 2,
                         (n + g.mvl) * 2, NT);
  lookback::cp_async_wait();
  __syncthreads();

  // the nonzero flags of each staged MB: lane l tests piece l's block
  for (int k = warp; k < ns; k += SEG) {
    bool nz;
    if (lane < 16)
      nz = cabac_rec::any(g.luma + (k * 16 + lane) * 16, 16);
    else if (lane < 18)
      nz = cabac_rec::any((lane == 16 ? g.cb_dc : g.cr_dc) + k * 4, 4);
    else if (lane < 26)
      nz = cabac_rec::any((lane < 22 ? g.cb_ac : g.cr_ac) + (k * 4 + ((lane - 18) & 3)) * 15, 15);
    else
      nz = false;
    const unsigned bits = __ballot_sync(FULL, nz);
    if (lane == 0) sm.nz[k] = bits;
  }
  __syncthreads();

  // counts: warp w the segment's MB w, lane j its piece j
  const int c = c0 + warp;
  int pbits = 0, poff = 0;
  if (warp < n) {
    bool ovf = false;
    if (lane < cabac_rec::P_PIECES) {
      const cabac_rec::PCtx x = p_seg_ctx(sm, g, warp, c, a.nc);
      CountSink cs;
      ovf = cabac_rec::p_piece(x, lane, cs);
      pbits = static_cast<int>(cs.n);
    }
    poff = piece_offset(pbits, ovf, a.cap, &sm.h.mb_bits[warp], &sm.h.flags);
  }
  __syncthreads();
  if (warp == 0) place(sm.h, a.S, a.out, r, s, a.nseg, a.nr, n, a.slots);
  __syncthreads();

  // the words: each lane ORs its piece's records into the window
  store_segment<P_WIN>(sm.h, sm.win, a.out, a.out_words, a.nr, s, a.S, r, a.nseg,
                       [&](int lead, int nwin, int lo) {
    if (warp < n && lane < cabac_rec::P_PIECES && pbits > 0) {
      const long long p = lead + sm.h.mb_off[warp] + poff - 32LL * lo;
      if (p < 32LL * nwin && p + pbits > 0) {
        const cabac_rec::PCtx x = p_seg_ctx(sm, g, warp, c, a.nc);
        RunSink rs(sm.win, p, nwin);
        cabac_rec::p_piece(x, lane, rs);
        rs.flush();
      }
    }
  });
}

// ---------------------------------------------------------------------------
// K11i

struct IArgs {
  const int *luma_dc, *luma_ac, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *pred_mode, *i4_modes, *luma_i4;
  const uint8_t* mb_i4;
  unsigned* out;
  long long out_words;
  transport::State S;
  int nr, nc, nseg, slots, cap;
};

struct ISmem {
  // the staged levels and I4 modes of the segment's MBs and its left
  // neighbour, the segment's I_16x16 prediction modes
  int luma_dc[(SEG + 1) * 16 + 4], luma_ac[(SEG + 1) * 240 + 4], luma_i4[(SEG + 1) * 256 + 4];
  int cb_dc[(SEG + 1) * 4 + 4], cr_dc[(SEG + 1) * 4 + 4];
  int cb_ac[(SEG + 1) * 60 + 4], cr_ac[(SEG + 1) * 60 + 4];
  int modes[(SEG + 1) * 16 + 4], pm[SEG + 4];
  unsigned win[I_WIN];
  unsigned nz[2][SEG + 1];                     // each staged MB's nonzero words
  unsigned char i4[SEG + 1];
  SegHead h;
};

struct IStaged {
  const int *luma_dc, *luma_ac, *luma_i4, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *modes, *pm;
  int lft;
};

__device__ __forceinline__ cabac_rec::ICtx i_seg_ctx(const ISmem& sm, const IStaged& g, int w,
                                                     int c, int nc) {
  const int k = w + g.lft;
  const cabac_rec::ISum cur = cabac_rec::i_sum_from(sm.nz[0][k], sm.nz[1][k], sm.i4[k]);
  cabac_rec::ISum left{};
  if (c > 0) left = cabac_rec::i_sum_from(sm.nz[0][k - 1], sm.nz[1][k - 1], sm.i4[k - 1]);
  return cabac_rec::i_ctx(cur, c > 0 ? &left : nullptr, c == nc - 1, g.pm[w], g.modes + k * 16,
                          c > 0 ? g.modes + (k - 1) * 16 : nullptr, g.luma_dc + k * 16, g.luma_ac + k * 240,
                          g.luma_i4 + k * 256, g.cb_dc + k * 4, g.cb_ac + k * 60,
                          g.cr_dc + k * 4, g.cr_ac + k * 60);
}

__global__ void __launch_bounds__(NT, 4) i_seg_kernel(const IArgs a) {
  __shared__ __align__(16) ISmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  take_ticket(sm.h, a.S.istate);
  __syncthreads();
  const int r = sm.h.ticket / a.nseg, s = sm.h.ticket - r * a.nseg;
  const int c0 = s * SEG, n = min(SEG, a.nc - c0);
  IStaged g;
  g.lft = c0 > 0 ? 1 : 0;
  const int ns = n + g.lft;
  const size_t mb = static_cast<size_t>(r) * a.nc + c0 - g.lft;
  g.luma_dc = lookback::stage(sm.luma_dc, a.luma_dc + mb * 16, ns * 16, NT);
  g.luma_ac = lookback::stage(sm.luma_ac, a.luma_ac + mb * 240, ns * 240, NT);
  g.luma_i4 = lookback::stage(sm.luma_i4, a.luma_i4 + mb * 256, ns * 256, NT);
  g.cb_dc = lookback::stage(sm.cb_dc, a.cb_dc + mb * 4, ns * 4, NT);
  g.cr_dc = lookback::stage(sm.cr_dc, a.cr_dc + mb * 4, ns * 4, NT);
  g.cb_ac = lookback::stage(sm.cb_ac, a.cb_ac + mb * 60, ns * 60, NT);
  g.cr_ac = lookback::stage(sm.cr_ac, a.cr_ac + mb * 60, ns * 60, NT);
  g.modes = lookback::stage(sm.modes, a.i4_modes + mb * 16, ns * 16, NT);
  g.pm = lookback::stage(sm.pm, a.pred_mode + mb + g.lft, n, NT);
  if (tid < ns) sm.i4[tid] = a.mb_i4[mb + tid];
  lookback::cp_async_wait();
  __syncthreads();

  // the nonzero words of each staged MB, two ballots (cabac_rec::i_lane_nz)
  for (int k = warp; k < ns; k += SEG) {
    const int* ldc = g.luma_dc + k * 16;
    const int* lac = g.luma_ac + k * 240;
    const int* li4 = g.luma_i4 + k * 256;
    const int *cbd = g.cb_dc + k * 4, *cba = g.cb_ac + k * 60;
    const int *crd = g.cr_dc + k * 4, *cra = g.cr_ac + k * 60;
    const unsigned w0 =
        __ballot_sync(FULL, cabac_rec::i_lane_nz(0, lane, ldc, lac, li4, cbd, cba, crd, cra));
    const unsigned w1 =
        __ballot_sync(FULL, cabac_rec::i_lane_nz(1, lane, ldc, lac, li4, cbd, cba, crd, cra));
    if (lane == 0) {
      sm.nz[0][k] = w0;
      sm.nz[1][k] = w1;
    }
  }
  __syncthreads();

  // counts: warp w the segment's MB w, lane j its piece j
  const int c = c0 + warp;
  int pbits = 0, poff = 0;
  if (warp < n) {
    const cabac_rec::ICtx x = i_seg_ctx(sm, g, warp, c, a.nc);
    CountSink cs;
    const bool ovf = cabac_rec::i_piece(x, lane, cs);
    pbits = static_cast<int>(cs.n);
    poff = piece_offset(pbits, ovf, a.cap, &sm.h.mb_bits[warp], &sm.h.flags);
  }
  __syncthreads();
  if (warp == 0) place(sm.h, a.S, a.out, r, s, a.nseg, a.nr, n, a.slots);
  __syncthreads();

  store_segment<I_WIN>(sm.h, sm.win, a.out, a.out_words, a.nr, s, a.S, r, a.nseg,
                       [&](int lead, int nwin, int lo) {
    if (warp < n && pbits > 0) {
      const long long p = lead + sm.h.mb_off[warp] + poff - 32LL * lo;
      if (p < 32LL * nwin && p + pbits > 0) {
        const cabac_rec::ICtx x = i_seg_ctx(sm, g, warp, c, a.nc);
        RunSink rs(sm.win, p, nwin);
        cabac_rec::i_piece(x, lane, rs);
        rs.flush();
      }
    }
  });
}

// The transport's words at ``cap`` words an MB, the buffer's state behind
// them, zeroed by one memset; then ``launch(out_words, state)``.
template <class Launch>
int with_state(int* buf, int nr, int nc, int cap, cudaStream_t stream, Launch launch) {
  if (nr <= 0 || nc <= 0) return 0;
  if (cap <= 0) return cudaErrorInvalidValue;
  const long long out_words = transport::META_WORDS + nr + static_cast<long long>(nr) * nc * cap;
  if (static_cast<long long>(nr) * segments(nc) > 0x7fffffffLL) return cudaErrorInvalidValue;
  transport::State S;
  size_t bytes;
  int e;
  if ((e = transport::state_at(buf, out_words, nr, segments(nc), &S, &bytes))) return e;
  if ((e = cudaMemsetAsync(S.istate, 0, bytes, stream))) return e;
  launch(out_words, S, static_cast<unsigned>(static_cast<long long>(nr) * segments(nc)));
  return dngd_last_error();
}

}  // namespace

// The int32 words of the buffer binarize_p_launch and binarize_intra_launch
// take (ops/cabac_binarize.py sizes its one allocation by this call): the
// transport of ``out_words`` words, then the look-back state.
extern "C" long long binarize_buffer_words(long long out_words, int nr, int nc) {
  return transport::buffer_words(out_words, nr, segments(nc));
}

// buf: binarize_buffer_words(out_words, nr, nc) int32: the transport
// (header + rows + nr * nc * cap words, the words past the payload left
// as they were), then the state, zeroed here by one memset.  slots: the
// header's record-slot count; cap: words per MB (static bound).
extern "C" int binarize_p_launch(const int* mv, const int* luma, const int* cb_dc,
                                 const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                 int* buf, int nr, int nc, int slots, int cap,
                                 cudaStream_t stream) {
  return with_state(buf, nr, nc, cap, stream,
                    [&](long long out_words, const transport::State& S, unsigned ctas) {
    const PArgs a{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, reinterpret_cast<unsigned*>(buf),
                  out_words, S, nr, nc, segments(nc), slots, cap};
    p_seg_kernel<<<ctas, NT, 0, stream>>>(a);
  });
}

// As binarize_p_launch, for an I picture: mb_i4 one byte an MB.
extern "C" int binarize_intra_launch(const int* luma_dc, const int* luma_ac, const int* cb_dc,
                                     const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                     const int* pred_mode, const uint8_t* mb_i4,
                                     const int* i4_modes, const int* luma_i4, int* buf, int nr,
                                     int nc, int slots, int cap, cudaStream_t stream) {
  return with_state(buf, nr, nc, cap, stream,
                    [&](long long out_words, const transport::State& S, unsigned ctas) {
    const IArgs a{luma_dc,  luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                  i4_modes, luma_i4, mb_i4, reinterpret_cast<unsigned*>(buf), out_words,
                  S,        nr,      nc,    segments(nc), slots, cap};
    i_seg_kernel<<<ctas, NT, 0, stream>>>(a);
  });
}
