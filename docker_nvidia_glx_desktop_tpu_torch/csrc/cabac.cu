// K11i / K11p — CABAC binarization and context-index derivation: a frame's
// levels (and modes or motion vectors) -> the version-2 transport of
// (bin, ctxIdx, bypass) records, per-row bit counts in the header.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/cabac_binarize.py:490
// binarize_intra and :415 binarize_p (their _pack_stream :368 on the
// ops/bitmerge.py trees).  Header and payload prefix equal the
// reference's word for word; the overflow flag trips where it does (a
// level or mvd beyond its bypass budget, an MB above the static cap of
// ``cap`` words).
//
// What bounds it: bytes (the levels are read once: ~21 MB intra, ~13 MB
// P at 1080p).
//
// K11i, as first written: under slice-per-MB-row each MB's records depend
// only on its own levels and its left MB's inputs, so (1) one thread per
// MB walks the syntax (csrc/cabac_records.cuh) and writes its records as
// a bit string into its own ``cap``-word slot of the scratch buffer,
// counting its bits; (2) one thread per row scans the MB bit counts, one
// thread the rows, and writes the header (transport.cuh); (3) a warp per
// MB shifts its bit string into place in the row payload.  Its serial
// walk, not the bytes, bounds it.
//
// K11p (redesigned for Hopper): one memset of the look-back state (a
// ticket, the flags, the rows' word counts, a status word a segment) and
// one launch, no scratch; the words past the payload are left as they
// were.  A CTA takes a segment of SEGP MBs of one row by an atomic ticket:
//  - it stages the segment's levels and mvs, and its left MB's, by 16-byte
//    cp.async (lookback.cuh);
//  - a warp an MB: a ballot over its blocks gives each staged MB's nonzero
//    word (cabac_rec::p_nz_bits: the coded_block_flag contexts of the MB
//    and, for the next MB, of its left neighbour; the top MB is never
//    available under a slice per row);
//  - lane k walks piece k of the MB (cabac_rec::p_piece: the skip flag and
//    mb_type, each mvd component, the CBP and mb_qp_delta, each of the 16
//    luma and 10 chroma blocks, end_of_slice) and counts its bits; a warp
//    scan gives each piece's offset, a vote the value overflow (bit 0), the
//    MB's total against ``cap`` bit 1;
//  - warp 0 scans the MBs' bits, publishes the segment's bits and looks
//    back over the row's earlier segments; the row's last segment writes
//    its row's bit count and publishes its row's words before it waits on
//    any other row; the last row's last segment writes the header;
//  - each lane walks its piece again into a window of the segment's words
//    in shared memory (RunSink: whole words stored, the edge
//    words ORed), and the CTA stores the words
//    coalesced: the last word by a plain store before the segment is DONE,
//    the first one, when it holds earlier bits, ORed after the predecessor
//    is DONE (lookback.cuh), so nothing but the state is zeroed.  Words
//    past the buffer (only where an MB passes its cap) are dropped.
#include "cabac_records.cuh"
#include "lookback.cuh"
#include "transport.cuh"

namespace {

constexpr int WALK_THREADS = 64;
constexpr int WARPS = 8;

struct Scratch {
  uint32_t* mb_words;  // [nmb * cap]
  int* mb_bits;        // [nmb]
  int* mb_off;         // [nmb]
  int* row_woff;       // [nr]
  int* flag;           // [1]: bit 0 value overflow, bit 1 an MB above its cap
  Scratch(int* s, int nmb, int nr, int cap)
      : mb_words(reinterpret_cast<uint32_t*>(s)), mb_bits(s + (size_t)nmb * cap),
        mb_off(mb_bits + nmb), row_woff(mb_off + nmb), flag(row_woff + nr) {}
};

__device__ __forceinline__ bool walk(const cabac_rec::IIn& in, int r, int c,
                                     cabac_rec::WordSink& sink) {
  return cabac_rec::intra_mb(in, r, c, sink);
}

template <class In>
__global__ void __launch_bounds__(WALK_THREADS) records_kernel(In in, int nr, int cap, Scratch S) {
  const int mb = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (mb >= nr * in.nc) return;
  cabac_rec::WordSink sink(S.mb_words + (size_t)mb * cap, cap);
  const bool ovf = walk(in, mb / in.nc, mb % in.nc, sink);
  sink.flush();
  S.mb_bits[mb] = (int)sink.n;
  const int f = (ovf ? 1 : 0) | (sink.n > 32LL * cap ? 2 : 0);
  if (f) atomicOr(S.flag, f);
}

// Warp per MB: the MB's bit string, from bit 0 of its scratch slot, is
// shifted to its bit offset in the transport.  Skipped when an MB ran
// over its cap (the offsets could then pass the buffer; the flag sends
// the caller to the dense path).
__global__ void __launch_bounds__(32 * WARPS) place_kernel(int nr, int nc, int cap, Scratch S,
                                                           unsigned* out) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (mb >= nr * nc || (*S.flag & 2)) return;
  const long long base = transport::mb_bit_base(S.mb_off, S.row_woff, mb, mb / nc, nr);
  const int lead = (int)(base & 31), bits = S.mb_bits[mb];
  const int nsrc = (bits + 31) >> 5, nwords = (lead + bits + 31) >> 5;
  const uint32_t* src = S.mb_words + (size_t)mb * cap;
  const long long w0 = base >> 5;
  for (int i = lane; i < nwords; i += 32) {
    const uint32_t lo = i < nsrc ? src[i] : 0u;
    const uint32_t hi = (i > 0 && i - 1 < nsrc) ? src[i - 1] : 0u;
    const uint32_t w = lead ? (hi << (32 - lead)) | (lo >> lead) : lo;
    if (i == 0 || i == nwords - 1)
      atomicOr(out + w0 + i, w);
    else
      out[w0 + i] = w;
  }
}

template <class In>
int run(const In& in, unsigned* out, int* scratch, int nr, int nc, int slots, int cap,
        cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  const int nmb = nr * nc;
  Scratch S(scratch, nmb, nr, cap);
  int e;
  if ((e = cudaMemsetAsync(S.flag, 0, sizeof(int), stream))) return e;
  if ((e = cudaMemsetAsync(out + transport::META_WORDS + nr, 0, (size_t)nmb * cap * 4, stream)))
    return e;
  records_kernel<In><<<(nmb + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0, stream>>>(
      in, nr, cap, S);
  if ((e = dngd_last_error())) return e;
  transport::row_scan_kernel<<<1, 1024, 0, stream>>>(S.mb_bits, S.mb_off, S.row_woff, S.flag,
                                                     out, nr, nc, 2, slots);
  if ((e = dngd_last_error())) return e;
  place_kernel<<<(nmb + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(nr, nc, cap, S, out);
  return dngd_last_error();
}

// ---------------------------------------------------------------------------
// K11p: a segment of SEGP MBs of one row a CTA, a warp an MB, a lane a piece.

constexpr int SEGP = 8;                        // MBs a segment, a warp each
constexpr int P_NT = 32 * SEGP;
constexpr int P_WIN = 8192;                    // a window of the segment's words: SEGP MBs at the P cap (981 words)
using lookback::FULL;

struct PArgs {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  unsigned* out;                               // the transport
  long long out_words;                         // its length
  int* istate;                                 // [0] ticket, [1] flags
  unsigned long long* row_pub;                 // the rows' words, published (INCL)
  unsigned long long* st;                      // a status word a segment, [nr][nseg]
  int nr, nc, nseg, slots, cap;
};

struct PSmem {
  // the staged levels of the segment's MBs and its left neighbour; the mv
  // of the two MBs left of the segment too (stage: n + 3 ints)
  int luma[(SEGP + 1) * 256 + 4];
  int cb_dc[(SEGP + 1) * 4 + 4], cr_dc[(SEGP + 1) * 4 + 4];
  int cb_ac[(SEGP + 1) * 60 + 4], cr_ac[(SEGP + 1) * 60 + 4];
  int mv[(SEGP + 2) * 2 + 4];
  unsigned win[P_WIN];
  unsigned nz[SEGP + 1];                       // cabac_rec::p_nz_bits of each staged MB
  int mb_bits[SEGP], mb_off[SEGP];
  long long excl, roww;
  int ticket, flags, seg_bits;
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

__global__ void __launch_bounds__(P_NT, 4) p_seg_kernel(const PArgs a) {
  __shared__ __align__(16) PSmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    sm.ticket = atomicAdd(a.istate, 1);
    sm.flags = 0;
  }
  __syncthreads();
  const int r = sm.ticket / a.nseg, s = sm.ticket - r * a.nseg;
  const int c0 = s * SEGP, n = min(SEGP, a.nc - c0);
  PStaged g;
  g.lft = c0 > 0 ? 1 : 0;
  g.mvl = min(c0, 2);
  const int ns = n + g.lft;
  const size_t mb = static_cast<size_t>(r) * a.nc + c0 - g.lft;
  g.luma = lookback::stage(sm.luma, a.luma + mb * 256, ns * 256, P_NT);
  g.cb_dc = lookback::stage(sm.cb_dc, a.cb_dc + mb * 4, ns * 4, P_NT);
  g.cr_dc = lookback::stage(sm.cr_dc, a.cr_dc + mb * 4, ns * 4, P_NT);
  g.cb_ac = lookback::stage(sm.cb_ac, a.cb_ac + mb * 60, ns * 60, P_NT);
  g.cr_ac = lookback::stage(sm.cr_ac, a.cr_ac + mb * 60, ns * 60, P_NT);
  g.mv = lookback::stage(sm.mv, a.mv + (static_cast<size_t>(r) * a.nc + c0 - g.mvl) * 2,
                         (n + g.mvl) * 2, P_NT);
  lookback::cp_async_wait();
  __syncthreads();

  // the nonzero flags of each staged MB: lane l tests piece l's block
  for (int k = warp; k < ns; k += SEGP) {
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
    int incl = pbits;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    poff = incl - pbits;
    const int mbits = __shfl_sync(FULL, incl, 31);
    const int f = (__any_sync(FULL, ovf) ? 1 : 0) | (mbits > 32LL * a.cap ? 2 : 0);
    if (lane == 0) {
      sm.mb_bits[warp] = mbits;
      if (f) atomicOr(&sm.flags, f);
    }
  }
  __syncthreads();

  unsigned long long* st = a.st + static_cast<size_t>(r) * a.nseg;
  unsigned long long* row_pub = a.row_pub;
  const bool last = s == a.nseg - 1;
  if (warp == 0) {
    const int b = lane < n ? sm.mb_bits[lane] : 0;
    int x = b;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane < n) sm.mb_off[lane] = x - b;
    const int seg_bits = __shfl_sync(FULL, x, 31);
    if (lane == 0 && sm.flags) atomicOr(a.istate + 1, sm.flags);
    long long excl = 0;
    if (s == 0) {
      if (lane == 0) lookback::publish(st, seg_bits, lookback::INCL);
    } else {
      if (lane == 0) lookback::publish(st + s, seg_bits, lookback::AGG);
      excl = lookback::look_back(st, s);
      if (lane == 0) lookback::publish(st + s, excl + seg_bits, lookback::INCL);
    }
    // the row's last segment publishes its row's words before it waits on
    // any other row, then every segment sums the earlier rows' words
    const long long row_bits = excl + seg_bits;
    const long long row_words = (row_bits + 31) >> 5;
    if (last && lane == 0) {
      a.out[transport::META_WORDS + r] = static_cast<unsigned>(row_bits);
      lookback::publish(row_pub + r, row_words, lookback::INCL);
    }
    long long w = 0;
    for (int q = lane; q < r; q += 32) w += lookback::wait_for(row_pub + q, lookback::INCL) >> 2;
    w = lookback::warp_sum(w);
    __syncwarp();
    if (lane == 0) {
      if (last && r == a.nr - 1) {
        const int flags = atomicOr(a.istate + 1, 0);
        unsigned* h = a.out;
        h[0] = 2u;
        h[1] = flags ? 1u : 0u;
        h[2] = static_cast<unsigned>(w + row_words);
        h[3] = static_cast<unsigned>(a.nr);
        h[4] = static_cast<unsigned>(a.slots);
        h[5] = h[6] = h[7] = 0u;
      }
      sm.excl = excl;
      sm.roww = w;
      sm.seg_bits = seg_bits;
    }
  }
  __syncthreads();

  // the words: windows of P_WIN, each lane ORing its piece's records into
  // shared memory, stored with the edge words in SegmentStore's order
  const long long excl = sm.excl;
  const long long w0 = transport::META_WORDS + a.nr + sm.roww;
  lookback::SegmentStore<lookback::Plain> out(a.out + w0, a.out_words - w0, excl, sm.seg_bits);
  for (int lo = 0; lo < out.nwords; lo += P_WIN) {
    const int nwin = min(out.nwords - lo, P_WIN);
    for (int i = tid; i < nwin; i += P_NT) sm.win[i] = 0;
    __syncthreads();
    if (warp < n && lane < cabac_rec::P_PIECES && pbits > 0) {
      const long long p = out.lead + sm.mb_off[warp] + poff - 32LL * lo;
      if (p < 32LL * nwin && p + pbits > 0) {
        const cabac_rec::PCtx x = p_seg_ctx(sm, g, warp, c, a.nc);
        RunSink rs(sm.win, p, nwin);
        cabac_rec::p_piece(x, lane, rs);
        rs.flush();
      }
    }
    __syncthreads();
    out.store(sm.win, lo, nwin, P_NT);
    __syncthreads();
  }
  if (tid == 0) out.finish(st, s, excl + sm.seg_bits);
}

inline int p_segments(int nc) { return (nc + SEGP - 1) / SEGP; }

// The look-back state behind a transport of ``out_words`` words: the
// ticket and the flags (int32), then, 8-byte aligned (this int32 offset),
// the rows' and the segments' status words.
inline size_t p_status_offset(size_t out_words) { return (out_words + 3) & ~static_cast<size_t>(1); }

}  // namespace

// The int32 words of the buffer binarize_p_launch takes
// (ops/cabac_binarize.py sizes its one allocation by this call): the
// transport of ``out_words`` words, then the look-back state.
extern "C" long long binarize_p_buffer_words(long long out_words, int nr, int nc) {
  return static_cast<long long>(p_status_offset(out_words) +
                                2 * static_cast<size_t>(nr) * (1 + p_segments(nc)));
}

// buf: binarize_p_buffer_words(out_words, nr, nc) int32: the transport
// (header + rows + nr * nc * cap words, the words past the payload left
// as they were), then the state, zeroed here by one memset.  slots: the
// header's record-slot count; cap: words per MB (static bound).
extern "C" int binarize_p_launch(const int* mv, const int* luma, const int* cb_dc,
                                 const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                 int* buf, int nr, int nc, int slots, int cap,
                                 cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  if (cap <= 0) return cudaErrorInvalidValue;
  PArgs a{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, reinterpret_cast<unsigned*>(buf), 0, nullptr,
          nullptr, nullptr, nr, nc, p_segments(nc), slots, cap};
  a.out_words = transport::META_WORDS + nr + static_cast<long long>(nr) * nc * cap;
  a.istate = buf + a.out_words;
  a.row_pub = reinterpret_cast<unsigned long long*>(buf + p_status_offset(a.out_words));
  a.st = a.row_pub + nr;
  if (reinterpret_cast<uintptr_t>(a.row_pub) & 7) return cudaErrorMisalignedAddress;
  const long long ctas = static_cast<long long>(nr) * a.nseg;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t state_bytes = 4 * (p_status_offset(a.out_words) - a.out_words) +
                             8 * (static_cast<size_t>(nr) + static_cast<size_t>(ctas));
  int e;
  if ((e = cudaMemsetAsync(a.istate, 0, state_bytes, stream))) return e;
  p_seg_kernel<<<static_cast<unsigned>(ctas), P_NT, 0, stream>>>(a);
  return dngd_last_error();
}

extern "C" int binarize_intra_launch(const int* luma_dc, const int* luma_ac, const int* cb_dc,
                                     const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                     const int* pred_mode, const uint8_t* mb_i4,
                                     const int* i4_modes, const int* luma_i4, unsigned* out,
                                     int* scratch, int nr, int nc, int slots, int cap,
                                     cudaStream_t stream) {
  const cabac_rec::IIn in{luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                          mb_i4,   i4_modes, luma_i4, nc};
  return run(in, out, scratch, nr, nc, slots, cap, stream);
}
