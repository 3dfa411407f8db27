// K10 — level transport of the CABAC path: a frame's quantized level
// slots (MB by MB in wire order) -> the version-1 uint32 transport.  Each
// zero slot codes as "0", each nonzero one as "1" + its 15-bit two's
// complement; an MB row is one MSB-first bit string starting on a word
// boundary; a value outside -16384..16383 sets the overflow flag.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/level_pack.py:131
// pack_levels (its body _pack :83, on the ops/bitmerge.py trees).  The
// header and the payload equal the reference's word for word; the words
// past the payload are left as they were (transport.cuh).
//
// What bounds it: bytes.  It reads the level tensors once (20.9 MB of
// intra levels, 12.5 MB of P levels at 1080p) and writes ~1 bit per zero
// slot.
//
// Designed for Hopper: one memset of the look-back state (transport.cuh)
// and one launch.  A CTA takes a segment of SEGL MBs of one row by an
// atomic ticket and stages the segment's slots in wire order, key by key,
// into shared memory by 16-byte cp.async (the levels are read once).  A
// warp an MB counts its bits 32 slots at a time (a ballot of the nonzero
// slots: the slots plus 15 x its popcount) and votes the value range;
// warp 0 places the segment (transport::place_segment: a look-back over
// the row's earlier segments, the row's words published by its last
// segment, the header by the last row's last segment); then each lane ORs
// its nonzero slot's 16-bit code into a shared window of the segment's
// words (its position from the ballot and the chunk's first bit, both
// kept from the counts: the lanes before it plus 15 x their nonzero count;
// an all-zero chunk costs nothing), and the CTA stores the window
// coalesced with the edge words in lookback.cuh SegmentStore's order, so
// nothing but the state is zeroed.  The window (5 KB) holds a desktop
// frame's segment whole; a dense segment takes two or three windows,
// which keeps the shared memory under 27 KB a CTA, eight CTAs an SM, and
// a 1080p frame's segments in one wave.
#include "transport.cuh"

namespace {

constexpr int MAX_KEYS = 7;
constexpr int SEGL = 8;                        // MBs a segment, a warp each
constexpr int NT = 32 * SEGL;
constexpr int MAX_SLOTS = 640;                 // INTRA_KEYS (P_KEYS: 384)
constexpr int STAGE_INTS = SEGL * MAX_SLOTS;
constexpr int MAX_CH = (MAX_SLOTS + 31) / 32;  // 32-slot chunks an MB
constexpr int WIN = 1280;                      // a window of a segment's words (a desktop's fit one)
constexpr int MIN_CTAS = 8;                    // 8 CTAs an SM: a 1080p frame's 1020 segments at once
using lookback::FULL;

struct Keys {
  const int* p[MAX_KEYS];
  int n[MAX_KEYS];
  int s;                                       // slots per MB
};

struct LArgs {
  Keys K;
  unsigned* out;
  long long out_words;
  transport::State S;
  int nr, nc, nseg;
};

inline int segments(int nc) { return (nc + SEGL - 1) / SEGL; }

// The segment's n MBs of each key, into ``lv`` in wire order (MB w's slot
// k at lv[w * K.s + k]): by 16-byte cp.async where the key's rows and
// places allow it, else by 4-byte ones.
__device__ __forceinline__ void stage_slots(int* lv, const Keys& K, size_t mb, int n) {
  int base = 0;
#pragma unroll
  for (int j = 0; j < MAX_KEYS; ++j) {
    const int nj = K.n[j];
    if (nj > 0) {
      const int* src = K.p[j] + mb * nj;
      if (((reinterpret_cast<uintptr_t>(src) | nj | K.s | base) & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int q = nj >> 2;
        for (int u = threadIdx.x; u < n * q; u += NT) {
          const int w = u / q, e = 4 * (u - w * q);
          lookback::cp_async16(lv + w * K.s + base + e, src + w * nj + e);
        }
      } else {
        for (int u = threadIdx.x; u < n * nj; u += NT) {
          const int w = u / nj;
          lookback::cp_async4(lv + w * K.s + base + (u - w * nj), src + u);
        }
      }
      base += nj;
    }
  }
}

__global__ void __launch_bounds__(NT, MIN_CTAS) seg_kernel(const LArgs a) {
  __shared__ __align__(16) int lv[STAGE_INTS];
  __shared__ unsigned win[WIN];
  __shared__ unsigned nzm[SEGL][MAX_CH];       // each chunk's ballot of its nonzeros
  __shared__ short cbit[SEGL][MAX_CH];         // and its first bit in the MB
  __shared__ long long excl_s, roww_s;
  __shared__ int ticket, flags, seg_bits_s, mb_bits[SEGL], mb_off[SEGL];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    ticket = atomicAdd(a.S.istate, 1);
    flags = 0;
  }
  __syncthreads();
  const int r = ticket / a.nseg, s = ticket - r * a.nseg;
  const int c0 = s * SEGL, n = min(SEGL, a.nc - c0);
  const size_t mb = static_cast<size_t>(r) * a.nc + c0;
  const Keys& K = a.K;
  stage_slots(lv, K, mb, n);
  lookback::cp_async_wait();
  __syncthreads();

  // counts: a ballot of each 32 slots' nonzeros, kept for the codes
  const int nch = (K.s + 31) >> 5;
  if (warp < n) {
    int bits = 0;
    bool ovf = false;
    for (int t = 0; t < nch; ++t) {
      const int k = t * 32 + lane;
      const int v = k < K.s ? lv[warp * K.s + k] : 0;
      ovf |= v > 16383 || v < -16384;
      const unsigned nz = __ballot_sync(FULL, v != 0);
      if (lane == 0) {
        nzm[warp][t] = nz;
        cbit[warp][t] = static_cast<short>(bits);
      }
      bits += min(32, K.s - t * 32) + 15 * __popc(nz);
    }
    if (__any_sync(FULL, ovf) && lane == 0) atomicOr(&flags, 1);
    if (lane == 0) mb_bits[warp] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    const transport::Place pl = transport::place_segment(
        a.S, a.out, r, s, a.nseg, a.nr, 1, K.s, lane < n ? mb_bits[lane] : 0, lane < n, mb_off,
        flags);
    if (lane == 0) {
      excl_s = pl.excl;
      roww_s = pl.row_words;
      seg_bits_s = pl.seg_bits;
    }
  }
  __syncthreads();

  // the codes: ORed into a window of WIN words, the segment window by
  // window (one window but where a segment is dense)
  const long long w0 = transport::META_WORDS + a.nr + roww_s;
  lookback::SegmentStore<lookback::Plain> st(a.out + w0, a.out_words - w0, excl_s, seg_bits_s);
  for (int lo = 0; lo < st.nwords; lo += WIN) {
    const int nwin = min(st.nwords - lo, WIN);
    for (int i = tid; i < nwin; i += NT) win[i] = 0;
    __syncthreads();
    if (warp < n) {
      const int pos = st.lead + mb_off[warp] - 32 * lo;  // the MB's first bit in the window
      for (int t = 0; t < nch; ++t) {                      // a chunk: at most 512 bits
        const unsigned nz = nzm[warp][t];
        const int p0 = pos + cbit[warp][t];
        if (p0 >= 32 * nwin) break;
        if (((nz >> lane) & 1u) && p0 + 512 > 0) {
          const int v = lv[warp * K.s + t * 32 + lane];
          const int p = p0 + lane + 15 * __popc(nz & ((1u << lane) - 1u));
          const unsigned code = 0x8000u | (static_cast<unsigned>(v) & 0x7FFFu);
          const int w = p >> 5, sh = p & 31;       // w < 0: the code starts before the window
          if (sh <= 16) {
            if (w >= 0 && w < nwin) atomicOr(win + w, code << (16 - sh));
          } else {
            if (w >= 0 && w < nwin) atomicOr(win + w, code >> (sh - 16));
            if (w + 1 >= 0 && w + 1 < nwin) atomicOr(win + w + 1, code << (48 - sh));
          }
        }
      }
    }
    __syncthreads();
    st.store(win, lo, nwin, NT);
    __syncthreads();
  }
  if (tid == 0) st.finish(a.S.st + static_cast<size_t>(r) * a.nseg, s, excl_s + seg_bits_s);
}

}  // namespace

// The int32 words of the buffer level_pack_launch takes
// (ops/level_pack.py sizes its one allocation by this call): the
// transport of ``out_words`` words, then the look-back state.
extern "C" long long level_pack_buffer_words(long long out_words, int nr, int nc) {
  return transport::buffer_words(out_words, nr, segments(nc));
}

// p0..p6: the level tensors in wire order (null past the last key), n0..n6
// their slots per MB (at most MAX_SLOTS in all).  buf:
// level_pack_buffer_words(out_words, nr, nc) int32, out_words = META_WORDS
// + nr + nr * nc * slots / 2: the transport (the words past the payload
// left as they were), then the state, zeroed here by one memset.
extern "C" int level_pack_launch(const int* p0, const int* p1, const int* p2, const int* p3,
                                 const int* p4, const int* p5, const int* p6, int* buf, int nr,
                                 int nc, int n0, int n1, int n2, int n3, int n4, int n5, int n6,
                                 cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  LArgs a{{{p0, p1, p2, p3, p4, p5, p6}, {n0, n1, n2, n3, n4, n5, n6}, 0},
          reinterpret_cast<unsigned*>(buf), 0, {}, nr, nc, segments(nc)};
  for (int j = 0; j < MAX_KEYS; ++j) {
    if (a.K.n[j] < 0 || (a.K.n[j] > 0 && !a.K.p[j])) return cudaErrorInvalidValue;
    a.K.s += a.K.n[j];
  }
  if (a.K.s <= 0 || a.K.s > MAX_SLOTS) return cudaErrorInvalidValue;
  if (static_cast<long long>(nr) * a.nseg > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.out_words = transport::META_WORDS + nr + static_cast<long long>(nr) * nc * a.K.s / 2;
  size_t bytes;
  int e;
  if ((e = transport::state_at(buf, a.out_words, nr, a.nseg, &a.S, &bytes))) return e;
  if ((e = cudaMemsetAsync(a.S.istate, 0, bytes, stream))) return e;
  seg_kernel<<<static_cast<unsigned>(static_cast<long long>(nr) * a.nseg), NT, 0, stream>>>(a);
  return dngd_last_error();
}
