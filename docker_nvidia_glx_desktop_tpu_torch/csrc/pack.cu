// K3 — bit packer: a frame's CAVLC codeword slots -> the flat buffer of
// row RBSPs (4-byte aligned) behind a metadata header of big-endian words.
// K7 — the same for P slices: the MB header piece in place of the MB
// syntax, 26 blocks per MB, and each row's trailing skip-run piece after
// its MBs.
//
// K3 replaces docker_nvidia_glx_desktop_tpu/ops/cavlc_device.py:629
// pack_frame with ops/bitmerge.py slots_to_words :87, merge_pieces_dense
// :107, merge_pieces_tree :157, the row compaction and META :681-714;
// K7 replaces ops/cavlc_p_device.py:298 pack_p_frame.
// The bytes up to META_WORDS*4 + 4*total_words equal the reference's, and
// the overflow flag trips at the same caps (256-bit block and MB syntax
// or header, 2048-bit MB, FLAT_CAP_WORDS in all).  tune=hq: the frame's
// qp sum, when given, goes to META_QP_SUM_WORD (cavlc_device.py:707-708),
// and K7 takes the I16-in-P layout of 27 blocks (a template instance).
//
// What bounds it: bytes.  It reads the slot lengths once (~30 MB at
// 1080p), the values only where a length is non-zero, and writes ~0.5 MB.
// Design (redesigned for Hopper): a memset of the flat buffers and of the
// look-back state behind them, then one launch.  A CTA takes a segment of
// SEG MBs of one row, its index from an atomic ticket (so every segment it
// waits on has started):
//  - it stages the segment's lengths, one contiguous span, into shared
//    memory with 16-byte cp.async copies;
//  - a warp an MB, a lane a piece (MB syntax or header, then the blocks),
//    sums the lengths and marks the live slots; a warp scan gives the
//    pieces' offsets, a vote the caps' overflow (an atomicOr on the
//    big-endian flag word);
//  - warp 0 scans the segment's MBs and publishes the segment's bits.  It
//    then reads the bits of the row's earlier segments (the row's header
//    first) and the word counts of the earlier rows: the row's last
//    segment publishes its row's words as soon as it has its row's bits,
//    before it waits on any other row, so no wait is more than two deep.
//    The row's last segment also writes the row's metadata words, the
//    last row's the total (and the FLAT_CAP_WORDS flag), the session's
//    first segment the qp sum;
//  - every lane walks its piece's live slots only, BATCH values in flight
//    at a time (a desktop's pieces hold a few codewords of their 34
//    slots), and ORs the codewords into the segment's words in shared
//    memory; warp 0's spare lanes place the slice header and the trailing
//    run, stop bit and pad;
//  - the CTA stores its words byte-swapped and coalesced.  Only the
//    segment's first and last words can hold a neighbouring segment's bits
//    too: those two go out by a global atomicOr.  A segment whose words
//    exceed the buffer (only where an MB breaks the 2048-bit cap) runs
//    the placement again window by window.  Words at or past
//    FLAT_CAP_WORDS are dropped; the memset leaves every byte past the
//    stream zero.
// The split (chip_smoke.py k3k7-split) times copies with a stage cut out.
// The memset also resets the ticket and the look-back state, so a graph
// replay starts clean.
#include "common.cuh"
#include "lookback.cuh"

namespace {

using lookback::bswap;
using lookback::cp_async_wait;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOTS = 34, HDR = 3;

// The slice type's layout, a compile-time pair: blocks per MB and slots
// of the MB's first piece (I: 27 blocks, 20 syntax slots; P: 26 blocks,
// 7 header slots).
template <int NB, int NS>
struct Layout {
  static constexpr int blocks = NB, syn = NS, pieces = NB + 1;
};
using ILayout = Layout<27, 20>;
using PLayout = Layout<26, 7>;
using PILayout = Layout<27, 7>;      // P with the I16-in-P DC block (tune=hq)
constexpr int BLOCK_CAP = 256, MB_CAP = 2048;
constexpr int META_WORDS = 1024, MAX_META_ROWS = 510;
constexpr int META_QP_SUM_WORD = 2 + 2 * MAX_META_ROWS;
constexpr int FLAT_CAP_WORDS = 1 << 17;
constexpr int FLAT_BYTES = 4 * (META_WORDS + FLAT_CAP_WORDS);

constexpr int SEG = 8;                         // MBs a CTA, a warp each
constexpr int NT = SEG * 32;
constexpr int MIN_CTAS = 6;                    // CTAs an SM: 40 registers, 32 KB each
constexpr int BATCH = 4;                       // live slots a lane loads at once
// a segment's words within the caps: SEG MBs of 2048 bits, the slice
// header (96), trailing run (32), stop bit and pad (8), and the offset of
// its first bit in its first word (31)
constexpr int BUF_WORDS = SEG * (MB_CAP / 32) + 6;
constexpr int LANE_HDR = 31, LANE_TAIL = 30;   // free lanes of warp 0

// The look-back state behind the sessions' flat buffers, in int32 words:
// [0] the ticket, then per session the segments' published bits (+1, 0
// while unknown; [nr][nseg] in the first nr * nc words) and the rows'
// published words (+1) in the next nr.
__host__ __device__ inline size_t state_words(int nr, int nc, int ns) {
  return 4 + (size_t)ns * ((size_t)nr * nc + nr);
}

// The launch's buffer: ns flats, then the look-back state.
inline size_t buffer_bytes(int nr, int nc, int ns) {
  return (size_t)ns * FLAT_BYTES + 4 * state_words(nr, nc, ns);
}

struct Args {
  const int *values, *lengths, *syn_vals, *syn_lens, *hdr_vals, *hdr_lens;
  const int *run_vals, *run_lens, *qp_sum;      // run_*: P only; qp_sum: or null
  uint8_t* flat;
  int* state;
  int nr, nc, nseg, hdr_step;
};

__device__ __forceinline__ void publish(int* p, int v) { atomicExch(p, v); }

// A published value (its +1 form); a wait that outlasts any possible
// launch traps instead of hanging the card.
__device__ int wait_for(const int* p) {
  unsigned spins = 0;
  int v;
  while ((v = *reinterpret_cast<const volatile int*>(p)) == 0) {
    __nanosleep(64);
    if (++spins > (1u << 24)) __trap();
  }
  return v - 1;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// MSB-first: the codeword's last bit lands at bit (pos + len - 1) of the
// window's words [lo, hi) held in buf (pos counts from the segment's first
// word).
__device__ __forceinline__ void put(unsigned* buf, int lo, int hi, int pos, unsigned v,
                                    int len) {
  const int w = pos >> 5, end = (pos & 31) + len;
  if (end <= 32) {
    if (w >= lo && w < hi) atomicOr(buf + w - lo, v << (32 - end));
  } else {
    if (w >= lo && w < hi) atomicOr(buf + w - lo, v >> (end - 32));
    if (w + 1 >= lo && w + 1 < hi) atomicOr(buf + w + 1 - lo, v << (64 - end));
  }
}

template <class Y>
struct Smem {
  int len[SEG * Y::blocks * SLOTS + 4];         // the staged lengths
  int syn[SEG * Y::syn + 4];
  unsigned buf[BUF_WORDS];                      // a window of the segment's words
  int mb_bits[SEG], mb_off[SEG];
  int ticket, bits, seg_bits, pad, run;
  long long w;
};

// A ticket's segment: session, row, segment of the row, its MBs, and the
// index of its first MB over the stacked sessions.
struct Seg {
  int sess, r, s, n;
  size_t g0;
};

__device__ __forceinline__ Seg locate(const Args& a, int t) {
  Seg g;
  const int per = a.nr * a.nseg;
  g.sess = t / per;
  const int rs = t - g.sess * per;
  g.r = rs / a.nseg;
  g.s = rs - g.r * a.nseg;
  g.n = min(SEG, a.nc - g.s * SEG);
  g.g0 = (size_t)g.sess * a.nr * a.nc + (size_t)g.r * a.nc + (size_t)g.s * SEG;
  return g;
}

// One segment, its lengths staged at L and SL (shared).
template <class Y>
__device__ __forceinline__ void segment(Smem<Y>& sm, const Args& a, const Seg& g, const int* L,
                                        const int* SL) {
  constexpr int NB = Y::blocks, NS = Y::syn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = g.r, s = g.s, n = g.n;
  const size_t nmb = (size_t)a.nr * a.nc;
  const int* hdr_vals = a.hdr_vals + (size_t)g.sess * a.hdr_step + r * HDR;
  const int* hdr_lens = a.hdr_lens + (size_t)g.sess * a.hdr_step + r * HDR;
  unsigned* meta = reinterpret_cast<unsigned*>(a.flat + (size_t)g.sess * FLAT_BYTES);
  int* seg_pub = a.state + 4 + g.sess * (nmb + a.nr) + (size_t)r * a.nseg;
  int* row_pub = a.state + 4 + g.sess * (nmb + a.nr) + nmb;
  const bool first = s == 0, last = s == a.nseg - 1;

  // counts: warp w the segment's MB w, lane j its piece j (m slots)
  const bool own = warp < n && lane < Y::pieces;
  const int m = lane == 0 ? NS : SLOTS;
  const int* pl = lane == 0 ? SL + warp * NS : L + (warp * NB + lane - 1) * SLOTS;
  // the piece's bits, and its live slots as a mask
  int pbits = 0;
  unsigned long long live = 0;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int len = own && k < m ? pl[k] : 0;
    pbits += len;
    if (len) live |= 1ull << k;
  }
  int incl = pbits;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int poff = incl - pbits;
  const int mbits = __shfl_sync(FULL, incl, 31);
  const bool ovf = __any_sync(FULL, pbits > BLOCK_CAP) || mbits > MB_CAP;
  if (lane == 0) {
    sm.mb_bits[warp] = mbits;
    if (ovf) atomicOr(meta, bswap(1u));
  }
  __syncthreads();

  if (warp == 0) {
    const int b = lane < SEG ? sm.mb_bits[lane] : 0;
    int x = b;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane < SEG) sm.mb_off[lane] = x - b;
    const int seg_bits = __shfl_sync(FULL, x, 31);
    if (lane == 0) publish(seg_pub + s, seg_bits + 1);
    // the row's bits before this segment: its header, its earlier segments
    long long before = 0;
    for (int q = lane; q < s; q += 32) before += wait_for(seg_pub + q);
    const int bits = hdr_lens[0] + hdr_lens[1] + hdr_lens[2] + static_cast<int>(warp_sum(before));
    int pad = 0, run = 0, row_bytes = 0, row_words = 0;
    if (last) {
      run = a.run_lens ? a.run_lens[(size_t)g.sess * a.nr + r] : 0;
      const int body = bits + seg_bits + run;
      pad = (8 - ((body + 1) % 8)) % 8;
      row_bytes = (body + pad + 1) / 8;
      row_words = (row_bytes + 3) / 4;
      if (lane == 0) publish(row_pub + r, row_words + 1);
    }
    // the words of the rows before this one
    long long w = 0;
    for (int q = lane; q < r; q += 32) w += wait_for(row_pub + q);
    w = warp_sum(w);
    if (lane == 0) {
      if (last) {
        meta[2 + r] = bswap(static_cast<unsigned>(row_bytes));
        meta[2 + MAX_META_ROWS + r] = bswap(static_cast<unsigned>(w));
        if (r == a.nr - 1) {
          const long long total = w + row_words;
          meta[1] = bswap(static_cast<unsigned>(total));
          if (total > FLAT_CAP_WORDS) atomicOr(meta, bswap(1u));
        }
      }
      if (first && r == 0 && a.qp_sum)
        meta[META_QP_SUM_WORD] = bswap(static_cast<unsigned>(a.qp_sum[g.sess]));
      sm.bits = bits;
      sm.w = w;
      sm.seg_bits = seg_bits;
      sm.pad = pad;
      sm.run = run;
    }
  }
  __syncthreads();

  // the segment's bits of its row: [lo_bit, hi_bit), the header with the
  // first segment, the trailing run, stop bit and pad with the last
  const int bits = sm.bits, seg_bits = sm.seg_bits, pad = sm.pad, run = sm.run;
  const int lo_bit = first ? 0 : bits;
  const int hi_bit = bits + seg_bits + (last ? run + pad + 1 : 0);
  if (hi_bit <= lo_bit) return;                  // P: a segment of skipped MBs
  const int base = lo_bit & ~31;                 // the first word's first bit
  const long long w_first = sm.w + (lo_bit >> 5);
  const int nwords = ((hi_bit - 1) >> 5) - (lo_bit >> 5) + 1;
  const bool shared_first = (lo_bit & 31) != 0;
  const bool shared_last = !last && (hi_bit & 31) != 0;
  unsigned* words = meta + META_WORDS;

  for (int lo = 0; lo < nwords; lo += BUF_WORDS) {
    const int hi = min(nwords, lo + BUF_WORDS);
    for (int i = tid; i < hi - lo; i += NT) sm.buf[i] = 0;
    __syncthreads();
    if (own) {
      // the live slots in order, BATCH values in flight at a time
      const int* pv = lane == 0 ? a.syn_vals + (g.g0 + warp) * NS
                                : a.values + ((g.g0 + warp) * NB + lane - 1) * SLOTS;
      int pos = bits + sm.mb_off[warp] + poff - base;
      for (unsigned long long mk = live; mk;) {
        int ks[BATCH];
        unsigned vs[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          ks[i] = mk ? __ffsll(static_cast<long long>(mk)) - 1 : -1;
          mk &= mk - 1;
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) vs[i] = ks[i] >= 0 ? __ldg(pv + ks[i]) : 0u;
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
          if (ks[i] >= 0) {
            const int len = pl[ks[i]];
            put(sm.buf, lo, hi, pos, vs[i], len);
            pos += len;
          }
      }
    } else if (warp == 0 && lane == LANE_HDR && first) {
      int pos = 0;
      for (int k = 0; k < HDR; ++k) {
        const int len = hdr_lens[k];
        if (len > 0) {
          put(sm.buf, lo, hi, pos, static_cast<unsigned>(hdr_vals[k]), len);
          pos += len;
        }
      }
    } else if (warp == 0 && lane == LANE_TAIL && last) {
      // the trailing skip run (a zero-length piece is skipped: a shift by
      // 32 is undefined), then the rbsp stop bit '1' and zeros to the byte
      const int pos = bits + seg_bits - base;
      if (run > 0)
        put(sm.buf, lo, hi, pos, static_cast<unsigned>(a.run_vals[(size_t)g.sess * a.nr + r]),
            run);
      put(sm.buf, lo, hi, pos + run, 1u << pad, pad + 1);
    }
    __syncthreads();
    for (int i = lo + tid; i < hi; i += NT) {
      const long long k = w_first + i;
      if (k >= FLAT_CAP_WORDS) break;
      const unsigned v = sm.buf[i - lo];
      if ((i == 0 && shared_first) || (i == nwords - 1 && shared_last)) {
        if (v) atomicOr(words + k, bswap(v));
      } else {
        words[k] = bswap(v);
      }
    }
    __syncthreads();
  }
}

template <class Y>
__global__ void __launch_bounds__(NT, MIN_CTAS) seg_kernel(const Args a) {
  __shared__ __align__(16) Smem<Y> sm;
  if (threadIdx.x == 0) sm.ticket = atomicAdd(a.state, 1);
  __syncthreads();
  const Seg g = locate(a, sm.ticket);
  const int* L = lookback::stage(sm.len, a.lengths + g.g0 * Y::blocks * SLOTS,
                                 g.n * Y::blocks * SLOTS, NT);
  const int* SL = lookback::stage(sm.syn, a.syn_lens + g.g0 * Y::syn, g.n * Y::syn, NT);
  cp_async_wait();
  __syncthreads();
  segment(sm, a, g, L, SL);
}

template <class Y>
int pack_launch(Args a, int ns, int hdr_sess, cudaStream_t stream) {
  if (a.nr <= 0 || a.nc <= 0 || ns <= 0 || a.nr > MAX_META_ROWS) return cudaErrorInvalidValue;
  a.nseg = (a.nc + SEG - 1) / SEG;
  a.hdr_step = hdr_sess ? a.nr * HDR : 0;
  a.state = reinterpret_cast<int*>(a.flat + (size_t)ns * FLAT_BYTES);
  const long long ctas = (long long)ns * a.nr * a.nseg;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  int e;
  if ((e = cudaMemsetAsync(a.flat, 0, buffer_bytes(a.nr, a.nc, ns), stream))) return e;
  seg_kernel<Y><<<static_cast<unsigned>(ctas), NT, 0, stream>>>(a);
  return dngd_last_error();
}

}  // namespace

// The bytes of the buffer the launches below take and zero: ns flat
// buffers of FLAT_BYTES, then the look-back state (state_words int32).
// The wrapper (ops/bitmerge.py) sizes its buffer by this call.
extern "C" long long pack_buffer_bytes(int nr, int nc, int ns) {
  return static_cast<long long>(buffer_bytes(nr, nc, ns));
}

// buf: pack_buffer_bytes(nr, nc, ns) bytes, zeroed here.
// qp_sum: one int per session on the card (tune=hq) or null.  ns:
// sessions (1 = one frame): slots, runs, flats and qp sums stacked; one
// header-slot set, or (hdr_sess) one per session, stacked.
extern "C" int pack_frame_launch(const int* values, const int* lengths, const int* syn_vals,
                                 const int* syn_lens, const int* hdr_vals, const int* hdr_lens,
                                 uint8_t* buf, const int* qp_sum, int nr, int nc, int ns,
                                 int hdr_sess, cudaStream_t stream) {
  const Args a{values, lengths, syn_vals, syn_lens, hdr_vals, hdr_lens, nullptr, nullptr,
               qp_sum, buf, nullptr, nr, nc, 0, 0};
  return pack_launch<ILayout>(a, ns, hdr_sess, stream);
}

// nb: blocks per MB, 26, or 27 with the I16-in-P DC block.
extern "C" int pack_p_frame_launch(const int* values, const int* lengths, const int* mbh_vals,
                                   const int* mbh_lens, const int* run_vals, const int* run_lens,
                                   const int* hdr_vals, const int* hdr_lens, uint8_t* buf,
                                   const int* qp_sum, int nr, int nc, int nb, int ns,
                                   int hdr_sess, cudaStream_t stream) {
  const Args a{values, lengths, mbh_vals, mbh_lens, hdr_vals, hdr_lens, run_vals, run_lens,
               qp_sum, buf, nullptr, nr, nc, 0, 0};
  if (nb == 27) return pack_launch<PILayout>(a, ns, hdr_sess, stream);
  if (nb != 26) return cudaErrorInvalidValue;
  return pack_launch<PLayout>(a, ns, hdr_sess, stream);
}

