// K16a, K16b, K16c — the baseline JPEG encoder's device programs, each over
// a session axis (S frames) and a restart-shard axis (nx strips of MCU rows
// per frame, DC predictors reset at each strip's start).  The single
// encoder passes S = 1, nx = 1; the session batch passes both.
//
// K16a  jpeg_transform_launch replaces docker_nvidia_glx_desktop_tpu/
//       models/mjpeg.py:36 _transform_stage: (S, H, W, 3) uint8 RGB, edge
//       padded to MCU multiples -> full-range YCbCr -> 2x2 chroma mean ->
//       -128 -> 8x8 DCT -> round(c / q) -> zigzag; out y (S, nmcu, 4, 64),
//       cb, cr (S, nmcu, 64) int32 in MCU order (Y00 Y01 Y10 Y11).
//       One block per MCU, one thread per pixel; the colour, the quad mean
//       and both DCT passes run in float64 in shared memory in one fixed
//       order, every product and sum spelled with __dmul_rn/__dadd_rn so
//       nvcc cannot contract them into FMAs, the coefficient rounded once
//       to float32, then an IEEE float32 divide and round half to even.
//       ops/jpeg_device.jpeg_transform_plain spells the same order, so the
//       two agree bit for bit.  Bound: bytes (6.2 MB in, 12.5 MB out at
//       1080p, ~5.6 us at 3.35 TB/s); this first version spends float64
//       operations and a shared-memory round trip per pass instead.
// K16b  jpeg_analyze_launch replaces ops/jpeg_device.py:142 jpeg_analyze
//       (:59 component_symbols, :94 component_histogram): one thread per
//       8x8 block walks its coefficients (DC difference against the
//       previous block of its chain and strip, run/size symbols, ZRLs,
//       EOB) into shared histograms, atomically added to the session's
//       global ones (dc_y 17, ac_y 256, dc_c 17, ac_c 256 int32): the
//       restart strips' histograms summed, as the reference's psum.
//       Integer work: exact.  Bound: bytes (12.5 MB of levels).
// K16c  jpeg_pack_launch replaces ops/jpeg_device.py:154 jpeg_pack (:105
//       component_entries, ops/bitpack.py:24 pack_bits) without its 254
//       entry slots a block.  Bound: bytes (12.5 MB of levels read once at
//       1080p, the scan written).  Design (redesigned for Hopper): one
//       memset of the look-back state (a ticket and a status word a
//       segment; never the words) and one launch.  A CTA takes a segment
//       of SEGM MCUs of one strip by an atomic ticket (a segment never
//       crosses a strip):
//        - it stages the segment's levels (Y, Cb, Cr: three contiguous
//          spans) by 16-byte cp.async, and the tables as (code, length)
//          pairs into shared memory;
//        - a warp a block (interleave order Y x4, Cb, Cr an MCU): lane l
//          holds the coefficients at zigzag positions l and l + 32; two
//          ballots give the block's 64-bit nonzero mask, and each nonzero's
//          run since the previous one comes from the mask (__clzll), which
//          gives its ZRLs, run/size symbol, code and amplitude bits; lane 0
//          codes the DC difference against its chain's predecessor (0 at a
//          strip's first MCU, as locate does), lane 31 the EOB when
//          position 63 is zero; a warp scan gives the lanes' offsets;
//        - warp 0 scans the blocks' bits, publishes the segment's bits and
//          looks back over the strip's earlier segments (lookback.cuh);
//          the strip's last segment writes its total;
//        - each lane writes its two runs of codes into a window of the
//          segment's words in shared memory (one window unless a segment
//          passes WIN_WORDS; whole words stored, a run's edge words ORed:
//          bitsink.cuh), and the CTA stores them coalesced, byte-swapped
//          (a swap commutes with OR).
//       Boundary words, in an order that needs no zeroed buffer: a
//       segment plain-stores its last word (zeros past its bits) before it
//       publishes DONE, and ORs into its first word, when that word holds
//       earlier bits, only after its predecessor is DONE.  Words past the
//       strip's shard_words are dropped (the total still counts them).
#include "bitsink.cuh"
#include "lookback.cuh"

namespace {

// natural 8x8 index -> zigzag position
__constant__ int c_zpos[64] = {0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
                               3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
                               10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
                               21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// float constants of K16a, in this order
constexpr int kDct = 0, kMat = 64, kOff = 73, kLq = 76, kCq = 140, kConsts = 204;

__global__ void __launch_bounds__(256)
    transform_kernel(const uint8_t* __restrict__ rgb, const float* __restrict__ consts,
                     int* __restrict__ y_out, int* __restrict__ cb_out, int* __restrict__ cr_out,
                     int h, int w) {
  __shared__ double pix[3][16][16];
  __shared__ double blk[6][64];
  __shared__ double tmp[6][64];
  __shared__ float k[kConsts];
  const int tid = threadIdx.x, py = tid >> 4, px = tid & 15;
  const int nmx = gridDim.x, mcu = blockIdx.y * nmx + blockIdx.x;
  const size_t s = blockIdx.z, nmcu = (size_t)nmx * gridDim.y;
  if (tid < kConsts) k[tid] = consts[tid];
  const int sy = min((int)blockIdx.y * 16 + py, h - 1);
  const int sx = min((int)blockIdx.x * 16 + px, w - 1);
  const uint8_t* p = rgb + ((s * h + sy) * w + sx) * 3;
  const double r = p[0], g = p[1], b = p[2];
  __syncthreads();
  for (int d = 0; d < 3; ++d) {
    const float* m = k + kMat + 3 * d;
    double v = __dadd_rn(__dmul_rn(r, (double)m[0]), __dmul_rn(g, (double)m[1]));
    v = __dadd_rn(v, __dmul_rn(b, (double)m[2]));
    pix[d][py][px] = __dadd_rn(v, (double)k[kOff + d]);
  }
  __syncthreads();
  blk[(py >> 3) * 2 + (px >> 3)][(py & 7) * 8 + (px & 7)] = __dadd_rn(pix[0][py][px], -128.0);
  if (tid < 64) {
    const int cy = 2 * (tid >> 3), cx = 2 * (tid & 7);
    for (int c = 1; c < 3; ++c) {
      double q = __dadd_rn(pix[c][cy][cx], pix[c][cy][cx + 1]);
      q = __dadd_rn(__dadd_rn(q, pix[c][cy + 1][cx]), pix[c][cy + 1][cx + 1]);
      blk[3 + c][tid] = __dadd_rn(__dmul_rn(q, 0.25), -128.0);
    }
  }
  __syncthreads();
  // rows: t[i][v] = sum_j x[i][j] * D[v][j]
  for (int o = tid; o < 384; o += 256) {
    const int bi = o >> 6, i = (o >> 3) & 7, v = o & 7;
    const double* x = blk[bi] + i * 8;
    const float* dv = k + kDct + v * 8;
    double acc = __dmul_rn(x[0], (double)dv[0]);
    for (int j = 1; j < 8; ++j) acc = __dadd_rn(acc, __dmul_rn(x[j], (double)dv[j]));
    tmp[bi][i * 8 + v] = acc;
  }
  __syncthreads();
  // columns: c[u][v] = sum_i D[u][i] * t[i][v]; quantize; zigzag
  for (int o = tid; o < 384; o += 256) {
    const int bi = o >> 6, u = (o >> 3) & 7, v = o & 7;
    const float* du = k + kDct + u * 8;
    double acc = __dmul_rn((double)du[0], tmp[bi][v]);
    for (int i = 1; i < 8; ++i) acc = __dadd_rn(acc, __dmul_rn((double)du[i], tmp[bi][i * 8 + v]));
    const float q = k[(bi < 4 ? kLq : kCq) + u * 8 + v];
    const int level = __float2int_rn(__fdiv_rn(__double2float_rn(acc), q));
    const int z = c_zpos[u * 8 + v];
    if (bi < 4)
      y_out[((s * nmcu + mcu) * 4 + bi) * 64 + z] = level;
    else
      (bi == 4 ? cb_out : cr_out)[(s * nmcu + mcu) * 64 + z] = level;
  }
}

// ---------------------------------------------------------------------------
// The entropy passes: one thread per 8x8 block, g = mcu * 6 + (0..3 Y, 4 Cb,
// 5 Cr) inside a session: the scan's interleave order.

constexpr int kDcL = 0, kAcL = 17, kDcC = 273, kAcC = 290, kSyms = 546;  // symbol offsets
constexpr int kTableInts = 2 * kSyms;  // codes at [0, 546), lengths at [546, 1092)

__device__ __forceinline__ int bit_length(int v) { return 32 - __clz(v); }

__device__ __forceinline__ uint32_t amplitude(int v, int size) {
  return (uint32_t)(v >= 0 ? v : v + (1 << size) - 1) & ((1u << size) - 1u);
}

struct Block {
  const int* zz;  // 64 zigzagged levels
  int prev_dc;    // the predictor: 0 at a strip's first block of its chain
  bool luma;
};

__device__ __forceinline__ Block locate(const int* y, const int* cb, const int* cr, size_t s,
                                        int nmcu, int mps, int g) {
  const int mcu = g / 6, c = g - 6 * mcu;
  const size_t m = s * nmcu + mcu;
  const bool first = mcu % mps == 0;
  Block b;
  b.luma = c < 4;
  if (c < 4) {
    b.zz = y + (m * 4 + c) * 64;
    b.prev_dc = c > 0 ? b.zz[-64] : (first ? 0 : y[(m * 4 - 1) * 64]);
  } else {
    const int* base = c == 4 ? cb : cr;
    b.zz = base + m * 64;
    b.prev_dc = first ? 0 : base[(m - 1) * 64];
  }
  return b;
}

// Walks one block's symbols, calling sym(table_offset, symbol, amp, size)
// in scan order: DC, then per nonzero AC its ZRLs and its symbol, then EOB.
template <typename F>
__device__ __forceinline__ void walk(const Block& b, F&& sym) {
  const int dc_t = b.luma ? kDcL : kDcC, ac_t = b.luma ? kAcL : kAcC;
  const int diff = b.zz[0] - b.prev_dc;
  const int dsize = bit_length(abs(diff));
  sym(dc_t, min(dsize, 16), amplitude(diff, dsize), dsize);
  int run = 0, last = 0;
  for (int i = 1; i < 64; ++i) {
    const int v = b.zz[i];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run >= 16; run -= 16) sym(ac_t, 0xF0, 0u, 0);
    const int size = bit_length(abs(v));
    sym(ac_t, ((run << 4) | size) & 0xFF, amplitude(v, size), size);
    run = 0;
    last = i;
  }
  if (last < 63) sym(ac_t, 0x00, 0u, 0);
}

__global__ void __launch_bounds__(256)
    analyze_kernel(const int* __restrict__ y, const int* __restrict__ cb,
                   const int* __restrict__ cr, int* __restrict__ hist, int nmcu, int mps) {
  __shared__ int h[kSyms];
  for (int i = threadIdx.x; i < kSyms; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t s = blockIdx.y;
  if (g < nmcu * 6) {
    const Block b = locate(y, cb, cr, s, nmcu, mps, g);
    walk(b, [&](int t, int symbol, uint32_t, int) { atomicAdd(&h[t + symbol], 1); });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSyms; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[s * kSyms + i], h[i]);
}

// ---------------------------------------------------------------------------
// K16c: a segment of SEGM MCUs of one strip a CTA, a warp a block.

constexpr int SEGM = 16;                  // MCUs a segment
constexpr int SEG_BLOCKS = 6 * SEGM;
constexpr int PACK_WARPS = 8, PACK_NT = 32 * PACK_WARPS;
constexpr int WIN_WORDS = 4096;           // a window of the segment's words
using lookback::FULL;

struct PackArgs {
  const int *y, *cb, *cr, *tables;
  unsigned* words;                        // (S, nx, shard_words), big-endian bytes
  int* totals;                            // (S, nx) bits
  unsigned long long* state;              // [0] the ticket, then a status a segment
  int nmcu, nx, mps, nseg, shard_words;
};

struct PackSmem {
  int ly[SEGM * 256 + 4];                 // the staged levels (stage: n + 3 ints)
  int lcb[SEGM * 64 + 4], lcr[SEGM * 64 + 4];
  int2 tb[kSyms];                         // (code, length) a symbol
  unsigned win[WIN_WORDS];
  int blk_bits[SEG_BLOCKS], blk_off[SEG_BLOCKS];
  long long excl;
  int ticket, seg_bits, prev_dc[3];
};

// One lane's codes in one block, scan order: item a at zigzag position
// lane (lane 0: the DC difference), item b at lane + 32, then (lane 31)
// the EOB.  z ZRL codes precede an item.
struct Items {
  unsigned long long va, vb;
  int la, lb, za, zb, eob;
};

__device__ __forceinline__ Items block_items(const int* zz, int prev_dc, bool luma,
                                             const int2* tb, int lane) {
  const int a = zz[lane], b = zz[lane + 32];
  const unsigned long long nz =
      (static_cast<unsigned long long>(__ballot_sync(FULL, b != 0)) << 32) |
      __ballot_sync(FULL, a != 0);
  const unsigned long long ac = nz & ~1ull;
  const int act = luma ? kAcL : kAcC;
  Items it;
  auto ac_item = [&](int k, int v, unsigned long long& val, int& len, int& zrl) {
    val = 0;
    len = zrl = 0;
    if (v == 0) return;
    const unsigned long long below = ac & ((1ull << k) - 1ull);
    const int run = k - (below ? 63 - __clzll(static_cast<long long>(below)) : 0) - 1;
    zrl = run >> 4;
    const int size = bit_length(abs(v));
    const int2 c = tb[act + ((((run & 15) << 4) | size) & 0xFF)];
    val = (static_cast<unsigned long long>(static_cast<unsigned>(c.x)) << size) | amplitude(v, size);
    len = c.y + size;
  };
  if (lane == 0) {
    const int diff = a - prev_dc;
    const int dsize = bit_length(abs(diff));
    const int2 c = tb[(luma ? kDcL : kDcC) + min(dsize, 16)];
    it.va = (static_cast<unsigned long long>(static_cast<unsigned>(c.x)) << dsize) |
            amplitude(diff, dsize);
    it.la = c.y + dsize;
    it.za = 0;
  } else {
    ac_item(lane, a, it.va, it.la, it.za);
  }
  ac_item(lane + 32, b, it.vb, it.lb, it.zb);
  it.eob = lane == 31 && !(ac >> 63) ? tb[act].y : 0;
  return it;
}

// The block's bits and this lane's two item offsets within the block.
__device__ __forceinline__ int block_offsets(const Items& it, int zrl_len, int lane, int& off_a,
                                             int& off_b) {
  const int bits_a = it.za * zrl_len + it.la;
  const int bits_b = it.zb * zrl_len + it.lb + it.eob;
  const int packed = bits_a | (bits_b << 16);   // each half below 2^16
  int incl = packed;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(FULL, incl, 31), excl = incl - packed;
  off_a = excl & 0xFFFF;
  off_b = (total & 0xFFFF) + (excl >> 16);
  return (total & 0xFFFF) + (total >> 16);
}

// Block g of the segment (interleave order: Y x4, Cb, Cr an MCU): its
// staged levels and DC predictor.
__device__ __forceinline__ const int* seg_block(const PackSmem& sm, const int* ly,
                                                const int* lcb, const int* lcr, int g,
                                                int& prev_dc) {
  const int m = g / 6, c = g - 6 * m;
  if (c < 4) {
    const int* zz = ly + (m * 4 + c) * 64;
    prev_dc = c > 0 || m > 0 ? zz[-64] : sm.prev_dc[0];
    return zz;
  }
  const int* zz = (c == 4 ? lcb : lcr) + m * 64;
  prev_dc = m > 0 ? zz[-64] : sm.prev_dc[c - 3];
  return zz;
}

__global__ void __launch_bounds__(PACK_NT, 4) pack_seg_kernel(const PackArgs a) {
  __shared__ __align__(16) PackSmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) sm.ticket = static_cast<int>(atomicAdd(a.state, 1ull));
  __syncthreads();
  const int t = sm.ticket, strip = t / a.nseg, sg = t - strip * a.nseg;
  const size_t sess = strip / a.nx;
  const int m0 = (strip - static_cast<int>(sess) * a.nx) * a.mps + sg * SEGM;
  const int n = min(SEGM, a.mps - sg * SEGM), nblk = 6 * n;
  const size_t mb0 = sess * a.nmcu + m0;
  const int* ly = lookback::stage(sm.ly, a.y + mb0 * 256, n * 256, PACK_NT);
  const int* lcb = lookback::stage(sm.lcb, a.cb + mb0 * 64, n * 64, PACK_NT);
  const int* lcr = lookback::stage(sm.lcr, a.cr + mb0 * 64, n * 64, PACK_NT);
  for (int i = tid; i < kSyms; i += PACK_NT) sm.tb[i] = make_int2(a.tables[i], a.tables[kSyms + i]);
  if (tid == 0) {
    const bool first = sg == 0;       // a strip's first MCU: predictors at 0
    sm.prev_dc[0] = first ? 0 : a.y[(mb0 * 4 - 1) * 64];
    sm.prev_dc[1] = first ? 0 : a.cb[(mb0 - 1) * 64];
    sm.prev_dc[2] = first ? 0 : a.cr[(mb0 - 1) * 64];
  }
  lookback::cp_async_wait();
  __syncthreads();

  // counts: a warp a block
  for (int g = warp; g < nblk; g += PACK_WARPS) {
    int prev;
    const int* zz = seg_block(sm, ly, lcb, lcr, g, prev);
    const bool luma = g % 6 < 4;
    const Items it = block_items(zz, prev, luma, sm.tb, lane);
    int oa, ob;
    const int bits = block_offsets(it, sm.tb[(luma ? kAcL : kAcC) + 0xF0].y, lane, oa, ob);
    if (lane == 0) sm.blk_bits[g] = bits;
  }
  __syncthreads();

  unsigned long long* st = a.state + 1 + static_cast<size_t>(strip) * a.nseg;
  if (warp == 0) {
    int seg_bits = 0;                 // the blocks' offsets, 32 at a time
    for (int i0 = 0; i0 < nblk; i0 += 32) {
      const int x = i0 + lane < nblk ? sm.blk_bits[i0 + lane] : 0;
      int ix = x;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, ix, o);
        if (lane >= o) ix += u;
      }
      if (i0 + lane < nblk) sm.blk_off[i0 + lane] = seg_bits + ix - x;
      seg_bits += __shfl_sync(FULL, ix, 31);
    }
    long long excl = 0;
    if (sg == 0) {
      if (lane == 0) lookback::publish(st, seg_bits, lookback::INCL);
    } else {
      if (lane == 0) lookback::publish(st + sg, seg_bits, lookback::AGG);
      excl = lookback::look_back(st, sg);
      if (lane == 0) lookback::publish(st + sg, excl + seg_bits, lookback::INCL);
    }
    if (lane == 0) {
      if (sg == a.nseg - 1) a.totals[strip] = static_cast<int>(excl + seg_bits);
      sm.excl = excl;
      sm.seg_bits = seg_bits;
    }
  }
  __syncthreads();

  // the words: windows of WIN_WORDS, each lane's two runs of codes written
  // in shared memory, stored byte-swapped with the edge words in
  // SegmentStore's order
  const long long excl = sm.excl;
  lookback::SegmentStore<lookback::Bswap> out(
      a.words + static_cast<size_t>(strip) * a.shard_words, a.shard_words, excl, sm.seg_bits);
  for (int lo = 0; lo < out.nwords; lo += WIN_WORDS) {
    const int nwin = min(out.nwords - lo, WIN_WORDS);
    for (int i = tid; i < nwin; i += PACK_NT) sm.win[i] = 0;
    __syncthreads();
    for (int g = warp; g < nblk; g += PACK_WARPS) {
      int prev;
      const int* zz = seg_block(sm, ly, lcb, lcr, g, prev);
      const bool luma = g % 6 < 4;
      const int act = luma ? kAcL : kAcC;
      const Items it = block_items(zz, prev, luma, sm.tb, lane);
      const int2 zrl = sm.tb[act + 0xF0];
      int oa, ob;
      block_offsets(it, zrl.y, lane, oa, ob);
      const long long base = out.lead + sm.blk_off[g] - 32LL * lo;
      if (it.la) {                    // the lane's first run: ZRLs, then item a
        RunSink r(sm.win, base + oa, nwin);
        for (int k = 0; k < it.za; ++k) r.put(zrl.x, zrl.y);
        r.put64(it.va, it.la);
        r.flush();
      }
      if (it.lb || it.eob) {          // the second: ZRLs, item b, the EOB
        RunSink r(sm.win, base + ob, nwin);
        for (int k = 0; k < it.zb; ++k) r.put(zrl.x, zrl.y);
        r.put64(it.vb, it.lb);
        r.put(sm.tb[act].x, it.eob);
        r.flush();
      }
    }
    __syncthreads();
    out.store(sm.win, lo, nwin, PACK_NT);
    __syncthreads();
  }
  if (tid == 0) out.finish(st, sg, excl + sm.seg_bits);
}

inline int pack_segments(int mps) { return (mps + SEGM - 1) / SEGM; }

// The pack buffer's int32 layout: words, totals, then (8-byte aligned)
// the look-back state.
inline size_t pack_state_offset(int s, int nx, int shard_words) {
  const size_t n = static_cast<size_t>(s) * nx * shard_words + static_cast<size_t>(s) * nx;
  return (n + 1) & ~static_cast<size_t>(1);
}

}  // namespace

// s frames (S, h, w, 3) -> y (S, nmcu, 4, 64), cb, cr (S, nmcu, 64);
// consts: 204 floats (DCT matrix, colour matrix, offsets, luma q, chroma q).
extern "C" int jpeg_transform_launch(const uint8_t* rgb, const float* consts, int* y, int* cb,
                                     int* cr, int s, int h, int w, int pad_h, int pad_w,
                                     cudaStream_t stream) {
  if (s <= 0 || pad_h <= 0 || pad_w <= 0) return 0;
  if (s > 65535 || pad_h % 16 || pad_w % 16) return cudaErrorInvalidValue;
  const dim3 grid(pad_w / 16, pad_h / 16, s);
  transform_kernel<<<grid, 256, 0, stream>>>(rgb, consts, y, cb, cr, h, w);
  return dngd_last_error();
}

// hist: (S, 546) int32, zeroed here: dc_y 17, ac_y 256, dc_c 17, ac_c 256.
extern "C" int jpeg_analyze_launch(const int* y, const int* cb, const int* cr, int* hist, int s,
                                   int nmcu, int nx, cudaStream_t stream) {
  if (s <= 0 || nmcu <= 0) return 0;
  if (s > 65535 || nx <= 0 || nmcu % nx) return cudaErrorInvalidValue;
  cudaMemsetAsync(hist, 0, sizeof(int) * kSyms * (size_t)s, stream);
  const dim3 grid((nmcu * 6 + 255) / 256, s);
  analyze_kernel<<<grid, 256, 0, stream>>>(y, cb, cr, hist, nmcu, nmcu / nx);
  return dngd_last_error();
}

// The int32 words of the buffer jpeg_pack_launch takes (ops/jpeg_device.py
// sizes its one allocation by this call): the strips' words (S, nx,
// shard_words), the totals (S, nx), then the look-back state.
extern "C" long long jpeg_pack_buffer_words(int s, int nmcu, int nx, int shard_words) {
  if (s <= 0 || nmcu <= 0 || nx <= 0 || nmcu % nx) return 0;
  return static_cast<long long>(pack_state_offset(s, nx, shard_words) +
                                2 * (1 + static_cast<size_t>(s) * nx * pack_segments(nmcu / nx)));
}

// tables: 1092 int32 (codes then lengths, symbols as in analyze's hist);
// buf: jpeg_pack_buffer_words int32 (words, totals, state; only the state
// is zeroed here, by one memset).
extern "C" int jpeg_pack_launch(const int* y, const int* cb, const int* cr, const int* tables,
                                int* buf, int s, int nmcu, int nx, int shard_words,
                                cudaStream_t stream) {
  if (s <= 0 || nmcu <= 0) return 0;
  if (nx <= 0 || nmcu % nx || shard_words <= 0) return cudaErrorInvalidValue;
  PackArgs a;
  a.y = y;
  a.cb = cb;
  a.cr = cr;
  a.tables = tables;
  a.words = reinterpret_cast<unsigned*>(buf);
  a.totals = buf + static_cast<size_t>(s) * nx * shard_words;
  a.state = reinterpret_cast<unsigned long long*>(buf + pack_state_offset(s, nx, shard_words));
  if (reinterpret_cast<uintptr_t>(a.state) & 7) return cudaErrorMisalignedAddress;
  a.nmcu = nmcu;
  a.nx = nx;
  a.mps = nmcu / nx;
  a.nseg = pack_segments(a.mps);
  a.shard_words = shard_words;
  const long long ctas = static_cast<long long>(s) * nx * a.nseg;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  int e;
  if ((e = cudaMemsetAsync(a.state, 0, 8 * (1 + static_cast<size_t>(ctas)), stream))) return e;
  pack_seg_kernel<<<static_cast<unsigned>(ctas), PACK_NT, 0, stream>>>(a);
  return dngd_last_error();
}
