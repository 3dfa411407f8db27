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
//       entry slots a block: pass 1 counts each block's bits with the
//       Huffman tables in shared memory; an exclusive scan over the blocks
//       in interleave order (Y x4, Cb, Cr per MCU), one thread block per
//       strip, gives every block its bit offset and zeroes the two words
//       it may share with a neighbour; pass 2 writes each block's codes
//       into 32-bit words, plain stores for its own words and atomicOr on
//       the shared first and last; a last pass swaps the used words to
//       big-endian bytes.  Each strip's buffer holds the worst case, 1729
//       bits a block.  Bound: bytes (12.5 MB of levels in, the scan out).
#include "common.cuh"

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

__device__ __forceinline__ void load_tables(const int* tables, int* sh) {
  for (int i = threadIdx.x; i < kTableInts; i += blockDim.x) sh[i] = tables[i];
  __syncthreads();
}

__global__ void __launch_bounds__(256)
    count_kernel(const int* __restrict__ y, const int* __restrict__ cb,
                 const int* __restrict__ cr, const int* __restrict__ tables,
                 int* __restrict__ counts, int nmcu, int mps) {
  __shared__ int tb[kTableInts];
  load_tables(tables, tb);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t s = blockIdx.y;
  if (g >= nmcu * 6) return;
  const Block b = locate(y, cb, cr, s, nmcu, mps, g);
  int bits = 0;
  walk(b, [&](int t, int symbol, uint32_t, int size) { bits += tb[kSyms + t + symbol] + size; });
  counts[s * nmcu * 6 + g] = bits;
}

// One block of 1024 threads per (session, strip): exclusive offsets of the
// strip's blocks, its total, and its blocks' edge words zeroed.
__global__ void __launch_bounds__(1024)
    scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                uint32_t* __restrict__ words, int* __restrict__ totals, int nmcu, int mps,
                int nx, int shard_words) {
  __shared__ int warp_sums[32];
  const int sh = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const size_t s = blockIdx.y;
  const int n = mps * 6;
  const size_t base = s * nmcu * 6 + (size_t)sh * n;
  uint32_t* wd = words + (s * nx + sh) * (size_t)shard_words;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += counts[base + i];
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += t;
    }
    warp_sums[lane] = ws;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - local + (wid > 0 ? warp_sums[wid - 1] : 0);
  const long long cap = 32LL * shard_words;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[base + i];
    offsets[base + i] = run;
    if (c > 0 && run + (long long)c <= cap) {
      wd[run >> 5] = 0u;
      wd[(run + c - 1) >> 5] = 0u;
    }
    run += c;
  }
  if (tid == blockDim.x - 1) totals[s * nx + sh] = run;
}

__global__ void __launch_bounds__(256)
    write_kernel(const int* __restrict__ y, const int* __restrict__ cb,
                 const int* __restrict__ cr, const int* __restrict__ tables,
                 const int* __restrict__ counts, const int* __restrict__ offsets,
                 uint32_t* __restrict__ words, int nmcu, int mps, int nx, int shard_words) {
  __shared__ int tb[kTableInts];
  load_tables(tables, tb);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t s = blockIdx.y;
  if (g >= nmcu * 6) return;
  const int cnt = counts[s * nmcu * 6 + g];
  const int off = offsets[s * nmcu * 6 + g];
  if (cnt <= 0 || off + (long long)cnt > 32LL * shard_words) return;
  uint32_t* wd = words + (s * nx + (g / 6) / mps) * (size_t)shard_words;
  const int first = off >> 5, last = (off + cnt - 1) >> 5;
  int pos = off, cw = first;
  uint32_t cur = 0;
  auto flush = [&]() {
    if (cw == first || cw == last)
      atomicOr(wd + cw, cur);
    else
      wd[cw] = cur;
  };
  auto put = [&](uint32_t v, int len) {
    if (len == 0) return;
    const int end = (pos & 31) + len;
    if (end <= 32) {
      cur |= v << (32 - end);
    } else {
      cur |= v >> (end - 32);
      flush();
      ++cw;
      cur = v << (64 - end);
    }
    pos += len;
    if ((pos & 31) == 0) {
      flush();
      ++cw;
      cur = 0;
    }
  };
  const Block b = locate(y, cb, cr, s, nmcu, mps, g);
  walk(b, [&](int t, int symbol, uint32_t amp, int size) {
    put((uint32_t)tb[t + symbol], tb[kSyms + t + symbol]);
    put(amp, size);
  });
  if (pos & 31) flush();
}

__global__ void swap_kernel(uint32_t* __restrict__ words, const int* __restrict__ totals,
                            int shard_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t strip = blockIdx.y;
  const int used = (totals[strip] + 31) >> 5;
  if (i < used && i < shard_words) {
    uint32_t* w = words + strip * shard_words + i;
    *w = __byte_perm(*w, 0, 0x0123);
  }
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

// tables: 1092 int32 (codes then lengths, symbols as in analyze's hist);
// counts, offsets: (S, nmcu * 6) int32 scratch; words: (S, nx, shard_words)
// uint32; totals: (S, nx) int32 bits.
extern "C" int jpeg_pack_launch(const int* y, const int* cb, const int* cr, const int* tables,
                                int* counts, int* offsets, uint32_t* words, int* totals, int s,
                                int nmcu, int nx, int shard_words, cudaStream_t stream) {
  if (s <= 0 || nmcu <= 0) return 0;
  if (s > 65535 || nx <= 0 || nmcu % nx || nx > 65535) return cudaErrorInvalidValue;
  const int mps = nmcu / nx;
  const dim3 grid((nmcu * 6 + 255) / 256, s);
  count_kernel<<<grid, 256, 0, stream>>>(y, cb, cr, tables, counts, nmcu, mps);
  scan_kernel<<<dim3(nx, s), 1024, 0, stream>>>(counts, offsets, words, totals, nmcu, mps, nx,
                                                shard_words);
  write_kernel<<<grid, 256, 0, stream>>>(y, cb, cr, tables, counts, offsets, words, nmcu, mps,
                                         nx, shard_words);
  swap_kernel<<<dim3((shard_words + 255) / 256, s * nx), 256, 0, stream>>>(words, totals,
                                                                           shard_words);
  return dngd_last_error();
}
