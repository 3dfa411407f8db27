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
//       The colour, the quad mean and both DCT passes run in float64 in
//       one fixed order, every product and sum spelled with
//       __dmul_rn/__dadd_rn so nvcc cannot contract them into FMAs, the
//       coefficient rounded once to float32, then the IEEE float32
//       quotient by the quant step and round half to even.
//       ops/jpeg_device.jpeg_transform_plain spells the same order, so the
//       two agree bit for bit.  Bound:
//       operations, 17,024 float64 adds and multiplies an MCU (0.0082 ms
//       at 1080p at ~17 T/s; bytes: 6.2 MB in, 12.5 MB out, 0.0056 ms).
//       Design (redesigned for Hopper): a CTA a tile of four MCUs of one
//       MCU row, a thread a pixel half line for the colour and Y's row
//       pass, a thread a chroma row for the quads and their row pass, every
//       thread a block column for the column pass; the float64 constants
//       are warp-uniform operands (no conversion a product), the frame read
//       by aligned words, the levels stored as 16-byte words (below).
// K16b  jpeg_analyze_launch replaces ops/jpeg_device.py:142 jpeg_analyze
//       (:59 component_symbols, :94 component_histogram): each block's
//       symbols (DC size against the previous block of its chain and strip,
//       run/size symbols, ZRLs, EOB) counted into the session's histograms
//       (dc_y 17, ac_y 256, dc_c 17, ac_c 256 int32), the restart strips'
//       summed as the reference's psum.  A DC size above 16 adds nothing, as
//       the reference's scatter drops it.  Integer work: exact.  Bound: bytes
//       (12.5 MB of levels at 1080p, 0.0037 ms).  Design (redesigned for
//       Hopper): one wave of CTAs, a warp a block, two coalesced loads
//       issued a step ahead and two ballots, the symbols from the 64-bit
//       mask (as K16c's); the hot bins in registers, an AC symbol a shared
//       add; one launch and no memset, the CTAs' bins summed in a
//       __device__ accumulator that the last CTA of a session takes out and
//       zeroes.
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
//          strip's first MCU), lane 31 the EOB when
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
#include <type_traits>

#include "bitsink.cuh"
#include "lookback.cuh"

namespace {

// K16a (K16A_TILE): a CTA a tile of MT MCUs along one MCU row, NT = 48 MT
// threads in two roles, then one:
//  - luma threads (32 an MCU, warps 0-3): a half line of 8 pixels each, the
//    tile's lines loaded coalesced (a line's 48 MT bytes by aligned words
//    and funnel shifts; a half line past the frame's right edge byte by
//    byte with its columns clamped, every line's row clamped); the colour
//    of its 8 pixels, Cb and Cr into `craw`, then Y's row pass on its own
//    8 values in registers;
//  - chroma threads (16 an MCU, warps 4-5): a row of a Cb or Cr block each,
//    after a named barrier the luma warps only arrive at: its 8 quads from
//    `craw`, then the row pass;
//  - all threads: a column of a block each (t[i][v], i = 0..7 from
//    `tmp`), the column pass, the quantize, the level into `lev` in
//    natural order; then the tile's levels go out as 16-byte words in
//    zigzag and MCU order.
// The DCT matrix, the colour matrix and the offsets are float64 constants
// (`c_dct`, `c_mat`, `c_off`: the float32 values of dct.DCT8,
// color._M_FULL and OFF_FULL, widened, which is exact), read as warp-
// uniform operands: no conversion a product.  Pixels become doubles by an
// add to 2^52 (exact).  The quotient: with c the coefficient rounded to
// float32 and q a float32 step, RN32(RN64(c * RN64(1 / q))) is RN32(c / q),
// the IEEE float32 divide's result: the double product is within 2^-52
// (relative) of c / q, and c / q is at least 2^-49 (relative) away from any
// midpoint of two float32 neighbours (a midpoint has a 25-bit odd
// significand, so c - q * m is a nonzero multiple of its last bit).  So no
// branching divide, and the eight quotients of a column overlap.
// The shared pitches keep every half-warp's 8-byte accesses on 16 distinct
// bank pairs (`tests/test_torch_k16a_k14d_order.py` holds the mapping).
// 63 registers and 39.6 KB of shared memory let five CTAs share an SM (on
// an H100, three CTAs an SM at 90 registers ran 13% slower at 1080p).
namespace k16a {

constexpr int MT = 4;                  // MCUs a tile
constexpr int NL = 32 * MT;            // luma threads
constexpr int NT = 48 * MT;            // all threads (the chroma threads: NT - NL)
constexpr int RP = 17, RM = 16 * RP + 2, RC = MT * RM + 1;   // craw: line, MCU, plane
constexpr int TI = 9, TB = 72, TM = 6 * TB + 2;               // tmp: row, block, MCU
constexpr int LB = 72;                                         // lev: ints a block

// dct.DCT8 (D[k][i], row-major): float32 values, exact as doubles
__constant__ double c_dct[64] = {
    0x1.6a09e6p-2, 0x1.6a09e6p-2, 0x1.6a09e6p-2, 0x1.6a09e6p-2,
    0x1.6a09e6p-2, 0x1.6a09e6p-2, 0x1.6a09e6p-2, 0x1.6a09e6p-2,
    0x1.f6297cp-2, 0x1.a9b662p-2, 0x1.1c73b4p-2, 0x1.8f8b84p-4,
    -0x1.8f8b84p-4, -0x1.1c73b4p-2, -0x1.a9b662p-2, -0x1.f6297cp-2,
    0x1.d906bcp-2, 0x1.87de2ap-3, -0x1.87de2ap-3, -0x1.d906bcp-2,
    -0x1.d906bcp-2, -0x1.87de2ap-3, 0x1.87de2ap-3, 0x1.d906bcp-2,
    0x1.a9b662p-2, -0x1.8f8b84p-4, -0x1.f6297cp-2, -0x1.1c73b4p-2,
    0x1.1c73b4p-2, 0x1.f6297cp-2, 0x1.8f8b84p-4, -0x1.a9b662p-2,
    0x1.6a09e6p-2, -0x1.6a09e6p-2, -0x1.6a09e6p-2, 0x1.6a09e6p-2,
    0x1.6a09e6p-2, -0x1.6a09e6p-2, -0x1.6a09e6p-2, 0x1.6a09e6p-2,
    0x1.1c73b4p-2, -0x1.f6297cp-2, 0x1.8f8b84p-4, 0x1.a9b662p-2,
    -0x1.a9b662p-2, -0x1.8f8b84p-4, 0x1.f6297cp-2, -0x1.1c73b4p-2,
    0x1.87de2ap-3, -0x1.d906bcp-2, 0x1.d906bcp-2, -0x1.87de2ap-3,
    -0x1.87de2ap-3, 0x1.d906bcp-2, -0x1.d906bcp-2, 0x1.87de2ap-3,
    0x1.8f8b84p-4, -0x1.1c73b4p-2, 0x1.a9b662p-2, -0x1.f6297cp-2,
    0x1.f6297cp-2, -0x1.a9b662p-2, 0x1.1c73b4p-2, -0x1.8f8b84p-4,
};
// color._M_FULL (rows Y, Cb, Cr) and color.OFF_FULL
__constant__ double c_mat[9] = {
    0x1.322d0ep-2, 0x1.2c8b44p-1, 0x1.d2f1aap-4,
    -0x1.599234p-3, -0x1.5336e6p-2, 0x1p-1,
    0x1p-1, -0x1.acbc70p-2, -0x1.4d0e3ep-4,
};
__constant__ double c_off[3] = {0.0, 128.0, 128.0};
// zigzag position -> natural 8x8 index (scan.ZIGZAG8), read once a CTA
__device__ const int g_nat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

__device__ __forceinline__ double u8d(unsigned v) {   // exact: 2^52 + v - 2^52
  return __dadd_rn(__hiloint2double(0x43300000, static_cast<int>(v)), -0x1p52);
}

// t[v] = sum_j x[j] * D[v][j], each sum from j = 0 up, unfused
__device__ __forceinline__ void row_pass(const double (&x)[8], double (&t)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) t[v] = __dmul_rn(x[0], c_dct[v * 8]);
#pragma unroll
  for (int j = 1; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 8; ++v) t[v] = __dadd_rn(t[v], __dmul_rn(x[j], c_dct[v * 8 + j]));
}

struct Smem {
  double craw[2 * RC];       // Cb, Cr of every pixel: [plane][MCU][line][column]
  double tmp[MT * TM];       // the row pass's output: [MCU][block][row][v]
  int lev[MT * 6 * LB];      // levels, natural order: [MCU][block][u * 8 + v]
  double rq[128];            // RN64(1 / q) of the luma, then chroma quant table
  int nat[64];
};

}  // namespace k16a

__global__ void __launch_bounds__(k16a::NT, 5)
    transform_kernel(const uint8_t* __restrict__ rgb, const float* __restrict__ qtab,
                     int* __restrict__ y_out, int* __restrict__ cb_out, int* __restrict__ cr_out,
                     int h, int w, int nmx) {
  using namespace k16a;
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, my = blockIdx.y, mx0 = blockIdx.x * MT;
  const int nm = min(MT, nmx - mx0);          // the tile's MCUs in the frame
  const size_t s = blockIdx.z, nmcu = static_cast<size_t>(nmx) * gridDim.y;
  const size_t mcu0 = s * nmcu + static_cast<size_t>(my) * nmx + mx0;
  if (tid < 128) sm.rq[tid] = __drcp_rn(static_cast<double>(qtab[tid]));
  else if (tid < 192) sm.nat[tid - 128] = g_nat[tid - 128];

  if (tid < NL) {
    // -- luma thread: line `line` of MCU `m`, columns 8 hf .. 8 hf + 7
    const int line = tid / (2 * MT), m = (tid >> 1) % MT, hf = tid & 1;
    double x[8];
    if (m < nm) {
      const int sy = min(my * 16 + line, h - 1), x0 = (mx0 + m) * 16 + 8 * hf;
      const uint8_t* row = rgb + (s * h + sy) * static_cast<size_t>(w) * 3;
      unsigned px[24];
      if (x0 + 8 <= w) {          // 24 bytes from aligned words
        const uint8_t* p = row + 3 * x0;
        const int sh = 8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
        const unsigned* wp = reinterpret_cast<const unsigned*>(p - (reinterpret_cast<uintptr_t>(p) & 3));
        unsigned wd[7];
#pragma unroll
        for (int i = 0; i < 6; ++i) wd[i] = __ldg(wp + i);
        wd[6] = sh ? __ldg(wp + 6) : 0u;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const unsigned u = __funnelshift_r(wd[i], wd[i + 1], sh);
#pragma unroll
          for (int k = 0; k < 4; ++k) px[4 * i + k] = (u >> (8 * k)) & 255u;
        }
      } else {                    // the frame's right edge: columns clamped
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint8_t* p = row + 3 * min(x0 + k, w - 1);
          px[3 * k] = p[0];
          px[3 * k + 1] = p[1];
          px[3 * k + 2] = p[2];
        }
      }
      double* cb = sm.craw + m * RM + line * RP + 8 * hf;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const double r = u8d(px[3 * k]), g = u8d(px[3 * k + 1]), b = u8d(px[3 * k + 2]);
        double c[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          double v = __dadd_rn(__dmul_rn(r, c_mat[3 * d]), __dmul_rn(g, c_mat[3 * d + 1]));
          v = __dadd_rn(v, __dmul_rn(b, c_mat[3 * d + 2]));
          c[d] = __dadd_rn(v, c_off[d]);
        }
        x[k] = __dadd_rn(c[0], -128.0);
        cb[k] = c[1];
        cb[RC + k] = c[2];
      }
    }
    asm volatile("bar.arrive 1, %0;" ::"n"(NT) : "memory");
    if (m < nm) {
      double t[8];
      row_pass(x, t);
      double* o = sm.tmp + m * TM + ((line >> 3) * 2 + hf) * TB + (line & 7) * TI;
#pragma unroll
      for (int v = 0; v < 8; ++v) o[v] = t[v];
    }
  } else {
    // -- chroma thread: row i of plane pl's block of MCU m
    const int c = tid - NL, m = c >> 4, pl = (c >> 3) & 1, i = c & 7;
    asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
    if (m < nm) {
      const double* p0 = sm.craw + pl * RC + m * RM + 2 * i * RP;
      const double* p1 = p0 + RP;
      double x[8], t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // ((p00 + p01) + p10) + p11, * 0.25, - 128
        double q = __dadd_rn(p0[2 * j], p0[2 * j + 1]);
        q = __dadd_rn(__dadd_rn(q, p1[2 * j]), p1[2 * j + 1]);
        x[j] = __dadd_rn(__dmul_rn(q, 0.25), -128.0);
      }
      row_pass(x, t);
      double* o = sm.tmp + m * TM + (4 + pl) * TB + i * TI;
#pragma unroll
      for (int v = 0; v < 8; ++v) o[v] = t[v];
    }
  }
  __syncthreads();

  {  // -- column v of block b of MCU m: c[u][v] = sum_i D[u][i] * t[i][v]
    const int m = tid / 48, b = (tid >> 3) % 6, v = tid & 7;
    if (m < nm) {
      const double* in = sm.tmp + m * TM + b * TB + v;
      double t[8], c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = in[i * TI];
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = __dmul_rn(c_dct[u * 8], t[0]);
#pragma unroll
      for (int i = 1; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) c[u] = __dadd_rn(c[u], __dmul_rn(c_dct[u * 8 + i], t[i]));
      const double* rq = sm.rq + (b < 4 ? 0 : 64) + v;
      int* o = sm.lev + (m * 6 + b) * LB + v;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        o[u * 8] = __float2int_rn(__double2float_rn(
            __dmul_rn(static_cast<double>(__double2float_rn(c[u])), rq[u * 8])));
    }
  }
  __syncthreads();

  // -- the tile's levels as 16-byte words: Y (nm x 64 words), Cb, Cr (nm x 16)
  for (int wd = tid; wd < nm * 96; wd += NT) {
    int m, b, z;
    int4* dst;
    if (wd < nm * 64) {
      m = wd >> 6, b = (wd >> 4) & 3, z = 4 * (wd & 15);
      dst = reinterpret_cast<int4*>(y_out + ((mcu0 + m) * 4 + b) * 64 + z);
    } else {
      const int w2 = wd - nm * 64, pl = w2 >= nm * 16, w3 = w2 - pl * nm * 16;
      m = w3 >> 4, b = 4 + pl, z = 4 * (w3 & 15);
      dst = reinterpret_cast<int4*>((pl ? cr_out : cb_out) + (mcu0 + m) * 64 + z);
    }
    const int* src = sm.lev + (m * 6 + b) * LB;
    *dst = make_int4(src[sm.nat[z]], src[sm.nat[z + 1]], src[sm.nat[z + 2]], src[sm.nat[z + 3]]);
  }
}

// ---------------------------------------------------------------------------
// The entropy passes (K16b, K16c): a warp an 8x8 block, lane l holding the
// levels at zigzag positions l and l + 32; blocks in the scan's interleave
// order, Y00 Y01 Y10 Y11 Cb Cr an MCU.  Both kernels take a block's symbols
// from the functions below, so they cannot disagree about one.

constexpr int kDcL = 0, kAcL = 17, kDcC = 273, kAcC = 290, kSyms = 546;  // symbol offsets
constexpr int kTableInts = 2 * kSyms;  // codes at [0, 546), lengths at [546, 1092)
using lookback::FULL;

__device__ __forceinline__ int bit_length(int v) { return 32 - __clz(v); }

__device__ __forceinline__ uint32_t amplitude(int v, int size) {
  return (uint32_t)(v >= 0 ? v : v + (1 << size) - 1) & ((1u << size) - 1u);
}

// The DC difference against the chain's predecessor, wrapping in 32 bits as
// the reference's int32 subtraction does.
__device__ __forceinline__ int dc_diff(int dc, int prev) {
  return static_cast<int>(static_cast<unsigned>(dc) - static_cast<unsigned>(prev));
}

// The block's AC nonzero mask, in two halves: bit k of lo (k >= 1) set where
// zigzag position k holds a nonzero level, bit k of hi where position
// 32 + k does (a: the lane's level at position lane, b: at lane + 32).
struct Mask {
  unsigned lo, hi;
};

__device__ __forceinline__ Mask ac_mask(int a, int b) {
  return {__ballot_sync(FULL, a != 0) & ~1u, __ballot_sync(FULL, b != 0)};
}

// The run/size symbol of the nonzero level v at zigzag position k = lane
// (HI: lane + 32) >= 1: its run of zeros since the previous nonzero (or the
// DC) is k less the mask's highest set bit below k, less one; zrl takes the
// runs of 16 before it, size the level's bit length.  Below 256 for any
// int32 level (size <= 32).
template <bool HI>
__device__ __forceinline__ int ac_symbol(Mask m, int lane, int v, int& zrl, int& size) {
  const unsigned below = (HI ? m.hi : m.lo) & ((1u << lane) - 1u);
  int prev = 31 - __clz(below);                      // -1 where no bit is below
  if (HI) prev = below ? prev + 32 : 31 - __clz(m.lo);
  const int run = (HI ? 32 + lane : lane) - max(prev, 0) - 1;
  zrl = run >> 4;
  size = bit_length(abs(v));
  return ((run & 15) << 4) | size;
}

// A block ends with an EOB unless its position 63 is nonzero.
__device__ __forceinline__ bool block_eob(Mask m) { return !(m.hi >> 31); }

// K16b (HIST_*): a CTA of HIST_WARPS warps takes a contiguous span of MCUs
// of one session (grid.y: the session), a warp a contiguous part of it, an
// MCU at a time: the 6 blocks of the next MCU (two coalesced 128-byte loads
// a block) are loaded while the warp counts this one (two MCUs a step, or
// loads two or three MCUs ahead, took more registers, fewer CTAs an SM, and
// were slower).  The grid is about HIST_CTAS_PER_SM CTAs an SM over all
// sessions (one wave), so each CTA's flush is paid once.  The DC chain: a
// warp carries each component's predecessor in a register across its MCUs
// (0 at a strip's first MCU), reading it from memory only for its first
// MCU.  Counting:
//  - the bins every block hits stay in registers until the warp is done:
//    lane k counts the blocks of DC size k (a size past 16 matches no lane
//    below 17, so it is dropped, as the reference's scatter drops it), the
//    EOBs are a warp-uniform count, the ZRLs a count a lane;
//  - an AC symbol is one shared atomic add from its lane (merging a
//    block's equal symbols first by __match_any_sync was slower);
//  - the CTA adds its nonzero bins to the session's accumulator, a
//    __device__ array zero between launches, then one arrival; the CTA that
//    finds every other CTA of its session arrived takes the sums out (each
//    bin swapped with 0), writes the histogram and resets the arrivals.
// So one launch and no memset; launches of one device must be
// stream-ordered (they share the accumulators).  A launch takes at most
// HIST_MAX_S sessions; the launcher splits a larger S.
constexpr int HIST_WARPS = 8, HIST_NT = 32 * HIST_WARPS;
constexpr int HIST_CTAS_PER_SM = 4;
constexpr int HIST_MAX_S = 64;
__device__ int g_hist_acc[HIST_MAX_S * kSyms];
__device__ unsigned g_hist_arrive[HIST_MAX_S];

struct HistLevels {                       // an MCU's 6 blocks: lane l's positions l, l + 32
  int a[6], b[6];
};

__device__ __forceinline__ void hist_load(HistLevels& v, const int* y, const int* cb,
                                          const int* cr, size_t m, int lane) {
  const int* py = y + m * 256 + lane;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v.a[c] = __ldg(py + 64 * c);
    v.b[c] = __ldg(py + 64 * c + 32);
  }
  v.a[4] = __ldg(cb + m * 64 + lane);
  v.b[4] = __ldg(cb + m * 64 + lane + 32);
  v.a[5] = __ldg(cr + m * 64 + lane);
  v.b[5] = __ldg(cr + m * 64 + lane + 32);
}

struct HistCounts {                       // a warp's register counts
  int dcl = 0, dcc = 0, zrl_l = 0, zrl_c = 0, eob_l = 0, eob_c = 0;
  int py = 0, pb = 0, pr = 0;             // the chains' predecessors
};

// MCU m (of a session) into the counts and the CTA's AC bins h.
__device__ __forceinline__ void hist_count(const HistLevels& v, HistCounts& k, int* h, int m,
                                           int mps, int lane) {
  if (m % mps == 0) k.py = k.pb = k.pr = 0;            // a strip's first MCU
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const bool luma = c < 4;
    const int dc = __shfl_sync(FULL, v.a[c], 0);
    int& prev = luma ? k.py : (c == 4 ? k.pb : k.pr);
    const int dsize = bit_length(abs(dc_diff(dc, prev)));
    prev = dc;
    (luma ? k.dcl : k.dcc) += dsize == lane;
    const Mask mk = ac_mask(v.a[c], v.b[c]);
    (luma ? k.eob_l : k.eob_c) += block_eob(mk);
    int* hac = h + (luma ? kAcL : kAcC);
    int& zrl = luma ? k.zrl_l : k.zrl_c;
    int z, size;
    if ((mk.lo >> lane) & 1) {                         // the item at position lane
      atomicAdd(hac + ac_symbol<false>(mk, lane, v.a[c], z, size), 1);
      zrl += z;
    }
    if (v.b[c]) {                                      // at lane + 32
      atomicAdd(hac + ac_symbol<true>(mk, lane, v.b[c], z, size), 1);
      zrl += z;
    }
  }
}

__global__ void __launch_bounds__(HIST_NT)
    analyze_kernel(const int* __restrict__ y, const int* __restrict__ cb,
                   const int* __restrict__ cr, int* __restrict__ hist, int nmcu, int mps) {
  __shared__ int h[kSyms];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, slot = blockIdx.y;
  // the CTA's span, then the warp's part of it
  const int per_cta = (nmcu + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per_cta, c1 = min(c0 + per_cta, nmcu);
  const int per_warp = (per_cta + HIST_WARPS - 1) / HIST_WARPS;
  const int w0 = c0 + warp * per_warp, w1 = min(w0 + per_warp, c1);
  const size_t base = static_cast<size_t>(slot) * nmcu;
  HistLevels cur, nxt;                                 // the MCU counted, the next one
  HistCounts k;
  if (w0 < w1) {
    hist_load(cur, y, cb, cr, base + w0, lane);
    if (w0 % mps) {
      k.py = __ldg(y + (base + w0) * 256 - 64);
      k.pb = __ldg(cb + (base + w0 - 1) * 64);
      k.pr = __ldg(cr + (base + w0 - 1) * 64);
    }
  }
  for (int i = tid; i < kSyms; i += HIST_NT) h[i] = 0;
  __syncthreads();

  for (int m = w0; m < w1; ++m) {                      // warp-uniform
    if (m + 1 < w1) hist_load(nxt, y, cb, cr, base + m + 1, lane);
    hist_count(cur, k, h, m, mps, lane);
    cur = nxt;
  }

  // the warp's registers, then the CTA's nonzero bins, then the arrival
  if (w0 < w1) {
    if (lane < 17) {
      if (k.dcl) atomicAdd(h + kDcL + lane, k.dcl);
      if (k.dcc) atomicAdd(h + kDcC + lane, k.dcc);
    }
    for (int o = 16; o; o >>= 1) {
      k.zrl_l += __shfl_xor_sync(FULL, k.zrl_l, o);
      k.zrl_c += __shfl_xor_sync(FULL, k.zrl_c, o);
    }
    if (lane == 0) {
      if (k.eob_l) atomicAdd(h + kAcL, k.eob_l);
      if (k.eob_c) atomicAdd(h + kAcC, k.eob_c);
      if (k.zrl_l) atomicAdd(h + kAcL + 0xF0, k.zrl_l);
      if (k.zrl_c) atomicAdd(h + kAcC + 0xF0, k.zrl_c);
    }
  }
  __syncthreads();
  int* acc = g_hist_acc + slot * kSyms;
  for (int i = tid; i < kSyms; i += HIST_NT)
    if (h[i]) atomicAdd(acc + i, h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(g_hist_arrive + slot, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                                     // every other CTA's adds are in
  for (int i = tid; i < kSyms; i += HIST_NT) hist[slot * kSyms + i] = atomicExch(acc + i, 0);
  if (tid == 0) g_hist_arrive[slot] = 0;               // for the next launch (stream-ordered)
}

// ---------------------------------------------------------------------------
// K16c: a segment of SEGM MCUs of one strip a CTA, a warp a block.

constexpr int SEGM = 16;                  // MCUs a segment
constexpr int SEG_BLOCKS = 6 * SEGM;
constexpr int PACK_WARPS = 8, PACK_NT = 32 * PACK_WARPS;
constexpr int WIN_WORDS = 4096;           // a window of the segment's words

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
  const Mask mk = ac_mask(a, b);
  const int act = luma ? kAcL : kAcC;
  Items it;
  auto ac_item = [&](auto hi, int v, unsigned long long& val, int& len, int& zrl) {
    val = 0;
    len = zrl = 0;
    if (v == 0) return;
    int size;
    const int2 c = tb[act + ac_symbol<decltype(hi)::value>(mk, lane, v, zrl, size)];
    val = (static_cast<unsigned long long>(static_cast<unsigned>(c.x)) << size) | amplitude(v, size);
    len = c.y + size;
  };
  if (lane == 0) {
    const int diff = dc_diff(a, prev_dc);
    const int dsize = bit_length(abs(diff));
    const int2 c = tb[(luma ? kDcL : kDcC) + min(dsize, 16)];
    it.va = (static_cast<unsigned long long>(static_cast<unsigned>(c.x)) << dsize) |
            amplitude(diff, dsize);
    it.la = c.y + dsize;
    it.za = 0;
  } else {
    ac_item(std::false_type(), a, it.va, it.la, it.za);
  }
  ac_item(std::true_type(), b, it.vb, it.lb, it.zb);
  it.eob = lane == 31 && block_eob(mk) ? tb[act].y : 0;
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

// s frames (S, h, w, 3) -> y (S, nmcu, 4, 64), cb, cr (S, nmcu, 64), each
// 16-byte aligned; consts: 128 floats (the luma, then the chroma quant table).
extern "C" int jpeg_transform_launch(const uint8_t* rgb, const float* consts, int* y, int* cb,
                                     int* cr, int s, int h, int w, int pad_h, int pad_w,
                                     cudaStream_t stream) {
  if (s <= 0 || pad_h <= 0 || pad_w <= 0) return 0;
  if (s > 65535 || pad_h % 16 || pad_w % 16 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(cb) |
       reinterpret_cast<uintptr_t>(cr)) & 15)
    return cudaErrorMisalignedAddress;
  const int nmx = pad_w / 16;
  const dim3 grid((nmx + k16a::MT - 1) / k16a::MT, pad_h / 16, s);
  transform_kernel<<<grid, k16a::NT, 0, stream>>>(rgb, consts, y, cb, cr, h, w, nmx);
  return dngd_last_error();
}

// hist: (S, 546) int32, every bin written: dc_y 17, ac_y 256, dc_c 17,
// ac_c 256.  One launch a HIST_MAX_S sessions, no memset.
extern "C" int jpeg_analyze_launch(const int* y, const int* cb, const int* cr, int* hist, int s,
                                   int nmcu, int nx, cudaStream_t stream) {
  if (s <= 0 || nmcu <= 0) return 0;
  if (s > 65535 || nx <= 0 || nmcu % nx) return cudaErrorInvalidValue;
  int sms = 0;
  if (const int e = dngd_sm_count(&sms)) return e;
  for (int s0 = 0; s0 < s; s0 += HIST_MAX_S) {
    const int ns = min(HIST_MAX_S, s - s0);
    // about HIST_CTAS_PER_SM CTAs an SM over the launch, each warp at least an MCU
    const int most = (nmcu + HIST_WARPS - 1) / HIST_WARPS;
    const int ctas = max(1, min(most, (sms * HIST_CTAS_PER_SM + ns - 1) / ns));
    const size_t m = static_cast<size_t>(s0) * nmcu;
    analyze_kernel<<<dim3(ctas, ns), HIST_NT, 0, stream>>>(
        y + m * 256, cb + m * 64, cr + m * 64, hist + static_cast<size_t>(s0) * kSyms, nmcu,
        nmcu / nx);
    if (const int e = dngd_last_error()) return e;
  }
  return 0;
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
