// K1 — H.264 intra core: I16x16 DC/H + I4x4 fast modes, chroma DC
// prediction, 4x4 integer transform, DC Hadamards, quant/dequant and the
// normative reconstruction of one frame.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/h264_device.py:555
// encode_intra_frame_yuv, whose MB columns run as the 120-step lax.scan at
// :656, at each of its mode sets (i16_modes; bit-exact with every one):
// "auto" (I16 DC/H and the I4 fast sets), "full" (:427
// _luma_step_i4_full: all nine I4 modes on block rows 1-3), "i16" (:590
// allow_i4 off: I16 DC/H only) and "dc" (:630 allow_h off: I16 DC only).
// The mode set is the chain pass's MODES template argument beside TIER,
// so each (MODES, TIER) pair is one instantiation; the pre-pass is shared.
//
// The tune tier is a template parameter: TIER 0 ("off") picks every mode
// by estimated bits; 1 ("hq_noaq") and 2 ("hq") by the Lagrangian
// SSD + lam * bits in float32 (h264_device.py:99-135, :225-262), every
// candidate reconstructed for its SSD, illegal I4 candidates +inf, the
// first minimum kept, and the multiply-adds fused (__fmaf_rn) as XLA's
// CPU backend fuses them; the I4 scores summed in the reference's order
// (row 0 block by block, rows 1-3 a row's four blocks left to right).
// TIER 2 quantises each MB at its qp from the qp plane (K14) and reads
// lambda at it; TIER 1 at the slice qp.  I16 vs I4: bits4 + 44 < bits16,
// or score4 + lam * 44 (fused under hq; hq_noaq's rounded constant).
//
// Design: two launches.  Every MB row is its own slice, so an MB's only
// neighbour is its left MB's reconstruction, and the chain along a row is
// that column alone.  The core transform is exact integer linear algebra,
// so fdct4(src - pred) == fdct4(src) - fdct4(pred), and what does not
// depend on the left column is computed off the chain:
//  1. intra_pre_kernel, fully parallel: a warp per MB of every session, a
//     lane per 4x4 block (16 luma, 8 chroma).  Each lane transforms its
//     source block and quantises its AC coefficients: the I16 DC
//     candidate's 15 AC levels (the H candidate shares the 12 off column
//     0, since an H prediction transforms to column 0 only) with their
//     bit estimates, and every chroma AC level (a chroma prediction is
//     constant per block: coefficient 0 only), which it writes out.
//  2. intra_chain_kernel, one CUDA block per MB row, four warps; the
//     three luma warps meet once per MB at a named barrier:
//     - warps 0-1, the I4 chain, a lane per candidate and row of a 4x4
//       block: row 0's four blocks in order on warp 0 (H, HU, DC-left),
//       then rows 1-3 a row at a time, two blocks a warp (V, DDL, VL).
//       Each step takes every candidate at once: its prediction row, its
//       transform (the row pass in the lane, the column pass by shuffles)
//       subtracted from the source's, quant, bits summed over the four
//       lanes, the reconstruction (the spec's inverse the same way) and
//       the first minimum by shuffles; __syncwarp or a 64-thread barrier
//       between steps;
//     - warp 2, the I16 candidates (a lane per candidate and block):
//       coefficient 0 (DC) or column 0 (H) against the source transform,
//       the DC Hadamards with lanes over coefficients, each candidate's
//       reconstruction, and the sums of bits (and SSDs) by shuffles;
//     - warp 3, chroma's DC chain, on its own along the row (chroma's
//       mode is always DC and never waits on luma).
//     Under "full", block rows 1-3 take H, HU, DDR, VR, HD and two-sided
//     DC, which read the left block's reconstruction, so they run block
//     by block: twelve dependent steps of nine candidates (sixteen steps
//     an MB against the fast sets' seven).  Nine candidates of four lanes
//     are 36 lanes, more than a warp, so both I4 warps take every step:
//     warp 0 V, DDL, VL, DC, H and warp 1 HU, DDR, VR, HD (each warp's
//     prediction arithmetic is its own family's, with no divergence
//     inside a warp), each warp's first minimum by shuffles, and the two
//     met at the 64-thread barrier, twice a step (the pick, then the
//     kept block's writes before the next block reads them).  Four lanes
//     a candidate keep the fast sets' transform by shuffles (i4_eval);
//     a lane a candidate over the whole block would need one warp only
//     but four times the instructions a lane.  Under hq the full set's
//     block scores are summed one at a time in block order, as the
//     reference's _acc_score sums them.
//     "i16" and "dc" leave the I4 warps idle but for the MB's barrier and
//     their outputs, the reference's constants (no I4, modes 2, levels 0);
//     "dc" never takes the I16 warp's H candidate (its lanes run beside
//     DC's, so skipping them would save no time).
//     The luma warps then take the decision, write their outputs, and
//     read the next MB's left column from the chosen reconstruction
//     (double-buffered by MB parity, so one barrier an MB suffices).
//     Under hq every candidate's SSD, the __fmaf_rn scores and the
//     reference's summation order stay as they were.  The I4 lanes run
//     the full transform of their prediction: the candidates share one
//     instruction stream, so a shorter form for H or DC on some lanes
//     would only make the others wait.
//
// What bounds it: the chain, not bytes or operations.  Per MB the I4
// warps' seven dependent block steps (four in row 0, one per row after),
// each ~300 instructions a lane issued by one warp (~0.43 us on an H100,
// chip_smoke.py k1-variants), then the barrier and the decision; times 120
// MBs a row at 1080p (240 at 4K).  "full" has sixteen such steps, twelve
// of them with two barriers; "i16" and "dc" only the I16 warp's work.  The I16 and chroma warps run beside
// it.  Bytes: ~3 MB of planes in, ~28 MB of levels and planes out a
// 1080p frame (0.0083 ms at 3.35 TB/s).
// Tensor cores do not help (a 9-bit residual does not fit int8 wgmma,
// and the transforms are 4x4 butterflies of adds and shifts), nor do TMA
// or asynchronous copies (~3 MB of input; the chain waits on
// arithmetic, and each warp loads the next MB's inputs while it works).
#include "common.cuh"
#include "transform.cuh"

namespace {

constexpr int ILLEGAL = 1 << 30;     // bit estimate of an unavailable mode
constexpr int I4_SIG_BITS = 44;      // I_NxN signalling bias vs I16
constexpr float SCORE_CLAMP = 1e18f; // the reference's I4 score clamp
constexpr unsigned FULL = 0xffffffffu;
// the mode sets (i16_modes), the chain pass's MODES template argument
enum { MODES_AUTO = 0, MODES_FULL = 1, MODES_I16 = 2, MODES_DC = 3 };

// The pre-pass's words per MB (int32; "packed": int16 pairs, low first).
constexpr int PRE_WORDS = 352;
enum {
  PRE_W = 0,      // luma source transforms [raster block][coef], packed
  PRE_AC = 128,   // the I16 DC candidate's levels, same order (coef 0 = 0)
  PRE_BITS = 256, // per raster block: bits of its 15 AC levels, | the bits
                  // of the 12 off column 0 << 16
  PRE_WC = 272,   // chroma coefficient 0 [plane][block]
  PRE_CAC = 280,  // chroma levels [plane][block][coef], packed (coef 0 = 0)
};

// Zigzag position -> raster coefficient, raster block -> luma4x4BlkIdx,
// as nibble tables: with a constant argument (unrolled loops) they fold,
// so register arrays they index stay in registers.
__device__ __forceinline__ constexpr int zz_of(int k) {
  return (int)((0xfeb7adc963258410ull >> (4 * k)) & 15);
}
__device__ __forceinline__ constexpr int blk_of_raster(int b) {
  return (int)((0xfebadc9876325410ull >> (4 * b)) & 15);
}
// luma4x4BlkIdx -> raster block (spec 6.4.3)
__device__ __forceinline__ int raster_of_blk(int blk) {
  return (((blk >> 3) & 1) * 2 + ((blk >> 1) & 1)) * 4 + ((blk >> 2) & 1) * 2 + (blk & 1);
}
// above-right availability of raster block (by >= 1, bx < 3): h264_device
// _TR_AVAIL, the above-right block precedes this one in blkIdx order
constexpr unsigned TR_AVAIL_MASK = 0x5750u;

__device__ __forceinline__ int lvl_bits(int l) {
  const int a = abs(l);
  return a ? 3 + 2 * flog2(a) : 0;
}

__device__ __forceinline__ int pack2(int lo, int hi) {
  return (int)(((unsigned)lo & 0xffffu) | ((unsigned)hi << 16));
}

__device__ __forceinline__ void store_packed(int* dst, const int* v) {
  int4 a, b;
  a.x = pack2(v[0], v[1]); a.y = pack2(v[2], v[3]);
  a.z = pack2(v[4], v[5]); a.w = pack2(v[6], v[7]);
  b.x = pack2(v[8], v[9]); b.y = pack2(v[10], v[11]);
  b.z = pack2(v[12], v[13]); b.w = pack2(v[14], v[15]);
  reinterpret_cast<int4*>(dst)[0] = a;
  reinterpret_cast<int4*>(dst)[1] = b;
}

__device__ __forceinline__ void unpack(int4 a, int4 b, int* v) {
  const int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[2 * j] = (int)(short)(w[j] & 0xffff);
    v[2 * j + 1] = w[j] >> 16;
  }
}

__device__ __forceinline__ void load_packed(const int* src, int* v) {
  unpack(reinterpret_cast<const int4*>(src)[0], reinterpret_cast<const int4*>(src)[1], v);
}

// The forward transform's 1-D butterfly.  A prediction constant along
// rows (columns) transforms to 4 * f1d of its column (row) in column 0
// (row 0), zeros elsewhere; a constant one to 16 * it in coefficient 0.
__device__ __forceinline__ void f1d(const int* l, int* f) {
  const int s03 = l[0] + l[3], d03 = l[0] - l[3], s12 = l[1] + l[2], d12 = l[1] - l[2];
  f[0] = s03 + s12; f[1] = 2 * d03 + d12; f[2] = s03 - s12; f[3] = d03 - 2 * d12;
}

// Coefficient i of the 4x4 Hadamard H . X . H^T (had4), X in shared
// memory: rows of H by their negative positions, 0x0, 0xC, 0x6, 0xA.
__device__ __forceinline__ int had_at(const int* x, int i) {
  const int nu = (0xA6C0 >> (4 * (i >> 2))) & 15, nv = (0xA6C0 >> (4 * (i & 3))) & 15;
  int acc = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int row = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) row += ((nv >> c) & 1) ? -x[r * 4 + c] : x[r * 4 + c];
    acc += ((nu >> r) & 1) ? -row : row;
  }
  return acc;
}

// Coefficient q of the 2x2 Hadamard (had2) of [x0 x1; x2 x3].
__device__ __forceinline__ int had2_at(int x0, int x1, int x2, int x3, int q) {
  const int a = q & 1 ? x0 - x1 : x0 + x1, b = q & 1 ? x2 - x3 : x2 + x3;
  return q & 2 ? a - b : a + b;
}

// Sum over the 16 lanes of a half warp.
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the two I4 warps and the I16 warp, once an MB
__device__ __forceinline__ void luma_barrier() { asm volatile("bar.sync 1, 96;" ::: "memory"); }

// --- 1. the pre-pass ------------------------------------------------------

template <int TIER>
__global__ void __launch_bounds__(128) intra_pre_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, int* __restrict__ cb_ac, int* __restrict__ cr_ac,
    int* __restrict__ pre, const int* __restrict__ qp_map, int nmb, int nc, int qp,
    int qpc) {
  // mbi: the MB of the stack (sessions' planes stacked, nmb MBs in all)
  const int mbi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (mbi >= nmb || lane >= 24) return;
  const int r = mbi / nc, c = mbi % nc;
  const int qm = TIER == 2 ? qp_map[mbi] : qp;
  int* const o = pre + (size_t)mbi * PRE_WORDS;
  int x[16], w[16], lv[16];
  if (lane < 16) {
    const int by = lane >> 2, bx = lane & 3, W = nc * 16;
    const uint8_t* s = y + (size_t)(r * 16 + by * 4) * W + c * 16 + bx * 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = s[(i >> 2) * W + (i & 3)];
    fdct4(x, w);
    const Qp Q(qm);
    lv[0] = 0;
#pragma unroll
    for (int i = 1; i < 16; ++i) lv[i] = Q.q(w[i], i);
    const int b15 = level_bits(lv);
    const int b12 = b15 - lvl_bits(lv[4]) - lvl_bits(lv[8]) - lvl_bits(lv[12]);
    store_packed(o + PRE_W + lane * 8, w);
    store_packed(o + PRE_AC + lane * 8, lv);
    o[PRE_BITS + lane] = b15 | (b12 << 16);
  } else {
    const int p = (lane - 16) >> 2, q = (lane - 16) & 3, by = q >> 1, bx = q & 1;
    const int Wc = nc * 8;
    const uint8_t* s = (p ? cr : cb) + (size_t)(r * 8 + by * 4) * Wc + c * 8 + bx * 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = s[(i >> 2) * Wc + (i & 3)];
    fdct4(x, w);
    const Qp QC(TIER == 2 ? dngd_chroma_qp(qm) : qpc);
    lv[0] = 0;
#pragma unroll
    for (int i = 1; i < 16; ++i) lv[i] = QC.q(w[i], i);
    o[PRE_WC + p * 4 + q] = w[0];
    store_packed(o + PRE_CAC + (p * 4 + q) * 8, lv);
    int* const ac = (p ? cr_ac : cb_ac) + (size_t)(mbi * 4 + q) * 15;
#pragma unroll
    for (int k = 1; k < 16; ++k) ac[k - 1] = lv[zz_of(k)];
  }
}

// --- 2. the chain ---------------------------------------------------------

struct Chain {
  alignas(16) int w4[2][128];   // [parity] the MB's luma transforms (PRE_W)
  int src[2][256];              // [parity] its luma samples (tiers 1, 2)
  int rec4[2][256];             // [parity] I4 reconstruction
  int rec16[2][2][256];         // [parity][candidate] I16 DC, H reconstructions
  int lvz4[2][16][16];          // [parity][raster block] I4 levels, zigzag
  int mode4[2][16];             // [parity][raster block] I4 modes
  int wbits[2][16];             // [parity][raster block] the kept I4 bits
  float wscore[2][16];          // ... and scores (row 0 clamped, as summed)
  int dcl[2][2][16];            // [parity][candidate] I16 DC levels
  int dcx[2][16];               // [candidate] the I16 warp's Hadamard input
  int t16[2][4];                // [parity] I16 DC, H bits; DC, H SSDs
  int bits4[2];                 // [parity] I4 bits (tier 0)
  float score4[2];              // [parity] I4 score (tiers 1, 2)
  int xk[2], xb[2];             // full set: [warp] its first minimum, bits
  float xs[2];                  // ... and score
};

// raster coefficient -> zigzag position
__device__ __forceinline__ constexpr int izz_of(int i) {
  return (int)((0xfea9db83c7426510ull >> (4 * i)) & 15);
}

// x[u] of four values for u in 0..3, by selects
__device__ __forceinline__ int sel4(int u, int x0, int x1, int x2, int x3) {
  return (u & 2) ? ((u & 1) ? x3 : x2) : ((u & 1) ? x1 : x0);
}

// An I4 lane's constants for an MB, given its row u of the 4x4 block:
// that row of Cf, the quant MF and the scaled dequant V of its four
// coefficients.
struct I4Lane {
  int k0, k1, k2, k3, f, qbits;
  int mf[4], vs[4];
  __device__ I4Lane(const Qp& Q, int u) : f(Q.f), qbits(Q.qbits) {
    k0 = u == 1 ? 2 : 1;
    k1 = u < 2 ? 1 : (u == 2 ? -1 : -2);
    k2 = u == 0 ? 1 : (u == 3 ? 2 : -1);
    k3 = u == 0 ? 1 : (u == 1 ? -2 : (u == 2 ? 1 : -1));
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int cls = pos_class(u * 4 + v);
      mf[v] = c_mf[cls][Q.m];
      vs[v] = c_v[cls][Q.m] << Q.s;
    }
  }
};

// One candidate's row u of a 4x4 block on the lane (the candidate's four
// lanes adjacent, from lane & ~3): fdct4(src) - fdct4(pred) with the
// transform's row pass in the lane and its column pass by shuffles, quant,
// bits summed over the four lanes (ILLEGAL where the mode is not
// available), the reconstruction (the spec's inverse, rows in the lane,
// columns by shuffles) and under hq the SSD and score (+inf if illegal).
template <int TIER>
__device__ __forceinline__ void i4_eval(const Chain& s, int par, int by, int bx, int u,
                                        const int* pred, bool legal, const I4Lane& Q,
                                        float lam, int lane, int* lv, int* rec, int& bits,
                                        float& score) {
  const int base = lane & ~3;
  // the prediction's transform: row pass here, column pass across the lanes
  int t[4];
  f1d(pred, t);
  bits = 0;
  {
    const int* wp = s.w4[par] + (by * 4 + bx) * 8 + u * 2;
    const int wsrc[4] = {(int)(short)(wp[0] & 0xffff), wp[0] >> 16,
                         (int)(short)(wp[1] & 0xffff), wp[1] >> 16};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t0 = __shfl_sync(FULL, t[v], base), t1 = __shfl_sync(FULL, t[v], base + 1),
                t2 = __shfl_sync(FULL, t[v], base + 2), t3 = __shfl_sync(FULL, t[v], base + 3);
      const int tp = Q.k0 * t0 + Q.k1 * t1 + Q.k2 * t2 + Q.k3 * t3;
      lv[v] = quant(wsrc[v] - tp, Q.mf[v], Q.f, Q.qbits);
      bits += lvl_bits(lv[v]);
    }
  }
  bits += __shfl_xor_sync(FULL, bits, 1);
  bits += __shfl_xor_sync(FULL, bits, 2);
  if (!legal) bits = ILLEGAL;
  // the reconstruction: the spec's inverse, this row's pass, then columns
  {
    int d[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) d[v] = lv[v] * Q.vs[v];
    const int e0 = d[0] + d[2], e1 = d[0] - d[2];
    const int e2 = (d[1] >> 1) - d[3], e3 = d[1] + (d[3] >> 1);
    const int f[4] = {e0 + e3, e1 + e2, e1 - e2, e0 - e3};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int f0 = __shfl_sync(FULL, f[v], base), f1 = __shfl_sync(FULL, f[v], base + 1),
                f2 = __shfl_sync(FULL, f[v], base + 2), f3 = __shfl_sync(FULL, f[v], base + 3);
      const int g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
      const int x = (u == 0 || u == 3) ? g0 : g1, y = (u == 0 || u == 3) ? g3 : g2;
      const int r = ((u < 2 ? x + y : x - y) + 32) >> 6;
      rec[v] = min(max(pred[v] + r, 0), 255);
    }
  }
  score = 0.0f;
  if constexpr (TIER != 0) {
    int ssd = 0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int dd = rec[v] - s.src[par][(by * 4 + u) * 16 + bx * 4 + v];
      ssd += dd * dd;
    }
    ssd += __shfl_xor_sync(FULL, ssd, 1);
    ssd += __shfl_xor_sync(FULL, ssd, 2);
    score = legal ? __fmaf_rn(lam, (float)bits, (float)ssd) : __int_as_float(0x7f800000);
  }
}

// One I4 step of the fast sets on the two I4 warps: a lane per candidate
// and row u of a 4x4 block, every candidate evaluated at once (i4_eval);
// then the first minimum of the block's three candidates (lanes g, g + 4,
// g + 8), whose lanes keep their rows.
template <int TIER>
__device__ __forceinline__ void i4_step(Chain& s, int par, int by, int bx, int cand, int u,
                                        int g, bool active, const int* left, bool has_left,
                                        const I4Lane& Q, float lam, int lane) {
  // the lane's prediction row, every mode computed and one selected (no
  // divergence between the candidates' lanes)
  int pred[4], mode;
  bool legal = true;
  if (by == 0) {                    // H / HU / DC (left)
    int l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      l[k] = bx == 0 ? (left ? left[k * 16 + 15] : 0) : s.rec4[par][k * 16 + bx * 4 - 1];
    const bool avail = bx > 0 || has_left;
    const int z[8] = {(l[0] + l[1] + 1) >> 1, (l[0] + 2 * l[1] + l[2] + 2) >> 2,
                      (l[1] + l[2] + 1) >> 1, (l[1] + 2 * l[2] + l[3] + 2) >> 2,
                      (l[2] + l[3] + 1) >> 1, (l[2] + 3 * l[3] + 2) >> 2,
                      l[3], l[3]};
    const int dc = avail ? (l[0] + l[1] + l[2] + l[3] + 2) >> 2 : 128;
    const int lu = sel4(u, l[0], l[1], l[2], l[3]);
#pragma unroll
    for (int v = 0; v < 4; ++v) {   // HU: z[min(v + 2u, 7)]
      const int hu = sel4(u, z[v], z[min(v + 2, 7)], z[min(v + 4, 7)], z[min(v + 6, 7)]);
      pred[v] = cand == 0 ? lu : (cand == 1 ? hu : dc);
    }
    legal = cand == 2 || avail;
    mode = cand == 0 ? 1 : (cand == 1 ? 8 : 2);
  } else {                          // V / DDL / VL
    const int* above = s.rec4[par] + (by * 4 - 1) * 16 + bx * 4;
    const bool tr_avail = (TR_AVAIL_MASK >> (by * 4 + bx)) & 1;
    int p[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = above[k];
      p[4 + k] = tr_avail ? above[4 + k] : above[3];
    }
    int d[7], a[5];                 // (p, 2p, p) and (p, p) filters
#pragma unroll
    for (int j = 0; j < 6; ++j) d[j] = (p[j] + 2 * p[j + 1] + p[j + 2] + 2) >> 2;
    d[6] = (p[6] + 3 * p[7] + 2) >> 2;
#pragma unroll
    for (int j = 0; j < 5; ++j) a[j] = (p[j] + p[j + 1] + 1) >> 1;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ddl = sel4(u, d[v], d[v + 1], d[v + 2], d[v + 3]);       // d[v + u]
      const int vl = (u & 1) ? ((u & 2) ? d[v + 1] : d[v])                // j = v + u / 2
                             : ((u & 2) ? a[v + 1] : a[v]);
      pred[v] = cand == 0 ? p[v] : (cand == 1 ? ddl : vl);
    }
    mode = cand == 0 ? 0 : (cand == 1 ? 3 : 7);
  }
  int lv[4], rec[4], bits;
  float score;
  i4_eval<TIER>(s, par, by, bx, u, pred, legal, Q, lam, lane, lv, rec, bits, score);
  const int rb = by * 4 + bx;
  int k;
  if constexpr (TIER == 0) {
    const int c0 = __shfl_sync(FULL, bits, g), c1 = __shfl_sync(FULL, bits, g + 4),
              c2 = __shfl_sync(FULL, bits, g + 8);
    k = c1 < c0 ? 1 : 0;
    k = c2 < (k ? c1 : c0) ? 2 : k;
  } else {
    const float c0 = __shfl_sync(FULL, score, g), c1 = __shfl_sync(FULL, score, g + 4),
                c2 = __shfl_sync(FULL, score, g + 8);
    k = c1 < c0 ? 1 : 0;
    k = c2 < (k ? c1 : c0) ? 2 : k;
  }
  if (active && cand == k) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s.rec4[par][(by * 4 + u) * 16 + bx * 4 + v] = rec[v];
      s.lvz4[par][rb][izz_of(u * 4 + v)] = lv[v];
    }
    if (u == 0) {
      s.mode4[par][rb] = mode;
      if constexpr (TIER == 0) {
        s.wbits[par][rb] = by == 0 ? min(bits, 1 << 24) : bits;
      } else {
        s.wscore[par][rb] = by == 0 ? fminf(score, SCORE_CLAMP) : score;
      }
    }
  }
}

__device__ __forceinline__ void i4_barrier() { asm volatile("bar.sync 2, 64;" ::: "memory"); }

// i16_modes="full", block rows 1-3: one block step with all nine modes on
// both I4 warps, a lane per candidate and row of the block: warp 0's
// lanes 0-19 take V, DDL, VL, DC, H (candidates 0-4), warp 1's lanes 0-15
// HU, DDR, VR, HD (5-8); the other lanes repeat their warp's last
// candidate and write nothing.  Each warp takes its first minimum by
// shuffles and publishes it; after a barrier both read the two, and warp
// 1's wins only where strictly lower, so the first minimum in the
// reference's candidate order wins.  The kept lanes write their rows, and
// a second barrier orders them before the next block reads them.
constexpr unsigned long long FULL_MODES = 0x654812730ull;  // candidate -> mode

template <int TIER>
__device__ __forceinline__ void i4_step_full(Chain& s, int par, int by, int bx, int warp,
                                             int u, const int* left, bool has_left,
                                             const I4Lane& Q, float lam, int lane) {
  const int nloc = warp ? 4 : 5, q = min(lane >> 2, nloc - 1), cand = warp * 5 + q;
  const int y0 = by * 4;
  const int* rec4 = s.rec4[par];
  // t8: the row above (and above-right, or p[3,-1] repeated); l4 and tl:
  // the left column and the top-left sample (from the left MB at bx = 0)
  const int* above = rec4 + (y0 - 1) * 16 + bx * 4;
  const bool tr_avail = (TR_AVAIL_MASK >> (by * 4 + bx)) & 1;
  int p[8], l[4], tl;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[k] = above[k];
    p[4 + k] = tr_avail ? above[4 + k] : above[3];
  }
  if (bx == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) l[k] = left ? left[(y0 + k) * 16 + 15] : 0;
    tl = left ? left[(y0 - 1) * 16 + 15] : 0;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) l[k] = rec4[(y0 + k) * 16 + bx * 4 - 1];
    tl = rec4[(y0 - 1) * 16 + bx * 4 - 1];
  }
  const bool avail = bx > 0 || has_left;
  int pred[4];
  if (warp == 0) {                  // V / DDL / VL / DC / H
    int d[7], a[5];
#pragma unroll
    for (int j = 0; j < 6; ++j) d[j] = (p[j] + 2 * p[j + 1] + p[j + 2] + 2) >> 2;
    d[6] = (p[6] + 3 * p[7] + 2) >> 2;
#pragma unroll
    for (int j = 0; j < 5; ++j) a[j] = (p[j] + p[j + 1] + 1) >> 1;
    const int top = p[0] + p[1] + p[2] + p[3];
    const int dc = avail ? (top + l[0] + l[1] + l[2] + l[3] + 4) >> 3 : (top + 2) >> 2;
    const int lu = sel4(u, l[0], l[1], l[2], l[3]);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ddl = sel4(u, d[v], d[v + 1], d[v + 2], d[v + 3]);
      const int vl = (u & 1) ? ((u & 2) ? d[v + 1] : d[v]) : ((u & 2) ? a[v + 1] : a[v]);
      pred[v] = q == 0 ? p[v] : q == 1 ? ddl : q == 2 ? vl : q == 3 ? dc : lu;
    }
  } else {                          // HU / DDR / VR / HD
    // the edge e = l3 l2 l1 l0 tl p0 .. p7 and its (1, 2, 1) and (1, 1)
    // filters f3[c] (centred on e[c]) and f2[c] (e[c], e[c + 1])
    const int e[13] = {l[3], l[2], l[1], l[0], tl, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
    int f3[13], f2[12];
#pragma unroll
    for (int c = 1; c < 12; ++c) f3[c] = (e[c - 1] + 2 * e[c] + e[c + 1] + 2) >> 2;
    f3[0] = f3[12] = 0;
#pragma unroll
    for (int c = 0; c < 12; ++c) f2[c] = (e[c] + e[c + 1] + 1) >> 1;
    const int z[8] = {(l[0] + l[1] + 1) >> 1, (l[0] + 2 * l[1] + l[2] + 2) >> 2,
                      (l[1] + l[2] + 1) >> 1, (l[1] + 2 * l[2] + l[3] + 2) >> 2,
                      (l[2] + l[3] + 1) >> 1, (l[2] + 3 * l[3] + 2) >> 2,
                      l[3], l[3]};
    // spec 8.3.1.2.5-6 at (y, x), both constant: VR z = 2x - y, HD z = 2y - x
    auto vr = [&](int y, int x) {
      const int zz = 2 * x - y, i = x - (y >> 1);
      return zz < 0 ? f3[5 + zz] : (zz & 1) ? f3[4 + i] : f2[4 + i];
    };
    auto hd = [&](int y, int x) {
      const int zz = 2 * y - x, i = y - (x >> 1);
      return zz < 0 ? f3[3 - zz] : (zz & 1) ? f3[4 - i] : f2[3 - i];
    };
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int hu = sel4(u, z[v], z[min(v + 2, 7)], z[min(v + 4, 7)], z[min(v + 6, 7)]);
      const int ddr = sel4(u, f3[4 + v], f3[3 + v], f3[2 + v], f3[1 + v]);   // f3[4 + v - u]
      const int vrv = sel4(u, vr(0, v), vr(1, v), vr(2, v), vr(3, v));
      const int hdv = sel4(u, hd(0, v), hd(1, v), hd(2, v), hd(3, v));
      pred[v] = q == 0 ? hu : q == 1 ? ddr : q == 2 ? vrv : hdv;
    }
  }
  const bool legal = cand < 4 || avail;
  int lv[4], rec[4], bits;
  float score;
  i4_eval<TIER>(s, par, by, bx, u, pred, legal, Q, lam, lane, lv, rec, bits, score);
  // this warp's first minimum over its candidates (lanes 0, 4, ...)
  int kl = 0, bb = __shfl_sync(FULL, bits, 0);
  float bs = __shfl_sync(FULL, score, 0);
#pragma unroll
  for (int j = 1; j < 5; ++j) {
    const int cb = __shfl_sync(FULL, bits, 4 * j);
    const float cs = __shfl_sync(FULL, score, 4 * j);
    const bool lower = j < nloc && (TIER == 0 ? cb < bb : cs < bs);
    kl = lower ? j : kl;
    bb = lower ? cb : bb;
    bs = lower ? cs : bs;
  }
  if (lane == 0) {
    s.xk[warp] = warp * 5 + kl;
    s.xb[warp] = bb;
    s.xs[warp] = bs;
  }
  i4_barrier();
  const bool w1 = TIER == 0 ? s.xb[1] < s.xb[0] : s.xs[1] < s.xs[0];
  const int k = s.xk[w1 ? 1 : 0];
  if ((lane >> 2) < nloc && cand == k) {
    const int rb = by * 4 + bx;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s.rec4[par][(y0 + u) * 16 + bx * 4 + v] = rec[v];
      s.lvz4[par][rb][izz_of(u * 4 + v)] = lv[v];
    }
    if (u == 0) {
      s.mode4[par][rb] = (int)((FULL_MODES >> (4 * cand)) & 15);
      if constexpr (TIER == 0) {
        s.wbits[par][rb] = min(bits, 1 << 24);
      } else {
        s.wscore[par][rb] = fminf(score, SCORE_CLAMP);
      }
    }
  }
  i4_barrier();
}

// The two I4 warps (i4 = threadIdx.x, 0..63) through one MB's I4 chain:
// row 0 on warp 0 (lanes 0-11); rows 1-3 on both, under the fast sets a
// row at a time (blocks 0-1 on warp 0, 2-3 on warp 1, lanes 0-23), under
// the full set a block at a time (i4_step_full); then the kept costs
// summed in the reference's order into bits4 / score4 (the full set's
// scores a block at a time, in block order).
template <int MODES, int TIER>
__device__ void i4_mb(Chain& s, int par, const int* left, bool has_left, const Qp& qp,
                      float lam, int i4) {
  const int warp = i4 >> 5, lane = i4 & 31, u = lane & 3;
  const I4Lane Q(qp, u);
  if (warp == 0) {
    const int q = min(lane >> 2, 2);          // lanes past 11 repeat DC
    for (int bx = 0; bx < 4; ++bx) {
      i4_step<TIER>(s, par, 0, bx, q, u, 0, lane < 12, left, has_left, Q, lam, lane);
      __syncwarp();
    }
  }
  i4_barrier();
  if constexpr (MODES == MODES_FULL) {
    for (int by = 1; by < 4; ++by)
      for (int bx = 0; bx < 4; ++bx)
        i4_step_full<TIER>(s, par, by, bx, warp, u, left, has_left, Q, lam, lane);
  } else {
    const int q = min(lane >> 2, 5);          // lanes past 23 repeat block 1's VL
    const int bl = q / 3, cand = q % 3, bx = warp * 2 + bl;
    for (int by = 1; by < 4; ++by) {
      i4_step<TIER>(s, par, by, bx, cand, u, bl * 12, lane < 24, left, has_left, Q, lam, lane);
      i4_barrier();
    }
  }
  if (i4 == 0) {
    if constexpr (TIER == 0) {
      int b = 0;
      for (int k = 0; k < 16; ++k) b += s.wbits[par][k];
      s.bits4[par] = b;
    } else if constexpr (MODES == MODES_FULL) {
      float acc = 0.0f;
      for (int k = 0; k < 16; ++k) acc = __fadd_rn(acc, s.wscore[par][k]);
      s.score4[par] = acc;
    } else {
      float acc = 0.0f;
      for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, s.wscore[par][k]);
      for (int r = 1; r < 4; ++r) {
        const float* w = s.wscore[par] + r * 4;
        acc = __fadd_rn(acc, __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[1]), w[2]), w[3]));
      }
      s.score4[par] = acc;
    }
  }
}

// The I16 warp's inputs of one MB: its lane's block of the pre-pass, and
// under hq its source samples.
struct I16In {
  int4 w0, w1, a0, a1;
  int bits;
  int px[16];
};

template <int TIER>
__device__ __forceinline__ I16In load_i16(const int* o, const uint8_t* ys, int W, int b) {
  I16In in;
  const int4* w = reinterpret_cast<const int4*>(o + PRE_W + b * 8);
  const int4* a = reinterpret_cast<const int4*>(o + PRE_AC + b * 8);
  in.w0 = w[0]; in.w1 = w[1]; in.a0 = a[0]; in.a1 = a[1];
  in.bits = o[PRE_BITS + b];
  if constexpr (TIER != 0) {
    const uint8_t* s = ys + (size_t)((b >> 2) * 4) * W + (b & 3) * 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) in.px[i] = s[(i >> 2) * W + (i & 3)];
  }
  return in;
}

// The I4 warps' inputs of one MB into its parity's buffers: warp 0 an
// int4 a lane of the transforms, warp 1 under hq 8 samples a lane.
template <int TIER>
__device__ __forceinline__ int4 load_i4(const int* o, const uint8_t* ys, int W, int i4,
                                        int* px) {
  int4 w = make_int4(0, 0, 0, 0);
  if (i4 < 32) {
    w = reinterpret_cast<const int4*>(o + PRE_W)[i4];
  } else if constexpr (TIER != 0) {
    const int l = i4 - 32;
    const uint8_t* sp = ys + (size_t)(l >> 1) * W + (l & 1) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) px[i] = sp[i];
  }
  return w;
}

template <int TIER>
__device__ __forceinline__ void put_i4(Chain& s, int par, int4 w, const int* px, int i4) {
  if (i4 < 32) {
    reinterpret_cast<int4*>(s.w4[par])[i4] = w;
  } else if constexpr (TIER != 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s.src[par][(i4 - 32) * 8 + i] = px[i];
  }
}

// The I16 warp (warp 2): both I16 candidates of one MB.  Lane =
// candidate * 16 + raster block; returns the candidate's levels in lvl
// for the outputs.
template <int TIER>
__device__ __forceinline__ void i16_mb(Chain& s, int par, const I16In& in, const int* left,
                                       bool has_left, const Qp& Q, int qm, int lane,
                                       int* lvl) {
  const int cand = lane >> 4, b = lane & 15, by = b >> 2, bx = b & 3;
  int ws[16];
  unpack(in.w0, in.w1, ws);
  unpack(in.a0, in.a1, lvl);
  int l[4], pred_dc = 128;
#pragma unroll
  for (int k = 0; k < 4; ++k) l[k] = left ? left[(by * 4 + k) * 16 + 15] : 0;
  if (has_left) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) sum += left[k * 16 + 15];
    pred_dc = (sum + 8) >> 4;
  }
  int dcraw, bac;
  if (cand) {          // H: the prediction's transform is column 0
    int f[4];
    f1d(l, f);
    dcraw = ws[0] - 4 * f[0];
    lvl[4] = Q.q(ws[4] - 4 * f[1], 4);
    lvl[8] = Q.q(ws[8] - 4 * f[2], 8);
    lvl[12] = Q.q(ws[12] - 4 * f[3], 12);
    bac = (in.bits >> 16) + lvl_bits(lvl[4]) + lvl_bits(lvl[8]) + lvl_bits(lvl[12]);
  } else {             // DC: coefficient 0
    dcraw = ws[0] - 16 * pred_dc;
    bac = in.bits & 0xffff;
  }
  // DC Hadamard: quant, inverse, dequant, a lane per coefficient
  s.dcx[cand][b] = dcraw;
  __syncwarp();
  const int wd2 = had_at(s.dcx[cand], b);
  const int a = abs(wd2) >> 1;
  const int dl = Q.q_dc(wd2 < 0 ? -a : a);
  const int bdc = sum16(lvl_bits(dl));
  __syncwarp();
  s.dcx[cand][b] = dl;
  s.dcl[par][cand][b] = dl;
  __syncwarp();
  const int fd = had_at(s.dcx[cand], b);
  const int v00 = c_v[0][Q.m];
  const int dcy = qm >= 12 ? fd * v00 * (1 << (Q.s - 2))
                           : (fd * v00 + (1 << (1 - Q.s))) >> (2 - Q.s);
  int wr[16], res[16];
  wr[0] = dcy;
#pragma unroll
  for (int i = 1; i < 16; ++i) wr[i] = Q.dq(lvl[i], i);
  idct4(wr, res);
  int ssd = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int v = min(max((cand ? l[i >> 2] : pred_dc) + res[i], 0), 255);
    s.rec16[par][cand][(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] = v;
    if constexpr (TIER != 0) {
      const int d = v - in.px[i];
      ssd += d * d;
    }
  }
  const int btot = bdc + sum16(bac);
  if constexpr (TIER != 0) ssd = sum16(ssd);
  if (b == 0) {
    s.t16[par][cand] = btot;
    if constexpr (TIER != 0) s.t16[par][2 + cand] = ssd;
  }
}

// Warp 3: chroma's DC chain along the row.  Lane = plane * 4 + block for
// lanes 0-7; lanes 8-31 mirror them and write nothing.
template <int TIER>
__device__ void chroma_row(const int* __restrict__ pre, int* cb_dc, int* cr_dc, uint8_t* rcb,
                           uint8_t* rcr, const int* __restrict__ qp_map, int r, int nc,
                           int qpc, int lane) {
  const int p = (lane >> 2) & 1, q = lane & 3, by = q >> 1, bx = q & 1, g = p * 4;
  const int Wc = nc * 8;
  uint8_t* const plane = p ? rcr : rcb;
  int* const dc_out = p ? cr_dc : cb_dc;
  int colsum = 0;     // the sum of this block's right column (q odd: the left of the next MB)
  for (int c = 0; c < nc; ++c) {
    const int mbi = r * nc + c;
    const Qp QC(TIER == 2 ? dngd_chroma_qp(qp_map[mbi]) : qpc);
    const int* o = pre + (size_t)mbi * PRE_WORDS;
    const int w0 = o[PRE_WC + p * 4 + q];
    int lv[16];
    load_packed(o + PRE_CAC + (p * 4 + q) * 8, lv);
    const int ls = __shfl_sync(FULL, colsum, g + by * 2 + 1);
    const int pred = c > 0 ? (ls + 2) >> 2 : 128;
    const int dcraw = w0 - 16 * pred;
    const int d0 = __shfl_sync(FULL, dcraw, g), d1 = __shfl_sync(FULL, dcraw, g + 1),
              d2 = __shfl_sync(FULL, dcraw, g + 2), d3 = __shfl_sync(FULL, dcraw, g + 3);
    const int dl = QC.q_dc(had2_at(d0, d1, d2, d3, q));
    const int e0 = __shfl_sync(FULL, dl, g), e1 = __shfl_sync(FULL, dl, g + 1),
              e2 = __shfl_sync(FULL, dl, g + 2), e3 = __shfl_sync(FULL, dl, g + 3);
    const int fd = had2_at(e0, e1, e2, e3, q);
    int wr[16], res[16];
    wr[0] = (fd * c_v[0][QC.m] * (1 << QC.s)) >> 1;
#pragma unroll
    for (int i = 1; i < 16; ++i) wr[i] = QC.dq(lv[i], i);
    idct4(wr, res);
    int rec[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) rec[i] = min(max(pred + res[i], 0), 255);
    if (lane < 8) {
      uint8_t* d = plane + (size_t)(r * 8 + by * 4) * Wc + c * 8 + bx * 4;
#pragma unroll
      for (int i = 0; i < 16; ++i) d[(i >> 2) * Wc + (i & 3)] = (uint8_t)rec[i];
      dc_out[mbi * 4 + q] = dl;
    }
    colsum = rec[3] + rec[7] + rec[11] + rec[15];
  }
}

template <int MODES, int TIER>
__global__ void __launch_bounds__(128) intra_chain_kernel(
    const uint8_t* __restrict__ y, const int* __restrict__ pre, int* luma_dc, int* luma_ac,
    int* cb_dc, int* cr_dc, int* pred_mode, uint8_t* mb_i4, int* i4_modes, int* luma_i4,
    uint8_t* ry, uint8_t* rcb, uint8_t* rcr, const int* __restrict__ qp_map,
    const float* __restrict__ lam_tab, const float* __restrict__ sig_tab, int nc, int qp,
    int qpc) {
  __shared__ Chain s;
  // r: the MB row of the stack.  blockIdx.y is the session: sessions'
  // planes and outputs are stacked contiguously, a session's stride is
  // gridDim.x MB rows, and no row reads another (slice per MB row)
  const int r = blockIdx.y * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 3) {
    chroma_row<TIER>(pre, cb_dc, cr_dc, rcb, rcr, qp_map, r, nc, qpc, lane);
    return;
  }
  const int W = nc * 16;
  const uint8_t* const yrow = y + (size_t)r * 16 * W;
  const int* const pre_row = pre + (size_t)r * nc * PRE_WORDS;
  // the I4 warps have no candidate to code under "i16" and "dc"
  constexpr bool I4 = MODES <= MODES_FULL;
  const bool is_i4 = warp < 2;
  const int i4 = threadIdx.x, b = lane & 15;
  int px[TIER != 0 ? 8 : 1];
  int4 w4n;
  I16In in16;
  if (is_i4) {
    if constexpr (I4) {
      w4n = load_i4<TIER>(pre_row, yrow, W, i4, px);
      put_i4<TIER>(s, 0, w4n, px, i4);
    }
  } else {
    in16 = load_i16<TIER>(pre_row, yrow, W, b);
  }
  luma_barrier();
  int sel = 0, use4 = 0;          // the previous MB's decision
  for (int c = 0; c < nc; ++c) {
    const int par = c & 1, mbi = r * nc + c;
    const bool has_left = c > 0, more = c + 1 < nc;
    const int qm = TIER == 2 ? qp_map[mbi] : qp;
    const Qp Q(qm);
    const float lam = TIER != 0 ? lam_tab[qm] : 0.0f;
    // the left column: the previous MB's chosen reconstruction
    const int* left = has_left ? (use4 ? s.rec4[par ^ 1] : s.rec16[par ^ 1][sel]) : nullptr;
    int lvl[16];
    if (is_i4) {
      if constexpr (I4) {
        if (more)
          w4n = load_i4<TIER>(pre_row + (c + 1) * PRE_WORDS, yrow + (c + 1) * 16, W, i4, px);
        i4_mb<MODES, TIER>(s, par, left, has_left, Q, lam, i4);
        if (more) put_i4<TIER>(s, par ^ 1, w4n, px, i4);
      }
    } else {
      I16In nxt;
      if (more) nxt = load_i16<TIER>(pre_row + (c + 1) * PRE_WORDS, yrow + (c + 1) * 16, W, b);
      i16_mb<TIER>(s, par, in16, left, has_left, Q, qm, lane, lvl);
      if (more) in16 = nxt;
    }
    luma_barrier();

    // --- decisions: I16 DC vs H, then I16 vs I4 (all three warps) ------
    const int b_dc = s.t16[par][0], b_h = s.t16[par][1];
    // ("dc": the H lanes of the I16 warp run beside DC's, never chosen)
    if constexpr (TIER == 0) {
      const bool use_h = MODES != MODES_DC && has_left && b_h < b_dc;
      sel = use_h;
      if constexpr (I4) use4 = s.bits4[par] + I4_SIG_BITS < (use_h ? b_h : b_dc);
    } else {
      const float sc_dc = __fmaf_rn(lam, (float)b_dc, (float)s.t16[par][2]);
      const float sc_h = __fmaf_rn(lam, (float)b_h, (float)s.t16[par][3]);
      const bool use_h = MODES != MODES_DC && has_left && sc_h < sc_dc;
      sel = use_h;
      if constexpr (I4) {
        const float i4s = TIER == 2 ? __fmaf_rn(lam, (float)I4_SIG_BITS, s.score4[par])
                                    : __fadd_rn(s.score4[par], sig_tab[qm]);
        use4 = i4s < (use_h ? sc_h : sc_dc);
      }
    }

    if (is_i4) {
      // without I4: the reference's constants (levels 0, modes DC)
      const int* yrec = use4 ? s.rec4[par] : s.rec16[par][sel];
      for (int i = i4; i < 256; i += 64) {
        ry[(size_t)(r * 16 + (i >> 4)) * W + c * 16 + (i & 15)] = (uint8_t)yrec[i];
        const int blk = i >> 4, k = i & 15;
        luma_i4[(mbi * 16 + blk) * 16 + k] = I4 ? s.lvz4[par][raster_of_blk(blk)][k] : 0;
      }
      if (i4 < 16) i4_modes[mbi * 16 + i4] = I4 ? s.mode4[par][raster_of_blk(i4)] : 2;
    } else {
      if ((lane >> 4) == sel) {
        int* const ac = luma_ac + (size_t)(mbi * 16 + blk_of_raster(b)) * 15;
#pragma unroll
        for (int k = 1; k < 16; ++k) ac[k - 1] = lvl[zz_of(k)];
      }
      if (lane < 16) luma_dc[mbi * 16 + lane] = s.dcl[par][sel][zz_of(lane)];
      if (lane == 16) {
        pred_mode[mbi] = sel ? 1 : 2;
        mb_i4[mbi] = (uint8_t)use4;
      }
    }
  }
}

#define INTRA_PARAMS                                                                      \
  const uint8_t *y, const uint8_t *cb, const uint8_t *cr, int *luma_dc, int *luma_ac,     \
      int *cb_dc, int *cb_ac, int *cr_dc, int *cr_ac, int *pred_mode, uint8_t *mb_i4,     \
      int *i4_modes, int *luma_i4, uint8_t *ry, uint8_t *rcb, uint8_t *rcr, int *pre,     \
      const int *qp_map, const float *lam, const float *sig, int nr, int nc, int qp,      \
      int qpc, int ns, cudaStream_t stream
#define INTRA_ARGS                                                                     \
  y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode, mb_i4, i4_modes, \
      luma_i4, ry, rcb, rcr, pre, qp_map, lam, sig, nr, nc, qp, qpc, ns, stream

template <int MODES, int TIER>
int launch_intra(INTRA_PARAMS) {
  const int nmb = nr * nc * ns;
  intra_pre_kernel<TIER><<<(nmb + 3) / 4, 128, 0, stream>>>(y, cb, cr, cb_ac, cr_ac, pre,
                                                             qp_map, nmb, nc, qp, qpc);
  const int e = dngd_last_error();
  if (e) return e;
  intra_chain_kernel<MODES, TIER><<<dim3(nr, ns), 128, 0, stream>>>(
      y, pre, luma_dc, luma_ac, cb_dc, cr_dc, pred_mode, mb_i4, i4_modes, luma_i4, ry, rcb,
      rcr, qp_map, lam, sig, nc, qp, qpc);
  return dngd_last_error();
}

// modes: 0 auto, 1 full, 2 i16, 3 dc (each a form of the chain pass)
template <int TIER>
int launch_modes(int modes, INTRA_PARAMS) {
  switch (modes) {
    case MODES_AUTO: return launch_intra<MODES_AUTO, TIER>(INTRA_ARGS);
    case MODES_FULL: return launch_intra<MODES_FULL, TIER>(INTRA_ARGS);
    case MODES_I16: return launch_intra<MODES_I16, TIER>(INTRA_ARGS);
    case MODES_DC: return launch_intra<MODES_DC, TIER>(INTRA_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ns: sessions (1 = one frame), each nr x nc MBs, stacked on the planes'
// and outputs' leading axis; scratch: ns * nr * nc * 352 int32 for the
// pre-pass's words; modes: the mode set (0 auto, 1 full, 2 i16, 3 dc).
extern "C" int intra_frame_launch(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int* luma_dc,
    int* luma_ac, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
    int* pred_mode, uint8_t* mb_i4, int* i4_modes, int* luma_i4, uint8_t* ry,
    uint8_t* rcb, uint8_t* rcr, int* scratch, int nr, int nc, int qp, int qpc, int modes,
    int ns, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  return launch_modes<0>(modes, y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                         pred_mode, mb_i4, i4_modes, luma_i4, ry, rcb, rcr, scratch, nullptr,
                         nullptr, nullptr, nr, nc, qp, qpc, ns, stream);
}

// tune=hq: tier 1 (hq_noaq) or 2 (hq, qp_map the qp plane); lam the
// tier's lambda table (52 float32), sig hq_noaq's I4 signalling costs.
extern "C" int intra_frame_hq_launch(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int* luma_dc,
    int* luma_ac, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
    int* pred_mode, uint8_t* mb_i4, int* i4_modes, int* luma_i4, uint8_t* ry,
    uint8_t* rcb, uint8_t* rcr, int* scratch, const int* qp_map, const float* lam,
    const float* sig, int nr, int nc, int qp, int qpc, int modes, int tier,
    cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  if (tier == 2) {
    if (!qp_map) return cudaErrorInvalidValue;
    return launch_modes<2>(modes, y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                           pred_mode, mb_i4, i4_modes, luma_i4, ry, rcb, rcr, scratch, qp_map,
                           lam, sig, nr, nc, qp, qpc, 1, stream);
  }
  if (tier == 1)
    return launch_modes<1>(modes, y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac,
                           pred_mode, mb_i4, i4_modes, luma_i4, ry, rcb, rcr, scratch, qp_map,
                           lam, sig, nr, nc, qp, qpc, 1, stream);
  return cudaErrorInvalidValue;
}
