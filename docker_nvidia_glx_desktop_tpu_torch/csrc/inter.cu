// K5 — H.264 P core: motion estimation (coarse grid, +-1 integer, half-
// and quarter-pel refinement), motion compensation (6-tap luma, 1/8-pel
// bilinear chroma), inter residual transform/quant and the closed-loop
// reconstruction of one frame.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/h264_inter.py:272
// encode_p_frame / :300 encode_p_frame_padded_ref (refine="alt",
// tune="off", p_intra=False); bit-exact with it.  refine="full" (:428-447,
// :453-528, the round-5 refinement the bench times) is the FULL template
// flag: the +-1 re-rank and both subpel stages score every luma line with
// full-strength margins (128 / 96 / 64, or the full-line lambda tables),
// the coarse stage stays on even lines at /2.
//
// What bounds it: integer operations, not bytes.  It reads the two
// frames once (~6 MB at 1080p) but every MB scores 81 coarse candidates
// plus 9 + 8 + 8 refinement candidates of 128 even-line pels each, and
// builds 3 x 18 x 18 interpolated samples.  Every MB is independent
// (slice per MB row, left-only MV prediction, motion search reads only
// the reference).  At 1080p the operations bound is 0.0104 ms (tier 0,
// chip_smoke.k5_ops over 67 T/s); the kernel's device time is 0.0310 ms
// against the block-per-MB design's 0.1810 (H100 80GB HBM3, 700 W,
// torch.profiler in chip_smoke.py's k5k4 pairs), 0.0376 against 0.1866
// as a graph replay.
//
// Design (redesigned for Hopper; one launch a frame, plus two for
// I16-in-P): a warp per MB, a block of eight warps per run of eight MBs
// along a row.
//  - The block stages the reference strip its eight windows share (MB
//    +- 13 pels: 42 rows x 176 bytes) once, as bytes, with 16-byte
//    cp.async copies; the chunks past the frame's left and right edges,
//    and every chunk of the padded form, are copied byte by byte with the
//    coordinates clamped as the reference's edge padding.  That is the
//    kernel's only block barrier.
//  - Pels stay bytes, four to a 32-bit word: a candidate's 16-pel row is
//    five shared words funnel-shifted to its byte offset, and its SAD
//    four __vsadu4.  SADs are integers throughout.
//  - Coarse grid: 27 lanes, a lane per column shift dx and three row
//    shifts dy; a lane walks its 16 reference rows once, each row
//    serving the three shifts whose even line it is.  The +-1 re-rank
//    takes two lanes a candidate, the subpel stages four.
//  - Each stage's first minimum is one __reduce_min_sync over a key
//    (SAD - bias + 2^16) << 7 | k: the smallest key is the smallest
//    biased SAD with the lowest index, jnp.argmin's first minimum.  The
//    biases and the subpel `use` rules are the reference's.
//  - The b, h and j planes around mv_int are built as bytes in two warp
//    passes: a lane per source row filters horizontally (b, and the
//    unrounded b1 kept as 16-bit with 32 x the window's pels beside it),
//    then a lane per column and half filters vertically (h from 32 x
//    window, j from b1: the same (x + 512) >> 10).
//  - The residual takes 24 lanes, one 4x4 block each (16 luma, 8 chroma)
//    on one code path: transform, quant, dequant, inverse and recon in
//    registers, the chroma DC Hadamards by shuffles among each plane's
//    four lanes.  Under tune=hq the levels and recon stay in registers
//    until the forced-skip decision; its sums are warp reductions of
//    integers and the decision the reference's float32 order (__fadd_rn,
//    __fmaf_rn).
//
// K5r, the same kernel over a worklist of MB rows, replaces
// docker_nvidia_glx_desktop_tpu/ops/damage_mask.py:170 row_core's P
// core (its vmap of encode_p_frame_padded_ref over row bands cut from
// the edge-padded reference): with a `rows` array of b MB rows the grid
// covers b rows of MB runs, stack row i encodes frame row rows[i] and
// writes compacted (b, nc, ...) outputs and (16b, W) / (8b, W/2) recon
// planes.  A band's search window is clamped at the frame's edges, not the
// band's, because the kernel reads the whole reference either way.  At
// every tier (row_core's `tune`): the qp plane arrives compacted (b, nc),
// and the I16-in-P candidate pass reads the current frame at frame row
// rows[i] but its left neighbour's recon, like every output, at stack
// row i; the gate and the merge walk stack rows.
// With `qp_dev` the slice qp (and its QPc) is read from device memory,
// so a captured CUDA graph takes each chunk's qp without a new capture.
//
// tune=hq (h264_inter.py:346-366, the TIER template parameter: 1
// hq_noaq, 2 hq with the qp plane): the motion margins become
// (int)(lam_mv * bits) per qp (host tables, :388-393, :444-447, :480-483,
// :545-548), TIER 2 quantises at the MB's qp, and a zero-MV MB whose
// skip SSD is at most its coded SSD + lam * (bits + 12) is coded as
// P_Skip (:651-686: levels zeroed, the recon is the prediction), the
// float32 sums and the fused multiply-add in the reference's order.
// With I16-in-P (:688-782) two more launches follow, each a warp an MB and
// a block a run of eight MBs along a row (redesigned for Hopper; what
// bounds them: bytes, ~11.5 MB at 1080p, the current planes read and the
// I16 keys written).  The first scores every MB's I16 DC candidate, built
// from its left neighbour's skip-merged inter recon (written by this
// kernel), against the inter score this kernel leaves and writes one
// `want` byte an MB; the second gates each MB from its row's want bytes
// (the run-parity gate) and only the kept MBs (a few percent on desktop
// content) build their candidate again and merge its levels, MV and
// recon; every other MB stores zero I16 keys.  No candidate goes through
// device memory.
//
// K5p, the padded-reference form (the PAD template flag), replaces
// docker_nvidia_glx_desktop_tpu/ops/h264_inter.py:300
// encode_p_frame_padded_ref as the spatial shards call it
// (parallel/batch.py:756): each shard's reference arrives padded by _PAD
// = WO pels on every side (csrc/spatial.cu's halo pad: the neighbour
// shard's rows at a seam, edge copies at the frame's edges), so the
// strip and the chroma taps read the padded plane at +WO with no clamp.
// The grid covers all shards' MBs as one frame's (a shard's rows are
// frame rows s*nr .. s*nr + nr - 1), so only the reference pointer
// depends on the shard; every tier comes with it.
#include <climits>

#include "common.cuh"
#include "transform.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NT = 256;
constexpr int MPB = NT / 32;          // MBs a block, a warp each
constexpr int ZERO_MV_BIAS = 128, HALF_BIAS = 96, QUARTER_BIAS = 64;
constexpr int SCALE = 2;              // refinement SADs use even lines only
constexpr int WO = 13;                // MB origin inside the window (_PAD)
constexpr int WIN = 16 + 2 * WO;      // reference window side
constexpr int PW = 18;                // interpolated window side (mv_int-1..+16)
constexpr int SP = 16 * MPB + 48;     // strip row pitch (bytes): 16-byte chunks
constexpr int CH = SP / 16;           // from the MB column before the run's
constexpr int PP = 20;                // interpolated plane row pitch (bytes)
constexpr int SRC_H = PW + 5;         // vertical filter pass: source rows
constexpr int KEY_OFF = 1 << 16;      // argmin keys: biased SAD + KEY_OFF >= 0

// quarter-sample prediction per fraction fy*4+fx: part count, then
// (plane, dy, dx) twice; planes 0 full, 1 b, 2 h, 3 j
__constant__ int c_qpel[16][7] = {
    {1, 0, 0, 0, 0, 0, 0}, {2, 0, 0, 0, 1, 0, 0}, {1, 1, 0, 0, 0, 0, 0},
    {2, 1, 0, 0, 0, 0, 1}, {2, 0, 0, 0, 2, 0, 0}, {2, 1, 0, 0, 2, 0, 0},
    {2, 1, 0, 0, 3, 0, 0}, {2, 1, 0, 0, 2, 0, 1}, {1, 2, 0, 0, 0, 0, 0},
    {2, 2, 0, 0, 3, 0, 0}, {1, 3, 0, 0, 0, 0, 0}, {2, 3, 0, 0, 2, 0, 1},
    {2, 2, 0, 0, 0, 1, 0}, {2, 2, 0, 0, 1, 1, 0}, {2, 3, 0, 0, 1, 1, 0},
    {2, 2, 0, 1, 1, 1, 0}};

// one warp's MB
struct WarpSmem {
  uint32_t cur[64];                   // current luma, 16 rows x 16 bytes
  uint32_t curc[2][16];               // current chroma, 8 rows x 8 bytes
  uint32_t pl[3][PW * PP / 4];        // b, h, j around mv_int, 18 x 20 bytes
  uint32_t src[SRC_H][PW];            // 16-bit: 32 x window | b1, 23 x 36
  uint32_t pred[64];
  uint32_t predc[2][16];
};

struct BlockSmem {
  uint32_t strip[WIN * SP / 4];       // reference rows r*16-13.., bytes
  int qpel[16][7];
  WarpSmem w[MPB];
};

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// 6-tap (1, -5, 20, 20, -5, 1) over six samples, unrounded
__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// neighbour k of a refinement centre (dy outer, dx inner, centre skipped)
__device__ __forceinline__ int nb_y(int k) { return (k + (k >= 4)) / 3 - 1; }
__device__ __forceinline__ int nb_x(int k) { return (k + (k >= 4)) % 3 - 1; }

__device__ __forceinline__ uint32_t key_of(int sad, int k) {
  return (static_cast<uint32_t>(sad + KEY_OFF) << 7) | static_cast<uint32_t>(k);
}
__device__ __forceinline__ int key_sad(uint32_t key) {
  return static_cast<int>(key >> 7) - KEY_OFF;
}

// the 4 bytes at byte offset o of a word array
__device__ __forceinline__ uint32_t word_at(const uint32_t* base, int o) {
  const uint32_t* p = base + (o >> 2);
  return __funnelshift_r(p[0], p[1], (o & 3) * 8);
}

// the 16 bytes at byte offset o of a word array, as four words
__device__ __forceinline__ void row_at(const uint32_t* base, int o, uint32_t r[4]) {
  const uint32_t* p = base + (o >> 2);
  const int sh = (o & 3) * 8;
  const uint32_t a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3], a4 = p[4];
  r[0] = __funnelshift_r(a0, a1, sh);
  r[1] = __funnelshift_r(a1, a2, sh);
  r[2] = __funnelshift_r(a2, a3, sh);
  r[3] = __funnelshift_r(a3, a4, sh);
}

__device__ __forceinline__ int sad16(const uint4 c, const uint32_t r[4]) {
  return static_cast<int>(__vsadu4(c.x, r[0]) + __vsadu4(c.y, r[1]) + __vsadu4(c.z, r[2]) +
                          __vsadu4(c.w, r[3]));
}

// The four planes around mv_int: plane 0 (full) is the strip itself, b, h
// and j the warp's buffers; (a, x) is plane row a, byte column x, luma
// position (mv_int - 1 + a, mv_int - 1 + x) relative to the MB.
struct Planes {
  const uint32_t* strip;
  const uint32_t* pl;
  int o0;                             // plane 0's (0, 0) in the strip
  __device__ const uint32_t* base(int p) const {
    return p ? pl + (p - 1) * (PW * PP / 4) : strip;
  }
  __device__ int off(int p, int a, int x) const { return p ? a * PP + x : o0 + a * SP + x; }
};

// the quarter-pel prediction of fraction f at integer offset (ry, rx) from
// mv_int, plane row 1 + ry + i, as the word at byte column 1 + rx + j0
__device__ __forceinline__ uint32_t qword(const Planes& P, const int* q, int ry, int rx, int i,
                                          int j0) {
  const uint32_t a = word_at(P.base(q[1]), P.off(q[1], 1 + ry + q[2] + i, 1 + rx + q[3] + j0));
  if (q[0] == 1) return a;
  return __vavgu4(a, word_at(P.base(q[4]), P.off(q[4], 1 + ry + q[5] + i, 1 + rx + q[6] + j0)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// coefficient position class of i = row*4 + col, and the zigzag scan, as
// compile-time functions of an unrolled index
__device__ constexpr int cls(int i) {
  return (((i >> 2) & 1) == 0 && (i & 1) == 0) ? 0 : ((((i >> 2) & 1) == 1 && (i & 1) == 1) ? 1 : 2);
}
__device__ constexpr int zz(int k) {
  return static_cast<int>((0xfeb7adc963258410ull >> (4 * k)) & 15);
}

// inter quant at one qp, the class tables in registers
struct QLane {
  int mf[3], v[3], f, qbits, s;
  __device__ explicit QLane(int qp) {
    const int m = qp % 6;
    s = qp / 6;
    qbits = 15 + s;
    f = (1 << qbits) / 6;
    for (int c = 0; c < 3; ++c) {
      mf[c] = c_mf[c][m];
      v[c] = c_v[c][m];
    }
  }
};

// The residual of one 4x4 block a lane (24 lanes: luma block `lane` in
// luma4x4BlkIdx order, then Cb's four and Cr's four), with the MB's
// outputs; TIER != 0 takes the forced-skip decision first.
template <int TIER>
__device__ void residual(WarpSmem& ws, int lane, int mb, int orow, int c, int W, int Wc,
                         int qm, int qcm, int mvy, int mvx, float lam, int* luma, int* cb_dc,
                         int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry, uint8_t* rcb,
                         uint8_t* rcr, float* score_out) {
  const bool is_c = lane >= 16, live = lane < 24;
  const int L = min(lane, 23), cq = (L - 16) & 3, cp = (L - 16) >> 2;
  int bx, by;
  const uint32_t* cw;
  uint32_t* pw;
  int pitch;
  if (!is_c) {
    bx = (L & 1) + ((L >> 2) & 1) * 2;
    by = ((L >> 1) & 1) + (L >> 3) * 2;
    cw = ws.cur + by * 16 + bx;
    pw = ws.pred + by * 16 + bx;
    pitch = 4;
  } else {
    bx = cq & 1;
    by = cq >> 1;
    cw = ws.curc[cp] + by * 8 + bx;
    pw = ws.predc[cp] + by * 8 + bx;
    pitch = 2;
  }
  int x[16], pr[16], w[16], lv[16], rec[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = cw[i * pitch], b = pw[i * pitch];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[i * 4 + j] = (a >> (8 * j)) & 255;
      pr[i * 4 + j] = (b >> (8 * j)) & 255;
    }
  }
  {
    int blk[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) blk[k] = x[k] - pr[k];
    fdct4(blk, w);
  }
  const QLane Q(is_c ? qcm : qm);
#pragma unroll
  for (int k = 0; k < 16; ++k) lv[k] = quant(w[k], Q.mf[cls(k)], Q.f, Q.qbits);
  // chroma DC: the 2x2 Hadamard across the plane's four lanes, quantised,
  // inverted and dequantised the same way
  const int base = lane & ~3;
  const int s1 = (cq & 1) ? -1 : 1, s2 = (cq & 2) ? -1 : 1;
  int dcl, dcc;
  {
    const int x0 = __shfl_sync(FULL_MASK, w[0], base), x1 = __shfl_sync(FULL_MASK, w[0], base + 1),
              x2 = __shfl_sync(FULL_MASK, w[0], base + 2),
              x3 = __shfl_sync(FULL_MASK, w[0], base + 3);
    dcl = quant(x0 + s1 * x1 + s2 * x2 + s1 * s2 * x3, Q.mf[0], 2 * Q.f, Q.qbits + 1);
    const int y0 = __shfl_sync(FULL_MASK, dcl, base), y1 = __shfl_sync(FULL_MASK, dcl, base + 1),
              y2 = __shfl_sync(FULL_MASK, dcl, base + 2),
              y3 = __shfl_sync(FULL_MASK, dcl, base + 3);
    dcc = ((y0 + s1 * y1 + s2 * y2 + s1 * s2 * y3) * Q.v[0] << Q.s) >> 1;
  }
  if (is_c) lv[0] = 0;
  {
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = lv[k] * Q.v[cls(k)] * (1 << Q.s);
    if (is_c) d[0] = dcc;
    idct4(d, rec);
  }
  int v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = clip255(pr[k] + rec[k]);

  bool force = false;
  if constexpr (TIER != 0) {
    int sc = 0, ss = 0, bits = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      sc += (v[k] - x[k]) * (v[k] - x[k]);
      ss += (pr[k] - x[k]) * (pr[k] - x[k]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (lv[k]) bits += 3 + 2 * flog2(abs(lv[k]));
    if (is_c && dcl) bits += 3 + 2 * flog2(abs(dcl));
    const int ly = lane < 16, lb = lane >= 16 && lane < 20, lr = lane >= 20 && lane < 24;
    const int yc = __reduce_add_sync(FULL_MASK, ly ? sc : 0);
    const int ys = __reduce_add_sync(FULL_MASK, ly ? ss : 0);
    const int bc = __reduce_add_sync(FULL_MASK, lb ? sc : 0);
    const int bs = __reduce_add_sync(FULL_MASK, lb ? ss : 0);
    const int rc = __reduce_add_sync(FULL_MASK, lr ? sc : 0);
    const int rs = __reduce_add_sync(FULL_MASK, lr ? ss : 0);
    const int nbits = __reduce_add_sync(FULL_MASK, live ? bits : 0);
    // (Y + Cb) + Cr in float32; d_skip <= d_coded + lam * (bits + 12)
    const float d_coded = __fadd_rn(__fadd_rn((float)yc, (float)bc), (float)rc);
    const float d_skip = __fadd_rn(__fadd_rn((float)ys, (float)bs), (float)rs);
    const float coded = __fmaf_rn(lam, __fadd_rn((float)nbits, 12.0f), d_coded);
    force = mvy == 0 && mvx == 0 && d_skip <= coded;
    if (score_out && lane == 0) score_out[mb] = force ? __fadd_rn(d_skip, lam) : coded;
  }
  // the outputs through the warp's shared memory (the vertical filter's
  // source, dead by now; the recon over the prediction, whose words every
  // lane has read), then stored with 16-byte accesses: levels at a stride
  // of 17 (luma) and 15 (chroma) words, one bank a lane
  int* stage = reinterpret_cast<int*>(ws.src);
  __syncwarp();
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= static_cast<uint32_t>(force ? pr[i * 4 + j] : v[i * 4 + j]) << (8 * j);
      pw[i * pitch] = word;
    }
    if (!is_c) {
#pragma unroll
      for (int k = 0; k < 16; ++k) stage[L * 17 + k] = force ? 0 : lv[zz(k)];
    } else {
#pragma unroll
      for (int k = 1; k < 16; ++k) stage[272 + (L - 16) * 15 + k - 1] = force ? 0 : lv[zz(k)];
      stage[392 + L - 16] = force ? 0 : dcl;
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {       // luma levels: 64 int4
    const int q = lane + 32 * h, b = q >> 2, k = 4 * (q & 3);
    reinterpret_cast<int4*>(luma + mb * 256)[q] =
        make_int4(stage[b * 17 + k], stage[b * 17 + k + 1], stage[b * 17 + k + 2],
                  stage[b * 17 + k + 3]);
  }
  if (lane < 30) {                    // chroma AC: 15 int4 a plane
    const int p = lane / 15, o = 272 + p * 60 + 4 * (lane - 15 * p);
    reinterpret_cast<int4*>((p ? cr_ac : cb_ac) + mb * 60)[lane - 15 * p] =
        make_int4(stage[o], stage[o + 1], stage[o + 2], stage[o + 3]);
  } else {                            // chroma DC: one int4 a plane
    const int p = lane - 30, o = 392 + 4 * p;
    *reinterpret_cast<int4*>((p ? cr_dc : cb_dc) + mb * 4) =
        make_int4(stage[o], stage[o + 1], stage[o + 2], stage[o + 3]);
  }
  if (lane < 16) {                    // recon: a luma row a lane, then chroma
    *reinterpret_cast<uint4*>(ry + (size_t)(orow * 16 + lane) * W + c * 16) =
        reinterpret_cast<const uint4*>(ws.pred)[lane];
  } else {
    const int p = (lane - 16) >> 3, i = lane & 7;
    *reinterpret_cast<uint2*>((p ? rcr : rcb) + (size_t)(orow * 8 + i) * Wc + c * 8) =
        reinterpret_cast<const uint2*>(ws.predc[p])[i];
  }
}

template <int TIER, bool SESS = false, bool PAD = false, bool FULL = false>
__global__ void __launch_bounds__(NT) inter_frame_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* __restrict__ ref_y,
    const uint8_t* __restrict__ ref_cb, const uint8_t* __restrict__ ref_cr,
    const int* __restrict__ rows, const int* __restrict__ qp_dev,
    const int* __restrict__ qp_map, const float* __restrict__ lam_tab,
    const int* __restrict__ marg, float* score_out, int* mv_out, int* luma,
    int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
    int nr, int nc, int qp, int qpc, int vec) {
  __shared__ __align__(16) BlockSmem s;
  const int t = threadIdx.x, lane = t & 31, m = t >> 5;
  // block: the run of MPB MBs from column c0 of output row orow
  const int ncg = (nc + MPB - 1) / MPB;
  const int orow = blockIdx.x / ncg, c0 = (blockIdx.x - orow * ncg) * MPB, c = c0 + m;
  if constexpr (SESS) {
    // blockIdx.y: the session.  Sessions' frames, references (nr x nc
    // MBs each) and outputs (a grid's rows of nc MBs each) are stacked
    // contiguously;
    // a session's search clamps at its own frame's edges.  (One session
    // launches the !SESS form: its pointers stay kernel parameters.)
    const size_t sess = blockIdx.y, fl = sess * nr * nc * 256,
                 om = sess * (gridDim.x / ncg) * nc;
    y += fl;
    cb += fl / 4;
    cr += fl / 4;
    ref_y += fl;
    ref_cb += fl / 4;
    ref_cr += fl / 4;
    mv_out += om * 2;
    luma += om * 256;
    cb_dc += om * 4;
    cr_dc += om * 4;
    cb_ac += om * 60;
    cr_ac += om * 60;
    ry += om * 256;
    rcb += om * 64;
    rcr += om * 64;
    if (qp_map) qp_map += om;
    if (score_out) score_out += om;
  }
  // r: the frame MB row the block encodes
  const int r = rows ? rows[orow] : orow;
  // PAD: the grid covers the shards' rows as one frame's (nr rows a
  // shard); frame row r is row pr of its shard, whose padded references
  // follow the previous shard's
  int pr = r;
  if constexpr (PAD) {
    const int sh = r / nr;
    pr = r - sh * nr;
    ref_y += (size_t)sh * (nr * 16 + 2 * WO) * (nc * 16 + 2 * WO);
    ref_cb += (size_t)sh * (nr * 8 + 2 * WO) * (nc * 8 + 2 * WO);
    ref_cr += (size_t)sh * (nr * 8 + 2 * WO) * (nc * 8 + 2 * WO);
  }
  const int H = nr * 16, W = nc * 16, Hc = nr * 8, Wc = nc * 8;

  // --- the strip: strip byte (u, x) is reference row r*16 - WO + u and
  //     column (c0 - 1)*16 + x, clamped (PAD: padded row pr*16 + u, column
  //     c0*16 - 3 + x); MB m's window column v is strip column 16m + 3 + v
  uint8_t* strip_b = reinterpret_cast<uint8_t*>(s.strip);
  for (int ch = t; ch < WIN * CH; ch += NT) {
    const int u = ch / CH, j = ch - u * CH;
    uint8_t* dst = strip_b + u * SP + 16 * j;
    const uint8_t* row;
    int x0, wl;
    if constexpr (PAD) {
      wl = W + 2 * WO;
      row = ref_y + (size_t)(pr * 16 + u) * wl;
      x0 = c0 * 16 - 3 + 16 * j;
    } else {
      wl = W;
      row = ref_y + (size_t)min(max(r * 16 - WO + u, 0), H - 1) * W;
      x0 = (c0 - 1 + j) * 16;
    }
    if (!PAD && vec && x0 >= 0 && x0 + 16 <= wl) {
      cp_async16(dst, row + x0);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = row[min(max(x0 + b, 0), wl - 1)];
    }
  }
  if (t < 16 * 7) s.qpel[t / 7][t % 7] = c_qpel[t / 7][t % 7];
  WarpSmem& ws = s.w[m];
  if (c < nc) {
    for (int k = lane; k < 64; k += 32)
      ws.cur[k] = *reinterpret_cast<const uint32_t*>(y + (size_t)(r * 16 + (k >> 2)) * W +
                                                     c * 16 + 4 * (k & 3));
    const int p = lane >> 4, k = lane & 15;
    ws.curc[p][k] = *reinterpret_cast<const uint32_t*>((p ? cr : cb) +
                                                       (size_t)(r * 8 + (k >> 1)) * Wc + c * 8 +
                                                       4 * (k & 1));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (c >= nc) return;                // the block's only barrier is behind

  if (qp_dev) {
    qp = *qp_dev;
    qpc = dngd_chroma_qp(qp);
  }
  const int mb = orow * nc + c;
  // tune=hq: the MB's qp (the qp plane's under the full tier) and the
  // lambda-scaled motion margins at it
  const int qm = TIER == 2 ? qp_map[mb] : qp;
  // RS: the refinement stages' line step and SAD scale (FULL: every
  // line, full-strength margins); the coarse stage's zbc stays at /2
  constexpr int RS = FULL ? 1 : SCALE;
  int zb = ZERO_MV_BIAS / RS, hb = HALF_BIAS / RS, qb = QUARTER_BIAS / RS;
  int zbc = ZERO_MV_BIAS / 2;
  if constexpr (TIER != 0) {
    zb = marg[qm];                    // the tables at the RS scale
    hb = marg[52 + qm];
    qb = marg[104 + qm];
    // (int)(lam * 8) == (int)(lam * 16) >> 1: float32 scaling by 2 is exact
    zbc = FULL ? zb >> 1 : zb;
  }
  const uint4* cur4 = reinterpret_cast<const uint4*>(ws.cur);
  const int wc0 = 16 * m + 3;         // the window's column 0 in the strip

  // --- coarse grid: 81 shifts (dy outer, dx inner) on the even lines; lane
  //     (dx, g) takes dy = 3g .. 3g + 2, reference row 5 + 2 (3g + s) of
  //     its window serving even line 2 (s - d) of shift dy = 3g + d -------
  uint32_t key = UINT_MAX;
  if (lane < 27) {
    const int dx = lane % 9, g = lane / 9;
    int sd[3] = {0, 0, 0};
    const int ob = (5 + 6 * g) * SP + wc0 + 5 + 2 * dx;
#pragma unroll
    for (int st = 0; st < 10; ++st) {
      uint32_t rw[4];
      row_at(s.strip, ob + 2 * st * SP, rw);
#pragma unroll
      for (int d = 0; d < 3; ++d)
        if (st - d >= 0 && st - d < 8) sd[d] += sad16(cur4[2 * (st - d)], rw);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int k = (3 * g + d) * 9 + dx;
      key = min(key, key_of(sd[d] - (k == 40 ? zbc : 0), k));
    }
  }
  key = __reduce_min_sync(FULL_MASK, key);
  const int cy = -8 + 2 * (int)((key & 127) / 9), cx = -8 + 2 * (int)((key & 127) % 9);

  // --- +-1 integer re-rank: [(0, 0)] + neighbours, two lanes a candidate -
  int part = 0;
  {
    const int k = lane >> 1, g = lane & 1;
    if (k < 9) {
      const int oy = k ? nb_y(k - 1) : 0, ox = k ? nb_x(k - 1) : 0;
      const int o = (WO + cy + oy) * SP + wc0 + WO + cx + ox;
#pragma unroll
      for (int tt = 0; tt < 8 / RS; ++tt) {
        const int i = RS * (g + 2 * tt);
        uint32_t rw[4];
        row_at(s.strip, o + i * SP, rw);
        part += sad16(cur4[i], rw);
      }
    }
    part += __shfl_xor_sync(FULL_MASK, part, 1);
    key = (k < 9 && g == 0) ? key_of(part - (k == 0 && cy == 0 && cx == 0 ? zb : 0), k)
                            : UINT_MAX;
    key = __reduce_min_sync(FULL_MASK, key);
  }
  const int b1i = key & 127, best_sad = key_sad(key);
  const int iy = cy + (b1i ? nb_y(b1i - 1) : 0), ix = cx + (b1i ? nb_x(b1i - 1) : 0);

  // --- the b, h and j planes around mv_int ------------------------------
  // pass 1, lane a < 23: window row 10 + iy + a (plane row a - 2), columns
  // 10 + ix .. 33 + ix: b1 = the horizontal 6-tap, b = clip((b1 + 16) >> 5)
  // for plane rows 0-17, and the vertical pass's source row: 32 x the
  // window's columns 12 + ix .. 29 + ix, then b1 (16 bits each)
  uint8_t* plb = reinterpret_cast<uint8_t*>(ws.pl);
  if (lane < SRC_H) {
    const int o = (10 + iy + lane) * SP + wc0 + 10 + ix;
    const uint32_t* p = s.strip + (o >> 2);
    const int sh = (o & 3) * 8;
    int xv[24];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const uint32_t wd = __funnelshift_r(p[k], p[k + 1], sh);
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[4 * k + j] = (wd >> (8 * j)) & 255;
    }
    int b1[PW];
#pragma unroll
    for (int j = 0; j < PW; ++j) b1[j] = tap6(xv[j], xv[j + 1], xv[j + 2], xv[j + 3], xv[j + 4], xv[j + 5]);
#pragma unroll
    for (int j = 0; j < PW / 2; ++j) {
      ws.src[lane][j] = (uint32_t)(xv[2 * j + 2] << 5) | ((uint32_t)(xv[2 * j + 3] << 5) << 16);
      ws.src[lane][PW / 2 + j] = ((uint32_t)b1[2 * j] & 0xffffu) | ((uint32_t)b1[2 * j + 1] << 16);
    }
    if (lane >= 2 && lane < PW + 2) {
      uint32_t* brow = ws.pl[0] + (lane - 2) * (PP / 4);
#pragma unroll
      for (int q = 0; q < PP / 4; ++q) {
        uint32_t wd = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < PW) wd |= (uint32_t)clip255((b1[4 * q + j] + 16) >> 5) << (8 * j);
        brow[q] = wd;
      }
    }
  }
  __syncwarp();
  // pass 2: task (column cc of the source, half hh): plane rows 9 hh ..
  // 9 hh + 8 of h (cc < 18) or j, (tap6 + 512) >> 10 over source rows
  {
    const int16_t* src16 = reinterpret_cast<const int16_t*>(ws.src);
    for (int task = lane; task < 4 * PW; task += 32) {
      const int hh = task / (2 * PW), cc = task - hh * (2 * PW);
      const int a0 = 9 * hh;
      int sv[14];
#pragma unroll
      for (int k = 0; k < 14; ++k) sv[k] = src16[(a0 + k) * (2 * PW) + cc];
      uint8_t* dst = plb + (cc < PW ? 1 : 2) * (PW * PP) + (cc < PW ? cc : cc - PW);
#pragma unroll
      for (int a = 0; a < 9; ++a)
        dst[(a0 + a) * PP] =
            (uint8_t)clip255((tap6(sv[a], sv[a + 1], sv[a + 2], sv[a + 3], sv[a + 4], sv[a + 5]) +
                              512) >> 10);
    }
  }
  __syncwarp();
  const Planes P{s.strip, ws.pl[0], (WO + iy - 1) * SP + wc0 + WO + ix - 1};

  // --- half-pel refinement, four lanes a candidate ----------------------
  int mhy, mhx, sad_h;
  {
    const int k = lane >> 2, g = lane & 3;
    const int oy = nb_y(k), ox = nb_x(k), p = (oy & 1) * 2 + (ox & 1);
    const uint32_t* bp = P.base(p);
    part = 0;
#pragma unroll
    for (int tt = 0; tt < 4 / RS; ++tt) {
      const int i = RS * (g + 4 * tt);
      uint32_t rw[4];
      row_at(bp, P.off(p, 1 + (oy >> 1) + i, 1 + (ox >> 1)), rw);
      part += sad16(cur4[i], rw);
    }
    part += __shfl_xor_sync(FULL_MASK, part, 1);
    part += __shfl_xor_sync(FULL_MASK, part, 2);
    key = __reduce_min_sync(FULL_MASK, g == 0 ? key_of(part, k) : UINT_MAX);
    const int b = key & 127, hv = key_sad(key);
    const bool use = hv + hb < best_sad;
    mhy = 2 * iy + (use ? nb_y(b) : 0);
    mhx = 2 * ix + (use ? nb_x(b) : 0);
    sad_h = use ? hv : best_sad;
  }

  // --- quarter-pel refinement: fractions from the signed half offset ----
  int mvy, mvx;
  {
    const int k = lane >> 2, g = lane & 3;
    const int ey = 2 * (mhy - 2 * iy) + nb_y(k), ex = 2 * (mhx - 2 * ix) + nb_x(k);
    const int* q = s.qpel[(ey & 3) * 4 + (ex & 3)];
    part = 0;
#pragma unroll
    for (int tt = 0; tt < 4 / RS; ++tt) {
      const int i = RS * (g + 4 * tt);
      uint4 pw;
      pw.x = qword(P, q, ey >> 2, ex >> 2, i, 0);
      pw.y = qword(P, q, ey >> 2, ex >> 2, i, 4);
      pw.z = qword(P, q, ey >> 2, ex >> 2, i, 8);
      pw.w = qword(P, q, ey >> 2, ex >> 2, i, 12);
      const uint32_t rw[4] = {pw.x, pw.y, pw.z, pw.w};
      part += sad16(cur4[i], rw);
    }
    part += __shfl_xor_sync(FULL_MASK, part, 1);
    part += __shfl_xor_sync(FULL_MASK, part, 2);
    key = __reduce_min_sync(FULL_MASK, g == 0 ? key_of(part, k) : UINT_MAX);
    const int b = key & 127;
    const bool use = key_sad(key) + qb < sad_h;
    mvy = 2 * mhy + (use ? nb_y(b) : 0);
    mvx = 2 * mhx + (use ? nb_x(b) : 0);
  }
  if (lane == 0) {
    mv_out[mb * 2] = mvy;
    mv_out[mb * 2 + 1] = mvx;
  }

  // --- prediction: luma at the quarter-pel MV (two words a lane), chroma
  //     1/8-pel bilinear (four samples of a row a lane) --------------------
  {
    const int ey = mvy - 4 * iy, ex = mvx - 4 * ix;
    const int* q = s.qpel[(ey & 3) * 4 + (ex & 3)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wd = lane + 32 * h;
      ws.pred[wd] = qword(P, q, ey >> 2, ex >> 2, wd >> 2, 4 * (wd & 3));
    }
  }
  {
    const int p = lane >> 4, i = (lane & 15) >> 1, j0 = 4 * (lane & 1);
    const uint8_t* rp = p ? ref_cr : ref_cb;
    const int yf = mvy & 7, xf = mvx & 7;
    int y0, y1, xs[5], ws_;
    if constexpr (PAD) {
      y0 = pr * 8 + (mvy >> 3) + i + WO;
      y1 = y0 + 1;
#pragma unroll
      for (int k = 0; k < 5; ++k) xs[k] = c * 8 + (mvx >> 3) + j0 + k + WO;
      ws_ = Wc + 2 * WO;
    } else {
      y0 = min(max(r * 8 + (mvy >> 3) + i, 0), Hc - 1);
      y1 = min(max(r * 8 + (mvy >> 3) + i + 1, 0), Hc - 1);
#pragma unroll
      for (int k = 0; k < 5; ++k) xs[k] = min(max(c * 8 + (mvx >> 3) + j0 + k, 0), Wc - 1);
      ws_ = Wc;
    }
    const uint8_t* r0 = rp + (size_t)y0 * ws_;
    const uint8_t* r1 = rp + (size_t)y1 * ws_;
    int a[5], b[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      a[k] = r0[xs[k]];
      b[k] = r1[xs[k]];
    }
    uint32_t wd = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = ((8 - xf) * (8 - yf) * a[k] + xf * (8 - yf) * a[k + 1] +
                     (8 - xf) * yf * b[k] + xf * yf * b[k + 1] + 32) >> 6;
      wd |= (uint32_t)v << (8 * k);
    }
    ws.predc[p][i * 2 + (lane & 1)] = wd;
  }
  __syncwarp();

  const int qcm = TIER == 0 ? qpc : dngd_chroma_qp(qm);
  residual<TIER>(ws, lane, mb, orow, c, W, Wc, qm, qcm, mvy, mvx,
                 TIER != 0 ? lam_tab[qm] : 0.0f, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb,
                 rcr, score_out);
}

// --- I16-in-P: two launches, a warp an MB, a block a run of MPB MBs ------

// One MB's I16 (DC) candidate on its warp: lanes 0-15 take luma block
// `lane` in raster order (by = lane >> 2, bx = lane & 3), 16-23 Cb's and
// Cr's four blocks; 24-31 repeat lane 23 (they take part in the shuffles,
// their results unused).  The prediction reads the left MB's column of
// the recon, which at this point is that MB's skip-merged inter recon
// (128 at column 0).  Integer sums, so their order does not matter.
struct I16Lane {
  int lv[16];   // the block's levels, raster, lv[0] = 0
  int dc;       // luma: DC level at raster position `lane`; chroma: the block's
  int rec[16];  // the block's recon, raster
  int bits;     // the lane's share of the bit estimate
  int ssd;
};

__device__ __forceinline__ int pick16(const int* v, int i) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < 16; ++k)
    if (i == k) r = v[k];
  return r;
}

__device__ __forceinline__ int lbits(int l) { return l ? 3 + 2 * flog2(abs(l)) : 0; }

__device__ __forceinline__ void i16_candidate(I16Lane& o, int lane, const uint8_t* __restrict__ y,
                              const uint8_t* __restrict__ cb, const uint8_t* __restrict__ cr,
                              const uint8_t* ry, const uint8_t* rcb, const uint8_t* rcr, int fr,
                              int r, int c, int W, int Wc, int qm) {
  const bool is_c = lane >= 16;
  const int L = min(lane, 23), cq = (L - 16) & 3, cp = (L - 16) >> 2;
  const int by = is_c ? cq >> 1 : L >> 2, bx = is_c ? cq & 1 : L & 3;
  const int pitch = is_c ? Wc : W;
  const uint8_t* cur = is_c ? (cp ? cr : cb) + (size_t)(fr * 8 + by * 4) * Wc + c * 8 + bx * 4
                            : y + (size_t)(fr * 16 + by * 4) * W + c * 16 + bx * 4;
  int x[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(cur + (size_t)i * pitch);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i * 4 + j] = (a >> (8 * j)) & 255;
  }
  int pred = 128;
  if (c > 0) {
    const int left = lane < 16 ? ry[(size_t)(r * 16 + lane) * W + c * 16 - 1] : 0;
    const int sum = __reduce_add_sync(FULL_MASK, left);
    if (!is_c) {
      pred = (sum + 8) >> 4;
    } else {
      const uint8_t* l = (cp ? rcr : rcb) + (size_t)(r * 8 + 4 * by) * Wc + c * 8 - 1;
      pred = (l[0] + l[Wc] + l[2 * Wc] + l[3 * Wc] + 2) >> 2;
    }
  }
  int w[16];
  {
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = x[k] - pred;
    fdct4(d, w);
  }
  const Qp Q(is_c ? dngd_chroma_qp(qm) : qm);
  o.lv[0] = 0;
#pragma unroll
  for (int k = 1; k < 16; ++k) o.lv[k] = Q.q(w[k], k);
  // the DC transforms across lanes: luma's 4x4 Hadamard over lanes 0-15,
  // each chroma plane's 2x2 over its four lanes
  const int base = lane & ~3;
  const int s1 = (cq & 1) ? -1 : 1, s2 = (cq & 2) ? -1 : 1;
  int g[16], h[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) g[i] = __shfl_sync(FULL_MASK, w[0], i);
  had4(g, h);
  {
    const int x0 = __shfl_sync(FULL_MASK, w[0], base), x1 = __shfl_sync(FULL_MASK, w[0], base + 1),
              x2 = __shfl_sync(FULL_MASK, w[0], base + 2),
              x3 = __shfl_sync(FULL_MASK, w[0], base + 3);
    const int hd = pick16(h, L & 15), a = abs(hd) >> 1;
    o.dc = is_c ? Q.q_dc(x0 + s1 * x1 + s2 * x2 + s1 * s2 * x3) : Q.q_dc(hd < 0 ? -a : a);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) g[i] = __shfl_sync(FULL_MASK, o.dc, i);
  had4(g, h);
  int d[16];
  {
    const int y0 = __shfl_sync(FULL_MASK, o.dc, base), y1 = __shfl_sync(FULL_MASK, o.dc, base + 1),
              y2 = __shfl_sync(FULL_MASK, o.dc, base + 2),
              y3 = __shfl_sync(FULL_MASK, o.dc, base + 3);
    const int v00 = c_v[0][Q.m];
    if (is_c) {
      d[0] = ((y0 + s1 * y1 + s2 * y2 + s1 * s2 * y3) * v00 * (1 << Q.s)) >> 1;
    } else {
      const int f = pick16(h, L & 15);
      d[0] = qm >= 12 ? f * v00 * (1 << (Q.s - 2)) : (f * v00 + (1 << (1 - Q.s))) >> (2 - Q.s);
    }
  }
#pragma unroll
  for (int k = 1; k < 16; ++k) d[k] = Q.dq(o.lv[k], k);
  int res[16];
  idct4(d, res);
  o.ssd = 0;
  o.bits = lbits(o.dc);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = min(max(pred + res[k], 0), 255);
    o.rec[k] = v;
    o.ssd += (v - x[k]) * (v - x[k]);
    o.bits += lbits(o.lv[k]);
  }
}

// Launch 1: every MB's candidate scored as the reference scores it,
// (Y + Cb) + Cr + lam * (bits + 11) in float32, against the inter score
// pass 1 left; only the `want` byte is written.
template <int TIER>
__global__ void __launch_bounds__(NT) i16_want_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* __restrict__ ry,
    const uint8_t* __restrict__ rcb, const uint8_t* __restrict__ rcr,
    const int* __restrict__ rows, const int* __restrict__ qp_dev, const int* __restrict__ qp_map,
    const float* __restrict__ lam_tab, const float* __restrict__ score, uint8_t* want, int nc,
    int qp) {
  const int lane = threadIdx.x & 31, rb = (nc + MPB - 1) / MPB;
  // r: the stack row (the recon's and every output's), fr: the frame row
  // of the current planes (rows[r] over a worklist)
  const int r = blockIdx.x / rb, c = (blockIdx.x % rb) * MPB + (threadIdx.x >> 5);
  if (c >= nc) return;
  const int mb = r * nc + c, fr = rows ? rows[r] : r;
  if (qp_dev) qp = *qp_dev;
  const int qm = TIER == 2 ? qp_map[mb] : qp;
  I16Lane o;
  i16_candidate(o, lane, y, cb, cr, ry, rcb, rcr, fr, r, c, nc * 16, nc * 8, qm);
  const int sy = __reduce_add_sync(FULL_MASK, lane < 16 ? o.ssd : 0);
  const int sb = __reduce_add_sync(FULL_MASK, lane >= 16 && lane < 20 ? o.ssd : 0);
  const int sr = __reduce_add_sync(FULL_MASK, lane >= 20 && lane < 24 ? o.ssd : 0);
  const int bits = __reduce_add_sync(FULL_MASK, lane < 24 ? o.bits : 0);
  if (lane == 0) {
    const float d = __fadd_rn(__fadd_rn((float)sy, (float)sb), (float)sr);
    const float si = __fmaf_rn(lam_tab[qm], __fadd_rn((float)bits, 11.0f), d);
    want[mb] = si < score[mb];
  }
}

// one warp's staged outputs of a kept MB (read back as 16-byte words)
struct __align__(16) I16Stage {
  int ac[240];        // i16_ac: 16 blocks (blkIdx) x 15 zigzag
  int cac[120];       // cb_ac, cr_ac: 4 blocks x 15 zigzag each
  int cdc[8];         // cb_dc, cr_dc
  uint32_t ry[64];    // recon: 16 rows x 16 bytes
  uint32_t rc[2][16]; // 8 rows x 8 bytes a chroma plane
};

// Launch 2: each MB's gate from its row's want bytes, the even positions
// of each run of wanting MBs (counted from the last MB to its left that
// does not want, found 32 at a time by ballots); a kept MB's left
// neighbour is never kept, so the column its candidate reads is still
// pass 1's.  A kept MB recomputes its candidate and writes its levels,
// zero MV, recon and the I16 keys; every other MB writes zero I16 keys.
template <int TIER>
__global__ void __launch_bounds__(NT) i16_merge_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const int* __restrict__ rows, const int* __restrict__ qp_dev,
    const int* __restrict__ qp_map, const uint8_t* __restrict__ want, int* mv, int* luma,
    int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
    uint8_t* mb_intra, int* i16_dc, int* i16_ac, int nc, int qp) {
  __shared__ I16Stage stage[MPB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rb = (nc + MPB - 1) / MPB;
  const int r = blockIdx.x / rb, c = (blockIdx.x % rb) * MPB + warp;
  if (c >= nc) return;
  const int mb = r * nc + c;
  const uint8_t* wr = want + (size_t)r * nc;
  bool keep = false;
  if (wr[c]) {
    int last = -2;                    // the last MB left of c that does not want
    for (int e = c - 1; last == -2; e -= 32) {
      const int p = e - lane;
      const unsigned nw = __ballot_sync(FULL_MASK, p < 0 || !wr[p]);
      if (nw) last = e - (__ffs(nw) - 1);
    }
    keep = ((c - last - 1) & 1) == 0;
  }
  if (lane == 0) mb_intra[mb] = keep;
  int4* ac4 = reinterpret_cast<int4*>(i16_ac + (size_t)mb * 240);
  if (!keep) {                        // 60 + 4 zero int4: the I16 keys
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = lane + 32 * h;
      if (q < 60) ac4[q] = make_int4(0, 0, 0, 0);
      else reinterpret_cast<int4*>(i16_dc + (size_t)mb * 16)[q - 60] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const int W = nc * 16, Wc = nc * 8;
  if (qp_dev) qp = *qp_dev;
  const int qm = TIER == 2 ? qp_map[mb] : qp;
  I16Lane o;
  i16_candidate(o, lane, y, cb, cr, ry, rcb, rcr, rows ? rows[r] : r, r, c, W, Wc, qm);
  I16Stage& st = stage[warp];
  const int L = min(lane, 23), cq = (L - 16) & 3, cp = (L - 16) >> 2;
  // the DC levels in zigzag order: lane k takes raster position zz(k)
  const int dz = __shfl_sync(FULL_MASK, o.dc, zz(lane & 15));
  if (lane < 16) {
    const int by = lane >> 2, bx = lane & 3;
    const int blk = (by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1);
#pragma unroll
    for (int k = 1; k < 16; ++k) st.ac[blk * 15 + k - 1] = o.lv[zz(k)];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st.ry[(by * 4 + i) * 4 + bx] = o.rec[i * 4] | o.rec[i * 4 + 1] << 8 |
                                     o.rec[i * 4 + 2] << 16 | o.rec[i * 4 + 3] << 24;
  } else if (lane < 24) {
    const int by = cq >> 1, bx = cq & 1;
#pragma unroll
    for (int k = 1; k < 16; ++k) st.cac[cp * 60 + cq * 15 + k - 1] = o.lv[zz(k)];
    st.cdc[cp * 4 + cq] = o.dc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st.rc[cp][(by * 4 + i) * 2 + bx] = o.rec[i * 4] | o.rec[i * 4 + 1] << 8 |
                                         o.rec[i * 4 + 2] << 16 | o.rec[i * 4 + 3] << 24;
  }
  __syncwarp();
  const int4 z4 = make_int4(0, 0, 0, 0);
  int4* l4 = reinterpret_cast<int4*>(luma + (size_t)mb * 256);
  l4[lane] = z4;
  l4[lane + 32] = z4;
  if (lane == 0) *reinterpret_cast<int2*>(mv + (size_t)mb * 2) = make_int2(0, 0);
  if (lane < 16) i16_dc[(size_t)mb * 16 + lane] = dz;
  const int4* sa = reinterpret_cast<const int4*>(st.ac);
  ac4[lane] = sa[lane];
  if (lane < 28) ac4[lane + 32] = sa[lane + 32];
  if (lane < 30) {                    // chroma AC: 15 int4 a plane
    const int p = lane / 15, q = lane - 15 * p;
    reinterpret_cast<int4*>((p ? cr_ac : cb_ac) + (size_t)mb * 60)[q] =
        reinterpret_cast<const int4*>(st.cac + p * 60)[q];
  } else {                            // chroma DC: one int4 a plane
    const int p = lane - 30;
    *reinterpret_cast<int4*>((p ? cr_dc : cb_dc) + (size_t)mb * 4) =
        reinterpret_cast<const int4*>(st.cdc)[p];
  }
  if (lane < 16) {                    // recon: a luma row a lane, then chroma
    *reinterpret_cast<uint4*>(ry + (size_t)(r * 16 + lane) * W + c * 16) =
        reinterpret_cast<const uint4*>(st.ry)[lane];
  } else {
    const int p = (lane - 16) >> 3, i = lane & 7;
    *reinterpret_cast<uint2*>((p ? rcr : rcb) + (size_t)(r * 8 + i) * Wc + c * 8) =
        reinterpret_cast<const uint2*>(st.rc[p])[i];
  }
}

}  // namespace

// Launch checks of every P core form: the current planes are read a
// 32-bit word at a time, the levels and the luma recon written 16 bytes
// at a time and the chroma recon 8; the reference strip is copied 16
// bytes at a time where the reference is 16-byte aligned (else byte by
// byte).
static bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

static bool outputs_aligned(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                            const int* luma, const int* cb_dc, const int* cb_ac,
                            const int* cr_dc, const int* cr_ac, const uint8_t* ry,
                            const uint8_t* rcb, const uint8_t* rcr) {
  return aligned(y, 4) && aligned(cb, 4) && aligned(cr, 4) && aligned(luma, 16) &&
         aligned(cb_dc, 16) && aligned(cb_ac, 16) && aligned(cr_dc, 16) &&
         aligned(cr_ac, 16) && aligned(ry, 16) && aligned(rcb, 8) && aligned(rcr, 8);
}

static int vec_ok(const void* ref_y) { return aligned(ref_y, 16); }

// blocks of one output row of nc MBs
static int row_blocks(int nc) { return (nc + MPB - 1) / MPB; }

// rows: null for the whole frame (nb = nr), else nb MB rows (K5r).
// qp_dev: null to take qp/qpc as given, else the slice qp on the card.
// ns: sessions (1 = one frame) stacked on every plane's and output's
// leading axis, each searching its own reference.
extern "C" int inter_frame_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                  const uint8_t* ref_y, const uint8_t* ref_cb,
                                  const uint8_t* ref_cr, const int* rows, const int* qp_dev,
                                  int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                  int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr, int nr,
                                  int nc, int nb, int qp, int qpc, int ns, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || nb <= 0 || ns <= 0) return 0;
  if (!outputs_aligned(y, cb, cr, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr))
    return cudaErrorMisalignedAddress;
  const int grid = nb * row_blocks(nc), vec = vec_ok(ref_y);
  if (ns == 1)
    inter_frame_kernel<0><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr, mv,
        luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc, vec);
  else
    inter_frame_kernel<0, true><<<dim3(grid, ns), NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr, mv,
        luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc, vec);
  return dngd_last_error();
}

// One frame's (or, PAD, the stacked shards') P core at tier 0, 1 or 2, in
// the FULL (refine="full") form or not: every pointer as
// inter_frame_hq_launch's below, lam/marg/score null at tier 0.
// rows: null, or the worklist of nb MB rows (K5r; not with PAD).
template <bool PAD, bool FULL>
int launch_tiers(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, const uint8_t* ref_y,
                 const uint8_t* ref_cb, const uint8_t* ref_cr, const int* rows,
                 const int* qp_dev, const int* qp_map, const float* lam, const int* marg,
                 int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry,
                 uint8_t* rcb, uint8_t* rcr, float* score, int nr, int nc, int qp, int qpc,
                 int tier, int nb, cudaStream_t stream) {
  if (!outputs_aligned(y, cb, cr, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr))
    return cudaErrorMisalignedAddress;
  const int grid = nb * row_blocks(nc), vec = vec_ok(ref_y);
  if (tier == 0) {
    inter_frame_kernel<0, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr,
        mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc, vec);
  } else if (tier == 1) {
    inter_frame_kernel<1, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam, marg, score, mv, luma,
        cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc, vec);
  } else if (tier == 2) {
    if (!qp_map) return cudaErrorInvalidValue;
    inter_frame_kernel<2, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam, marg, score, mv, luma,
        cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return dngd_last_error();
}

// The whole frame (rows null, nb = nr) or the nb MB rows of the worklist
// rows (K5r: compacted outputs, qp_map and score (nb, nc)) at tune=hq,
// tier 1 (hq_noaq) or 2 (hq, qp_map the qp plane), or with full
// (refine="full": the +-1 re-rank and both subpel stages on every line,
// marg the full-line margins) also at tier 0 (lam, marg, score null); lam
// the tier's lambda table (52), marg its motion margins (3 x 52); score
// (I16-in-P) the inter score per MB, or null.
extern "C" int inter_frame_hq_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                     const uint8_t* ref_y, const uint8_t* ref_cb,
                                     const uint8_t* ref_cr, const int* rows, const int* qp_dev,
                                     const int* qp_map, const float* lam, const int* marg,
                                     int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                     int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
                                     float* score, int nr, int nc, int nb, int qp, int qpc,
                                     int tier, int full, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || nb <= 0) return 0;
  if (!rows && nb != nr) return cudaErrorInvalidValue;
  if (tier == 0 && !full) return cudaErrorInvalidValue;  // inter_frame_launch's form
  return (full ? launch_tiers<false, true> : launch_tiers<false, false>)(
      y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam, marg, mv, luma, cb_dc,
      cb_ac, cr_dc, cr_ac, ry, rcb, rcr, score, nr, nc, qp, qpc, tier, nb, stream);
}

// K5p: the P core over ns shards of nr MB rows each, every shard's
// references padded by WO (pad_y (ns, 16 nr + 2 WO, 16 nc + 2 WO), chroma
// (ns, 8 nr + 2 WO, 8 nc + 2 WO)); planes, outputs and qp_map stacked as
// one frame of ns * nr MB rows.  tier 0 (tune=off), 1 (hq_noaq) or 2 (hq: qp_map the
// stacked qp plane); lam/marg/score as inter_frame_hq_launch's (null at
// tier 0); full: refine="full" (marg then the full-line margins).
extern "C" int inter_frame_padded_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                         const uint8_t* pad_y, const uint8_t* pad_cb,
                                         const uint8_t* pad_cr, const int* qp_dev,
                                         const int* qp_map, const float* lam, const int* marg,
                                         int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                         int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
                                         float* score, int nr, int nc, int qp, int qpc, int tier,
                                         int ns, int full, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  return (full ? launch_tiers<true, true> : launch_tiers<true, false>)(
      y, cb, cr, pad_y, pad_cb, pad_cr, nullptr, qp_dev, qp_map, lam, marg, mv, luma, cb_dc,
      cb_ac, cr_dc, cr_ac, ry, rcb, rcr, score, nr, nc, qp, qpc, tier, ns * nr, stream);
}

// I16-in-P (two launches), after inter_frame_hq_launch or the padded form
// on the same stream: want (nr x nc bytes) every MB's candidate against
// the inter score `score` (i16_want_kernel), then the gate and the merge
// (i16_merge_kernel).  mv .. rcr are the P core's outputs (the candidates
// read its recon, the merge overwrites the MBs that turn intra); mb_intra,
// i16_dc and i16_ac are written for every MB; rows null for the frame's nr
// rows, else the worklist of the nr stack rows (K5r), whose current
// planes are read at frame row rows[i].  tier 1 (qp or *qp_dev) or 2
// (qp_map (nr, nc)); lam the tier's lambda table.
extern "C" int inter_intra_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                  const int* rows, const int* qp_dev, const int* qp_map,
                                  const float* lam, const float* score, uint8_t* want, int* mv,
                                  int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
                                  uint8_t* ry, uint8_t* rcb, uint8_t* rcr, uint8_t* mb_intra,
                                  int* i16_dc, int* i16_ac, int nr, int nc, int qp, int tier,
                                  cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  if ((tier != 1 && tier != 2) || (tier == 2 && !qp_map)) return cudaErrorInvalidValue;
  if (!outputs_aligned(y, cb, cr, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr) ||
      !aligned(mv, 8) || !aligned(i16_dc, 16) || !aligned(i16_ac, 16))
    return cudaErrorMisalignedAddress;
  const int grid = nr * row_blocks(nc);
  if (tier == 2)
    i16_want_kernel<2><<<grid, NT, 0, stream>>>(y, cb, cr, ry, rcb, rcr, rows, qp_dev, qp_map,
                                                lam, score, want, nc, qp);
  else
    i16_want_kernel<1><<<grid, NT, 0, stream>>>(y, cb, cr, ry, rcb, rcr, rows, qp_dev, qp_map,
                                                lam, score, want, nc, qp);
  const int e = dngd_last_error();
  if (e) return e;
  if (tier == 2)
    i16_merge_kernel<2><<<grid, NT, 0, stream>>>(y, cb, cr, rows, qp_dev, qp_map, want, mv,
                                                 luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr,
                                                 mb_intra, i16_dc, i16_ac, nc, qp);
  else
    i16_merge_kernel<1><<<grid, NT, 0, stream>>>(y, cb, cr, rows, qp_dev, qp_map, want, mv,
                                                 luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr,
                                                 mb_intra, i16_dc, i16_ac, nc, qp);
  return dngd_last_error();
}
