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
// builds 4 x 18 x 18 interpolated samples.  Every MB is independent
// (slice per MB row, left-only MV prediction, motion search reads only
// the reference), so one CUDA block of 256 threads takes one MB: it
// stages the reference window the MV range reaches (MB +- 13 pels,
// coordinates clamped, which equals the reference's edge padding) and
// the current MB in shared memory, scores each stage's candidates with
// 16 threads each (a column per thread, a 16-lane shuffle sum), and
// picks the first minimum with a strict '<' as jnp.argmin does.  No
// float touches a SAD.
//
// K5r, the same kernel over a worklist of MB rows, replaces
// docker_nvidia_glx_desktop_tpu/ops/damage_mask.py:170 row_core's P
// core (its vmap of encode_p_frame_padded_ref over row bands cut from
// the edge-padded reference): with a `rows` array of b MB rows the grid
// is b * nc blocks, block i encodes frame row rows[i / nc] and writes
// compacted (b, nc, ...) outputs and (16b, W) / (8b, W/2) recon planes.
// A band's search window is clamped at the frame's edges, not the
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
// With I16-in-P (:688-782) two more launches follow: every MB's I16 DC
// candidate from its left neighbour's skip-merged inter recon (written by
// this kernel) scored against the inter score this kernel leaves, then
// per MB row the run-parity gate (one warp a row, a cummax scan) and a
// block per MB merging the kept candidates' levels, MVs and recon.
//
// K5p, the padded-reference form (the PAD template flag), replaces
// docker_nvidia_glx_desktop_tpu/ops/h264_inter.py:300
// encode_p_frame_padded_ref as the spatial shards call it
// (parallel/batch.py:756): each shard's reference arrives padded by _PAD
// = WO pels on every side (csrc/spatial.cu's halo pad: the neighbour
// shard's rows at a seam, edge copies at the frame's edges), so the
// window and the chroma taps read the padded plane at +WO with no clamp.
// The grid covers all shards' MBs as one frame's (a shard's rows are
// frame rows s*nr .. s*nr + nr - 1), so only the reference pointer
// depends on the shard; every tier comes with it.
#include <type_traits>

#include "common.cuh"
#include "transform.cuh"

namespace {

constexpr int NT = 256;
constexpr int ZERO_MV_BIAS = 128, HALF_BIAS = 96, QUARTER_BIAS = 64;
constexpr int SCALE = 2;              // refinement SADs use even lines only
constexpr int WO = 13;                // MB origin inside the window (_PAD)
constexpr int WIN = 16 + 2 * WO;      // reference window side
constexpr int PW = 18;                // interpolated window side (mv_int-1..+16)

// neighbours of a refinement centre, dy outer, dx inner
__constant__ int c_nb[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                               {0, 1},   {1, -1}, {1, 0},  {1, 1}};
// quarter-sample prediction per fraction fy*4+fx: part count, then
// (plane, dy, dx) twice; planes 0 full, 1 b, 2 h, 3 j
__constant__ int c_qpel[16][7] = {
    {1, 0, 0, 0, 0, 0, 0}, {2, 0, 0, 0, 1, 0, 0}, {1, 1, 0, 0, 0, 0, 0},
    {2, 1, 0, 0, 0, 0, 1}, {2, 0, 0, 0, 2, 0, 0}, {2, 1, 0, 0, 2, 0, 0},
    {2, 1, 0, 0, 3, 0, 0}, {2, 1, 0, 0, 2, 0, 1}, {1, 2, 0, 0, 0, 0, 0},
    {2, 2, 0, 0, 3, 0, 0}, {1, 3, 0, 0, 0, 0, 0}, {2, 3, 0, 0, 2, 0, 1},
    {2, 2, 0, 0, 0, 1, 0}, {2, 2, 0, 0, 1, 1, 0}, {2, 3, 0, 0, 1, 1, 0},
    {2, 2, 0, 1, 1, 1, 0}};

struct Smem {
  int win[WIN][WIN];          // reference luma, MB origin at (WO, WO)
  int cur[256];               // current MB luma
  int curc[2][64];            // current MB chroma
  int pl[4][PW][PW];          // full, b, h, j around mv_int
  int pred[256];
  int predc[2][64];
  int sads[81];
  int mvc[2], mvi[2], mvh[2], mv[2];
  int best_sad, sad_h;
  int cdc[2][4];              // chroma DC coefficients before the Hadamard
  int cdcc[2][4];             // dequantised chroma DC after it
};

// tune=hq: the residual kept in shared memory until the forced-skip
// decision
struct SmemHq : Smem {
  int hlv[16][16];            // luma levels, raster coefficient order
  int hrec[256];
  int hcac[2][4][16];         // chroma AC levels (DC position 0)
  int hdcl[2][4];
  int hrecc[2][64];
  int hbits[24], hbits_dc[2];
  int hssd_c[24], hssd_s[24]; // coded / skip SSD per 4x4 block
  int force;
};

template <int TIER>
using SmemT = typename std::conditional<TIER == 0, Smem, SmemHq>::type;

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// 6-tap (1, -5, 20, 20, -5, 1) over six samples, unrounded
__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

template <class S>
__device__ __forceinline__ int b1_at(const S& s, int u, int v) {
  return tap6(s.win[u][v - 2], s.win[u][v - 1], s.win[u][v], s.win[u][v + 1],
              s.win[u][v + 2], s.win[u][v + 3]);
}

// sample of plane p at window position (u, v): full, half right (b),
// half below (h), or the centre (j, vertical 6-tap over unrounded b1)
template <class S>
__device__ int plane_sample(const S& s, int p, int u, int v) {
  switch (p) {
    case 0:
      return s.win[u][v];
    case 1:
      return clip255((b1_at(s, u, v) + 16) >> 5);
    case 2:
      return clip255((tap6(s.win[u - 2][v], s.win[u - 1][v], s.win[u][v],
                           s.win[u + 1][v], s.win[u + 2][v], s.win[u + 3][v]) + 16) >> 5);
    default:
      return clip255((tap6(b1_at(s, u - 2, v), b1_at(s, u - 1, v), b1_at(s, u, v),
                           b1_at(s, u + 1, v), b1_at(s, u + 2, v), b1_at(s, u + 3, v)) +
                      512) >> 10);
  }
}

// quarter-fraction sample at integer offset (ry, rx) from mv_int
template <class S>
__device__ __forceinline__ int qsample(const S& s, int ry, int rx, int fy, int fx, int i,
                                       int j) {
  const int* q = c_qpel[fy * 4 + fx];
  const int a = s.pl[q[1]][1 + ry + q[2] + i][1 + rx + q[3] + j];
  if (q[0] == 1) return a;
  return (a + s.pl[q[4]][1 + ry + q[5] + i][1 + rx + q[6] + j] + 1) >> 1;
}

// SADs of n candidates over every STEP-th line of the MB (2: the even
// lines): 16 threads per candidate (one column each), 16 candidates per
// pass.  f(k, i, j) is candidate k's prediction at MB row i, column j.
template <int STEP, class S, class F>
__device__ void stage_sads(S& s, int n, F f) {
  const int t = threadIdx.x, j = t & 15;
  for (int base = 0; base < n; base += NT / 16) {
    const int k = base + (t >> 4);
    int acc = 0;
    if (k < n)
      for (int i = 0; i < 16; i += STEP) acc += abs(s.cur[i * 16 + j] - f(k, i, j));
    for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (k < n && j == 0) s.sads[k] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ int first_argmin(const int* a, int n) {
  int best = 0;
  for (int k = 1; k < n; ++k)
    if (a[k] < a[best]) best = k;
  return best;
}

// tune=hq's residual: computed into shared memory, then the forced skip,
// then the outputs; score_out (I16-in-P) gets the inter candidate's score.
template <class S>
__device__ void hq_residual(S& s, int mb, int orow, int c, int W, int Wc, int qm, float lam,
                            int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
                            uint8_t* ry, uint8_t* rcb, uint8_t* rcr, float* score_out) {
  const int t = threadIdx.x;
  const Qp Q(qm, false), QC(dngd_chroma_qp(qm), false);
  int blk[16], w[16], lv[16], rec[16];
  const int p = (t - 16) >> 2, q = (t - 16) & 3;      // chroma plane, block
  if (t < 16) {
    const int bx = c_blk_x[t], by = c_blk_y[t];
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      blk[k] = s.cur[i * 16 + j] - s.pred[i * 16 + j];
    }
    fdct4(blk, w);
    for (int k = 0; k < 16; ++k) lv[k] = Q.q(w[k], k);
    for (int k = 0; k < 16; ++k) s.hlv[t][k] = lv[k];
    s.hbits[t] = level_bits(lv);
    for (int k = 0; k < 16; ++k) w[k] = Q.dq(lv[k], k);
    idct4(w, rec);
    int sc = 0, ss = 0;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      const int cur = s.cur[i * 16 + j], pr = s.pred[i * 16 + j];
      const int v = clip255(pr + rec[k]);
      s.hrec[i * 16 + j] = v;
      sc += (v - cur) * (v - cur);
      ss += (pr - cur) * (pr - cur);
    }
    s.hssd_c[t] = sc;
    s.hssd_s[t] = ss;
  } else if (t < 24) {
    const int bx = q & 1, by = q >> 1;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      blk[k] = s.curc[p][i * 8 + j] - s.predc[p][i * 8 + j];
    }
    fdct4(blk, w);
    s.cdc[p][q] = w[0];
    lv[0] = 0;
    for (int k = 1; k < 16; ++k) lv[k] = QC.q(w[k], k);
    for (int k = 0; k < 16; ++k) s.hcac[p][q][k] = lv[k];
    s.hbits[t] = level_bits(lv);
  }
  __syncthreads();
  if (t == 16 || t == 20) {             // 2x2 DC Hadamard, one per plane
    int hd[4], dcl[4], f[4];
    had2(s.cdc[p], hd);
    for (int k = 0; k < 4; ++k) dcl[k] = s.hdcl[p][k] = QC.q_dc(hd[k]);
    s.hbits_dc[p] = level_bits(dcl, 4);
    had2(dcl, f);
    for (int k = 0; k < 4; ++k) s.cdcc[p][k] = ((f[k] * c_v[0][QC.m]) << QC.s) >> 1;
  }
  __syncthreads();
  if (t >= 16 && t < 24) {
    const int bx = q & 1, by = q >> 1;
    for (int k = 1; k < 16; ++k) w[k] = QC.dq(lv[k], k);
    w[0] = s.cdcc[p][q];
    idct4(w, rec);
    int sc = 0, ss = 0;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      const int cur = s.curc[p][i * 8 + j], pr = s.predc[p][i * 8 + j];
      const int v = clip255(pr + rec[k]);
      s.hrecc[p][i * 8 + j] = v;
      sc += (v - cur) * (v - cur);
      ss += (pr - cur) * (pr - cur);
    }
    s.hssd_c[t] = sc;
    s.hssd_s[t] = ss;
  }
  __syncthreads();
  if (t == 0) {
    int bits = s.hbits_dc[0] + s.hbits_dc[1];
    for (int k = 0; k < 24; ++k) bits += s.hbits[k];
    int yc = 0, ys = 0, bc = 0, bs = 0, rc = 0, rs = 0;
    for (int k = 0; k < 16; ++k) {
      yc += s.hssd_c[k];
      ys += s.hssd_s[k];
    }
    for (int k = 16; k < 20; ++k) {
      bc += s.hssd_c[k];
      bs += s.hssd_s[k];
      rc += s.hssd_c[k + 4];
      rs += s.hssd_s[k + 4];
    }
    // (Y + Cb) + Cr in float32; d_skip <= d_coded + lam * (bits + 12)
    const float d_coded = __fadd_rn(__fadd_rn((float)yc, (float)bc), (float)rc);
    const float d_skip = __fadd_rn(__fadd_rn((float)ys, (float)bs), (float)rs);
    const float coded = __fmaf_rn(lam, __fadd_rn((float)bits, 12.0f), d_coded);
    const bool force = s.mv[0] == 0 && s.mv[1] == 0 && d_skip <= coded;
    s.force = force;
    if (score_out) score_out[mb] = force ? __fadd_rn(d_skip, lam) : coded;
  }
  __syncthreads();
  const bool force = s.force;
  if (t < 16) {
    const int bx = c_blk_x[t], by = c_blk_y[t];
    for (int k = 0; k < 16; ++k) luma[(mb * 16 + t) * 16 + k] = force ? 0 : s.hlv[t][c_zz[k]];
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      ry[(orow * 16 + i) * W + c * 16 + j] =
          (uint8_t)(force ? s.pred[i * 16 + j] : s.hrec[i * 16 + j]);
    }
  } else if (t < 24) {
    const int bx = q & 1, by = q >> 1;
    int* ac = p ? cr_ac : cb_ac;
    for (int k = 1; k < 16; ++k) ac[(mb * 4 + q) * 15 + k - 1] = force ? 0 : s.hcac[p][q][c_zz[k]];
    uint8_t* rc = p ? rcr : rcb;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      rc[(orow * 8 + i) * Wc + c * 8 + j] =
          (uint8_t)(force ? s.predc[p][i * 8 + j] : s.hrecc[p][i * 8 + j]);
    }
    if (q == 0) {
      int* dc = p ? cr_dc : cb_dc;
      for (int k = 0; k < 4; ++k) dc[mb * 4 + k] = force ? 0 : s.hdcl[p][k];
    }
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
    int nr, int nc, int qp, int qpc) {
  __shared__ SmemT<TIER> s;
  const int t = threadIdx.x;
  if constexpr (SESS) {
    // blockIdx.y: the session.  Sessions' frames, references (nr x nc
    // MBs each) and outputs (gridDim.x MBs each) are stacked contiguously;
    // a session's search clamps at its own frame's edges.  (One session
    // launches the !SESS form: its pointers stay kernel parameters.)
    const size_t sess = blockIdx.y, fl = sess * nr * nc * 256, om = sess * gridDim.x;
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
  // mb: the output MB (compacted order); r: the frame MB row it encodes
  const int mb = blockIdx.x, orow = mb / nc, c = mb % nc;
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
  if (qp_dev) {
    qp = *qp_dev;
    qpc = dngd_chroma_qp(qp);
  }
  const int H = nr * 16, W = nc * 16, Hc = nr * 8, Wc = nc * 8;
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

  for (int k = t; k < WIN * WIN; k += NT) {
    const int u = k / WIN, v = k % WIN;
    if constexpr (PAD) {
      // padded row pr*16 + u is the shard's row pr*16 - WO + u
      s.win[u][v] = ref_y[(size_t)(pr * 16 + u) * (W + 2 * WO) + c * 16 + v];
    } else {
      const int gy = min(max(r * 16 - WO + u, 0), H - 1);
      const int gx = min(max(c * 16 - WO + v, 0), W - 1);
      s.win[u][v] = ref_y[gy * W + gx];
    }
  }
  s.cur[t] = y[(r * 16 + (t >> 4)) * W + c * 16 + (t & 15)];
  if (t < 128) {
    const int p = t >> 6, k = t & 63;
    const uint8_t* src = p ? cr : cb;
    s.curc[p][k] = src[(r * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)];
  }
  __syncthreads();

  // --- coarse grid: 81 shifts, dy outer, dx inner ----------------------
  stage_sads<2>(s, 81, [&](int k, int i, int j) {
    return s.win[i + WO - 8 + 2 * (k / 9)][j + WO - 8 + 2 * (k % 9)];
  });
  if (t == 0) {
    s.sads[40] -= zbc;
    const int b = first_argmin(s.sads, 81);
    s.mvc[0] = -8 + 2 * (b / 9);
    s.mvc[1] = -8 + 2 * (b % 9);
  }
  __syncthreads();

  // --- +-1 integer re-rank: [(0, 0)] + neighbours ----------------------
  const int cy = s.mvc[0], cx = s.mvc[1];
  stage_sads<RS>(s, 9, [&](int k, int i, int j) {
    const int oy = k ? c_nb[k - 1][0] : 0, ox = k ? c_nb[k - 1][1] : 0;
    return s.win[i + WO + cy + oy][j + WO + cx + ox];
  });
  if (t == 0) {
    if (cy == 0 && cx == 0) s.sads[0] -= zb;
    const int b = first_argmin(s.sads, 9);
    s.best_sad = s.sads[b];
    s.mvi[0] = cy + (b ? c_nb[b - 1][0] : 0);
    s.mvi[1] = cx + (b ? c_nb[b - 1][1] : 0);
  }
  __syncthreads();

  // --- the four planes around mv_int: index (i, j) is luma position
  //     (mv_int - 1 + i, mv_int - 1 + j) relative to the MB ---------------
  const int iy = s.mvi[0], ix = s.mvi[1];
  for (int k = t; k < 4 * PW * PW; k += NT) {
    const int p = k / (PW * PW), i = (k / PW) % PW, j = k % PW;
    s.pl[p][i][j] = plane_sample(s, p, WO + iy - 1 + i, WO + ix - 1 + j);
  }
  __syncthreads();

  // --- half-pel refinement ---------------------------------------------
  stage_sads<RS>(s, 8, [&](int k, int i, int j) {
    const int oy = c_nb[k][0], ox = c_nb[k][1];
    return s.pl[(oy & 1) * 2 + (ox & 1)][1 + (oy >> 1) + i][1 + (ox >> 1) + j];
  });
  if (t == 0) {
    const int b = first_argmin(s.sads, 8);
    const bool use = s.sads[b] + hb < s.best_sad;
    s.mvh[0] = 2 * iy + (use ? c_nb[b][0] : 0);
    s.mvh[1] = 2 * ix + (use ? c_nb[b][1] : 0);
    s.sad_h = use ? s.sads[b] : s.best_sad;
  }
  __syncthreads();

  // --- quarter-pel refinement: fractions from the signed half offset ----
  const int hdy = s.mvh[0] - 2 * iy, hdx = s.mvh[1] - 2 * ix;
  stage_sads<RS>(s, 8, [&](int k, int i, int j) {
    const int ey = 2 * hdy + c_nb[k][0], ex = 2 * hdx + c_nb[k][1];
    return qsample(s, ey >> 2, ex >> 2, ey & 3, ex & 3, i, j);
  });
  if (t == 0) {
    const int b = first_argmin(s.sads, 8);
    const bool use = s.sads[b] + qb < s.sad_h;
    s.mv[0] = 2 * s.mvh[0] + (use ? c_nb[b][0] : 0);
    s.mv[1] = 2 * s.mvh[1] + (use ? c_nb[b][1] : 0);
    mv_out[mb * 2] = s.mv[0];
    mv_out[mb * 2 + 1] = s.mv[1];
  }
  __syncthreads();

  // --- prediction: luma at the quarter-pel MV, chroma 1/8-pel bilinear --
  const int mvy = s.mv[0], mvx = s.mv[1];
  {
    const int ey = mvy - 4 * iy, ex = mvx - 4 * ix;
    s.pred[t] = qsample(s, ey >> 2, ex >> 2, ey & 3, ex & 3, t >> 4, t & 15);
  }
  if (t < 128) {
    const int p = t >> 6, k = t & 63, i = k >> 3, j = k & 7;
    const uint8_t* rp = p ? ref_cr : ref_cb;
    const int yf = mvy & 7, xf = mvx & 7;
    int y0, y1, x0, x1, ws;
    if constexpr (PAD) {
      y0 = pr * 8 + (mvy >> 3) + i + WO;
      x0 = c * 8 + (mvx >> 3) + j + WO;
      y1 = y0 + 1;
      x1 = x0 + 1;
      ws = Wc + 2 * WO;
    } else {
      y0 = min(max(r * 8 + (mvy >> 3) + i, 0), Hc - 1);
      y1 = min(max(r * 8 + (mvy >> 3) + i + 1, 0), Hc - 1);
      x0 = min(max(c * 8 + (mvx >> 3) + j, 0), Wc - 1);
      x1 = min(max(c * 8 + (mvx >> 3) + j + 1, 0), Wc - 1);
      ws = Wc;
    }
    s.predc[p][k] = ((8 - xf) * (8 - yf) * rp[y0 * ws + x0] + xf * (8 - yf) * rp[y0 * ws + x1] +
                     (8 - xf) * yf * rp[y1 * ws + x0] + xf * yf * rp[y1 * ws + x1] + 32) >> 6;
  }
  __syncthreads();

  if constexpr (TIER != 0) {
    hq_residual(s, mb, orow, c, W, Wc, qm, lam_tab[qm], luma, cb_dc, cb_ac, cr_dc, cr_ac, ry,
                rcb, rcr, score_out);
    return;
  }

  // --- residual: 16 luma blocks (threads 0-15), 8 chroma (16-23) ---------
  const Qp Q(qp, false), QC(qpc, false);
  int blk[16], w[16], lv[16], rec[16];
  const int p = (t - 16) >> 2, q = (t - 16) & 3;      // chroma plane, block
  if (t < 16) {
    const int bx = c_blk_x[t], by = c_blk_y[t];
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      blk[k] = s.cur[i * 16 + j] - s.pred[i * 16 + j];
    }
    fdct4(blk, w);
    for (int k = 0; k < 16; ++k) lv[k] = Q.q(w[k], k);
    for (int k = 0; k < 16; ++k) luma[(mb * 16 + t) * 16 + k] = lv[c_zz[k]];
    for (int k = 0; k < 16; ++k) w[k] = Q.dq(lv[k], k);
    idct4(w, rec);
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      ry[(orow * 16 + i) * W + c * 16 + j] = (uint8_t)clip255(s.pred[i * 16 + j] + rec[k]);
    }
  } else if (t < 24) {
    const int bx = q & 1, by = q >> 1;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      blk[k] = s.curc[p][i * 8 + j] - s.predc[p][i * 8 + j];
    }
    fdct4(blk, w);
    s.cdc[p][q] = w[0];
    lv[0] = 0;
    for (int k = 1; k < 16; ++k) lv[k] = QC.q(w[k], k);
    int* ac = p ? cr_ac : cb_ac;
    for (int k = 1; k < 16; ++k) ac[(mb * 4 + q) * 15 + k - 1] = lv[c_zz[k]];
  }
  __syncthreads();
  if (t == 16 || t == 20) {             // 2x2 DC Hadamard, one per plane
    int hd[4], dcl[4], f[4];
    had2(s.cdc[p], hd);
    for (int k = 0; k < 4; ++k) dcl[k] = QC.q_dc(hd[k]);
    int* dc = p ? cr_dc : cb_dc;
    for (int k = 0; k < 4; ++k) dc[mb * 4 + k] = dcl[k];
    had2(dcl, f);
    for (int k = 0; k < 4; ++k) s.cdcc[p][k] = ((f[k] * c_v[0][QC.m]) << QC.s) >> 1;
  }
  __syncthreads();
  if (t >= 16 && t < 24) {
    const int bx = q & 1, by = q >> 1;
    for (int k = 1; k < 16; ++k) w[k] = QC.dq(lv[k], k);
    w[0] = s.cdcc[p][q];
    idct4(w, rec);
    uint8_t* rc = p ? rcr : rcb;
    for (int k = 0; k < 16; ++k) {
      const int i = by * 4 + (k >> 2), j = bx * 4 + (k & 3);
      rc[(orow * 8 + i) * Wc + c * 8 + j] = (uint8_t)clip255(s.predc[p][i * 8 + j] + rec[k]);
    }
  }
}

// --- I16-in-P, pass 2: every MB's I16 DC candidate -----------------------

constexpr int NT_I = 64;

struct I16Smem {
  int cur[256], curc[2][64];
  int yl[16], cl[2][8];        // the left MB's skip-merged inter recon
  int dcraw[16], ac[16][16], bits_ac[16];
  int dcl[16], dcy[16], bits_dc;
  int rec[256];
  int dcrawc[2][4], acc[2][4][16], dclc[2][4], dcc[2][4], bits_c[8], bits_cdc[2];
  int recc[2][64];
  int ssd[24];
};

template <int TIER>
__global__ void __launch_bounds__(NT_I) inter_i16_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* __restrict__ ry,
    const uint8_t* __restrict__ rcb, const uint8_t* __restrict__ rcr,
    const int* __restrict__ qp_dev, const int* __restrict__ qp_map,
    const float* __restrict__ lam_tab, const float* __restrict__ score_inter, uint8_t* want,
    int* i16_dc, int* cand_ac, int* cand_cac, int* cand_cdc, uint8_t* cand_ry,
    uint8_t* cand_rc, const int* __restrict__ rows, int nc, int qp) {
  __shared__ I16Smem s;
  // r: the stack row (the recon's and every output's), fr: the frame row
  // of the current planes (rows[r] over a worklist)
  const int mb = blockIdx.x, r = mb / nc, c = mb % nc, t = threadIdx.x;
  const int fr = rows ? rows[r] : r;
  const int W = nc * 16, Wc = nc * 8;
  if (qp_dev) qp = *qp_dev;
  const int qm = TIER == 2 ? qp_map[mb] : qp;
  const Qp Q(qm), QC(dngd_chroma_qp(qm));
  const bool has_left = c > 0;
  for (int i = t; i < 256; i += NT_I) s.cur[i] = y[(fr * 16 + (i >> 4)) * W + c * 16 + (i & 15)];
  for (int i = t; i < 128; i += NT_I) {
    const int p = i >> 6, k = i & 63;
    s.curc[p][k] = (p ? cr : cb)[(fr * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)];
  }
  if (t < 16) {
    s.yl[t] = has_left ? ry[(r * 16 + t) * W + c * 16 - 1] : 0;
  } else if (t < 32) {
    const int p = (t - 16) >> 3, k = (t - 16) & 7;
    s.cl[p][k] = has_left ? (p ? rcr : rcb)[(r * 8 + k) * Wc + c * 8 - 1] : 0;
  }
  __syncthreads();
  int pred_dc = 128;
  if (has_left) {
    int sum = 0;
    for (int i = 0; i < 16; ++i) sum += s.yl[i];
    pred_dc = (sum + 8) >> 4;
  }
  const int p = (t - 16) >> 2, q = (t - 16) & 3;
  int cpred = 128;
  if (t >= 16 && t < 24 && has_left) {
    const int* l = s.cl[p] + 4 * (q >> 1);
    cpred = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
  }
  int x[16], w[16];
  if (t < 16) {
    const int by = t >> 2, bx = t & 3;
    for (int i = 0; i < 16; ++i) x[i] = s.cur[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] - pred_dc;
    fdct4(x, w);
    s.dcraw[t] = w[0];
    s.ac[t][0] = 0;
    for (int i = 1; i < 16; ++i) s.ac[t][i] = Q.q(w[i], i);
    s.bits_ac[t] = level_bits(s.ac[t]);
  } else if (t < 24) {
    const int by = q >> 1, bx = q & 1;
    for (int i = 0; i < 16; ++i)
      x[i] = s.curc[p][(by * 4 + (i >> 2)) * 8 + bx * 4 + (i & 3)] - cpred;
    fdct4(x, w);
    s.dcrawc[p][q] = w[0];
    s.acc[p][q][0] = 0;
    for (int i = 1; i < 16; ++i) s.acc[p][q][i] = QC.q(w[i], i);
    s.bits_c[t - 16] = level_bits(s.acc[p][q]);
  }
  __syncthreads();
  if (t == 0) {
    int wd2[16], fd[16];
    had4(s.dcraw, wd2);
    for (int i = 0; i < 16; ++i) {
      const int a = abs(wd2[i]) >> 1;
      s.dcl[i] = Q.q_dc(wd2[i] < 0 ? -a : a);
    }
    s.bits_dc = level_bits(s.dcl);
    had4(s.dcl, fd);
    const int v00 = c_v[0][Q.m];
    for (int i = 0; i < 16; ++i)
      s.dcy[i] = qm >= 12 ? fd[i] * v00 * (1 << (Q.s - 2))
                          : (fd[i] * v00 + (1 << (1 - Q.s))) >> (2 - Q.s);
  } else if (t < 3) {
    const int pc = t - 1;
    int wd[4], fd[4];
    had2(s.dcrawc[pc], wd);
    for (int k = 0; k < 4; ++k) s.dclc[pc][k] = QC.q_dc(wd[k]);
    s.bits_cdc[pc] = level_bits(s.dclc[pc], 4);
    had2(s.dclc[pc], fd);
    for (int k = 0; k < 4; ++k) s.dcc[pc][k] = (fd[k] * c_v[0][QC.m] * (1 << QC.s)) >> 1;
  }
  __syncthreads();
  if (t < 16) {
    const int by = t >> 2, bx = t & 3;
    int wr[16], res[16], ssd = 0;
    wr[0] = s.dcy[t];
    for (int i = 1; i < 16; ++i) wr[i] = Q.dq(s.ac[t][i], i);
    idct4(wr, res);
    for (int i = 0; i < 16; ++i) {
      const int k = (by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3);
      const int v = min(max(pred_dc + res[i], 0), 255);
      s.rec[k] = v;
      ssd += (v - s.cur[k]) * (v - s.cur[k]);
    }
    s.ssd[t] = ssd;
  } else if (t < 24) {
    const int by = q >> 1, bx = q & 1;
    int wr[16], res[16], ssd = 0;
    wr[0] = s.dcc[p][q];
    for (int i = 1; i < 16; ++i) wr[i] = QC.dq(s.acc[p][q][i], i);
    idct4(wr, res);
    for (int i = 0; i < 16; ++i) {
      const int k = (by * 4 + (i >> 2)) * 8 + bx * 4 + (i & 3);
      const int v = min(max(cpred + res[i], 0), 255);
      s.recc[p][k] = v;
      ssd += (v - s.curc[p][k]) * (v - s.curc[p][k]);
    }
    s.ssd[t] = ssd;
  }
  __syncthreads();
  if (t == 0) {
    int bits = s.bits_dc + s.bits_cdc[0] + s.bits_cdc[1];
    for (int k = 0; k < 16; ++k) bits += s.bits_ac[k];
    for (int k = 0; k < 8; ++k) bits += s.bits_c[k];
    int sy = 0, sb = 0, sr = 0;
    for (int k = 0; k < 16; ++k) sy += s.ssd[k];
    for (int k = 16; k < 20; ++k) {
      sb += s.ssd[k];
      sr += s.ssd[k + 4];
    }
    // (Y + Cb) + Cr + lam * (bits + 11) against the inter score
    const float d = __fadd_rn(__fadd_rn((float)sy, (float)sb), (float)sr);
    const float si = __fmaf_rn(lam_tab[qm], __fadd_rn((float)bits, 11.0f), d);
    want[mb] = si < score_inter[mb];
  }
  if (t < 16) i16_dc[mb * 16 + t] = s.dcl[c_zz[t]];
  for (int i = t; i < 240; i += NT_I) {
    const int blk = i / 15, k = i % 15 + 1;
    cand_ac[mb * 240 + i] = s.ac[c_blk_y[blk] * 4 + c_blk_x[blk]][c_zz[k]];
  }
  for (int i = t; i < 120; i += NT_I) {
    const int pc = i / 60, qc = (i % 60) / 15, k = i % 15 + 1;
    cand_cac[mb * 120 + i] = s.acc[pc][qc][c_zz[k]];
  }
  if (t < 8) cand_cdc[mb * 8 + t] = s.dclc[t >> 2][t & 3];
  for (int i = t; i < 256; i += NT_I) cand_ry[mb * 256 + i] = (uint8_t)s.rec[i];
  for (int i = t; i < 128; i += NT_I) cand_rc[mb * 128 + i] = (uint8_t)s.recc[i >> 6][i & 63];
}

// --- I16-in-P, pass 3: run-parity gate, then the merge ---------------------

// one warp per MB row: keep the even positions of each run of wanting MBs
__global__ void i16_gate_kernel(const uint8_t* __restrict__ want, uint8_t* mb_intra, int nr,
                                int nc) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= nr) return;
  const int per = (nc + 31) / 32, c0 = min(lane * per, nc), c1 = min(c0 + per, nc);
  const uint8_t* wr = want + row * nc;
  int last = -1;                          // the last non-wanting MB
  for (int c = c0; c < c1; ++c)
    if (!wr[c]) last = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, last, o);
    if (lane >= o) last = max(last, v);
  }
  int ln = __shfl_up_sync(0xffffffffu, last, 1);
  if (lane == 0) ln = -1;
  for (int c = c0; c < c1; ++c) {
    if (!wr[c]) ln = c;
    mb_intra[row * nc + c] = wr[c] && ((c - ln - 1) % 2 == 0);
  }
}

// one block per MB: a kept candidate replaces the inter MB's levels, MV
// and recon; everywhere else the I16 outputs are zero
__global__ void __launch_bounds__(NT) i16_merge_kernel(
    const uint8_t* __restrict__ mb_intra, const int* __restrict__ cand_ac,
    const int* __restrict__ cand_cac, const int* __restrict__ cand_cdc,
    const uint8_t* __restrict__ cand_ry, const uint8_t* __restrict__ cand_rc, int* mv,
    int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry, uint8_t* rcb,
    uint8_t* rcr, int* i16_dc, int* i16_ac, int nc) {
  const int mb = blockIdx.x, r = mb / nc, c = mb % nc, t = threadIdx.x;
  const int W = nc * 16, Wc = nc * 8;
  if (!mb_intra[mb]) {
    if (t < 16) i16_dc[mb * 16 + t] = 0;
    if (t < 240) i16_ac[mb * 240 + t] = 0;
    return;
  }
  luma[mb * 256 + t] = 0;
  if (t < 2) mv[mb * 2 + t] = 0;
  if (t < 240) i16_ac[mb * 240 + t] = cand_ac[mb * 240 + t];
  if (t < 120) ((t < 60) ? cb_ac : cr_ac)[mb * 60 + t % 60] = cand_cac[mb * 120 + t];
  if (t < 8) ((t < 4) ? cb_dc : cr_dc)[mb * 4 + (t & 3)] = cand_cdc[mb * 8 + t];
  ry[(r * 16 + (t >> 4)) * W + c * 16 + (t & 15)] = cand_ry[mb * 256 + t];
  if (t < 128) {
    const int p = t >> 6, k = t & 63;
    (p ? rcr : rcb)[(r * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)] = cand_rc[mb * 128 + t];
  }
}

}  // namespace

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
  if (ns == 1)
    inter_frame_kernel<0><<<nb * nc, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr, mv,
        luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc);
  else
    inter_frame_kernel<0, true><<<dim3(nb * nc, ns), NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr, mv,
        luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc);
  return dngd_last_error();
}

// One frame's (or, PAD, the stacked shards') P core at tier 0, 1 or 2, in
// the FULL (refine="full") form or not: every pointer as
// inter_frame_hq_launch's below, lam/marg/score null at tier 0.
// rows: null, or the worklist of grid / nc MB rows (K5r; not with PAD).
template <bool PAD, bool FULL>
int launch_tiers(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, const uint8_t* ref_y,
                 const uint8_t* ref_cb, const uint8_t* ref_cr, const int* rows,
                 const int* qp_dev, const int* qp_map, const float* lam, const int* marg,
                 int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry,
                 uint8_t* rcb, uint8_t* rcr, float* score, int nr, int nc, int qp, int qpc,
                 int tier, int grid, cudaStream_t stream) {
  if (tier == 0) {
    inter_frame_kernel<0, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, nullptr, nullptr, nullptr, nullptr,
        mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc);
  } else if (tier == 1) {
    inter_frame_kernel<1, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam, marg, score, mv, luma,
        cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc);
  } else if (tier == 2) {
    if (!qp_map) return cudaErrorInvalidValue;
    inter_frame_kernel<2, false, PAD, FULL><<<grid, NT, 0, stream>>>(
        y, cb, cr, ref_y, ref_cb, ref_cr, rows, qp_dev, qp_map, lam, marg, score, mv, luma,
        cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, nr, nc, qp, qpc);
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
      cb_ac, cr_dc, cr_ac, ry, rcb, rcr, score, nr, nc, qp, qpc, tier, nb * nc, stream);
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
  const int grid = ns * nr * nc;
  return (full ? launch_tiers<true, true> : launch_tiers<true, false>)(
      y, cb, cr, pad_y, pad_cb, pad_cr, nullptr, qp_dev, qp_map, lam, marg, mv, luma, cb_dc,
      cb_ac, cr_dc, cr_ac, ry, rcb, rcr, score, nr, nc, qp, qpc, tier, grid, stream);
}

// I16-in-P pass 2, after inter_frame_hq_launch on the same stream: ry/rcb/
// rcr its recon; cand_* per MB (16 x 15 luma AC, 2 x 4 x 15 chroma AC,
// 2 x 4 chroma DC, 256 + 128 recon samples); i16_dc written for every MB.
// nr stack rows: the frame's, or (rows non-null) the worklist's, whose
// current planes are read at frame row rows[i].
static int inter_i16_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                const uint8_t* ry, const uint8_t* rcb, const uint8_t* rcr,
                                const int* rows, const int* qp_dev, const int* qp_map,
                                const float* lam, const float* score, uint8_t* want,
                                int* i16_dc, int* cand_ac, int* cand_cac, int* cand_cdc,
                                uint8_t* cand_ry, uint8_t* cand_rc, int nr, int nc, int qp,
                                int qpc, int tier, cudaStream_t stream) {
  (void)qpc;
  if (nr <= 0 || nc <= 0) return 0;
  if (tier == 2) {
    if (!qp_map) return cudaErrorInvalidValue;
    inter_i16_kernel<2><<<nr * nc, NT_I, 0, stream>>>(y, cb, cr, ry, rcb, rcr, qp_dev, qp_map,
                                                      lam, score, want, i16_dc, cand_ac,
                                                      cand_cac, cand_cdc, cand_ry, cand_rc, rows,
                                                      nc, qp);
  } else if (tier == 1) {
    inter_i16_kernel<1><<<nr * nc, NT_I, 0, stream>>>(y, cb, cr, ry, rcb, rcr, qp_dev, qp_map,
                                                      lam, score, want, i16_dc, cand_ac,
                                                      cand_cac, cand_cdc, cand_ry, cand_rc, rows,
                                                      nc, qp);
  } else {
    return cudaErrorInvalidValue;
  }
  return dngd_last_error();
}

// I16-in-P pass 3: the gate (one warp a row) and the merge (a block an MB).
static int inter_merge_launch(const uint8_t* want, int* i16_dc,
                                  const int* cand_ac, const int* cand_cac, const int* cand_cdc,
                                  const uint8_t* cand_ry, const uint8_t* cand_rc, int* mv,
                                  int* luma, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
                                  uint8_t* ry, uint8_t* rcb, uint8_t* rcr, uint8_t* mb_intra,
                                  int* i16_ac, int nr, int nc, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  const int threads = 128, rows_per_block = threads / 32;
  i16_gate_kernel<<<(nr + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
      want, mb_intra, nr, nc);
  int e;
  if ((e = dngd_last_error())) return e;
  i16_merge_kernel<<<nr * nc, NT, 0, stream>>>(mb_intra, cand_ac, cand_cac, cand_cdc, cand_ry,
                                               cand_rc, mv, luma, cb_dc, cb_ac, cr_dc, cr_ac,
                                               ry, rcb, rcr, i16_dc, i16_ac, nc);
  return dngd_last_error();
}

// I16-in-P passes 2 and 3 in one host call, after inter_frame_hq_launch or
// the padded form on the same stream: every MB's candidate, then the gate
// and the merge.  mv .. rcr are the P core's outputs (the candidates read
// its recon, the merge overwrites the MBs that turn intra); rows null for
// the frame's nr rows, else the worklist of the nr stack rows (K5r); the
// rest as the two passes above take them.
extern "C" int inter_intra_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                  const int* rows, const int* qp_dev, const int* qp_map,
                                  const float* lam, const float* score, uint8_t* want,
                                  int* i16_dc, int* cand_ac, int* cand_cac, int* cand_cdc,
                                  uint8_t* cand_ry, uint8_t* cand_rc, int* mv, int* luma,
                                  int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry,
                                  uint8_t* rcb, uint8_t* rcr, uint8_t* mb_intra, int* i16_ac,
                                  int nr, int nc, int qp, int qpc, int tier,
                                  cudaStream_t stream) {
  const int e = inter_i16_launch(y, cb, cr, ry, rcb, rcr, rows, qp_dev, qp_map, lam, score,
                                 want, i16_dc, cand_ac, cand_cac, cand_cdc, cand_ry, cand_rc,
                                 nr, nc, qp, qpc, tier, stream);
  if (e) return e;
  return inter_merge_launch(want, i16_dc, cand_ac, cand_cac, cand_cdc, cand_ry, cand_rc, mv,
                            luma, cb_dc, cb_ac, cr_dc, cr_ac, ry, rcb, rcr, mb_intra, i16_ac,
                            nr, nc, stream);
}
