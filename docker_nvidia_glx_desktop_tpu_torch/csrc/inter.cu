// K5 — H.264 P core: motion estimation (coarse grid, +-1 integer, half-
// and quarter-pel refinement), motion compensation (6-tap luma, 1/8-pel
// bilinear chroma), inter residual transform/quant and the closed-loop
// reconstruction of one frame.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/h264_inter.py:272
// encode_p_frame / :300 encode_p_frame_padded_ref (refine="alt",
// tune="off", p_intra=False); bit-exact with it.
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
// band's, because the kernel reads the whole reference either way.
// With `qp_dev` the slice qp (and its QPc) is read from device memory,
// so a captured CUDA graph takes each chunk's qp without a new capture.
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

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// 6-tap (1, -5, 20, 20, -5, 1) over six samples, unrounded
__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int b1_at(const Smem& s, int u, int v) {
  return tap6(s.win[u][v - 2], s.win[u][v - 1], s.win[u][v], s.win[u][v + 1],
              s.win[u][v + 2], s.win[u][v + 3]);
}

// sample of plane p at window position (u, v): full, half right (b),
// half below (h), or the centre (j, vertical 6-tap over unrounded b1)
__device__ int plane_sample(const Smem& s, int p, int u, int v) {
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
__device__ __forceinline__ int qsample(const Smem& s, int ry, int rx, int fy, int fx, int i,
                                       int j) {
  const int* q = c_qpel[fy * 4 + fx];
  const int a = s.pl[q[1]][1 + ry + q[2] + i][1 + rx + q[3] + j];
  if (q[0] == 1) return a;
  return (a + s.pl[q[4]][1 + ry + q[5] + i][1 + rx + q[6] + j] + 1) >> 1;
}

// SADs of n candidates over the even lines of the MB: 16 threads per
// candidate (one column each), 16 candidates per pass.  f(k, i, j) is
// candidate k's prediction at MB row i, column j.
template <class F>
__device__ void stage_sads(Smem& s, int n, F f) {
  const int t = threadIdx.x, j = t & 15;
  for (int base = 0; base < n; base += NT / 16) {
    const int k = base + (t >> 4);
    int acc = 0;
    if (k < n)
      for (int i = 0; i < 16; i += SCALE) acc += abs(s.cur[i * 16 + j] - f(k, i, j));
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

__global__ void __launch_bounds__(NT) inter_frame_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* __restrict__ ref_y,
    const uint8_t* __restrict__ ref_cb, const uint8_t* __restrict__ ref_cr,
    const int* __restrict__ rows, const int* __restrict__ qp_dev, int* mv_out, int* luma,
    int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
    int nr, int nc, int qp, int qpc) {
  __shared__ Smem s;
  const int t = threadIdx.x;
  // mb: the output MB (compacted order); r: the frame MB row it encodes
  const int mb = blockIdx.x, orow = mb / nc, c = mb % nc;
  const int r = rows ? rows[orow] : orow;
  if (qp_dev) {
    qp = *qp_dev;
    qpc = dngd_chroma_qp(qp);
  }
  const int H = nr * 16, W = nc * 16, Hc = nr * 8, Wc = nc * 8;

  for (int k = t; k < WIN * WIN; k += NT) {
    const int u = k / WIN, v = k % WIN;
    const int gy = min(max(r * 16 - WO + u, 0), H - 1);
    const int gx = min(max(c * 16 - WO + v, 0), W - 1);
    s.win[u][v] = ref_y[gy * W + gx];
  }
  s.cur[t] = y[(r * 16 + (t >> 4)) * W + c * 16 + (t & 15)];
  if (t < 128) {
    const int p = t >> 6, k = t & 63;
    const uint8_t* src = p ? cr : cb;
    s.curc[p][k] = src[(r * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)];
  }
  __syncthreads();

  // --- coarse grid: 81 shifts, dy outer, dx inner ----------------------
  stage_sads(s, 81, [&](int k, int i, int j) {
    return s.win[i + WO - 8 + 2 * (k / 9)][j + WO - 8 + 2 * (k % 9)];
  });
  if (t == 0) {
    s.sads[40] -= ZERO_MV_BIAS / 2;
    const int b = first_argmin(s.sads, 81);
    s.mvc[0] = -8 + 2 * (b / 9);
    s.mvc[1] = -8 + 2 * (b % 9);
  }
  __syncthreads();

  // --- +-1 integer re-rank: [(0, 0)] + neighbours ----------------------
  const int cy = s.mvc[0], cx = s.mvc[1];
  stage_sads(s, 9, [&](int k, int i, int j) {
    const int oy = k ? c_nb[k - 1][0] : 0, ox = k ? c_nb[k - 1][1] : 0;
    return s.win[i + WO + cy + oy][j + WO + cx + ox];
  });
  if (t == 0) {
    if (cy == 0 && cx == 0) s.sads[0] -= ZERO_MV_BIAS / SCALE;
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
  stage_sads(s, 8, [&](int k, int i, int j) {
    const int oy = c_nb[k][0], ox = c_nb[k][1];
    return s.pl[(oy & 1) * 2 + (ox & 1)][1 + (oy >> 1) + i][1 + (ox >> 1) + j];
  });
  if (t == 0) {
    const int b = first_argmin(s.sads, 8);
    const bool use = s.sads[b] + HALF_BIAS / SCALE < s.best_sad;
    s.mvh[0] = 2 * iy + (use ? c_nb[b][0] : 0);
    s.mvh[1] = 2 * ix + (use ? c_nb[b][1] : 0);
    s.sad_h = use ? s.sads[b] : s.best_sad;
  }
  __syncthreads();

  // --- quarter-pel refinement: fractions from the signed half offset ----
  const int hdy = s.mvh[0] - 2 * iy, hdx = s.mvh[1] - 2 * ix;
  stage_sads(s, 8, [&](int k, int i, int j) {
    const int ey = 2 * hdy + c_nb[k][0], ex = 2 * hdx + c_nb[k][1];
    return qsample(s, ey >> 2, ex >> 2, ey & 3, ex & 3, i, j);
  });
  if (t == 0) {
    const int b = first_argmin(s.sads, 8);
    const bool use = s.sads[b] + QUARTER_BIAS / SCALE < s.sad_h;
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
    const int y0 = min(max(r * 8 + (mvy >> 3) + i, 0), Hc - 1);
    const int y1 = min(max(r * 8 + (mvy >> 3) + i + 1, 0), Hc - 1);
    const int x0 = min(max(c * 8 + (mvx >> 3) + j, 0), Wc - 1);
    const int x1 = min(max(c * 8 + (mvx >> 3) + j + 1, 0), Wc - 1);
    s.predc[p][k] = ((8 - xf) * (8 - yf) * rp[y0 * Wc + x0] + xf * (8 - yf) * rp[y0 * Wc + x1] +
                     (8 - xf) * yf * rp[y1 * Wc + x0] + xf * yf * rp[y1 * Wc + x1] + 32) >> 6;
  }
  __syncthreads();

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

}  // namespace

// rows: null for the whole frame (nb = nr), else nb MB rows (K5r).
// qp_dev: null to take qp/qpc as given, else the slice qp on the card.
extern "C" int inter_frame_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                                  const uint8_t* ref_y, const uint8_t* ref_cb,
                                  const uint8_t* ref_cr, const int* rows, const int* qp_dev,
                                  int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                  int* cr_ac, uint8_t* ry, uint8_t* rcb, uint8_t* rcr, int nr,
                                  int nc, int nb, int qp, int qpc, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || nb <= 0) return 0;
  inter_frame_kernel<<<nb * nc, NT, 0, stream>>>(y, cb, cr, ref_y, ref_cb, ref_cr, rows,
                                                 qp_dev, mv, luma, cb_dc, cb_ac, cr_dc, cr_ac,
                                                 ry, rcb, rcr, nr, nc, qp, qpc);
  return dngd_last_error();
}
