// K8 — H.264 in-loop deblocking filter (spec 8.7) under slice-per-row
// with disable_deblocking_filter_idc=2: vertical edges x=0,4,8,12 of
// every MB (no x=0 edge in column 0) and the internal horizontal edges
// y=4,8,12; chroma its MB edge, x=4 and y=4.  Intra frames: bS 4 at MB
// edges, 3 inside.  P frames: 2 where either 4x4 block has coefficients,
// else 1 at an MB edge whose MVs differ by >= 4 quarter pels, else 0.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/h264_deblock.py:225
// deblock_frame (its line filters :122-220); bit-exact with it.
//
// What bounds it: the dependency chain.  MB rows are independent (the
// filter never crosses a slice), but inside a row the x=0 edge of MB n
// rewrites up to 3 columns of MB n-1 after n-1's horizontal pass, so the
// MBs go in order.  One CUDA block per MB row copies the row (16 luma
// and 2 x 8 chroma lines) into shared memory, then one warp walks the
// MBs: first a thread per line filters the vertical edges left to right
// (lines are independent), then a thread per column filters the
// horizontal edges top to bottom; the block writes the row out.  Known
// limit: a 1080p frame has 68 rows, so 68 blocks run on 132 SMs.
//
// Two optional inputs serve the captured chunk step (ops/devloop.py):
// `qp_dev` puts the slice qp in device memory (the tables below are then
// looked up on the card, so one graph serves every qp), and `luma` (the P
// core's (R, C, 16 blkIdx, 16) levels) stands in for the nnz flags: the
// block derives its row's coded-block flags into shared memory first.
// The rows of a damage worklist filter as a frame of b rows: with idc=2
// no edge crosses a row.
#include "common.cuh"

namespace {

constexpr int NT = 128;

struct Tables {
  int alpha, beta, tc0[3];
};

// indexA -> alpha', indexB -> beta' (Table 8-16), tC0 for bS 1..3 (8-17)
__constant__ int c_alpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9, 10, 12, 13,
    15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182,
    203, 226, 255, 255};
__constant__ int c_beta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
                               11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int c_tc0[52][3] = {
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},  {0, 1, 1},  {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},  {1, 1, 2},  {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},  {2, 3, 4},  {3, 3, 5},   {3, 4, 6},   {3, 4, 6},   {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},  {5, 7, 10}, {6, 8, 11},  {6, 8, 13},  {7, 10, 14}, {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

__device__ __forceinline__ Tables tables_at(int index_a) {
  return Tables{c_alpha[index_a], c_beta[index_a],
                {c_tc0[index_a][0], c_tc0[index_a][1], c_tc0[index_a][2]}};
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) { return min(max(x, lo), hi); }

// Filter one edge line in place: q0 at p[0], p0 at p[-st] (spec 8.7.2.3,
// 8.7.2.4).
__device__ void filter_line(uint8_t* e, int st, int bs, const Tables& T, bool chroma) {
  if (bs == 0) return;
  const int p0 = e[-st], p1 = e[-2 * st], p2 = e[-3 * st], p3 = e[-4 * st];
  const int q0 = e[0], q1 = e[st], q2 = e[2 * st], q3 = e[3 * st];
  if (!(abs(p0 - q0) < T.alpha && abs(p1 - p0) < T.beta && abs(q1 - q0) < T.beta)) return;
  const bool ap = abs(p2 - p0) < T.beta, aq = abs(q2 - q0) < T.beta;
  if (bs < 4) {
    const int t0 = T.tc0[bs - 1];
    const int tc = chroma ? t0 + 1 : t0 + (int)ap + (int)aq;
    const int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    e[-st] = (uint8_t)clip3(0, 255, p0 + d);
    e[0] = (uint8_t)clip3(0, 255, q0 - d);
    if (!chroma) {
      const int avg = (p0 + q0 + 1) >> 1;
      if (ap) e[-2 * st] = (uint8_t)clip3(0, 255, p1 + clip3(-t0, t0, (p2 + avg - 2 * p1) >> 1));
      if (aq) e[st] = (uint8_t)clip3(0, 255, q1 + clip3(-t0, t0, (q2 + avg - 2 * q1) >> 1));
    }
    return;
  }
  const bool strong = abs(p0 - q0) < ((T.alpha >> 2) + 2);
  if (!chroma && strong && ap) {
    e[-st] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    e[-2 * st] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    e[-3 * st] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    e[-st] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (!chroma && strong && aq) {
    e[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
    e[st] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
    e[2 * st] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    e[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

struct Bs {
  const uint8_t* nnz;   // (R, C, 4, 4) raster [by][bx] from MB mb0 on; nullptr = intra
  const int* mv;        // (R, C, 2)
  int mb, c, mb0;
  __device__ int nz(int m, int by, int bx) const {
    return nnz[(m - mb0) * 16 + by * 4 + bx] != 0;
  }
  // vertical edge e (x = 4e) at luma line j
  __device__ int v(int e, int j) const {
    if (e == 0 && c == 0) return 0;
    if (!nnz) return e == 0 ? 4 : 3;
    const int by = j >> 2;
    if (e > 0) return 2 * (nz(mb, by, e - 1) | nz(mb, by, e));
    if (nz(mb - 1, by, 3) | nz(mb, by, 0)) return 2;
    return (abs(mv[mb * 2] - mv[mb * 2 - 2]) >= 4 || abs(mv[mb * 2 + 1] - mv[mb * 2 - 1]) >= 4)
               ? 1 : 0;
  }
  // horizontal edge y = 4e (e = 1..3) at luma column j
  __device__ int h(int e, int j) const {
    if (!nnz) return 3;
    return 2 * (nz(mb, e - 1, j >> 2) | nz(mb, e, j >> 2));
  }
};

__global__ void __launch_bounds__(NT) deblock_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* nnz, const int* mv,
    const int* __restrict__ luma, const int* __restrict__ qp_dev, uint8_t* oy, uint8_t* ocb,
    uint8_t* ocr, int nc, Tables TL, Tables TC) {
  extern __shared__ uint4 smem4[];
  // r: the MB row of the stack; blockIdx.y is the session (sessions'
  // planes, flags and MVs stacked contiguously, gridDim.x rows each)
  const int W = nc * 16, Wc = nc * 8, r = blockIdx.y * gridDim.x + blockIdx.x;
  const int t = threadIdx.x;
  uint8_t* sy = reinterpret_cast<uint8_t*>(smem4);           // 16 x W
  uint8_t* sc[2] = {sy + 16 * W, sy + 16 * W + 8 * Wc};     // 8 x Wc each
  const int ny = 16 * W / 16, nch = 8 * Wc / 16;             // uint4 counts
  if (qp_dev) {
    TL = tables_at(*qp_dev);
    TC = tables_at(dngd_chroma_qp(*qp_dev));
  }
  int mb0 = 0;
  if (luma) {
    // this row's coded-block flags, raster [by][bx] per MB, from the
    // levels' blkIdx order
    uint8_t* snz = sy + 24 * W;
    for (int k = t; k < nc * 16; k += NT) {
      const int by = (k & 15) >> 2, bx = k & 3;
      const int blk = ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1);
      const int* lv = luma + ((size_t)(r * nc + (k >> 4)) * 16 + blk) * 16;
      bool any = false;
      for (int i = 0; i < 16; ++i) any |= lv[i] != 0;
      snz[k] = any;
    }
    nnz = snz;
    mb0 = r * nc;
  }
  const uint4* gy = reinterpret_cast<const uint4*>(y + (size_t)r * 16 * W);
  const uint4* gc[2] = {reinterpret_cast<const uint4*>(cb + (size_t)r * 8 * Wc),
                        reinterpret_cast<const uint4*>(cr + (size_t)r * 8 * Wc)};
  for (int k = t; k < ny; k += NT) smem4[k] = gy[k];
  for (int k = t; k < nch; k += NT) {
    smem4[ny + k] = gc[0][k];
    smem4[ny + nch + k] = gc[1][k];
  }
  __syncthreads();

  if (t < 32) {
    const bool chroma = t >= 16;
    const int p = (t - 16) >> 3, jc = t & 7;     // chroma plane and line
    for (int c = 0; c < nc; ++c) {
      const Bs B{nnz, mv, r * nc + c, c, mb0};
      // vertical edges, left to right: one thread per line
      if (!chroma) {
        for (int e = 0; e < 4; ++e)
          filter_line(sy + t * W + c * 16 + 4 * e, 1, B.v(e, t), TL, false);
      } else {
        uint8_t* line = sc[p] + jc * Wc + c * 8;
        filter_line(line, 1, B.v(0, 2 * jc), TC, true);
        filter_line(line + 4, 1, B.v(2, 2 * jc), TC, true);
      }
      __syncwarp();
      // internal horizontal edges, top to bottom: one thread per column
      if (!chroma) {
        for (int e = 1; e < 4; ++e)
          filter_line(sy + 4 * e * W + c * 16 + t, W, B.h(e, t), TL, false);
      } else {
        filter_line(sc[p] + 4 * Wc + c * 8 + jc, Wc, B.h(2, 2 * jc), TC, true);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  uint4* oy4 = reinterpret_cast<uint4*>(oy + (size_t)r * 16 * W);
  uint4* oc4[2] = {reinterpret_cast<uint4*>(ocb + (size_t)r * 8 * Wc),
                   reinterpret_cast<uint4*>(ocr + (size_t)r * 8 * Wc)};
  for (int k = t; k < ny; k += NT) oy4[k] = smem4[k];
  for (int k = t; k < nch; k += NT) {
    oc4[0][k] = smem4[ny + k];
    oc4[1][k] = smem4[ny + nch + k];
  }
}

}  // namespace

// tables: alpha, beta, tc0[3] for luma (indexA = qp), then chroma
// (indexA = QPc); qp_dev non-null replaces them by the tables at the qp
// it holds.  nnz, mv and luma null for an intra frame; a P frame passes
// mv and either nnz or luma.  ns: sessions (1 = one frame) stacked on
// every array's leading axis.
extern "C" int deblock_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                              const uint8_t* nnz, const int* mv, const int* luma,
                              const int* qp_dev, uint8_t* oy, uint8_t* ocb, uint8_t* ocr,
                              int nr, int nc, int a_l, int b_l, int t_l0, int t_l1, int t_l2,
                              int a_c, int b_c, int t_c0, int t_c1, int t_c2, int ns,
                              cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  const Tables TL{a_l, b_l, {t_l0, t_l1, t_l2}}, TC{a_c, b_c, {t_c0, t_c1, t_c2}};
  const size_t smem = 24 * (size_t)nc * 16 + (luma ? (size_t)nc * 16 : 0);
  // raised once per size, on the first (uncaptured) launch that needs it
  static size_t smem_set = 48 * 1024;
  int e;
  if (smem > smem_set) {
    if ((e = cudaFuncSetAttribute(deblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)))
      return e;
    smem_set = smem;
  }
  deblock_kernel<<<dim3(nr, ns), NT, smem, stream>>>(y, cb, cr, nnz, mv, luma, qp_dev, oy, ocb, ocr, nc,
                                           TL, TC);
  return dngd_last_error();
}
