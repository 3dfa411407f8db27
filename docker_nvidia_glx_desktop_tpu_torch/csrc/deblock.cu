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
// What bounds it: the dependency chain, not the bytes.  MB rows are
// independent (the filter never crosses a slice), but inside a row the
// x=0 edge of MB n+1 rewrites columns 13-15 of MB n after n's horizontal
// edges, so the MBs go in order: each costs 4 vertical then 3 horizontal
// dependent line filters, 840 a 1080p row.  The design keeps that chain
// short and alone:
//  - a pre-pass: all threads of the block (one block per MB row) work out
//    the row's bS into shared memory first, 28 bytes an MB (the luma
//    levels' coded flags by 16-byte loads and warp ballots), so the walk
//    reads no flags or MVs from device memory;
//  - one warp walks the row with the samples in registers: lanes 0-15
//    hold luma lines 0-15, lanes 16-23 Cb lines and 24-31 Cr lines of the
//    MB as 32-bit words, plus the previous MB's last word.  The filter is
//    branch-free on packed words (selects where lanes differ: bS, the
//    sample tests, a chroma lane's rules and its bS 0 at the luma-only
//    edges), so luma and chroma run side by side with no divergent
//    branch.  The kernel is compiled per form: intra computes the bS 4
//    filter at x = 0 and the bS < 4 one elsewhere; a P frame only the
//    bS < 4 one, and the warp skips, as one, a pass whose bS words are all
//    0 (the words are the same for every lane);
//  - the horizontal edges filter columns: a 16x16 byte transpose through
//    a padded shared tile gives each lane a column, a second returns it;
//  - the row streams: the warp loads MB n+3's lines (16-byte loads) while
//    MB n filters, and stores MB n-1's lines once MB n's x=0 edge is done,
//    so shared memory no longer grows with the width.
//
// Two optional inputs serve the captured chunk step (ops/devloop.py):
// `qp_dev` puts the slice qp in device memory (the tables below are then
// looked up on the card, so one graph serves every qp), and `luma` (the P
// core's (R, C, 16 blkIdx, 16) levels) stands in for the nnz flags.  The
// rows of a damage worklist filter as a frame of b rows: with idc=2 no
// edge crosses a row.
#include "common.cuh"

namespace {

constexpr int NT = 128;          // threads a block: the pre-pass; warp 0 walks
constexpr int MAX_NC = 512;      // MBs a row (8192 samples)
constexpr unsigned FULL = 0xffffffffu;

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

// Filter one edge line held in two packed words (spec 8.7.2.3, 8.7.2.4):
// pw's bytes 0..3 are p3 p2 p1 p0, qw's q0 q1 q2 q3 (a line's words for a
// vertical edge, a column's for a horizontal one).  Branch-free: where a
// lane's bS or sample tests fail its samples stay as they were, by
// selects.  CL: the filters the edge's lanes may need (1: bS 1-3, 2: bS
// 4, 3: either), known when the kernel is compiled.
template <int CL>
__device__ __forceinline__ void filt(uint32_t& pw, uint32_t& qw, int bs, const Tables& T,
                                     bool chroma) {
  const int p0 = pw >> 24, p1 = (pw >> 16) & 255, p2 = (pw >> 8) & 255, p3 = pw & 255;
  const int q0 = qw & 255, q1 = (qw >> 8) & 255, q2 = (qw >> 16) & 255, q3 = qw >> 24;
  const int ad = abs(p0 - q0);
  const bool fil = bs > 0 && ad < T.alpha && abs(p1 - p0) < T.beta && abs(q1 - q0) < T.beta;
  const bool ap = abs(p2 - p0) < T.beta, aq = abs(q2 - q0) < T.beta;
  const bool b4 = CL == 1 ? false : (CL == 2 ? true : bs == 4);
  int o0 = p0, o1 = p1, o2 = p2, r0 = q0, r1 = q1, r2 = q2;
  if (CL & 1) {                                   // bS < 4
    const int t0 = bs >= 3 ? T.tc0[2] : (bs == 2 ? T.tc0[1] : T.tc0[0]);
    const int tc = chroma ? t0 + 1 : t0 + (int)ap + (int)aq;
    const int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    if (fil && !b4) {
      o0 = clip3(0, 255, p0 + d);
      r0 = clip3(0, 255, q0 - d);
      if (ap && !chroma) o1 = p1 + clip3(-t0, t0, (p2 + avg - 2 * p1) >> 1);
      if (aq && !chroma) r1 = q1 + clip3(-t0, t0, (q2 + avg - 2 * q1) >> 1);
    }
  }
  if (CL & 2) {                                   // bS == 4
    const bool strong = ad < ((T.alpha >> 2) + 2);
    const bool sp = !chroma && strong && ap, sq = !chroma && strong && aq;
    if (fil && b4) {
      o0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3 : (2 * p1 + p0 + q1 + 2) >> 2;
      r0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3 : (2 * q1 + q0 + p1 + 2) >> 2;
      if (sp) {
        o1 = (p2 + p1 + p0 + q0 + 2) >> 2;
        o2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
      }
      if (sq) {
        r1 = (q2 + q1 + q0 + p0 + 2) >> 2;
        r2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
      }
    }
  }
  pw = (uint32_t)p3 | ((uint32_t)o2 << 8) | ((uint32_t)o1 << 16) | ((uint32_t)o0 << 24);
  qw = (uint32_t)r0 | ((uint32_t)r1 << 8) | ((uint32_t)r2 << 16) | ((uint32_t)q3 << 24);
}

// A 16x16 byte transpose through the lane's padded tile (lane k: line k
// in, column k out), and back.  Luma lanes use all 16 rows, chroma lanes
// rows 0-7 (their tiles keep 16 rows, so the unused ones stay apart).
__device__ __forceinline__ void lines_to_columns(uint8_t* tb, int k, const uint32_t* w,
                                                 uint32_t* col) {
  *reinterpret_cast<uint4*>(tb + 16 * k) = make_uint4(w[0], w[1], w[2], w[3]);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    col[q] = (uint32_t)tb[16 * (4 * q) + k] | ((uint32_t)tb[16 * (4 * q + 1) + k] << 8) |
             ((uint32_t)tb[16 * (4 * q + 2) + k] << 16) |
             ((uint32_t)tb[16 * (4 * q + 3) + k] << 24);
}

__device__ __forceinline__ void columns_to_lines(uint8_t* tb, int k, const uint32_t* col,
                                                 uint32_t* w) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) tb[16 * (4 * q + i) + k] = (uint8_t)(col[q] >> (8 * i));
  __syncwarp();
  const uint4 l = *reinterpret_cast<const uint4*>(tb + 16 * k);
  __syncwarp();
  w[0] = l.x; w[1] = l.y; w[2] = l.z; w[3] = l.w;
}

// The bS of one MB as 8 words: word e (0..3) the vertical edge x = 4e,
// word 4 + e (0..2) the horizontal edge y = 4(e + 1); byte g of each the
// edge's bS on 4-line (vertical) or 4-column (horizontal) group g.
__device__ void mb_bs(const uint8_t* nz, const int* mv, int mb, int c, uint32_t* o) {
  if (!nz) {                                     // intra
    o[0] = c ? 0x04040404u : 0u;
    o[1] = o[2] = o[3] = o[4] = o[5] = o[6] = 0x03030303u;
    o[7] = 0;
    return;
  }
  // the MB's flags and its left MB's, 16 bytes each ([by][bx])
  uint8_t f[16], l[16];
  if (!(reinterpret_cast<uintptr_t>(nz) & 15)) {
    *reinterpret_cast<uint4*>(f) = *reinterpret_cast<const uint4*>(nz);
    if (c) *reinterpret_cast<uint4*>(l) = *reinterpret_cast<const uint4*>(nz - 16);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      f[i] = nz[i];
      l[i] = c ? nz[i - 16] : 0;
    }
  }
  bool mvd = false;
  if (c)
    mvd = abs(mv[mb * 2] - mv[mb * 2 - 2]) >= 4 || abs(mv[mb * 2 + 1] - mv[mb * 2 - 1]) >= 4;
  uint32_t w[7] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int sh = 8 * g;
    const int e0 = !c ? 0 : ((l[g * 4 + 3] | f[g * 4]) ? 2 : (mvd ? 1 : 0));
    w[0] |= (uint32_t)e0 << sh;
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      w[e] |= (uint32_t)(2 * ((f[g * 4 + e - 1] | f[g * 4 + e]) != 0)) << sh;
      w[3 + e] |= (uint32_t)(2 * ((f[(e - 1) * 4 + g] | f[e * 4 + g]) != 0)) << sh;
    }
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) o[k] = w[k];
  o[7] = 0;
}

template <bool INTRA>
__global__ void __launch_bounds__(NT) deblock_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, const uint8_t* __restrict__ nnz,
    const int* __restrict__ mv, const int* __restrict__ luma, const int* __restrict__ qp_dev,
    uint8_t* __restrict__ oy, uint8_t* __restrict__ ocb, uint8_t* __restrict__ ocr, int nc,
    Tables TL, Tables TC) {
  __shared__ __align__(16) uint32_t sbs[MAX_NC * 8];   // the row's bS, 8 words an MB
  __shared__ __align__(16) uint8_t snz[MAX_NC * 16];   // luma form: coded flags, raster
  __shared__ __align__(16) uint8_t tile[800];          // the walk's transposes
  // r: the MB row of the stack; blockIdx.y is the session (sessions'
  // planes, flags and MVs stacked contiguously, gridDim.x rows each)
  const int W = nc * 16, Wc = nc * 8, r = blockIdx.y * gridDim.x + blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the walking warp's lane: its plane, its line (vertical edges) and
  // column (horizontal edges) k, and the MBs' first three loads, issued
  // before the pre-pass
  const bool chroma = lane >= 16;
  const int k = chroma ? (lane & 7) : lane;
  const int plane = chroma ? 1 + ((lane >> 3) & 1) : 0;
  const uint8_t* src = plane == 0 ? y + ((size_t)r * 16 + k) * W
                                  : (plane == 1 ? cb : cr) + ((size_t)r * 8 + k) * Wc;
  uint8_t* dst = plane == 0 ? oy + ((size_t)r * 16 + k) * W
                            : (plane == 1 ? ocb : ocr) + ((size_t)r * 8 + k) * Wc;
  auto load = [&](int c, uint32_t* w) {
    if (chroma) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src + 8 * c));
      w[0] = v.x; w[1] = v.y; w[2] = 0; w[3] = 0;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 16 * c));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
  };
  uint32_t cur[4] = {0, 0, 0, 0}, n1[4] = {0, 0, 0, 0}, n2[4] = {0, 0, 0, 0};
  if (warp == 0) {
    load(0, cur);
    if (nc > 1) load(1, n1);
    if (nc > 2) load(2, n2);
  }

  // --- the pre-pass: the row's bS -------------------------------------
  if (qp_dev) {
    TL = tables_at(*qp_dev);
    TC = tables_at(dngd_chroma_qp(*qp_dev));
  }
  const uint8_t* nz = nnz ? nnz + (size_t)r * nc * 16 : nullptr;
  if (luma) {
    // a 4x4 block is coded where any of its 16 levels (4 int4) is nonzero
    const int4* l4 = reinterpret_cast<const int4*>(luma + (size_t)r * nc * 256);
    const int n4 = nc * 64;
    constexpr int U = 8;
    for (int i0 = warp * 32 * U; i0 < n4; i0 += NT * U) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * 32 + lane;
        v[u] = i < n4 ? __ldg(l4 + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * 32 + lane;
        const unsigned bal = __ballot_sync(FULL, (v[u].x | v[u].y | v[u].z | v[u].w) != 0);
        if ((lane & 3) == 0 && i < n4) {
          const int blk = i >> 2, b = blk & 15;
          snz[(blk & ~15) + c_blk_y[b] * 4 + c_blk_x[b]] = ((bal >> lane) & 15u) != 0;
        }
      }
    }
    __syncthreads();
    nz = snz;
  }
  for (int c = t; c < nc; c += NT) {
    mb_bs(nz ? nz + c * 16 : nullptr, mv, r * nc + c, c, sbs + c * 8);
  }
  __syncthreads();
  if (warp) return;

  // --- the walk -------------------------------------------------------
  const Tables T = chroma ? TC : TL;
  const int gsh = 8 * (chroma ? k >> 1 : k >> 2);     // this lane's byte of a bS word
  uint8_t* tb = tile + (chroma ? ((lane >> 3) & 1 ? 544 : 272) : 0);
  uint32_t pw = 0, s0 = 0, s1 = 0, s2 = 0;   // MB c-1: its line's words 0-2, last word
  auto store = [&](int c) {
    if (chroma)
      *reinterpret_cast<uint2*>(dst + 8 * c) = make_uint2(s0, pw);
    else
      *reinterpret_cast<uint4*>(dst + 16 * c) = make_uint4(s0, s1, s2, pw);
  };
  for (int c = 0; c < nc; ++c) {
    uint32_t w[4] = {cur[0], cur[1], cur[2], cur[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) { cur[i] = n1[i]; n1[i] = n2[i]; }
    if (c + 3 < nc) load(c + 3, n2);
    const uint4 a = *reinterpret_cast<const uint4*>(sbs + c * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(sbs + c * 8 + 4);
    const int v0 = (a.x >> gsh) & 255, v1 = ((chroma ? a.z : a.y) >> gsh) & 255;
    const int v2 = chroma ? 0 : (a.z >> gsh) & 255, v3 = chroma ? 0 : (a.w >> gsh) & 255;
    const int h1 = ((chroma ? b.y : b.x) >> gsh) & 255;
    const int h2 = chroma ? 0 : (b.y >> gsh) & 255, h3 = chroma ? 0 : (b.z >> gsh) & 255;
    // vertical edges, left to right: a lane a line (x = 0 bS 0 in column
    // 0).  Intra edges have bS 4 (x = 0) or 3; a P frame's bS 0-2, and the
    // warp skips a pass whose bS words are all 0 (the same words for every
    // lane: no lane diverges)
    constexpr int V0 = INTRA ? 2 : 1;
    if (INTRA || (a.x | a.y | a.z | a.w)) {
      filt<V0>(pw, w[0], v0, T, chroma);
      filt<1>(w[0], w[1], v1, T, chroma);
      filt<1>(w[1], w[2], v2, T, chroma);
      filt<1>(w[2], w[3], v3, T, chroma);
    }
    if (c) store(c - 1);                      // MB c-1 is final
    // horizontal edges, top to bottom: a lane a column
    if (INTRA || (b.x | b.y | b.z)) {
      uint32_t col[4];
      lines_to_columns(tb, k, w, col);
      filt<1>(col[0], col[1], h1, T, chroma);
      filt<1>(col[1], col[2], h2, T, chroma);
      filt<1>(col[2], col[3], h3, T, chroma);
      columns_to_lines(tb, k, col, w);
    }
    s0 = w[0]; s1 = w[1]; s2 = w[2];
    pw = chroma ? w[1] : w[3];
  }
  store(nc - 1);
}

}  // namespace

// tables: alpha, beta, tc0[3] for luma (indexA = qp), then chroma
// (indexA = QPc); qp_dev non-null replaces them by the tables at the qp
// it holds.  nnz, mv and luma null for an intra frame; a P frame passes
// mv and either nnz or luma.  ns: sessions (1 = one frame) stacked on
// every array's leading axis.  Planes 16-byte aligned, luma too.
extern "C" int deblock_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                              const uint8_t* nnz, const int* mv, const int* luma,
                              const int* qp_dev, uint8_t* oy, uint8_t* ocb, uint8_t* ocr,
                              int nr, int nc, int a_l, int b_l, int t_l0, int t_l1, int t_l2,
                              int a_c, int b_c, int t_c0, int t_c1, int t_c2, int ns,
                              cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  if (nc > MAX_NC) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(luma) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(oy) | reinterpret_cast<uintptr_t>(cb) |
       reinterpret_cast<uintptr_t>(cr) | reinterpret_cast<uintptr_t>(ocb) |
       reinterpret_cast<uintptr_t>(ocr)) & 15)
    return cudaErrorMisalignedAddress;
  const Tables TL{a_l, b_l, {t_l0, t_l1, t_l2}}, TC{a_c, b_c, {t_c0, t_c1, t_c2}};
  if (nnz || luma)
    deblock_kernel<false><<<dim3(nr, ns), NT, 0, stream>>>(y, cb, cr, nnz, mv, luma, qp_dev,
                                                           oy, ocb, ocr, nc, TL, TC);
  else
    deblock_kernel<true><<<dim3(nr, ns), NT, 0, stream>>>(y, cb, cr, nnz, mv, luma, qp_dev,
                                                          oy, ocb, ocr, nc, TL, TC);
  return dngd_last_error();
}
