// K4 — content stats of one frame: per-MB damage (summed abs diff against
// the previous ingest luma above a threshold), its count, the p50/p95 of
// the per-MB luma activity (256 * sum of squared deviation), and where
// the encoder passes them the luma SSE against the recon, the mean and
// p95 of |MV| and the skip/inter/intra MB counts.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/content_stats.py:156
// frame_stats -> _frame_vec :120 (with ops/aq.py:77 mb_activity,
// _luma_sse :79, _mv_stats :93, _mode_counts :100); absent inputs pin
// their slots at -1 as there.
//
// What bounds it: bytes.  The luma planes and the residual tensors are
// read once (~19 MB at 1080p with a P frame's recon, MVs and levels, ~4 MB
// for the intra form); what is left is three order statistics of 8160
// values.  At 1080p the bytes bound is 0.0056 ms for the full form and
// 0.0012 for the intra form (over 3.35 TB/s); the kernel's device time is
// 0.0323 / 0.0276 ms against the memset, reduction and two one-block
// sorts' 0.1675 / 0.0841 (H100 80GB HBM3, 700 W, torch.profiler in
// chip_smoke.py's k5k4 pairs).  About 0.02 ms of it is the last block's
// select (chip_smoke.py k5k4-split).
//
// Design (redesigned for Hopper): one launch a frame, or a chunk of K
// frames, and no memset.  A block of 1024 threads takes 32 MBs, a warp
// each (8 pixels a lane in one 8-byte load, shuffle reductions; the
// residual's any-nonzero over three 16-byte loads a lane by a warp vote),
// and writes each MB's activity, SSE, |MV| (float bits)
// and skip/intra flags to the scratch and its damage bit to the grid.
// The frame's last block to finish (a __threadfence and an atomic ticket
// per frame, which it resets to 0 for the next launch; launches of one
// device are stream-ordered) then reads them back and computes:
//  - the counts, the exact 64-bit SSE sum and the float64 |MV| sum (each
//    rounded once: exact in any order, since every |MV| is 0 or at least
//    1 and below 2^7);
//  - the percentiles by radix select, not by sorting: the ranks
//    floor(q/100 (n-1)) for activity q = 50, 95 and |MV| q = 95 (every
//    value a non-negative int; |MV| by its float bits), a digit of 8 bits
//    a pass over four passes, the three targets together, counted in a
//    shared 256-bin histogram per target with a private column per lane
//    (no bank conflicts, no contended atomics on a flat frame).  The
//    ceil rank is the same value while it falls in the selected value's
//    run, else one block min over the larger values;
//  - jnp.percentile's float32 linear interpolation, round-to-nearest
//    operations with no contraction into FMAs.
// The intra form (no recon, MV field or residual) skips those inputs'
// reads and their slots.
//
// K4c, the same kernel with a frame axis, replaces
// docker_nvidia_glx_desktop_tpu/ops/content_stats.py:169 chunk_stats:
// K staged frames in one launch (the frame is blockIdx.y).  Slot k diffs
// against slot k-1 and slot 0 against `prev` (null: no damage in any
// slot, -1 and a zero grid); the recon is the chunk's last reference, so
// the SSE lands in slot K-1 only; the MV field and residuals are (K, ...)
// stacks.  One frame is the K = 1 case.  tune=hq's I16-in-P MBs
// (`mb_intra`, content_stats.py :100-120) count as intra and never as
// skip: a template instance, chosen by whether the caller passes them.
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NT = 1024;
constexpr int MBS_PER_BLOCK = NT / 32;
constexpr int MAX_K = 4096;              // frames a launch: one ticket each
constexpr int NTARGET = 3;               // act p50, act p95, |MV| p95
constexpr int HIST_BYTES = NTARGET * 256 * 32 * 4;
constexpr int B = 4;                     // values a thread loads at once

// per frame: how many of its blocks have finished (reset by the last)
__device__ unsigned int g_ticket[MAX_K];

// the optional inputs; null pointers mark what the caller did not pass
struct Optional {
  const uint8_t* recon;
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  const uint8_t* mb_intra;
  // frame k of K (n MBs each): the recon belongs to the last frame only
  __device__ Optional at(int k, int K, int n) const {
    const size_t m = (size_t)k * n;
    return Optional{k == K - 1 ? recon : nullptr, mv ? mv + 2 * m : nullptr,
                    luma ? luma + 256 * m : nullptr, cb_dc ? cb_dc + 4 * m : nullptr,
                    cb_ac ? cb_ac + 60 * m : nullptr, cr_dc ? cr_dc + 4 * m : nullptr,
                    cr_ac ? cr_ac + 60 * m : nullptr, mb_intra ? mb_intra + m : nullptr};
  }
};

// scratch of frame k: per-MB activity, SSE, |MV| (float bits) and flags
// (1 skip, 2 intra)
struct Scratch {
  int *act, *sse, *mag, *flags;
  __device__ Scratch(int* s, int n, int k)
      : act(s + (size_t)4 * n * k), sse(act + n), mag(act + 2 * n), flags(act + 3 * n) {}
};

// 8 pels from p, one 8-byte load
__device__ __forceinline__ void load8(const uint8_t* p, int o[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = (a.x >> (8 * j)) & 255;
    o[4 + j] = (a.y >> (8 * j)) & 255;
  }
}

// one MB a warp: its sums, its flags and its damage bit
template <bool INTRA>
__device__ void mb_pass(const uint8_t* y, const uint8_t* prev, const Optional& O,
                        uint8_t* grid, const Scratch& S, int mb, int nc, int thr_sad) {
  const int lane = threadIdx.x & 31, W = nc * 16;
  const int r = mb / nc, c = mb % nc;
  const size_t at = (size_t)(r * 16 + (lane >> 1)) * W + c * 16 + (lane & 1) * 8;
  int sad = 0, s = 0, s2 = 0, sse = 0;
  int v[8], o[8];
  load8(y + at, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s += v[k];
    s2 += v[k] * v[k];
  }
  if (prev) {
    load8(prev + at, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) sad += abs(v[k] - o[k]);
  }
  if (O.recon) {
    load8(O.recon + at, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) sse += (v[k] - o[k]) * (v[k] - o[k]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sad += __shfl_down_sync(FULL_MASK, sad, off);
    s += __shfl_down_sync(FULL_MASK, s, off);
    s2 += __shfl_down_sync(FULL_MASK, s2, off);
  }
  if (O.recon)
    for (int off = 16; off > 0; off >>= 1) sse += __shfl_down_sync(FULL_MASK, sse, off);
  bool coded = false;
  if (O.luma) {
    // 96 int4: luma 64, Cb AC 15, Cr AC 15, Cb DC 1, Cr DC 1
    bool nz = false;
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int q = lane + 32 * h;
      const int4* p = q < 64   ? reinterpret_cast<const int4*>(O.luma + mb * 256) + q
                      : q < 79 ? reinterpret_cast<const int4*>(O.cb_ac + mb * 60) + (q - 64)
                      : q < 94 ? reinterpret_cast<const int4*>(O.cr_ac + mb * 60) + (q - 79)
                      : reinterpret_cast<const int4*>((q == 94 ? O.cb_dc : O.cr_dc) + mb * 4);
      const int4 a = *p;
      nz |= (a.x | a.y | a.z | a.w) != 0;
    }
    coded = __any_sync(FULL_MASK, nz);
  }
  if (lane == 0) {
    // 256*s2 and s*s wrap in 32 bits; their difference (< 2^31) does not
    const int a = (int)(256u * (unsigned)s2 - (unsigned)s * (unsigned)s);
    S.act[mb] = max(a, 0);
    S.sse[mb] = sse;
    grid[mb] = (uint8_t)(prev && sad > thr_sad);
    int fl = 0;
    if (O.mv) {
      const float fy = (float)O.mv[mb * 2], fx = (float)O.mv[mb * 2 + 1];
      S.mag[mb] = __float_as_int(__fsqrt_rn(__fadd_rn(__fmul_rn(fy, fy), __fmul_rn(fx, fx))));
      const bool zero_mv = O.mv[mb * 2] == 0 && O.mv[mb * 2 + 1] == 0;
      const bool intra = INTRA && O.mb_intra[mb] != 0;
      if (O.luma) fl = (!coded && zero_mv && !intra ? 1 : 0) | (intra ? 2 : 0);
    }
    S.flags[mb] = fl;
  }
}

__device__ __forceinline__ float to_f(unsigned v, bool is_float) {
  return is_float ? __uint_as_float(v) : __int2float_rn((int)v);
}

// jnp.percentile's float32 position of q in n values
struct Pos {
  int li, hi;
  float lw, hw;
  __device__ Pos(float q, int n) {
    const float pos = __fmul_rn(__fdiv_rn(q, 100.0f), (float)(n - 1));
    const float low = floorf(pos), high = ceilf(pos);
    hw = __fsub_rn(pos, low);
    lw = __fsub_rn(1.0f, hw);
    li = min(max((int)low, 0), n - 1);
    hi = min(max((int)high, 0), n - 1);
  }
  __device__ float at(unsigned vlo, unsigned vhi, bool is_float) const {
    return __fadd_rn(__fmul_rn(to_f(vlo, is_float), lw), __fmul_rn(to_f(vhi, is_float), hw));
  }
};

// The frame's slots, by its last block: counts and sums, then the three
// order statistics by radix select.
template <bool INTRA>
__device__ void frame_vec(const Scratch& S, const Optional& O, const uint8_t* grid,
                          bool has_prev, float* vec, int n, unsigned* hist) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ long long s_sse[32];
  __shared__ double s_mag[32];
  __shared__ int s_cnt3[32][3];
  __shared__ int s_tot[NTARGET * 256];
  __shared__ unsigned s_prefix[NTARGET], s_next[NTARGET];
  __shared__ int s_k[NTARGET], s_eq[NTARGET];
  const bool has_mv = O.mv != nullptr;

  // -- counts and sums -------------------------------------------------
  int n_dmg = 0, n_skip = 0, n_intra = 0;
  long long sse = 0;
  double mag = 0.0;
  // every loop over the frame's values loads B of them a thread before it
  // uses any: the block's only latency hiding
  for (int i0 = t; i0 < n; i0 += NT * B) {
    int g[B], fl[B], ss[B], mm[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u * NT;
      const bool in = i < n;
      g[u] = in ? __ldcg(grid + i) : 0;
      fl[u] = in ? __ldcg(S.flags + i) : 0;
      ss[u] = in && O.recon ? __ldcg(S.sse + i) : 0;
      mm[u] = in && has_mv ? __ldcg(S.mag + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      n_dmg += g[u] != 0;
      n_skip += fl[u] & 1;
      n_intra += fl[u] >> 1;
      sse += ss[u];
      mag += (double)__int_as_float(mm[u]);
    }
  }
  n_dmg = __reduce_add_sync(FULL_MASK, n_dmg);
  n_skip = __reduce_add_sync(FULL_MASK, n_skip);
  n_intra = __reduce_add_sync(FULL_MASK, n_intra);
  for (int o = 16; o > 0; o >>= 1) {
    sse += __shfl_down_sync(FULL_MASK, sse, o);
    mag += __shfl_down_sync(FULL_MASK, mag, o);
  }
  if (lane == 0) {
    s_sse[warp] = sse;
    s_mag[warp] = mag;
    s_cnt3[warp][0] = n_dmg;
    s_cnt3[warp][1] = n_skip;
    s_cnt3[warp][2] = n_intra;
  }

  // -- radix select of the floor ranks, 8 bits a pass --------------------
  const int nt = has_mv ? 3 : 2;
  const Pos p50(50.0f, n), p95(95.0f, n);
  if (t < NTARGET) {
    s_prefix[t] = 0;
    s_k[t] = t == 0 ? p50.li : p95.li;
    s_next[t] = UINT_MAX;
  }
  const unsigned* act = reinterpret_cast<const unsigned*>(S.act);
  const unsigned* mg = reinterpret_cast<const unsigned*>(S.mag);
  // the counts start at 0; each pass's totals read them and zero them
  for (int i = t; i < nt * 256 * 32; i += NT) hist[i] = 0;
  for (int d = 3; d >= 0; --d) {
    __syncthreads();
    const int sh = 8 * d;
    const unsigned hi_mask = d == 3 ? 0u : 0xffffffffu << (sh + 8);
    const unsigned p0 = s_prefix[0], p1 = s_prefix[1], p2 = s_prefix[2];
    // the two activity targets share one histogram while their prefixes do
    const bool same01 = p0 == p1;
    for (int i0 = t; i0 < n; i0 += NT * B) {
      unsigned va[B], vm[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int i = i0 + u * NT;
        va[u] = i < n ? __ldcg(act + i) : 0u;
        vm[u] = i < n && has_mv ? __ldcg(mg + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (i0 + u * NT >= n) break;
        const unsigned ba = (va[u] >> sh) & 255;
        if (((va[u] ^ p0) & hi_mask) == 0) atomicAdd(hist + (0 * 256 + ba) * 32 + lane, 1u);
        if (!same01 && ((va[u] ^ p1) & hi_mask) == 0)
          atomicAdd(hist + (1 * 256 + ba) * 32 + lane, 1u);
        if (has_mv && ((vm[u] ^ p2) & hi_mask) == 0)
          atomicAdd(hist + (2 * 256 + ((vm[u] >> sh) & 255)) * 32 + lane, 1u);
      }
    }
    __syncthreads();
    // a bin's total over the lanes' columns (read in a rotated order: one
    // bank a thread), the columns zeroed for the next pass
    if (t < nt * 256 && !(same01 && t >= 256 && t < 512)) {
      int part[4] = {0, 0, 0, 0};
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        unsigned* h = hist + t * 32 + ((l + t) & 31);
        part[l & 3] += *h;
        *h = 0;
      }
      const int tot = part[0] + part[1] + part[2] + part[3];
      s_tot[t] = tot;
      if (same01 && t < 256) s_tot[256 + t] = tot;
    }
    __syncthreads();
    if (warp < nt) {                    // warp T finds target T's bin
      int c8[8], sum = 0;
      for (int j = 0; j < 8; ++j) sum += c8[j] = s_tot[warp * 256 + lane * 8 + j];
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const int k = s_k[warp], excl = incl - sum;
      if (excl <= k && k < incl) {      // exactly one lane
        int before = excl, bin = -1, eq = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (bin < 0 && k < before + c8[j]) {
            bin = j;
            eq = c8[j];
          } else if (bin < 0) {
            before += c8[j];
          }
        }
        s_prefix[warp] |= (unsigned)(lane * 8 + bin) << sh;
        s_k[warp] = k - before;
        s_eq[warp] = eq;
      }
    }
    __syncthreads();
  }

  // -- the ceil ranks: the selected value while its run holds them, else
  //    the least larger value -----------------------------------------
  const unsigned v0 = s_prefix[0], v1 = s_prefix[1], v2 = s_prefix[2];
  const bool want0 = p50.hi != p50.li && s_k[0] + 1 >= s_eq[0];
  const bool want1 = p95.hi != p95.li && s_k[1] + 1 >= s_eq[1];
  const bool want2 = has_mv && p95.hi != p95.li && s_k[2] + 1 >= s_eq[2];
  if (want0 || want1 || want2) {
    unsigned m0 = UINT_MAX, m1 = UINT_MAX, m2 = UINT_MAX;
    for (int i0 = t; i0 < n; i0 += NT * B) {
      unsigned va[B], vm[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int i = i0 + u * NT;
        va[u] = i < n ? __ldcg(act + i) : 0u;
        vm[u] = i < n && want2 ? __ldcg(mg + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (va[u] > v0) m0 = min(m0, va[u]);
        if (va[u] > v1) m1 = min(m1, va[u]);
        if (vm[u] > v2) m2 = min(m2, vm[u]);
      }
    }
    m0 = __reduce_min_sync(FULL_MASK, m0);
    m1 = __reduce_min_sync(FULL_MASK, m1);
    m2 = __reduce_min_sync(FULL_MASK, m2);
    if (lane == 0) {
      atomicMin(&s_next[0], m0);
      atomicMin(&s_next[1], m1);
      atomicMin(&s_next[2], m2);
    }
  }
  __syncthreads();
  if (t == 0) {
    long long sse_tot = 0;
    double mag_tot = 0.0;
    int dmg = 0, skip = 0, intra = 0;
    for (int w = 0; w < 32; ++w) {
      sse_tot += s_sse[w];
      mag_tot += s_mag[w];
      dmg += s_cnt3[w][0];
      skip += s_cnt3[w][1];
      intra += s_cnt3[w][2];
    }
    for (int i = 0; i < 10; ++i) vec[i] = -1.0f;
    vec[1] = has_prev ? (float)dmg : -1.0f;
    vec[7] = p50.at(v0, want0 ? s_next[0] : v0, false);
    vec[8] = p95.at(v1, want1 ? s_next[1] : v1, false);
    vec[9] = (float)n;
    if (O.recon) vec[0] = (float)sse_tot;
    if (O.luma) {
      vec[2] = (float)skip;
      vec[3] = (float)(n - intra - skip);
      vec[4] = (float)intra;
    }
    if (has_mv) {
      vec[5] = (float)(mag_tot / n);
      vec[6] = p95.at(v2, want2 ? s_next[2] : v2, true);
    }
  }
}

template <bool INTRA>
__global__ void __launch_bounds__(NT, 2) stats_kernel(const uint8_t* __restrict__ ys,
                                                   const uint8_t* __restrict__ prev0, Optional OK,
                                                   float* vecs, uint8_t* grids, int* scratch,
                                                   int nr, int nc, int thr_sad) {
  extern __shared__ unsigned hist[];
  __shared__ bool last;
  const int n = nr * nc, f = blockIdx.y, K = gridDim.y;
  const size_t plane = (size_t)n * 256;
  const uint8_t* y = ys + f * plane;
  const uint8_t* prev = !prev0 ? nullptr : f ? y - plane : prev0;
  const Optional O = OK.at(f, K, n);
  const Scratch S(scratch, n, f);
  uint8_t* grid = grids + (size_t)f * n;
  const int mb = blockIdx.x * MBS_PER_BLOCK + (threadIdx.x >> 5);
  if (mb < n) mb_pass<INTRA>(y, prev, O, grid, S, mb, nc, thr_sad);
  // the frame's last block to finish goes on
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_ticket[f], 1u) == gridDim.x - 1;
    if (last) g_ticket[f] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  frame_vec<INTRA>(S, O, grid, prev != nullptr, vecs + 10 * f, n, hist);
}

template <bool INTRA>
int stats_launch(const uint8_t* ys, const uint8_t* prev, const Optional& O, float* vecs,
                 uint8_t* grids, int* scratch, int K, int nr, int nc, int thr_sad,
                 cudaStream_t stream) {
  const int e = cudaFuncSetAttribute(stats_kernel<INTRA>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, HIST_BYTES);
  if (e) return e;
  const int n = nr * nc;
  stats_kernel<INTRA><<<dim3((n + MBS_PER_BLOCK - 1) / MBS_PER_BLOCK, K), NT, HIST_BYTES,
                        stream>>>(ys, prev, O, vecs, grids, scratch, nr, nc, thr_sad);
  return dngd_last_error();
}

}  // namespace

// ys (K, H, W); prev the luma before slot 0 (null: no damage); recon the
// last slot's; mv and the residuals (K, ...) stacks or null; mb_intra the
// (K, R, C) I16-in-P flags or null; vecs (K, 10), grids (K, R, C),
// scratch 4 * K * R * C ints.  One launch; K <= 4096 (a ticket a frame).
// The luma planes are read 8 bytes at a time and the residual tensors 16.
extern "C" int chunk_stats_launch(const uint8_t* ys, const uint8_t* prev, const uint8_t* recon,
                                  const int* mv, const int* luma, const int* cb_dc,
                                  const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                  const uint8_t* mb_intra, float* vecs, uint8_t* grids,
                                  int* scratch, int K, int nr, int nc, int thr_sad,
                                  cudaStream_t stream) {
  const int n = nr * nc;
  if (n <= 0 || n > (1 << 15) || K <= 0 || K > MAX_K) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
  };
  if (!aligned(ys, 8) || !aligned(prev, 8) || !aligned(recon, 8) || !aligned(luma, 16) ||
      !aligned(cb_dc, 16) || !aligned(cb_ac, 16) || !aligned(cr_dc, 16) || !aligned(cr_ac, 16))
    return cudaErrorMisalignedAddress;
  const Optional O{recon, mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, mb_intra};
  if (mb_intra)
    return stats_launch<true>(ys, prev, O, vecs, grids, scratch, K, nr, nc, thr_sad, stream);
  return stats_launch<false>(ys, prev, O, vecs, grids, scratch, K, nr, nc, thr_sad, stream);
}
