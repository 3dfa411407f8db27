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
// What bounds it: bytes for the reduction (luma planes and the residual
// tensors, read once), then one block's sorts.  Pass 1 gives each MB one
// warp (8 pixels a lane, shuffle reductions; the residual's any-nonzero
// by a warp vote).  Pass 2 is one block of 1024 threads that
// bitonic-sorts the activity values in shared memory (padded to a power
// of two) and applies jnp.percentile's linear interpolation in float32
// with round-to-nearest operations (no contraction into FMAs).  Only
// when the encoder passes a recon or an MV field, pass 3 (one block)
// sums the SSE exactly in 64 bits and the |MV| in float64, each rounded
// once, counts the modes and sorts the |MV| for its p95 the same way; the
// intra form runs passes 1 and 2 only.
//
// K4c, the same three kernels with a frame axis, replaces
// docker_nvidia_glx_desktop_tpu/ops/content_stats.py:169 chunk_stats:
// K staged frames in one launch sequence (the frame is blockIdx.y of
// pass 1 and blockIdx.x of passes 2 and 3).  Slot k diffs against slot
// k-1 and slot 0 against `prev` (null: no damage in any slot, -1 and a
// zero grid);
// the recon is the chunk's last reference, so the SSE lands in slot K-1
// only; the MV field and residuals are (K, ...) stacks.  One frame is
// the K = 1 case.  tune=hq's I16-in-P MBs (`mb_intra`, content_stats.py
// :100-120) count as intra and never as skip: a template instance of
// passes 1 and 3, chosen by whether the caller passes them.
#include <climits>

#include "common.cuh"

namespace {

constexpr int MBS_PER_BLOCK = 8;
constexpr int SORT_THREADS = 1024;

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

// scratch of frame k: per-MB activity, SSE and |MV| (float bits), then
// the frame's two counts, which sit after all frames' per-MB arrays so
// that one memset clears every count
struct Scratch {
  int *act, *sse, *mag, *n_damage, *n_skip, *n_intra;
  __device__ Scratch(int* s, int n, int k, int K)
      : act(s + (size_t)3 * n * k), sse(act + n), mag(act + 2 * n),
        n_damage(s + (size_t)3 * n * K + 3 * k), n_skip(n_damage + 1),
        n_intra(n_damage + 2) {}
};

__device__ __forceinline__ bool any_nonzero(const int* a, int n, int lane) {
  bool nz = false;
  for (int k = lane; k < n; k += 32) nz |= a[k] != 0;
  return __any_sync(0xffffffffu, nz);
}

template <bool INTRA>
__global__ void mb_reduce_kernel(const uint8_t* __restrict__ ys, const uint8_t* __restrict__ prev0,
                                 Optional OK, uint8_t* grids, int* scratch, int nr, int nc,
                                 int thr_sad) {
  const int mb = blockIdx.x * MBS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (mb >= nr * nc) return;
  const int W = nc * 16, n = nr * nc, f = blockIdx.y, K = gridDim.y;
  const size_t plane = (size_t)n * 256;
  const uint8_t* y = ys + f * plane;
  const uint8_t* prev = !prev0 ? nullptr : f ? y - plane : prev0;
  const Optional O = OK.at(f, K, n);
  const Scratch S(scratch, n, f, K);
  uint8_t* grid = grids + (size_t)f * n;
  const int r = mb / nc, c = mb % nc;
  const int row = r * 16 + (lane >> 1), col = c * 16 + (lane & 1) * 8;
  int sad = 0, s = 0, s2 = 0, sse = 0;
  for (int k = 0; k < 8; ++k) {
    const int v = y[row * W + col + k];
    if (prev) sad += abs(v - (int)prev[row * W + col + k]);
    s += v;
    s2 += v * v;
    if (O.recon) {
      const int d = v - (int)O.recon[row * W + col + k];
      sse += d * d;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sad += __shfl_down_sync(0xffffffffu, sad, o);
    s += __shfl_down_sync(0xffffffffu, s, o);
    s2 += __shfl_down_sync(0xffffffffu, s2, o);
  }
  if (O.recon)
    for (int o = 16; o > 0; o >>= 1) sse += __shfl_down_sync(0xffffffffu, sse, o);
  bool coded = false;
  if (O.luma) {
    coded = any_nonzero(O.luma + mb * 256, 256, lane) | any_nonzero(O.cb_ac + mb * 60, 60, lane) |
            any_nonzero(O.cr_ac + mb * 60, 60, lane) | any_nonzero(O.cb_dc + mb * 4, 4, lane) |
            any_nonzero(O.cr_dc + mb * 4, 4, lane);
  }
  if (lane == 0) {
    // 256*s2 and s*s wrap in 32 bits; their difference (< 2^31) does not
    const int a = (int)(256u * (unsigned)s2 - (unsigned)s * (unsigned)s);
    S.act[mb] = max(a, 0);
    S.sse[mb] = sse;
    const int dmg = prev && sad > thr_sad;
    grid[mb] = (uint8_t)dmg;
    if (dmg) atomicAdd(S.n_damage, 1);
    if (O.mv) {
      const float fy = (float)O.mv[mb * 2], fx = (float)O.mv[mb * 2 + 1];
      S.mag[mb] = __float_as_int(__fsqrt_rn(__fadd_rn(__fmul_rn(fy, fy), __fmul_rn(fx, fx))));
      const bool zero_mv = O.mv[mb * 2] == 0 && O.mv[mb * 2 + 1] == 0;
      if constexpr (INTRA) {
        const bool intra = O.mb_intra[mb] != 0;
        if (O.luma && intra) atomicAdd(S.n_intra, 1);
        if (O.luma && !coded && zero_mv && !intra) atomicAdd(S.n_skip, 1);
      } else {
        if (O.luma && !coded && zero_mv) atomicAdd(S.n_skip, 1);
      }
    }
  }
}

__device__ __forceinline__ float to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <class T>
__device__ float percentile(const T* sorted, int n, float q) {
  const float pos = __fmul_rn(__fdiv_rn(q, 100.0f), (float)(n - 1));
  const float low = floorf(pos), high = ceilf(pos);
  const float hw = __fsub_rn(pos, low), lw = __fsub_rn(1.0f, hw);
  const int li = min(max((int)low, 0), n - 1), hi = min(max((int)high, 0), n - 1);
  return __fadd_rn(__fmul_rn(to_f(sorted[li]), lw), __fmul_rn(to_f(sorted[hi]), hw));
}

// Ascending bitonic sort of s[0:n_pad] in shared memory (whole block).
__device__ __forceinline__ void bitonic_sort(int* s, int n_pad) {
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const int a = s[i], b = s[ixj];
          if ((a > b) == up) { s[i] = b; s[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// one block per frame
__global__ void __launch_bounds__(SORT_THREADS) sort_pct_kernel(
    int* scratch, bool has_prev, float* vecs, int n, int n_pad) {
  extern __shared__ int s[];
  const Scratch S(scratch, n, blockIdx.x, gridDim.x);
  float* vec = vecs + 10 * blockIdx.x;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) s[i] = i < n ? S.act[i] : INT_MAX;
  __syncthreads();
  bitonic_sort(s, n_pad);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 10; ++i) vec[i] = -1.0f;
    vec[1] = has_prev ? (float)*S.n_damage : -1.0f;
    vec[7] = percentile(s, n, 50.0f);
    vec[8] = percentile(s, n, 95.0f);
    vec[9] = (float)n;
  }
}

// The recon / MV / mode slots, after sort_pct_kernel on the same stream;
// one block per frame.
template <bool INTRA>
__global__ void __launch_bounds__(SORT_THREADS) extras_kernel(
    int* scratch, Optional OK, float* vecs, int n, int n_pad) {
  extern __shared__ int s[];
  const Scratch S(scratch, n, blockIdx.x, gridDim.x);
  const Optional O = OK.at(blockIdx.x, gridDim.x, n);
  float* vec = vecs + 10 * blockIdx.x;
  __shared__ long long sse_part[SORT_THREADS / 32];
  __shared__ double mag_part[SORT_THREADS / 32];
  const int t = threadIdx.x;
  long long sse = 0;
  double mag = 0.0;
  for (int i = t; i < n; i += blockDim.x) {
    if (O.recon) sse += S.sse[i];
    if (O.mv) mag += (double)__int_as_float(S.mag[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sse += __shfl_down_sync(0xffffffffu, sse, o);
    mag += __shfl_down_sync(0xffffffffu, mag, o);
  }
  if ((t & 31) == 0) {
    sse_part[t >> 5] = sse;
    mag_part[t >> 5] = mag;
  }
  // |MV| >= 0: its float bits sort as ints
  if (O.mv) {
    for (int i = t; i < n_pad; i += blockDim.x) s[i] = i < n ? S.mag[i] : INT_MAX;
    __syncthreads();
    bitonic_sort(s, n_pad);
  }
  __syncthreads();
  if (t == 0) {
    long long sse_tot = 0;
    double mag_tot = 0.0;
    for (int w = 0; w < SORT_THREADS / 32; ++w) {
      sse_tot += sse_part[w];
      mag_tot += mag_part[w];
    }
    if (O.recon) vec[0] = (float)sse_tot;
    if (O.luma) {
      if constexpr (INTRA) {
        vec[2] = (float)*S.n_skip;
        vec[3] = (float)(n - *S.n_intra - *S.n_skip);
        vec[4] = (float)*S.n_intra;
      } else {
        vec[2] = (float)*S.n_skip;
        vec[3] = (float)(n - *S.n_skip);
        vec[4] = 0.0f;
      }
    }
    if (O.mv) {
      vec[5] = (float)(mag_tot / n);
      vec[6] = percentile(reinterpret_cast<const float*>(s), n, 95.0f);
    }
  }
}

template <bool INTRA>
int stats_launch(const uint8_t* ys, const uint8_t* prev, const Optional& O, float* vecs,
                 uint8_t* grids, int* scratch, int K, int nr, int nc, int thr_sad,
                 cudaStream_t stream) {
  const int n = nr * nc;
  int n_pad = 1;
  while (n_pad < n) n_pad <<= 1;
  int e;
  if ((e = cudaMemsetAsync(scratch + (size_t)3 * n * K, 0, 3 * K * sizeof(int), stream)))
    return e;
  mb_reduce_kernel<INTRA><<<dim3((n + MBS_PER_BLOCK - 1) / MBS_PER_BLOCK, K),
                            32 * MBS_PER_BLOCK, 0, stream>>>(ys, prev, O, grids, scratch, nr,
                                                             nc, thr_sad);
  if ((e = dngd_last_error())) return e;
  const size_t smem = sizeof(int) * n_pad;
  if (smem > 46 * 1024 &&
      ((e = cudaFuncSetAttribute(sort_pct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)) ||
       (e = cudaFuncSetAttribute(extras_kernel<INTRA>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))))
    return e;
  sort_pct_kernel<<<K, SORT_THREADS, smem, stream>>>(scratch, prev != nullptr, vecs, n, n_pad);
  if ((e = dngd_last_error())) return e;
  if (!O.recon && !O.mv) return 0;
  extras_kernel<INTRA><<<K, SORT_THREADS, smem, stream>>>(scratch, O, vecs, n, n_pad);
  return dngd_last_error();
}

}  // namespace

// ys (K, H, W); prev the luma before slot 0 (null: no damage); recon the
// last slot's; mv and the residuals (K, ...) stacks or null; mb_intra the
// (K, R, C) I16-in-P flags or null; vecs (K, 10), grids (K, R, C),
// scratch 3 * K * R * C + 3 * K ints.
extern "C" int chunk_stats_launch(const uint8_t* ys, const uint8_t* prev, const uint8_t* recon,
                                  const int* mv, const int* luma, const int* cb_dc,
                                  const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                  const uint8_t* mb_intra, float* vecs, uint8_t* grids,
                                  int* scratch, int K, int nr, int nc, int thr_sad,
                                  cudaStream_t stream) {
  const int n = nr * nc;
  if (n <= 0 || n > (1 << 15) || K <= 0) return cudaErrorInvalidValue;
  const Optional O{recon, mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, mb_intra};
  if (mb_intra)
    return stats_launch<true>(ys, prev, O, vecs, grids, scratch, K, nr, nc, thr_sad, stream);
  return stats_launch<false>(ys, prev, O, vecs, grids, scratch, K, nr, nc, thr_sad, stream);
}
