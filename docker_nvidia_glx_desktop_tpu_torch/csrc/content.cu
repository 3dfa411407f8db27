// K4 — content stats of one frame: per-MB damage (summed abs diff against
// the previous ingest luma above a threshold), its count, and the p50/p95
// of the per-MB luma activity (256 * sum of squared deviation).
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/content_stats.py:156
// frame_stats -> _frame_vec :120 (with ops/aq.py:77 mb_activity) where
// no recon, MV field or residual is passed: the vector is
// [-1, n_damage, -1, -1, -1, -1, -1, act_p50, act_p95, R*C].
//
// What bounds it: bytes for the reduction (two luma planes, read once),
// then one block's sort.  Pass 1 gives each MB one warp (8 pixels a lane,
// shuffle reductions).  Pass 2 is one block of 1024 threads that
// bitonic-sorts the activity values in shared memory (padded to a power
// of two) and applies jnp.percentile's linear interpolation in float32
// with round-to-nearest operations (no contraction into FMAs).
#include <climits>

#include "common.cuh"

namespace {

constexpr int MBS_PER_BLOCK = 8;
constexpr int SORT_THREADS = 1024;

__global__ void mb_reduce_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ prev,
                                 uint8_t* grid, int* act, int* n_damage, int nr, int nc,
                                 int thr_sad) {
  const int mb = blockIdx.x * MBS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (mb >= nr * nc) return;
  const int W = nc * 16;
  const int r = mb / nc, c = mb % nc;
  const int row = r * 16 + (lane >> 1), col = c * 16 + (lane & 1) * 8;
  int sad = 0, s = 0, s2 = 0;
  for (int k = 0; k < 8; ++k) {
    const int v = y[row * W + col + k];
    sad += abs(v - (int)prev[row * W + col + k]);
    s += v;
    s2 += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sad += __shfl_down_sync(0xffffffffu, sad, o);
    s += __shfl_down_sync(0xffffffffu, s, o);
    s2 += __shfl_down_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) {
    // 256*s2 and s*s wrap in 32 bits; their difference (< 2^31) does not
    const int a = (int)(256u * (unsigned)s2 - (unsigned)s * (unsigned)s);
    act[mb] = max(a, 0);
    const int dmg = sad > thr_sad;
    grid[mb] = (uint8_t)dmg;
    if (dmg) atomicAdd(n_damage, 1);
  }
}

__device__ float percentile(const int* sorted, int n, float q) {
  const float pos = __fmul_rn(__fdiv_rn(q, 100.0f), (float)(n - 1));
  const float low = floorf(pos), high = ceilf(pos);
  const float hw = __fsub_rn(pos, low), lw = __fsub_rn(1.0f, hw);
  const int li = min(max((int)low, 0), n - 1), hi = min(max((int)high, 0), n - 1);
  return __fadd_rn(__fmul_rn(__int2float_rn(sorted[li]), lw),
                   __fmul_rn(__int2float_rn(sorted[hi]), hw));
}

__global__ void __launch_bounds__(SORT_THREADS) sort_pct_kernel(
    const int* act, const int* n_damage, float* vec, int n, int n_pad) {
  extern __shared__ int s[];
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) s[i] = i < n ? act[i] : INT_MAX;
  __syncthreads();
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
  if (threadIdx.x == 0) {
    for (int i = 0; i < 10; ++i) vec[i] = -1.0f;
    vec[1] = (float)*n_damage;
    vec[7] = percentile(s, n, 50.0f);
    vec[8] = percentile(s, n, 95.0f);
    vec[9] = (float)n;
  }
}

}  // namespace

extern "C" int frame_stats_launch(const uint8_t* y, const uint8_t* prev, float* vec,
                                  uint8_t* grid, int* scratch, int nr, int nc, int thr_sad,
                                  cudaStream_t stream) {
  const int n = nr * nc;
  if (n <= 0 || n > (1 << 15)) return cudaErrorInvalidValue;
  int n_pad = 1;
  while (n_pad < n) n_pad <<= 1;
  int* n_damage = scratch + n;
  int e;
  if ((e = cudaMemsetAsync(n_damage, 0, sizeof(int), stream))) return e;
  mb_reduce_kernel<<<(n + MBS_PER_BLOCK - 1) / MBS_PER_BLOCK, 32 * MBS_PER_BLOCK, 0, stream>>>(
      y, prev, grid, scratch, n_damage, nr, nc, thr_sad);
  if ((e = dngd_last_error())) return e;
  const size_t smem = sizeof(int) * n_pad;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(sort_pct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)))
    return e;
  sort_pct_kernel<<<1, SORT_THREADS, smem, stream>>>(scratch, n_damage, vec, n, n_pad);
  return dngd_last_error();
}
