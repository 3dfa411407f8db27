// K14 — the tune=hq per-MB qp plane: the activity delta of each MB's
// luma, plus the 1-frame lookahead bias where the next frame is staged,
// added to the slice qp and clipped to [1, 51].
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/aq.py:115 qp_plane with
// :87 aq_offsets, :103 lookahead_bias and :77 mb_activity; equal to them.
// K14r, the same kernel over a worklist of MB rows, is the qp plane that
// docker_nvidia_glx_desktop_tpu/ops/damage_mask.py:170 row_core computes
// band by band: the math is per MB, so it equals the frame's plane at
// those rows, and the kernel reads only the listed rows.
//
// The reference's delta round(s * 0.5 * (log2(act/256 + 1) - 12)) is a
// monotone step function of the integer activity act = 256 * s2 - s * s
// (int32, wrapping as the reference's int32 products wrap); the host
// passes its breakpoints, so the kernel compares integers and no float
// log2 (XLA's differs from CUDA's) is evaluated.
//
// What bounds it: bytes.  One block of 256 threads per MB reads its 256
// luma samples (and the next frame's), a pixel a thread, block-reduces
// the sums and writes one int32.  At 1080p that is 2 x 2.1 MB in and
// 33 KB out.
//
// K14d — the BD-rate bench's distortion: the sum of squared differences
// of two uint8 planes as one device reduction.  Replaces
// docker_nvidia_glx_desktop_tpu/ops/aq.py:196 _mse_reduce (:204
// mse_planes, :216 psnr_planes).  The reference promises an exact int64
// SSE, but JAX runs with x64 off, so its sum is int32 and wraps on large
// planes; this kernel keeps the promise.  Each thread squares the
// differences of one 16-byte vector load of each plane in int32 (at most
// 16 x 255^2), adds them into a 64-bit sum over its grid-stride chunks,
// a warp and then the block reduce, and each block adds its sum to one
// unsigned long long with atomicAdd (zeroed on the stream first).  The
// tail past the last whole vector, or the whole plane when a pointer is
// not 16-byte aligned, takes the byte path.  What bounds it: bytes, two
// planes read once (4.2 MB at 1088x1920, 0.0012 ms); at that size the
// launch dominates.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_STEPS = 16;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) qp_plane_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ next_y,
    const int* __restrict__ rows, const int* __restrict__ qp_dev,
    const int* __restrict__ steps, int* qp_map, int nc, int qp, int first, int n_steps,
    int bias) {
  __shared__ int part[3][NT / 32];
  // mb: the output MB (row mb / nc of the worklist), r: the frame row read
  const int mb = blockIdx.x, c = mb % nc, t = threadIdx.x;
  const int r = rows ? rows[mb / nc] : mb / nc;
  const int W = nc * 16;
  const int idx = (r * 16 + (t >> 4)) * W + c * 16 + (t & 15);
  const int v = y[idx];
  int s = warp_sum(v), s2 = warp_sum(v * v);
  int sad = next_y ? warp_sum(abs(v - (int)next_y[idx])) : 0;
  if ((t & 31) == 0) {
    part[0][t >> 5] = s;
    part[1][t >> 5] = s2;
    part[2][t >> 5] = sad;
  }
  __syncthreads();
  if (t == 0) {
    s = s2 = sad = 0;
    for (int w = 0; w < NT / 32; ++w) {
      s += part[0][w];
      s2 += part[1][w];
      sad += part[2][w];
    }
    // 256*s2 and s*s wrap in 32 bits, as the reference's int32 products
    const int act = max((int)(256u * (unsigned)s2 - (unsigned)s * (unsigned)s), 0);
    int d = first;
    for (int k = 0; k < n_steps && k < MAX_STEPS; ++k) d += act >= steps[k];
    if (next_y) d += sad <= 256 ? -bias : (sad >= 6 * 256 ? 1 : 0);
    const int q = qp_dev ? *qp_dev : qp;
    qp_map[mb] = min(max(q + d, 1), 51);
  }
}

__device__ __forceinline__ int sq_diff4(unsigned a, unsigned b) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const int d = (int)((a >> k) & 255u) - (int)((b >> k) & 255u);
    s += d * d;
  }
  return s;
}

__global__ void __launch_bounds__(NT) sse_kernel(const uint8_t* __restrict__ a,
                                                 const uint8_t* __restrict__ b,
                                                 unsigned long long* out, int n) {
  __shared__ unsigned long long part[NT / 32];
  const bool vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const int nvec = vec ? n / 16 : 0;
  const int stride = gridDim.x * NT;
  const int t0 = blockIdx.x * NT + threadIdx.x;
  unsigned long long s = 0;
  for (int v = t0; v < nvec; v += stride) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[v];
    const uint4 y = reinterpret_cast<const uint4*>(b)[v];
    s += (unsigned)(sq_diff4(x.x, y.x) + sq_diff4(x.y, y.y) + sq_diff4(x.z, y.z) +
                    sq_diff4(x.w, y.w));
  }
  for (int k = nvec * 16 + t0; k < n; k += stride) {
    const int d = (int)a[k] - (int)b[k];
    s += (unsigned)(d * d);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0;
    for (int w = 0; w < NT / 32; ++w) s += part[w];
    atomicAdd(out, s);
  }
}

}  // namespace

// out: one unsigned long long, zeroed here before the reduction.
extern "C" int sse_launch(const uint8_t* a, const uint8_t* b, unsigned long long* out, int n,
                          cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vecs = (n + 15) / 16;
  const int blocks = std::max(1, std::min((vecs + NT - 1) / NT, 132 * 8));
  sse_kernel<<<blocks, NT, 0, stream>>>(a, b, out, n);
  return dngd_last_error();
}

// next_y, qp_dev: null when absent; steps: the delta's breakpoints.
// rows: null for the whole frame (nb = nr), else the nb MB rows of a
// worklist (K14r): qp_map is then (nb, nc), row i from frame row rows[i]
// of y and next_y.
extern "C" int qp_plane_launch(const uint8_t* y, const uint8_t* next_y, const int* rows,
                               const int* qp_dev, const int* steps, int* qp_map, int nr, int nc,
                               int nb, int qp, int first, int n_steps, int bias,
                               cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || nb <= 0) return 0;
  if (!rows && nb != nr) return cudaErrorInvalidValue;
  qp_plane_kernel<<<nb * nc, NT, 0, stream>>>(y, next_y, rows, qp_dev, steps, qp_map, nc, qp,
                                              first, n_steps, bias);
  return dngd_last_error();
}
