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
// planes; this kernel keeps the promise.  What bounds it: bytes, two
// planes read once (4.2 MB at 1088x1920, 0.0012 ms), against a graph
// kernel node's own floor (~0.0015 ms on an H100).  Design (redesigned
// for Hopper): one kernel, one graph node, no memset.  The grid fits one
// wave of the card (at most 8 CTAs an SM); each thread keeps SSE_U
// 16-byte loads of each plane in flight, squares their byte differences
// by __vabsdiffu4 and __dp4a in 32 bits (at most 4 x 16 x 255^2 a batch)
// and widens each batch into a 64-bit sum; a warp and then the CTA
// reduce.  Each CTA adds its partial and one arrival to one 64-bit word
// (`g_sse_acc`: the sum below bit 53, the arrivals above) by a single
// atomicAdd; the CTA whose add finds every other CTA arrived holds the
// whole sum (integers: exact, in any order), writes `out` and zeroes the
// word for the next launch.
// The word is a __device__ variable, zero when the module loads on a
// device, so a graph replays the launch as it is; launches of one device
// must be stream-ordered (they share it).  The tail past the last whole
// vector, or the whole plane when a pointer is not 16-byte aligned, takes
// the byte path.
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

constexpr int SSE_NT = 256;
constexpr int SSE_U = 4;              // 16-byte loads of each plane in flight a thread
constexpr int SSE_CTAS_PER_SM = 8;
constexpr int SSE_MAX_CTAS = 2048;    // fits the arrival count's 11 bits
constexpr int SUM_BITS = 53;          // n * 255^2 < 2^47 for n < 2^31
// the running sum in the low SUM_BITS bits, the CTAs arrived above them;
// 0 between launches
__device__ unsigned long long g_sse_acc;

// the squared differences of four byte pairs (at most 4 x 255^2)
__device__ __forceinline__ unsigned sq4(unsigned a, unsigned b) {
  const unsigned d = __vabsdiffu4(a, b);
  return __dp4a(d, d, 0u);
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long s,
                                                        unsigned long long* part) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < SSE_NT / 32; ++w) s += part[w];
  return s;                           // thread 0's
}

__global__ void __launch_bounds__(SSE_NT) sse_kernel(const uint8_t* __restrict__ a,
                                                     const uint8_t* __restrict__ b,
                                                     unsigned long long* out, int n, int nvec) {
  __shared__ unsigned long long part[SSE_NT / 32];
  const int stride = gridDim.x * SSE_NT;
  const int t0 = blockIdx.x * SSE_NT + threadIdx.x;
  const uint4* va = reinterpret_cast<const uint4*>(a);
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  unsigned long long s = 0;
  for (int v0 = t0; v0 < nvec; v0 += SSE_U * stride) {
    uint4 x[SSE_U], y[SSE_U];
#pragma unroll
    for (int u = 0; u < SSE_U; ++u) {
      const int v = v0 + u * stride;
      x[u] = v < nvec ? __ldg(va + v) : make_uint4(0, 0, 0, 0);
      y[u] = v < nvec ? __ldg(vb + v) : make_uint4(0, 0, 0, 0);
    }
    unsigned acc = 0;
#pragma unroll
    for (int u = 0; u < SSE_U; ++u)
      acc += sq4(x[u].x, y[u].x) + sq4(x[u].y, y[u].y) + sq4(x[u].z, y[u].z) +
             sq4(x[u].w, y[u].w);
    s += acc;
  }
  for (int k = nvec * 16 + t0; k < n; k += stride) {
    const int d = (int)a[k] - (int)b[k];
    s += (unsigned)(d * d);
  }
  s = block_sum(s, part);
  if (threadIdx.x == 0) {             // one atomic: the partial and the arrival
    const unsigned long long old = atomicAdd(&g_sse_acc, s + (1ull << SUM_BITS));
    if ((old >> SUM_BITS) == gridDim.x - 1) {   // the last CTA: every partial is in
      *out = (old & ((1ull << SUM_BITS) - 1)) + s;
      g_sse_acc = 0;                  // for the next launch (stream-ordered)
    }
  }
}

}  // namespace

// out: one unsigned long long, written by the launch's last CTA (no memset).
extern "C" int sse_launch(const uint8_t* a, const uint8_t* b, unsigned long long* out, int n,
                          cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  static int sms[64];                 // per device, read once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const int nvec = vec ? n / 16 : 0;
  const long long work = vec ? (nvec + SSE_U - 1) / SSE_U : n;   // a thread's first batch
  const int cap = std::min(SSE_MAX_CTAS, sms[dev] * SSE_CTAS_PER_SM);
  const int ctas = static_cast<int>(
      std::max(1LL, std::min<long long>((work + SSE_NT - 1) / SSE_NT, cap)));
  sse_kernel<<<ctas, SSE_NT, 0, stream>>>(a, b, out, n, nvec);
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
