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
// What bounds it: bytes, the luma (and the next frame's) read once: 2 x
// 2.1 MB in and 33 KB out at 1080p (0.0013 ms), under a graph kernel
// node's own floor (~0.0015 ms).  Design (redesigned for Hopper): a warp
// two horizontally adjacent MBs of one row (QP_*), lane 2 row + m loading
// row `row` of MB m as one 16-byte word (a lane pair reads one 32-byte
// sector), and the next frame's word where one is staged; the sums by
// __dp4a (s <= 65280, s2 <= 16,646,400 and the SAD <= 65280: exact in 32
// bits), four xor-shuffles reduce each MB's 16 lanes; then lane k of
// half-warp m compares MB m's activity with breakpoint k (lanes past the
// breakpoints masked), and a ballot's popcount is the delta.  A plane off a
// 16-byte boundary takes the same words byte by byte.
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

constexpr int QP_WARPS = 8, QP_NT = 32 * QP_WARPS;   // a warp two MBs
constexpr int MAX_STEPS = 16;

// 16 bytes from p: one load, or byte by byte where p may be off 16 bytes
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<unsigned>(p[4 * k]) | (static_cast<unsigned>(p[4 * k + 1]) << 8) |
           (static_cast<unsigned>(p[4 * k + 2]) << 16) | (static_cast<unsigned>(p[4 * k + 3]) << 24);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned dp4(const uint4& a, const uint4& b) {
  return __dp4a(a.x, b.x, __dp4a(a.y, b.y, __dp4a(a.z, b.z, __dp4a(a.w, b.w, 0u))));
}

template <bool VEC>
__global__ void __launch_bounds__(QP_NT) qp_plane_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ next_y,
    const int* __restrict__ rows, const int* __restrict__ qp_dev,
    const int* __restrict__ steps, int* qp_map, int nb, int nc, int qp, int first, int n_steps,
    int bias) {
  const int lane = threadIdx.x & 31, np = (nc + 1) >> 1;   // MB pairs a row
  const int gw = blockIdx.x * QP_WARPS + (threadIdx.x >> 5);
  const int i = gw / np;                     // the output row
  if (i >= nb) return;                       // the whole warp
  const int m = lane & 1, c = 2 * (gw - i * np) + m;
  const bool valid = c < nc;                 // an odd row's last pair has one MB
  const int r = rows ? __ldg(rows + i) : i;  // the frame row read
  const size_t off = (static_cast<size_t>(r) * 16 + (lane >> 1)) * (static_cast<size_t>(nc) * 16) +
                     static_cast<size_t>(c) * 16;
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  unsigned s = 0, s2 = 0, sad = 0;
  if (valid) {
    const uint4 w = load16<VEC>(y + off);
    s = dp4(w, ones);
    s2 = dp4(w, w);
    if (next_y) {
      const uint4 n = load16<VEC>(next_y + off);
      const uint4 d = make_uint4(__vabsdiffu4(w.x, n.x), __vabsdiffu4(w.y, n.y),
                                 __vabsdiffu4(w.z, n.z), __vabsdiffu4(w.w, n.w));
      sad = dp4(d, ones);
    }
  }
#pragma unroll
  for (int o = 2; o < 32; o <<= 1) {         // the 16 lanes of MB m (lane parity m)
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    sad += __shfl_xor_sync(0xffffffffu, sad, o);
  }
  // 256*s2 and s*s wrap in 32 bits, as the reference's int32 products
  const int act = max(static_cast<int>(256u * s2 - s * s), 0);
  // lane k of half-warp h: MB h's activity against breakpoint k
  const int h = lane >> 4, k = lane & 15;
  const int act_h = __shfl_sync(0xffffffffu, act, h);
  const unsigned up =
      __ballot_sync(0xffffffffu, k < min(n_steps, MAX_STEPS) && act_h >= __ldg(steps + k));
  if (lane < 2 && valid) {                   // lane m: MB m
    int d = first + __popc(up & (0xffffu << (16 * m)));
    if (next_y) d += sad <= 256 ? -bias : (sad >= 6 * 256 ? 1 : 0);
    const int q = qp_dev ? *qp_dev : qp;
    qp_map[static_cast<size_t>(i) * nc + c] = min(max(q + d, 1), 51);
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
  int sms = 0;
  if (const int e = dngd_sm_count(&sms)) return e;
  const bool vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const int nvec = vec ? n / 16 : 0;
  const long long work = vec ? (nvec + SSE_U - 1) / SSE_U : n;   // a thread's first batch
  const int cap = std::min(SSE_MAX_CTAS, sms * SSE_CTAS_PER_SM);
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
  const long long warps = static_cast<long long>(nb) * ((nc + 1) / 2);
  const long long ctas = (warps + QP_WARPS - 1) / QP_WARPS;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(next_y)) & 15) == 0;
  if (vec)
    qp_plane_kernel<true><<<static_cast<unsigned>(ctas), QP_NT, 0, stream>>>(
        y, next_y, rows, qp_dev, steps, qp_map, nb, nc, qp, first, n_steps, bias);
  else
    qp_plane_kernel<false><<<static_cast<unsigned>(ctas), QP_NT, 0, stream>>>(
        y, next_y, rows, qp_dev, steps, qp_map, nb, nc, qp, first, n_steps, bias);
  return dngd_last_error();
}
