// K14 — the tune=hq per-MB qp plane: the activity delta of each MB's
// luma, plus the 1-frame lookahead bias where the next frame is staged,
// added to the slice qp and clipped to [1, 51].
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/aq.py:115 qp_plane with
// :87 aq_offsets, :103 lookahead_bias and :77 mb_activity; equal to them.
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
    const int* __restrict__ qp_dev, const int* __restrict__ steps, int* qp_map, int nc, int qp,
    int first, int n_steps, int bias) {
  __shared__ int part[3][NT / 32];
  const int mb = blockIdx.x, r = mb / nc, c = mb % nc, t = threadIdx.x;
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

}  // namespace

// next_y, qp_dev: null when absent; steps: the delta's breakpoints.
extern "C" int qp_plane_launch(const uint8_t* y, const uint8_t* next_y, const int* qp_dev,
                               const int* steps, int* qp_map, int nr, int nc, int qp, int first,
                               int n_steps, int bias, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  qp_plane_kernel<<<nr * nc, NT, 0, stream>>>(y, next_y, qp_dev, steps, qp_map, nc, qp, first,
                                              n_steps, bias);
  return dngd_last_error();
}
