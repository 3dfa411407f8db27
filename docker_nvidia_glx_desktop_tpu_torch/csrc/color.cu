// K9 — RGB -> studio-range BT.601 YUV 4:2:0 planes, edge-padded to MB
// multiples: Y (pad_h, pad_w), Cb/Cr (pad_h/2, pad_w/2), uint8.
//
// Replaces docker_nvidia_glx_desktop_tpu/models/h264.py:207 _yuv_stage
// (ops/color.py:90 rgb_to_yuv420, matrix="video", then round and clip);
// bit-exact with it as XLA compiles it on the CPU.  The arithmetic is
// spelled out with round-to-nearest intrinsics so that nvcc may not
// contract or reorder it: per pixel and channel
//   fma(b, m2, fma(r, m0, g * m1)) + off        (float32)
// chroma the 2x2 quad summed in row order ((p00 + p01) + p10) + p11 and
// multiplied by 0.25 (exact), every value rounded half-to-even (rintf)
// and clipped to 0..255.
//
// What bounds it: bytes.  At 1080p it reads 6.2 MB of RGB and writes
// 3.1 MB of planes (~2.8 us at 3.35 TB/s).  One thread per output 2x2
// quad reads its 2 x 2 pixels (clamped to the frame: the edge padding)
// and writes four luma samples and one sample of each chroma plane; no
// shared memory, no reuse across threads.
//
// A frame axis (grid.z = K) converts a staged chunk of K frames in one
// launch: the super-step ring's rgb ingest, whose luma is also the
// content stats' input (docker_nvidia_glx_desktop_tpu/models/h264.py:220
// _stack_luma and ops/devloop.py:306-316).
#include <cstring>

#include "common.cuh"

namespace {

struct Matrix {
  float m[3][3], off[3];
};

__device__ __forceinline__ float channel(const Matrix& M, int d, float r, float g, float b) {
  float acc = __fmul_rn(g, M.m[d][1]);
  acc = __fmaf_rn(r, M.m[d][0], acc);
  acc = __fmaf_rn(b, M.m[d][2], acc);
  return __fadd_rn(acc, M.off[d]);
}

__device__ __forceinline__ uint8_t q(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

__global__ void color_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ y,
                             uint8_t* __restrict__ cb, uint8_t* __restrict__ cr, int h,
                             int w, int pad_h, int pad_w, Matrix M) {
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  const int cw = pad_w / 2;
  if (qx >= cw || qy >= pad_h / 2) return;
  const size_t f = blockIdx.z;
  rgb += f * h * w * 3;
  y += f * pad_h * pad_w;
  cb += f * (pad_h / 2) * cw;
  cr += f * (pad_h / 2) * cw;
  float c[2][2][2];  // [dy][dx][cb, cr]
  for (int dy = 0; dy < 2; ++dy) {
    const int sy = min(2 * qy + dy, h - 1);
    for (int dx = 0; dx < 2; ++dx) {
      const int sx = min(2 * qx + dx, w - 1);
      const uint8_t* p = rgb + ((size_t)sy * w + sx) * 3;
      const float r = p[0], g = p[1], b = p[2];
      y[(size_t)(2 * qy + dy) * pad_w + 2 * qx + dx] = q(channel(M, 0, r, g, b));
      c[dy][dx][0] = channel(M, 1, r, g, b);
      c[dy][dx][1] = channel(M, 2, r, g, b);
    }
  }
  for (int k = 0; k < 2; ++k) {
    const float s = __fadd_rn(__fadd_rn(__fadd_rn(c[0][0][k], c[0][1][k]), c[1][0][k]),
                              c[1][1][k]);
    (k ? cr : cb)[(size_t)qy * cw + qx] = q(__fmul_rn(s, 0.25f));
  }
}

}  // namespace

// k frames (K, h, w, 3) -> (K, pad_h, pad_w) and 2 x (K, pad_h/2, pad_w/2);
// m: the 3x3 matrix row-major then the 3 offsets, as float32 bit patterns.
extern "C" int rgb_to_yuv420_launch(const uint8_t* rgb, uint8_t* y, uint8_t* cb, uint8_t* cr,
                                    int k, int h, int w, int pad_h, int pad_w, int m00, int m01,
                                    int m02, int m10, int m11, int m12, int m20, int m21,
                                    int m22, int o0, int o1, int o2, cudaStream_t stream) {
  if (pad_h <= 0 || pad_w <= 0 || k <= 0) return 0;
  if (k > 65535) return cudaErrorInvalidValue;
  const int bits[12] = {m00, m01, m02, m10, m11, m12, m20, m21, m22, o0, o1, o2};
  Matrix M;
  for (int k = 0; k < 9; ++k) {
    int v = bits[k];
    memcpy(&M.m[k / 3][k % 3], &v, 4);
  }
  for (int k = 0; k < 3; ++k) {
    int v = bits[9 + k];
    memcpy(&M.off[k], &v, 4);
  }
  const dim3 block(32, 8);
  const dim3 grid((pad_w / 2 + block.x - 1) / block.x, (pad_h / 2 + block.y - 1) / block.y, k);
  color_kernel<<<grid, block, 0, stream>>>(rgb, y, cb, cr, h, w, pad_h, pad_w, M);
  return dngd_last_error();
}
