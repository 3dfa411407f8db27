// K17p and K17c — the two kernels of the device-only timing loops
// (ops/devloop.py intra_loop ... cabac_p_loop, rows 17a-f).
//
// K17p replaces docker_nvidia_glx_desktop_tpu/ops/devloop.py:33 _perturb:
// (x + (i & 1)).clip(0, 255) on the Y, Cb and Cr planes in one launch,
// the loop index i read from device memory, so one captured step serves
// every iteration of a loop.  A thread takes 16 bytes of a plane as one
// vector load, adds with a per-byte saturating add (__vaddus4 is exactly
// the clip at 255) and stores 16 bytes; blockIdx.y picks the plane and a
// plane's tail (its bytes past the last whole vector, or every byte when
// a pointer is not 16-byte aligned) takes the byte path.  What bounds
// it: bytes, each plane read once and written once (6.27 MB at 1080p).
//
// K17c replaces the loop carry of the same file's fori_loop bodies
// (`acc + word.astype(jnp.uint32)`, :49, :82, :112, :134, :155, :199):
// one thread adds the step's checksum word (a uint8 byte or an int32,
// as uint32) into the uint32 accumulator and increments i, both on the
// card, so a replayed step needs nothing from the host.  Its bound is 0.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) perturb_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, uint8_t* __restrict__ oy, uint8_t* __restrict__ ocb,
    uint8_t* __restrict__ ocr, const int* __restrict__ i_dev, int n_luma, int n_chroma) {
  const int p = blockIdx.y;
  const uint8_t* src = p == 0 ? y : (p == 1 ? cb : cr);
  uint8_t* dst = p == 0 ? oy : (p == 1 ? ocb : ocr);
  const int n = p == 0 ? n_luma : n_chroma;
  const unsigned add = (unsigned)(*i_dev & 1);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nvec = vec ? n / 16 : 0;
  const int stride = gridDim.x * NT;
  const unsigned add4 = add * 0x01010101u;
  for (int v = blockIdx.x * NT + threadIdx.x; v < nvec; v += stride) {
    uint4 w = reinterpret_cast<const uint4*>(src)[v];
    w.x = __vaddus4(w.x, add4);
    w.y = __vaddus4(w.y, add4);
    w.z = __vaddus4(w.z, add4);
    w.w = __vaddus4(w.w, add4);
    reinterpret_cast<uint4*>(dst)[v] = w;
  }
  for (int k = nvec * 16 + blockIdx.x * NT + threadIdx.x; k < n; k += stride)
    dst[k] = (uint8_t)min((unsigned)src[k] + add, 255u);
}

__global__ void tick_kernel(const void* __restrict__ src, int offset, int is_byte,
                            unsigned* acc, int* i_dev) {
  const unsigned w = is_byte ? (unsigned)static_cast<const uint8_t*>(src)[offset]
                             : (unsigned)static_cast<const int*>(src)[offset];
  *acc += w;
  *i_dev += 1;
}

}  // namespace

extern "C" int perturb_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                              uint8_t* oy, uint8_t* ocb, uint8_t* ocr, const int* i_dev,
                              int n_luma, int n_chroma, cudaStream_t stream) {
  if (n_luma < 0 || n_chroma < 0) return cudaErrorInvalidValue;
  const int vecs = (n_luma + 15) / 16;
  const int blocks = std::max(1, std::min((vecs + NT - 1) / NT, 132 * 8));
  perturb_kernel<<<dim3(blocks, 3), NT, 0, stream>>>(y, cb, cr, oy, ocb, ocr, i_dev, n_luma,
                                                     n_chroma);
  return dngd_last_error();
}

extern "C" int tick_launch(const void* src, unsigned* acc, int* i_dev, int offset, int is_byte,
                           cudaStream_t stream) {
  if (offset < 0) return cudaErrorInvalidValue;
  tick_kernel<<<1, 1, 0, stream>>>(src, offset, is_byte, acc, i_dev);
  return dngd_last_error();
}
