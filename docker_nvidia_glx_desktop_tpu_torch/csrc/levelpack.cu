// K10 — level transport of the CABAC path: a frame's quantized level
// slots (MB by MB in wire order) -> the version-1 uint32 transport.  Each
// zero slot codes as "0", each nonzero one as "1" + its 15-bit two's
// complement; an MB row is one MSB-first bit string starting on a word
// boundary; a value outside -16384..16383 sets the overflow flag.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/level_pack.py:131
// pack_levels (its body _pack :83, on the ops/bitmerge.py trees).  The
// header and payload prefix equal the reference's word for word.
//
// What bounds it: bytes.  It reads the level tensors once (20.9 MB of
// intra levels, 12.5 MB of P levels at 1080p) and writes ~1 bit per zero
// slot.  No merge trees: (1) a warp per MB sums its slots' code lengths
// and checks the value range; (2) one thread per row scans its MBs' bit
// counts, one thread the rows' word counts, and writes the header; (3) a
// warp per MB takes its slots 32 at a time, scans their lengths across
// the warp, ORs each code into the MB's words in shared memory, and
// writes them out (atomic OR on the two words shared with the
// neighbouring MBs).
#include "transport.cuh"

namespace {

constexpr int MAX_KEYS = 7;
constexpr int WARPS = 8;

struct Keys {
  const int* p[MAX_KEYS];
  int n[MAX_KEYS];
  int s;  // slots per MB
};

// Slot k of MB mb in wire order.
__device__ __forceinline__ int slot(const Keys& K, int mb, int k) {
  int base = 0;
#pragma unroll
  for (int j = 0; j < MAX_KEYS; ++j) {
    if (k < base + K.n[j]) return K.p[j][(size_t)mb * K.n[j] + (k - base)];
    base += K.n[j];
  }
  return 0;
}

__global__ void __launch_bounds__(32 * WARPS) count_kernel(Keys K, int nmb, int* mb_bits,
                                                           int* flag) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (mb >= nmb) return;
  int bits = 0;
  bool ovf = false;
  for (int k = lane; k < K.s; k += 32) {
    const int v = slot(K, mb, k);
    bits += v ? 16 : 1;
    ovf |= v > 16383 || v < -16384;
  }
  for (int o = 16; o; o >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, o);
  if (__any_sync(0xffffffffu, ovf) && lane == 0) atomicOr(flag, 1);
  if (lane == 0) mb_bits[mb] = bits;
}

__global__ void __launch_bounds__(32 * WARPS) write_kernel(Keys K, int nr, int nc,
                                                           const int* mb_bits,
                                                           const int* mb_off,
                                                           const int* row_woff,
                                                           unsigned* out) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mb = blockIdx.x * WARPS + warp;
  const int cap = K.s / 2 + 2;  // words of the longest MB, unaligned
  unsigned* buf = smem + warp * cap;
  if (mb >= nr * nc) return;
  const long long base = transport::mb_bit_base(mb_off, row_woff, mb, mb / nc, nr);
  const int lead = (int)(base & 31);
  const int nwords = (lead + mb_bits[mb] + 31) >> 5;
  for (int i = lane; i < nwords; i += 32) buf[i] = 0u;
  __syncwarp();
  int run = lead;  // bit position of the chunk's first code in buf
  for (int k0 = 0; k0 < K.s; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < K.s ? slot(K, mb, k) : 0;
    const int len = k < K.s ? (v ? 16 : 1) : 0;
    int incl = len;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned code = v ? (0x8000u | ((unsigned)v & 0x7FFFu)) : 0u;
    if (code) transport::or_bits(buf, run + incl - len, code, len);
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  transport::store_words(out, base, buf, nwords, lane, 32);
}

}  // namespace

// p0..p6: the level tensors in wire order (null past the last key), n0..n6
// their slots per MB.  scratch: 2 * nr * nc + nr + 1 ints.
extern "C" int level_pack_launch(const int* p0, const int* p1, const int* p2, const int* p3,
                                 const int* p4, const int* p5, const int* p6, unsigned* out,
                                 int* scratch, int nr, int nc, int n0, int n1, int n2, int n3,
                                 int n4, int n5, int n6, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  Keys K{{p0, p1, p2, p3, p4, p5, p6}, {n0, n1, n2, n3, n4, n5, n6}, 0};
  for (int j = 0; j < MAX_KEYS; ++j) K.s += K.n[j];
  const int nmb = nr * nc;
  int* mb_bits = scratch;
  int* mb_off = mb_bits + nmb;
  int* row_woff = mb_off + nmb;
  int* flag = row_woff + nr;
  int e;
  if ((e = cudaMemsetAsync(flag, 0, sizeof(int), stream))) return e;
  const size_t payload = (size_t)nmb * (K.s / 2);
  if ((e = cudaMemsetAsync(out + transport::META_WORDS + nr, 0, payload * 4, stream)))
    return e;
  const int grid = (nmb + WARPS - 1) / WARPS;
  count_kernel<<<grid, 32 * WARPS, 0, stream>>>(K, nmb, mb_bits, flag);
  if ((e = dngd_last_error())) return e;
  transport::row_scan_kernel<<<1, 1024, 0, stream>>>(mb_bits, mb_off, row_woff, flag, out, nr,
                                                     nc, 1, K.s);
  if ((e = dngd_last_error())) return e;
  const size_t smem = (size_t)WARPS * (K.s / 2 + 2) * sizeof(unsigned);
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)))
    return e;
  write_kernel<<<grid, 32 * WARPS, smem, stream>>>(K, nr, nc, mb_bits, mb_off, row_woff, out);
  return dngd_last_error();
}
