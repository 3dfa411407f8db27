// Shared pieces of the port's CUDA kernels: the C error-string export
// every library carries, and the H.264 integer transform / quant helpers.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* dngd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Launch check: a refused launch never runs and synchronize() would not
// report it, so every entry point returns this to the Python wrapper.
static inline int dngd_last_error() {
  return static_cast<int>(cudaGetLastError());
}

// luma4x4BlkIdx -> (bx, by), spec 6.4.3; zigzag scan of a 4x4 block.
__constant__ int c_blk_x[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int c_blk_y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int c_zz[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

// QPc of a slice qp (Table 8-15, chroma_qp_index_offset 0), for the
// kernels that read their qp from device memory (a captured graph's qp
// changes between replays without a new capture).
__constant__ int c_qpc_high[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                                   36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
__device__ __forceinline__ int dngd_chroma_qp(int qp) {
  qp = min(max(qp, 0), 51);
  return qp < 30 ? qp : c_qpc_high[qp - 30];
}
