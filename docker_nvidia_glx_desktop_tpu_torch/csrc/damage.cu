// K13 — the reference-row scatter of damage-driven encode: the next
// reference planes from the old ones, with the MB rows of a damage
// worklist replaced by the compacted (deblocked) recon rows.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/damage_mask.py:228-235
// (row_core's `.at[rows].set` of the three planes).  The output is new
// planes: the old reference stays as it was, so a pipelined submit never
// reads a plane while it is written.
//
// What bounds it: bytes.  At 1080p it reads 3.1 MB (a row comes from
// the old reference or from the recon stack, never both) and writes
// 3.1 MB, ~1.9 us at 3.35 TB/s.  One thread per output 32-bit word of
// the three planes; each block first inverts the worklist (frame row ->
// stack row) in shared memory.  Padded duplicates of a row carry equal
// recon rows, so whichever of them the inversion keeps is right.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_ROWS = 1024;

__device__ __forceinline__ void copy_word(const uint32_t* ref, const uint32_t* rec,
                                          uint32_t* out, const int* inv, size_t w,
                                          int words_per_line, int lines_per_row) {
  const int line = (int)(w / words_per_line), x = (int)(w % words_per_line);
  const int i = inv[line / lines_per_row];
  out[w] = i < 0 ? ref[w]
                 : rec[((size_t)i * lines_per_row + line % lines_per_row) * words_per_line + x];
}

__global__ void __launch_bounds__(NT) scatter_rows_kernel(
    const uint32_t* __restrict__ ref_y, const uint32_t* __restrict__ ref_cb,
    const uint32_t* __restrict__ ref_cr, const uint32_t* __restrict__ rec_y,
    const uint32_t* __restrict__ rec_cb, const uint32_t* __restrict__ rec_cr,
    const int* __restrict__ rows, uint32_t* out_y, uint32_t* out_cb, uint32_t* out_cr, int nr,
    int nb, int wy, int wc) {
  __shared__ int inv[MAX_ROWS];
  for (int r = threadIdx.x; r < nr; r += NT) inv[r] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += NT)
    if (rows[i] >= 0 && rows[i] < nr) inv[rows[i]] = i;
  __syncthreads();
  const size_t ny = (size_t)nr * 16 * wy, nc = (size_t)nr * 8 * wc;
  const size_t w = (size_t)blockIdx.x * NT + threadIdx.x;
  if (w < ny) {
    copy_word(ref_y, rec_y, out_y, inv, w, wy, 16);
  } else if (w < ny + nc) {
    copy_word(ref_cb, rec_cb, out_cb, inv, w - ny, wc, 8);
  } else if (w < ny + 2 * nc) {
    copy_word(ref_cr, rec_cr, out_cr, inv, w - ny - nc, wc, 8);
  }
}

}  // namespace

// planes of nr MB rows, W luma bytes a line (a multiple of 8); rows: nb
// frame rows in 0..nr-1, the recon planes (16 nb, W) and (8 nb, W/2).
extern "C" int scatter_rows_launch(const uint32_t* ref_y, const uint32_t* ref_cb,
                                   const uint32_t* ref_cr, const uint32_t* rec_y,
                                   const uint32_t* rec_cb, const uint32_t* rec_cr,
                                   const int* rows, uint32_t* out_y, uint32_t* out_cb,
                                   uint32_t* out_cr, int nr, int nb, int W,
                                   cudaStream_t stream) {
  if (nr <= 0 || nr > MAX_ROWS || nb <= 0 || W <= 0 || W % 8) return cudaErrorInvalidValue;
  const int wy = W / 4, wc = W / 8;
  const size_t words = (size_t)nr * 16 * wy + 2 * (size_t)nr * 8 * wc;
  scatter_rows_kernel<<<(unsigned)((words + NT - 1) / NT), NT, 0, stream>>>(
      ref_y, ref_cb, ref_cr, rec_y, rec_cb, rec_cr, rows, out_y, out_cb, out_cr, nr, nb, wy, wc);
  return dngd_last_error();
}
