// Single-session spatial shards on one card: the reference halo pad (15e)
// and the forced-skip row gate of the masked shard step (13s).
//
// 15e replaces docker_nvidia_glx_desktop_tpu/parallel/batch.py:609
// _spatial_halo_pad.  There each of nx devices holds 1/nx of the frame's MB
// rows and pads its reference planes by _PAD = 13 pels: at an interior seam
// the neighbour's 13 rows arrive over ppermute, at the frame's top and
// bottom and at the sides the edge is replicated; halo=False (the
// measurement twin) replicates at every seam.  Here the whole reference
// plane is on the card, so each shard's padded plane is a clamped copy:
// padded row u of shard s is frame row s*h_l - 13 + u, clamped to the
// frame (halo) or to the shard's own rows (halo=False), and column v is
// frame column v - 13 clamped to the frame.  Storage is uint8: every value
// is a copied sample, so the reference's int32 planes hold the same
// numbers.  What bounds it: bytes.  A block writes one padded row (its
// source row worked out once; the threads stride its columns), blockIdx.y
// the shard, blockIdx.z the plane.
//
// 13s replaces docker_nvidia_glx_desktop_tpu/ops/damage_mask.py:312
// force_skip_rows.  Where keep[r] is false, every MB of row r becomes
// P_Skip before entropy: its MV and levels (and the I16-in-P outputs)
// are zeroed and its recon rows are the reference's.  The P core's
// output tensors are gated in place: a block takes one MB row of one
// tensor (blockIdx.x the row, blockIdx.y the tensor) and returns at once
// where the row is kept; its threads stride the row's elements (32-bit
// words of a recon plane).  Bytes bound it too.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int PAD = 13;   // ops/h264_inter.py _PAD = SEARCH_R + 5

__global__ void __launch_bounds__(NT) halo_pad_kernel(
    const uint8_t* __restrict__ ref_y, const uint8_t* __restrict__ ref_cb,
    const uint8_t* __restrict__ ref_cr, uint8_t* pad_y, uint8_t* pad_cb, uint8_t* pad_cr,
    int H, int W, int nx, int halo) {
  const int p = blockIdx.z, s = blockIdx.y, u = blockIdx.x;
  const int h = p ? H / 2 : H, w = p ? W / 2 : W;
  const int hl = h / nx, ph = hl + 2 * PAD, pw = w + 2 * PAD;
  if (u >= ph) return;
  const int lo = halo ? 0 : s * hl, hi = halo ? h - 1 : s * hl + hl - 1;
  const uint8_t* src = (p == 0 ? ref_y : (p == 1 ? ref_cb : ref_cr)) +
                       (size_t)min(max(s * hl - PAD + u, lo), hi) * w;
  uint8_t* dst = (p == 0 ? pad_y : (p == 1 ? pad_cb : pad_cr)) + ((size_t)s * ph + u) * pw;
  for (int v = threadIdx.x; v < pw; v += NT) dst[v] = src[min(max(v - PAD, 0), w - 1)];
}

constexpr int JOBS = 12;

// one gated tensor: per_row elements of `bytes` (1 or 4) per MB row; rows
// where keep is false take src's elements, or zero without a src
struct Job {
  void* dst;
  const void* src;
  int per_row, bytes;
};
struct Jobs {
  Job j[JOBS];
};

__global__ void __launch_bounds__(NT) force_skip_kernel(Jobs jobs,
                                                         const uint8_t* __restrict__ keep) {
  const Job jb = jobs.j[blockIdx.y];
  if (!jb.dst || keep[blockIdx.x]) return;
  const size_t base = (size_t)blockIdx.x * jb.per_row;
  for (int i = threadIdx.x; i < jb.per_row; i += NT) {
    if (jb.bytes == 4)
      static_cast<int*>(jb.dst)[base + i] =
          jb.src ? static_cast<const int*>(jb.src)[base + i] : 0;
    else
      static_cast<uint8_t*>(jb.dst)[base + i] =
          jb.src ? static_cast<const uint8_t*>(jb.src)[base + i] : 0;
  }
}

}  // namespace

// ref planes (H, W) and (H/2, W/2); pad planes (nx, H/nx + 26, W + 26) and
// (nx, H/(2 nx) + 26, W/2 + 26).  halo: 1 neighbour rows at the seams, 0
// edge copies there.
extern "C" int halo_pad_launch(const uint8_t* ref_y, const uint8_t* ref_cb, const uint8_t* ref_cr,
                               uint8_t* pad_y, uint8_t* pad_cb, uint8_t* pad_cr, int H, int W,
                               int nx, int halo, cudaStream_t stream) {
  if (H <= 0 || W <= 0 || nx <= 0 || H % (16 * nx) || W % 16) return cudaErrorInvalidValue;
  halo_pad_kernel<<<dim3(H / nx + 2 * PAD, nx, 3), NT, 0, stream>>>(
      ref_y, ref_cb, ref_cr, pad_y, pad_cb, pad_cr, H, W, nx, halo);
  return dngd_last_error();
}

// The P core's outputs of nr MB rows of nc MBs (mb_intra, i16_dc, i16_ac
// null without I16-in-P), its recon planes and the reference planes they
// take where keep (nr bytes) is 0.
extern "C" int force_skip_launch(int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                 int* cr_ac, uint8_t* mb_intra, int* i16_dc, int* i16_ac,
                                 uint8_t* recon_y, uint8_t* recon_cb, uint8_t* recon_cr,
                                 const uint8_t* ref_y, const uint8_t* ref_cb,
                                 const uint8_t* ref_cr, const uint8_t* keep, int nr, int nc,
                                 cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return cudaErrorInvalidValue;
  const int wy = nc * 16 * 16 / 4, wc = nc * 8 * 8 / 4;   // recon words per MB row
  const Jobs jobs = {{{mv, nullptr, nc * 2, 4},
                      {luma, nullptr, nc * 256, 4},
                      {cb_dc, nullptr, nc * 4, 4},
                      {cb_ac, nullptr, nc * 60, 4},
                      {cr_dc, nullptr, nc * 4, 4},
                      {cr_ac, nullptr, nc * 60, 4},
                      {mb_intra, nullptr, nc, 1},
                      {i16_dc, nullptr, nc * 16, 4},
                      {i16_ac, nullptr, nc * 240, 4},
                      {recon_y, ref_y, wy, 4},
                      {recon_cb, ref_cb, wc, 4},
                      {recon_cr, ref_cr, wc, 4}}};
  force_skip_kernel<<<dim3(nr, JOBS), NT, 0, stream>>>(jobs, keep);
  return dngd_last_error();
}
