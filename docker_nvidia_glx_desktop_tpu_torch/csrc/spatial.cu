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
// numbers.  What bounds it: bytes (~6.5 MB at 1080p, nx = 2: 0.0019 ms).
//
// Design (redesigned for Hopper): one launch over all three planes, flat
// over their 16-byte output words (plane p's words follow plane p-1's, so
// no thread idles but in the last block).  A thread writes one aligned
// 16-byte word; the padded rows (W + 26 bytes) start anywhere in a word,
// so a word spans at most two rows.  A word inside one row whose columns
// are all inside the frame copies 16 contiguous source bytes: five
// aligned 32-bit loads joined by funnel shifts.  Every other word (the
// side columns, a row's seam) gathers its bytes one by one, each from the
// aligned 32-bit word that holds it, with the row and column clamped.  The
// last word of a plane whose size is no multiple of 16 stores only its
// bytes.  Sources may start at any byte (a view): loads stay aligned.
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

// one plane of the pad: its source (h, w) and its (nx, hl + 2 PAD, w +
// 2 PAD) output, whose 16-byte words are the launch's words first ..
struct PadPlane {
  const uint8_t* src;
  uint8_t* dst;
  int h, w, hl, ph, pw, bytes, first;
};
struct PadPlanes {
  PadPlane p[3];
};

// the byte at any address, from the aligned 32-bit word that holds it
__device__ __forceinline__ uint32_t byte_at(const uint8_t* a) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(a);
  return (*reinterpret_cast<const uint32_t*>(u & ~uintptr_t(3)) >> (8 * (u & 3))) & 255u;
}

__global__ void __launch_bounds__(NT) halo_pad_kernel(PadPlanes pp, int nwords, int halo) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= nwords) return;
  const PadPlane P = g >= pp.p[2].first ? pp.p[2] : (g >= pp.p[1].first ? pp.p[1] : pp.p[0]);
  const int b0 = (g - P.first) * 16, per = P.ph * P.pw;
  int s = b0 / per, u = (b0 - s * per) / P.pw, v = b0 - s * per - u * P.pw;
  const int n = min(16, P.bytes - b0);
  // the frame row of padded row u of shard s
  auto src_row = [&](int s, int u) {
    const int lo = halo ? 0 : s * P.hl, hi = halo ? P.h - 1 : s * P.hl + P.hl - 1;
    return P.src + (size_t)min(max(s * P.hl - PAD + u, lo), hi) * P.w;
  };
  uint32_t o[4];
  if (n == 16 && v >= PAD && v + 16 <= PAD + P.w) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src_row(s, u) + v - PAD);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const int sh = 8 * (a & 3);
    const uint32_t w0 = q[0], w1 = q[1], w2 = q[2], w3 = q[3], w4 = sh ? q[4] : 0u;
    o[0] = __funnelshift_r(w0, w1, sh);
    o[1] = __funnelshift_r(w1, w2, sh);
    o[2] = __funnelshift_r(w2, w3, sh);
    o[3] = __funnelshift_r(w3, w4, sh);
  } else {
    o[0] = o[1] = o[2] = o[3] = 0u;
    const uint8_t* row = src_row(s, u);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < n) {
        o[j >> 2] |= byte_at(row + min(max(v - PAD, 0), P.w - 1)) << (8 * (j & 3));
        if (++v == P.pw) {                       // the word runs into the next row
          v = 0;
          if (++u == P.ph) u = 0, ++s;
          row = src_row(s, u);
        }
      }
    }
  }
  uint8_t* d = P.dst + b0;
  if (n == 16) {
    *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {                                       // a plane's last word
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < n) d[j] = (uint8_t)(o[j >> 2] >> (8 * (j & 3)));
  }
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

// ref planes (H, W) and (H/2, W/2), at any byte offset; pad planes (nx,
// H/nx + 26, W + 26) and (nx, H/(2 nx) + 26, W/2 + 26), each 16-byte
// aligned (else cudaErrorMisalignedAddress).  halo: 1 neighbour rows at
// the seams, 0 edge copies there.
extern "C" int halo_pad_launch(const uint8_t* ref_y, const uint8_t* ref_cb, const uint8_t* ref_cr,
                               uint8_t* pad_y, uint8_t* pad_cb, uint8_t* pad_cr, int H, int W,
                               int nx, int halo, cudaStream_t stream) {
  if (H <= 0 || W <= 0 || nx <= 0 || H % (16 * nx) || W % 16) return cudaErrorInvalidValue;
  const uint8_t* src[3] = {ref_y, ref_cb, ref_cr};
  uint8_t* dst[3] = {pad_y, pad_cb, pad_cr};
  PadPlanes pp;
  long long words = 0;
  for (int p = 0; p < 3; ++p) {
    if (reinterpret_cast<uintptr_t>(dst[p]) & 15) return cudaErrorMisalignedAddress;
    const int h = p ? H / 2 : H, w = p ? W / 2 : W, hl = h / nx;
    const long long bytes = (long long)nx * (hl + 2 * PAD) * (w + 2 * PAD);
    if (bytes + words * 16 >= (1LL << 31)) return cudaErrorInvalidValue;
    pp.p[p] = {src[p], dst[p], h, w, hl, hl + 2 * PAD, w + 2 * PAD, (int)bytes, (int)words};
    words += (bytes + 15) / 16;
  }
  halo_pad_kernel<<<(int)((words + NT - 1) / NT), NT, 0, stream>>>(pp, (int)words, halo);
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
