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
// output tensors are gated in place.  What bounds it: bytes (at 1080p
// with every other row gated, 9.4 MB written and read: 0.0028 ms).
//
// Design (redesigned for Hopper): one launch over a grid of (chunk, MB
// row).  The launcher cuts each present tensor's row into chunks of at
// most SKIP_CHUNK 16-byte words (a table in the launch's parameters), so
// a CTA moves a part of one tensor's row: no per-word search for the
// tensor, no shared memory and no barrier.  A CTA reads keep[row] first
// and a kept row's CTAs return at once (loading a recon chunk's reference
// words while keep is read was slower at 4K: the kept rows' loads cost
// more than the latency they hid).  A zero word is one 16-byte store with
// no load, a recon word one
// 16-byte load and store, SKIP_U words a thread at once.  A row that does
// not start on a 16-byte boundary (mb_intra's nc bytes, mv's 8 nc where nc
// is odd, any tensor off 16 bytes) stores its head and tail by 8-byte
// halves or bytes (rowcopy.cuh).  With keep all true the launch writes
// nothing.
#include "common.cuh"
#include "rowcopy.cuh"

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
constexpr int SKIP_NT = 256;
constexpr int SKIP_U = 2;             // words a thread moves at once
constexpr int SKIP_CHUNK = SKIP_NT * SKIP_U;   // words a CTA moves in one step
constexpr int MAX_CHUNKS = 160;       // a row's chunks, over all its tensors

// one present tensor: bytes a MB row; rows where keep is false take src's
// bytes, or zeros without a src
struct Gate {
  uint8_t* dst;
  const uint8_t* src;
  int bytes, aligned;
};
// a chunk: words [s0, s1) of one tensor's row
struct Chunk {
  int t, s0, s1;
};
struct Gates {
  Gate g[JOBS];
  Chunk c[MAX_CHUNKS];
};

__global__ void __launch_bounds__(SKIP_NT) force_skip_kernel(Gates gs,
                                                              const uint8_t* __restrict__ keep) {
  const Chunk c = gs.c[blockIdx.x];
  const Gate G = gs.g[c.t];
  if (keep[blockIdx.y]) return;       // a kept row: nothing to write
  const unsigned off = blockIdx.y * (unsigned)G.bytes;
  const uint8_t* src = G.src ? G.src + off : nullptr;
  for (int s = c.s0 + (int)threadIdx.x; s < c.s1; s += SKIP_CHUNK) {
    SpanWord w[SKIP_U];
    uint4 v[SKIP_U];
#pragma unroll
    for (int k = 0; k < SKIP_U; ++k) {
      const int sk = s + k * SKIP_NT;
      if (sk < c.s1) {
        w[k] = G.aligned ? aligned_word(G.dst, G.src, off + 16u * sk)
                         : span_word(G.dst + off, G.bytes, src, sk);
        v[k] = w[k].whole ? span_load(w[k]) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < SKIP_U; ++k)
      if (s + k * SKIP_NT < c.s1) span_store(w[k], v[k]);
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
// take where keep (nr bytes) is 0; any tensor at any byte offset.
extern "C" int force_skip_launch(int* mv, int* luma, int* cb_dc, int* cb_ac, int* cr_dc,
                                 int* cr_ac, uint8_t* mb_intra, int* i16_dc, int* i16_ac,
                                 uint8_t* recon_y, uint8_t* recon_cb, uint8_t* recon_cr,
                                 const uint8_t* ref_y, const uint8_t* ref_cb,
                                 const uint8_t* ref_cr, const uint8_t* keep, int nr, int nc,
                                 cudaStream_t stream) {
  if (nr <= 0 || nr > 65535 || nc <= 0) return cudaErrorInvalidValue;
  const struct {
    void* dst;
    const uint8_t* src;
    int bytes;
  } all[JOBS] = {{mv, nullptr, nc * 2 * 4},          {luma, nullptr, nc * 256 * 4},
                 {cb_dc, nullptr, nc * 4 * 4},       {cb_ac, nullptr, nc * 60 * 4},
                 {cr_dc, nullptr, nc * 4 * 4},       {cr_ac, nullptr, nc * 60 * 4},
                 {mb_intra, nullptr, nc},            {i16_dc, nullptr, nc * 16 * 4},
                 {i16_ac, nullptr, nc * 240 * 4},    {recon_y, ref_y, nc * 16 * 16},
                 {recon_cb, ref_cb, nc * 8 * 8},     {recon_cr, ref_cr, nc * 8 * 8}};
  // a chunk at most SKIP_CHUNK words, or as many as keep a row's chunks
  // within MAX_CHUNKS (a multiple of SKIP_CHUNK: a thread then loops)
  long long per_row = 0;
  for (const auto& j : all)
    if (j.dst) per_row += span_slots(j.dst, j.bytes);
  const long long cw = SKIP_CHUNK * ((per_row + (long long)SKIP_CHUNK * (MAX_CHUNKS - JOBS) - 1) /
                                     ((long long)SKIP_CHUNK * (MAX_CHUNKS - JOBS)));
  Gates gs = {};
  int n = 0, nch = 0;
  for (const auto& j : all) {
    if (!j.dst) continue;
    if ((long long)nr * j.bytes >= (1LL << 31)) return cudaErrorInvalidValue;
    const int slots = span_slots(j.dst, j.bytes);
    gs.g[n] = {static_cast<uint8_t*>(j.dst), j.src, j.bytes, spans_aligned(j.dst, j.src, j.bytes)};
    for (long long s0 = 0; s0 < slots; s0 += cw)
      gs.c[nch++] = {n, (int)s0, (int)(s0 + cw < slots ? s0 + cw : slots)};
    ++n;
  }
  if (!nch) return cudaErrorInvalidValue;
  const dim3 grid(nch, nr);
  force_skip_kernel<<<grid, SKIP_NT, 0, stream>>>(gs, keep);
  return dngd_last_error();
}
