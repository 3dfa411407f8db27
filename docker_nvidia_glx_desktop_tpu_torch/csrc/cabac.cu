// K11i / K11p — CABAC binarization and context-index derivation: a frame's
// levels (and modes or motion vectors) -> the version-2 transport of
// (bin, ctxIdx, bypass) records, per-row bit counts in the header.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/cabac_binarize.py:490
// binarize_intra and :415 binarize_p (their _pack_stream :368 on the
// ops/bitmerge.py trees).  Header and payload prefix equal the
// reference's word for word; the overflow flag trips where it does (a
// level or mvd beyond its bypass budget, an MB above the static cap of
// ``cap`` words).
//
// What bounds it: bytes in principle (the levels are read once: ~21 MB
// intra, ~13 MB P at 1080p), but this first version is bound by its
// serial walk.  Design: under slice-per-MB-row each MB's records depend
// only on its own levels and its left MB's inputs, so (1) one thread per
// MB walks the syntax (csrc/cabac_records.cuh) and writes its records as
// a bit string into its own ``cap``-word slot of the scratch buffer,
// counting its bits; (2) one thread per row scans the MB bit counts, one
// thread the rows, and writes the header (transport.cuh); (3) a warp per
// MB shifts its bit string into place in the row payload.  The walk
// reads each MB's levels about three times (its own summary, its
// residuals, its right neighbour's summary), uncoalesced: one thread per
// MB keeps it simple, not fast.
#include "cabac_records.cuh"
#include "transport.cuh"

namespace {

constexpr int WALK_THREADS = 64;
constexpr int WARPS = 8;

struct Scratch {
  uint32_t* mb_words;  // [nmb * cap]
  int* mb_bits;        // [nmb]
  int* mb_off;         // [nmb]
  int* row_woff;       // [nr]
  int* flag;           // [1]: bit 0 value overflow, bit 1 an MB above its cap
  Scratch(int* s, int nmb, int nr, int cap)
      : mb_words(reinterpret_cast<uint32_t*>(s)), mb_bits(s + (size_t)nmb * cap),
        mb_off(mb_bits + nmb), row_woff(mb_off + nmb), flag(row_woff + nr) {}
};

__device__ __forceinline__ bool walk(const cabac_rec::PIn& in, int r, int c,
                                     cabac_rec::WordSink& sink) {
  return cabac_rec::p_mb(in, r, c, sink);
}

__device__ __forceinline__ bool walk(const cabac_rec::IIn& in, int r, int c,
                                     cabac_rec::WordSink& sink) {
  return cabac_rec::intra_mb(in, r, c, sink);
}

template <class In>
__global__ void __launch_bounds__(WALK_THREADS) records_kernel(In in, int nr, int cap, Scratch S) {
  const int mb = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (mb >= nr * in.nc) return;
  cabac_rec::WordSink sink(S.mb_words + (size_t)mb * cap, cap);
  const bool ovf = walk(in, mb / in.nc, mb % in.nc, sink);
  sink.flush();
  S.mb_bits[mb] = (int)sink.n;
  const int f = (ovf ? 1 : 0) | (sink.n > 32LL * cap ? 2 : 0);
  if (f) atomicOr(S.flag, f);
}

// Warp per MB: the MB's bit string, from bit 0 of its scratch slot, is
// shifted to its bit offset in the transport.  Skipped when an MB ran
// over its cap (the offsets could then pass the buffer; the flag sends
// the caller to the dense path).
__global__ void __launch_bounds__(32 * WARPS) place_kernel(int nr, int nc, int cap, Scratch S,
                                                           unsigned* out) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (mb >= nr * nc || (*S.flag & 2)) return;
  const long long base = transport::mb_bit_base(S.mb_off, S.row_woff, mb, mb / nc, nr);
  const int lead = (int)(base & 31), bits = S.mb_bits[mb];
  const int nsrc = (bits + 31) >> 5, nwords = (lead + bits + 31) >> 5;
  const uint32_t* src = S.mb_words + (size_t)mb * cap;
  const long long w0 = base >> 5;
  for (int i = lane; i < nwords; i += 32) {
    const uint32_t lo = i < nsrc ? src[i] : 0u;
    const uint32_t hi = (i > 0 && i - 1 < nsrc) ? src[i - 1] : 0u;
    const uint32_t w = lead ? (hi << (32 - lead)) | (lo >> lead) : lo;
    if (i == 0 || i == nwords - 1)
      atomicOr(out + w0 + i, w);
    else
      out[w0 + i] = w;
  }
}

template <class In>
int run(const In& in, unsigned* out, int* scratch, int nr, int nc, int slots, int cap,
        cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  const int nmb = nr * nc;
  Scratch S(scratch, nmb, nr, cap);
  int e;
  if ((e = cudaMemsetAsync(S.flag, 0, sizeof(int), stream))) return e;
  if ((e = cudaMemsetAsync(out + transport::META_WORDS + nr, 0, (size_t)nmb * cap * 4, stream)))
    return e;
  records_kernel<In><<<(nmb + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0, stream>>>(
      in, nr, cap, S);
  if ((e = dngd_last_error())) return e;
  transport::row_scan_kernel<<<1, 1024, 0, stream>>>(S.mb_bits, S.mb_off, S.row_woff, S.flag,
                                                     out, nr, nc, 2, slots);
  if ((e = dngd_last_error())) return e;
  place_kernel<<<(nmb + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(nr, nc, cap, S, out);
  return dngd_last_error();
}

}  // namespace

// slots: the header's record-slot count; cap: words per MB (static
// bound).  scratch: nr * nc * cap + 2 * nr * nc + nr + 1 ints.
extern "C" int binarize_p_launch(const int* mv, const int* luma, const int* cb_dc,
                                 const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                 unsigned* out, int* scratch, int nr, int nc, int slots, int cap,
                                 cudaStream_t stream) {
  const cabac_rec::PIn in{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, nc};
  return run(in, out, scratch, nr, nc, slots, cap, stream);
}

extern "C" int binarize_intra_launch(const int* luma_dc, const int* luma_ac, const int* cb_dc,
                                     const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                     const int* pred_mode, const uint8_t* mb_i4,
                                     const int* i4_modes, const int* luma_i4, unsigned* out,
                                     int* scratch, int nr, int nc, int slots, int cap,
                                     cudaStream_t stream) {
  const cabac_rec::IIn in{luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                          mb_i4,   i4_modes, luma_i4, nc};
  return run(in, out, scratch, nr, nc, slots, cap, stream);
}
