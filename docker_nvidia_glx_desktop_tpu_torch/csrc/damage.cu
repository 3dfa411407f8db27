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
// 3.1 MB, ~1.9 us at 3.35 TB/s.
//
// Design (redesigned for Hopper): one launch whose units are the output
// lines of the frame (luma, then Cb, then Cr) and then the lines of the
// recon stack; a CTA eight consecutive units, a warp one, its lanes
// every 32nd 16-byte word, LINE_U at once.  A stack line is stored at its
// row's place, the worklist entry read while its words load.  A frame
// line loads the reference's words, then asks whether its MB row is in
// the worklist (a ballot over the entries, the first 32 held in
// registers from the kernel's start) and stores them only where it is
// not.  So no line waits on the worklist before its loads, and no CTA
// inverts the worklist or passes a barrier.  Padded duplicates of a row
// carry equal recon rows, so their stack lines store equal bytes.  A
// chroma line of W/2 bytes that is no multiple of 16 (W = 16 odd) starts
// or ends in an 8-byte half, and planes at any byte offset move their
// unaligned words by halves or bytes (rowcopy.cuh).
#include "common.cuh"
#include "rowcopy.cuh"

namespace {

constexpr int SCATTER_NT = 256;
constexpr int LINE_U = 4;          // words a lane moves at once in a line

// one output plane: lines of `bytes` bytes, MB rows of 1 << shift lines
struct Plane {
  uint8_t* out;
  const uint8_t* ref;
  const uint8_t* rec;
  int bytes, slots, shift, aligned;
};
struct Planes {
  Plane p[3];
};

__device__ __forceinline__ Plane plane_of(const Planes& pl, int p) {
  return p == 0 ? pl.p[0] : (p == 1 ? pl.p[1] : pl.p[2]);
}

// the warp's copy of one line: dst's words from src, LINE_U a lane at
// once.  A stack line (stack = true) stores where ok, its words loaded
// while ok (its worklist entry) is read; a frame line stores only where
// its MB row m is in no worklist entry (a ballot over the entries, the
// first 32 held in rv), its words loaded while that is found.
__device__ __forceinline__ void copy_line(const Plane& P, uint8_t* dst, const uint8_t* src,
                                          bool stack, bool ok, int m, int rv,
                                          const int* __restrict__ rows, int nb, int lane) {
  for (int s0 = 0; s0 < P.slots; s0 += 32 * LINE_U) {   // warp-uniform: the ballot
    SpanWord w[LINE_U];
    uint4 v[LINE_U];
#pragma unroll
    for (int k = 0; k < LINE_U; ++k) {
      const int s = s0 + lane + 32 * k;
      if (s < P.slots) {
        w[k] = P.aligned ? aligned_word(dst, src, 16u * s) : span_word(dst, P.bytes, src, s);
        v[k] = w[k].whole ? span_load(w[k]) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (stack && !ok) return;           // an entry outside the frame
    if (!stack && s0 == 0) {            // a damaged row's lines come from the stack
      bool hit = __ballot_sync(~0u, rv == m) != 0;
      for (int i = 32 + lane; !hit && i - lane < nb; i += 32)
        hit = __ballot_sync(~0u, i < nb && __ldg(rows + i) == m) != 0;
      if (hit) return;
    }
#pragma unroll
    for (int k = 0; k < LINE_U; ++k)
      if (s0 + lane + 32 * k < P.slots) span_store(w[k], v[k]);
  }
}

// units: the frame's 32 nr lines, then the stack's 32 nb
__global__ void __launch_bounds__(SCATTER_NT) scatter_rows_kernel(
    Planes pl, const int* __restrict__ rows, int nr, int nb, int units) {
  const int lane = threadIdx.x & 31;
  const int rv = lane < nb ? __ldg(rows + lane) : -1;   // the worklist's first 32 entries
  const int u = blockIdx.x * (SCATTER_NT / 32) + (threadIdx.x >> 5);
  if (u < units) {
    const bool stack = u >= 32 * nr;
    const int n = stack ? nb : nr, g = stack ? u - 32 * nr : u;
    const int p = g < 16 * n ? 0 : (g < 24 * n ? 1 : 2);
    const int l = g - (p == 0 ? 0 : (p == 1 ? 16 * n : 24 * n));   // line of the plane
    const Plane P = plane_of(pl, p);
    const int m = l >> P.shift;                                       // its MB row
    if (stack) {
      const int r = __ldg(rows + m);     // the frame row, read while the words load
      const bool ok = r >= 0 && r < nr;
      copy_line(P, P.out + (unsigned)(((ok ? r : 0) << P.shift) + (l & ((1 << P.shift) - 1))) *
                               (unsigned)P.bytes,
                P.rec + (unsigned)l * (unsigned)P.bytes, true, ok, m, rv, rows, nb, lane);
    } else {
      const unsigned off = (unsigned)l * (unsigned)P.bytes;
      copy_line(P, P.out + off, P.ref + off, false, true, m, rv, rows, nb, lane);
    }
  }
}

}  // namespace

// planes of nr MB rows, W luma bytes a line (a multiple of 8); rows: nb
// frame rows in 0..nr-1, the recon planes (16 nb, W) and (8 nb, W/2);
// every plane at any byte offset.
extern "C" int scatter_rows_launch(const uint8_t* ref_y, const uint8_t* ref_cb,
                                   const uint8_t* ref_cr, const uint8_t* rec_y,
                                   const uint8_t* rec_cb, const uint8_t* rec_cr,
                                   const int* rows, uint8_t* out_y, uint8_t* out_cb,
                                   uint8_t* out_cr, int nr, int nb, int W,
                                   cudaStream_t stream) {
  if (nr <= 0 || nb <= 0 || W <= 0 || W % 8) return cudaErrorInvalidValue;
  if ((long long)nr * 16 * W >= (1LL << 31)) return cudaErrorInvalidValue;
  auto aligned = [](const void* o, const void* a, const void* b, int n) {
    return (int)(spans_aligned(o, a, n) && spans_aligned(o, b, n));
  };
  const Planes pl = {{{out_y, ref_y, rec_y, W, span_slots(out_y, W), 4,
                       aligned(out_y, ref_y, rec_y, W)},
                      {out_cb, ref_cb, rec_cb, W / 2, span_slots(out_cb, W / 2), 3,
                       aligned(out_cb, ref_cb, rec_cb, W / 2)},
                      {out_cr, ref_cr, rec_cr, W / 2, span_slots(out_cr, W / 2), 3,
                       aligned(out_cr, ref_cr, rec_cr, W / 2)}}};
  const int units = 32 * (nr + nb);
  scatter_rows_kernel<<<(units + SCATTER_NT / 32 - 1) / (SCATTER_NT / 32), SCATTER_NT, 0,
                        stream>>>(pl, rows, nr, nb, units);
  return dngd_last_error();
}
