// Shared pieces of the CABAC transports (K10 level pack, csrc/levelpack.cu;
// K11i / K11p record streams, csrc/cabac.cu): the look-back state behind a
// transport and where a segment of a row's MBs places its bits.
//
// Header (uint32 words): [0] version  [1] overflow flag  [2] total payload
// words  [3] rows  [4] slots per MB  [5..7] 0, then per row its payload
// word count (version 1) or bit count (version 2), then the payloads, each
// row from a word boundary.  The words past the payload are left as they
// were (the header and the payload are all a consumer reads).
#pragma once
#include "lookback.cuh"

namespace transport {

constexpr int META_WORDS = 8;

// The look-back state, behind the transport in the one buffer a wrapper
// allocates: a ticket and the flags (int32), then, 8-byte aligned, the
// rows' published word counts and a status word a segment ([nr][nseg]).
struct State {
  int* istate;                   // [0] ticket, [1] flags
  unsigned long long* row_pub;   // the rows' words, published (INCL)
  unsigned long long* st;        // a status word a segment
};

// int32 offset of the status words behind ``out_words`` words.
inline size_t status_offset(size_t out_words) { return (out_words + 3) & ~static_cast<size_t>(1); }

// int32 words of a buffer: the transport, then the state.
inline long long buffer_words(long long out_words, int nr, int nseg) {
  return static_cast<long long>(status_offset(static_cast<size_t>(out_words)) +
                                2 * static_cast<size_t>(nr) * (1 + static_cast<size_t>(nseg)));
}

// The state behind ``out_words`` words of ``buf``; *bytes: what one memset
// zeroes.  Returns a CUDA error where the state is misaligned.
inline int state_at(int* buf, long long out_words, int nr, int nseg, State* S, size_t* bytes) {
  S->istate = buf + out_words;
  S->row_pub = reinterpret_cast<unsigned long long*>(buf + status_offset(out_words));
  S->st = S->row_pub + nr;
  if (reinterpret_cast<uintptr_t>(S->row_pub) & 7) return cudaErrorMisalignedAddress;
  *bytes = 4 * (status_offset(out_words) - static_cast<size_t>(out_words)) +
           8 * (static_cast<size_t>(nr) + static_cast<size_t>(nr) * nseg);
  return 0;
}

// Where a segment's bits go: the bits before it in its row, the words of
// the earlier rows, and its own bits.
struct Place {
  long long excl, row_words;
  int seg_bits;
};

// Called by warp 0 of the CTA of segment ``s`` (of ``nseg``) of row ``r``
// (of ``nr``), lane l holding MB l's bits ``b`` (0 past the segment's MBs,
// at most 32 MBs) and every lane the segment's ``flags``.  Writes lane l's
// bit offset in the segment to ``off[l]`` where ``has_mb``; ORs the flags
// into the state; publishes the segment's bits (AGG) and looks back over
// the row's earlier segments (INCL); the row's last segment writes its
// row's count (``version`` 1: words, 2: bits) and publishes its row's
// words before it waits on any other row; the last row's last segment
// writes the header once every row is published.
__device__ __forceinline__ Place place_segment(const State& S, unsigned* out, int r, int s,
                                               int nseg, int nr, int version, int slots, int b,
                                               bool has_mb, int* off, int flags) {
  using namespace lookback;
  const int lane = threadIdx.x & 31;
  int x = b;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (has_mb) off[lane] = x - b;
  const int seg_bits = __shfl_sync(FULL, x, 31);
  if (lane == 0 && flags) atomicOr(S.istate + 1, flags);
  unsigned long long* st = S.st + static_cast<size_t>(r) * nseg;
  long long excl = 0;
  if (s == 0) {
    if (lane == 0) publish(st, seg_bits, INCL);
  } else {
    if (lane == 0) publish(st + s, seg_bits, AGG);
    excl = look_back(st, s);
    if (lane == 0) publish(st + s, excl + seg_bits, INCL);
  }
  const bool last = s == nseg - 1;
  const long long row_bits = excl + seg_bits;
  const long long row_words = (row_bits + 31) >> 5;
  if (last && lane == 0) {
    out[META_WORDS + r] = static_cast<unsigned>(version == 1 ? row_words : row_bits);
    publish(S.row_pub + r, row_words, INCL);
  }
  long long w = 0;
  for (int q = lane; q < r; q += 32) w += wait_for(S.row_pub + q, INCL) >> 2;
  w = warp_sum(w);
  __syncwarp();
  if (lane == 0 && last && r == nr - 1) {
    const int f = atomicOr(S.istate + 1, 0);
    out[0] = static_cast<unsigned>(version);
    out[1] = f ? 1u : 0u;
    out[2] = static_cast<unsigned>(w + row_words);
    out[3] = static_cast<unsigned>(nr);
    out[4] = static_cast<unsigned>(slots);
    out[5] = out[6] = out[7] = 0u;
  }
  return Place{excl, w, seg_bits};
}

}  // namespace transport
