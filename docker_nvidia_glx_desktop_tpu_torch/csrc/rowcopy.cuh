// Spans of bytes stored as 16-byte words, shared by the forced-skip row
// gate (13s, spatial.cu) and the reference-row scatter (K13, damage.cu).
//
// A span is a run of output bytes [lo, lo + bytes) (an MB row of one
// tensor, a line of one plane) whose bytes come from a source at the same
// offsets, or are zero where the source is null.  Its words are the
// 16-byte aligned words that overlap it; slot s is the s-th of them from
// the one that holds lo.  A word wholly inside its span whose source is
// 16-byte aligned too moves as one 16-byte load and store (no load for
// zeros).  Any other word (the head or tail of a span off 16-byte
// boundaries, a source at another alignment) moves by 8-byte halves where
// both ends allow it, else byte by byte, and touches only its span's
// bytes: two spans may share a word.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// The slots a span of `bytes` bytes needs: the spans of a tensor or plane
// start at base + k * bytes, so at a multiple of al, the largest power of
// two (at most 16) that divides both; a span that starts 16 - al bytes
// into a word covers (bytes + 16 - al) / 16 words, rounded up.
static inline int span_slots(const void* base, int bytes) {
  const uint64_t x = (uint64_t)(uintptr_t)base | (uint64_t)(unsigned)bytes | 16u;
  const int al = (int)(x & (~x + 1));
  return (bytes + 31 - al) / 16;
}

struct SpanWord {
  uint8_t* a;          // the word (16-byte aligned)
  const uint8_t* s;    // the source of the word's byte 0 (null: zeros)
  int lo, hi;          // the span's bytes of the word: [lo, hi) of 0..16
  bool whole;          // one 16-byte move
};

// slot `slot` of the span at lo of `bytes` bytes, its bytes from src
__device__ __forceinline__ SpanWord span_word(uint8_t* lo, int bytes, const uint8_t* src,
                                              int slot) {
  const intptr_t l = reinterpret_cast<intptr_t>(lo);
  const intptr_t a = (l & ~intptr_t(15)) + 16 * slot, h = l + bytes;
  SpanWord w;
  w.a = reinterpret_cast<uint8_t*>(a);
  w.s = src ? src + (a - l) : nullptr;
  w.lo = a < l ? (int)(l - a) : 0;
  w.hi = h >= a + 16 ? 16 : (h > a ? (int)(h - a) : 0);
  w.whole = w.lo == 0 && w.hi == 16 && !(reinterpret_cast<uintptr_t>(w.s) & 15);
  return w;
}

// a word of a span whose tensor, source and span length are all 16-byte
// aligned: whole, at byte offset off of both
__device__ __forceinline__ SpanWord aligned_word(uint8_t* dst, const uint8_t* src, unsigned off) {
  SpanWord w;
  w.a = dst + off;
  w.s = src ? src + off : nullptr;
  w.lo = 0;
  w.hi = 16;
  w.whole = true;
  return w;
}

// whether base, src (if any) and bytes are all multiples of 16: then
// every word of every span is whole
static inline bool spans_aligned(const void* base, const void* src, int bytes) {
  return !(((uintptr_t)base | (uintptr_t)src | (uintptr_t)bytes) & 15);
}

// a whole word's value (zero without a source)
__device__ __forceinline__ uint4 span_load(const SpanWord& w) {
  return w.s ? __ldg(reinterpret_cast<const uint4*>(w.s)) : make_uint4(0u, 0u, 0u, 0u);
}

// stores the word: v where it is whole, else its span's bytes from the source
__device__ __forceinline__ void span_store(const SpanWord& w, uint4 v) {
  if (w.whole) {
    *reinterpret_cast<uint4*>(w.a) = v;
    return;
  }
#pragma unroll
  for (int h = 0; h < 16; h += 8) {
    if (w.lo <= h && w.hi >= h + 8 && !(reinterpret_cast<uintptr_t>(w.s) & 7)) {
      *reinterpret_cast<uint2*>(w.a + h) =
          w.s ? *reinterpret_cast<const uint2*>(w.s + h) : make_uint2(0u, 0u);
    } else {
      for (int j = h; j < h + 8; ++j)
        if (j >= w.lo && j < w.hi) w.a[j] = w.s ? w.s[j] : 0;
    }
  }
}
