// Shared pieces of the CABAC transports (K10 level pack, K11 record
// streams): the per-row scan that places each MB's bit string in its row
// and each row on a word boundary, and the transport header.
//
// Header (uint32 words): [0] version  [1] overflow flag  [2] total payload
// words  [3] rows  [4] slots per MB  [5..7] 0, then per row its payload
// word count (version 1) or bit count (version 2), then the payloads.
#pragma once
#include "common.cuh"

namespace transport {

constexpr int META_WORDS = 8;

// One block: thread r scans row r's MB bit counts into MB bit offsets;
// thread 0 then scans the rows' word counts and writes the header.
// flag[0] holds the overflow flag set by the counting pass.
__global__ void row_scan_kernel(const int* __restrict__ mb_bits, int* __restrict__ mb_off,
                                int* __restrict__ row_woff, const int* __restrict__ flag,
                                unsigned* __restrict__ out, int nr, int nc, int version,
                                int slots) {
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    long long acc = 0;
    for (int c = 0; c < nc; ++c) {
      mb_off[r * nc + c] = (int)acc;
      acc += mb_bits[r * nc + c];
    }
    const unsigned words = (unsigned)((acc + 31) >> 5);
    row_woff[r] = (int)words;  // the row's word count, offsets below
    out[META_WORDS + r] = version == 1 ? words : (unsigned)acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int r = 0; r < nr; ++r) {
      const unsigned w = (unsigned)row_woff[r];
      row_woff[r] = (int)total;
      total += w;
    }
    out[0] = (unsigned)version;
    out[1] = flag[0] ? 1u : 0u;
    out[2] = total;
    out[3] = (unsigned)nr;
    out[4] = (unsigned)slots;
    out[5] = out[6] = out[7] = 0u;
  }
}

// OR a code of ``len`` <= 32 bits into MSB-first words at bit ``pos``
// (shared or global memory; the words start zeroed).
__device__ __forceinline__ void or_bits(unsigned* words, long long pos, unsigned code,
                                        int len) {
  if (len <= 0) return;
  if (len < 32) code &= (1u << len) - 1u;
  const long long w = pos >> 5;
  const int end = (int)(pos & 31) + len;
  if (end <= 32) {
    atomicOr(words + w, code << (32 - end));
  } else {
    atomicOr(words + w, code >> (end - 32));
    atomicOr(words + w + 1, code << (64 - end));
  }
}

// Global bit position of MB ``mb`` (row r) in the transport buffer.
__device__ __forceinline__ long long mb_bit_base(const int* mb_off, const int* row_woff,
                                                 int mb, int r, int nr) {
  return 32LL * (META_WORDS + nr + row_woff[r]) + mb_off[mb];
}

// Copy ``nwords`` words of an MB's bits, laid out from bit ``base & 31``
// of ``src[0]``, to the global word grid: the first and last words are
// shared with the neighbouring MBs (atomic OR), the others are the MB's.
__device__ __forceinline__ void store_words(unsigned* out, long long base, const unsigned* src,
                                            int nwords, int lane, int nlanes) {
  const long long w0 = base >> 5;
  for (int i = lane; i < nwords; i += nlanes) {
    if (i == 0 || i == nwords - 1)
      atomicOr(out + w0 + i, src[i]);
    else
      out[w0 + i] = src[i];
  }
}

}  // namespace transport
