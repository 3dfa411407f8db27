// Bit sinks of the segment packers K11p (cabac.cu, through
// cabac_records.cuh) and K16c (jpeg.cu): a stream of MSB-first codes
// counted, or written into a window of 32-bit words (shared memory on
// the card).  Host and device code: the CPU tests compile it with g++.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define CR_HD __host__ __device__ __forceinline__
#else
#define CR_HD inline
#endif

// Counts the bits of a record stream.
struct CountSink {
  long long n = 0;
  CR_HD void put(uint32_t, int len) {
    if (len > 0) n += len;
  }
};

// Writes a record stream, MSB-first from bit ``pos`` of a window of
// ``nwin`` zeroed words (shared memory on the card), 32 bits at a time
// from an accumulator: a word that lies inside the stream by a plain
// store, its first word (when it starts inside a word) and its last one,
// which it shares with the neighbouring streams, by OR.  Words outside
// the window are dropped; ``flush`` writes the last bits.
struct RunSink {
  uint32_t* w;
  int nwin;
  long long widx, first;   // the word the accumulator fills; the first word
  unsigned long long acc;  // the pending bits, ``have`` (< 32) of them
  int have;
  bool lead;               // the first word holds earlier bits
  CR_HD RunSink(uint32_t* win, long long pos, int n)
      : w(win), nwin(n), widx(pos >> 5), first(pos >> 5), acc(0), have((int)(pos & 31)),
        lead((pos & 31) != 0) {}
  CR_HD void store(uint32_t x, bool shared) {
    if (widx < 0 || widx >= nwin) return;
#ifdef __CUDA_ARCH__
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(w + widx));
    if (shared)
      asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
    else
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
#else
    if (shared)
      w[widx] |= x;
    else
      w[widx] = x;
#endif
  }
  CR_HD void put(uint32_t v, int len) {
    if (len <= 0) return;
    if (len < 32) v &= (1u << len) - 1u;
    acc = (acc << len) | v;
    have += len;
    if (have >= 32) {
      have -= 32;
      store((uint32_t)(acc >> have), lead && widx == first);
      ++widx;
      acc &= (1ull << have) - 1ull;
    }
  }
  CR_HD void put64(uint64_t v, int len) {  // len <= 64
    if (len > 32) {
      put((uint32_t)(v >> 32), len - 32);
      len = 32;
    }
    put((uint32_t)v, len);
  }
  CR_HD void flush() {
    if (have > 0) store((uint32_t)(acc << (32 - have)), true);
  }
};
