// Shared pieces of the segment bit packers K16c (jpeg.cu), K11p
// (cabac.cu) and K3/K7 (pack.cu, which uses the staging and the byte swap
// only): staging a span of ints into shared memory by cp.async, the
// decoupled look-back over the segments of one row or strip, and the
// store of a segment's words with its edge words (SegmentStore).
//
// A segment publishes one 64-bit status word, value << 2 | state:
//   AGG   its own bits, as soon as it has counted them;
//   INCL  the bits up to its end (its inclusive prefix), once it has
//         looked back over its predecessors;
//   DONE  the same value, once its last word is stored.
// A segment looks back over 32 predecessors at a time: the nearest INCL
// (or DONE) ends the walk, AGG values in front of it are added.  Each
// segment reads its index from an atomic ticket, so every segment it waits
// on has started, and every segment publishes AGG without waiting: the
// walk cannot deadlock.  The word a segment shares with its predecessor
// is ORed only after the predecessor is DONE (it has stored that word with
// a plain store), so no buffer needs zeroing.
#pragma once
#include "common.cuh"

namespace lookback {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGG = 1, INCL = 2, DONE = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  for (int i = 0; i < 4; ++i) static_cast<int*>(dst)[i] = static_cast<const int*>(src)[i];
#endif
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *static_cast<int*>(dst) = *static_cast<const int*>(src);
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// n ints of global src into shared dst (16-byte aligned, room for n + 3
// ints), by the block's nt threads: staged at the same offset within 16
// bytes as src, so that all but a ragged head and tail move as 16-byte
// copies.  Returns element 0.  The caller waits (cp_async_wait) and syncs.
__device__ __forceinline__ int* stage(int* dst, const int* src, int n, int nt) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  int* d = dst + lead;
  const int head = min(n, (4 - lead) & 3);
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += nt) cp_async4(d + i, src + i);
  for (int i = threadIdx.x; i < body; i += nt) cp_async16(d + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < n; i += nt) cp_async4(d + i, src + i);
  return d;
}

// Release and acquire at gpu scope: what a thread wrote before it
// publishes is seen by a thread that has read the published value.
__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long x) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
#else
  __threadfence();
  atomicExch(p, x);
#endif
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
#if defined(__CUDA_ARCH__)
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  const unsigned long long v = *reinterpret_cast<const volatile unsigned long long*>(p);
  __threadfence();
  return v;
#endif
}

__device__ __forceinline__ void publish(unsigned long long* p, long long v,
                                        unsigned long long state) {
  store_release(p, (static_cast<unsigned long long>(v) << 2) | state);
}

// The status word once it has reached ``state``; a wait that outlasts any
// possible launch traps instead of hanging the card.
__device__ __forceinline__ unsigned long long wait_for(const unsigned long long* p,
                                                       unsigned long long state) {
  unsigned spins = 0;
  unsigned long long v;
  while (((v = load_acquire(p)) & 3) < state) {
    __nanosleep(64);
    if (++spins > (1u << 24)) __trap();
  }
  return v;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Called by a whole warp: the bits before segment ``i`` of the run whose
// status words start at ``st`` (segment 0 starts at bit 0).
__device__ __forceinline__ long long look_back(const unsigned long long* st, int i) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int j = i - 1; j >= 0; j -= 32) {
    const int q = j - lane;
    const unsigned long long x = q >= 0 ? wait_for(st + q, AGG) : INCL;
    const unsigned incl = __ballot_sync(FULL, (x & 3) >= INCL);
    long long v = static_cast<long long>(x >> 2);
    if (incl) {
      if (lane > __ffs(incl) - 1) v = 0;
      excl += warp_sum(v);
      break;
    }
    excl += warp_sum(v);
  }
  __syncwarp();    // what the lanes acquired, before lane 0 publishes
  return excl;
}

__device__ __forceinline__ unsigned bswap(unsigned x) { return __byte_perm(x, 0, 0x0123); }

// Word transforms for SegmentStore: the words as written, or byte-swapped
// (big-endian bytes; a swap commutes with OR).
struct Plain {
  __device__ __forceinline__ unsigned operator()(unsigned x) const { return x; }
};
struct Bswap {
  __device__ __forceinline__ unsigned operator()(unsigned x) const { return bswap(x); }
};

// The words of one segment, bits [excl, excl + seg_bits) of a run whose
// words start at ``base`` (``cap`` of them; words past it are dropped),
// stored window by window from shared memory, each word through ``Xf``.
// The order of the two edge words, which the segment shares with its
// neighbours, needs no zeroed buffer: thread 0 plain-stores the last word
// (zeros past the bits) before the segment is DONE, and ORs into the
// first word, when it holds earlier bits, only after the predecessor is
// DONE.
template <class Xf>
struct SegmentStore {
  unsigned* dst;          // the segment's first word
  long long limit;        // words from dst to the end of the run
  int lead, nwords;       // the first bit within dst[0]; the words touched
  bool shared_first;      // dst[0] holds earlier bits
  unsigned first_val = 0;

  __device__ __forceinline__ SegmentStore(unsigned* base, long long cap, long long excl,
                                          int seg_bits)
      : dst(base + (excl >> 5)), limit(cap - (excl >> 5)), lead(static_cast<int>(excl & 31)),
        nwords(seg_bits > 0 ? (static_cast<int>(excl & 31) + seg_bits + 31) >> 5 : 0),
        shared_first((excl & 31) != 0) {}

  // Words lo .. lo + nwin of the segment from ``win``, by the block's nt
  // threads; the caller syncs before the window is reused.
  __device__ __forceinline__ void store(const unsigned* win, int lo, int nwin, int nt) {
    const Xf xf;
    for (int i = threadIdx.x; i < nwin; i += nt) {
      const int k = lo + i;
      if ((k == 0 && shared_first) || k == nwords - 1 || k >= limit) continue;
      dst[k] = xf(win[i]);
    }
    if (threadIdx.x == 0) {
      if (lo == 0) first_val = xf(win[0]);
      const int k = nwords - 1;
      if (k >= lo && k < lo + nwin && !(k == 0 && shared_first) && k < limit)
        dst[k] = xf(win[k - lo]);
    }
  }

  // Thread 0, after the last window: publishes the segment (status word
  // st[s], ``incl`` bits to its end) DONE, and ORs its first word.
  __device__ __forceinline__ void finish(unsigned long long* st, int s, long long incl) {
    const bool or_first = shared_first && nwords > 0 && limit > 0;
    if (nwords == 0 || (or_first && nwords == 1)) {
      if (s > 0) wait_for(st + s - 1, DONE);
      if (or_first) atomicOr(dst, first_val);
      publish(st + s, incl, DONE);
    } else {
      publish(st + s, incl, DONE);
      if (or_first) {
        wait_for(st + s - 1, DONE);
        atomicOr(dst, first_val);
      }
    }
  }
};

}  // namespace lookback
