// Host-side decoder for the device level-pack transport
// (ops/level_pack.py): per-MB-row bitstreams of
//   zero coefficient  -> 1 bit  "0"
//   nonzero           -> "1" + 15-bit two's-complement value
// MSB-first within uint32 words (the ops/bitmerge word convention).
// Rows are independent word-aligned streams, decoded in parallel.
//
// A copy of docker_nvidia_glx_desktop_tpu/native/levelpack.cpp for the
// PyTorch/CUDA port (built by native/lib.py into the package's build/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void decode_row(const uint32_t* words, int64_t nwords,
                       int32_t* out, int64_t slots) {
  // 64-bit bit window refilled per slot: a slot consumes at most 16
  // bits, so one refill check per slot suffices.
  uint64_t acc = 0;
  int have = 0;          // valid bits in acc (top-aligned)
  int64_t w = 0;
  for (int64_t s = 0; s < slots; ++s) {
    if (have < 16) {
      while (have <= 32 && w < nwords) {
        acc |= (uint64_t)words[w++] << (32 - have);
        have += 32;
      }
      if (have <= 0) {   // stream exhausted: remaining slots are zero
        std::memset(out + s, 0, (slots - s) * sizeof(int32_t));
        return;
      }
    }
    if (acc >> 63) {     // nonzero flag
      uint32_t raw = (uint32_t)((acc << 1) >> 49);   // next 15 bits
      int32_t v = (int32_t)raw - ((raw >> 14) << 15);
      out[s] = v;
      acc <<= 16;
      have -= 16;
    } else {
      out[s] = 0;
      acc <<= 1;
      have -= 1;
    }
  }
}

}  // namespace

extern "C" {

int32_t tpudesktop_levelpack_abi_version() { return 1; }

// payload: concatenated word-aligned row streams; row_off: (rows+1,)
// word offsets; out: (rows * slots_per_row,) int32.
void level_unpack_rows(const uint32_t* payload, const int64_t* row_off,
                       int64_t rows, int64_t slots_per_row,
                       int32_t* out) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  int64_t nthreads = std::min<int64_t>(rows, std::min<unsigned>(hw, 16));
  if (nthreads <= 1) {
    for (int64_t r = 0; r < rows; ++r)
      decode_row(payload + row_off[r], row_off[r + 1] - row_off[r],
                 out + r * slots_per_row, slots_per_row);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int64_t t = 0; t < nthreads; ++t) {
    ts.emplace_back([=] {
      for (int64_t r = t; r < rows; r += nthreads)
        decode_row(payload + row_off[r], row_off[r + 1] - row_off[r],
                   out + r * slots_per_row, slots_per_row);
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
