// Host-side H.264 emulation prevention for the PyTorch/CUDA port: the
// EPB function of docker_nvidia_glx_desktop_tpu/native/entropy.cpp,
// copied (bitstream/h264.nal_unit takes it for RBSPs above 4 KiB; the
// bytes equal the pure-Python escaper's).

#include <cstdint>

extern "C" {

// H.264 emulation prevention (spec §7.4.1.1): insert 0x03 after any
// 0x00 0x00 followed by a byte <= 0x03.  Worst case out = in * 3/2.
// Returns bytes written, or -1 if out_cap too small.
int64_t h264_emulation_prevention(const uint8_t* in, int64_t n,
                                  uint8_t* out, int64_t out_cap) {
  int64_t pos = 0;
  int zeros = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t b = in[i];
    if (zeros >= 2 && b <= 3) {
      if (pos >= out_cap) return -1;
      out[pos++] = 3;
      zeros = 0;
    }
    if (pos >= out_cap) return -1;
    out[pos++] = b;
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return pos;
}

// Simple ABI sanity probe used by the loader.
int32_t tpudesktop_entropy_abi_version() { return 1; }

}  // extern "C"
