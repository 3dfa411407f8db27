// Host-side entropy helpers of the PyTorch/CUDA port, copied from
// docker_nvidia_glx_desktop_tpu/native/entropy.cpp:
//   jpeg_component_histogram  : per-component DC/AC symbol histograms
//   jpeg_encode_scan          : interleaved 4:2:0 MCU scan emission (the
//                               MJPEG encoder's entropy="native" coder)
//   h264_emulation_prevention : Annex-B EPB escaping (bitstream/h264.
//                               nal_unit takes it for RBSPs above 4 KiB)
// The bytes equal the pure-Python coders' (bitstream/jpeg_huffman.py,
// bitstream/h264.py).

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// MSB-first bit writer with optional JPEG 0xFF00 byte stuffing.
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;        // bytes written
  uint64_t acc = 0;       // bit accumulator
  int nbits = 0;          // bits in accumulator
  bool jpeg_stuffing;
  bool overflow = false;

  BitWriter(uint8_t* out_, int64_t cap_, bool stuff)
      : out(out_), cap(cap_), jpeg_stuffing(stuff) {}

  inline void put_byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
    if (jpeg_stuffing && b == 0xFF) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = 0x00;
    }
  }

  inline void write(uint32_t value, int n) {
    if (n == 0) return;
    acc = (acc << n) | (value & ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte((uint8_t)((acc >> nbits) & 0xFF));
    }
    acc &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
  }

  inline void pad_to_byte(int pad_bit) {
    if (nbits % 8) {
      int n = 8 - nbits % 8;
      write(pad_bit ? ((1u << n) - 1) : 0, n);
    }
  }
};

inline int size_category(int32_t v) {
  uint32_t av = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
  return av == 0 ? 0 : 32 - __builtin_clz(av);
}

// Huffman table on the wire for the C side: codes + lengths per symbol.
struct HuffTable {
  const uint32_t* codes;
  const uint8_t* lens;
};

// Encode one zigzagged 64-coeff block.  Returns new DC predictor.
inline int32_t encode_block(BitWriter& bw, const int32_t* zz, int32_t prev_dc,
                            const HuffTable& dc, const HuffTable& ac) {
  int32_t diff = zz[0] - prev_dc;
  int s = size_category(diff);
  uint32_t amp = diff >= 0 ? (uint32_t)diff : (uint32_t)(diff + (1 << s) - 1);
  bw.write(dc.codes[s], dc.lens[s]);
  bw.write(amp, s);

  int run = 0;
  int last_nz = 0;
  for (int k = 63; k >= 1; --k) {
    if (zz[k] != 0) { last_nz = k; break; }
  }
  for (int k = 1; k <= last_nz; ++k) {
    int32_t v = zz[k];
    if (v == 0) { ++run; continue; }
    while (run >= 16) {
      bw.write(ac.codes[0xF0], ac.lens[0xF0]);
      run -= 16;
    }
    int sz = size_category(v);
    uint32_t a = v >= 0 ? (uint32_t)v : (uint32_t)(v + (1 << sz) - 1);
    bw.write(ac.codes[(run << 4) | sz], ac.lens[(run << 4) | sz]);
    bw.write(a, sz);
    run = 0;
  }
  if (last_nz < 63) bw.write(ac.codes[0x00], ac.lens[0x00]);
  return zz[0];
}

}  // namespace

extern "C" {

// Histogram DC-size and AC run/size symbols for one component.
// blocks: (nblk, 64) int32 zigzagged; dc_hist: int64[17]; ac_hist: int64[256].
void jpeg_component_histogram(const int32_t* blocks, int64_t nblk,
                              int64_t* dc_hist, int64_t* ac_hist) {
  int32_t prev_dc = 0;
  for (int64_t b = 0; b < nblk; ++b) {
    const int32_t* zz = blocks + b * 64;
    dc_hist[size_category(zz[0] - prev_dc)]++;
    prev_dc = zz[0];
    int last_nz = 0;
    for (int k = 63; k >= 1; --k) {
      if (zz[k] != 0) { last_nz = k; break; }
    }
    int run = 0;
    for (int k = 1; k <= last_nz; ++k) {
      if (zz[k] == 0) { ++run; continue; }
      while (run >= 16) { ac_hist[0xF0]++; run -= 16; }
      ac_hist[(run << 4) | size_category(zz[k])]++;
      run = 0;
    }
    if (last_nz < 63) ac_hist[0x00]++;
  }
}

// Emit the interleaved 4:2:0 scan: per MCU 4 luma blocks then Cb then Cr.
//   y:  (nmcu*4, 64)   cb, cr: (nmcu, 64)
//   *_codes: uint32[256], *_lens: uint8[256] (DC tables use entries 0..16)
// Returns bytes written, or -1 on output overflow.
int64_t jpeg_encode_scan(const int32_t* y, const int32_t* cb, const int32_t* cr,
                         int64_t nmcu,
                         const uint32_t* dc_codes_l, const uint8_t* dc_lens_l,
                         const uint32_t* ac_codes_l, const uint8_t* ac_lens_l,
                         const uint32_t* dc_codes_c, const uint8_t* dc_lens_c,
                         const uint32_t* ac_codes_c, const uint8_t* ac_lens_c,
                         uint8_t* out, int64_t out_cap) {
  BitWriter bw(out, out_cap, /*stuff=*/true);
  HuffTable dcl{dc_codes_l, dc_lens_l}, acl{ac_codes_l, ac_lens_l};
  HuffTable dcc{dc_codes_c, dc_lens_c}, acc{ac_codes_c, ac_lens_c};
  int32_t prev_y = 0, prev_cb = 0, prev_cr = 0;
  for (int64_t m = 0; m < nmcu; ++m) {
    for (int s = 0; s < 4; ++s)
      prev_y = encode_block(bw, y + (m * 4 + s) * 64, prev_y, dcl, acl);
    prev_cb = encode_block(bw, cb + m * 64, prev_cb, dcc, acc);
    prev_cr = encode_block(bw, cr + m * 64, prev_cr, dcc, acc);
  }
  bw.pad_to_byte(1);
  if (bw.overflow) return -1;
  return bw.pos;
}

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
int32_t tpudesktop_entropy_abi_version() { return 2; }

}  // extern "C"
