// H.264 CAVLC slice entropy coder on the host, the PyTorch/CUDA port's
// copy of docker_nvidia_glx_desktop_tpu/native/cavlc.cpp (the encoder's
// entropy="native" IDR route: I_16x16 DC pictures at the slice qp, no
// deblocking).  Mirrors bitstream/h264_entropy.py + bitstream/cavlc.py
// byte for byte; each macroblock row is an independent slice, so slices
// are coded on a thread pool and concatenated in order.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" int64_t h264_emulation_prevention(const uint8_t* in, int64_t n,
                                             uint8_t* out, int64_t out_cap);

namespace {

// --- VLC tables (spec Tables 9-5..9-10); identical to bitstream/cavlc.py ---

const uint8_t kCtLen[3][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6,
     11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10,
     14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14,
     16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4,
     8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9,
     12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13,
     13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4,
     7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6,
     9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10},
};
const uint8_t kCtBits[3][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3,
     7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4,
     11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12,
     11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4,
     4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4,
     11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12,
     7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12,
     15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8,
     15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2},
};
const uint8_t kCtLenCdc[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6,
                               3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kCtBitsCdc[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6,
                                1, 0, 3, 3, 2, 5, 2, 3, 2, 0};

const uint8_t kTzLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0},
    {6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0},
    {6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0},
    {5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};
const uint8_t kTzBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};
const uint8_t kTzLenCdc[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t kTzBitsCdc[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
const uint8_t kRbLen[7][15] = {
    {1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3},
    {2, 3, 3, 3, 3, 3, 3},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
const uint8_t kRbBits[7][15] = {
    {1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0},
    {3, 0, 1, 3, 2, 5, 4},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

// luma4x4BlkIdx -> (bx, by)
const int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

struct Bits {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int n = 0;

  inline void put(uint32_t v, int len) {
    acc = (acc << len) | (uint64_t)v;
    n += len;
    while (n >= 8) {
      n -= 8;
      buf.push_back((uint8_t)(acc >> n));
    }
    acc &= (1ull << n) - 1;
  }
  inline void ue(uint32_t v) {
    uint32_t code = v + 1;
    int nbits = 32 - __builtin_clz(code);
    put(0, nbits - 1);
    put(code, nbits);
  }
  inline void se(int32_t v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
  inline void trailing() {
    put(1, 1);
    if (n) put(0, 8 - n);
  }
};

inline void write_level(Bits& bw, int code, int suffix_len) {
  int extra;
  if (suffix_len == 0) {
    if (code < 14) {
      bw.put(1, code + 1);
      return;
    }
    if (code < 30) {
      bw.put(1, 15);
      bw.put(code - 14, 4);
      return;
    }
    extra = 15;  // levelCode += 15 when level_prefix >= 15 and sl == 0
  } else {
    int prefix = code >> suffix_len;
    if (prefix < 15) {
      bw.put(1, prefix + 1);
      bw.put(code & ((1 << suffix_len) - 1), suffix_len);
      return;
    }
    extra = 0;
  }
  if (code < (15 << suffix_len) + extra + 4096) {
    bw.put(1, 16);
    bw.put(code - (15 << suffix_len) - extra, 12);
    return;
  }
  // level_prefix >= 16 extension: suffix is p-3 bits,
  // levelCode += (1 << (p-3)) - 4096
  for (int p = 16;; p++) {
    int base = (15 << suffix_len) + extra + (1 << (p - 3)) - 4096;
    if (code < base + (1 << (p - 3))) {
      bw.put(1, p + 1);
      bw.put((uint32_t)(code - base), p - 3);
      return;
    }
  }
}

// Returns TotalCoeff.  levels: scan-order, length max_coeff.  nc: -1 chroma DC.
int encode_block(Bits& bw, const int32_t* levels, int nc, int max_coeff) {
  int idx[16], val[16], total = 0;
  for (int i = 0; i < max_coeff; i++) {
    if (levels[i]) {
      idx[total] = i;
      val[total] = levels[i];
      total++;
    }
  }
  int t1 = 0;
  while (t1 < 3 && t1 < total && (val[total - 1 - t1] == 1 || val[total - 1 - t1] == -1))
    t1++;

  int ln, bits;
  if (nc == -1) {
    ln = kCtLenCdc[4 * total + t1];
    bits = kCtBitsCdc[4 * total + t1];
  } else if (nc >= 8) {
    ln = 6;
    bits = total == 0 ? 3 : (((total - 1) << 2) | t1);
  } else {
    int cls = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
    ln = kCtLen[cls][4 * total + t1];
    bits = kCtBits[cls][4 * total + t1];
  }
  bw.put(bits, ln);
  if (total == 0) return 0;

  for (int k = 0; k < t1; k++) bw.put(val[total - 1 - k] < 0 ? 1 : 0, 1);

  int suffix_len = (total > 10 && t1 < 3) ? 1 : 0;
  bool first = true;
  for (int k = total - 1 - t1; k >= 0; k--) {
    int level = val[k];
    int code = level > 0 ? 2 * level - 2 : -2 * level - 1;
    if (first && t1 < 3) code -= 2;
    first = false;
    write_level(bw, code, suffix_len);
    if (suffix_len == 0) suffix_len = 1;
    int a = level < 0 ? -level : level;
    if (a > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
  }

  int tz = idx[total - 1] + 1 - total;
  if (total < max_coeff) {
    if (nc == -1)
      bw.put(kTzBitsCdc[total - 1][tz], kTzLenCdc[total - 1][tz]);
    else
      bw.put(kTzBits[total - 1][tz], kTzLen[total - 1][tz]);
  }
  int zeros_left = tz;
  for (int k = total - 1; k > 0 && zeros_left > 0; k--) {
    int run = idx[k] - idx[k - 1] - 1;
    int row = (zeros_left < 7 ? zeros_left : 7) - 1;
    bw.put(kRbBits[row][run], kRbLen[row][run]);
    zeros_left -= run;
  }
  return total;
}

inline int nc_ctx(int na, int nb, bool a_ok, bool b_ok) {
  if (a_ok && b_ok) return (na + nb + 1) >> 1;
  if (a_ok) return na;
  if (b_ok) return nb;
  return 0;
}

struct PictureArgs {
  const int32_t *luma_dc, *luma_ac, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  int64_t rows, cols;
  int32_t frame_num, idr_pic_id;
};

// Entropy-code one MB-row slice into an RBSP (no NAL wrapping).
void encode_slice(const PictureArgs& a, int64_t my, std::vector<uint8_t>& out) {
  Bits bw;
  const int64_t C = a.cols;
  // slice header (mirrors bitstream/h264.py slice_header): I slice type 7,
  // IDR, POC type 2, 4-bit frame_num, deblocking disabled.
  bw.ue((uint32_t)(my * C));       // first_mb_in_slice
  bw.ue(7);                        // slice_type
  bw.ue(0);                        // pic_parameter_set_id
  bw.put(a.frame_num & 0xF, 4);    // frame_num
  bw.ue(a.idr_pic_id);             // idr_pic_id
  bw.put(0, 1);                    // no_output_of_prior_pics_flag
  bw.put(0, 1);                    // long_term_reference_flag
  bw.se(0);                        // slice_qp_delta
  bw.ue(1);                        // disable_deblocking_filter_idc

  // per-row tc state: [by][bx] luma, [by][bx] chroma x2
  std::vector<int32_t> tcl(C * 16), tcb(C * 4), tcr(C * 4);

  for (int64_t mx = 0; mx < C; mx++) {
    const int32_t* ldc = a.luma_dc + (my * C + mx) * 16;
    const int32_t* lac = a.luma_ac + (my * C + mx) * 16 * 15;
    const int32_t* bdc = a.cb_dc + (my * C + mx) * 4;
    const int32_t* bac = a.cb_ac + (my * C + mx) * 4 * 15;
    const int32_t* rdc = a.cr_dc + (my * C + mx) * 4;
    const int32_t* rac = a.cr_ac + (my * C + mx) * 4 * 15;

    bool cl = false;
    for (int i = 0; i < 16 * 15 && !cl; i++) cl = lac[i] != 0;
    bool c_ac = false, c_dc = false;
    for (int i = 0; i < 4 * 15 && !c_ac; i++) c_ac = bac[i] || rac[i];
    for (int i = 0; i < 4 && !c_dc; i++) c_dc = bdc[i] || rdc[i];
    int cc = c_ac ? 2 : (c_dc ? 1 : 0);

    bw.ue(1 + 2 + 4 * cc + (cl ? 12 : 0));  // mb_type (I_16x16, DC pred)
    bw.ue(0);                               // intra_chroma_pred_mode
    bw.se(0);                               // mb_qp_delta

    int32_t* t = &tcl[mx * 16];             // this MB's luma tc [by*4+bx]
    const int32_t* tl = mx > 0 ? &tcl[(mx - 1) * 16] : nullptr;

    // Intra16x16DC: context of blk (0,0)
    {
      bool a_ok = mx > 0;
      int na = a_ok ? tl[0 * 4 + 3] : 0;
      encode_block(bw, ldc, nc_ctx(na, 0, a_ok, false), 16);
    }
    if (cl) {
      for (int blk = 0; blk < 16; blk++) {
        int bx = kBlkX[blk], by = kBlkY[blk];
        bool a_ok = bx > 0 || mx > 0;
        bool b_ok = by > 0;
        int na = bx > 0 ? t[by * 4 + bx - 1] : (mx > 0 ? tl[by * 4 + 3] : 0);
        int nb = b_ok ? t[(by - 1) * 4 + bx] : 0;
        t[by * 4 + bx] =
            encode_block(bw, lac + blk * 15, nc_ctx(na, nb, a_ok, b_ok), 15);
      }
    } else {
      std::memset(t, 0, 16 * sizeof(int32_t));
    }
    if (cc > 0) {
      encode_block(bw, bdc, -1, 4);
      encode_block(bw, rdc, -1, 4);
    }
    int32_t* tb = &tcb[mx * 4];
    int32_t* tr = &tcr[mx * 4];
    const int32_t* tbl = mx > 0 ? &tcb[(mx - 1) * 4] : nullptr;
    const int32_t* trl = mx > 0 ? &tcr[(mx - 1) * 4] : nullptr;
    if (cc == 2) {
      for (int c = 0; c < 2; c++) {
        const int32_t* ac = c == 0 ? bac : rac;
        int32_t* tt = c == 0 ? tb : tr;
        const int32_t* ttl = c == 0 ? tbl : trl;
        for (int blk = 0; blk < 4; blk++) {
          int by = blk >> 1, bx = blk & 1;
          bool a_ok = bx > 0 || mx > 0;
          bool b_ok = by > 0;
          int na = bx > 0 ? tt[by * 2] : (mx > 0 ? ttl[by * 2 + 1] : 0);
          int nb = b_ok ? tt[bx] : 0;
          tt[blk] =
              encode_block(bw, ac + blk * 15, nc_ctx(na, nb, a_ok, b_ok), 15);
        }
      }
    } else {
      std::memset(tb, 0, 4 * sizeof(int32_t));
      std::memset(tr, 0, 4 * sizeof(int32_t));
    }
  }
  bw.trailing();

  // Annex-B NAL: start code + header + EPB-escaped RBSP (shared escaper
  // from entropy.cpp, same shared object)
  out.push_back(0); out.push_back(0); out.push_back(0); out.push_back(1);
  out.push_back(0x65);  // ref_idc 3, type 5 (IDR slice)
  size_t head = out.size();
  out.resize(head + bw.buf.size() * 3 / 2 + 16);
  int64_t n = h264_emulation_prevention(bw.buf.data(), (int64_t)bw.buf.size(),
                                        out.data() + head,
                                        (int64_t)(out.size() - head));
  out.resize(head + (size_t)n);
}

}  // namespace

extern "C" {

// Entropy-code a full I_16x16 picture (all row-slices) into Annex-B NALs.
// Returns bytes written, or -1 if `cap` was insufficient.
int64_t h264_encode_intra_picture(
    const int32_t* luma_dc, const int32_t* luma_ac, const int32_t* cb_dc,
    const int32_t* cb_ac, const int32_t* cr_dc, const int32_t* cr_ac,
    int64_t mb_rows, int64_t mb_cols, int32_t frame_num, int32_t idr_pic_id,
    uint8_t* out, int64_t cap) {
  PictureArgs a{luma_dc, luma_ac, cb_dc, cb_ac,
                cr_dc,   cr_ac,   mb_rows, mb_cols, frame_num, idr_pic_id};
  std::vector<std::vector<uint8_t>> slices(mb_rows);

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw > 8 ? 8 : (hw ? hw : 1));
  if ((int64_t)nthreads > mb_rows) nthreads = (int)mb_rows;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t my = next.fetch_add(1);
      if (my >= mb_rows) break;
      encode_slice(a, my, slices[my]);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; i++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  int64_t total = 0;
  for (auto& s : slices) total += (int64_t)s.size();
  if (total > cap) return -1;
  int64_t pos = 0;
  for (auto& s : slices) {
    std::memcpy(out + pos, s.data(), s.size());
    pos += (int64_t)s.size();
  }
  return pos;
}

// ABI probe checked by native/lib.py.
int32_t tpudesktop_cavlc_abi_version() { return 1; }

}  // extern "C"
