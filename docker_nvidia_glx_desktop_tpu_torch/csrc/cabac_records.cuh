// The per-MB syntax walk of K11: one macroblock's CABAC (bin, ctxIdx,
// bypass) records, emitted in the engine's consumption order into a bit
// sink.  Spec 9.3.2/9.3.3 for the syntax subset of the encoder: I slices
// with I_16x16 and I_NxN MBs, P slices with P_L0_16x16 and P_Skip.
//
// Mirrors docker_nvidia_glx_desktop_tpu/ops/cabac_binarize.py record by
// record (_residual_slots :154, _mvd_slots :338, binarize_p :415,
// binarize_intra :490): each slot of the reference is the concatenation
// of the records emitted here in the same order.  Records (MSB first):
//   DEC  0   + ctx(9) + bin(1)        RUN  10  + ctx(9) + cnt(4)
//   BYP  110 + cnt(4) + bits(cnt)     TRM  111 + bin(1)
// Every context depends on the MB itself and on its left MB's inputs
// (slice per MB row: the top MB is never available), so the walk reads
// the MB's levels and summaries of the left MB (and, for the left MB's
// mvd, the mv of the MB left of it).
//
// Host and device code: the walk has no CUDA dependency, so it can be
// compiled for the host too.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define CR_HD __host__ __device__ __forceinline__
#else
#define CR_HD inline
#endif

namespace cabac_rec {

CR_HD int imin(int a, int b) { return a < b ? a : b; }
CR_HD int imax(int a, int b) { return a > b ? a : b; }
CR_HD int iabs(int a) { return a < 0 ? -a : a; }

// luma4x4BlkIdx -> (x, y) in 4x4-block units, and back
CR_HD int blk_x(int b) { return ((b >> 2) & 1) * 2 + (b & 1); }
CR_HD int blk_y(int b) { return ((b >> 3) & 1) * 2 + ((b >> 1) & 1); }
CR_HD int blk_of(int x, int y) { return ((y >> 1) * 2 + (x >> 1)) * 4 + (y & 1) * 2 + (x & 1); }

CR_HD int cbf_off(int cat) { return cat * 4; }
CR_HD int sig_off(int cat) { return cat == 0 ? 0 : cat == 1 ? 15 : cat == 2 ? 29 : cat == 3 ? 44 : 47; }
CR_HD int abs_off(int cat) { return cat == 0 ? 0 : cat == 1 ? 10 : cat == 2 ? 20 : cat == 3 ? 30 : 39; }

// Bits of a record stream, MSB-first into words; counts every bit but
// writes only the first ``cap_words`` words.
struct WordSink {
  uint32_t* w;
  int cap_words;
  long long n;
  unsigned long long acc;
  int have, widx;
  CR_HD WordSink(uint32_t* words, int cap) : w(words), cap_words(cap), n(0), acc(0), have(0), widx(0) {}
  CR_HD void put(uint32_t v, int len) {
    if (len <= 0) return;
    if (len < 32) v &= (1u << len) - 1u;
    acc = (acc << len) | v;
    have += len;
    n += len;
    while (have >= 32) {
      have -= 32;
      const uint32_t word = (uint32_t)(acc >> have);
      if (widx < cap_words) w[widx] = word;
      ++widx;
      acc &= (1ull << have) - 1ull;
    }
  }
  CR_HD void flush() {
    if (have > 0 && widx < cap_words) w[widx] = (uint32_t)(acc << (32 - have));
  }
};

template <class Sink>
struct Rec {
  Sink& s;
  CR_HD void dec(int ctx, int b) { s.put(((uint32_t)ctx << 1) | (b ? 1u : 0u), 11); }
  CR_HD void run(int ctx, int cnt) { s.put((2u << 13) | ((uint32_t)ctx << 4) | (uint32_t)cnt, 15); }
  CR_HD void byp(uint32_t bits, int cnt) {
    s.put((6u << (4 + cnt)) | ((uint32_t)cnt << cnt) | bits, 7 + cnt);
  }
  CR_HD void trm(int b) { s.put((7u << 1) | (b ? 1u : 0u), 4); }
};

// One residual block (spec 9.3.3.1.3): coded_block_flag, the
// significance map, then the levels in reverse scan order.  Returns the
// suffix-budget overflow (a level beyond what its bypass slots hold).
template <class R>
CR_HD bool residual(R& rec, const int* c, int n, int cat, int cbf_inc, bool emit) {
  if (!emit) return false;
  int last = -1;
  for (int i = 0; i < n; ++i)
    if (c[i]) last = i;
  rec.dec(85 + cbf_off(cat) + cbf_inc, last >= 0);
  if (last < 0) return false;
  const int sig_base = 105 + sig_off(cat), last_base = 166 + sig_off(cat);
  for (int i = 0; i < n - 1 && i <= last; ++i) {
    const int inc = cat == 3 ? imin(i, 2) : i;
    rec.dec(sig_base + inc, c[i] != 0);
    if (c[i]) rec.dec(last_base + inc, last == i);
  }
  const int abs_base = 227 + abs_off(cat);
  const int capn = cat == 3 ? 3 : 4;
  const bool wide = cat == 0 || cat == 3;   // two bypass slots of suffix budget
  const int u_lim = wide ? 14 : 6;
  bool ovf = false;
  int num_gt1 = 0, num_eq1 = 0;             // over the positions after j
  for (int j = n - 1; j >= 0; --j) {
    const int v0 = c[j];
    if (v0) {
      const int a = iabs(v0), lvl = a - 1;
      const int c0 = abs_base + (num_gt1 > 0 ? 0 : imin(4, 1 + num_eq1));
      const int cn = abs_base + 5 + imin(capn, num_gt1);
      const int prefix = imin(lvl, 14);
      rec.dec(c0, lvl >= 1);
      if (prefix >= 2) rec.run(cn, imin(imax(prefix - 1, 1), 14));
      if (prefix >= 1 && prefix < 14) rec.dec(cn, 0);
      const int v = imax(lvl - 14, 0);
      int u = 0;
      for (int k = 1; k <= u_lim + 1; ++k) u += (v + 1 >= (1 << k)) ? 1 : 0;
      u = imin(u, u_lim);
      const int r = v - ((1 << u) - 1);
      const uint32_t sign = v0 < 0 ? 1u : 0u;
      const uint32_t suf = ((uint32_t)((1 << u) - 1) << (u + 1)) | (uint32_t)r;
      const bool has_suf = lvl >= 14;
      const uint32_t bits = has_suf ? ((suf << 1) | sign) : sign;
      const int cnt = has_suf ? 2 * u + 2 : 1;
      if (wide) {
        const int hi_len = imin(cnt, 15), lo_len = cnt - hi_len;
        rec.byp(bits >> lo_len, hi_len);
        if (lo_len > 0) rec.byp(bits & ((1u << lo_len) - 1u), lo_len);
      } else {
        rec.byp(bits, cnt);
      }
      ovf |= v + 1 > (1 << (u_lim + 1)) - 1;
      if (a > 1) ++num_gt1;
      if (a == 1) ++num_eq1;
    }
  }
  return ovf;
}

// mvd_l0 component: UEG3 (uCoff 9) prefix bins, then suffix and sign as
// one bypass record.  Returns the bypass-budget overflow.
template <class R>
CR_HD bool mvd(R& rec, int comp, int s_left, int base) {
  const int inc = s_left < 3 ? 0 : (s_left <= 32 ? 1 : 2);
  const int aa = iabs(comp), prefix = imin(aa, 9);
  for (int k = 0; k < 9; ++k) {
    if (k < prefix || (k == prefix && prefix < 9))
      rec.dec(k == 0 ? base + inc : base + 2 + imin(k, 4), k < prefix);
  }
  const int v3 = imax(aa - 9, 0);
  int u3 = 0;
  for (int j = 1; j <= 6; ++j) u3 += (v3 >= 8 * ((1 << j) - 1)) ? 1 : 0;
  const int r3 = v3 - 8 * ((1 << u3) - 1);
  const uint32_t suf3 = ((uint32_t)((1 << u3) - 1) << (u3 + 4)) | (uint32_t)r3;
  const uint32_t sign = comp < 0 ? 1u : 0u;
  const bool has_suf = aa >= 9;
  if (aa > 0) rec.byp(has_suf ? ((suf3 << 1) | sign) : sign, has_suf ? 2 * u3 + 5 : 1);
  return 2 * u3 + 5 > 15;
}

// Chroma nonzero flags and coded_block_pattern chroma of one MB.
struct Chroma {
  int cc;         // 0, 1 (DC only) or 2 (AC)
  int dcnz[2];    // Cb, Cr DC blocks
  uint32_t acnz;  // bit p*4 + b: AC block b of plane p
};

CR_HD bool any(const int* p, int n) {
  for (int i = 0; i < n; ++i)
    if (p[i]) return true;
  return false;
}

CR_HD Chroma chroma_of(const int* cb_dc, const int* cb_ac, const int* cr_dc, const int* cr_ac,
                       int mb) {
  Chroma s;
  s.dcnz[0] = any(cb_dc + mb * 4, 4);
  s.dcnz[1] = any(cr_dc + mb * 4, 4);
  s.acnz = 0;
  for (int b = 0; b < 4; ++b) {
    s.acnz |= any(cb_ac + (mb * 4 + b) * 15, 15) ? 1u << b : 0u;
    s.acnz |= any(cr_ac + (mb * 4 + b) * 15, 15) ? 1u << (4 + b) : 0u;
  }
  s.cc = s.acnz ? 2 : (s.dcnz[0] | s.dcnz[1]) ? 1 : 0;
  return s;
}

// Chroma DC (cat 3) then AC (cat 4) residuals; ``left`` null = column 0.
template <class R>
CR_HD bool chroma_residuals(R& rec, const Chroma& cur, const Chroma* left, bool left_skip,
                            const int* cb_dc, const int* cb_ac, const int* cr_dc,
                            const int* cr_ac, int mb, bool intra) {
  const int una = intra ? 1 : 0;
  bool ovf = false;
  const int* dc[2] = {cb_dc + mb * 4, cr_dc + mb * 4};
  const int* ac[2] = {cb_ac + mb * 60, cr_ac + mb * 60};
  for (int p = 0; p < 2; ++p) {
    const int a = !left ? una : (left_skip ? 0 : left->dcnz[p]);
    ovf |= residual(rec, dc[p], 4, 3, a + 2 * una, cur.cc > 0);
  }
  for (int p = 0; p < 2; ++p) {
    for (int b = 0; b < 4; ++b) {
      const int by = b >> 1, bx = b & 1;
      const int av = bx ? (int)((cur.acnz >> (p * 4 + by * 2)) & 1u)
                        : (!left ? una
                                 : (left_skip ? 0 : (int)((left->acnz >> (p * 4 + by * 2 + 1)) & 1u)));
      const int bv = by ? (int)((cur.acnz >> (p * 4 + bx)) & 1u) : una;
      ovf |= residual(rec, ac[p] + b * 15, 15, 4, av + 2 * bv, cur.cc == 2);
    }
  }
  return ovf;
}

// ---------------------------------------------------------------------------
// P pictures
// ---------------------------------------------------------------------------

struct PIn {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  int nc;
};

struct PSum {
  bool skip;
  int cbp_luma;    // bit g: 8x8 group g has coefficients
  uint32_t lnz;    // bit b: luma block b (blkIdx) has coefficients
  Chroma ch;
  int mv[2];       // (y, x) quarter-pel
};

CR_HD PSum p_summary(const PIn& in, int mb) {
  PSum s;
  s.lnz = 0;
  for (int b = 0; b < 16; ++b) s.lnz |= any(in.luma + (mb * 16 + b) * 16, 16) ? 1u << b : 0u;
  s.cbp_luma = 0;
  for (int g = 0; g < 4; ++g) s.cbp_luma |= ((s.lnz >> (4 * g)) & 0xFu) ? 1 << g : 0;
  s.ch = chroma_of(in.cb_dc, in.cb_ac, in.cr_dc, in.cr_ac, mb);
  s.mv[0] = in.mv[mb * 2];
  s.mv[1] = in.mv[mb * 2 + 1];
  s.skip = s.mv[0] == 0 && s.mv[1] == 0 && s.cbp_luma == 0 && s.ch.cc == 0;
  return s;
}

// Records of P MB (r, c); returns the value overflow.
template <class Sink>
CR_HD bool p_mb(const PIn& in, int r, int c, Sink& sink) {
  Rec<Sink> rec{sink};
  const int mb = r * in.nc + c;
  const PSum cur = p_summary(in, mb);
  PSum L{};
  if (c > 0) L = p_summary(in, mb - 1);
  const bool col0 = c == 0, left_skip = !col0 && L.skip;
  bool ovf = false;
  rec.dec(11 + ((!col0 && !left_skip) ? 1 : 0), cur.skip);
  if (!cur.skip) {
    rec.dec(14, 0);
    rec.dec(15, 0);
    rec.dec(16, 0);
    // mvp = the left MB's mv; the left MB's |mvd| sums, 0 for a skip
    const int mvp[2] = {col0 ? 0 : L.mv[0], col0 ? 0 : L.mv[1]};
    int labs[2] = {0, 0};
    if (!col0 && !L.skip) {
      const int ll0 = c > 1 ? in.mv[(mb - 2) * 2] : 0, ll1 = c > 1 ? in.mv[(mb - 2) * 2 + 1] : 0;
      labs[0] = iabs(L.mv[0] - ll0);
      labs[1] = iabs(L.mv[1] - ll1);
    }
    ovf |= mvd(rec, cur.mv[1] - mvp[1], labs[1], 40);
    ovf |= mvd(rec, cur.mv[0] - mvp[0], labs[0], 47);
    const int lcl = (col0 || L.skip) ? 0 : L.cbp_luma;
    const int lcc = (col0 || L.skip) ? 0 : L.ch.cc;
    for (int b = 0; b < 4; ++b) {
      const int grp = (cur.cbp_luma >> b) & 1;
      const int a_n = (b & 1) ? 1 - ((cur.cbp_luma >> (b - 1)) & 1)
                              : (col0 ? 0 : 1 - ((lcl >> (b + 1)) & 1));
      const int b_n = (b & 2) ? 1 - ((cur.cbp_luma >> (b - 2)) & 1) : 0;
      rec.dec(73 + a_n + 2 * b_n, grp);
    }
    rec.dec(77 + (lcc > 0 ? 1 : 0), cur.ch.cc > 0);
    if (cur.ch.cc > 0) rec.dec(81 + (lcc == 2 ? 1 : 0), cur.ch.cc == 2);
    if (cur.cbp_luma > 0 || cur.ch.cc > 0) rec.dec(60, 0);
    for (int blk = 0; blk < 16; ++blk) {
      const int bx = blk_x(blk), by = blk_y(blk);
      const int av = bx ? (int)((cur.lnz >> blk_of(bx - 1, by)) & 1u)
                        : ((col0 || left_skip) ? 0 : (int)((L.lnz >> blk_of(3, by)) & 1u));
      const int bv = by ? (int)((cur.lnz >> blk_of(bx, by - 1)) & 1u) : 0;
      ovf |= residual(rec, in.luma + (mb * 16 + blk) * 16, 16, 2, av + 2 * bv,
                      (cur.cbp_luma >> (blk >> 2)) & 1);
    }
    ovf |= chroma_residuals(rec, cur.ch, col0 ? nullptr : &L.ch, left_skip, in.cb_dc, in.cb_ac,
                            in.cr_dc, in.cr_ac, mb, false);
  }
  rec.trm(c == in.nc - 1);
  return ovf;
}

// ---------------------------------------------------------------------------
// I pictures
// ---------------------------------------------------------------------------

struct IIn {
  const int *luma_dc, *luma_ac, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *pred_mode;
  const uint8_t* mb_i4;
  const int *i4_modes, *luma_i4;
  int nc;
};

struct ISum {
  bool i16, cl16;
  int dcnz;        // luma DC block has coefficients
  uint32_t i4nz;   // bit b: I_NxN block b has coefficients
  uint32_t cbf;    // bit b: the coded_block_flag of luma block b
  int cbp4;        // I_NxN coded_block_pattern luma
  Chroma ch;
};

CR_HD ISum i_summary(const IIn& in, int mb) {
  ISum s;
  s.i16 = !in.mb_i4[mb];
  s.dcnz = any(in.luma_dc + mb * 16, 16);
  s.i4nz = 0;
  uint32_t acnz = 0;
  for (int b = 0; b < 16; ++b) {
    s.i4nz |= any(in.luma_i4 + (mb * 16 + b) * 16, 16) ? 1u << b : 0u;
    acnz |= any(in.luma_ac + (mb * 16 + b) * 15, 15) ? 1u << b : 0u;
  }
  s.cl16 = acnz != 0;
  s.cbf = s.i16 ? acnz : s.i4nz;
  s.cbp4 = 0;
  for (int g = 0; g < 4; ++g) s.cbp4 |= ((s.i4nz >> (4 * g)) & 0xFu) ? 1 << g : 0;
  s.ch = chroma_of(in.cb_dc, in.cb_ac, in.cr_dc, in.cr_ac, mb);
  return s;
}

// Intra4x4 mode of raster block (x, y) as the predictor sees it: 2 (DC)
// for an I_16x16 MB.
CR_HD int mode_at(const IIn& in, int mb, bool i16, int x, int y) {
  return i16 ? 2 : in.i4_modes[mb * 16 + blk_of(x, y)];
}

// Records of I MB (r, c); returns the value overflow.
template <class Sink>
CR_HD bool intra_mb(const IIn& in, int r, int c, Sink& sink) {
  Rec<Sink> rec{sink};
  const int mb = r * in.nc + c;
  const ISum cur = i_summary(in, mb);
  ISum L{};
  if (c > 0) L = i_summary(in, mb - 1);
  const bool col0 = c == 0;
  bool ovf = false;
  rec.dec(3 + ((!col0 && L.i16) ? 1 : 0), cur.i16);
  if (cur.i16) {
    const int pm = in.pred_mode[mb];
    rec.trm(0);
    rec.dec(6, cur.cl16);
    rec.dec(7, cur.ch.cc > 0);
    if (cur.ch.cc > 0) rec.dec(8, cur.ch.cc == 2);
    rec.dec(9, (pm >> 1) & 1);
    rec.dec(10, pm & 1);
  } else {
    for (int blk = 0; blk < 16; ++blk) {
      const int bx = blk_x(blk), by = blk_y(blk);
      int pred = 2;
      if (by > 0 && (bx > 0 || !col0)) {
        const int ma = bx ? mode_at(in, mb, false, bx - 1, by) : mode_at(in, mb - 1, L.i16, 3, by);
        pred = imin(ma, mode_at(in, mb, false, bx, by - 1));
      }
      const int mode = in.i4_modes[mb * 16 + blk];
      const bool eq = mode == pred;
      const int rem = mode > pred ? mode - 1 : mode;
      rec.dec(68, eq);
      if (!eq) {
        rec.dec(69, rem & 1);
        rec.dec(69, (rem >> 1) & 1);
        rec.dec(69, (rem >> 2) & 1);
      }
    }
  }
  rec.dec(64, 0);
  if (!cur.i16) {
    const int lcl = col0 ? 0 : (L.i16 ? (L.cl16 ? 0xF : 0) : L.cbp4);
    const int lcc = col0 ? 0 : L.ch.cc;
    for (int b = 0; b < 4; ++b) {
      const int grp = (cur.cbp4 >> b) & 1;
      const int a_n = (b & 1) ? 1 - ((cur.cbp4 >> (b - 1)) & 1)
                              : (col0 ? 0 : 1 - ((lcl >> (b + 1)) & 1));
      const int b_n = (b & 2) ? 1 - ((cur.cbp4 >> (b - 2)) & 1) : 0;
      rec.dec(73 + a_n + 2 * b_n, grp);
    }
    rec.dec(77 + (lcc > 0 ? 1 : 0), cur.ch.cc > 0);
    if (cur.ch.cc > 0) rec.dec(81 + (lcc == 2 ? 1 : 0), cur.ch.cc == 2);
  }
  if (cur.i16 || cur.cbp4 > 0 || cur.ch.cc > 0) rec.dec(60, 0);
  {
    const int a = col0 ? 1 : (L.i16 ? L.dcnz : 0);
    ovf |= residual(rec, in.luma_dc + mb * 16, 16, 0, a + 2, cur.i16);
  }
  for (int blk = 0; blk < 16; ++blk) {
    const int bx = blk_x(blk), by = blk_y(blk);
    const int av = bx ? (int)((cur.cbf >> blk_of(bx - 1, by)) & 1u)
                      : (col0 ? 1 : (int)((L.cbf >> blk_of(3, by)) & 1u));
    const int bv = by ? (int)((cur.cbf >> blk_of(bx, by - 1)) & 1u) : 1;
    if (cur.i16)
      ovf |= residual(rec, in.luma_ac + (mb * 16 + blk) * 15, 15, 1, av + 2 * bv, cur.cl16);
    else
      ovf |= residual(rec, in.luma_i4 + (mb * 16 + blk) * 16, 16, 2, av + 2 * bv,
                      (cur.cbp4 >> (blk >> 2)) & 1);
  }
  ovf |= chroma_residuals(rec, cur.ch, col0 ? nullptr : &L.ch, false, in.cb_dc, in.cb_ac,
                          in.cr_dc, in.cr_ac, mb, true);
  rec.trm(c == in.nc - 1);
  return ovf;
}

}  // namespace cabac_rec
