// The per-MB syntax walk of K11: one macroblock's CABAC (bin, ctxIdx,
// bypass) records, emitted in the engine's consumption order into a bit
// sink.  Spec 9.3.2/9.3.3 for the syntax subset of the encoder: I slices
// with I_16x16 and I_NxN MBs, P slices with P_L0_16x16 and P_Skip.
//
// Mirrors docker_nvidia_glx_desktop_tpu/ops/cabac_binarize.py record by
// record (_residual_slots :154, _mvd_slots :338, binarize_p :415,
// binarize_intra :490): each slot of the reference is the concatenation
// of the records emitted here in the same order.  An MB's records come in
// pieces (p_piece, i_piece), one a lane of the MB's warp; the pieces in
// order are the MB's stream.  Records (MSB first):
//   DEC  0   + ctx(9) + bin(1)        RUN  10  + ctx(9) + cnt(4)
//   BYP  110 + cnt(4) + bits(cnt)     TRM  111 + bin(1)
// Every context depends on the MB itself and on its left MB's inputs
// (slice per MB row: the top MB is never available), so the walk reads
// the MB's levels and summaries of the left MB (its nonzero flags, and
// the I4 modes of an I MB's left MB; for a P MB's left mvd, the mv of the
// MB left of it).
//
// Host and device code: the walk has no CUDA dependency, so it can be
// compiled for the host too.
#pragma once
#include <stdint.h>

#include "bitsink.cuh"

namespace cabac_rec {

CR_HD int imin(int a, int b) { return a < b ? a : b; }
CR_HD int imax(int a, int b) { return a > b ? a : b; }
CR_HD int iabs(int a) { return a < 0 ? -a : a; }
// floor(log2(x)), x >= 1
CR_HD int ilog2(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

// luma4x4BlkIdx -> (x, y) in 4x4-block units, and back
CR_HD int blk_x(int b) { return ((b >> 2) & 1) * 2 + (b & 1); }
CR_HD int blk_y(int b) { return ((b >> 3) & 1) * 2 + ((b >> 1) & 1); }
CR_HD int blk_of(int x, int y) { return ((y >> 1) * 2 + (x >> 1)) * 4 + (y & 1) * 2 + (x & 1); }

CR_HD int cbf_off(int cat) { return cat * 4; }
CR_HD int sig_off(int cat) { return cat == 0 ? 0 : cat == 1 ? 15 : cat == 2 ? 29 : cat == 3 ? 44 : 47; }
CR_HD int abs_off(int cat) { return cat == 0 ? 0 : cat == 1 ? 10 : cat == 2 ? 20 : cat == 3 ? 30 : 39; }

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
      const int u = imin(ilog2(static_cast<uint32_t>(v) + 1u), u_lim);
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
  const int u3 = imin(ilog2(static_cast<uint32_t>(v3 >> 3) + 1u), 6);  // v3 >= 8 (2^j - 1)
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

// The coded_block_flag context increments of the chroma DC block (cat 3)
// of plane p and of the AC block (cat 4) b of plane p; ``has_left`` false
// = column 0 (``left`` then unread).
CR_HD int chroma_dc_inc(const Chroma& left, bool has_left, bool left_skip, int p, bool intra) {
  const int una = intra ? 1 : 0;
  const int a = !has_left ? una : (left_skip ? 0 : (p ? left.dcnz[1] : left.dcnz[0]));
  return a + 2 * una;
}

CR_HD int chroma_ac_inc(const Chroma& cur, const Chroma& left, bool has_left, bool left_skip,
                        int p, int b, bool intra) {
  const int una = intra ? 1 : 0;
  const int by = b >> 1, bx = b & 1;
  const int av = bx ? (int)((cur.acnz >> (p * 4 + by * 2)) & 1u)
                    : (!has_left ? una
                                 : (left_skip ? 0 : (int)((left.acnz >> (p * 4 + by * 2 + 1)) & 1u)));
  const int bv = by ? (int)((cur.acnz >> (p * 4 + bx)) & 1u) : una;
  return av + 2 * bv;
}

// ---------------------------------------------------------------------------
// P pictures
// ---------------------------------------------------------------------------

struct PSum {
  bool skip;
  int cbp_luma;    // bit g: 8x8 group g has coefficients
  uint32_t lnz;    // bit b: luma block b (blkIdx) has coefficients
  Chroma ch;
  int mv[2];       // (y, x) quarter-pel
};

// An MB's nonzero flags as one word, bit for bit what a warp's ballot
// gives with lane l on piece l: bits 0-15 the luma blocks, 16 and 17 the
// Cb and Cr DC blocks, 18-21 the Cb AC blocks, 22-25 the Cr AC blocks.
CR_HD uint32_t p_nz_bits(const int* luma, const int* cb_dc, const int* cb_ac, const int* cr_dc,
                         const int* cr_ac) {
  uint32_t b = 0;
  for (int k = 0; k < 16; ++k) b |= any(luma + k * 16, 16) ? 1u << k : 0u;
  b |= any(cb_dc, 4) ? 1u << 16 : 0u;
  b |= any(cr_dc, 4) ? 1u << 17 : 0u;
  for (int k = 0; k < 4; ++k) {
    b |= any(cb_ac + k * 15, 15) ? 1u << (18 + k) : 0u;
    b |= any(cr_ac + k * 15, 15) ? 1u << (22 + k) : 0u;
  }
  return b;
}

CR_HD PSum p_sum_from(uint32_t bits, int mv0, int mv1) {
  PSum s;
  s.lnz = bits & 0xFFFFu;
  s.cbp_luma = 0;
  for (int g = 0; g < 4; ++g) s.cbp_luma |= ((s.lnz >> (4 * g)) & 0xFu) ? 1 << g : 0;
  s.ch.dcnz[0] = (int)((bits >> 16) & 1u);
  s.ch.dcnz[1] = (int)((bits >> 17) & 1u);
  s.ch.acnz = (bits >> 18) & 0xFFu;
  s.ch.cc = s.ch.acnz ? 2 : (s.ch.dcnz[0] | s.ch.dcnz[1]) ? 1 : 0;
  s.mv[0] = mv0;
  s.mv[1] = mv1;
  s.skip = mv0 == 0 && mv1 == 0 && s.cbp_luma == 0 && s.ch.cc == 0;
  return s;
}

// What the pieces of one P MB read: its summary, its left MB's (col0:
// none), the left MB's |mvd| (from the mv of the MB left of it), and the
// MB's own levels.
struct PCtx {
  PSum cur, L;
  bool col0, left_skip, last_col;
  int mvp[2], labs[2];
  const int *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
};

// ``left``/``ll_mv``: the left MB's summary and the mv of the MB left of
// it (null where the MB has none); ``lv``: the MB's luma, cb_dc, cb_ac,
// cr_dc, cr_ac.
CR_HD PCtx p_ctx(const PSum& cur, const PSum* left, const int* ll_mv, bool last_col,
                 const int* luma, const int* cb_dc, const int* cb_ac, const int* cr_dc,
                 const int* cr_ac) {
  PCtx x;
  x.cur = cur;
  x.L = left ? *left : PSum{};
  x.col0 = !left;
  x.left_skip = left && x.L.skip;
  x.last_col = last_col;
  x.mvp[0] = left ? x.L.mv[0] : 0;
  x.mvp[1] = left ? x.L.mv[1] : 0;
  x.labs[0] = x.labs[1] = 0;
  if (left && !x.L.skip) {
    x.labs[0] = iabs(x.L.mv[0] - (ll_mv ? ll_mv[0] : 0));
    x.labs[1] = iabs(x.L.mv[1] - (ll_mv ? ll_mv[1] : 0));
  }
  x.luma = luma;
  x.cb_dc = cb_dc;
  x.cb_ac = cb_ac;
  x.cr_dc = cr_dc;
  x.cr_ac = cr_ac;
  return x;
}

// A P MB's records in P_PIECES pieces, in stream order: 0 mb_skip_flag
// and mb_type; 1, 2 the mvd's x and y components; 3 coded_block_pattern
// and mb_qp_delta; 4-19 the luma 4x4 blocks (blkIdx order); 20, 21 the Cb
// and Cr DC blocks; 22-29 the Cb then Cr AC blocks; 30 end_of_slice.
// Returns the value overflow.
constexpr int P_PIECES = 31;

template <class Sink>
CR_HD bool p_piece(const PCtx& x, int k, Sink& sink) {
  Rec<Sink> rec{sink};
  const PSum& cur = x.cur;
  if (k == 0) {
    rec.dec(11 + ((!x.col0 && !x.left_skip) ? 1 : 0), cur.skip);
    if (!cur.skip) {
      rec.dec(14, 0);
      rec.dec(15, 0);
      rec.dec(16, 0);
    }
    return false;
  }
  if (k == P_PIECES - 1) {
    rec.trm(x.last_col);
    return false;
  }
  if (cur.skip) return false;
  if (k < 3) {                               // one call site: one copy of the code
    const bool xc = k == 1;                  // (selects, not indices: registers)
    return mvd(rec, xc ? cur.mv[1] - x.mvp[1] : cur.mv[0] - x.mvp[0],
               xc ? x.labs[1] : x.labs[0], xc ? 40 : 47);
  }
  if (k == 3) {
    const int lcl = (x.col0 || x.L.skip) ? 0 : x.L.cbp_luma;
    const int lcc = (x.col0 || x.L.skip) ? 0 : x.L.ch.cc;
    for (int b = 0; b < 4; ++b) {
      const int grp = (cur.cbp_luma >> b) & 1;
      const int a_n = (b & 1) ? 1 - ((cur.cbp_luma >> (b - 1)) & 1)
                              : (x.col0 ? 0 : 1 - ((lcl >> (b + 1)) & 1));
      const int b_n = (b & 2) ? 1 - ((cur.cbp_luma >> (b - 2)) & 1) : 0;
      rec.dec(73 + a_n + 2 * b_n, grp);
    }
    rec.dec(77 + (lcc > 0 ? 1 : 0), cur.ch.cc > 0);
    if (cur.ch.cc > 0) rec.dec(81 + (lcc == 2 ? 1 : 0), cur.ch.cc == 2);
    if (cur.cbp_luma > 0 || cur.ch.cc > 0) rec.dec(60, 0);
    return false;
  }
  // a residual block: its coefficients, category and context, then one
  // call site of residual (the walk's code once, whatever the block)
  const int* c;
  int n, cat, inc;
  bool emit;
  if (k < 20) {
    const int blk = k - 4, bx = blk_x(blk), by = blk_y(blk);
    const int av = bx ? (int)((cur.lnz >> blk_of(bx - 1, by)) & 1u)
                      : ((x.col0 || x.left_skip) ? 0 : (int)((x.L.lnz >> blk_of(3, by)) & 1u));
    const int bv = by ? (int)((cur.lnz >> blk_of(bx, by - 1)) & 1u) : 0;
    c = x.luma + blk * 16;
    n = 16;
    cat = 2;
    inc = av + 2 * bv;
    emit = (cur.cbp_luma >> (blk >> 2)) & 1;
  } else if (k < 22) {
    c = k == 20 ? x.cb_dc : x.cr_dc;
    n = 4;
    cat = 3;
    inc = chroma_dc_inc(x.L.ch, !x.col0, x.left_skip, k - 20, false);
    emit = cur.ch.cc > 0;
  } else {
    const int p = (k - 22) >> 2, b = (k - 22) & 3;
    c = (p ? x.cr_ac : x.cb_ac) + b * 15;
    n = 15;
    cat = 4;
    inc = chroma_ac_inc(cur.ch, x.L.ch, !x.col0, x.left_skip, p, b, false);
    emit = cur.ch.cc == 2;
  }
  return residual(rec, c, n, cat, inc, emit);
}

// ---------------------------------------------------------------------------
// I pictures
// ---------------------------------------------------------------------------

struct ISum {
  bool i16, cl16;
  int dcnz;        // luma DC block has coefficients
  uint32_t i4nz;   // bit b: I_NxN block b has coefficients
  uint32_t cbf;    // bit b: the coded_block_flag of luma block b
  int cbp4;        // I_NxN coded_block_pattern luma
  Chroma ch;
};

// What lane l of an I MB's warp tests for the MB's two nonzero words, so
// that a ballot gives each word: word 0, lanes 0-15 the luma AC blocks
// (I_16x16), 16 and 17 the Cb and Cr DC blocks, 18-21 the Cb AC blocks,
// 22-25 the Cr AC blocks, 26 the luma DC block; word 1, lanes 0-15 the
// I_NxN blocks.  The pointers are the MB's own levels.
CR_HD bool i_lane_nz(int word, int lane, const int* luma_dc, const int* luma_ac,
                     const int* luma_i4, const int* cb_dc, const int* cb_ac, const int* cr_dc,
                     const int* cr_ac) {
  if (word) return lane < 16 && any(luma_i4 + lane * 16, 16);
  if (lane < 16) return any(luma_ac + lane * 15, 15);
  if (lane < 18) return any(lane == 16 ? cb_dc : cr_dc, 4);
  if (lane < 26) return any((lane < 22 ? cb_ac : cr_ac) + ((lane - 18) & 3) * 15, 15);
  return lane == 26 && any(luma_dc, 16);
}

CR_HD ISum i_sum_from(uint32_t a, uint32_t b, bool i4) {
  ISum s;
  s.i16 = !i4;
  s.dcnz = static_cast<int>((a >> 26) & 1u);
  s.i4nz = b & 0xFFFFu;
  const uint32_t acnz = a & 0xFFFFu;
  s.cl16 = acnz != 0;
  s.cbf = s.i16 ? acnz : s.i4nz;
  s.cbp4 = 0;
  for (int g = 0; g < 4; ++g) s.cbp4 |= ((s.i4nz >> (4 * g)) & 0xFu) ? 1 << g : 0;
  s.ch.dcnz[0] = static_cast<int>((a >> 16) & 1u);
  s.ch.dcnz[1] = static_cast<int>((a >> 17) & 1u);
  s.ch.acnz = (a >> 18) & 0xFFu;
  s.ch.cc = s.ch.acnz ? 2 : (s.ch.dcnz[0] | s.ch.dcnz[1]) ? 1 : 0;
  return s;
}

// What the pieces of one I MB read: its summary, its left MB's (col0:
// none), its I_16x16 prediction mode, its I4 modes and its left MB's (null
// in column 0), and its own levels.
struct ICtx {
  ISum cur, L;
  bool col0, last_col;
  int pm;
  const int *modes, *lmodes;
  const int *luma_dc, *luma_ac, *luma_i4, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
};

CR_HD ICtx i_ctx(const ISum& cur, const ISum* left, bool last_col, int pm, const int* modes,
                 const int* lmodes, const int* luma_dc, const int* luma_ac, const int* luma_i4,
                 const int* cb_dc, const int* cb_ac, const int* cr_dc, const int* cr_ac) {
  ICtx x;
  x.cur = cur;
  x.L = left ? *left : ISum{};
  x.col0 = !left;
  x.last_col = last_col;
  x.pm = pm;
  x.modes = modes;
  x.lmodes = left ? lmodes : nullptr;
  x.luma_dc = luma_dc;
  x.luma_ac = luma_ac;
  x.luma_i4 = luma_i4;
  x.cb_dc = cb_dc;
  x.cb_ac = cb_ac;
  x.cr_dc = cr_dc;
  x.cr_ac = cr_ac;
  return x;
}

// An I MB's records in I_PIECES pieces, in stream order: 0 mb_type (and,
// for I_16x16, the bins it carries); 1 the 16 I4 prediction modes (I_NxN);
// 2 intra_chroma_pred_mode; 3 coded_block_pattern (I_NxN) and
// mb_qp_delta; 4 the luma DC block (I_16x16); 5-20 the 16 luma blocks
// (blkIdx order; AC of I_16x16 or I_NxN 4x4); 21, 22 the Cb and Cr DC
// blocks; 23-30 the Cb then Cr AC blocks; 31 end_of_slice.  Returns the
// value overflow.
constexpr int I_PIECES = 32;

template <class Sink>
CR_HD bool i_piece(const ICtx& x, int k, Sink& sink) {
  Rec<Sink> rec{sink};
  const ISum& cur = x.cur;
  if (k == 0) {
    rec.dec(3 + ((!x.col0 && x.L.i16) ? 1 : 0), cur.i16);
    if (cur.i16) {
      rec.trm(0);
      rec.dec(6, cur.cl16);
      rec.dec(7, cur.ch.cc > 0);
      if (cur.ch.cc > 0) rec.dec(8, cur.ch.cc == 2);
      rec.dec(9, (x.pm >> 1) & 1);
      rec.dec(10, x.pm & 1);
    }
    return false;
  }
  if (k == 1) {
    if (cur.i16) return false;
    for (int blk = 0; blk < 16; ++blk) {
      const int bx = blk_x(blk), by = blk_y(blk);
      int pred = 2;                        // the predictor's modes: 2 (DC) for I_16x16
      if (by > 0 && (bx > 0 || !x.col0)) {
        const int ma = bx ? x.modes[blk_of(bx - 1, by)]
                          : (x.L.i16 ? 2 : x.lmodes[blk_of(3, by)]);
        pred = imin(ma, x.modes[blk_of(bx, by - 1)]);
      }
      const int mode = x.modes[blk];
      const bool eq = mode == pred;
      const int rem = mode > pred ? mode - 1 : mode;
      rec.dec(68, eq);
      if (!eq) {
        rec.dec(69, rem & 1);
        rec.dec(69, (rem >> 1) & 1);
        rec.dec(69, (rem >> 2) & 1);
      }
    }
    return false;
  }
  if (k == 2) {
    rec.dec(64, 0);
    return false;
  }
  if (k == 3) {
    if (!cur.i16) {
      const int lcl = x.col0 ? 0 : (x.L.i16 ? (x.L.cl16 ? 0xF : 0) : x.L.cbp4);
      const int lcc = x.col0 ? 0 : x.L.ch.cc;
      for (int b = 0; b < 4; ++b) {
        const int grp = (cur.cbp4 >> b) & 1;
        const int a_n = (b & 1) ? 1 - ((cur.cbp4 >> (b - 1)) & 1)
                                : (x.col0 ? 0 : 1 - ((lcl >> (b + 1)) & 1));
        const int b_n = (b & 2) ? 1 - ((cur.cbp4 >> (b - 2)) & 1) : 0;
        rec.dec(73 + a_n + 2 * b_n, grp);
      }
      rec.dec(77 + (lcc > 0 ? 1 : 0), cur.ch.cc > 0);
      if (cur.ch.cc > 0) rec.dec(81 + (lcc == 2 ? 1 : 0), cur.ch.cc == 2);
    }
    if (cur.i16 || cur.cbp4 > 0 || cur.ch.cc > 0) rec.dec(60, 0);
    return false;
  }
  if (k == I_PIECES - 1) {
    rec.trm(x.last_col);
    return false;
  }
  // a residual block: its coefficients, category and context, then one
  // call site of residual (the walk's code once, whatever the block)
  const int* c;
  int n, cat, inc;
  bool emit;
  if (k == 4) {
    c = x.luma_dc;
    n = 16;
    cat = 0;
    inc = (x.col0 ? 1 : (x.L.i16 ? x.L.dcnz : 0)) + 2;
    emit = cur.i16;
  } else if (k < 21) {
    const int blk = k - 5, bx = blk_x(blk), by = blk_y(blk);
    const int av = bx ? (int)((cur.cbf >> blk_of(bx - 1, by)) & 1u)
                      : (x.col0 ? 1 : (int)((x.L.cbf >> blk_of(3, by)) & 1u));
    const int bv = by ? (int)((cur.cbf >> blk_of(bx, by - 1)) & 1u) : 1;
    inc = av + 2 * bv;
    if (cur.i16) {
      c = x.luma_ac + blk * 15;
      n = 15;
      cat = 1;
      emit = cur.cl16;
    } else {
      c = x.luma_i4 + blk * 16;
      n = 16;
      cat = 2;
      emit = (cur.cbp4 >> (blk >> 2)) & 1;
    }
  } else if (k < 23) {
    c = k == 21 ? x.cb_dc : x.cr_dc;
    n = 4;
    cat = 3;
    inc = chroma_dc_inc(x.L.ch, !x.col0, false, k - 21, true);
    emit = cur.ch.cc > 0;
  } else {
    const int p = (k - 23) >> 2, b = (k - 23) & 3;
    c = (p ? x.cr_ac : x.cb_ac) + b * 15;
    n = 15;
    cat = 4;
    inc = chroma_ac_inc(cur.ch, x.L.ch, !x.col0, false, p, b, true);
    emit = cur.ch.cc == 2;
  }
  return residual(rec, c, n, cat, inc, emit);
}

}  // namespace cabac_rec
