// K2 — CAVLC slot coder: the intra core's level tensors -> (value, length)
// codeword slots for the 27 residual blocks of every MB (34 slots each)
// and the 20 MB-syntax slots.
// K6 — the same for P slices: 26 residual blocks per MB, the 7 MB-header
// slots (skip run, mb_type, mvd, cbp, mb_qp_delta), each row's trailing
// skip run and the per-4x4 coded flags the loop filter takes.  Its
// I16-in-P form (tune=hq, a template instantiation) codes 27 blocks, the
// Intra16x16DCLevel first and an intra MB's 15-coefficient luma AC, and
// an intra MB's header (cavlc_p_device.py:77-158, :160-290).
// The qp chain (tune=hq's full tier) is a pass of its own after either
// slot coder: one warp per MB row scans cummax(codes ? c : -1) along
// the row (aq.py:151 qp_chain, cavlc_device.py:527-545 / cavlc_p_device
// :427-437), writes the mb_qp_delta slots and adds the effective qps
// into the frame's qp sum.
//
// K2 replaces docker_nvidia_glx_desktop_tpu/ops/cavlc_device.py:416
// frame_block_slots (code_blocks :247, nc_grid :388,
// intra_mb_syntax_slots :548); K6 replaces ops/cavlc_p_device.py:158
// p_frame_block_slots (inter MBs), :77 p_mb_header_slots and the nnz
// flags of _finish_p :425.  The slots are equal to theirs.
//
// What bounds it: the sequential per-block CAVLC loops (level VLC with
// adaptive suffixLength, run_before with zerosLeft), not bytes: it reads
// ~4 KB and writes ~7.5 KB of slots per MB.  Pass 1 (one thread per MB)
// counts total_coeff per block with the cbp gates; pass 2 runs one thread
// per 4x4 block (27 per MB) with its loops in registers and the tables in
// constant memory, plus one thread per MB for the syntax slots.
#include "common.cuh"

namespace {

constexpr int BLOCKS = 27, SLOTS = 34, SYN = 20;
constexpr int INFO = 32;     // per-MB scratch words written by pass 1

// (length << 16 | bits) tables, uploaded once by cavlc_upload_tables.
__constant__ int c_ct[5 * 17 * 4];
__constant__ int c_tz[16 * 16];
__constant__ int c_tzc[3 * 4];
__constant__ int c_rb[57];
__constant__ int c_cbp_cn[48];
__constant__ int c_cbp_cn_inter[48];

struct Levels {
  const int *luma_dc, *luma_ac, *cb_dc, *cb_ac, *cr_dc, *cr_ac, *pred_mode;
  const uint8_t* mb_i4;
  const int *i4_modes, *luma_i4;
};

// scratch word layout per MB (pass 1 -> pass 2)
enum { TC_LUMA = 0, TC_CB = 16, TC_CR = 20, CBP_LUMA = 24, CBP_LUMA4 = 25,
       CBP_CHROMA = 26, GRP_ANY = 27 };

// blockIdx.y: the session.  Sessions' levels, slots and scratch are
// stacked contiguously, nmb MBs each, so mb below is the stack's index;
// an MB reads only its own row (slice per MB row), never another session.
__global__ void mb_info_kernel(Levels L, int* info, int nmb) {
  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= nmb) return;
  const int mb = blockIdx.y * nmb + local;
  int* o = info + mb * INFO;
  const bool i4 = L.mb_i4[mb];
  bool cbp_luma = false;
  for (int k = 0; k < 16 * 15; ++k) cbp_luma |= L.luma_ac[mb * 240 + k] != 0;
  int grp[4] = {0, 0, 0, 0}, cbp4 = 0;
  for (int g = 0; g < 4; ++g) {
    for (int k = 0; k < 64; ++k) grp[g] |= L.luma_i4[mb * 256 + g * 64 + k] != 0;
    cbp4 |= grp[g] << g;
  }
  bool ac_any = false, dc_any = false;
  for (int k = 0; k < 60; ++k)
    ac_any |= (L.cb_ac[mb * 60 + k] != 0) | (L.cr_ac[mb * 60 + k] != 0);
  for (int k = 0; k < 4; ++k)
    dc_any |= (L.cb_dc[mb * 4 + k] != 0) | (L.cr_dc[mb * 4 + k] != 0);
  const int cbp_c = ac_any ? 2 : (dc_any ? 1 : 0);
  for (int b = 0; b < 16; ++b) {      // blkIdx -> raster position
    int tc = 0;
    const bool gate = i4 ? grp[b >> 2] : cbp_luma;
    if (gate) {
      if (i4) {
        for (int k = 0; k < 16; ++k) tc += L.luma_i4[(mb * 16 + b) * 16 + k] != 0;
      } else {
        for (int k = 0; k < 15; ++k) tc += L.luma_ac[(mb * 16 + b) * 15 + k] != 0;
      }
    }
    o[TC_LUMA + c_blk_y[b] * 4 + c_blk_x[b]] = tc;
  }
  for (int q = 0; q < 4; ++q) {
    int tcb = 0, tcr = 0;
    if (cbp_c == 2) {
      for (int k = 0; k < 15; ++k) {
        tcb += L.cb_ac[(mb * 4 + q) * 15 + k] != 0;
        tcr += L.cr_ac[(mb * 4 + q) * 15 + k] != 0;
      }
    }
    o[TC_CB + q] = tcb;
    o[TC_CR + q] = tcr;
  }
  o[CBP_LUMA] = cbp_luma;
  o[CBP_LUMA4] = cbp4;
  o[CBP_CHROMA] = cbp_c;
  o[GRP_ANY] = grp[0] | (grp[1] << 1) | (grp[2] << 2) | (grp[3] << 3);
}

// nC of the block at (by, bx) of a w x w total_coeff grid (spec 9.2.1):
// above only inside the MB, left across into the previous MB.
__device__ int nc_of(const int* grid, const int* left_grid, int w, int by, int bx) {
  const bool a_ok = bx > 0 || left_grid != nullptr;
  const bool b_ok = by > 0;
  const int na = bx > 0 ? grid[by * w + bx - 1] : (a_ok ? left_grid[by * w + w - 1] : 0);
  const int nb = b_ok ? grid[(by - 1) * w + bx] : 0;
  if (a_ok && b_ok) return (na + nb + 1) >> 1;
  if (a_ok) return na;
  if (b_ok) return nb;
  return 0;
}

// One level codeword (9.2.2.1), all escape tiers up to level_prefix 17.
__device__ void level_vlc(int code, int sl, unsigned* val, int* len) {
  const int slm = max(sl, 1);
  const int prefix = code >> slm;
  const int esc_base = (15 << sl) + (sl == 0 ? 15 : 0);
  const int b16 = esc_base + (1 << 13) - 4096;
  const int b17 = esc_base + (1 << 14) - 4096;
  unsigned ev;
  int el;
  if (code < esc_base + 4096) { ev = (1u << 12) | (unsigned)(code - esc_base); el = 28; }
  else if (code < b16 + (1 << 13)) { ev = (1u << 13) | (unsigned)(code - b16); el = 30; }
  else { ev = (1u << 14) | (unsigned)(code - b17); el = 32; }
  if (sl == 0) {
    if (code < 14) { *val = 1; *len = code + 1; }
    else if (code < 30) { *val = (1u << 4) | (unsigned)(code - 14); *len = 19; }
    else { *val = ev; *len = el; }
  } else if (prefix < 15) {
    *val = (1u << slm) | (unsigned)(code & ((1 << slm) - 1));
    *len = prefix + 1 + sl;
  } else {
    *val = ev; *len = el;
  }
}

// Code one block's 16 scan-order levels into 34 slots.
__device__ void code_block(const int* lv, int nc, bool is_cdc, int max_coeff,
                           bool gate, int* vals, int* lens) {
  int rv[19], rp[16], total = 0;
  for (int k = 15; k >= 0; --k)
    if (lv[k] != 0) { rv[total] = lv[k]; rp[total] = k; ++total; }
  for (int j = total; j < 16; ++j) { rv[j] = 0; rp[j] = 0; }
  rv[16] = rv[17] = rv[18] = 0;
  const bool c0 = total > 0 && abs(rv[0]) == 1;
  const bool c1 = c0 && total > 1 && abs(rv[1]) == 1;
  const bool c2 = c1 && total > 2 && abs(rv[2]) == 1;
  const int t1 = (int)c0 + (int)c1 + (int)c2;
  const int cls = is_cdc ? 4 : (nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3)));
  const int ct = c_ct[(cls * 17 + total) * 4 + t1];
  vals[0] = ct & 0xFFFF; lens[0] = ct >> 16;
  const int s0 = rv[0] < 0, s1 = rv[1] < 0, s2 = rv[2] < 0;
  vals[1] = t1 == 0 ? 0 : (t1 == 1 ? s0 : (t1 == 2 ? (s0 << 1) | s1 : (s0 << 2) | (s1 << 1) | s2));
  lens[1] = t1;
  // remaining levels, highest frequency first
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  bool first = true;
  const int n_levels = total - t1;
  for (int j = 0; j < 16; ++j) {
    if (j >= n_levels) { vals[2 + j] = 0; lens[2 + j] = 0; continue; }
    const int level = rv[t1 + j];
    int code = level > 0 ? 2 * level - 2 : -2 * level - 1;
    if (first && t1 < 3) code -= 2;
    unsigned v;
    int l;
    level_vlc(code, sl, &v, &l);
    vals[2 + j] = (int)v; lens[2 + j] = l;
    int sl_new = max(sl, 1);
    if (abs(level) > (3 << max(sl_new - 1, 0)) && sl_new < 6) ++sl_new;
    sl = sl_new;
    first = false;
  }
  // total_zeros
  const int tz = total > 0 ? rp[0] + 1 - total : 0;
  const int tzi = min(max(total - 1, 0), 15);
  const int tzp = is_cdc ? c_tzc[min(tzi, 2) * 4 + min(max(tz, 0), 3)]
                         : c_tz[tzi * 16 + min(max(tz, 0), 15)];
  const bool tz_emit = total > 0 && total < max_coeff;
  vals[18] = tz_emit ? tzp & 0xFFFF : 0;
  lens[18] = tz_emit ? tzp >> 16 : 0;
  // run_before
  int zeros_left = tz;
  for (int k = 0; k < 15; ++k) {
    const int next = k + 1 < 16 ? rp[k + 1] : 0;
    const int run = min(max(rp[k] - next - 1, 0), 14);
    const bool active = k <= total - 2 && zeros_left > 0;
    int rbp = 0;
    if (active) {
      const int row = min(max(min(zeros_left, 7) - 1, 0), 6);
      rbp = c_rb[row < 6 ? row * 7 + min(run, 6) : 42 + run];
    }
    vals[19 + k] = rbp & 0xFFFF;
    lens[19 + k] = rbp >> 16;
    zeros_left -= run;
  }
  if (!gate)
    for (int s = 0; s < SLOTS; ++s) lens[s] = 0;
}

__device__ int ue_len(int code_num) { return 2 * (32 - __clz(code_num + 1)) - 1; }

__device__ int mode_raster(const Levels& L, int mb, int by, int bx) {
  if (!L.mb_i4[mb]) return 2;
  // raster (by, bx) -> blkIdx
  const int blk = (by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1);
  return L.i4_modes[mb * 16 + blk];
}

__device__ void syntax_slots(const Levels& L, const int* info, int mb, bool has_left,
                             int* vals, int* lens) {
  const bool i4 = L.mb_i4[mb];
  for (int b = 0; b < 16; ++b) {
    const int bx = c_blk_x[b], by = c_blk_y[b];
    const bool a_ok = bx > 0 || has_left, b_ok = by > 0;
    int pred = 2;
    if (a_ok && b_ok) {
      const int ma = bx > 0 ? mode_raster(L, mb, by, bx - 1) : mode_raster(L, mb - 1, by, 3);
      pred = min(ma, mode_raster(L, mb, by - 1, bx));
    }
    const int m = L.i4_modes[mb * 16 + b];
    const bool flag = m == pred;
    vals[1 + b] = flag ? 1 : m - (m > pred);
    lens[1 + b] = i4 ? (flag ? 1 : 4) : 0;
  }
  const int cl = info[CBP_LUMA], cc = info[CBP_CHROMA];
  const int mbt16 = 1 + L.pred_mode[mb] + 4 * cc + 12 * cl;
  vals[0] = i4 ? 1 : mbt16 + 1;
  lens[0] = i4 ? 1 : ue_len(mbt16);
  const int cbp = info[CBP_LUMA4] + 16 * cc;
  const int cn = c_cbp_cn[cbp];
  vals[17] = 1; lens[17] = 1;
  vals[18] = cn + 1;
  lens[18] = i4 ? ue_len(cn) : 0;
  vals[19] = 1;
  lens[19] = (i4 && cbp == 0) ? 0 : 1;
}

__global__ void slots_kernel(Levels L, const int* info, int* values, int* lengths,
                             int* syn_vals, int* syn_lens, int nmb, int nc) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= nmb * (BLOCKS + 1)) return;
  const int mb = blockIdx.y * nmb + gid / (BLOCKS + 1), j = gid % (BLOCKS + 1);
  const bool has_left = mb % nc != 0;
  const int* inf = info + mb * INFO;
  const int* linf = has_left ? info + (mb - 1) * INFO : nullptr;
  if (j == BLOCKS) {
    syntax_slots(L, inf, mb, has_left, syn_vals + mb * SYN, syn_lens + mb * SYN);
    return;
  }
  const bool i4 = L.mb_i4[mb];
  const int cbp_c = inf[CBP_CHROMA];
  int lv[16];
  for (int k = 0; k < 16; ++k) lv[k] = 0;
  int nc_ctx = 0, max_coeff = 15;
  bool is_cdc = false, gate = true;
  if (j == 0) {                                   // luma DC (I16)
    for (int k = 0; k < 16; ++k) lv[k] = L.luma_dc[mb * 16 + k];
    nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, 0, 0);
    max_coeff = 16;
    gate = !i4;
  } else if (j <= 16) {                           // luma blocks, blkIdx order
    const int b = j - 1;
    if (i4) {
      for (int k = 0; k < 16; ++k) lv[k] = L.luma_i4[(mb * 16 + b) * 16 + k];
    } else {
      for (int k = 0; k < 15; ++k) lv[k] = L.luma_ac[(mb * 16 + b) * 15 + k];
    }
    nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[b], c_blk_x[b]);
    max_coeff = i4 ? 16 : 15;
    gate = i4 ? ((inf[GRP_ANY] >> (b >> 2)) & 1) : inf[CBP_LUMA];
  } else if (j <= 18) {                           // chroma DC
    const int* dc = j == 17 ? L.cb_dc : L.cr_dc;
    for (int k = 0; k < 4; ++k) lv[k] = dc[mb * 4 + k];
    is_cdc = true;
    max_coeff = 4;
    gate = cbp_c > 0;
  } else {                                        // chroma AC
    const int p = (j - 19) >> 2, q = (j - 19) & 3;
    const int* ac = p ? L.cr_ac : L.cb_ac;
    for (int k = 0; k < 15; ++k) lv[k] = ac[(mb * 4 + q) * 15 + k];
    const int off = p ? TC_CR : TC_CB;
    nc_ctx = nc_of(inf + off, linf ? linf + off : nullptr, 2, q >> 1, q & 1);
    gate = cbp_c == 2;
  }
  const int base = (mb * BLOCKS + j) * SLOTS;
  code_block(lv, nc_ctx, is_cdc, max_coeff, gate, values + base, lengths + base);
}

// --- K6: P slices -------------------------------------------------------

constexpr int P_BLOCKS = 26, P_HDR = 7;

struct PLevels {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  const int *i16_dc, *i16_ac;       // I16-in-P (tune=hq), else null
  const uint8_t* mb_intra;
};

// scratch word layout per MB (P pass 1 -> pass 2); TC_* as the intra's
enum { P_CBP = 24, P_CBP_CHROMA = 25, P_GRP = 26, P_INTRA = 27, P_CL15 = 28 };

template <bool INTRA>
__global__ void p_info_kernel(PLevels L, int* info, uint8_t* nnz, int nmb) {
  const int local = blockIdx.x * blockDim.x + threadIdx.x;   // session blockIdx.y
  if (local >= nmb) return;
  const int mb = blockIdx.y * nmb + local;
  int* o = info + mb * INFO;
  int grp = 0;
  for (int b = 0; b < 16; ++b) {        // blkIdx order
    int tc = 0;
    for (int k = 0; k < 16; ++k) tc += L.luma[(mb * 16 + b) * 16 + k] != 0;
    o[TC_LUMA + c_blk_y[b] * 4 + c_blk_x[b]] = tc;
    nnz[mb * 16 + c_blk_y[b] * 4 + c_blk_x[b]] = tc > 0;
    if (tc) grp |= 1 << (b >> 2);
  }
  bool intra = false, cl15 = false;
  if constexpr (INTRA) {
    // an intra MB's 4x4 counts come from its (cbp-gated) AC blocks
    intra = L.mb_intra[mb] != 0;
    if (intra) {
      for (int k = 0; k < 16 * 15; ++k) cl15 |= L.i16_ac[mb * 240 + k] != 0;
      for (int b = 0; b < 16; ++b) {
        int tc = 0;
        if (cl15)
          for (int k = 0; k < 15; ++k) tc += L.i16_ac[(mb * 16 + b) * 15 + k] != 0;
        o[TC_LUMA + c_blk_y[b] * 4 + c_blk_x[b]] = tc;
      }
    }
    o[P_INTRA] = intra;
    o[P_CL15] = cl15;
  }
  bool ac_any = false, dc_any = false;
  for (int k = 0; k < 60; ++k)
    ac_any |= (L.cb_ac[mb * 60 + k] != 0) | (L.cr_ac[mb * 60 + k] != 0);
  for (int k = 0; k < 4; ++k)
    dc_any |= (L.cb_dc[mb * 4 + k] != 0) | (L.cr_dc[mb * 4 + k] != 0);
  const int cbp_c = ac_any ? 2 : (dc_any ? 1 : 0);
  for (int q = 0; q < 4; ++q) {
    int tcb = 0, tcr = 0;
    if (cbp_c == 2) {
      for (int k = 0; k < 15; ++k) {
        tcb += L.cb_ac[(mb * 4 + q) * 15 + k] != 0;
        tcr += L.cr_ac[(mb * 4 + q) * 15 + k] != 0;
      }
    }
    o[TC_CB + q] = tcb;
    o[TC_CR + q] = tcr;
  }
  // an intra MB's cbp is its I16 pattern (the core zeroed its inter luma)
  o[P_CBP] = (intra ? (cl15 ? 15 : 0) : grp) + 16 * cbp_c;
  o[P_CBP_CHROMA] = cbp_c;
  o[P_GRP] = grp;
}

template <bool INTRA>
__device__ __forceinline__ bool p_coded(const PLevels& L, const int* info, int mb) {
  bool coded = L.mv[mb * 2] != 0 || L.mv[mb * 2 + 1] != 0 || info[mb * INFO + P_CBP] != 0;
  if constexpr (INTRA) coded |= info[mb * INFO + P_INTRA] != 0;
  return coded;
}

__device__ __forceinline__ void ue_slot(int v, int* val, int* len) {
  *val = v + 1;
  *len = ue_len(v);
}

__device__ __forceinline__ void se_slot(int v, int* val, int* len) {
  ue_slot(v > 0 ? 2 * v - 1 : -2 * v, val, len);
}

// MB header slots; the last MB of a row also codes the row's trailing run.
template <bool INTRA>
__device__ void p_header(const PLevels& L, const int* info, int mb, int c, int nc, int* vals,
                         int* lens, int* trail_val, int* trail_len) {
  int prev = -1;                        // last coded MB strictly before c
  for (int k = c - 1; k >= 0; --k)
    if (p_coded<INTRA>(L, info, mb - c + k)) { prev = k; break; }
  const bool coded = p_coded<INTRA>(L, info, mb);
  const int cbp = info[mb * INFO + P_CBP];
  const int lx = c ? L.mv[mb * 2 - 1] : 0, ly = c ? L.mv[mb * 2 - 2] : 0;
  ue_slot(c - prev - 1, vals + 0, lens + 0);
  ue_slot(0, vals + 1, lens + 1);
  se_slot(L.mv[mb * 2 + 1] - lx, vals + 2, lens + 2);
  se_slot(L.mv[mb * 2] - ly, vals + 3, lens + 3);
  ue_slot(c_cbp_cn_inter[cbp], vals + 4, lens + 4);
  vals[5] = 1; lens[5] = 0;
  se_slot(0, vals + 6, lens + 6);
  if (cbp == 0) lens[6] = 0;
  if constexpr (INTRA) {
    if (info[mb * INFO + P_INTRA]) {
      // I_16x16 in a P slice: ue(5 + the I16 type), DC prediction with
      // the cbp folded in; no mvd, no cbp; chroma mode DC; a qp delta
      ue_slot(8 + 4 * (cbp >> 4) + ((cbp & 15) ? 12 : 0), vals + 1, lens + 1);
      lens[2] = lens[3] = lens[4] = 0;
      vals[4] = c_cbp_cn_inter[0] + 1;
      lens[5] = 1;
      lens[6] = 1;
    }
  }
  if (!coded)
    for (int k = 0; k < P_HDR; ++k) lens[k] = 0;
  if (c == nc - 1) {
    const int last = coded ? c : prev;
    const int trail = nc - 1 - last;
    int v, l;
    ue_slot(trail, &v, &l);
    *trail_val = v;
    *trail_len = trail > 0 ? l : 0;
  }
}

template <bool INTRA>
__global__ void p_slots_kernel(PLevels L, const int* info, int* values, int* lengths,
                               int* hdr_vals, int* hdr_lens, int* trail_vals, int* trail_lens,
                               int nmb, int nc) {
  constexpr int NB = P_BLOCKS + (INTRA ? 1 : 0);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= nmb * (NB + 1)) return;
  const int mb = blockIdx.y * nmb + gid / (NB + 1), c = mb % nc;   // session blockIdx.y
  const int jb = gid % (NB + 1);           // block slot (NB: the header)
  if (jb == NB) {
    const int r = mb / nc;
    p_header<INTRA>(L, info, mb, c, nc, hdr_vals + mb * P_HDR, hdr_lens + mb * P_HDR,
                    trail_vals + r, trail_lens + r);
    return;
  }
  const int* inf = info + mb * INFO;
  const int* linf = c ? info + (mb - 1) * INFO : nullptr;
  const int cbp_c = inf[P_CBP_CHROMA];
  int lv[16];
  for (int k = 0; k < 16; ++k) lv[k] = 0;
  int nc_ctx = 0, max_coeff = 15;
  bool is_cdc = false, gate;
  const int j = INTRA ? jb - 1 : jb;       // the 26-block layout's index
  if (INTRA && jb == 0) {                         // Intra16x16DCLevel
    for (int k = 0; k < 16; ++k) lv[k] = L.i16_dc[mb * 16 + k];
    nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, 0, 0);
    max_coeff = 16;
    gate = inf[P_INTRA] != 0;
  } else if (INTRA && j < 16 && inf[P_INTRA]) {   // an intra MB's luma AC
    for (int k = 0; k < 15; ++k) lv[k] = L.i16_ac[(mb * 16 + j) * 15 + k];
    nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[j], c_blk_x[j]);
    max_coeff = 15;
    gate = inf[P_CL15] != 0;
  } else if (j < 16) {                            // luma, blkIdx order
    for (int k = 0; k < 16; ++k) lv[k] = L.luma[(mb * 16 + j) * 16 + k];
    nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[j], c_blk_x[j]);
    max_coeff = 16;
    gate = (inf[P_GRP] >> (j >> 2)) & 1;
  } else if (j < 18) {                            // chroma DC
    const int* dc = j == 16 ? L.cb_dc : L.cr_dc;
    for (int k = 0; k < 4; ++k) lv[k] = dc[mb * 4 + k];
    is_cdc = true;
    max_coeff = 4;
    gate = cbp_c > 0;
  } else {                                        // chroma AC
    const int p = (j - 18) >> 2, q = (j - 18) & 3;
    const int* ac = p ? L.cr_ac : L.cb_ac;
    for (int k = 0; k < 15; ++k) lv[k] = ac[(mb * 4 + q) * 15 + k];
    const int off = p ? TC_CR : TC_CB;
    nc_ctx = nc_of(inf + off, linf ? linf + off : nullptr, 2, q >> 1, q & 1);
    gate = cbp_c == 2;
  }
  const int base = (mb * NB + jb) * SLOTS;
  code_block(lv, nc_ctx, is_cdc, max_coeff, gate, values + base, lengths + base);
}

// --- the qp chain (tune=hq full tier) -----------------------------------

// kind 0: intra slots (codes: I16, or cbp != 0), slot 19 of 20;
// kind 1: P headers (codes: cbp != 0 or I16-in-P), slot 6 of 7.
__global__ void qp_chain_kernel(const int* __restrict__ qp_map, const uint8_t* __restrict__ flag,
                                const int* __restrict__ info, int* vals, int* lens, int* qp_sum,
                                const int* __restrict__ qp_dev, int nr, int nc, int slice_qp,
                                int kind, int rows_per_sum) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= nr) return;                  // whole warps: blockDim is a multiple of 32
  const int sq = qp_dev ? *qp_dev : slice_qp;
  const int stride = kind ? P_HDR : SYN, slot = kind ? 6 : 19;
  const int per = (nc + 31) / 32, c0 = min(lane * per, nc), c1 = min(c0 + per, nc);
  auto codes = [&](int c) {
    const int mb = row * nc + c;
    const int* inf = info + mb * INFO;
    if (kind) return inf[P_CBP] > 0 || (flag && flag[mb]);
    const bool i4 = flag[mb] != 0;
    const bool any = (i4 ? inf[CBP_LUMA4] > 0 : inf[CBP_LUMA] != 0) || inf[CBP_CHROMA] > 0;
    return !i4 || any;
  };
  // the last coding MB of each lane's segment, max-scanned over the lanes
  int last = -1;
  for (int c = c0; c < c1; ++c)
    if (codes(c)) last = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, last, o);
    if (lane >= o) last = max(last, v);
  }
  int j = __shfl_up_sync(0xffffffffu, last, 1);
  if (lane == 0) j = -1;
  const int* q = qp_map + row * nc;
  int sum = 0;
  for (int c = c0; c < c1; ++c) {
    const int prev = j >= 0 ? q[j] : sq;
    const bool cd = codes(c);
    if (cd) j = c;
    sum += j >= 0 ? q[j] : sq;
    const int d = q[c] - prev;
    int v, l;
    se_slot(d, &v, &l);
    vals[(row * nc + c) * stride + slot] = v;
    lens[(row * nc + c) * stride + slot] = cd ? l : 0;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) atomicAdd(qp_sum + row / rows_per_sum, sum);
}

}  // namespace

extern "C" int cavlc_upload_tables(const int* ct, const int* tz, const int* tzc,
                                   const int* rb, const int* cbp_cn,
                                   const int* cbp_cn_inter) {
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_ct, ct, sizeof(c_ct))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_tz, tz, sizeof(c_tz))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_tzc, tzc, sizeof(c_tzc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_rb, rb, sizeof(c_rb))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_cbp_cn, cbp_cn, sizeof(c_cbp_cn))) != cudaSuccess) return e;
  return cudaMemcpyToSymbol(c_cbp_cn_inter, cbp_cn_inter, sizeof(c_cbp_cn_inter));
}

// ns: sessions (1 = one frame), each nr x nc MBs, stacked on every
// array's leading axis (scratch included).
extern "C" int cavlc_slots_launch(
    const int* luma_dc, const int* luma_ac, const int* cb_dc, const int* cb_ac,
    const int* cr_dc, const int* cr_ac, const int* pred_mode, const uint8_t* mb_i4,
    const int* i4_modes, const int* luma_i4, int* values, int* lengths,
    int* syn_vals, int* syn_lens, int* scratch, int nr, int nc, int ns,
    cudaStream_t stream) {
  const int nmb = nr * nc;
  if (nmb <= 0 || ns <= 0) return 0;
  const Levels L{luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                 mb_i4, i4_modes, luma_i4};
  mb_info_kernel<<<dim3((nmb + 127) / 128, ns), 128, 0, stream>>>(L, scratch, nmb);
  int e = dngd_last_error();
  if (e) return e;
  const int n = nmb * (BLOCKS + 1);
  slots_kernel<<<dim3((n + 127) / 128, ns), 128, 0, stream>>>(L, scratch, values, lengths,
                                                              syn_vals, syn_lens, nmb, nc);
  return dngd_last_error();
}

extern "C" int cavlc_p_slots_launch(const int* mv, const int* luma, const int* cb_dc,
                                    const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                    int* values, int* lengths, int* hdr_vals, int* hdr_lens,
                                    int* trail_vals, int* trail_lens, uint8_t* nnz,
                                    int* scratch, int nr, int nc, int ns,
                                    cudaStream_t stream) {
  const int nmb = nr * nc;
  if (nmb <= 0 || ns <= 0) return 0;
  const PLevels L{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, nullptr, nullptr, nullptr};
  p_info_kernel<false><<<dim3((nmb + 127) / 128, ns), 128, 0, stream>>>(L, scratch, nnz, nmb);
  int e = dngd_last_error();
  if (e) return e;
  const int n = nmb * (P_BLOCKS + 1);
  p_slots_kernel<false><<<dim3((n + 127) / 128, ns), 128, 0, stream>>>(
      L, scratch, values, lengths, hdr_vals, hdr_lens, trail_vals, trail_lens, nmb, nc);
  return dngd_last_error();
}

// The I16-in-P form: 27 block slots per MB.
extern "C" int cavlc_p_slots_i_launch(const int* mv, const int* luma, const int* cb_dc,
                                      const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                      const int* i16_dc, const int* i16_ac,
                                      const uint8_t* mb_intra, int* values, int* lengths,
                                      int* hdr_vals, int* hdr_lens, int* trail_vals,
                                      int* trail_lens, uint8_t* nnz, int* scratch, int nr,
                                      int nc, cudaStream_t stream) {
  const int nmb = nr * nc;
  if (nmb <= 0) return 0;
  const PLevels L{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, i16_dc, i16_ac, mb_intra};
  p_info_kernel<true><<<(nmb + 127) / 128, 128, 0, stream>>>(L, scratch, nnz, nmb);
  int e = dngd_last_error();
  if (e) return e;
  const int n = nmb * (P_BLOCKS + 2);
  p_slots_kernel<true><<<(n + 127) / 128, 128, 0, stream>>>(
      L, scratch, values, lengths, hdr_vals, hdr_lens, trail_vals, trail_lens, nmb, nc);
  return dngd_last_error();
}

// After the slot coder of `kind` (0 intra, 1 P) on the same stream and
// scratch: flag is mb_i4 (intra) or mb_intra (P, may be null); vals/lens
// the MB syntax or header slots; qp_sum nsum ints, the sum of each of nsum
// equal bands of rows (the spatial shards'; 1 = the frame's); qp_dev the
// slice qp on the card, or null for slice_qp.
extern "C" int cavlc_qp_chain_launch(const int* qp_map, const uint8_t* flag, const int* scratch,
                                     int* vals, int* lens, int* qp_sum, const int* qp_dev,
                                     int nr, int nc, int slice_qp, int kind, int nsum,
                                     cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  if ((!kind && !flag) || nsum <= 0 || nr % nsum) return cudaErrorInvalidValue;
  int e;
  if ((e = cudaMemsetAsync(qp_sum, 0, nsum * sizeof(int), stream))) return e;
  const int threads = 128, rows_per_block = threads / 32;
  qp_chain_kernel<<<(nr + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
      qp_map, flag, scratch, vals, lens, qp_sum, qp_dev, nr, nc, slice_qp, kind, nr / nsum);
  return dngd_last_error();
}
