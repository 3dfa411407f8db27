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
// What bounds them: the bytes of the slots and how they are written, not
// the coder's arithmetic.  A 1080p P frame reads ~12 MB of levels and
// writes ~58 MB of slots (0.021 ms at 3.35 TB/s); the per-block loops
// (level VLC with adaptive suffixLength, run_before with zerosLeft) are
// ~10^3 instructions a block, ~7 us of issue over the card.
// K6 and K2 share one design (one pass each, below): a CTA per segment of
// a row stages its levels in shared memory with 16-byte loads, a warp per
// MB counts total_coeff by ballots, a thread per 4x4 block codes it into
// a shared slot tile and the tile goes out as one contiguous range (K6:
// 16-byte stores; K2: a TMA bulk store); K6's skip runs are a max-scan of
// coded MBs along the row.  The block coder walks its nonzeros through a
// bit mask and keeps no dynamically indexed array (no local memory).  K6
// comes within ~3x of the bytes bound on an H100 (chip_smoke.py
// k1k6-pairs).
#include "common.cuh"

namespace {

constexpr int BLOCKS = 27, SLOTS = 34, SYN = 20;
constexpr int INFO = 32;     // per-MB info words (shared memory, the qp chain's scratch)

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

// per-MB info words (shared memory; CBP_* also the scratch words the
// qp chain reads)
enum { TC_LUMA = 0, TC_CB = 16, TC_CR = 20, CBP_LUMA = 24, CBP_LUMA4 = 25,
       CBP_CHROMA = 26, GRP_ANY = 27 };

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

// Code one block's n <= 16 scan-order levels into 34 slots.  The levels
// are read where they lie (shared memory for K6); the nonzeros are walked
// from the highest frequency down through a bit mask, so the coder keeps
// no dynamically indexed array of its own.
__device__ void code_block(const int* lv, int n, int nc, bool is_cdc, int max_coeff,
                           bool gate, int* vals, int* lens) {
  unsigned mask = 0;
  for (int k = 0; k < n; ++k) mask |= (lv[k] != 0 ? 1u : 0u) << k;
  const int total = __popc(mask);
  // rv[0..2]: the three highest-frequency nonzeros (0 past total)
  int rv[3] = {0, 0, 0};
  unsigned m = mask;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (m) {
      const int p = 31 - __clz(m);
      rv[i] = lv[p];
      m &= ~(1u << p);
    }
  }
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
  // remaining levels, highest frequency first, past the trailing ones
  m = mask;
  for (int i = 0; i < t1; ++i) m &= ~(1u << (31 - __clz(m)));
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  const int n_levels = total - t1;
  for (int j = 0; j < 16; ++j) {
    if (j >= n_levels) { vals[2 + j] = 0; lens[2 + j] = 0; continue; }
    const int p = 31 - __clz(m);
    m &= ~(1u << p);
    const int level = lv[p];
    int code = level > 0 ? 2 * level - 2 : -2 * level - 1;
    if (j == 0 && t1 < 3) code -= 2;
    unsigned v;
    int l;
    level_vlc(code, sl, &v, &l);
    vals[2 + j] = (int)v; lens[2 + j] = l;
    int sl_new = max(sl, 1);
    if (abs(level) > (3 << max(sl_new - 1, 0)) && sl_new < 6) ++sl_new;
    sl = sl_new;
  }
  // total_zeros
  const int top = total > 0 ? 31 - __clz(mask) : 0;     // rp[0]
  const int tz = total > 0 ? top + 1 - total : 0;
  const int tzi = min(max(total - 1, 0), 15);
  const int tzp = is_cdc ? c_tzc[min(tzi, 2) * 4 + min(max(tz, 0), 3)]
                         : c_tz[tzi * 16 + min(max(tz, 0), 15)];
  const bool tz_emit = total > 0 && total < max_coeff;
  vals[18] = tz_emit ? tzp & 0xFFFF : 0;
  lens[18] = tz_emit ? tzp >> 16 : 0;
  // run_before: cur = rp[k], next = rp[k + 1] (rp[j] = 0 for j >= total)
  int zeros_left = tz, cur = top;
  m = total > 0 ? mask & ~(1u << top) : 0u;
  for (int k = 0; k < 15; ++k) {
    const int next = m ? 31 - __clz(m) : 0;
    if (m) m &= ~(1u << next);
    const int run = min(max(cur - next - 1, 0), 14);
    const bool active = k <= total - 2 && zeros_left > 0;
    int rbp = 0;
    if (active) {
      const int row = min(max(min(zeros_left, 7) - 1, 0), 6);
      rbp = c_rb[row < 6 ? row * 7 + min(run, 6) : 42 + run];
    }
    vals[19 + k] = rbp & 0xFFFF;
    lens[19 + k] = rbp >> 16;
    zeros_left -= run;
    cur = next;
  }
  if (!gate)
    for (int s = 0; s < SLOTS; ++s) lens[s] = 0;
}

__device__ int ue_len(int code_num) { return 2 * (32 - __clz(code_num + 1)) - 1; }

// --- K6: P slices -------------------------------------------------------
//
// One kernel.  A CTA takes a segment of one MB row (up to P_SEG_CHUNKS
// chunks of P_G MBs; the session is blockIdx.y):
//  A. the coded flag (mv != 0, any level, or intra) of every MB of the
//     row up to the segment's end, from 16-byte loads, and the row's skip
//     runs as a warp max-scan of the coded MBs' indices (as the qp chain);
//  B. per chunk: the chunk's levels and the MB to its left (the halo, for
//     the nC of its left column) staged in shared memory with 16-byte
//     loads; per MB a warp counts total_coeff by ballots over the
//     coefficients and derives the cbp, the gates and the nnz flags; a
//     thread per 4x4 block codes its slots into a shared tile that goes
//     out whole as 16-byte coalesced stores (a chunk's slots are one
//     contiguous range), and a thread per MB writes its header.

constexpr int P_BLOCKS = 26, P_HDR = 7;
constexpr int P_G = 8;            // MBs a chunk
constexpr int P_SEG_CHUNKS = 4;   // chunks a CTA
constexpr int P_THREADS = 256;
constexpr int P_MAX_NC = 512;     // MBs a row (8192 samples)

struct PLevels {
  const int *mv, *luma, *cb_dc, *cb_ac, *cr_dc, *cr_ac;
  const int *i16_dc, *i16_ac;       // I16-in-P (tune=hq), else null
  const uint8_t* mb_intra;
};

// per-MB info words (smem), TC_* as the intra's; P_CBP is also the word
// the qp chain reads from the scratch
enum { P_CBP = 24, P_CBP_CHROMA = 25, P_GRP = 26, P_INTRA = 27, P_CL15 = 28 };

template <bool INTRA>
struct PSmem {
  static constexpr int NB = P_BLOCKS + (INTRA ? 1 : 0);
  static constexpr int NI = INTRA ? P_G + 1 : 1;
  alignas(16) int vals[P_G][NB][SLOTS];   // the chunk's slot tile
  alignas(16) int lens[P_G][NB][SLOTS];
  // levels of the chunk's MBs at 1..P_G, the halo MB at 0
  alignas(16) int luma[P_G + 1][256];
  alignas(16) int cbdc[P_G + 1][4];
  alignas(16) int crdc[P_G + 1][4];
  alignas(16) int cbac[P_G + 1][60];
  alignas(16) int crac[P_G + 1][60];
  alignas(16) int i16dc[NI][16];
  alignas(16) int i16ac[NI][240];
  int intra[NI];
  int info[P_G + 1][INFO];
  short prev[P_MAX_NC];             // last coded MB strictly before c, -1 if none
  unsigned char coded[P_MAX_NC];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// flags[c] = 1 where MB c's n levels (of a, MB-major, mbs MBs) hold a nonzero
__device__ void mark_nonzero(const int* __restrict__ a, int n, int mbs, unsigned char* flags) {
  if ((n & 3) == 0 && aligned16(a)) {
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int per = n >> 2;
    for (int i = threadIdx.x; i < mbs * per; i += P_THREADS) {
      const int4 v = a4[i];
      if (v.x | v.y | v.z | v.w) flags[i / per] = 1;
    }
  } else {
    for (int i = threadIdx.x; i < mbs * n; i += P_THREADS)
      if (a[i]) flags[i / n] = 1;
  }
}

// n ints from global to shared (16-byte loads where both are aligned)
__device__ void stage(int* dst, const int* __restrict__ src, int n) {
  if ((n & 3) == 0 && aligned16(src) && aligned16(dst)) {
    for (int i = threadIdx.x; i < n / 4; i += P_THREADS)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += P_THREADS) dst[i] = src[i];
  }
}

// n ints from shared to global (16-byte stores where aligned)
__device__ void copy_out(int* dst, const int* src, int n) {
  if ((n & 3) == 0 && aligned16(dst)) {
    for (int i = threadIdx.x; i < n / 4; i += P_THREADS)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += P_THREADS) dst[i] = src[i];
  }
}

// The tile's copy-out by the Tensor Memory Accelerator: one thread hands
// a contiguous range of shared memory to a bulk store (16-byte aligned
// ends, a multiple of 16 bytes) and the CTA goes on; the tile is written
// again only after the copy has read it.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
               : "memory");
#else
  for (unsigned i = 0; i < bytes; ++i)
    static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
#endif
}

__device__ __forceinline__ void bulk_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

// wait until the committed bulk stores have read their sources (READ) or
// finished
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
#if defined(__CUDA_ARCH__)
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#endif
}

// this thread's shared-memory writes, seen by the bulk copies after a barrier
__device__ __forceinline__ void fence_async_shared() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// One MB's info by one warp: total_coeff per block (ballots over the
// coefficients), cbp, gates; for a chunk MB (nnz non-null) its nnz flags
// and the scratch's P_CBP word.
template <bool INTRA>
__device__ void p_mb_info(PSmem<INTRA>& s, int m, int lane, uint8_t* nnz, int* scratch) {
  const int* lu = s.luma[m];
  int tc = 0;                       // lane b < 16: luma block b (blkIdx)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned bal = __ballot_sync(0xffffffffu, lu[k * 32 + lane] != 0);
    if (lane == 2 * k) tc = __popc(bal & 0xffffu);
    if (lane == 2 * k + 1) tc = __popc(bal >> 16);
  }
  const unsigned nzb = __ballot_sync(0xffffffffu, lane < 16 && tc > 0);
  const int grp = ((nzb & 0xfu) ? 1 : 0) | ((nzb & 0xf0u) ? 2 : 0) |
                  ((nzb & 0xf00u) ? 4 : 0) | ((nzb & 0xf000u) ? 8 : 0);
  // chroma: lanes 0-7 count an AC block (cb then cr), lanes 8-15 read a DC level
  int ctc = 0, dcv = 0;
  if (lane < 8) {
    const int* a = ((lane >> 2) ? s.crac[m] : s.cbac[m]) + (lane & 3) * 15;
    for (int k = 0; k < 15; ++k) ctc += a[k] != 0;
  } else if (lane < 16) {
    dcv = ((lane >> 2) & 1 ? s.crdc[m] : s.cbdc[m])[lane & 3];
  }
  const bool ac_any = __ballot_sync(0xffffffffu, ctc > 0) != 0;
  const bool dc_any = __ballot_sync(0xffffffffu, dcv != 0) != 0;
  const int cbp_c = ac_any ? 2 : (dc_any ? 1 : 0);
  bool intra = false, cl15 = false;
  int itc = 0;
  if constexpr (INTRA) {
    // an intra MB's 4x4 counts come from its (cbp-gated) AC blocks
    intra = s.intra[m] != 0;
    if (intra) {
      if (lane < 16)
        for (int k = 0; k < 15; ++k) itc += s.i16ac[m][lane * 15 + k] != 0;
      cl15 = __ballot_sync(0xffffffffu, itc > 0) != 0;
    }
  }
  int* o = s.info[m];
  if (lane < 16) {
    const int rb = c_blk_y[lane] * 4 + c_blk_x[lane];
    o[TC_LUMA + rb] = intra ? (cl15 ? itc : 0) : tc;
    if (nnz) nnz[rb] = tc > 0;
  }
  if (lane < 8) o[((lane >> 2) ? TC_CR : TC_CB) + (lane & 3)] = cbp_c == 2 ? ctc : 0;
  if (lane == 0) {
    // an intra MB's cbp is its I16 pattern (the core zeroed its inter luma)
    const int cbp = (intra ? (cl15 ? 15 : 0) : grp) + 16 * cbp_c;
    o[P_CBP] = cbp;
    o[P_CBP_CHROMA] = cbp_c;
    o[P_GRP] = grp;
    o[P_INTRA] = intra;
    o[P_CL15] = cl15;
    if (scratch) scratch[P_CBP] = cbp;
  }
}

__device__ __forceinline__ void ue_slot(int v, int* val, int* len) {
  *val = v + 1;
  *len = ue_len(v);
}

__device__ __forceinline__ void se_slot(int v, int* val, int* len) {
  ue_slot(v > 0 ? 2 * v - 1 : -2 * v, val, len);
}

// MB header slots (prev: the last coded MB before c in the row, or -1);
// the last MB of a row also codes the row's trailing run.
template <bool INTRA>
__device__ void p_header(const PLevels& L, const int* inf, int mb, int c, int nc, int prev,
                         bool coded, int* vals, int* lens, int* trail_val, int* trail_len) {
  const int cbp = inf[P_CBP];
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
    if (inf[P_INTRA]) {
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
__global__ void __launch_bounds__(P_THREADS) p_slots_kernel(
    PLevels L, int* scratch, uint8_t* nnz, int* values, int* lengths, int* hdr_vals,
    int* hdr_lens, int* trail_vals, int* trail_lens, int nr, int nc, int segs) {
  using S = PSmem<INTRA>;
  constexpr int NB = S::NB;
  extern __shared__ int4 p_dyn[];
  S& s = *reinterpret_cast<S*>(p_dyn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / segs, seg = blockIdx.x % segs;
  const int trow = blockIdx.y * nr + row;           // the row of the stack
  const int rowmb = trow * nc;                      // its first MB
  const int nchunks = (nc + P_G - 1) / P_G;
  const int ch0 = seg * P_SEG_CHUNKS, ch1 = min(ch0 + P_SEG_CHUNKS, nchunks);
  if (ch0 >= ch1) return;
  const int c_end = min(ch1 * P_G, nc);

  // --- A: coded flags of MBs [0, c_end), the skip-run scan -------------
  for (int c = tid; c < c_end; c += P_THREADS) {
    const int mb = rowmb + c;
    bool cd = L.mv[2 * mb] != 0 || L.mv[2 * mb + 1] != 0;
    if constexpr (INTRA) cd = cd || L.mb_intra[mb] != 0;
    s.coded[c] = cd;
  }
  __syncthreads();
  mark_nonzero(L.luma + (size_t)rowmb * 256, 256, c_end, s.coded);
  mark_nonzero(L.cb_ac + (size_t)rowmb * 60, 60, c_end, s.coded);
  mark_nonzero(L.cr_ac + (size_t)rowmb * 60, 60, c_end, s.coded);
  mark_nonzero(L.cb_dc + (size_t)rowmb * 4, 4, c_end, s.coded);
  mark_nonzero(L.cr_dc + (size_t)rowmb * 4, 4, c_end, s.coded);
  __syncthreads();
  if (warp == 0) {
    // the last coded MB of each lane's slice, max-scanned over the lanes
    const int per = (c_end + 31) / 32, a0 = min(lane * per, c_end), a1 = min(a0 + per, c_end);
    int last = -1;
    for (int c = a0; c < a1; ++c)
      if (s.coded[c]) last = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, last, o);
      if (lane >= o) last = max(last, v);
    }
    int j = __shfl_up_sync(0xffffffffu, last, 1);
    if (lane == 0) j = -1;
    for (int c = a0; c < a1; ++c) {
      s.prev[c] = (short)j;
      if (s.coded[c]) j = c;
    }
  }

  // --- B: the segment's chunks ----------------------------------------
  for (int ch = ch0; ch < ch1; ++ch) {
    const int c0 = ch * P_G, gc = min(P_G, nc - c0);
    const int h = c0 > 0 ? 1 : 0;                   // a halo MB to the left
    const int m0 = 1 - h, n = gc + h;               // smem slots m0 .. gc
    const size_t first = (size_t)rowmb + c0 - h;
    __syncthreads();                                // the previous chunk is out
    stage(s.luma[m0], L.luma + first * 256, n * 256);
    stage(s.cbdc[m0], L.cb_dc + first * 4, n * 4);
    stage(s.crdc[m0], L.cr_dc + first * 4, n * 4);
    stage(s.cbac[m0], L.cb_ac + first * 60, n * 60);
    stage(s.crac[m0], L.cr_ac + first * 60, n * 60);
    if constexpr (INTRA) {
      stage(s.i16dc[m0], L.i16_dc + first * 16, n * 16);
      stage(s.i16ac[m0], L.i16_ac + first * 240, n * 240);
      for (int i = tid; i < n; i += P_THREADS) s.intra[m0 + i] = L.mb_intra[first + i];
    }
    __syncthreads();
    for (int m = m0 + warp; m <= gc; m += P_THREADS / 32) {
      const size_t mb = (size_t)rowmb + c0 + m - 1;
      p_mb_info<INTRA>(s, m, lane, m ? nnz + mb * 16 : nullptr,
                       m ? scratch + mb * INFO : nullptr);
    }
    __syncthreads();
    if (tid < gc * NB) {
      const int m = tid / NB + 1, jb = tid % NB, c = c0 + m - 1;
      const int* inf = s.info[m];
      const int* linf = c ? s.info[m - 1] : nullptr;
      const int cbp_c = inf[P_CBP_CHROMA];
      const int* lv;
      int len = 15, nc_ctx = 0, max_coeff = 15;
      bool is_cdc = false, gate;
      const int j = INTRA ? jb - 1 : jb;            // the 26-block layout's index
      if (INTRA && jb == 0) {                       // Intra16x16DCLevel
        lv = s.i16dc[INTRA ? m : 0];
        len = 16;
        nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, 0, 0);
        max_coeff = 16;
        gate = inf[P_INTRA] != 0;
      } else if (INTRA && j < 16 && inf[P_INTRA]) { // an intra MB's luma AC
        lv = s.i16ac[INTRA ? m : 0] + j * 15;
        nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[j],
                       c_blk_x[j]);
        gate = inf[P_CL15] != 0;
      } else if (j < 16) {                          // luma, blkIdx order
        lv = s.luma[m] + j * 16;
        len = 16;
        nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[j],
                       c_blk_x[j]);
        max_coeff = 16;
        gate = (inf[P_GRP] >> (j >> 2)) & 1;
      } else if (j < 18) {                          // chroma DC
        lv = j == 16 ? s.cbdc[m] : s.crdc[m];
        len = 4;
        is_cdc = true;
        max_coeff = 4;
        gate = cbp_c > 0;
      } else {                                      // chroma AC
        const int p = (j - 18) >> 2, q = (j - 18) & 3;
        lv = (p ? s.crac[m] : s.cbac[m]) + q * 15;
        const int off = p ? TC_CR : TC_CB;
        nc_ctx = nc_of(inf + off, linf ? linf + off : nullptr, 2, q >> 1, q & 1);
        gate = cbp_c == 2;
      }
      code_block(lv, len, nc_ctx, is_cdc, max_coeff, gate, s.vals[m - 1][jb], s.lens[m - 1][jb]);
    } else if (tid >= P_G * NB && tid < P_G * NB + gc) {
      const int m = tid - P_G * NB + 1, c = c0 + m - 1, mb = rowmb + c;
      p_header<INTRA>(L, s.info[m], mb, c, nc, s.prev[c], s.coded[c] != 0,
                      hdr_vals + (size_t)mb * P_HDR, hdr_lens + (size_t)mb * P_HDR,
                      trail_vals + trow, trail_lens + trow);
    }
    __syncthreads();
    const size_t out0 = ((size_t)rowmb + c0) * NB * SLOTS;
    copy_out(values + out0, &s.vals[0][0][0], gc * NB * SLOTS);
    copy_out(lengths + out0, &s.lens[0][0][0], gc * NB * SLOTS);
  }
}

template <bool INTRA>
int launch_p_slots(const PLevels& L, int* scratch, uint8_t* nnz, int* values, int* lengths,
                   int* hdr_vals, int* hdr_lens, int* trail_vals, int* trail_lens, int nr,
                   int nc, int ns, cudaStream_t stream) {
  if (nc > P_MAX_NC) return cudaErrorInvalidValue;
  const int nchunks = (nc + P_G - 1) / P_G;
  const int segs = (nchunks + P_SEG_CHUNKS - 1) / P_SEG_CHUNKS;
  const int smem = (int)sizeof(PSmem<INTRA>);
  const cudaError_t e = cudaFuncSetAttribute(
      p_slots_kernel<INTRA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  p_slots_kernel<INTRA><<<dim3(nr * segs, ns), P_THREADS, smem, stream>>>(
      L, scratch, nnz, values, lengths, hdr_vals, hdr_lens, trail_vals, trail_lens, nr, nc,
      segs);
  return dngd_last_error();
}

// --- K2: intra slices (one pass, K6's design) ---------------------------
//
// A CTA takes a segment of one MB row (up to P_SEG_CHUNKS chunks of P_G
// MBs; the session is blockIdx.y).  Per chunk: the chunk's levels and the
// MB to its left (the halo: its total_coeff for the nC of the left
// column, its I4 modes for the left predictors) staged in shared memory
// with 16-byte loads; per MB a warp counts total_coeff by ballots over the
// I4 levels (and a lane a block over the I16 AC) and derives the cbp and
// the gates; a thread per 4x4 block codes its slots into a shared tile and
// a thread per MB its 20 syntax slots.  A chunk's slots are one contiguous
// range: the block slots' tiles go out by a bulk store of the Tensor
// Memory Accelerator while the CTA stages and counts the next chunk
// (16-byte coalesced stores where the range is not 16-byte aligned), the
// syntax tile by 16-byte stores.  The qp chain's scratch words (CBP_*)
// are written where a scratch is given.

// Six MBs a chunk keep the CTA at ~65 KB of shared memory and 80
// registers a thread, so three CTAs share an SM and one's copy-out and
// staging overlap another's coding (eight MBs a chunk at two CTAs an SM
// takes about twice as long: the "g8" cut of chip_smoke.py k2k8-split).
constexpr int I_G = 6;            // MBs a chunk
constexpr int I_SEG_CHUNKS = 4;   // chunks a CTA
constexpr int I_MINB = 3;         // CTAs an SM

struct ISmem {
  alignas(16) int vals[I_G][BLOCKS][SLOTS];   // the chunk's slot tiles
  alignas(16) int lens[I_G][BLOCKS][SLOTS];
  alignas(16) int syn_vals[I_G][SYN];
  alignas(16) int syn_lens[I_G][SYN];
  // levels of the chunk's MBs at 1..I_G, the halo MB at 0
  // I4 levels a 4x4 block a row of 17: the threads coding neighbouring
  // blocks read distinct banks
  alignas(16) int li4[I_G + 1][16][17];
  alignas(16) int lac[I_G + 1][240];
  alignas(16) int ldc[I_G + 1][16];
  alignas(16) int cbdc[I_G + 1][4];
  alignas(16) int crdc[I_G + 1][4];
  alignas(16) int cbac[I_G + 1][60];
  alignas(16) int crac[I_G + 1][60];
  alignas(16) int modes[I_G + 1][16];
  int pred[I_G + 1];
  int i4[I_G + 1];
  int info[I_G + 1][INFO];
};

// n MBs' I4 levels from global to the rows of 17 (16-byte loads where the
// source is aligned)
__device__ void stage_i4(int* dst, const int* __restrict__ src, int n) {
  if (aligned16(src)) {
    for (int i = threadIdx.x; i < n * 64; i += P_THREADS) {
      const int4 v = reinterpret_cast<const int4*>(src)[i];
      int* d = dst + (i >> 2) * 17 + (i & 3) * 4;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < n * 256; i += P_THREADS) dst[(i >> 4) * 17 + (i & 15)] = src[i];
  }
}

// One MB's info by one warp (TC_* raster grids, cbp, gates); for a chunk
// MB with a scratch, the qp chain's words.
__device__ void i_mb_info(ISmem& s, int m, int lane, int* scratch) {
  int tc4 = 0;                      // lane b < 16: I4 block b (blkIdx)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned bal =
        __ballot_sync(0xffffffffu, s.li4[m][2 * k + (lane >> 4)][lane & 15] != 0);
    if (lane == 2 * k) tc4 = __popc(bal & 0xffffu);
    if (lane == 2 * k + 1) tc4 = __popc(bal >> 16);
  }
  const unsigned nzb = __ballot_sync(0xffffffffu, lane < 16 && tc4 > 0);
  const int grp = ((nzb & 0xfu) ? 1 : 0) | ((nzb & 0xf0u) ? 2 : 0) |
                  ((nzb & 0xf00u) ? 4 : 0) | ((nzb & 0xf000u) ? 8 : 0);
  const int* la = s.lac[m];
  bool acn = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = k * 32 + lane;
    acn |= i < 240 && la[i] != 0;
  }
  const bool cbp_luma = __ballot_sync(0xffffffffu, acn) != 0;
  int tc16 = 0;                     // lane b < 16: I16 AC block b (stride 15: no conflicts)
  if (lane < 16 && cbp_luma)
    for (int k = 0; k < 15; ++k) tc16 += la[lane * 15 + k] != 0;
  // chroma: lanes 0-7 count an AC block (cb then cr), lanes 8-15 read a DC level
  int ctc = 0, dcv = 0;
  if (lane < 8) {
    const int* a = ((lane >> 2) ? s.crac[m] : s.cbac[m]) + (lane & 3) * 15;
    for (int k = 0; k < 15; ++k) ctc += a[k] != 0;
  } else if (lane < 16) {
    dcv = ((lane >> 2) & 1 ? s.crdc[m] : s.cbdc[m])[lane & 3];
  }
  const bool ac_any = __ballot_sync(0xffffffffu, ctc > 0) != 0;
  const bool dc_any = __ballot_sync(0xffffffffu, dcv != 0) != 0;
  const int cbp_c = ac_any ? 2 : (dc_any ? 1 : 0);
  int* o = s.info[m];
  if (lane < 16) o[TC_LUMA + c_blk_y[lane] * 4 + c_blk_x[lane]] = s.i4[m] ? tc4 : tc16;
  if (lane < 8) o[((lane >> 2) ? TC_CR : TC_CB) + (lane & 3)] = ctc;
  if (lane == 0) {
    o[CBP_LUMA] = cbp_luma;
    o[CBP_LUMA4] = grp;
    o[CBP_CHROMA] = cbp_c;
    o[GRP_ANY] = grp;
    if (scratch) {
      scratch[CBP_LUMA] = cbp_luma;
      scratch[CBP_LUMA4] = grp;
      scratch[CBP_CHROMA] = cbp_c;
    }
  }
}

__device__ __forceinline__ int mode_raster(const ISmem& s, int m, int by, int bx) {
  if (!s.i4[m]) return 2;
  // raster (by, bx) -> blkIdx
  return s.modes[m][(by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1)];
}

// MB m's 20 syntax slots (mb_type, the 16 I4 modes, chroma mode, cbp,
// mb_qp_delta); m - 1 is its left MB where has_left.
__device__ void syntax_slots(const ISmem& s, int m, bool has_left, int* vals, int* lens) {
  const bool i4 = s.i4[m];
  for (int b = 0; b < 16; ++b) {
    const int bx = c_blk_x[b], by = c_blk_y[b];
    const bool a_ok = bx > 0 || has_left, b_ok = by > 0;
    int pred = 2;
    if (a_ok && b_ok) {
      const int ma = bx > 0 ? mode_raster(s, m, by, bx - 1) : mode_raster(s, m - 1, by, 3);
      pred = min(ma, mode_raster(s, m, by - 1, bx));
    }
    const int md = s.modes[m][b];
    const bool flag = md == pred;
    vals[1 + b] = flag ? 1 : md - (md > pred);
    lens[1 + b] = i4 ? (flag ? 1 : 4) : 0;
  }
  const int* info = s.info[m];
  const int cl = info[CBP_LUMA], cc = info[CBP_CHROMA];
  const int mbt16 = 1 + s.pred[m] + 4 * cc + 12 * cl;
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

__global__ void __launch_bounds__(P_THREADS, I_MINB) i_slots_kernel(
    Levels L, int* scratch, int* values, int* lengths, int* syn_vals, int* syn_lens, int nr,
    int nc, int segs) {
  extern __shared__ int4 i_dyn[];
  ISmem& s = *reinterpret_cast<ISmem*>(i_dyn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / segs, seg = blockIdx.x % segs;
  const int rowmb = (blockIdx.y * nr + row) * nc;   // the first MB of the stack's row
  const int nchunks = (nc + I_G - 1) / I_G;
  const int ch0 = seg * I_SEG_CHUNKS, ch1 = min(ch0 + I_SEG_CHUNKS, nchunks);
  for (int ch = ch0; ch < ch1; ++ch) {
    const int c0 = ch * I_G, gc = min(I_G, nc - c0);
    const int h = c0 > 0 ? 1 : 0;                   // a halo MB to the left
    const int m0 = 1 - h, n = gc + h;               // smem slots m0 .. gc
    const size_t first = (size_t)rowmb + c0 - h;
    __syncthreads();                                // the previous chunk is out
    stage_i4(&s.li4[m0][0][0], L.luma_i4 + first * 256, n);
    stage(s.lac[m0], L.luma_ac + first * 240, n * 240);
    stage(s.ldc[m0], L.luma_dc + first * 16, n * 16);
    stage(s.cbdc[m0], L.cb_dc + first * 4, n * 4);
    stage(s.crdc[m0], L.cr_dc + first * 4, n * 4);
    stage(s.cbac[m0], L.cb_ac + first * 60, n * 60);
    stage(s.crac[m0], L.cr_ac + first * 60, n * 60);
    stage(s.modes[m0], L.i4_modes + first * 16, n * 16);
    for (int i = tid; i < n; i += P_THREADS) {
      s.pred[m0 + i] = L.pred_mode[first + i];
      s.i4[m0 + i] = L.mb_i4[first + i];
    }
    __syncthreads();
    for (int m = m0 + warp; m <= gc; m += P_THREADS / 32)
      i_mb_info(s, m, lane, m && scratch ? scratch + (first + m - m0) * INFO : nullptr);
    if (tid == 0) bulk_wait<true>();                // the last chunk's tiles were read
    __syncthreads();
    if (tid < gc * BLOCKS) {
      const int m = tid / BLOCKS + 1, j = tid % BLOCKS, c = c0 + m - 1;
      const int* inf = s.info[m];
      const int* linf = c ? s.info[m - 1] : nullptr;
      const bool i4 = s.i4[m];
      const int cbp_c = inf[CBP_CHROMA];
      const int* lv;
      int len = 15, nc_ctx = 0, max_coeff = 15;
      bool is_cdc = false, gate;
      if (j == 0) {                                 // luma DC (I16)
        lv = s.ldc[m];
        len = 16;
        nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, 0, 0);
        max_coeff = 16;
        gate = !i4;
      } else if (j <= 16) {                         // luma blocks, blkIdx order
        const int b = j - 1;
        lv = i4 ? s.li4[m][b] : s.lac[m] + b * 15;
        len = i4 ? 16 : 15;
        nc_ctx = nc_of(inf + TC_LUMA, linf ? linf + TC_LUMA : nullptr, 4, c_blk_y[b],
                       c_blk_x[b]);
        max_coeff = len;
        gate = i4 ? ((inf[GRP_ANY] >> (b >> 2)) & 1) : inf[CBP_LUMA];
      } else if (j <= 18) {                         // chroma DC
        lv = j == 17 ? s.cbdc[m] : s.crdc[m];
        len = 4;
        is_cdc = true;
        max_coeff = 4;
        gate = cbp_c > 0;
      } else {                                      // chroma AC
        const int p = (j - 19) >> 2, q = (j - 19) & 3;
        lv = (p ? s.crac[m] : s.cbac[m]) + q * 15;
        const int off = p ? TC_CR : TC_CB;
        nc_ctx = nc_of(inf + off, linf ? linf + off : nullptr, 2, q >> 1, q & 1);
        gate = cbp_c == 2;
      }
      code_block(lv, len, nc_ctx, is_cdc, max_coeff, gate, s.vals[m - 1][j], s.lens[m - 1][j]);
    } else if (tid >= I_G * BLOCKS && tid < I_G * BLOCKS + gc) {
      const int m = tid - I_G * BLOCKS + 1;
      syntax_slots(s, m, c0 + m - 1 > 0, s.syn_vals[m - 1], s.syn_lens[m - 1]);
    }
    fence_async_shared();
    __syncthreads();
    const size_t out0 = (size_t)rowmb + c0;
    int* const vdst = values + out0 * BLOCKS * SLOTS;
    int* const ldst = lengths + out0 * BLOCKS * SLOTS;
    const unsigned bytes = gc * BLOCKS * SLOTS * 4;
    if (((reinterpret_cast<uintptr_t>(vdst) | reinterpret_cast<uintptr_t>(ldst) | bytes) & 15) ==
        0) {
      if (tid == 0) {
        bulk_store(vdst, &s.vals[0][0][0], bytes);
        bulk_store(ldst, &s.lens[0][0][0], bytes);
        bulk_commit();
      }
    } else {
      copy_out(vdst, &s.vals[0][0][0], gc * BLOCKS * SLOTS);
      copy_out(ldst, &s.lens[0][0][0], gc * BLOCKS * SLOTS);
    }
    copy_out(syn_vals + out0 * SYN, &s.syn_vals[0][0], gc * SYN);
    copy_out(syn_lens + out0 * SYN, &s.syn_lens[0][0], gc * SYN);
  }
  if (tid == 0) bulk_wait<false>();
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
// array's leading axis (scratch included; null when no qp chain follows).
extern "C" int cavlc_slots_launch(
    const int* luma_dc, const int* luma_ac, const int* cb_dc, const int* cb_ac,
    const int* cr_dc, const int* cr_ac, const int* pred_mode, const uint8_t* mb_i4,
    const int* i4_modes, const int* luma_i4, int* values, int* lengths,
    int* syn_vals, int* syn_lens, int* scratch, int nr, int nc, int ns,
    cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  const Levels L{luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
                 mb_i4, i4_modes, luma_i4};
  const int nchunks = (nc + I_G - 1) / I_G;
  const int segs = (nchunks + I_SEG_CHUNKS - 1) / I_SEG_CHUNKS;
  const int smem = (int)sizeof(ISmem);
  const cudaError_t e = cudaFuncSetAttribute(
      i_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  i_slots_kernel<<<dim3(nr * segs, ns), P_THREADS, smem, stream>>>(
      L, scratch, values, lengths, syn_vals, syn_lens, nr, nc, segs);
  return dngd_last_error();
}

extern "C" int cavlc_p_slots_launch(const int* mv, const int* luma, const int* cb_dc,
                                    const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                    int* values, int* lengths, int* hdr_vals, int* hdr_lens,
                                    int* trail_vals, int* trail_lens, uint8_t* nnz,
                                    int* scratch, int nr, int nc, int ns,
                                    cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  const PLevels L{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, nullptr, nullptr, nullptr};
  return launch_p_slots<false>(L, scratch, nnz, values, lengths, hdr_vals, hdr_lens,
                               trail_vals, trail_lens, nr, nc, ns, stream);
}

// The I16-in-P form: 27 block slots per MB.
extern "C" int cavlc_p_slots_i_launch(const int* mv, const int* luma, const int* cb_dc,
                                      const int* cb_ac, const int* cr_dc, const int* cr_ac,
                                      const int* i16_dc, const int* i16_ac,
                                      const uint8_t* mb_intra, int* values, int* lengths,
                                      int* hdr_vals, int* hdr_lens, int* trail_vals,
                                      int* trail_lens, uint8_t* nnz, int* scratch, int nr,
                                      int nc, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  const PLevels L{mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, i16_dc, i16_ac, mb_intra};
  return launch_p_slots<true>(L, scratch, nnz, values, lengths, hdr_vals, hdr_lens,
                              trail_vals, trail_lens, nr, nc, 1, stream);
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

// The full tier's P slots in one host call: the I16-in-P form, then the
// qp chain (kind 1, nsum sums as cavlc_qp_chain_launch's) on the same
// stream and scratch.
extern "C" int cavlc_p_slots_i_chain_launch(
    const int* mv, const int* luma, const int* cb_dc, const int* cb_ac, const int* cr_dc,
    const int* cr_ac, const int* i16_dc, const int* i16_ac, const uint8_t* mb_intra,
    int* values, int* lengths, int* hdr_vals, int* hdr_lens, int* trail_vals,
    int* trail_lens, uint8_t* nnz, int* scratch, const int* qp_map, int* qp_sum,
    const int* qp_dev, int nr, int nc, int slice_qp, int nsum, cudaStream_t stream) {
  const int e = cavlc_p_slots_i_launch(mv, luma, cb_dc, cb_ac, cr_dc, cr_ac, i16_dc, i16_ac,
                                       mb_intra, values, lengths, hdr_vals, hdr_lens,
                                       trail_vals, trail_lens, nnz, scratch, nr, nc, stream);
  if (e) return e;
  return cavlc_qp_chain_launch(qp_map, mb_intra, scratch, hdr_vals, hdr_lens, qp_sum, qp_dev,
                               nr, nc, slice_qp, 1, nsum, stream);
}
