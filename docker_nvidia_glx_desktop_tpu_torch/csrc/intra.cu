// K1 — H.264 intra core: I16x16 DC/H + I4x4 fast modes, chroma DC
// prediction, 4x4 integer transform, DC Hadamards, quant/dequant and the
// normative reconstruction of one frame.
//
// Replaces docker_nvidia_glx_desktop_tpu/ops/h264_device.py:555
// encode_intra_frame_yuv (i16_modes="auto"); bit-exact with it.
//
// The tune tier is a template parameter: TIER 0 ("off") picks every mode
// by estimated bits; 1 ("hq_noaq") and 2 ("hq") by the Lagrangian
// SSD + lam * bits in float32 (h264_device.py:99-135, :225-262), every
// candidate reconstructed for its SSD, illegal I4 candidates +inf, the
// first minimum kept, and the multiply-adds fused (__fmaf_rn) as XLA's
// CPU backend fuses them; the I4 scores summed in the reference's order
// (row 0 block by block, rows 1-3 a row's four blocks left to right).
// TIER 2 quantises each MB at its qp from the qp plane (K14) and reads
// lambda at it; TIER 1 at the slice qp.  I16 vs I4: bits4 + 44 < bits16,
// or score4 + lam * 44 (fused under hq; hq_noaq's rounded constant).
//
// What bounds it: the dependency chain, not bytes or operations.  Every
// MB row is its own slice, so rows are independent, but inside a row each
// MB predicts from the left MB's reconstruction.  One CUDA block owns one
// MB row and walks its MB columns in order; inside an MB its threads take
// the 4x4 blocks and the candidates of each stage (I16 DC and H: 32
// threads; chroma: 8; I4x4 row 0: 3 candidates, four blocks in sequence;
// I4x4 rows 1-3: 4 blocks x 3 candidates), separated by __syncthreads.
// Known limit: a 1080p frame has 68 MB rows, so 68 blocks run on 132 SMs
// and each walks 120 MBs of ~20 barrier-separated stages.
#include <type_traits>

#include "common.cuh"
#include "transform.cuh"

namespace {

constexpr int NT = 64;               // threads per block (one MB row)
constexpr int ILLEGAL = 1 << 30;     // bit estimate of an unavailable mode
constexpr int I4_SIG_BITS = 44;      // I_NxN signalling bias vs I16
constexpr float SCORE_CLAMP = 1e18f; // the reference's I4 score clamp

// raster (by, bx) -> luma4x4BlkIdx
__constant__ int c_raster_idx[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                     8, 9, 12, 13, 10, 11, 14, 15};
__constant__ int c_mode_row0[3] = {1, 8, 2};    // H, HU, DC (left)
__constant__ int c_mode_rows[3] = {0, 3, 7};    // V, DDL, VL

struct Smem {
  int ysrc[256];
  int csrc[2][64];
  int yl[16];                 // left MB's recon column (luma)
  int cl[2][8];               // ... and chroma
  // I16 candidates: 0 = DC, 1 = Horizontal
  int ac16[2][16][16];        // [cand][raster block][coef], DC zeroed
  int dcraw[2][16];
  int bits_ac[2][16];
  int dcl16[2][16];
  int dcy[2][16];
  int bits_dc[2];
  int rec16[2][256];
  // chroma
  int acc[2][4][16];
  int dcrawc[2][4];
  int dclc[2][4];
  int dcc[2][4];
  int recc[2][64];
  // I4x4
  int rec4[256];
  int clv[12][16];            // candidate levels (raster coef order)
  int cpred[12][16];
  int cbits[12];
  int mode4[16];              // raster block order
  int lvz4[16][16];           // raster block, zigzag levels
  int bits4;
  int sel_h, use4;
};

// tune=hq's extra state: candidate SSDs and float32 scores
struct SmemHq : Smem {
  int ssd16[2][16];           // I16 [cand][raster block]
  float cscore[12];           // I4 candidates
  float bscore[4];            // rows 1-3: each block's kept score
  float bits4f;               // the I4 score total
};

template <int TIER>
using SmemT = typename std::conditional<TIER == 0, Smem, SmemHq>::type;

template <class S>
__device__ void i4_finish(S& s, const Qp& Q, int k, int mode, int bx, int by) {
  int wr[16], res[16];
  for (int i = 0; i < 16; ++i) wr[i] = Q.dq(s.clv[k][i], i);
  idct4(wr, res);
  for (int i = 0; i < 16; ++i) {
    const int v = s.cpred[k][i] + res[i];
    s.rec4[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] = min(max(v, 0), 255);
  }
  const int rb = by * 4 + bx;
  s.mode4[rb] = mode;
  for (int i = 0; i < 16; ++i) s.lvz4[rb][i] = s.clv[k][c_zz[i]];
}

template <int TIER, class S>
__device__ void i4_candidate(S& s, const Qp& Q, int slot, int bx, int by,
                             const int* pred, bool legal, float lam) {
  int x[16], w[16];
  for (int i = 0; i < 16; ++i) {
    x[i] = s.ysrc[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)] - pred[i];
    s.cpred[slot][i] = pred[i];
  }
  fdct4(x, w);
  for (int i = 0; i < 16; ++i) s.clv[slot][i] = Q.q(w[i], i);
  s.cbits[slot] = legal ? level_bits(s.clv[slot]) : ILLEGAL;
  if constexpr (TIER != 0) {
    // the candidate's reconstruction, for SSD + lam * bits
    int wr[16], res[16], ssd = 0;
    for (int i = 0; i < 16; ++i) wr[i] = Q.dq(s.clv[slot][i], i);
    idct4(wr, res);
    for (int i = 0; i < 16; ++i) {
      const int d = min(max(pred[i] + res[i], 0), 255) - (pred[i] + x[i]);
      ssd += d * d;
    }
    s.cscore[slot] = legal ? __fmaf_rn(lam, (float)s.cbits[slot], (float)ssd)
                           : __int_as_float(0x7f800000);  // +inf
  }
}

// first minimum of n candidate costs from k0, as argmin
template <int TIER, class S>
__device__ __forceinline__ int pick(const S& s, int k0, int n) {
  int k = k0;
  for (int j = k0 + 1; j < k0 + n; ++j) {
    if constexpr (TIER == 0) {
      if (s.cbits[j] < s.cbits[k]) k = j;
    } else {
      if (s.cscore[j] < s.cscore[k]) k = j;
    }
  }
  return k;
}

template <int TIER>
__global__ void __launch_bounds__(NT) intra_frame_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
    const uint8_t* __restrict__ cr, int* luma_dc, int* luma_ac, int* cb_dc,
    int* cb_ac, int* cr_dc, int* cr_ac, int* pred_mode, uint8_t* mb_i4,
    int* i4_modes, int* luma_i4, uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
    const int* __restrict__ qp_map, const float* __restrict__ lam_tab,
    const float* __restrict__ sig_tab, int nc, int qp, int qpc) {
  __shared__ SmemT<TIER> s;
  // r: the MB row of the stack.  blockIdx.y is the session: sessions'
  // planes and outputs are stacked contiguously, a session's stride is
  // gridDim.x MB rows, and no row reads another (slice per MB row)
  const int r = blockIdx.y * gridDim.x + blockIdx.x, t = threadIdx.x;
  const int W = nc * 16, Wc = nc * 8;
  const Qp Q0(qp), QC0(qpc);
  uint8_t* const rc[2] = {rcb, rcr};
  int* const c_dc[2] = {cb_dc, cr_dc};
  int* const c_ac[2] = {cb_ac, cr_ac};
  // the first MB has no left neighbour: its unavailable candidates read
  // zeros, as the reference's scan carry starts at zeros
  if (t < 16) s.yl[t] = 0;
  else if (t < 32) s.cl[(t - 16) >> 3][(t - 16) & 7] = 0;

  for (int c = 0; c < nc; ++c) {
    const bool has_left = c > 0;
    const int mbi = r * nc + c;
    // the MB's qp: the qp plane's under the full tier, else the slice's
    const int qm = TIER == 2 ? qp_map[mbi] : qp;
    const Qp Q = TIER == 2 ? Qp(qm) : Q0;
    const Qp QC = TIER == 2 ? Qp(dngd_chroma_qp(qm)) : QC0;
    const float lam = TIER != 0 ? lam_tab[qm] : 0.0f;
    for (int i = t; i < 256; i += NT)
      s.ysrc[i] = y[(r * 16 + (i >> 4)) * W + c * 16 + (i & 15)];
    for (int i = t; i < 128; i += NT) {
      const int p = i >> 6, k = i & 63;
      s.csrc[p][k] = (p ? cr : cb)[(r * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)];
    }
    if (t == 0) {
      s.bits4 = 0;
      if constexpr (TIER != 0) s.bits4f = 0.0f;
    }
    __syncthreads();

    // --- I16 candidates and chroma: transform + AC quant -------------
    if (t < 32) {
      const int cand = t >> 4, b = t & 15, by = b >> 2, bx = b & 3;
      int pred_dc = 128;
      if (has_left) {
        int sum = 0;
        for (int i = 0; i < 16; ++i) sum += s.yl[i];
        pred_dc = (sum + 8) >> 4;
      }
      int x[16], w[16];
      for (int i = 0; i < 16; ++i) {
        const int yy = by * 4 + (i >> 2);
        x[i] = s.ysrc[yy * 16 + bx * 4 + (i & 3)] - (cand ? s.yl[yy] : pred_dc);
      }
      fdct4(x, w);
      s.dcraw[cand][b] = w[0];
      s.ac16[cand][b][0] = 0;
      for (int i = 1; i < 16; ++i) s.ac16[cand][b][i] = Q.q(w[i], i);
      s.bits_ac[cand][b] = level_bits(s.ac16[cand][b]);
    } else if (t < 40) {
      const int p = (t - 32) >> 2, q = (t - 32) & 3, by = q >> 1, bx = q & 1;
      int pred = 128;
      if (has_left) {
        const int* l = s.cl[p] + 4 * by;
        pred = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
      }
      int x[16], w[16];
      for (int i = 0; i < 16; ++i)
        x[i] = s.csrc[p][(by * 4 + (i >> 2)) * 8 + bx * 4 + (i & 3)] - pred;
      fdct4(x, w);
      s.dcrawc[p][q] = w[0];
      s.acc[p][q][0] = 0;
      for (int i = 1; i < 16; ++i) s.acc[p][q][i] = QC.q(w[i], i);
    }
    __syncthreads();

    // --- DC Hadamards: quant, inverse, dequant ------------------------
    if (t < 2) {
      int wd2[16], dcl[16], fd[16];
      had4(s.dcraw[t], wd2);
      for (int i = 0; i < 16; ++i) {
        const int a = abs(wd2[i]) >> 1;
        dcl[i] = Q.q_dc(wd2[i] < 0 ? -a : a);
        s.dcl16[t][i] = dcl[i];
      }
      s.bits_dc[t] = level_bits(dcl);
      had4(dcl, fd);
      for (int i = 0; i < 16; ++i) {
        const int v00 = c_v[0][Q.m];
        s.dcy[t][i] = qm >= 12 ? fd[i] * v00 * (1 << (Q.s - 2))
                               : (fd[i] * v00 + (1 << (1 - Q.s))) >> (2 - Q.s);
      }
    } else if (t < 4) {
      const int p = t - 2;
      int wd[4], dcl[4], fd[4];
      had2(s.dcrawc[p], wd);
      for (int q = 0; q < 4; ++q) {
        dcl[q] = QC.q_dc(wd[q]);
        s.dclc[p][q] = dcl[q];
      }
      had2(dcl, fd);
      for (int q = 0; q < 4; ++q)
        s.dcc[p][q] = (fd[q] * c_v[0][QC.m] * (1 << QC.s)) >> 1;
    }
    __syncthreads();

    // --- I16 and chroma reconstruction --------------------------------
    if (t < 32) {
      const int cand = t >> 4, b = t & 15, by = b >> 2, bx = b & 3;
      int pred_dc = 128;
      if (has_left) {
        int sum = 0;
        for (int i = 0; i < 16; ++i) sum += s.yl[i];
        pred_dc = (sum + 8) >> 4;
      }
      int wr[16], res[16];
      wr[0] = s.dcy[cand][b];
      for (int i = 1; i < 16; ++i) wr[i] = Q.dq(s.ac16[cand][b][i], i);
      idct4(wr, res);
      for (int i = 0; i < 16; ++i) {
        const int yy = by * 4 + (i >> 2);
        const int v = (cand ? s.yl[yy] : pred_dc) + res[i];
        s.rec16[cand][yy * 16 + bx * 4 + (i & 3)] = min(max(v, 0), 255);
      }
      if constexpr (TIER != 0) {
        int ssd = 0;
        for (int i = 0; i < 16; ++i) {
          const int k = (by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3);
          const int d = s.rec16[cand][k] - s.ysrc[k];
          ssd += d * d;
        }
        s.ssd16[cand][b] = ssd;
      }
    } else if (t < 40) {
      const int p = (t - 32) >> 2, q = (t - 32) & 3, by = q >> 1, bx = q & 1;
      int pred = 128;
      if (has_left) {
        const int* l = s.cl[p] + 4 * by;
        pred = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
      }
      int wr[16], res[16];
      wr[0] = s.dcc[p][q];
      for (int i = 1; i < 16; ++i) wr[i] = QC.dq(s.acc[p][q][i], i);
      idct4(wr, res);
      for (int i = 0; i < 16; ++i) {
        const int v = pred + res[i];
        s.recc[p][(by * 4 + (i >> 2)) * 8 + bx * 4 + (i & 3)] = min(max(v, 0), 255);
      }
    }

    // --- I4x4 block row 0: H / HU / DC(left), sequential along bx ------
    for (int bx = 0; bx < 4; ++bx) {
      __syncthreads();
      if (t < 3) {
        int l[4];
        for (int k = 0; k < 4; ++k)
          l[k] = bx == 0 ? s.yl[k] : s.rec4[k * 16 + bx * 4 - 1];
        const bool avail = bx > 0 || has_left;
        int pred[16];
        if (t == 0) {
          for (int i = 0; i < 16; ++i) pred[i] = l[i >> 2];
        } else if (t == 1) {
          const int z[8] = {(l[0] + l[1] + 1) >> 1, (l[0] + 2 * l[1] + l[2] + 2) >> 2,
                            (l[1] + l[2] + 1) >> 1, (l[1] + 2 * l[2] + l[3] + 2) >> 2,
                            (l[2] + l[3] + 1) >> 1, (l[2] + 3 * l[3] + 2) >> 2,
                            l[3], l[3]};
          for (int i = 0; i < 16; ++i) pred[i] = z[min((i & 3) + 2 * (i >> 2), 7)];
        } else {
          const int dc = avail ? (l[0] + l[1] + l[2] + l[3] + 2) >> 2 : 128;
          for (int i = 0; i < 16; ++i) pred[i] = dc;
        }
        i4_candidate<TIER>(s, Q, t, bx, 0, pred, t == 2 || avail, lam);
      }
      __syncthreads();
      if (t == 0) {
        const int k = pick<TIER>(s, 0, 3);
        i4_finish(s, Q, k, c_mode_row0[k], bx, 0);
        if constexpr (TIER == 0) {
          s.bits4 += min(s.cbits[k], 1 << 24);
        } else {
          s.bits4f = __fadd_rn(s.bits4f, fminf(s.cscore[k], SCORE_CLAMP));
        }
      }
    }

    // --- I4x4 block rows 1-3: V / DDL / VL, four blocks in parallel ---
    for (int by = 1; by < 4; ++by) {
      __syncthreads();
      if (t < 12) {
        const int bx = t / 3, cand = t % 3;
        const int* above = s.rec4 + (by * 4 - 1) * 16 + bx * 4;
        const bool tr_avail =
            bx < 3 && c_raster_idx[(by - 1) * 4 + bx + 1] < c_raster_idx[by * 4 + bx];
        int p[8];
        for (int k = 0; k < 4; ++k) {
          p[k] = above[k];
          p[4 + k] = tr_avail ? above[4 + k] : above[3];
        }
        int pred[16];
        for (int i = 0; i < 16; ++i) {
          const int yy = i >> 2, xx = i & 3;
          if (cand == 0) {
            pred[i] = p[xx];
          } else if (cand == 1) {
            const int j = xx + yy;
            pred[i] = j == 6 ? (p[6] + 3 * p[7] + 2) >> 2
                             : (p[j] + 2 * p[j + 1] + p[j + 2] + 2) >> 2;
          } else {
            const int j = xx + (yy >> 1);
            pred[i] = (yy & 1) ? (p[j] + 2 * p[j + 1] + p[j + 2] + 2) >> 2
                               : (p[j] + p[j + 1] + 1) >> 1;
          }
        }
        i4_candidate<TIER>(s, Q, t, bx, by, pred, true, lam);
      }
      __syncthreads();
      if (t < 4) {
        const int k = pick<TIER>(s, 3 * t, 3);
        i4_finish(s, Q, k, c_mode_rows[k - 3 * t], t, by);
        if constexpr (TIER == 0) {
          atomicAdd(&s.bits4, s.cbits[k]);
        } else {
          s.bscore[t] = s.cscore[k];
        }
      }
      if constexpr (TIER != 0) {
        // the row's four scores, summed left to right as XLA reduces
        __syncthreads();
        if (t == 0)
          s.bits4f = __fadd_rn(
              s.bits4f,
              __fadd_rn(__fadd_rn(__fadd_rn(s.bscore[0], s.bscore[1]), s.bscore[2]),
                        s.bscore[3]));
      }
    }
    __syncthreads();

    // --- decisions: I16 DC vs H, then I16 vs I4 -----------------------
    if (t == 0) {
      int b_dc = s.bits_dc[0], b_h = s.bits_dc[1];
      for (int b = 0; b < 16; ++b) {
        b_dc += s.bits_ac[0][b];
        b_h += s.bits_ac[1][b];
      }
      if constexpr (TIER == 0) {
        const bool use_h = has_left && b_h < b_dc;
        s.sel_h = use_h;
        s.use4 = s.bits4 + I4_SIG_BITS < (use_h ? b_h : b_dc);
      } else {
        int ssd_dc = 0, ssd_h = 0;
        for (int b = 0; b < 16; ++b) {
          ssd_dc += s.ssd16[0][b];
          ssd_h += s.ssd16[1][b];
        }
        const float sc_dc = __fmaf_rn(lam, (float)b_dc, (float)ssd_dc);
        const float sc_h = __fmaf_rn(lam, (float)b_h, (float)ssd_h);
        const bool use_h = has_left && sc_h < sc_dc;
        s.sel_h = use_h;
        const float i4 = TIER == 2 ? __fmaf_rn(lam, (float)I4_SIG_BITS, s.bits4f)
                                   : __fadd_rn(s.bits4f, sig_tab[qm]);
        s.use4 = i4 < (use_h ? sc_h : sc_dc);
      }
    }
    __syncthreads();

    const int sel = s.sel_h, use4 = s.use4;
    const int* yrec = use4 ? s.rec4 : s.rec16[sel];
    if (t < 16) {
      s.yl[t] = yrec[t * 16 + 15];
    } else if (t < 32) {
      const int p = (t - 16) >> 3, k = (t - 16) & 7;
      s.cl[p][k] = s.recc[p][k * 8 + 7];
    }
    for (int i = t; i < 256; i += NT) {
      ry[(r * 16 + (i >> 4)) * W + c * 16 + (i & 15)] = (uint8_t)yrec[i];
      const int blk = i >> 4, k = i & 15;    // blkIdx, zigzag position
      const int rb = c_blk_y[blk] * 4 + c_blk_x[blk];
      luma_i4[(mbi * 16 + blk) * 16 + k] = s.lvz4[rb][k];
      if (k > 0) luma_ac[(mbi * 16 + blk) * 15 + k - 1] = s.ac16[sel][rb][c_zz[k]];
    }
    for (int i = t; i < 128; i += NT) {
      const int p = i >> 6, k = i & 63;
      rc[p][(r * 8 + (k >> 3)) * Wc + c * 8 + (k & 7)] = (uint8_t)s.recc[p][k];
      if (k < 60) {
        const int q = k / 15, j = k % 15 + 1;
        c_ac[p][(mbi * 4 + q) * 15 + j - 1] = s.acc[p][q][c_zz[j]];
      }
    }
    if (t < 16) {
      luma_dc[mbi * 16 + t] = s.dcl16[sel][c_zz[t]];
      i4_modes[mbi * 16 + t] = s.mode4[c_blk_y[t] * 4 + c_blk_x[t]];
    } else if (t < 24) {
      const int p = (t - 16) >> 2, q = (t - 16) & 3;
      c_dc[p][mbi * 4 + q] = s.dclc[p][q];
    } else if (t == 24) {
      pred_mode[mbi] = sel ? 1 : 2;
      mb_i4[mbi] = (uint8_t)use4;
    }
  }
}

}  // namespace

// ns: sessions (1 = one frame), each nr x nc MBs, stacked on the planes'
// and outputs' leading axis.
extern "C" int intra_frame_launch(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int* luma_dc,
    int* luma_ac, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
    int* pred_mode, uint8_t* mb_i4, int* i4_modes, int* luma_i4, uint8_t* ry,
    uint8_t* rcb, uint8_t* rcr, int nr, int nc, int qp, int qpc, int ns,
    cudaStream_t stream) {
  if (nr <= 0 || nc <= 0 || ns <= 0) return 0;
  intra_frame_kernel<0><<<dim3(nr, ns), NT, 0, stream>>>(
      y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
      mb_i4, i4_modes, luma_i4, ry, rcb, rcr, nullptr, nullptr, nullptr, nc, qp, qpc);
  return dngd_last_error();
}

// tune=hq: tier 1 (hq_noaq) or 2 (hq, qp_map the qp plane); lam the
// tier's lambda table (52 float32), sig hq_noaq's I4 signalling costs.
extern "C" int intra_frame_hq_launch(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int* luma_dc,
    int* luma_ac, int* cb_dc, int* cb_ac, int* cr_dc, int* cr_ac,
    int* pred_mode, uint8_t* mb_i4, int* i4_modes, int* luma_i4, uint8_t* ry,
    uint8_t* rcb, uint8_t* rcr, const int* qp_map, const float* lam, const float* sig,
    int nr, int nc, int qp, int qpc, int tier, cudaStream_t stream) {
  if (nr <= 0 || nc <= 0) return 0;
  if (tier == 2) {
    if (!qp_map) return cudaErrorInvalidValue;
    intra_frame_kernel<2><<<nr, NT, 0, stream>>>(
        y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
        mb_i4, i4_modes, luma_i4, ry, rcb, rcr, qp_map, lam, sig, nc, qp, qpc);
  } else if (tier == 1) {
    intra_frame_kernel<1><<<nr, NT, 0, stream>>>(
        y, cb, cr, luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac, pred_mode,
        mb_i4, i4_modes, luma_i4, ry, rcb, rcr, qp_map, lam, sig, nc, qp, qpc);
  } else {
    return cudaErrorInvalidValue;
  }
  return dngd_last_error();
}
