// H.264 CABAC slice entropy coder — native fast path.
//
// Mirrors bitstream/cabac.py + bitstream/h264_cabac.py BYTE-FOR-BYTE
// (tests enforce per-slice payload equality).  Each macroblock row is an
// independent slice with its own arithmetic engine, so rows are coded on
// a thread pool and concatenated by the Python caller, which also writes
// the (tiny) slice headers and NAL wrapping.
//
// The normative tables (context init, rangeTabLPS, transIdx) are NOT
// duplicated here: the Python side passes the constants of
// bitstream/cabac_tables.py, keeping them single-sourced.
//
// A copy of docker_nvidia_glx_desktop_tpu/native/cabac.cpp for the
// PyTorch/CUDA port (built by native/lib.py into the package's build/).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Persistent row pool: the entry points run at 60 fps, and creating +
// joining a fresh std::thread set per frame costs a measurable slice of
// the 16.7 ms budget.  Workers are detached and the singleton is leaked
// (joinable threads in a static destructor would std::terminate).
class RowPool {
 public:
  static RowPool& instance() {
    static RowPool* p = new RowPool();
    return *p;
  }

  void run(int64_t n, const std::function<void(int64_t)>& fn) {
    if (n <= 1) {
      for (int64_t i = 0; i < n; ++i) fn(i);
      return;
    }
    // One job at a time: done_cv_.wait below releases m_, so without the
    // outer lock a second caller (prewarm thread vs serving thread, both
    // with the GIL released) would overwrite the job state mid-flight and
    // rows would be re-coded or dropped.  Each job also gets its own heap
    // state object so a straggler worker from the previous job can only
    // ever observe exhausted indices of ITS job, never the new job's.
    std::lock_guard<std::mutex> job_lk(job_m_);
    auto job = std::make_shared<Job>();
    job->fn = &fn;
    job->remaining = n;
    job->total = n;
    std::unique_lock<std::mutex> lk(m_);
    ensure_workers();
    job_ = job;
    ++gen_;
    cv_.notify_all();
    done_cv_.wait(lk, [&] { return job->remaining == 0; });
    job_ = nullptr;
  }

 private:
  void ensure_workers() {
    if (!workers_started_) {
      unsigned n = std::max(1u, std::thread::hardware_concurrency());
      for (unsigned i = 0; i < n; ++i)
        std::thread([this] { worker(); }).detach();
      workers_started_ = true;
    }
  }

  struct Job {
    const std::function<void(int64_t)>* fn = nullptr;
    std::atomic<int64_t> next{0};
    int64_t remaining = 0, total = 0;
  };

  void worker() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      cv_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      std::shared_ptr<Job> job = job_;
      lk.unlock();
      if (job) {
        for (;;) {
          int64_t i = job->next.fetch_add(1);
          if (i >= job->total) break;
          (*job->fn)(i);
          lk.lock();
          if (--job->remaining == 0) done_cv_.notify_all();
          lk.unlock();
        }
      }
      lk.lock();
    }
  }

  std::mutex job_m_;
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  std::shared_ptr<Job> job_;
  uint64_t gen_ = 0;
  bool workers_started_ = false;
};

// luma4x4BlkIdx -> (bx, by) z-scan (bitstream/cabac._BLK_XY)
const int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

const int kCbfOff[5] = {0, 4, 8, 12, 16};     // base 85
const int kSigOff[5] = {0, 15, 29, 44, 47};   // base 105 / 166
const int kAbsOff[5] = {0, 10, 20, 30, 39};   // base 227

struct Engine {
  const uint8_t* rng_lps;   // (64,4)
  const uint8_t* t_mps;     // (64,)
  const uint8_t* t_lps;     // (64,)
  uint8_t state[1024];
  uint8_t mps[1024];
  uint32_t low = 0;
  uint32_t range = 510;
  int outstanding = 0;
  bool first = true;
  std::vector<uint8_t> bits;   // one bit per byte; packed at the end

  void put(int b) {
    if (first) first = false; else bits.push_back((uint8_t)b);
    while (outstanding > 0) { bits.push_back((uint8_t)(1 - b)); --outstanding; }
  }
  void renorm() {
    while (range < 256) {
      if (low < 256) put(0);
      else if (low >= 512) { low -= 512; put(1); }
      else { low -= 256; ++outstanding; }
      range <<= 1; low <<= 1;
    }
  }
  void decision(int ctx, int b) {
    int s = state[ctx];
    uint32_t r_lps = rng_lps[s * 4 + ((range >> 6) & 3)];
    range -= r_lps;
    if (b != mps[ctx]) {
      low += range; range = r_lps;
      if (s == 0) mps[ctx] ^= 1;
      state[ctx] = t_lps[s];
    } else {
      state[ctx] = t_mps[s];
    }
    renorm();
  }
  void bypass(int b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 1024) { low -= 1024; put(1); }
    else if (low < 512) put(0);
    else { low -= 512; ++outstanding; }
  }
  void terminate(int b) {
    range -= 2;
    if (b) {
      low += range; range = 2; renorm();
      put((low >> 9) & 1);
      uint32_t v = ((low >> 7) & 3) | 1;
      bits.push_back((uint8_t)((v >> 1) & 1));
      bits.push_back((uint8_t)(v & 1));
    } else {
      renorm();
    }
  }
  void ueg_suffix(int v, int k) {
    while (v >= (1 << k)) { bypass(1); v -= 1 << k; ++k; }
    bypass(0);
    for (int i = k - 1; i >= 0; --i) bypass((v >> i) & 1);
  }
  int64_t pack(uint8_t* out) const {
    int64_t n = (int64_t)bits.size();
    int64_t nbytes = (n + 7) / 8;
    for (int64_t i = 0; i < nbytes; ++i) out[i] = 0;
    for (int64_t i = 0; i < n; ++i)
      if (bits[i]) out[i >> 3] |= (uint8_t)(0x80u >> (i & 7));
    return nbytes;
  }
};

struct MbCtx {
  bool valid = false;      // false = column 0 (no left MB)
  bool intra = false, i16 = false, skip = false;
  uint8_t cbf_luma[4][4] = {};     // [by][bx]
  uint8_t cbf_luma_dc = 0;
  uint8_t cbf_cb[2][2] = {}, cbf_cr[2][2] = {};
  uint8_t cbf_cb_dc = 0, cbf_cr_dc = 0;
  int cbp_luma = 0, cbp_chroma = 0;
  int abs_mvd[2] = {0, 0};         // (x, y)
};

struct SliceCoder {
  Engine e;
  bool intra_slice;
  MbCtx left;
  int prev_qp_delta_nz = 0;

  // -- residual (9.3.3.1.3) --
  int residual(const int32_t* c, int n, int cat, int cbf_inc) {
    int last_nz = -1;
    for (int i = 0; i < n; ++i) if (c[i]) last_nz = i;
    int cbf = last_nz >= 0 ? 1 : 0;
    e.decision(85 + kCbfOff[cat] + cbf_inc, cbf);
    if (!cbf) return 0;
    int sig_base = 105 + kSigOff[cat], last_base = 166 + kSigOff[cat];
    for (int i = 0; i < n - 1; ++i) {
      int inc = (cat == 3) ? (i < 2 ? i : 2) : i;
      int sig = c[i] ? 1 : 0;
      e.decision(sig_base + inc, sig);
      if (sig) {
        e.decision(last_base + inc, i == last_nz ? 1 : 0);
        if (i == last_nz) break;
      }
    }
    int abs_base = 227 + kAbsOff[cat];
    int num_eq1 = 0, num_gt1 = 0;
    for (int i = last_nz; i >= 0; --i) {
      if (!c[i]) continue;
      int a = c[i] < 0 ? -c[i] : c[i];
      int lvl = a - 1;
      int c0 = abs_base + (num_gt1 ? 0 : (num_eq1 + 1 < 4 ? num_eq1 + 1 : 4));
      int capn = (cat == 3) ? 3 : 4;
      int cn = abs_base + 5 + (num_gt1 < capn ? num_gt1 : capn);
      int prefix = lvl < 14 ? lvl : 14;
      for (int k = 0; k < prefix; ++k) e.decision(k == 0 ? c0 : cn, 1);
      if (prefix < 14) e.decision(prefix == 0 ? c0 : cn, 0);
      else e.ueg_suffix(lvl - 14, 0);
      e.bypass(c[i] < 0 ? 1 : 0);
      if (lvl == 0) ++num_eq1; else ++num_gt1;
    }
    return 1;
  }

  void mb_skip(bool skip) {
    int inc = (left.valid && !left.skip) ? 1 : 0;
    e.decision(11 + inc, skip ? 1 : 0);
  }
  void mb_type_i(bool i4, int pred_mode, bool cbp_luma_nz, int cbp_chroma) {
    if (intra_slice) {
      int inc = (left.valid && left.i16) ? 1 : 0;
      e.decision(3 + inc, i4 ? 0 : 1);
      if (i4) return;
      e.terminate(0);
      e.decision(6, cbp_luma_nz ? 1 : 0);
      e.decision(7, cbp_chroma ? 1 : 0);
      if (cbp_chroma) e.decision(8, cbp_chroma == 2 ? 1 : 0);
      e.decision(9, (pred_mode >> 1) & 1);
      e.decision(10, pred_mode & 1);
    } else {
      e.decision(14, 1);
      e.decision(17, i4 ? 0 : 1);
      if (i4) return;
      e.terminate(0);
      e.decision(18, cbp_luma_nz ? 1 : 0);
      e.decision(19, cbp_chroma ? 1 : 0);
      if (cbp_chroma) e.decision(19, cbp_chroma == 2 ? 1 : 0);
      e.decision(20, (pred_mode >> 1) & 1);
      e.decision(20, pred_mode & 1);
    }
  }
  void mb_type_p16() { e.decision(14, 0); e.decision(15, 0); e.decision(16, 0); }

  void mvd(int comp, int val) {
    int base = comp == 0 ? 40 : 47;
    int s = left.valid ? left.abs_mvd[comp] : 0;
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    int a = val < 0 ? -val : val;
    int prefix = a < 9 ? a : 9;
    int ctxs[5] = {base + inc, base + 3, base + 4, base + 5, base + 6};
    for (int k = 0; k < prefix; ++k) e.decision(ctxs[k < 4 ? k : 4], 1);
    if (prefix < 9) e.decision(ctxs[prefix < 4 ? prefix : 4], 0);
    else e.ueg_suffix(a - 9, 3);
    if (a) e.bypass(val < 0 ? 1 : 0);
  }

  void intra_chroma_mode0() { e.decision(64, 0); }   // DC only (inc == 0)

  void i4_pred_mode(int mode, int pred) {
    if (mode == pred) { e.decision(68, 1); return; }
    e.decision(68, 0);
    int rem = mode > pred ? mode - 1 : mode;
    e.decision(69, rem & 1);
    e.decision(69, (rem >> 1) & 1);
    e.decision(69, (rem >> 2) & 1);
  }

  void cbp(int cbp_luma, int cbp_chroma) {
    for (int b = 0; b < 4; ++b) {
      int a_bit, a_avail;
      if (b & 1) { a_bit = (cbp_luma >> (b - 1)) & 1; a_avail = 1; }
      else { a_bit = left.valid ? ((left.cbp_luma >> (b + 1)) & 1) : 0;
             a_avail = left.valid ? 1 : 0; }
      int b_bit = 0, b_avail = 0;
      if (b & 2) { b_bit = (cbp_luma >> (b - 2)) & 1; b_avail = 1; }
      int inc = ((a_avail && !a_bit) ? 1 : 0) + 2 * ((b_avail && !b_bit) ? 1 : 0);
      e.decision(73 + inc, (cbp_luma >> b) & 1);
    }
    int ca = left.valid ? left.cbp_chroma : 0;
    e.decision(77 + (ca > 0 ? 1 : 0), cbp_chroma ? 1 : 0);
    if (cbp_chroma)
      e.decision(81 + (ca == 2 ? 1 : 0), cbp_chroma == 2 ? 1 : 0);
  }

  void qp_delta_zero() {
    e.decision(60 + prev_qp_delta_nz, 0);
    prev_qp_delta_nz = 0;
  }
  void qp_delta_absent() { prev_qp_delta_nz = 0; }
  void end_of_slice(bool last) { e.terminate(last ? 1 : 0); }

  int cbf_inc_luma(const uint8_t cur[4][4], int bx, int by, bool intra) {
    int a;
    if (bx > 0) a = cur[by][bx - 1];
    else if (left.valid && !left.skip) a = left.cbf_luma[by][3];
    else if (left.valid) a = 0;
    else a = intra ? 1 : 0;
    int b = (by > 0) ? cur[by - 1][bx] : (intra ? 1 : 0);
    return a + 2 * b;
  }
  int cbf_inc_chroma(const uint8_t cur[2][2], const uint8_t lgrid[2][2],
                     int bx, int by, bool intra) {
    int a;
    if (bx > 0) a = cur[by][bx - 1];
    else if (left.valid && !left.skip) a = lgrid[by][1];
    else if (left.valid) a = 0;
    else a = intra ? 1 : 0;
    int b = (by > 0) ? cur[by - 1][bx] : (intra ? 1 : 0);
    return a + 2 * b;
  }
  int cbf_inc_dc(uint8_t left_dc, bool left_has, bool intra) {
    int a = left.valid ? ((left.skip || !left_has) ? 0 : left_dc)
                       : (intra ? 1 : 0);
    int b = intra ? 1 : 0;
    return a + 2 * b;
  }
};

void init_slice(SliceCoder& sc, const int8_t* ctx_init, int qp,
                const uint8_t* rng, const uint8_t* tm, const uint8_t* tl,
                bool intra_slice) {
  sc.e.rng_lps = rng; sc.e.t_mps = tm; sc.e.t_lps = tl;
  int q = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
  for (int i = 0; i < 1024; ++i) {
    int m = ctx_init[2 * i], n = ctx_init[2 * i + 1];
    int pre = ((m * q) >> 4) + n;
    pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
    if (pre > 63) { sc.e.state[i] = (uint8_t)(pre - 64); sc.e.mps[i] = 1; }
    else { sc.e.state[i] = (uint8_t)(63 - pre); sc.e.mps[i] = 0; }
  }
  sc.intra_slice = intra_slice;
}

}  // namespace

extern "C" {

int32_t tpudesktop_cabac_abi_version() { return 1; }

// Intra picture: one slice payload per MB row, written at out + row*cap.
// Returns 0 on success; lens[row] = payload bytes.  Arrays are the same
// shapes the Python assembler takes (see h264_cabac.encode_intra_picture).
int64_t h264_cabac_intra_slices(
    const int32_t* luma_dc,    // (R,C,16)
    const int32_t* luma_ac,    // (R,C,16,15)
    const int32_t* cb_dc, const int32_t* cb_ac,   // (R,C,4), (R,C,4,15)
    const int32_t* cr_dc, const int32_t* cr_ac,
    const int32_t* pred_mode,  // (R,C)
    const uint8_t* mb_i4,      // (R,C)
    const int32_t* i4_modes,   // (R,C,16)
    const int32_t* luma_i4,    // (R,C,16,16)
    int64_t nr, int64_t nc, int32_t qp,
    const int8_t* ctx_init,    // (1024,2) I table
    const uint8_t* rng_lps, const uint8_t* trans_mps,
    const uint8_t* trans_lps,
    uint8_t* out, int64_t* lens, int64_t cap) {
  std::atomic<int64_t> fail{0};
  auto code_row = [&](int64_t my) {
    {
      SliceCoder sc;
      init_slice(sc, ctx_init, qp, rng_lps, trans_mps, trans_lps, true);
      for (int64_t mx = 0; mx < nc; ++mx) {
        int64_t mb = my * nc + mx;
        // chroma cbp
        bool c_ac = false, c_dc = false;
        for (int b = 0; b < 4; ++b) {
          if (cb_dc[mb * 4 + b] || cr_dc[mb * 4 + b]) c_dc = true;
          for (int k = 0; k < 15; ++k)
            if (cb_ac[(mb * 4 + b) * 15 + k] || cr_ac[(mb * 4 + b) * 15 + k])
              c_ac = true;
        }
        int cc = c_ac ? 2 : (c_dc ? 1 : 0);
        MbCtx ctx;
        ctx.valid = true; ctx.intra = true;
        if (mb_i4[mb]) {
          int cl4 = 0;
          for (int blk = 0; blk < 16; ++blk)
            for (int k = 0; k < 16; ++k)
              if (luma_i4[(mb * 16 + blk) * 16 + k]) {
                cl4 |= 1 << (blk / 4); break;
              }
          sc.mb_type_i(true, 0, false, 0);
          for (int blk = 0; blk < 16; ++blk) {
            int bx = kBlkX[blk], by = kBlkY[blk];
            // predictor: min(A, B), DC(2) when either unavailable.
            // A crosses into the left MB's bx=3 column; B within MB.
            int ma, ava, mbv, avb;
            if (bx > 0) {
              int ablk = -1;
              for (int t = 0; t < 16; ++t)
                if (kBlkX[t] == bx - 1 && kBlkY[t] == by) { ablk = t; break; }
              ma = mb_i4[mb] ? i4_modes[mb * 16 + ablk] : 2;  // same MB
              ava = 1;
            } else if (mx > 0) {
              int64_t lmb = mb - 1;
              int ablk = -1;
              for (int t = 0; t < 16; ++t)
                if (kBlkX[t] == 3 && kBlkY[t] == by) { ablk = t; break; }
              ma = mb_i4[lmb] ? i4_modes[lmb * 16 + ablk] : 2;
              ava = 1;
            } else { ma = 2; ava = 0; }
            if (by > 0) {
              int bblk = -1;
              for (int t = 0; t < 16; ++t)
                if (kBlkX[t] == bx && kBlkY[t] == by - 1) { bblk = t; break; }
              mbv = mb_i4[mb] ? i4_modes[mb * 16 + bblk] : 2;
              avb = 1;
            } else { mbv = 2; avb = 0; }
            int pred = (ava && avb) ? (ma < mbv ? ma : mbv) : 2;
            sc.i4_pred_mode(i4_modes[mb * 16 + blk], pred);
          }
          sc.intra_chroma_mode0();
          sc.cbp(cl4, cc);
          if (cl4 || cc) sc.qp_delta_zero(); else sc.qp_delta_absent();
          for (int blk = 0; blk < 16; ++blk) {
            if (cl4 & (1 << (blk / 4))) {
              int bx = kBlkX[blk], by = kBlkY[blk];
              int inc = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, true);
              ctx.cbf_luma[by][bx] = (uint8_t)sc.residual(
                  &luma_i4[(mb * 16 + blk) * 16], 16, 2, inc);
            }
          }
          ctx.i16 = false; ctx.cbp_luma = cl4;
        } else {
          bool cl = false;
          for (int blk = 0; blk < 16 && !cl; ++blk)
            for (int k = 0; k < 15; ++k)
              if (luma_ac[(mb * 16 + blk) * 15 + k]) { cl = true; break; }
          sc.mb_type_i(false, pred_mode[mb], cl, cc);
          sc.intra_chroma_mode0();
          sc.qp_delta_zero();
          int inc = sc.cbf_inc_dc(sc.left.cbf_luma_dc,
                                  sc.left.i16, true);
          ctx.cbf_luma_dc =
              (uint8_t)sc.residual(&luma_dc[mb * 16], 16, 0, inc);
          if (cl) {
            for (int blk = 0; blk < 16; ++blk) {
              int bx = kBlkX[blk], by = kBlkY[blk];
              int inc2 = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, true);
              ctx.cbf_luma[by][bx] = (uint8_t)sc.residual(
                  &luma_ac[(mb * 16 + blk) * 15], 15, 1, inc2);
            }
          }
          ctx.i16 = true; ctx.cbp_luma = cl ? 0xF : 0;
        }
        // chroma residuals
        if (cc > 0) {
          int inc = sc.cbf_inc_dc(sc.left.cbf_cb_dc, !sc.left.skip, true);
          ctx.cbf_cb_dc = (uint8_t)sc.residual(&cb_dc[mb * 4], 4, 3, inc);
          inc = sc.cbf_inc_dc(sc.left.cbf_cr_dc, !sc.left.skip, true);
          ctx.cbf_cr_dc = (uint8_t)sc.residual(&cr_dc[mb * 4], 4, 3, inc);
        }
        if (cc == 2) {
          for (int b = 0; b < 4; ++b) {
            int by = b / 2, bx = b % 2;
            int inc = sc.cbf_inc_chroma(ctx.cbf_cb, sc.left.cbf_cb,
                                        bx, by, true);
            ctx.cbf_cb[by][bx] = (uint8_t)sc.residual(
                &cb_ac[(mb * 4 + b) * 15], 15, 4, inc);
          }
          for (int b = 0; b < 4; ++b) {
            int by = b / 2, bx = b % 2;
            int inc = sc.cbf_inc_chroma(ctx.cbf_cr, sc.left.cbf_cr,
                                        bx, by, true);
            ctx.cbf_cr[by][bx] = (uint8_t)sc.residual(
                &cr_ac[(mb * 4 + b) * 15], 15, 4, inc);
          }
        }
        ctx.cbp_chroma = cc;
        sc.left = ctx;
        sc.end_of_slice(mx == nc - 1);
      }
      int64_t nbytes = (int64_t)(sc.e.bits.size() + 7) / 8;
      if (nbytes > cap) { fail.store(1); return; }
      lens[my] = sc.e.pack(out + my * cap);
    }
  };
  RowPool::instance().run(nr, code_row);
  return fail.load() ? -1 : 0;
}

// P picture slices (P_L0_16x16 + P_Skip).
int64_t h264_cabac_p_slices(
    const int32_t* mv,         // (R,C,2) (y, x) quarter-pel
    const int32_t* luma,       // (R,C,16,16)
    const int32_t* cb_dc, const int32_t* cb_ac,
    const int32_t* cr_dc, const int32_t* cr_ac,
    int64_t nr, int64_t nc, int32_t qp,
    const int8_t* ctx_init,    // (1024,2): table for 1 + cabac_init_idc
    const uint8_t* rng_lps, const uint8_t* trans_mps,
    const uint8_t* trans_lps,
    uint8_t* out, int64_t* lens, int64_t cap) {
  std::atomic<int64_t> fail{0};
  auto code_row = [&](int64_t my) {
    {
      SliceCoder sc;
      init_slice(sc, ctx_init, qp, rng_lps, trans_mps, trans_lps, false);
      int mvp[2] = {0, 0};
      for (int64_t mx = 0; mx < nc; ++mx) {
        int64_t mb = my * nc + mx;
        int cbp_luma = 0;
        for (int blk = 0; blk < 16; ++blk)
          for (int k = 0; k < 16; ++k)
            if (luma[(mb * 16 + blk) * 16 + k]) {
              cbp_luma |= 1 << (blk / 4); break;
            }
        bool c_ac = false, c_dc = false;
        for (int b = 0; b < 4; ++b) {
          if (cb_dc[mb * 4 + b] || cr_dc[mb * 4 + b]) c_dc = true;
          for (int k = 0; k < 15; ++k)
            if (cb_ac[(mb * 4 + b) * 15 + k] || cr_ac[(mb * 4 + b) * 15 + k])
              c_ac = true;
        }
        int cc = c_ac ? 2 : (c_dc ? 1 : 0);
        int mv_y = mv[mb * 2], mv_x = mv[mb * 2 + 1];
        bool skip = (mv_y == 0 && mv_x == 0 && cbp_luma == 0 && cc == 0);
        MbCtx ctx;
        ctx.valid = true;
        if (skip) {
          sc.mb_skip(true);
          sc.qp_delta_absent();
          ctx.skip = true;
          mvp[0] = 0; mvp[1] = 0;
          sc.left = ctx;
          sc.end_of_slice(mx == nc - 1);
          continue;
        }
        sc.mb_skip(false);
        sc.mb_type_p16();
        int mvd_x = mv_x - mvp[1], mvd_y = mv_y - mvp[0];
        sc.mvd(0, mvd_x);
        sc.mvd(1, mvd_y);
        ctx.abs_mvd[0] = mvd_x < 0 ? -mvd_x : mvd_x;
        ctx.abs_mvd[1] = mvd_y < 0 ? -mvd_y : mvd_y;
        mvp[0] = mv_y; mvp[1] = mv_x;
        sc.cbp(cbp_luma, cc);
        if (cbp_luma || cc) sc.qp_delta_zero(); else sc.qp_delta_absent();
        for (int blk = 0; blk < 16; ++blk) {
          if (cbp_luma & (1 << (blk / 4))) {
            int bx = kBlkX[blk], by = kBlkY[blk];
            int inc = sc.cbf_inc_luma(ctx.cbf_luma, bx, by, false);
            ctx.cbf_luma[by][bx] = (uint8_t)sc.residual(
                &luma[(mb * 16 + blk) * 16], 16, 2, inc);
          }
        }
        if (cc > 0) {
          int inc = sc.cbf_inc_dc(sc.left.cbf_cb_dc, !sc.left.skip, false);
          ctx.cbf_cb_dc = (uint8_t)sc.residual(&cb_dc[mb * 4], 4, 3, inc);
          inc = sc.cbf_inc_dc(sc.left.cbf_cr_dc, !sc.left.skip, false);
          ctx.cbf_cr_dc = (uint8_t)sc.residual(&cr_dc[mb * 4], 4, 3, inc);
        }
        if (cc == 2) {
          for (int b = 0; b < 4; ++b) {
            int by = b / 2, bx = b % 2;
            int inc = sc.cbf_inc_chroma(ctx.cbf_cb, sc.left.cbf_cb,
                                        bx, by, false);
            ctx.cbf_cb[by][bx] = (uint8_t)sc.residual(
                &cb_ac[(mb * 4 + b) * 15], 15, 4, inc);
          }
          for (int b = 0; b < 4; ++b) {
            int by = b / 2, bx = b % 2;
            int inc = sc.cbf_inc_chroma(ctx.cbf_cr, sc.left.cbf_cr,
                                        bx, by, false);
            ctx.cbf_cr[by][bx] = (uint8_t)sc.residual(
                &cr_ac[(mb * 4 + b) * 15], 15, 4, inc);
          }
        }
        ctx.cbp_luma = cbp_luma; ctx.cbp_chroma = cc;
        sc.left = ctx;
        sc.end_of_slice(mx == nc - 1);
      }
      int64_t nbytes = (int64_t)(sc.e.bits.size() + 7) / 8;
      if (nbytes > cap) { fail.store(1); return; }
      lens[my] = sc.e.pack(out + my * cap);
    }
  };
  RowPool::instance().run(nr, code_row);
  return fail.load() ? -1 : 0;
}

// Arithmetic-engine-only rows: replay a device-binarized record stream
// (ops/cabac_binarize wire format).  The device already computed every
// bin value and ctxIdx; this entry does NOTHING but run the spec 9.3.4
// engine over the records — the irreducible sequential core.  Records
// (MSB-first): 0+ctx(9)+bin(1) decision; 10+ctx(9)+cnt(4) run of cnt
// 1-bins; 110+cnt(4)+bits bypass run; 111+bin terminate.  row_bits
// bounds each row exactly (the zero-padded word tail must not read as
// a decision record).
int64_t h264_cabac_engine_rows(
    const uint32_t* payload, const int64_t* row_off,  // word offsets
    const int64_t* row_bits, int64_t rows,
    int32_t qp,
    const int8_t* ctx_init,    // (1024,2) table for this slice type
    const uint8_t* rng_lps, const uint8_t* trans_mps,
    const uint8_t* trans_lps,
    uint8_t* out, int64_t* lens, int64_t cap) {
  std::atomic<int64_t> fail{0};
  auto code_row = [&](int64_t my) {
    SliceCoder sc;
    init_slice(sc, ctx_init, qp, rng_lps, trans_mps, trans_lps, true);
    const uint32_t* w = payload + row_off[my];
    int64_t nbits = row_bits[my];
    int64_t nwords = row_off[my + 1] - row_off[my];
    // 64-bit bit cache: field extraction is O(1), not per-bit — the
    // record parse must cost less than the engine it feeds.  Reads
    // past the row's words yield zeros (a malformed stream then fails
    // the exact-bit-count check instead of reading out of bounds).
    uint64_t cache = 0;
    int cbits = 0;
    int64_t wpos = 0;
    auto rd = [&](int n) -> uint32_t {
      while (cbits < n) {
        uint32_t nw = (wpos < nwords) ? w[wpos] : 0u;
        ++wpos;
        cache = (cache << 32) | (uint64_t)nw;
        cbits += 32;
      }
      cbits -= n;
      return (uint32_t)((cache >> cbits) & ((1u << n) - 1u));
    };
    auto pos = [&]() -> int64_t { return wpos * 32 - cbits; };
    while (pos() < nbits) {
      if (rd(1) == 0) {                       // DEC
        uint32_t v = rd(10);                  // ctx(9) + bin(1)
        sc.e.decision((int)(v >> 1), (int)(v & 1u));
      } else if (rd(1) == 0) {                // RUN
        uint32_t v = rd(13);                  // ctx(9) + cnt(4)
        int ctx = (int)(v >> 4);
        uint32_t cnt = v & 15u;
        for (uint32_t k = 0; k < cnt; ++k) sc.e.decision(ctx, 1);
      } else if (rd(1) == 0) {                // BYP
        uint32_t cnt = rd(4);
        uint32_t bits = rd((int)cnt);
        for (uint32_t k = cnt; k-- > 0;)
          sc.e.bypass((int)((bits >> k) & 1u));
      } else {                                // TRM
        sc.e.terminate((int)rd(1));
      }
    }
    if (pos() != nbits) { fail.store(2); return; }
    int64_t nbytes = (int64_t)(sc.e.bits.size() + 7) / 8;
    if (nbytes > cap) { fail.store(1); return; }
    lens[my] = sc.e.pack(out + my * cap);
  };
  RowPool::instance().run(rows, code_row);
  return fail.load() ? -fail.load() : 0;
}

}  // extern "C"
