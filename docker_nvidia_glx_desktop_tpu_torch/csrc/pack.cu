// K3 — bit packer: a frame's CAVLC codeword slots -> the flat buffer of
// row RBSPs (4-byte aligned) behind a metadata header of big-endian words.
// K7 — the same for P slices: the MB header piece in place of the MB
// syntax, 26 blocks per MB, and each row's trailing skip-run piece after
// its MBs.
//
// K3 replaces docker_nvidia_glx_desktop_tpu/ops/cavlc_device.py:629
// pack_frame with ops/bitmerge.py slots_to_words :87, merge_pieces_dense
// :107, merge_pieces_tree :157, the row compaction and META :681-714;
// K7 replaces ops/cavlc_p_device.py:298 pack_p_frame.
// The bytes up to META_WORDS*4 + 4*total_words equal the reference's, and
// the overflow flag trips at the same caps (256-bit block and MB syntax
// or header, 2048-bit MB, FLAT_CAP_WORDS in all).  tune=hq: the frame's
// qp sum, when given, goes to META_QP_SUM_WORD (cavlc_device.py:707-708),
// and K7 takes the I16-in-P layout of 27 blocks (a template instance).
//
// What bounds it: bytes.  It reads the slot arrays once (~60 MB at 1080p)
// and writes ~0.5 MB.  No merge tree: per-MB bit counts (one thread per
// MB), a scan along each row (one thread per row) and over the rows (one
// thread), then one thread per coded piece (MB syntax or 4x4 block, and
// the slice header and stop bits of each row) OR-ing its codewords into
// the big-endian words at their bit offsets.  Codewords never share a
// bit, so the atomic ORs commute.
#include "common.cuh"

namespace {

constexpr int SLOTS = 34, HDR = 3;
constexpr int MAX_PIECES = 28;        // MB syntax or header + up to 27 blocks

// The slice type's layout, a compile-time pair: blocks per MB and slots
// of the MB's first piece (I: 27 blocks, 20 syntax slots; P: 26 blocks,
// 7 header slots).
template <int NB, int NS>
struct Layout {
  static constexpr int blocks = NB, syn = NS, pieces = NB + 1;
};
using ILayout = Layout<27, 20>;
using PLayout = Layout<26, 7>;
using PILayout = Layout<27, 7>;      // P with the I16-in-P DC block (tune=hq)
constexpr int BLOCK_CAP = 256, MB_CAP = 2048;
constexpr int META_WORDS = 1024, MAX_META_ROWS = 510;
constexpr int META_QP_SUM_WORD = 2 + 2 * MAX_META_ROWS;
constexpr int FLAT_CAP_WORDS = 1 << 17;
constexpr int FLAT_BYTES = 4 * (META_WORDS + FLAT_CAP_WORDS);

struct Scratch {
  int* piece_off;   // [nmb * MAX_PIECES] bit offset of each piece in its MB
  int* mb_bits;     // [nmb]
  int* mb_off;      // [nmb] bit offset of each MB in its row
  int* body_bits;   // [nr] header + MBs
  int* pad;         // [nr] alignment zeros after the stop bit
  int* row_bytes;   // [nr]
  int* word_off;    // [nr]
  int* flags;       // [0] overflow
  Scratch(int* s, int nmb, int nr)
      : piece_off(s), mb_bits(s + nmb * MAX_PIECES), mb_off(mb_bits + nmb),
        body_bits(mb_off + nmb), pad(body_bits + nr), row_bytes(pad + nr),
        word_off(row_bytes + nr), flags(word_off + nr) {}
  // one session's words: sessions' scratches are stacked, words() apart
  static __host__ __device__ size_t words(int nmb, int nr) {
    return (size_t)nmb * (MAX_PIECES + 2) + 4 * (size_t)nr + 8;
  }
  __device__ Scratch at(size_t off) const {
    Scratch o = *this;
    o.piece_off += off; o.mb_bits += off; o.mb_off += off; o.body_bits += off;
    o.pad += off; o.row_bytes += off; o.word_off += off; o.flags += off;
    return o;
  }
};

// Sessions: the SESS instantiations take the session from blockIdx.y (the
// one-thread meta kernel: blockIdx.x); a session's slots, runs, flat
// buffer and scratch follow the previous session's, the slice-header slots
// are shared (one geometry) or, with hdr_step = nr * HDR, stacked too (the
// spatial shards: each shard's rows carry their own first_mb_in_slice).
// One session launches the !SESS instantiations, the kernels as they were
// before the session axis.

__device__ __forceinline__ unsigned bswap(unsigned x) { return __byte_perm(x, 0, 0x0123); }

template <class Y, bool SESS>
__global__ void mb_bits_kernel(const int* lengths, const int* syn_lens, Scratch S, int nmb,
                               int nr) {
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  if constexpr (SESS) {
    const size_t sess = blockIdx.y;
    S = S.at(sess * Scratch::words(nmb, nr));
    lengths += sess * nmb * Y::blocks * SLOTS;
    syn_lens += sess * nmb * Y::syn;
  }
  bool ovf = false;
  int bits = 0;
  for (int k = 0; k < Y::syn; ++k) bits += syn_lens[mb * Y::syn + k];
  ovf |= bits > BLOCK_CAP;
  S.piece_off[mb * MAX_PIECES] = 0;
  int off = bits;
  for (int j = 0; j < Y::blocks; ++j) {
    S.piece_off[mb * MAX_PIECES + 1 + j] = off;
    int b = 0;
    for (int k = 0; k < SLOTS; ++k) b += lengths[(mb * Y::blocks + j) * SLOTS + k];
    ovf |= b > BLOCK_CAP;
    off += b;
  }
  ovf |= off > MB_CAP;
  S.mb_bits[mb] = off;
  if (ovf) atomicOr(S.flags, 1);
}

// run_lens: each row's trailing skip-run piece after its MBs (P), or null
template <bool SESS>
__global__ void row_scan_kernel(const int* hdr_lens, const int* run_lens, Scratch S, int nr,
                                int nc, int hdr_step) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nr) return;
  if constexpr (SESS) {
    const size_t sess = blockIdx.y;
    S = S.at(sess * Scratch::words(nr * nc, nr));
    if (run_lens) run_lens += sess * nr;
    hdr_lens += sess * hdr_step;
  }
  int off = hdr_lens[r * HDR] + hdr_lens[r * HDR + 1] + hdr_lens[r * HDR + 2];
  for (int c = 0; c < nc; ++c) {
    S.mb_off[r * nc + c] = off;
    off += S.mb_bits[r * nc + c];
  }
  if (run_lens) off += run_lens[r];
  const int pad = (8 - ((off + 1) % 8)) % 8;
  S.body_bits[r] = off;
  S.pad[r] = pad;
  S.row_bytes[r] = (off + pad + 1) / 8;
}

template <bool SESS>
__global__ void meta_kernel(Scratch S, uint8_t* flat, int nr, int nc, const int* qp_sum) {
  if constexpr (SESS) {
    const size_t sess = blockIdx.x;
    S = S.at(sess * Scratch::words(nr * nc, nr));
    flat += sess * FLAT_BYTES;
    if (qp_sum) qp_sum += sess;
  }
  unsigned* meta = reinterpret_cast<unsigned*>(flat);
  long long total = 0;
  for (int r = 0; r < nr; ++r) {
    S.word_off[r] = (int)total;
    meta[2 + r] = bswap((unsigned)S.row_bytes[r]);
    meta[2 + MAX_META_ROWS + r] = bswap((unsigned)total);
    total += (S.row_bytes[r] + 3) / 4;
  }
  const bool ovf = S.flags[0] != 0 || total > FLAT_CAP_WORDS;
  meta[0] = bswap(ovf ? 1u : 0u);
  meta[1] = bswap((unsigned)total);
  if (qp_sum) meta[META_QP_SUM_WORD] = bswap((unsigned)*qp_sum);
}

__device__ __forceinline__ void or_word(unsigned* words, long long k, unsigned x) {
  if (x && k < FLAT_CAP_WORDS) atomicOr(words + k, bswap(x));
}

// MSB-first: the codeword's last bit lands at bit (pos + len - 1).
__device__ void place(unsigned* words, long long pos, unsigned v, int len) {
  const long long w = pos >> 5;
  const int end = (int)(pos & 31) + len;
  if (end <= 32) {
    or_word(words, w, v << (32 - end));
  } else {
    or_word(words, w, v >> (end - 32));
    or_word(words, w + 1, v << (64 - end));
  }
}

template <class Y, bool SESS>
__global__ void scatter_kernel(const int* values, const int* lengths, const int* syn_vals,
                               const int* syn_lens, const int* hdr_vals, const int* hdr_lens,
                               const int* run_vals, const int* run_lens, Scratch S,
                               uint8_t* flat, int nr, int nc, int hdr_step) {
  const int nmb = nr * nc, np = Y::pieces;
  if constexpr (SESS) {
    const size_t sess = blockIdx.y;
    S = S.at(sess * Scratch::words(nmb, nr));
    flat += sess * FLAT_BYTES;
    values += sess * nmb * Y::blocks * SLOTS;
    lengths += sess * nmb * Y::blocks * SLOTS;
    syn_vals += sess * nmb * Y::syn;
    syn_lens += sess * nmb * Y::syn;
    if (run_lens) {
      run_vals += sess * nr;
      run_lens += sess * nr;
    }
    hdr_vals += sess * hdr_step;
    hdr_lens += sess * hdr_step;
  }
  unsigned* words = reinterpret_cast<unsigned*>(flat) + META_WORDS;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < nmb * np) {
    const int mb = gid / np, j = gid % np, r = mb / nc;
    long long pos = 32LL * S.word_off[r] + S.mb_off[mb] + S.piece_off[mb * MAX_PIECES + j];
    const int* v = j == 0 ? syn_vals + mb * Y::syn : values + (mb * Y::blocks + j - 1) * SLOTS;
    const int* l = j == 0 ? syn_lens + mb * Y::syn : lengths + (mb * Y::blocks + j - 1) * SLOTS;
    const int n = j == 0 ? Y::syn : SLOTS;
    for (int k = 0; k < n; ++k) {
      if (l[k] > 0) {
        place(words, pos, (unsigned)v[k], l[k]);
        pos += l[k];
      }
    }
  } else if (gid < nmb * np + nr) {
    const int r = gid - nmb * np;
    long long pos = 32LL * S.word_off[r];
    for (int k = 0; k < HDR; ++k) {
      const int len = hdr_lens[r * HDR + k];
      if (len > 0) {
        place(words, pos, (unsigned)hdr_vals[r * HDR + k], len);
        pos += len;
      }
    }
    // the trailing skip run (a zero-length piece is skipped: a shift by
    // 32 is undefined), then the rbsp stop bit '1' and zeros to the byte
    const int rl = run_lens ? run_lens[r] : 0;
    if (rl > 0) place(words, 32LL * S.word_off[r] + S.body_bits[r] - rl, (unsigned)run_vals[r], rl);
    place(words, 32LL * S.word_off[r] + S.body_bits[r], 1u << S.pad[r], S.pad[r] + 1);
  }
}

template <class Y, bool SESS>
int pack_kernels(const int* values, const int* lengths, const int* syn_vals, const int* syn_lens,
                 const int* run_vals, const int* run_lens, const int* hdr_vals,
                 const int* hdr_lens, uint8_t* flat, const Scratch& S, const int* qp_sum, int nr,
                 int nc, int ns, int hdr_step, cudaStream_t stream) {
  const int nmb = nr * nc;
  int e;
  mb_bits_kernel<Y, SESS><<<dim3((nmb + 127) / 128, ns), 128, 0, stream>>>(lengths, syn_lens,
                                                                            S, nmb, nr);
  if ((e = dngd_last_error())) return e;
  row_scan_kernel<SESS><<<dim3((nr + 63) / 64, ns), 64, 0, stream>>>(hdr_lens, run_lens, S, nr,
                                                                      nc, hdr_step);
  if ((e = dngd_last_error())) return e;
  meta_kernel<SESS><<<ns, 1, 0, stream>>>(S, flat, nr, nc, qp_sum);
  if ((e = dngd_last_error())) return e;
  const int n = nmb * (Y::blocks + 1) + nr;
  scatter_kernel<Y, SESS><<<dim3((n + 127) / 128, ns), 128, 0, stream>>>(
      values, lengths, syn_vals, syn_lens, hdr_vals, hdr_lens, run_vals, run_lens, S, flat, nr,
      nc, hdr_step);
  return dngd_last_error();
}

template <class Y>
int pack_launch(const int* values, const int* lengths, const int* syn_vals, const int* syn_lens,
                const int* run_vals, const int* run_lens, const int* hdr_vals,
                const int* hdr_lens, uint8_t* flat, int* scratch, const int* qp_sum, int nr,
                int nc, int ns, int hdr_sess, cudaStream_t stream) {
  const int nmb = nr * nc;
  if (nmb <= 0 || ns <= 0 || nr > MAX_META_ROWS) return cudaErrorInvalidValue;
  const Scratch S(scratch, nmb, nr);
  int e;
  if ((e = cudaMemsetAsync(flat, 0, (size_t)ns * FLAT_BYTES, stream))) return e;
  if (ns == 1) {
    if ((e = cudaMemsetAsync(S.flags, 0, 8 * sizeof(int), stream))) return e;
    return pack_kernels<Y, false>(values, lengths, syn_vals, syn_lens, run_vals, run_lens,
                                  hdr_vals, hdr_lens, flat, S, qp_sum, nr, nc, 1, 0, stream);
  }
  // each session's overflow flags: a strided column of the stack
  const size_t per = Scratch::words(nmb, nr) * sizeof(int);
  if ((e = cudaMemset2DAsync(S.flags, per, 0, 8 * sizeof(int), ns, stream))) return e;
  return pack_kernels<Y, true>(values, lengths, syn_vals, syn_lens, run_vals, run_lens,
                               hdr_vals, hdr_lens, flat, S, qp_sum, nr, nc, ns,
                               hdr_sess ? nr * HDR : 0, stream);
}

}  // namespace

// qp_sum: one int per session on the card (tune=hq) or null.  ns:
// sessions (1 = one frame): slots, runs, flats (FLAT_BYTES each), qp sums
// and scratches (Scratch::words each) stacked; one header-slot set, or
// (hdr_sess) one per session, stacked.
extern "C" int pack_frame_launch(const int* values, const int* lengths, const int* syn_vals,
                                 const int* syn_lens, const int* hdr_vals, const int* hdr_lens,
                                 uint8_t* flat, int* scratch, const int* qp_sum, int nr, int nc,
                                 int ns, int hdr_sess, cudaStream_t stream) {
  return pack_launch<ILayout>(values, lengths, syn_vals, syn_lens, nullptr, nullptr, hdr_vals,
                              hdr_lens, flat, scratch, qp_sum, nr, nc, ns, hdr_sess, stream);
}

// nb: blocks per MB, 26, or 27 with the I16-in-P DC block.
extern "C" int pack_p_frame_launch(const int* values, const int* lengths, const int* mbh_vals,
                                   const int* mbh_lens, const int* run_vals, const int* run_lens,
                                   const int* hdr_vals, const int* hdr_lens, uint8_t* flat,
                                   int* scratch, const int* qp_sum, int nr, int nc, int nb,
                                   int ns, int hdr_sess, cudaStream_t stream) {
  if (nb == 27)
    return pack_launch<PILayout>(values, lengths, mbh_vals, mbh_lens, run_vals, run_lens,
                                 hdr_vals, hdr_lens, flat, scratch, qp_sum, nr, nc, ns,
                                 hdr_sess, stream);
  if (nb != 26) return cudaErrorInvalidValue;
  return pack_launch<PLayout>(values, lengths, mbh_vals, mbh_lens, run_vals, run_lens, hdr_vals,
                              hdr_lens, flat, scratch, qp_sum, nr, nc, ns, hdr_sess, stream);
}
