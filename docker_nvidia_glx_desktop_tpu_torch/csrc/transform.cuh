// H.264 4x4 integer transforms and the MF/V quantisation shared by the
// intra (K1) and inter (K5) cores: the spec 8.5.12 butterflies, the 4x4
// and 2x2 DC Hadamards, JM/x264 fixed-point quant/dequant, and the
// reference's bit estimate that its mode decisions score.
#pragma once

namespace {

// MF and V per qp%6, by coefficient position class (a, b, c).
__constant__ int c_mf[3][6] = {{13107, 11916, 10082, 9362, 8192, 7282},
                               {5243, 4660, 4194, 3647, 3355, 2893},
                               {8066, 7490, 6554, 5825, 5243, 4559}};
__constant__ int c_v[3][6] = {{10, 11, 13, 14, 16, 18},
                              {16, 18, 20, 23, 25, 29},
                              {13, 14, 16, 18, 20, 23}};

__device__ __forceinline__ int pos_class(int i) {   // i = row*4 + col
  const int r = (i >> 2) & 1, c = i & 1;
  return (r == 0 && c == 0) ? 0 : ((r == 1 && c == 1) ? 1 : 2);
}

// Cf . X . Cf^T, X row-major 4x4.
__device__ void fdct4(const int* x, int* w) {
  int t[16];
  for (int j = 0; j < 4; ++j) {
    const int s03 = x[j] + x[12 + j], d03 = x[j] - x[12 + j];
    const int s12 = x[4 + j] + x[8 + j], d12 = x[4 + j] - x[8 + j];
    t[j] = s03 + s12; t[4 + j] = 2 * d03 + d12;
    t[8 + j] = s03 - s12; t[12 + j] = d03 - 2 * d12;
  }
  for (int i = 0; i < 4; ++i) {
    const int* a = t + 4 * i;
    const int s03 = a[0] + a[3], d03 = a[0] - a[3];
    const int s12 = a[1] + a[2], d12 = a[1] - a[2];
    w[4 * i] = s03 + s12; w[4 * i + 1] = 2 * d03 + d12;
    w[4 * i + 2] = s03 - s12; w[4 * i + 3] = d03 - 2 * d12;
  }
}

// Spec 8.5.12.2: rows first, then columns, then (x + 32) >> 6.
__device__ void idct4(const int* d, int* r) {
  int f[16];
  for (int i = 0; i < 4; ++i) {
    const int* a = d + 4 * i;
    const int e0 = a[0] + a[2], e1 = a[0] - a[2];
    const int e2 = (a[1] >> 1) - a[3], e3 = a[1] + (a[3] >> 1);
    f[4 * i] = e0 + e3; f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2; f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {
    const int g0 = f[j] + f[8 + j], g1 = f[j] - f[8 + j];
    const int g2 = (f[4 + j] >> 1) - f[12 + j], g3 = f[4 + j] + (f[12 + j] >> 1);
    r[j] = (g0 + g3 + 32) >> 6; r[4 + j] = (g1 + g2 + 32) >> 6;
    r[8 + j] = (g1 - g2 + 32) >> 6; r[12 + j] = (g0 - g3 + 32) >> 6;
  }
}

// H . X . H^T (4x4 Hadamard, no scaling).
__device__ void had4(const int* x, int* w) {
  int t[16];
  for (int j = 0; j < 4; ++j) {
    const int s01 = x[j] + x[4 + j], d01 = x[j] - x[4 + j];
    const int s23 = x[8 + j] + x[12 + j], d23 = x[8 + j] - x[12 + j];
    t[j] = s01 + s23; t[4 + j] = s01 - s23;
    t[8 + j] = d01 - d23; t[12 + j] = d01 + d23;
  }
  for (int i = 0; i < 4; ++i) {
    const int* a = t + 4 * i;
    const int s01 = a[0] + a[1], d01 = a[0] - a[1];
    const int s23 = a[2] + a[3], d23 = a[2] - a[3];
    w[4 * i] = s01 + s23; w[4 * i + 1] = s01 - s23;
    w[4 * i + 2] = d01 - d23; w[4 * i + 3] = d01 + d23;
  }
}

__device__ void had2(const int* x, int* w) {    // x = [a b; c d]
  w[0] = x[0] + x[1] + x[2] + x[3];
  w[1] = x[0] - x[1] + x[2] - x[3];
  w[2] = x[0] + x[1] - x[2] - x[3];
  w[3] = x[0] - x[1] - x[2] + x[3];
}

__device__ __forceinline__ int quant(int w, int mf, int f, int qbits) {
  const int l = (abs(w) * mf + f) >> qbits;
  return w < 0 ? -l : l;
}

// floor(log2(a)), a >= 1, as the reference computes it: XLA's float32
// log2 on the CPU lands just below the integer at 8192 and 32768.
__device__ __forceinline__ int flog2(int a) {
  return 31 - __clz(a) - ((a == 8192 || a == 32768) ? 1 : 0);
}

// The reference's CAVLC bit estimate of n levels (_level_bits_est): 3
// bits a nonzero plus 2 a magnitude bit above the first.
__device__ int level_bits(const int* lv, int n = 16) {
  int s = 0;
  for (int k = 0; k < n; ++k) {
    const int a = abs(lv[k]);
    if (a) s += 3 + 2 * flog2(a);
  }
  return s;
}

struct Qp {
  int m, s, qbits, f;
  // rounding offset f = 2^qbits / 3 for intra blocks, / 6 for inter
  __device__ Qp(int qp, bool intra = true)
      : m(qp % 6), s(qp / 6), qbits(15 + qp / 6),
        f((1 << (15 + qp / 6)) / (intra ? 3 : 6)) {}
  __device__ int q(int w, int i) const { return quant(w, c_mf[pos_class(i)][m], f, qbits); }
  __device__ int dq(int l, int i) const { return l * c_v[pos_class(i)][m] * (1 << s); }
  __device__ int q_dc(int w) const { return quant(w, c_mf[0][m], 2 * f, qbits + 1); }
};

}  // namespace
