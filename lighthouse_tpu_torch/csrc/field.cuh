// BLS12-381 field library for the hand-written CUDA kernels (sm_90a).
//
// Transcribes the in-kernel field helpers `_k*` of
// lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py (lines 58-472) that the
// Fp6 product reaches -- the Fp reduction, Fp2 and Fp6 Karatsuba -- on the
// same representation: 12-bit signed limbs in int32, width W = 35, lazy
// form limbs in [-1, 2^12]. It also holds the constants and the FOLD_R
// tables that the warp-cooperative layer (field_coop.cuh) builds on.
//
// BIT IDENTITY. Every function returns the same int32 limbs as its PyTorch
// (and JAX) counterpart:
//   * integer column sums are exact whatever the order (the bounds of
//     limbs.py keep every partial sum far below 2^31), so the column loops
//     may run in any order;
//   * the carry/fold schedule is reproduced exactly: reduce = carry3, fold,
//     fold; add/sub = one fold of the raw sum.
//     A carry round maps width w to w + 1 and keeps every carry, so the
//     widths below are those of the JAX arrays and nothing is truncated.
//
// Layout: an Fp element is int[W]; Fp2 is int[2W] (c0, c1); Fp6 is three
// Fp2; Fp12 is two Fp6 -- the (..., 2, 3, 2, W) order of the tower, flat.
// Every function writes its result through a local temporary, so an
// output may alias an input.
//
// DESIGN (simple first): one thread per row, the whole working set in
// registers and local memory. The Fp2-level helpers are __noinline__, so
// the Fp6 product does not inline its six Fp2 products; their frames live
// on the thread stack (local memory, cached in L1/L2), which the CUDA
// runtime sizes at launch. Only the kernel of fp6_mul runs on this layer;
// fp_mul and fp_sq (a warp per row) and miller_dbl_step, miller_add_step,
// fp12_mul and fp12_cyclotomic_sq (a block per row) run on the
// warp-cooperative layer of field_coop.cuh, which gives the same integers.
#pragma once

#include <cuda_runtime.h>

namespace lh {

constexpr int BITS = 12;
constexpr int MASK = (1 << BITS) - 1;
constexpr int NL = 32;           // canonical limbs
constexpr int W = NL + 3;        // working width
constexpr int NCOL = 2 * W - 1;  // schoolbook columns
constexpr int NFOLD = 44;        // FOLD_R rows
constexpr int F2 = 2 * W, F6 = 6 * W, F12 = 12 * W;

// FOLD_R[r][j] = limbs(2^(12*(32+r)) mod p), j < 32 (the part folds read):
// in constant memory for the one-thread kernel, whose lanes read one row
// entry at a time, and in global memory for the kernels of field_coop.cuh,
// whose lanes read a row at once (constant memory serialises different
// addresses): read there directly, or copied into shared memory
__constant__ int FOLD[NFOLD * NL];
__device__ int FOLD_G[NFOLD * NL];

// --- Fp core -----------------------------------------------------------------

// One carry round in place: width w -> w + 1 (x has room for w + 1).
// x & MASK == x - ((x >> 12) << 12) in two's complement; >> is arithmetic.
__device__ __forceinline__ void carry_round(int* x, int w) {
  int prev = 0;
  for (int i = 0; i < w; ++i) {
    int v = x[i];
    x[i] = (v & MASK) + prev;
    prev = v >> BITS;
  }
  x[w] = prev;
}

__device__ __forceinline__ void carry3(int* x, int w) {
  carry_round(x, w);
  carry_round(x, w + 1);
  carry_round(x, w + 2);
}

// limbs._fold_round: x of width w (NL < w <= NL + NFOLD) -> width W.
__device__ __noinline__ void fold(int* x, int w) {
  int acc[NL];
  for (int j = 0; j < NL; ++j) acc[j] = x[j];
  for (int r = 0; r < w - NL; ++r) {
    int h = x[NL + r];
    const int* row = FOLD + r * NL;
    for (int j = 0; j < NL; ++j) acc[j] += h * row[j];
  }
  for (int j = 0; j < NL; ++j) x[j] = acc[j];
  carry3(x, NL);
}

// limbs.reduce_columns: cols of width NCOL (room for NCOL + 3) -> x[0..W).
__device__ __noinline__ void reduce(int* cols) {
  carry3(cols, NCOL);       // width 72
  fold(cols, NCOL + 3);     // 40 fold rows -> width 35
  fold(cols, W);            // 3 fold rows  -> width 35
}

// schoolbook columns, cols[k] = sum_{i+j=k} a_i b_j (room for NCOL + 3)
__device__ __noinline__ void mul_cols(int* cols, const int* a, const int* b) {
  for (int k = 0; k < NCOL; ++k) cols[k] = 0;
  for (int i = 0; i < W; ++i) {
    int ai = a[i];
    for (int j = 0; j < W; ++j) cols[i + j] += ai * b[j];
  }
}

// n Fp elements at once: out = fold(a + sa * b) with sa = +1 (add) or
// -1 (sub).
__device__ __noinline__ void lin_n(int* out, const int* a, const int* b,
                                   int sa, int n) {
  for (int e = 0; e < n; ++e) {
    int t[W];
    for (int i = 0; i < W; ++i) t[i] = a[e * W + i] + sa * b[e * W + i];
    fold(t, W);
    for (int i = 0; i < W; ++i) out[e * W + i] = t[i];
  }
}

__device__ __forceinline__ void add_n(int* out, const int* a, const int* b, int n) {
  lin_n(out, a, b, 1, n);
}
__device__ __forceinline__ void sub_n(int* out, const int* a, const int* b, int n) {
  lin_n(out, a, b, -1, n);
}

__device__ __forceinline__ void copy_n(int* out, const int* a, int n) {
  for (int i = 0; i < n * W; ++i) out[i] = a[i];
}

// --- Fp2 (tower.fp2_*) ----------------------------------------------------------

// Karatsuba with column sharing: 3 column products, 2 shared reductions
__device__ __noinline__ void fp2_mul(int* out, const int* a, const int* b) {
  int t0[NCOL + 3], t1[NCOL + 3], tk[NCOL + 3];
  int sa[W], sb[W];
  mul_cols(t0, a, b);
  mul_cols(t1, a + W, b + W);
  add_n(sa, a, a + W, 1);
  add_n(sb, b, b + W, 1);
  mul_cols(tk, sa, sb);
  for (int k = 0; k < NCOL; ++k) {
    int x0 = t0[k], x1 = t1[k];
    t0[k] = x0 - x1;
    tk[k] = tk[k] - x0 - x1;
  }
  reduce(t0);
  reduce(tk);
  for (int i = 0; i < W; ++i) {
    out[i] = t0[i];
    out[W + i] = tk[i];
  }
}

// xi = 1 + u: (c0 - c1) + (c0 + c1) u
__device__ __noinline__ void fp2_mul_by_xi(int* out, const int* a) {
  int r[F2];
  sub_n(r, a, a + W, 1);
  add_n(r + W, a, a + W, 1);
  copy_n(out, r, 2);
}

// --- Fp6 (tower.fp6_mul) -------------------------------------------------

__device__ __noinline__ void fp6_mul(int* out, const int* a, const int* b) {
  const int *a0 = a, *a1 = a + F2, *a2 = a + 2 * F2;
  const int *b0 = b, *b1 = b + F2, *b2 = b + 2 * F2;
  int t0[F2], t1[F2], t2[F2], x[F2], y[F2], m[F2];
  int r[F6];
  fp2_mul(t0, a0, b0);
  fp2_mul(t1, a1, b1);
  fp2_mul(t2, a2, b2);
  // c0 = xi((a1+a2)(b1+b2) - t1 - t2) + t0
  add_n(x, a1, a2, 2);
  add_n(y, b1, b2, 2);
  fp2_mul(m, x, y);
  sub_n(m, m, t1, 2);
  sub_n(m, m, t2, 2);
  fp2_mul_by_xi(m, m);
  add_n(r, m, t0, 2);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi(t2)
  add_n(x, a0, a1, 2);
  add_n(y, b0, b1, 2);
  fp2_mul(m, x, y);
  sub_n(m, m, t0, 2);
  sub_n(m, m, t1, 2);
  fp2_mul_by_xi(x, t2);
  add_n(r + F2, m, x, 2);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  add_n(x, a0, a2, 2);
  add_n(y, b0, b2, 2);
  fp2_mul(m, x, y);
  sub_n(m, m, t0, 2);
  sub_n(m, m, t2, 2);
  add_n(r + 2 * F2, m, t1, 2);
  copy_n(out, r, 6);
}

}  // namespace lh

// FOLD_R as given by the host: (44, W) int32 row-major; keeps columns < 32.
extern "C" int lh_init(const int* fold_r) {
  int buf[lh::NFOLD * lh::NL];
  for (int r = 0; r < lh::NFOLD; ++r)
    for (int j = 0; j < lh::NL; ++j) buf[r * lh::NL + j] = fold_r[r * lh::W + j];
  cudaMemcpyToSymbol(lh::FOLD, buf, sizeof(buf));
  cudaMemcpyToSymbol(lh::FOLD_G, buf, sizeof(buf));
  return (int)cudaGetLastError();
}
