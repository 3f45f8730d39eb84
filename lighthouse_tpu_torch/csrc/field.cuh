// BLS12-381 field library for the hand-written CUDA kernels (sm_90a).
//
// Transcribes the in-kernel field helpers `_k*` of
// lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py (lines 58-472): Fp, Fp2,
// Fp6, Fp12, the sparse line multiply and the Jacobian Miller steps, on the
// same representation -- 12-bit signed limbs in int32, width W = 35, lazy
// form limbs in [-1, 2^12].
//
// BIT IDENTITY. Every function returns the same int32 limbs as its PyTorch
// (and JAX) counterpart:
//   * integer column sums are exact whatever the order (the bounds of
//     limbs.py keep every partial sum far below 2^31), so the column loops
//     may run in any order;
//   * the carry/fold schedule is reproduced exactly: reduce = carry3, fold,
//     fold; norm = carry3, fold; add/sub/neg = one fold of the raw sum.
//     A carry round maps width w to w + 1 and keeps every carry, so the
//     widths below are those of the JAX arrays and nothing is truncated.
//
// Layout: an Fp element is int[W]; Fp2 is int[2W] (c0, c1); Fp6 is three
// Fp2; Fp12 is two Fp6 -- the (..., 2, 3, 2, W) order of the tower, flat.
// Every function writes its result through a local temporary, so an
// output may alias an input.
//
// DESIGN (simple first): one thread per row, the whole working set in
// registers and local memory. The Fp2-level helpers are __noinline__ so
// the fused Miller kernels build in seconds instead of inlining ~150 Fp2
// products each; their frames live on the thread stack (local memory,
// cached in L1/L2), which the CUDA runtime sizes at launch. The kernels of
// fp_mul, miller_add_step and fp6_mul run on this layer; fp_sq (a warp per
// row) and miller_dbl_step, fp12_mul and fp12_cyclotomic_sq (a block per
// row) run on the warp-cooperative layer of field_coop.cuh, which gives
// the same integers.
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
// in constant memory for the one-thread kernels, whose lanes read one row
// entry at a time, and in global memory for the block-per-row kernels of
// field_coop.cuh, which copy it into shared memory (their lanes read a row
// at once, and constant memory serialises different addresses)
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

// limbs._norm: x of width W (room for W + 3) -> carry3, one fold.
__device__ __noinline__ void norm(int* x) {
  carry3(x, W);
  fold(x, W + 3);
}

// schoolbook columns, cols[k] = sum_{i+j=k} a_i b_j (room for NCOL + 3)
__device__ __noinline__ void mul_cols(int* cols, const int* a, const int* b) {
  for (int k = 0; k < NCOL; ++k) cols[k] = 0;
  for (int i = 0; i < W; ++i) {
    int ai = a[i];
    for (int j = 0; j < W; ++j) cols[i + j] += ai * b[j];
  }
}

__device__ __noinline__ void fp_mul(int* out, const int* a, const int* b) {
  int cols[NCOL + 3];
  mul_cols(cols, a, b);
  reduce(cols);
  for (int i = 0; i < W; ++i) out[i] = cols[i];
}

// n Fp elements at once: out = fold(a + sa * b) with sa in {+1, -1, 0}
// (add, sub, neg(a) as sa = 0 with a negated).
__device__ __noinline__ void lin_n(int* out, const int* a, const int* b,
                                   int sa, int sign_a, int n) {
  for (int e = 0; e < n; ++e) {
    int t[W];
    for (int i = 0; i < W; ++i) {
      int v = sign_a * a[e * W + i];
      if (sa) v += sa * b[e * W + i];
      t[i] = v;
    }
    fold(t, W);
    for (int i = 0; i < W; ++i) out[e * W + i] = t[i];
  }
}

__device__ __forceinline__ void add_n(int* out, const int* a, const int* b, int n) {
  lin_n(out, a, b, 1, 1, n);
}
__device__ __forceinline__ void sub_n(int* out, const int* a, const int* b, int n) {
  lin_n(out, a, b, -1, 1, n);
}
__device__ __forceinline__ void neg_n(int* out, const int* a, int n) {
  lin_n(out, a, a, 0, -1, n);
}

// limbs.mul_small on n elements: norm(a * k), |k| <= 64
__device__ __noinline__ void mul_small_n(int* out, const int* a, int k, int n) {
  for (int e = 0; e < n; ++e) {
    int t[W + 3];
    for (int i = 0; i < W; ++i) t[i] = a[e * W + i] * k;
    norm(t);
    for (int i = 0; i < W; ++i) out[e * W + i] = t[i];
  }
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

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
__device__ __noinline__ void fp2_sq(int* out, const int* a) {
  int tc[NCOL + 3], c0[NCOL + 3];
  int s[W], d[W];
  mul_cols(tc, a, a + W);
  add_n(s, a, a + W, 1);
  sub_n(d, a, a + W, 1);
  mul_cols(c0, s, d);
  reduce(c0);
  for (int k = 0; k < NCOL; ++k) tc[k] = tc[k] + tc[k];
  reduce(tc);
  for (int i = 0; i < W; ++i) {
    out[i] = c0[i];
    out[W + i] = tc[i];
  }
}

// xi = 1 + u: (c0 - c1) + (c0 + c1) u
__device__ __noinline__ void fp2_mul_by_xi(int* out, const int* a) {
  int r[F2];
  sub_n(r, a, a + W, 1);
  add_n(r + W, a, a + W, 1);
  copy_n(out, r, 2);
}

// Fp2 x Fp: two plain Fp products
__device__ __noinline__ void fp2_mul_fp(int* out, const int* a, const int* s) {
  fp_mul(out, a, s);
  fp_mul(out + W, a + W, s);
}

// --- Fp6 (tower.fp6_mul, fp6_mul_by_v) ------------------------------------------

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

__device__ __noinline__ void fp6_mul_by_v(int* out, const int* a) {
  int r[F6];
  fp2_mul_by_xi(r, a + 2 * F2);
  copy_n(r + F2, a, 2);
  copy_n(r + 2 * F2, a + F2, 2);
  copy_n(out, r, 6);
}

// --- Miller step pieces (pairing.py) -----------------------------------------

// Fp6 * (a + b v): pairing._fp6_mul_s2
__device__ __noinline__ void fp6_mul_s2(int* out, const int* f6, const int* a,
                                        const int* b) {
  const int *d0 = f6, *d1 = f6 + F2, *d2 = f6 + 2 * F2;
  int x[F2], y[F2];
  int r[F6];
  fp2_mul(x, d0, a);
  fp2_mul(y, d2, b);
  fp2_mul_by_xi(y, y);
  add_n(r, x, y, 2);
  fp2_mul(x, d1, a);
  fp2_mul(y, d0, b);
  add_n(r + F2, x, y, 2);
  fp2_mul(x, d2, a);
  fp2_mul(y, d1, b);
  add_n(r + 2 * F2, x, y, 2);
  copy_n(out, r, 6);
}

// Fp6 * (c v): pairing._fp6_mul_s1
__device__ __noinline__ void fp6_mul_s1(int* out, const int* f6, const int* c) {
  int r[F6];
  fp2_mul(r, f6 + 2 * F2, c);
  fp2_mul_by_xi(r, r);
  fp2_mul(r + F2, f6, c);
  fp2_mul(r + 2 * F2, f6 + F2, c);
  copy_n(out, r, 6);
}

// pairing.mul_by_line: f * (c0 + cv v + cvw v w), line = [c0 | cv | cvw]
__device__ __noinline__ void mul_by_line(int* out, const int* f, const int* line) {
  const int *c0 = line, *cv = line + F2, *cvw = line + 2 * F2;
  const int *f0 = f, *f1 = f + F6;
  int t0[F6], t1[F6], s[F6], x[F6];
  int cs[F2];
  fp6_mul_s2(t0, f0, c0, cv);
  fp6_mul_s1(t1, f1, cvw);
  add_n(x, f0, f1, 6);
  add_n(cs, cv, cvw, 2);
  fp6_mul_s2(s, x, c0, cs);
  fp6_mul_by_v(x, t1);
  add_n(out, t0, x, 6);
  sub_n(s, s, t0, 6);
  sub_n(out + F6, s, t1, 6);
}

// pairing._jac_madd: madd-2007-bl, q = [xq | yq]
__device__ __noinline__ void jac_madd(int* out, const int* t, const int* q) {
  const int *x1 = t, *y1 = t + F2, *z1 = t + 2 * F2;
  const int *x2 = q, *y2 = q + F2;
  int z1z1[F2], u2[F2], s2[F2], h[F2], hh[F2], i[F2], j[F2], rr[F2], v[F2];
  int u[F2], w[F2];
  int r[F6];
  fp2_sq(z1z1, z1);
  fp2_mul(u2, x2, z1z1);
  fp2_mul(s2, y2, z1);
  fp2_mul(s2, s2, z1z1);
  sub_n(h, u2, x1, 2);
  fp2_sq(hh, h);
  mul_small_n(i, hh, 4, 2);
  fp2_mul(j, h, i);
  sub_n(u, s2, y1, 2);
  mul_small_n(rr, u, 2, 2);
  fp2_mul(v, x1, i);
  fp2_sq(u, rr);
  sub_n(u, u, j, 2);
  mul_small_n(w, v, 2, 2);
  sub_n(r, u, w, 2);                  // x3
  sub_n(u, v, r, 2);
  fp2_mul(u, rr, u);
  fp2_mul(w, y1, j);
  mul_small_n(w, w, 2, 2);
  sub_n(r + F2, u, w, 2);             // y3
  add_n(u, z1, h, 2);
  fp2_sq(u, u);
  sub_n(u, u, z1z1, 2);
  sub_n(r + 2 * F2, u, hh, 2);        // z3
  copy_n(out, r, 6);
}

// pairing._add_step: T + Q and the chord line through T, Q evaluated at P
__device__ __noinline__ void add_step(int* t_out, int* line, const int* t,
                                      const int* q, const int* xp,
                                      const int* yp) {
  const int *x = t, *y = t + F2, *z = t + 2 * F2;
  const int *xq = q, *yq = q + F2;
  int z2[F2], z3[F2], n[F2], d[F2], u[F2], v[F2];
  fp2_sq(z2, z);
  fp2_mul(z3, z2, z);
  fp2_mul(u, yq, z3);
  sub_n(n, y, u, 2);
  fp2_mul(u, xq, z2);
  sub_n(u, x, u, 2);
  fp2_mul(d, z, u);
  fp2_mul(u, n, xq);
  fp2_mul(v, d, yq);
  sub_n(line, u, v, 2);               // c0
  fp2_mul_fp(u, n, xp);
  neg_n(line + F2, u, 2);             // cv
  fp2_mul_fp(line + 2 * F2, d, yp);   // cvw
  jac_madd(t_out, t, q);
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
