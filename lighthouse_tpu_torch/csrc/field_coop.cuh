// Warp-cooperative BLS12-381 field layer: every kernel runs on it -- fp_mul
// and fp_sq a warp per row; miller_dbl_step, miller_add_step, fp6_mul,
// fp12_mul and fp12_cyclotomic_sq a block per row.
//
// One warp works on one Fp element. A value in flight lives in the warp's
// registers, `Limbs`: lane l holds limbs l, l + 32 and l + 64, every limb
// at or above the value's width is zero. Operands of a column product live
// in shared memory, where the block keeps its row state.
//
// BIT IDENTITY with gpu/limbs.py and gpu/tower.py (and so with the JAX
// text), step by step:
//   * integer column sums are exact whatever the order (limbs.py's bounds
//     keep every partial sum far below 2^31);
//   * a carry round computes x'[i] = (x[i] & MASK) + (x[i-1] >> 12) from the
//     values BEFORE the round (each lane takes its neighbour's carry by a
//     shuffle of the pre-round value), and x'[w] = x[w-1] >> 12 falls out
//     of the zero limbs above the width, so the widths need no bookkeeping
//     and nothing is truncated;
//   * fold gives lane j < 32 the sum x[j] + sum_r x[32+r] FOLD_R[r][j] in the
//     same order of r, then carry3 on width 32;
//   * the schoolbook columns are summed over i in the same order (lane l
//     owns columns l, l+32, l+64; b sits between zeros, so out-of-range
//     terms add 0);
//   * reduce, norm, add/sub, mul_small and lincomb keep limbs.py's widths
//     and order (carry3, fold, fold; carry3, fold; one fold of the sum);
//     the Fp2 and Fp6 pieces keep the order of kernels.fp6_mul_plain.
//
// SYNCHRONISATION. Every lane of a warp calls every function here (the
// shuffles name the full warp). `store` and `set_pad` sync the warp before
// writing (the lanes may still read the old contents) and after (other
// lanes read what was written). Across warps the kernels sync the block
// between phases and never let two warps of one phase touch one buffer.
#pragma once

#include "field.cuh"

namespace lh {
namespace coop {

constexpr unsigned FULL = 0xffffffffu;
// a column product's second operand: zeros, W limbs, zeros (indices
// W + l - t + 32 k, k < 3, stay inside [1, 101))
constexpr int PAD = 104;

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

struct Limbs {
  int v0, v1, v2;  // limbs lane, lane + 32, lane + 64
};

struct L2 {
  Limbs c0, c1;
};

__device__ __forceinline__ Limbs load(const int* x) {
  int l = lane();
  return {x[l], l < W - NL ? x[NL + l] : 0, 0};
}

// the W limbs of x (above W they are zero by the width invariant)
__device__ __forceinline__ void store(int* out, Limbs x) {
  int l = lane();
  __syncwarp();
  out[l] = x.v0;
  if (l < W - NL) out[NL + l] = x.v1;
  __syncwarp();
}

__device__ __forceinline__ L2 load2(const int* x) { return {load(x), load(x + W)}; }

__device__ __forceinline__ void store2(int* out, L2 x) {
  store(out, x.c0);
  store(out + W, x.c1);
}

// One carry round: x' = (x & MASK) + (x >> 12 shifted up one limb). WIDE:
// the value reaches limb 63 or above, so the third register takes part.
template <bool WIDE>
__device__ __forceinline__ Limbs carry_round(Limbs x) {
  int l = lane(), src = (l + 31) & 31;
  int r0 = __shfl_sync(FULL, x.v0 >> BITS, src);
  int r1 = __shfl_sync(FULL, x.v1 >> BITS, src);
  Limbs y;
  y.v0 = (x.v0 & MASK) + (l ? r0 : 0);
  y.v1 = (x.v1 & MASK) + (l ? r1 : r0);
  if (WIDE) {
    int r2 = __shfl_sync(FULL, x.v2 >> BITS, src);
    y.v2 = (x.v2 & MASK) + (l ? r2 : r1);
  } else {
    y.v2 = 0;
  }
  return y;
}

template <bool WIDE>
__device__ __forceinline__ Limbs carry3(Limbs x) {
  return carry_round<WIDE>(carry_round<WIDE>(carry_round<WIDE>(x)));
}

// limbs._fold_round of a value of width NL + ROWS -> width W
template <int ROWS>
__device__ __forceinline__ Limbs fold(Limbs x, const int* table) {
  int l = lane();
  int acc = x.v0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int h = __shfl_sync(FULL, r < NL ? x.v1 : x.v2, r & 31);
    acc += h * table[r * NL + l];
  }
  return carry3<false>({acc, 0, 0});
}

// Column product: cols[k] = sum_i a_i b_{k-i}, k < NCOL; a in shared
// memory (read as a broadcast), b in a padded buffer (see PAD)
__device__ __forceinline__ Limbs cols(const int* a, const int* bpad) {
  const int* b = bpad + W + lane();
  int c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    int at = a[t];
    if (t < NL) c0 += at * b[-t];                // column lane: b index lane - t
    c1 += at * b[NL - t];                        // column lane + 32
    if (t > 2 * NL - W) c2 += at * b[2 * NL - t];  // column lane + 64
  }
  return {c0, c1, c2};
}

// The warp's view of its block: the shared FOLD table and its own scratch.
struct Warp {
  const int* table;  // FOLD_R, NFOLD x NL: a shared copy, or FOLD_G itself
  int* pad;          // PAD ints, zero outside [W, 2W)
  int* tmp;          // W ints: a column product's first operand
  int* opa;          // 2 W ints each: Fp2 operands built by the caller
  int* opb;

  // --- Fp, in registers ------------------------------------------------------
  __device__ __forceinline__ Limbs add(Limbs a, Limbs b) const {
    return fold<W - NL>({a.v0 + b.v0, a.v1 + b.v1, 0}, table);
  }
  __device__ __forceinline__ Limbs sub(Limbs a, Limbs b) const {
    return fold<W - NL>({a.v0 - b.v0, a.v1 - b.v1, 0}, table);
  }
  // limbs._norm: carry3 (W -> W + 3), one fold
  __device__ __forceinline__ Limbs norm(Limbs x) const {
    return fold<W + 3 - NL>(carry3<false>(x), table);
  }
  __device__ __forceinline__ Limbs mul_small(Limbs a, int k) const {
    return norm({a.v0 * k, a.v1 * k, 0});
  }
  __device__ __forceinline__ Limbs lincomb(Limbs a, int ka, Limbs b, int kb) const {
    return norm({a.v0 * ka + b.v0 * kb, a.v1 * ka + b.v1 * kb, 0});
  }
  // limbs.reduce_columns: carry3 (NCOL -> NCOL + 3), fold (40 rows), fold
  __device__ __noinline__ Limbs reduce(Limbs c) const {
    return fold<W - NL>(fold<NCOL + 3 - NL>(carry3<true>(c), table), table);
  }

  __device__ __forceinline__ void set_pad(Limbs b) const {
    store(pad + W, b);
  }

  __device__ __noinline__ Limbs fp_mul(const int* a, const int* b) const {
    set_pad(load(b));
    return reduce(cols(a, pad));
  }

  // --- Fp2, in registers ---------------------------------------------------------
  __device__ __forceinline__ L2 add2(L2 a, L2 b) const {
    return {add(a.c0, b.c0), add(a.c1, b.c1)};
  }
  __device__ __forceinline__ L2 sub2(L2 a, L2 b) const {
    return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
  }
  __device__ __forceinline__ L2 mul_small2(L2 a, int k) const {
    return {mul_small(a.c0, k), mul_small(a.c1, k)};
  }
  __device__ __forceinline__ L2 lincomb2(L2 a, int ka, L2 b, int kb) const {
    return {lincomb(a.c0, ka, b.c0, kb), lincomb(a.c1, ka, b.c1, kb)};
  }
  // xi = 1 + u: (c0 - c1) + (c0 + c1) u
  __device__ __forceinline__ L2 xi2(L2 a) const {
    return {sub(a.c0, a.c1), add(a.c0, a.c1)};
  }

  // tower.fp2_mul: Karatsuba with column sharing, three column products,
  // two reductions
  __device__ __noinline__ L2 fp2_mul(const int* a, const int* b) const {
    set_pad(load(b));
    Limbs t0 = cols(a, pad);
    set_pad(load(b + W));
    Limbs t1 = cols(a + W, pad);
    store(tmp, add(load(a), load(a + W)));
    set_pad(add(load(b), load(b + W)));
    Limbs tk = cols(tmp, pad);
    Limbs r0 = {t0.v0 - t1.v0, t0.v1 - t1.v1, t0.v2 - t1.v2};
    Limbs rk = {tk.v0 - t0.v0 - t1.v0, tk.v1 - t0.v1 - t1.v1,
                tk.v2 - t0.v2 - t1.v2};
    return {reduce(r0), reduce(rk)};
  }

  // tower.fp2_sq: (a0 + a1)(a0 - a1) + 2 a0 a1 u
  __device__ __noinline__ L2 fp2_sq(const int* a) const {
    set_pad(load(a + W));
    Limbs tc = cols(a, pad);
    Limbs a0 = load(a), a1 = load(a + W);
    store(tmp, add(a0, a1));
    set_pad(sub(a0, a1));
    Limbs c0 = reduce(cols(tmp, pad));
    Limbs c1 = reduce({tc.v0 + tc.v0, tc.v1 + tc.v1, tc.v2 + tc.v2});
    return {c0, c1};
  }

  // The six Fp2 products of tower.fp6_mul (Karatsuba, in the order of
  // kernels.fp6_mul_plain) of the Fp6 operands a, b: j = 0, 1, 2 the
  // diagonal a_j b_j, then (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2)
  __device__ __forceinline__ L2 fp6_mul_product(int j, const int* a,
                                                const int* b) const {
    if (j < 3) return fp2_mul(a + j * F2, b + j * F2);
    int p = j == 3 ? 1 : 0, q = j == 4 ? 1 : 2;
    store2(opa, add2(load2(a + p * F2), load2(a + q * F2)));
    store2(opb, add2(load2(b + p * F2), load2(b + q * F2)));
    return fp2_mul(opa, opb);
  }

  // Fp2 component k of fp6_mul from its six products prod = [t0 t1 t2 m0 m1
  // m2]: c0 = xi(m0 - t1 - t2) + t0, c1 = m1 - t0 - t1 + xi(t2),
  // c2 = m2 - t0 - t2 + t1, in fp6_mul_plain's order
  __device__ __forceinline__ L2 fp6_mul_combine(int k, const int* prod) const {
    L2 t0 = load2(prod), t1 = load2(prod + F2), t2 = load2(prod + 2 * F2);
    L2 m = load2(prod + (3 + k) * F2);
    if (k == 0) return add2(xi2(sub2(sub2(m, t1), t2)), t0);
    if (k == 1) return add2(sub2(sub2(m, t0), t1), xi2(t2));
    return add2(sub2(sub2(m, t0), t2), t1);
  }
};

// A warp's own pad buffer zeroed by its lanes, for a kernel that keeps no
// block-wide state (no block sync needed)
__device__ __forceinline__ void zero_pad(int* pad) {
  for (int i = lane(); i < PAD; i += 32) pad[i] = 0;
  __syncwarp();
}

// The block's copy of FOLD_R and zeroed pad buffers, before the first phase
// (the caller syncs the block after).
__device__ __forceinline__ void init_block(int* table, int* pads, int n_pads) {
  for (int i = threadIdx.x; i < NFOLD * NL; i += blockDim.x) table[i] = FOLD_G[i];
  for (int i = threadIdx.x; i < n_pads * PAD; i += blockDim.x) pads[i] = 0;
}

}  // namespace coop
}  // namespace lh
