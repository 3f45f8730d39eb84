// fp6_mul / fp12_mul / fp12_cyclo_sq: one tower product or square per row.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:fp6_mul
// (_math_fp6_mul -> _k6_mul), :fp12_mul (_math_fp12_mul -> _k12_mul) and
// :fp12_cyclotomic_sq (_math_cyclo_sq -> _k12_cyclo_sq), all through
// _fused_call; bit-identical to the op compositions fp6_mul_plain,
// fp12_mul_plain and fp12_cyclotomic_sq_plain in gpu/kernels.py.
//
// What bounds it: operations, and on one row latency. An Fp12 product is
// 18 Fp2 products (~130k int32 multiply-adds) per row against 5 KB of
// traffic, a cyclotomic square 9 Fp2 squares (~55k); the bound is the
// int32 rate. But the final exponentiation runs them on ONE row, 316
// squares and 35 products in a chain, so a launch costs the latency of
// one row's schedule.
//
// fp12_mul_kernel: ONE BLOCK PER ROW (field_coop.cuh), 18 warps. The row's
// a, b and every intermediate sit in shared memory (38,320 bytes with the
// fold table and the per-warp scratch). Four phases, the block synced
// between them, in fp12_mul_plain's and fp6_mul_plain's order: the Karatsuba
// operand sums x6 = a0 + a1, y6 = b0 + b1 (6 warps); the 18 Fp2 products
// of the three Fp6 products a0 b0, a1 b1, x6 y6 (one warp each); the 9 Fp6
// combines t0, t1, m; the 6 output slots c0 = t0 + v t1, c1 = m - t0 - t1.
// The critical path is one Fp2 product and three short add chains.
//
// fp12_cyclo_sq_kernel: ONE BLOCK PER ROW (field_coop.cuh), 9 warps. The
// row sits in shared memory; phase 1 runs the nine Fp2 squares, one warp
// each (the three of sums add first); phase 2 the six output slots, one
// warp each: the subs, the xi-multiplies and the adds, then the 3t -+ 2x
// combine. Two Fp2-square latencies and a launch per square.
//
// fp6_mul_kernel: ONE BLOCK PER ROW (field_coop.cuh), 6 warps: phases 2-3
// of fp12_mul_kernel for one Fp6 product. The row's a and b sit in shared
// memory (15,688 bytes with the fold table and the per-warp scratch);
// phase 1 runs the six Fp2 products, one warp each; phase 2 the three
// combines, one warp each, written straight to the output. One Fp2-product
// latency and three short add chains. The main path calls it once a
// verify, on the two rows of fp12_inv's stacked product.
#include "field_coop.cuh"

namespace {

constexpr int FP6_NW = 6;  // warps per block: the six Fp2 products at once

// One row of fp6_mul in shared memory; prod holds the six products in
// fp6_mul_product order
struct Fp6MulRow {
  int a[lh::F6], b[lh::F6], prod[6 * lh::F2];
  int table[lh::NFOLD * lh::NL];
  int pad[FP6_NW][lh::coop::PAD], tmp[FP6_NW][lh::W];
  int opa[FP6_NW][lh::F2], opb[FP6_NW][lh::F2];
};

// tower.fp6_mul (_k6_mul): Karatsuba, in the order of kernels.fp6_mul_plain
__global__ void __launch_bounds__(FP6_NW * 32)
fp6_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
               const int* __restrict__ b) {
  using lh::F2;
  using lh::F6;
  using lh::coop::store2;
  __shared__ Fp6MulRow s;
  const int row = blockIdx.x, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < F6; i += blockDim.x) {
    s.a[i] = a[row * F6 + i];
    s.b[i] = b[row * F6 + i];
  }
  lh::coop::init_block(s.table, &s.pad[0][0], FP6_NW);
  __syncthreads();
  const lh::coop::Warp w{s.table, s.pad[warp], s.tmp[warp], s.opa[warp], s.opb[warp]};

  // phase 1: product j = warp of fp6_mul(a, b)
  store2(s.prod + warp * F2, w.fp6_mul_product(warp, s.a, s.b));
  __syncthreads();

  // phase 2: Fp2 slot k = warp of the product (warps 0-2)
  if (warp < 3) store2(out + row * F6 + warp * F2, w.fp6_mul_combine(warp, s.prod));
}

constexpr int MUL_NW = 18;  // warps per block: the 18 Fp2 products at once

// One row of fp12_mul in shared memory. a's Fp6 halves are a and a + F6;
// prod holds the six fp6_mul products (fp6_mul_product order) of a0 b0,
// then a1 b1, then x6 y6; t their combines t0 = a0 b0, t1 = a1 b1, m = x6 y6.
struct Fp12MulRow {
  int a[lh::F12], b[lh::F12], x6[lh::F6], y6[lh::F6];
  int prod[18 * lh::F2], t[9 * lh::F2];
  int table[lh::NFOLD * lh::NL];
  int pad[MUL_NW][lh::coop::PAD], tmp[MUL_NW][lh::W];
  int opa[MUL_NW][lh::F2], opb[MUL_NW][lh::F2];
};

// tower.fp12_mul (_k12_mul): Karatsuba over three Fp6 products, in the
// order of kernels.fp12_mul_plain and fp6_mul_plain
__global__ void __launch_bounds__(MUL_NW * 32)
fp12_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
                const int* __restrict__ b) {
  using lh::F2;
  using lh::F6;
  using lh::coop::L2;
  using lh::coop::load2;
  using lh::coop::store2;
  __shared__ Fp12MulRow s;
  const int row = blockIdx.x, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < lh::F12; i += blockDim.x) {
    s.a[i] = a[row * lh::F12 + i];
    s.b[i] = b[row * lh::F12 + i];
  }
  lh::coop::init_block(s.table, &s.pad[0][0], MUL_NW);
  __syncthreads();
  const lh::coop::Warp w{s.table, s.pad[warp], s.tmp[warp], s.opa[warp], s.opb[warp]};

  // phase 1: x6 = a0 + a1 (warps 0-2), y6 = b0 + b1 (warps 3-5), Fp2 slot
  // j each (add_n: one fold of each element's sum)
  if (warp < 6) {
    const int j = warp % 3;
    const int* u = warp < 3 ? s.a : s.b;
    int* sum = warp < 3 ? s.x6 : s.y6;
    store2(sum + j * F2, w.add2(load2(u + j * F2), load2(u + F6 + j * F2)));
  }
  __syncthreads();

  // phase 2: product j of fp6_mul(A, B), (A, B) = (a0, b0), (a1, b1), (x6, y6)
  {
    const int set = warp / 6, j = warp % 6;
    const int* A = set == 2 ? s.x6 : s.a + set * F6;
    const int* B = set == 2 ? s.y6 : s.b + set * F6;
    store2(s.prod + warp * F2, w.fp6_mul_product(j, A, B));
  }
  __syncthreads();

  // phase 3: Fp2 slot k of t0, t1, m
  if (warp < 9) {
    const int set = warp / 3, k = warp % 3;
    store2(s.t + warp * F2, w.fp6_mul_combine(k, s.prod + set * 6 * F2));
  }
  __syncthreads();

  // phase 4: c0_j = t0_j + (v t1)_j, v t1 = (xi t1_2, t1_0, t1_1) (warps
  // 0-2); c1_j = (m_j - t0_j) - t1_j (warps 3-5)
  if (warp < 6) {
    const int j = warp % 3;
    const int *t0 = s.t, *t1 = s.t + F6, *m = s.t + 2 * F6;
    L2 r;
    if (warp < 3) {
      L2 vt = j == 0 ? w.xi2(load2(t1 + 2 * F2)) : load2(t1 + (j - 1) * F2);
      r = w.add2(load2(t0 + j * F2), vt);
    } else {
      r = w.sub2(w.sub2(load2(m + j * F2), load2(t0 + j * F2)), load2(t1 + j * F2));
    }
    store2(out + row * lh::F12 + warp * F2, r);
  }
}

constexpr int CYCLO_NW = 9;  // warps per block: the nine Fp2 squares at once

struct CycloRow {
  int a[lh::F12], sq[9 * lh::F2];
  int table[lh::NFOLD * lh::NL];
  int pad[CYCLO_NW][lh::coop::PAD], tmp[CYCLO_NW][lh::W];
  int opa[CYCLO_NW][lh::F2], opb[CYCLO_NW][lh::F2];
};

// tower.fp12_cyclotomic_sq (_k12_cyclo_sq), Granger-Scott, in the order of
// kernels.fp12_cyclotomic_sq_plain. x_ij is Fp2 slot 3i + j of the row.
__global__ void __launch_bounds__(CYCLO_NW * 32)
fp12_cyclo_sq_kernel(int* __restrict__ out, const int* __restrict__ a) {
  using lh::F2;
  using lh::coop::L2;
  using lh::coop::load2;
  using lh::coop::store2;
  __shared__ CycloRow s;
  const int row = blockIdx.x, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < lh::F12; i += blockDim.x) s.a[i] = a[row * lh::F12 + i];
  lh::coop::init_block(s.table, &s.pad[0][0], CYCLO_NW);
  __syncthreads();
  const lh::coop::Warp w{s.table, s.pad[warp], s.tmp[warp], s.opa[warp], s.opb[warp]};
  auto x = [&](int ij) { return s.a + ij * F2; };

  // phase 1: t0..t5 = x11^2, x00^2, x02^2, x10^2, x12^2, x01^2; t6..t8 =
  // (x11 + x00)^2, (x02 + x10)^2, (x12 + x01)^2
  {
    const int k = warp;
    const int first[6] = {4, 0, 2, 3, 5, 1};
    if (k < 6) {
      store2(s.sq + k * F2, w.fp2_sq(x(first[k])));
    } else {
      store2(w.opa, w.add2(load2(x(first[2 * (k - 6)])),
                           load2(x(first[2 * (k - 6) + 1]))));
      store2(s.sq + k * F2, w.fp2_sq(w.opa));
    }
  }
  __syncthreads();

  // phase 2: slot r = 3t -+ 2x of t0' = xi t0 + t1, t2' = xi t2 + t3,
  // t4' = xi t4 + t5 (slots 00, 01, 02, with -2) and t8' = xi (t8 - t4 -
  // t5), t6' = t6 - t0 - t1, t7' = t7 - t2 - t3 (slots 10, 11, 12, with +2)
  if (warp < 6) {
    const int r = warp;
    auto t = [&](int i) { return load2(s.sq + i * F2); };
    L2 u;
    if (r < 3) {
      u = w.add2(w.xi2(t(2 * r)), t(2 * r + 1));
    } else {
      const int m = r == 3 ? 8 : r + 2, i = r == 3 ? 4 : 2 * (r - 4);
      u = w.sub2(w.sub2(t(m), t(i)), t(i + 1));
      if (r == 3) u = w.xi2(u);
    }
    store2(out + row * lh::F12 + r * F2,
           w.lincomb2(u, 3, load2(x(r)), r < 3 ? -2 : 2));
  }
}

}  // namespace

extern "C" int lh_fp6_mul(void* out, const void* a, const void* b, int n,
                          void* stream) {
  fp6_mul_kernel<<<n, FP6_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp12_mul(void* out, const void* a, const void* b, int n,
                           void* stream) {
  fp12_mul_kernel<<<n, MUL_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp12_cyclo_sq(void* out, const void* a, int n, void* stream) {
  fp12_cyclo_sq_kernel<<<n, CYCLO_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a);
  return (int)cudaGetLastError();
}
