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
// fp12_cyclo_sq_kernel: ONE BLOCK PER ROW (field_coop.cuh), 9 warps. The
// row sits in shared memory; phase 1 runs the nine Fp2 squares, one warp
// each (the three of sums add first); phase 2 the six output slots, one
// warp each: the subs, the xi-multiplies and the adds, then the 3t -+ 2x
// combine. Two Fp2-square latencies and a launch per square.
//
// fp6_mul_kernel, fp12_mul_kernel: still the simple design (one thread per
// row, the ragged edge masked by the row test, Fp2/Fp6 helpers not inlined,
// frames on the local stack).
#include "field_coop.cuh"

namespace {

constexpr int THREADS = 64;

__global__ void fp6_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
                               const int* __restrict__ b, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int A[lh::F6], B[lh::F6];
  for (int i = 0; i < lh::F6; ++i) {
    A[i] = a[row * lh::F6 + i];
    B[i] = b[row * lh::F6 + i];
  }
  lh::fp6_mul(A, A, B);
  for (int i = 0; i < lh::F6; ++i) out[row * lh::F6 + i] = A[i];
}

__global__ void fp12_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
                                const int* __restrict__ b, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int A[lh::F12], B[lh::F12];
  for (int i = 0; i < lh::F12; ++i) {
    A[i] = a[row * lh::F12 + i];
    B[i] = b[row * lh::F12 + i];
  }
  lh::fp12_mul(A, A, B);
  for (int i = 0; i < lh::F12; ++i) out[row * lh::F12 + i] = A[i];
}

constexpr int CYCLO_NW = 9;  // warps per block: the nine Fp2 squares at once

struct CycloRow {
  int a[lh::F12], sq[9 * lh::F2];
  int table[lh::NFOLD * lh::NL];
  int pad[CYCLO_NW][lh::coop::PAD], tmp[CYCLO_NW][lh::W];
  int opa[CYCLO_NW][lh::F2], opb[CYCLO_NW][lh::F2];
};

// tower.fp12_cyclotomic_sq (_k12_cyclo_sq), Granger-Scott, in the order of
// field.cuh's one-thread transcription. x_ij is Fp2 slot 3i + j of the row.
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

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int lh_fp6_mul(void* out, const void* a, const void* b, int n,
                          void* stream) {
  fp6_mul_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b, n);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp12_mul(void* out, const void* a, const void* b, int n,
                           void* stream) {
  fp12_mul_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b, n);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp12_cyclo_sq(void* out, const void* a, int n, void* stream) {
  fp12_cyclo_sq_kernel<<<n, CYCLO_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a);
  return (int)cudaGetLastError();
}
