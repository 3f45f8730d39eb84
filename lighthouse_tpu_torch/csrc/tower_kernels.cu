// fp6_mul / fp12_mul / fp12_cyclo_sq: one tower product or square per row.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:fp6_mul
// (_math_fp6_mul -> _k6_mul), :fp12_mul (_math_fp12_mul -> _k12_mul) and
// :fp12_cyclotomic_sq (_math_cyclo_sq -> _k12_cyclo_sq), all through
// _fused_call; bit-identical to the op compositions fp6_mul_plain,
// fp12_mul_plain and fp12_cyclotomic_sq_plain in gpu/kernels.py.
//
// What bounds it: operations, and on this design latency. An Fp12 product
// is 18 Fp2 products (~130k int32 multiply-adds) per row against 5 KB of
// traffic, a cyclotomic square 9 Fp2 squares (~55k); the bound is the
// int32 rate. But the final exponentiation runs them on ONE row, 316
// squares and 35 products in a chain: one thread on one SM works through
// the whole Fp2 schedule serially, its temporaries on the local-memory
// stack, so a launch takes the latency of that chain. The design is the
// simple one (one thread per row, the ragged edge masked by the row test,
// no block padding); spreading one row's independent Fp2 products over a
// warp is later work.
#include "field.cuh"

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

__global__ void fp12_cyclo_sq_kernel(int* __restrict__ out,
                                     const int* __restrict__ a, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int A[lh::F12];
  for (int i = 0; i < lh::F12; ++i) A[i] = a[row * lh::F12 + i];
  lh::fp12_cyclo_sq(A, A);
  for (int i = 0; i < lh::F12; ++i) out[row * lh::F12 + i] = A[i];
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
  fp12_cyclo_sq_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, n);
  return (int)cudaGetLastError();
}
