// fp_mul / fp_sq: Fp product and square of lazy limbs.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:fp_mul
// (_mul_kernel via _mul_call) and :fp_sq (_sq_kernel via _sq_call):
// schoolbook columns, carry3, two folds with FOLD_R, truncate -- bit-identical
// to limbs.mul / limbs.sq (field.cuh says why).
//
// What bounds it: latency. A row reads 2 x 140 bytes and writes 140; it
// does ~1225 column products plus 2 x ~1300 fold products (~3.8k int32
// multiply-adds), so even at 1024 rows the work is ~4M int ops and ~0.4 MB
// of traffic, far from either roofline. The main path calls fp_sq mostly
// on ONE row (the Fermat inversions' chains of squares) and otherwise on
// 128 to 1024 rows, so a launch costs the latency of one row's chain.
//
// fp_sq_kernel: ONE WARP PER ROW (field_coop.cuh), SQ_NW warps a block.
// A warp loads its row into registers, writes it once into its zero-padded
// buffer, takes the 69 columns of a * a from that buffer (lane l owns
// columns l, l + 32, l + 64), reduces them with Warp::reduce and stores.
// The full column product, not the halved square: the column integers are
// the same (2 a_i a_j = a_i a_j + a_j a_i) and a lane's 35 steps are
// already short. The ragged edge is masked per warp. Four warps a block
// spread the main path's 128 and 256 rows over 32 and 64 SMs (one warp per
// scheduler); at 1024 rows the card holds the 256 blocks at once. The
// lanes read FOLD_R straight from FOLD_G through the L1 cache (lane l
// reads entry l of a table row: one coalesced line), which measured faster
// than a copy in shared memory (PERF.md), and no block sync is needed.
//
// fp_mul_kernel: still the simple design (one row per thread, field.cuh).
#include "field_coop.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SQ_NW = 4;  // fp_sq_kernel's warps a block, one row each

__global__ void fp_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
                              const int* __restrict__ b, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;  // ragged edge: masked, not padded
  int x[lh::W], y[lh::W];
  for (int i = 0; i < lh::W; ++i) {
    x[i] = a[row * lh::W + i];
    y[i] = b[row * lh::W + i];
  }
  lh::fp_mul(x, x, y);
  for (int i = 0; i < lh::W; ++i) out[row * lh::W + i] = x[i];
}

// limbs.sq (_sq_kernel): columns, carry3, fold, fold; one warp per row
__global__ void __launch_bounds__(SQ_NW * 32)
fp_sq_kernel(int* __restrict__ out, const int* __restrict__ a, int n) {
  using namespace lh::coop;
  __shared__ int pad[SQ_NW][PAD];
  const int warp = threadIdx.x >> 5, row = blockIdx.x * SQ_NW + warp;
  if (row >= n) return;  // ragged edge: the whole warp
  zero_pad(pad[warp]);
  const Warp w{lh::FOLD_G, pad[warp], nullptr, nullptr, nullptr};
  w.set_pad(load(a + row * lh::W));
  store(out + row * lh::W, w.reduce(cols(w.pad + lh::W, w.pad)));
}

}  // namespace

extern "C" int lh_fp_mul(void* out, const void* a, const void* b, int n, void* stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  fp_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b, n);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp_sq(void* out, const void* a, int n, void* stream) {
  int blocks = (n + SQ_NW - 1) / SQ_NW;
  fp_sq_kernel<<<blocks, SQ_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, n);
  return (int)cudaGetLastError();
}
