// fp_mul / fp_sq: Fp product and square of lazy limbs.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:fp_mul
// (_mul_kernel via _mul_call) and :fp_sq (_sq_kernel via _sq_call):
// schoolbook columns, carry3, two folds with FOLD_R, truncate -- bit-identical
// to limbs.mul / limbs.sq (field_coop.cuh says why).
//
// What bounds it: latency. A row reads 2 x 140 bytes and writes 140; it
// does ~1225 column products plus 2 x ~1300 fold products (~3.8k int32
// multiply-adds), so even at 1024 rows the work is ~4M int ops and ~0.4 MB
// of traffic, far from either roofline. The main path calls both mostly
// on ONE row (the Fermat inversions' chains) and otherwise on 128 to 2048
// rows, so a launch costs the latency of one row's chain; only the
// aggregate batch's largest fp_mul launches (up to 98,304 rows) come near
// the int32 rate.
//
// fp_sq_kernel and fp_mul_kernel: ONE WARP PER ROW (field_coop.cuh),
// ROW_NW warps a block. A warp writes its row's second operand once into
// its zero-padded buffer, takes the 69 columns (lane l owns columns l,
// l + 32, l + 64) with the first operand read as a broadcast, reduces
// them with Warp::reduce and stores. fp_sq's row is both operands
// (`cols(pad + W, pad)`): the full column product, not the halved square,
// since the column integers are the same (2 a_i a_j = a_i a_j + a_j a_i)
// and a lane's 35 steps are already short. fp_mul first copies a's row
// into a per-warp shared buffer and reads the broadcast from there
// (Warp::fp_mul), which measured faster than reading it straight from
// global memory (PERF.md). The ragged edge is masked per warp. Four
// warps a block spread the main path's 128 and 256 rows over 32 and 64
// SMs (one warp per scheduler); at 1024 rows the card holds the 256
// blocks at once. The lanes read FOLD_R straight from FOLD_G through the
// L1 cache (lane l reads entry l of a table row: one coalesced line),
// which measured faster than a copy in shared memory (PERF.md), and no
// block sync is needed.
#include "field_coop.cuh"

namespace {

constexpr int ROW_NW = 4;  // warps a block of both kernels, one row each

// limbs.mul (_mul_kernel): columns, carry3, fold, fold; one warp per row
__global__ void __launch_bounds__(ROW_NW * 32)
fp_mul_kernel(int* __restrict__ out, const int* __restrict__ a,
              const int* __restrict__ b, int n) {
  using namespace lh::coop;
  __shared__ int pad[ROW_NW][PAD];
  __shared__ int tmp[ROW_NW][lh::W];  // a's row, the broadcast operand
  const int warp = threadIdx.x >> 5, row = blockIdx.x * ROW_NW + warp;
  if (row >= n) return;  // ragged edge: the whole warp
  zero_pad(pad[warp]);
  const Warp w{lh::FOLD_G, pad[warp], tmp[warp], nullptr, nullptr};
  store(w.tmp, load(a + row * lh::W));
  store(out + row * lh::W, w.fp_mul(w.tmp, b + row * lh::W));
}

// limbs.sq (_sq_kernel): columns, carry3, fold, fold; one warp per row
__global__ void __launch_bounds__(ROW_NW * 32)
fp_sq_kernel(int* __restrict__ out, const int* __restrict__ a, int n) {
  using namespace lh::coop;
  __shared__ int pad[ROW_NW][PAD];
  const int warp = threadIdx.x >> 5, row = blockIdx.x * ROW_NW + warp;
  if (row >= n) return;  // ragged edge: the whole warp
  zero_pad(pad[warp]);
  const Warp w{lh::FOLD_G, pad[warp], nullptr, nullptr, nullptr};
  w.set_pad(load(a + row * lh::W));
  store(out + row * lh::W, w.reduce(cols(w.pad + lh::W, w.pad)));
}

}  // namespace

extern "C" int lh_fp_mul(void* out, const void* a, const void* b, int n, void* stream) {
  int blocks = (n + ROW_NW - 1) / ROW_NW;
  fp_mul_kernel<<<blocks, ROW_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, (const int*)b, n);
  return (int)cudaGetLastError();
}

extern "C" int lh_fp_sq(void* out, const void* a, int n, void* stream) {
  int blocks = (n + ROW_NW - 1) / ROW_NW;
  fp_sq_kernel<<<blocks, ROW_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)a, n);
  return (int)cudaGetLastError();
}
