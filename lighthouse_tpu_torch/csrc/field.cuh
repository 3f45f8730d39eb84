// BLS12-381 field constants for the hand-written CUDA kernels (sm_90a).
//
// The representation of lighthouse_tpu/crypto/bls/tpu/limbs.py (and of
// gpu/limbs.py): 12-bit signed limbs in int32, working width W = 35, lazy
// form limbs in [-1, 2^12]. Layout: an Fp element is int[W]; Fp2 is int[2W]
// (c0, c1); Fp6 is three Fp2; Fp12 is two Fp6 -- the (..., 2, 3, 2, W)
// order of the tower, flat.
//
// Only the constants and the FOLD_R table live here. Every kernel runs on
// the warp-cooperative layer of field_coop.cuh: fp_mul and fp_sq a warp
// per row; miller_dbl_step, miller_add_step, fp6_mul, fp12_mul and
// fp12_cyclotomic_sq a block per row.
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

// FOLD_R[r][j] = limbs(2^(12*(32+r)) mod p), j < 32 (the part folds read),
// in global memory: a warp's lanes read one table row at once (one
// coalesced line), straight from here or from a block's shared copy
__device__ int FOLD_G[NFOLD * NL];

}  // namespace lh

// FOLD_R as given by the host: (44, W) int32 row-major; keeps columns < 32.
extern "C" int lh_init(const int* fold_r) {
  int buf[lh::NFOLD * lh::NL];
  for (int r = 0; r < lh::NFOLD; ++r)
    for (int j = 0; j < lh::NL; ++j) buf[r * lh::NL + j] = fold_r[r * lh::W + j];
  cudaMemcpyToSymbol(lh::FOLD_G, buf, sizeof(buf));
  return (int)cudaGetLastError();
}
