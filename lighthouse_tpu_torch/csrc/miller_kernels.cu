// miller_dbl_step / miller_add_step: one fused Miller-loop step per row.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:miller_dbl_step
// (_math_miller_dbl via _fused_call) and :miller_add_step
// (_math_miller_add): the Jacobian point step, the line through it
// evaluated at P, f^2 (doubling only) and the sparse mul_by_line update,
// bit-identical to the op composition in gpu/pairing.py.
//
// What bounds it: operations, and at the main path's 65 to 1025 rows the
// latency of one row's chain. A doubling step is ~60 Fp2 products (~700k
// int32 multiply-adds) per row against ~3.4 KB of traffic, so the bound is
// the int32 rate.
//
// miller_dbl_kernel: ONE BLOCK PER ROW (field_coop.cuh). The row's state
// (f, T, P, the line, every intermediate) sits in shared memory, ~41 KB;
// each Fp2 product is one warp with its lanes across limbs and columns, and
// the step's ~50 Fp2 products run as seven phases of independent tasks
// (Fp2 products or short linear chains) spread over the block's 16 warps,
// the block synced between phases. The critical path is five products
// deep: T^2 -> x^3, z^3 -> y z^3 -> the line's cvw -> mul_by_line, with
// f^2 (12 products) beside the first level.
//
// miller_add_kernel: ONE BLOCK PER ROW as well, 17 warps, ~39 KB of
// shared memory. The addition step's 31 Fp2 products (madd-2007-bl, the
// chord line, mul_by_line) run as seven phases by dependency depth: z^2
// and yq z; z^3, xq z^2 and (yq z) z^2; yq z^3, z (x - xq z^2), h^2, r^2,
// (z + h)^2; the line's products and j, v; the line's c0 and 2T's x3, z3
// (linear); mul_by_line's 15 products beside r (v - x3) and y j; the
// combines. jac_madd's z1^2 and x2 z1^2 are the step's z^2 and xq z^2 (the
// same functions of the same operands), so each is computed once.
#include "field_coop.cuh"

namespace {

using lh::F12;
using lh::F2;
using lh::F6;
using lh::W;
using lh::coop::L2;
using lh::coop::load2;
using lh::coop::store2;
using lh::coop::Warp;

// mul_by_line's line (c0, cv, cvw) and its 15 Fp2 products in shared
// memory: p, the six of t0 = fp6_mul_s2(f0, c0, cv) (f0_0 c0, f0_2 cv, f0_1
// c0, f0_0 cv, f0_2 c0, f0_1 cv); q, the three of t1 = fp6_mul_s1(f1, cvw)
// (f1_2 cvw, f1_0 cvw, f1_1 cvw); s, the six of fp6_mul_s2(f0 + f1, c0,
// cv + cvw) in p's order
struct Line {
  int c0[F2], cv[F2], cvw[F2];
  int p[6 * F2], q[3 * F2], s[6 * F2];
};

// mul_by_line's product k < 15 of f by the line: p (k < 6), q (k < 9), s
__device__ __forceinline__ void line_product(const Warp& w, int k, const int* f,
                                             Line& l) {
  const int *f0 = f, *f1 = f + F6;
  if (k < 6) {
    int slot = 2 * k % 3;  // 0, 2, 1, 0, 2, 1
    store2(l.p + k * F2, w.fp2_mul(f0 + slot * F2, k % 2 ? l.cv : l.c0));
  } else if (k < 9) {
    int j = k - 6;
    store2(l.q + j * F2, w.fp2_mul(f1 + (j + 2) % 3 * F2, l.cvw));
  } else {
    int j = k - 9, slot = 2 * j % 3;
    store2(w.opa, w.add2(load2(f0 + slot * F2), load2(f1 + slot * F2)));
    if (j % 2) store2(w.opb, w.add2(load2(l.cv), load2(l.cvw)));
    store2(l.s + j * F2, w.fp2_mul(w.opa, j % 2 ? w.opb : l.c0));
  }
}

// Fp2 slot k < 6 of f' = (t0 + v t1, s - t0 - t1), with t0_j = p_2j +
// p_2j+1 (xi on p_1), t1 = (xi q0, q1, q2), s_j likewise from s
__device__ __forceinline__ void line_combine(const Warp& w, int k, const Line& l,
                                             int* fo) {
  int j = k % 3;
  L2 a = load2(l.p + 2 * j * F2), b = load2(l.p + (2 * j + 1) * F2);
  L2 t0 = w.add2(a, j == 0 ? w.xi2(b) : b);
  if (k < 3) {
    // (v t1)_j = xi q2, xi q0, q1
    L2 q = load2(l.q + (j + 2) % 3 * F2);
    store2(fo + j * F2, w.add2(t0, j == 2 ? q : w.xi2(q)));
  } else {
    L2 sa = load2(l.s + 2 * j * F2), sb = load2(l.s + (2 * j + 1) * F2);
    L2 sj = w.add2(sa, j == 0 ? w.xi2(sb) : sb);
    L2 q = load2(l.q + j * F2);
    store2(fo + F6 + j * F2, w.sub2(w.sub2(sj, t0), j == 0 ? w.xi2(q) : q));
  }
}

constexpr int NW = 16;  // warps per block: phase 1's 16 Fp2 products at once

// One row of the doubling step in shared memory. f's Fp2 slot (h, k) is
// f + (3h + k) F2; the f^2 of phase 3 overwrites f.
struct DblRow {
  int f[F12], t[F6], xp[W], yp[W];
  int x6[F6], y6[F6];       // f0 + f1, f0 + v f1
  int x2[F2], y2[F2], z2[F2];
  int fa[6 * F2], fb[6 * F2];  // fp6_mul products of f0 f1 and of x6 y6
  int x3[F2], z3[F2], xz[F2], c[F2], uj[F2], fj[F2];
  int tt[F6], mm[F6];       // f0 f1, x6 y6
  int yz3[F2];
  Line ln;
  int table[lh::NFOLD * lh::NL];
  int pad[NW][lh::coop::PAD], tmp[NW][W], opa[NW][F2], opb[NW][F2];
};

// pairing._dbl_step + tower.fp12_sq + pairing.mul_by_line, in
// gpu/pairing.py's order (jac_double's a = x^2 and b = y^2 are the step's
// x2, y2)
__global__ void __launch_bounds__(NW * 32)
miller_dbl_kernel(int* __restrict__ f_out, int* __restrict__ t_out,
                  const int* __restrict__ f, const int* __restrict__ t,
                  const int* __restrict__ xp, const int* __restrict__ yp) {
  __shared__ DblRow s;
  const int row = blockIdx.x, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < F12; i += blockDim.x) s.f[i] = f[row * F12 + i];
  for (int i = threadIdx.x; i < F6; i += blockDim.x) s.t[i] = t[row * F6 + i];
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    s.xp[i] = xp[row * W + i];
    s.yp[i] = yp[row * W + i];
  }
  lh::coop::init_block(s.table, &s.pad[0][0], NW);
  __syncthreads();
  const Warp w{s.table, s.pad[warp], s.tmp[warp], s.opa[warp], s.opb[warp]};
  int* fo = f_out + row * F12;
  int* to = t_out + row * F6;
  const int *x = s.t, *y = s.t + F2, *z = s.t + 2 * F2;
  const int *f0 = s.f, *f1 = s.f + F6;

  // phase 0: x6 = f0 + f1, y6 = f0 + v f1 (v f1 = (xi f1_2, f1_0, f1_1))
  for (int k = warp; k < 6; k += NW) {
    if (k < 3) {
      store2(s.x6 + k * F2, w.add2(load2(f0 + k * F2), load2(f1 + k * F2)));
    } else {
      int j = k - 3;
      L2 v = j == 0 ? w.xi2(load2(f1 + 2 * F2)) : load2(f1 + (j - 1) * F2);
      store2(s.y6 + j * F2, w.add2(load2(f0 + j * F2), v));
    }
  }
  __syncthreads();

  // phase 1: x^2, y^2, z^2, 2T's z3 = 2y z; the twelve Fp2 products of
  // fp12_sq's fp6_mul(f0, f1) and fp6_mul(x6, y6)
  for (int k = warp; k < 16; k += NW) {
    switch (k) {
      case 0: store2(s.x2, w.fp2_sq(x)); break;
      case 1: store2(s.y2, w.fp2_sq(y)); break;
      case 2: store2(s.z2, w.fp2_sq(z)); break;
      case 3:
        store2(w.opa, w.mul_small2(load2(y), 2));
        store2(to + 2 * F2, w.fp2_mul(w.opa, z));
        break;
      default: {
        int j = (k - 4) % 6;
        if (k < 10) store2(s.fa + j * F2, w.fp6_mul_product(j, f0, f1));
        else store2(s.fb + j * F2, w.fp6_mul_product(j, s.x6, s.y6));
      }
    }
  }
  __syncthreads();

  // phase 2: x^3, z^3, x^2 z^2; jac_double's c = b^2, (x + b)^2, (3a)^2; the
  // two fp6 products' combines
  for (int k = warp; k < 12; k += NW) {
    switch (k) {
      case 0: store2(s.x3, w.fp2_mul(s.x2, x)); break;
      case 1: store2(s.z3, w.fp2_mul(s.z2, z)); break;
      case 2: store2(s.xz, w.fp2_mul(s.x2, s.z2)); break;
      case 3: store2(s.c, w.fp2_sq(s.y2)); break;
      case 4:
        store2(w.opa, w.add2(load2(x), load2(s.y2)));
        store2(s.uj, w.fp2_sq(w.opa));
        break;
      case 5:
        store2(w.opa, w.mul_small2(load2(s.x2), 3));
        store2(s.fj, w.fp2_sq(w.opa));
        break;
      default: {
        int j = (k - 6) % 3;
        if (k < 9) store2(s.tt + j * F2, w.fp6_mul_combine(j, s.fa));
        else store2(s.mm + j * F2, w.fp6_mul_combine(j, s.fb));
      }
    }
  }
  __syncthreads();

  // phase 3: y z^3; the line's c0 and cv; 2T's x3 and y3; f^2 = (mm - tt -
  // v tt, 2 tt) over f
  for (int k = warp; k < 8; k += NW) {
    switch (k) {
      case 0: store2(s.yz3, w.fp2_mul(y, s.z3)); break;
      case 1:
      case 2: {
        int c = k - 1;
        lh::coop::store(w.opa, w.mul_small(lh::coop::load(s.xz + c * W), -3));
        lh::coop::store(s.ln.cv + c * W, w.fp_mul(w.opa, s.xp));
        break;
      }
      case 3: {
        L2 d = w.mul_small2(w.sub2(w.sub2(load2(s.uj), load2(s.x2)), load2(s.c)), 2);
        L2 x3 = w.sub2(load2(s.fj), w.mul_small2(d, 2));
        store2(to, x3);
        store2(w.opa, w.mul_small2(load2(s.x2), 3));
        store2(w.opb, w.sub2(d, x3));
        L2 u = w.fp2_mul(w.opa, w.opb);
        store2(to + F2, w.sub2(u, w.mul_small2(load2(s.c), 8)));
        break;
      }
      case 4:
        store2(s.ln.c0, w.sub2(w.mul_small2(load2(s.x3), 3),
                               w.mul_small2(load2(s.y2), 2)));
        break;
      default: {
        int j = k - 5;
        L2 tj = load2(s.tt + j * F2);
        L2 vt = j == 0 ? w.xi2(load2(s.tt + 2 * F2)) : load2(s.tt + (j - 1) * F2);
        store2(s.f + j * F2, w.sub2(w.sub2(load2(s.mm + j * F2), tj), vt));
        store2(s.f + F6 + j * F2, w.add2(tj, tj));
      }
    }
  }
  __syncthreads();

  // phase 4: the line's cvw; mul_by_line's six products of t0 =
  // fp6_mul_s2(f0, c0, cv)
  for (int k = warp; k < 8; k += NW) {
    if (k < 2) {
      lh::coop::store(w.opa, w.mul_small(lh::coop::load(s.yz3 + k * W), 2));
      lh::coop::store(s.ln.cvw + k * W, w.fp_mul(w.opa, s.yp));
    } else {
      line_product(w, k - 2, s.f, s.ln);
    }
  }
  __syncthreads();

  // phase 5: mul_by_line's other nine products, of t1 = fp6_mul_s1(f1,
  // cvw) and of s = fp6_mul_s2(f0 + f1, c0, cv + cvw)
  for (int k = warp; k < 9; k += NW) line_product(w, 6 + k, s.f, s.ln);
  __syncthreads();

  // phase 6: f' = (t0 + v t1, s - t0 - t1)
  for (int k = warp; k < 6; k += NW) line_combine(w, k, s.ln, fo);
}

constexpr int ADD_NW = 17;  // warps per block: phase 6's 17 Fp2 products at once

// One row of the addition step in shared memory: the inputs, then each
// intermediate under its name in pairing._add_step and _jac_madd (ud =
// x - xq z^2; yqz = yq z; rr2 = r^2; zh2 = (z + h)^2; ry = r (v - x3))
struct AddRow {
  int f[F12], t[F6], q[2 * F2], xp[W], yp[W];
  int z2[F2], yqz[F2], z3[F2], h[F2], ud[F2], rr[F2];
  int n[F2], d[F2], hh[F2], i[F2], rr2[F2], zh2[F2];
  int nxq[F2], dyq[F2], j[F2], v[F2], x3[F2], ry[F2], yj[F2];
  Line ln;
  int table[lh::NFOLD * lh::NL];
  int pad[ADD_NW][lh::coop::PAD], tmp[ADD_NW][W], opa[ADD_NW][F2], opb[ADD_NW][F2];
};

// pairing._add_step (_jac_madd, madd-2007-bl, and the chord line at P) +
// pairing.mul_by_line, in gpu/pairing.py's order and widths
__global__ void __launch_bounds__(ADD_NW * 32)
miller_add_kernel(int* __restrict__ f_out, int* __restrict__ t_out,
                  const int* __restrict__ f, const int* __restrict__ t,
                  const int* __restrict__ q, const int* __restrict__ xp,
                  const int* __restrict__ yp) {
  __shared__ AddRow s;
  const int row = blockIdx.x, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < F12; i += blockDim.x) s.f[i] = f[row * F12 + i];
  for (int i = threadIdx.x; i < F6; i += blockDim.x) s.t[i] = t[row * F6 + i];
  for (int i = threadIdx.x; i < 2 * F2; i += blockDim.x) s.q[i] = q[row * 2 * F2 + i];
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    s.xp[i] = xp[row * W + i];
    s.yp[i] = yp[row * W + i];
  }
  lh::coop::init_block(s.table, &s.pad[0][0], ADD_NW);
  __syncthreads();
  const Warp w{s.table, s.pad[warp], s.tmp[warp], s.opa[warp], s.opb[warp]};
  int* fo = f_out + row * F12;
  int* to = t_out + row * F6;
  const int *x = s.t, *y = s.t + F2, *z = s.t + 2 * F2;
  const int *xq = s.q, *yq = s.q + F2;

  // phase 1: z^2 (jac_madd's z1z1), yq z
  for (int k = warp; k < 2; k += ADD_NW) {
    if (k == 0) store2(s.z2, w.fp2_sq(z));
    else store2(s.yqz, w.fp2_mul(yq, z));
  }
  __syncthreads();

  // phase 2: z^3; xq z^2 (jac_madd's u2) -> h = u2 - x and x - u2;
  // s2 = (yq z) z^2 -> r = 2 (s2 - y)
  for (int k = warp; k < 3; k += ADD_NW) {
    switch (k) {
      case 0: store2(s.z3, w.fp2_mul(s.z2, z)); break;
      case 1: {
        L2 u2 = w.fp2_mul(xq, s.z2);
        store2(s.h, w.sub2(u2, load2(x)));
        store2(s.ud, w.sub2(load2(x), u2));
        break;
      }
      default:
        store2(s.rr, w.mul_small2(w.sub2(w.fp2_mul(s.yqz, s.z2), load2(y)), 2));
    }
  }
  __syncthreads();

  // phase 3: n = y - yq z^3; d = z (x - u2); hh = h^2 and i = 4 hh; r^2;
  // (z + h)^2
  for (int k = warp; k < 5; k += ADD_NW) {
    switch (k) {
      case 0: store2(s.n, w.sub2(load2(y), w.fp2_mul(yq, s.z3))); break;
      case 1: store2(s.d, w.fp2_mul(z, s.ud)); break;
      case 2: {
        L2 hh = w.fp2_sq(s.h);
        store2(s.hh, hh);
        store2(s.i, w.mul_small2(hh, 4));
        break;
      }
      case 3: store2(s.rr2, w.fp2_sq(s.rr)); break;
      default:
        store2(w.opa, w.add2(load2(z), load2(s.h)));
        store2(s.zh2, w.fp2_sq(w.opa));
    }
  }
  __syncthreads();

  // phase 4: n xq, d yq; the line's cv = -(n xp) and cvw = d yp, an Fp
  // product a component; j = h i, v = x i
  for (int k = warp; k < 8; k += ADD_NW) {
    switch (k) {
      case 0: store2(s.nxq, w.fp2_mul(s.n, xq)); break;
      case 1: store2(s.dyq, w.fp2_mul(s.d, yq)); break;
      case 2:
      case 3: {
        int c = k - 2;
        lh::coop::Limbs u = w.fp_mul(s.n + c * W, s.xp);
        lh::coop::store(s.ln.cv + c * W, w.sub({0, 0, 0}, u));
        break;
      }
      case 4:
      case 5: {
        int c = k - 4;
        lh::coop::store(s.ln.cvw + c * W, w.fp_mul(s.d + c * W, s.yp));
        break;
      }
      case 6: store2(s.j, w.fp2_mul(s.h, s.i)); break;
      default: store2(s.v, w.fp2_mul(x, s.i));
    }
  }
  __syncthreads();

  // phase 5: the line's c0 = n xq - d yq; 2T's x3 = (r^2 - j) - 2 v and
  // z3 = ((z + h)^2 - z^2) - hh
  for (int k = warp; k < 3; k += ADD_NW) {
    switch (k) {
      case 0: store2(s.ln.c0, w.sub2(load2(s.nxq), load2(s.dyq))); break;
      case 1: {
        L2 x3 = w.sub2(w.sub2(load2(s.rr2), load2(s.j)),
                       w.mul_small2(load2(s.v), 2));
        store2(s.x3, x3);
        store2(to, x3);
        break;
      }
      default:
        store2(to + 2 * F2, w.sub2(w.sub2(load2(s.zh2), load2(s.z2)), load2(s.hh)));
    }
  }
  __syncthreads();

  // phase 6: mul_by_line's 15 products; r (v - x3) and y j for y3
  for (int k = warp; k < 17; k += ADD_NW) {
    if (k < 15) {
      line_product(w, k, s.f, s.ln);
    } else if (k == 15) {
      store2(w.opb, w.sub2(load2(s.v), load2(s.x3)));
      store2(s.ry, w.fp2_mul(s.rr, w.opb));
    } else {
      store2(s.yj, w.fp2_mul(y, s.j));
    }
  }
  __syncthreads();

  // phase 7: f' = (t0 + v t1, s - t0 - t1); y3 = r (v - x3) - 2 y j
  for (int k = warp; k < 7; k += ADD_NW) {
    if (k < 6) line_combine(w, k, s.ln, fo);
    else store2(to + F2, w.sub2(load2(s.ry), w.mul_small2(load2(s.yj), 2)));
  }
}

}  // namespace

extern "C" int lh_miller_dbl(void* f_out, void* t_out, const void* f, const void* t,
                             const void* xp, const void* yp, int n, void* stream) {
  miller_dbl_kernel<<<n, NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)f_out, (int*)t_out, (const int*)f, (const int*)t, (const int*)xp,
      (const int*)yp);
  return (int)cudaGetLastError();
}

extern "C" int lh_miller_add(void* f_out, void* t_out, const void* f, const void* t,
                             const void* q, const void* xp, const void* yp, int n,
                             void* stream) {
  miller_add_kernel<<<n, ADD_NW * 32, 0, (cudaStream_t)stream>>>(
      (int*)f_out, (int*)t_out, (const int*)f, (const int*)t, (const int*)q,
      (const int*)xp, (const int*)yp);
  return (int)cudaGetLastError();
}
