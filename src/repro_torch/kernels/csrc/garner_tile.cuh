// Garner mixed-radix reconstruction of one output element, shared by
// crt_garner.cu and the two megakernels (fused_mod_gemm.cu,
// fused_karatsuba.cu).
//
// The op sequence is the reference's `crt_garner.garner_tile`
// (src/repro/kernels/crt_garner.py:61): the digits are exact f32 integer
// arithmetic (all values < 2^17), and the digits -> value sum runs most
// significant digit first in double-single arithmetic with the f32 weight
// table W_t 2^-S (crt_garner.py:84-94, core/expansion.py:17-52).  Every
// multiply and add rounds on its own (-fmad=false), except the one fused
// multiply-add of crt_garner.py:89, `pe = pe + w_lo * digit`, which XLA on
// the CPU contracts into an FMA and which is therefore an explicit
// __fmaf_rn here.  The caller applies the inverse scaling.
#pragma once

#include "common.cuh"

// The Garner tables, passed by value in the kernel's parameters (2,788
// bytes; with CastParams and the pointers a megakernel's parameters stay
// near 3.7 KB, under the 4 KB of older toolkits and far under the 32 KB
// that CUDA 12.1 and later allow).
struct GarnerParams {
  int n_mod;
  float p[REPRO_MAX_MODULI];
  float half[REPRO_MAX_MODULI];
  float recip[REPRO_MAX_MODULI];
  float inv[REPRO_MAX_MODULI][REPRO_MAX_MODULI];  // inv[s][t] = p_s^-1 mod p_t
  float w_hi[REPRO_MAX_MODULI];
  float w_lo[REPRO_MAX_MODULI];
};

// Fill `prm` from the host tables: `moduli` (N,), `garner_inv` (N, N) and
// the double-single `weights` (N, 2).  Returns false when N is out of range.
inline bool make_garner_params(GarnerParams& prm, int n_mod, const int* moduli,
                               const int* garner_inv, const float* weights) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return false;
  prm.n_mod = n_mod;
  for (int t = 0; t < n_mod; ++t) {
    prm.p[t] = static_cast<float>(moduli[t]);
    prm.half[t] = static_cast<float>((moduli[t] - 1) / 2);
    prm.recip[t] = static_cast<float>(1.0 / moduli[t]);
    prm.w_hi[t] = weights[2 * t];
    prm.w_lo[t] = weights[2 * t + 1];
    for (int u = 0; u < n_mod; ++u) prm.inv[u][t] = static_cast<float>(garner_inv[u * n_mod + t]);
  }
  return true;
}

struct DS {
  float hi, lo;
};

__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ DS quick_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}

__device__ __forceinline__ DS split(float a) {
  const float c = 4097.0f * a;
  const float hi = c - (c - a);
  return {hi, a - hi};
}

__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = a * b;
  const DS as = split(a), bs = split(b);
  return {p, (((as.hi * bs.hi - p) + as.hi * bs.lo) + as.lo * bs.hi) + as.lo * bs.lo};
}

__device__ __forceinline__ DS dd_add(DS x, DS y) {
  const DS s = two_sum(x.hi, y.hi);
  const float te = (x.lo + y.lo) + s.lo;
  return quick_two_sum(s.hi, te);
}

// d[t] holds the canonical residue mod p_t of the element for t < N (as an
// f32 integer); on return it holds the Garner digits, and the result is the
// double-single value sum_t W_t 2^-S d_t.  NMAX is a compile-time bound on
// the run-time N, so the digits stay in registers.
template <int NMAX>
__device__ __forceinline__ DS garner_value(float (&d)[NMAX], const GarnerParams& prm) {
  const int N = prm.n_mod;
#pragma unroll
  for (int t = 0; t < NMAX; ++t) {
    if (t < N) {
      const float p = prm.p[t], half = prm.half[t], recip = prm.recip[t];
      float r = d[t];
#pragma unroll
      for (int u = 0; u < NMAX; ++u) {
        if (u < t) r = sym_mod_f32((r - d[u]) * prm.inv[u][t], p, half, recip);
      }
      d[t] = r;
    }
  }
  DS acc = {0.0f, 0.0f};
#pragma unroll
  for (int t = NMAX - 1; t >= 0; --t) {
    if (t < N) {
      DS pr = two_prod(prm.w_hi[t], d[t]);
      pr.lo = __fmaf_rn(prm.w_lo[t], d[t], pr.lo);  // crt_garner.py:89, fused as XLA does
      acc = dd_add(acc, pr);
    }
  }
  return acc;
}
