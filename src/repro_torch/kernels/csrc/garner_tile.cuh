// The Garner reconstruction's route, shared by the Garner kernel
// (crt_garner.cu, four elements a thread) and the two megakernels
// (fused_mod_gemm.cu, fused_karatsuba.cu, one element at a time through
// `garner_value`).
//
// The digits are the reference's (`crt_garner.garner_tile`,
// src/repro/kernels/crt_garner.py:61), taken by their mixed-radix form:
// digit t is one symmetric reduction of an exact f32 integer sum of fmas,
// sum_{u<=t} coef[u][t] y_u (y_u the digits below t, y_t the residue x_t),
// with the coefficients of `kernels/crt_garner.py` `route_tables`.
// Balanced mixed-radix digits are unique, so these are the reference's,
// bit for bit (tests/test_torch_garner_schedule.py).  The digits -> value
// sum runs most significant digit first in double-single arithmetic with
// the f32 weight table W_t 2^-S (crt_garner.py:84-94,
// core/expansion.py:17-52).  Every multiply and add rounds on its own
// (-fmad=false), except the one fused multiply-add of crt_garner.py:89,
// `pe = pe + w_lo * digit`, which XLA on the CPU contracts into an FMA and
// which is therefore an explicit __fmaf_rn here.  Dekker's product of w_hi
// and a digit takes two shortcuts that give its bits (proven over every
// weight and digit in the same test file): split(w_hi) comes from the host
// (`route_tables`), and the split of a digit |d| <= 128 is (d, +0), so the
// product's error is ah d - ph + al d, whose products are exact, by two
// FMAs.  The caller applies the inverse scaling.  On the H100 the
// mixed-radix digits made fused_karatsuba 2.8 % and fused_mod_gemm 1.5 %
// faster than the reference's recursion (PERF.md section 6).
#pragma once

#include "common.cuh"

// The Garner tables, passed by value in the kernel's parameters (2,884
// bytes; with CastParams and the pointers a megakernel's parameters stay
// near 3.8 KB, under the 4 KB of older toolkits and far under the 32 KB
// that CUDA 12.1 and later allow).
struct GarnerParams {
  int n_mod;
  float p[REPRO_MAX_MODULI];
  float recip[REPRO_MAX_MODULI];
  float coef[REPRO_MAX_MODULI][REPRO_MAX_MODULI];  // coef[u][t]: of digit u (x_t at u = t) in digit t
  float w_hi[REPRO_MAX_MODULI];
  float w_lo[REPRO_MAX_MODULI];
  float w_ah[REPRO_MAX_MODULI], w_al[REPRO_MAX_MODULI];  // split(w_hi)
};

// Fill `prm` from the host tables: `moduli` (N,), the route's integer
// coefficients `coef` (N, N) and weight splits `split` (N, 2) (both from
// `route_tables`) and the double-single `weights` (N, 2).  Returns false
// when N is out of range.
inline bool make_garner_params(GarnerParams& prm, int n_mod, const int* moduli, const int* coef,
                               const float* weights, const float* split) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return false;
  prm.n_mod = n_mod;
  for (int t = 0; t < n_mod; ++t) {
    prm.p[t] = static_cast<float>(moduli[t]);
    prm.recip[t] = static_cast<float>(1.0 / moduli[t]);
    prm.w_hi[t] = weights[2 * t];
    prm.w_lo[t] = weights[2 * t + 1];
    prm.w_ah[t] = split[2 * t];
    prm.w_al[t] = split[2 * t + 1];
    for (int u = 0; u < n_mod; ++u) prm.coef[u][t] = static_cast<float>(coef[u * n_mod + t]);
  }
  return true;
}

constexpr float GARNER_MAGIC = 12582912.0f;  // 1.5 * 2^23: (x + MAGIC) - MAGIC = rint(x) for |x| < 2^22

// The canonical symmetric residue of an f32 integer v, not -0, for the
// sums the route makes, |v| <= REACH = 24 * 127 * 128 (about 2^18.6), and
// an odd modulus p in 3..255: q = rint(v / p) with no FRND and no
// correction (the magic sum rounds), and v - q p is exact.  That the
// guess needs no correction is proven only there, for every such v and p
// (tests/test_torch_garner_schedule.py); nearer 2^22 the error of v recip
// can pass 1 / (2 p), and a wider route would need a correction.
__device__ __forceinline__ float garner_reduce(float v, float p, float recip) {
  const float q = __fsub_rn(__fadd_rn(__fmul_rn(v, recip), GARNER_MAGIC), GARNER_MAGIC);
  return __fmaf_rn(-q, p, v);
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

__device__ __forceinline__ DS dd_add(DS x, DS y) {
  const DS s = two_sum(x.hi, y.hi);
  const float te = (x.lo + y.lo) + s.lo;
  return quick_two_sum(s.hi, te);
}

// The digits of E elements: d[t][e] holds the canonical residue mod p_t of
// element e (an f32 integer) for t < N; on return it holds the Garner
// digits.  NMAX is a compile-time bound on the run-time N, so the digits
// stay in registers.
template <int NMAX, int E>
__device__ __forceinline__ void garner_digits(float (&d)[NMAX][E], const GarnerParams& prm) {
  const int N = prm.n_mod;
#pragma unroll
  for (int t = 1; t < NMAX; ++t) {
    if (t < N) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float acc = __fmaf_rn(prm.coef[t][t], d[t][e], 0.0f);  // from +0: the sum is never -0
#pragma unroll
        for (int u = 0; u < t; ++u) acc = __fmaf_rn(prm.coef[u][t], d[u][e], acc);
        d[t][e] = garner_reduce(acc, prm.p[t], prm.recip[t]);
      }
    }
  }
}

// The double-single values sum_t W_t 2^-S d_t of E elements' digits, most
// significant digit first.
template <int NMAX, int E>
__device__ __forceinline__ void garner_sum(const float (&d)[NMAX][E], const GarnerParams& prm, DS (&v)[E]) {
  const int N = prm.n_mod;
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = {0.0f, 0.0f};
#pragma unroll
  for (int t = NMAX - 1; t >= 0; --t) {
    if (t < N) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dt = d[t][e];
        DS pr;
        pr.hi = __fmul_rn(prm.w_hi[t], dt);
        pr.lo = __fmaf_rn(prm.w_ah[t], dt, -pr.hi);  // Dekker's error with split(d) = (d, +0)
        pr.lo = __fmaf_rn(prm.w_al[t], dt, pr.lo);
        pr.lo = __fmaf_rn(prm.w_lo[t], dt, pr.lo);  // crt_garner.py:89, fused as XLA does
        v[e] = dd_add(v[e], pr);
      }
    }
  }
}

// One element: d[t] holds its canonical residue mod p_t for t < N; returns
// its double-single value.
template <int NMAX>
__device__ __forceinline__ DS garner_value(const float (&d)[NMAX], const GarnerParams& prm) {
  float x[NMAX][1];
#pragma unroll
  for (int t = 0; t < NMAX; ++t) x[t][0] = d[t];
  garner_digits<NMAX, 1>(x, prm);
  DS v[1];
  garner_sum<NMAX, 1>(x, prm, v);
  return v[0];
}
