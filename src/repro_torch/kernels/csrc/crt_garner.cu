// Garner mixed-radix CRT reconstruction with exact inverse scaling.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/crt_garner.py:97
// (`crt_garner`, :139), which runs `garner_tile` (:61).
//
// Bound on the H100: f32 operations.  Each output element reads N int8
// residues and writes 4 bytes (8 for the double-single pair), but its
// digits take ~8 f32 operations for each of the N(N-1)/2 pairs, plus ~30
// per digit for the double-single sum: at N = 14 that is ~1150 operations
// against 22 bytes, so 67 TFLOP/s is reached before 3.35 TB/s.
//
// Design: one thread per output element of the (S, m, n) stack, in a
// grid-stride loop; neighbouring threads read neighbouring residues of each
// plane, so every load is coalesced.  The digits are the reference's exact
// f32 integer arithmetic (all values < 2^17).  The digits -> value sum runs
// most significant digit first in double-single arithmetic with the f32
// weight table W_t 2^-S, in the op order of crt_garner.py:84-94 and
// core/expansion.py:17-52: every multiply and add rounds on its own
// (-fmad=false), except the one fused multiply-add of crt_garner.py:89,
// `pe = pe + w_lo * digit`, which XLA on the CPU contracts into an FMA and
// which is therefore an explicit __fmaf_rn here.  The digit array is held in
// registers: NMAX is a compile-time bound (8, 16 or 24) on the runtime N.
#include "common.cuh"

namespace {

struct GarnerParams {
  int n_mod;
  float p[REPRO_MAX_MODULI];
  float half[REPRO_MAX_MODULI];
  float recip[REPRO_MAX_MODULI];
  float inv[REPRO_MAX_MODULI][REPRO_MAX_MODULI];  // inv[s][t] = p_s^-1 mod p_t
  float w_hi[REPRO_MAX_MODULI];
  float w_lo[REPRO_MAX_MODULI];
};

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

template <int NMAX>
__global__ void __launch_bounds__(256) crt_garner_kernel(
    const int8_t* __restrict__ res, const float* __restrict__ r1,
    const float* __restrict__ r2, const float* __restrict__ c1,
    const float* __restrict__ c2, float* __restrict__ out, long long S,
    long long m, long long n, int out_dd, GarnerParams prm) {
  const long long mn = m * n;
  const long long total = S * mn;
  const int N = prm.n_mod;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long s = idx / mn;
    const long long pos = idx - s * mn;
    const long long i = pos / n, j = pos - i * n;
    const int8_t* src = res + s * N * mn + pos;

    // Garner digits, exact f32 integer arithmetic
    float d[NMAX];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < N) {
        const float p = prm.p[t], half = prm.half[t], recip = prm.recip[t];
        float r = static_cast<float>(src[t * mn]);
#pragma unroll
        for (int u = 0; u < NMAX; ++u) {
          if (u < t) r = sym_mod_f32((r - d[u]) * prm.inv[u][t], p, half, recip);
        }
        d[t] = r;
      }
    }

    // digits -> value, double-single, most significant digit first
    DS acc = {0.0f, 0.0f};
#pragma unroll
    for (int t = NMAX - 1; t >= 0; --t) {
      if (t < N) {
        DS pr = two_prod(prm.w_hi[t], d[t]);
        pr.lo = __fmaf_rn(prm.w_lo[t], d[t], pr.lo);  // crt_garner.py:89, fused as XLA does
        acc = dd_add(acc, pr);
      }
    }

    // exact inverse power-of-two scaling (folds in 2^S)
    const float rr = r1[i] * r2[i];
    const float cc = c1[j] * c2[j];
    if (out_dd) {
      out[(s * 2) * mn + pos] = (acc.hi * rr) * cc;
      out[(s * 2 + 1) * mn + pos] = (acc.lo * rr) * cc;
    } else {
      out[idx] = ((acc.hi + acc.lo) * rr) * cc;
    }
  }
}

}  // namespace

extern "C" int crt_garner_launch(const void* res, const void* r1, const void* r2,
                                 const void* c1, const void* c2, void* out, long long S,
                                 int n_mod, long long m, long long n, int out_dd,
                                 const int* moduli, const int* garner_inv,
                                 const float* weights, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
  GarnerParams prm;
  prm.n_mod = n_mod;
  for (int t = 0; t < n_mod; ++t) {
    prm.p[t] = static_cast<float>(moduli[t]);
    prm.half[t] = static_cast<float>((moduli[t] - 1) / 2);
    prm.recip[t] = static_cast<float>(1.0 / moduli[t]);
    prm.w_hi[t] = weights[2 * t];
    prm.w_lo[t] = weights[2 * t + 1];
    for (int u = 0; u < n_mod; ++u) prm.inv[u][t] = static_cast<float>(garner_inv[u * n_mod + t]);
  }
  const long long total = S * m * n;
  if (total == 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 64 ? want : 132LL * 64);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* R = static_cast<const int8_t*>(res);
  const auto* R1 = static_cast<const float*>(r1);
  const auto* R2 = static_cast<const float*>(r2);
  const auto* C1 = static_cast<const float*>(c1);
  const auto* C2 = static_cast<const float*>(c2);
  auto* O = static_cast<float*>(out);
  if (n_mod <= 8) {
    crt_garner_kernel<8><<<blocks, threads, 0, st>>>(R, R1, R2, C1, C2, O, S, m, n, out_dd, prm);
  } else if (n_mod <= 16) {
    crt_garner_kernel<16><<<blocks, threads, 0, st>>>(R, R1, R2, C1, C2, O, S, m, n, out_dd, prm);
  } else {
    crt_garner_kernel<24><<<blocks, threads, 0, st>>>(R, R1, R2, C1, C2, O, S, m, n, out_dd, prm);
  }
  return static_cast<int>(cudaGetLastError());
}
