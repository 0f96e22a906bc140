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
// plane, so every load is coalesced.  The digits and the double-single sum
// are `garner_tile.cuh`'s `garner_value` (shared with the megakernels), in
// the reference's op order with its one fused multiply-add.  The digit
// array is held in registers: NMAX is a compile-time bound (8, 16 or 24) on
// the runtime N.
#include "garner_tile.cuh"

namespace {

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

    float d[NMAX];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < N) d[t] = static_cast<float>(src[t * mn]);
    }
    const DS acc = garner_value<NMAX>(d, prm);

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
  GarnerParams prm;
  if (!make_garner_params(prm, n_mod, moduli, garner_inv, weights)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
