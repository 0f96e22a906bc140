// Residue cast: scale -> trunc -> limb peel -> N canonical int8 residues.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/residue_cast.py:37
// (`residue_cast`, :75), which runs `common.residue_tiles_f32`
// (src/repro/kernels/common.py:93).
//
// Bound on the H100: memory.  Each element reads 4 bytes of f32 and writes
// N int8 residues, (4 + N) bytes, against ~N*(5 + 8*limbs) f32 operations,
// so at 3.35 TB/s the bytes take longer than the arithmetic at 67 TFLOP/s.
//
// Design: one thread per element of the (S, m, k) f32 stack, in a grid-stride
// loop.  It runs the reference's op sequence in f32 (the scale product, the
// trunc, the base-2^24 limb peel, the per-modulus residue sum), except that
// each limb's residue is taken in exact int32 arithmetic.  The canonical
// residue is unique, so the planes equal the reference's bit for bit.  Plane
// l of stack entry s is written at out[s, l, :, :]: neighbouring threads
// write neighbouring bytes, so every plane store is coalesced.  The moduli
// and the limb radix table travel by value in the kernel's parameters.
#include "common.cuh"

struct CastParams {
  int n_mod;
  int n_limbs;
  int pi[REPRO_MAX_MODULI];
  float p[REPRO_MAX_MODULI];
  float half[REPRO_MAX_MODULI];
  float recip[REPRO_MAX_MODULI];
  float radix[REPRO_MAX_LIMBS][REPRO_MAX_MODULI];
};

__global__ void __launch_bounds__(256) residue_cast_kernel(
    const float* __restrict__ a, const float* __restrict__ s1,
    const float* __restrict__ s2, int8_t* __restrict__ out, long long S,
    long long m, long long k, int scale_axis, CastParams prm) {
  const long long mk = m * k;
  const long long total = S * mk;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long s = idx / mk;
    const long long pos = idx - s * mk;
    const long long si = scale_axis == 0 ? pos / k : pos % k;
    const float scale = s1[si] * s2[si];
    const float x = truncf(a[idx] * scale);  // exact: power-of-two scale

    // exact base-2^24 limb peel, most significant limb first
    float limbs[REPRO_MAX_LIMBS];
    float rem = x;
#pragma unroll
    for (int i = REPRO_MAX_LIMBS - 1; i >= 1; --i) {
      if (i < prm.n_limbs) {
        const float base = ldexpf(1.0f, 24 * i);
        const float inv = ldexpf(1.0f, -24 * i);
        const float hi = truncf(rem * inv);
        rem = rem - hi * base;
        limbs[i] = hi;
      }
    }
    limbs[0] = rem;

    int8_t* dst = out + s * prm.n_mod * mk + pos;
    for (int l = 0; l < prm.n_mod; ++l) {
      const float p = prm.p[l], half = prm.half[l], recip = prm.recip[l];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < REPRO_MAX_LIMBS; ++i) {
        if (i < prm.n_limbs) {
          // exact int32 residue of the limb (|limb| < 2^24, so its int is
          // exact); the f32 reciprocal trick's n*p could pass 2^24 and round
          const int r = sym_mod_i32(static_cast<int>(limbs[i]), prm.pi[l]);
          acc = acc + static_cast<float>(r) * prm.radix[i][l];
        }
      }
      dst[l * mk] = static_cast<int8_t>(sym_mod_f32(acc, p, half, recip));
    }
  }
}

extern "C" int residue_cast_launch(const void* a, const void* s1, const void* s2,
                                   void* out, long long S, long long m, long long k,
                                   int scale_axis, int n_mod, int n_limbs,
                                   const int* moduli, const float* radix,
                                   void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI || n_limbs < 1 || n_limbs > REPRO_MAX_LIMBS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CastParams prm;
  prm.n_mod = n_mod;
  prm.n_limbs = n_limbs;
  for (int l = 0; l < n_mod; ++l) {
    prm.pi[l] = moduli[l];
    prm.p[l] = static_cast<float>(moduli[l]);
    prm.half[l] = static_cast<float>((moduli[l] - 1) / 2);
    prm.recip[l] = static_cast<float>(1.0 / moduli[l]);
    for (int i = 0; i < n_limbs; ++i) prm.radix[i][l] = radix[i * n_mod + l];
  }
  const long long total = S * m * k;
  if (total == 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 64 ? want : 132LL * 64);
  residue_cast_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<int8_t*>(out), S, m, k,
      scale_axis, prm);
  return static_cast<int>(cudaGetLastError());
}
