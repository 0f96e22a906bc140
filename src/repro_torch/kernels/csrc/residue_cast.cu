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
// each limb's residue is taken in exact int32 arithmetic (`cast_tile.cuh`,
// shared with the megakernels).  The canonical residue is unique, so the
// planes equal the reference's bit for bit.  Plane l of stack entry s is
// written at out[s, l, :, :]: neighbouring threads write neighbouring
// bytes, so every plane store is coalesced.  The moduli
// and the limb radix table travel by value in the kernel's parameters.
#include "cast_tile.cuh"

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
    float limbs[REPRO_MAX_LIMBS];
    cast_limbs(a[idx], s1[si] * s2[si], prm.n_limbs, limbs);
    int8_t* dst = out + s * prm.n_mod * mk + pos;
    for (int l = 0; l < prm.n_mod; ++l) {
      dst[l * mk] = static_cast<int8_t>(limbs_residue(limbs, l, prm));
    }
  }
}

extern "C" int residue_cast_launch(const void* a, const void* s1, const void* s2,
                                   void* out, long long S, long long m, long long k,
                                   int scale_axis, int n_mod, int n_limbs,
                                   const int* moduli, const float* radix,
                                   void* stream) {
  CastParams prm;
  if (!make_cast_params(prm, n_mod, n_limbs, moduli, radix)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
