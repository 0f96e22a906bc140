// The division-free residue cast of the residue-cast kernel
// (residue_cast.cu) and the two megakernels (fused_mod_gemm.cu,
// fused_karatsuba.cu); it includes hopper.cuh for the thread-block-cluster
// primitives the megakernels share their casts through.
//
// The cast computes the canonical symmetric residue mod p_l of trunc(a *
// scale), the reference's `common.residue_tiles_f32`
// (src/repro/kernels/common.py:93), by another exact route, with no integer
// division and no conversion per limb:
//
//   x = trunc(a * scale), peeled into base-2^24 limbs L_i (|L_i| < 2^24), as
//       the reference peels them (the same limbs);
//   per limb: q = rint(L * (1/p)), r = L - q p;
//   acc = sum_i r_i * radix_i;  v = acc - rint(acc * (1/p)) p.
//
// Why each step is exact (p is odd and 5 <= p <= 255, which the C entry
// point checks; 1/p is f32(1/p)):
//   - q = fma(L, 1/p, 1.5 * 2^23) - 1.5 * 2^23 is rint of the exact product
//     L * (1/p), rounded to nearest even as rintf does: |L * (1/p)| < 2^24 / 5
//     < 2^22, so the fma's sum lies in (2^23, 2^24), where the f32 spacing
//     is 1, and its one rounding is to an integer; the subtraction is exact.
//   - L * (1/p) is within |L/p| 2^-24 < 1/p < 1/2 of L/p, so q is rint(L/p)
//     or one off it: |r| <= p + (p-1)/2.  r = fma(-q, p, L) is exact:
//     -q p + L is an integer below 2^24.
//   - |r_i * radix_i| <= 382 * 127, and the sum over at most 5 limbs stays
//     below 2^18: every fma of the sum is exact, in any order.
//   - acc * (1/p) is within |acc/p| 2^-24 < 2^-5 / p of acc/p, while an
//     integer over an odd p is at least 1/(2p) from every half-integer: the
//     final q is exactly rint(acc/p), and v is the canonical residue,
//     |v| <= (p-1)/2, with no correction step.
// The canonical residue is unique, so the cast's bits are the reference's.
// `tests/test_torch_cast.py` runs this op sequence in numpy, rounding as f32
// does, against exact integer residues.
#pragma once

#include "cast_tile.cuh"
#include "hopper.cuh"

// Whether the route's exactness argument above holds for every modulus:
// odd 5 <= p <= 255.  The C entries of its kernels reject the rest.
inline bool fma_moduli_ok(int n_mod, const int* moduli) {
  for (int l = 0; l < n_mod; ++l) {
    if (moduli[l] < 5 || moduli[l] > 255 || moduli[l] % 2 == 0) return false;
  }
  return true;
}

// 1.5 * 2^23: the rint shifter above.  For an integer |r| < 2^22 the low
// byte of the bits of r + kShift is r's two's-complement byte (the stored
// mantissa is r + 2^22, and 2^22 is 0 mod 256).
constexpr float kShift = 12582912.0f;

// One plane's cast constants, read from CastParams once per plane.
struct PlaneCast {
  float p, recip;
  float radix[REPRO_MAX_LIMBS];
  int pi, half;  // for the per-byte sum of a pre-cast operand
};

__device__ __forceinline__ PlaneCast plane_cast(const CastParams& cp, int l) {
  PlaneCast pc;
  pc.p = cp.p[l];
  pc.recip = cp.recip[l];
#pragma unroll
  for (int i = 0; i < REPRO_MAX_LIMBS; ++i) pc.radix[i] = i < cp.n_limbs ? cp.radix[i][l] : 0.0f;
  pc.pi = cp.pi[l];
  pc.half = (cp.pi[l] - 1) >> 1;
  return pc;
}

// 2^(24 i) and 2^(-24 i), 1 <= i < REPRO_MAX_LIMBS (constants once the limb
// loop is unrolled).
__device__ __forceinline__ float limb_base(int i) {
  return i == 1 ? 0x1p24f : i == 2 ? 0x1p48f : i == 3 ? 0x1p72f : 0x1p96f;
}
__device__ __forceinline__ float limb_inv(int i) {
  return i == 1 ? 0x1p-24f : i == 2 ? 0x1p-48f : i == 3 ? 0x1p-72f : 0x1p-96f;
}

// v - rint(v * (1/p)) p: a residue of the f32 integer v, |v| < 2^24 (see
// above for its range).
__device__ __forceinline__ float reduce_fma(float v, const PlaneCast& pc) {
  // one rounding, to the integer nearest v (1/p): the sum lies in (2^23, 2^24)
  const float q = __fmaf_rn(v, pc.recip, kShift) - kShift;
  return __fmaf_rn(-q, pc.p, v);  // exact: v - q p is an integer below 2^24
}

// The canonical residue mod p of trunc(a * scale), as an f32 integer.
__device__ __forceinline__ float residue_fma(float a, float scale, int n_limbs, const PlaneCast& pc) {
  float rem = truncf(a * scale);  // exact: power-of-two scale
  float acc = 0.0f;
#pragma unroll
  for (int i = REPRO_MAX_LIMBS - 1; i >= 1; --i) {
    if (i < n_limbs) {
      const float hi = truncf(rem * limb_inv(i));  // exact: a power of two
      rem = __fmaf_rn(-hi, limb_base(i), rem);  // exact: the remainder is representable
      acc = __fmaf_rn(reduce_fma(hi, pc), pc.radix[i], acc);  // exact: integers below 2^18
    }
  }
  acc = __fmaf_rn(reduce_fma(rem, pc), pc.radix[0], acc);  // exact: integers below 2^18
  return reduce_fma(acc, pc);
}

// The canonical residue of the sum of two canonical residues: |s| < p.
__device__ __forceinline__ float sum_residue(float x, float y, const PlaneCast& pc) {
  return reduce_fma(x + y, pc);
}

// The int8 byte of a residue, in the low byte of a word.
__device__ __forceinline__ uint32_t residue_byte(float r) { return __float_as_uint(r + kShift); }

// Four residues packed low byte first.
__device__ __forceinline__ uint32_t pack4_residues(const float* r) {
  const uint32_t lo = __byte_perm(residue_byte(r[0]), residue_byte(r[1]), 0x0040);
  const uint32_t hi = __byte_perm(residue_byte(r[2]), residue_byte(r[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}
