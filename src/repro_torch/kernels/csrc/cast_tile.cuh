// The per-element residue cast shared by residue_cast.cu and the two
// megakernels (fused_mod_gemm.cu, fused_karatsuba.cu): scale -> trunc ->
// base-2^24 limb peel -> canonical residue mod p_l.
//
// The op sequence is the reference's `common.residue_tiles_f32`
// (src/repro/kernels/common.py:93), in f32, except that each limb's residue
// is taken in exact int32 arithmetic: |limb| < 2^24, so its int is exact,
// while the f32 reciprocal trick's n*p could pass 2^24 and round.  The
// canonical residue is unique, so every caller gets the reference's bits.
#pragma once

#include "common.cuh"

// The moduli and the limb radix table, passed by value in the kernel's
// parameters (872 bytes).
struct CastParams {
  int n_mod;
  int n_limbs;
  int pi[REPRO_MAX_MODULI];
  float p[REPRO_MAX_MODULI];
  float half[REPRO_MAX_MODULI];
  float recip[REPRO_MAX_MODULI];
  float radix[REPRO_MAX_LIMBS][REPRO_MAX_MODULI];
};

// Fill `prm` from the host tables: `moduli` (N,) and `radix` (n_limbs, N).
// Returns false when N or the limb count is out of range.
inline bool make_cast_params(CastParams& prm, int n_mod, int n_limbs, const int* moduli,
                             const float* radix) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI || n_limbs < 1 || n_limbs > REPRO_MAX_LIMBS) {
    return false;
  }
  prm.n_mod = n_mod;
  prm.n_limbs = n_limbs;
  for (int l = 0; l < n_mod; ++l) {
    prm.pi[l] = moduli[l];
    prm.p[l] = static_cast<float>(moduli[l]);
    prm.half[l] = static_cast<float>((moduli[l] - 1) / 2);
    prm.recip[l] = static_cast<float>(1.0 / moduli[l]);
    for (int i = 0; i < n_limbs; ++i) prm.radix[i][l] = radix[i * n_mod + l];
  }
  return true;
}

// trunc(a * scale) split into exact base-2^24 limbs, most significant first.
__device__ __forceinline__ void cast_limbs(float a, float scale, int n_limbs,
                                          float (&limbs)[REPRO_MAX_LIMBS]) {
  const float x = truncf(a * scale);  // exact: power-of-two scale
  float rem = x;
#pragma unroll
  for (int i = REPRO_MAX_LIMBS - 1; i >= 1; --i) {
    if (i < n_limbs) {
      const float base = ldexpf(1.0f, 24 * i);
      const float inv = ldexpf(1.0f, -24 * i);
      const float hi = truncf(rem * inv);
      rem = rem - hi * base;
      limbs[i] = hi;
    }
  }
  limbs[0] = rem;
}

// The canonical symmetric residue mod p_l of the value whose limbs are given,
// as an f32 integer.
__device__ __forceinline__ float limbs_residue(const float (&limbs)[REPRO_MAX_LIMBS], int l,
                                               const CastParams& prm) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < REPRO_MAX_LIMBS; ++i) {
    if (i < prm.n_limbs) {
      const int r = sym_mod_i32(static_cast<int>(limbs[i]), prm.pi[l]);
      acc = acc + static_cast<float>(r) * prm.radix[i][l];
    }
  }
  // |acc| <= n_limbs * 127^2 < 2^17: the f32 route is exact here
  return sym_mod_f32(acc, prm.p[l], prm.half[l], prm.recip[l]);
}

// The residue mod p_l of trunc(a * scale), as the int8 the GEMMs read.
__device__ __forceinline__ int8_t cast_residue(float a, float scale, int l, const CastParams& prm) {
  float limbs[REPRO_MAX_LIMBS];
  cast_limbs(a, scale, prm.n_limbs, limbs);
  return static_cast<int8_t>(limbs_residue(limbs, l, prm));
}

// ---- staging of raw f32 tiles for the megakernels ---------------------------
// Loads outside the (rows, cols) extent read as zero, and a zero casts to
// zero residues, which contribute nothing to any product.  The vector path
// (16-byte loads) needs cols % 4 == 0 and a 16-byte aligned base.

// 16 values of row `r`, columns [c, c + 16).
template <bool VEC>
__device__ __forceinline__ void load_f32_16(const float* X, int rows, int cols, int r, int c,
                                            float (&v)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = 0.0f;
  if (r >= rows) return;
  const float* src = X + static_cast<size_t>(r) * cols + c;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c + 4 * q < cols) {
        const float4 f = *reinterpret_cast<const float4*>(src + 4 * q);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (c + q < cols) v[q] = src[q];
    }
  }
}

// 4 values of row `r`, columns [c, c + 4).
template <bool VEC>
__device__ __forceinline__ void load_f32_4(const float* X, int rows, int cols, int r, int c,
                                           float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = 0.0f;
  if (r >= rows) return;
  const float* src = X + static_cast<size_t>(r) * cols + c;
  if (VEC) {
    if (c < cols) {
      const float4 f = *reinterpret_cast<const float4*>(src);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c + q < cols) v[q] = src[q];
    }
  }
}

// Residues mod p_l of four values, packed low byte first; `scale[j]` is the
// power-of-two factor of value j.
__device__ __forceinline__ uint32_t cast_pack4(const float* v, const float* scale, int l,
                                               const CastParams& prm) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w |= static_cast<uint32_t>(static_cast<uint8_t>(cast_residue(v[j], scale[j], l, prm))) << (8 * j);
  }
  return w;
}

// Residues mod p_l of a 16-value row segment sharing one scale, as 16 bytes.
__device__ __forceinline__ uint4 cast_row16(const float (&v)[16], float scale, int l,
                                            const CastParams& prm) {
  const float s[4] = {scale, scale, scale, scale};
  return make_uint4(cast_pack4(v, s, l, prm), cast_pack4(v + 4, s, l, prm),
                    cast_pack4(v + 8, s, l, prm), cast_pack4(v + 12, s, l, prm));
}
