// The parameters of the per-element residue cast that residue_cast.cu and
// the two megakernels (fused_mod_gemm.cu, fused_karatsuba.cu) run by
// residue_fma.cuh's division-free route: scale -> trunc -> base-2^24 limb
// peel -> canonical residue mod p_l, the reference's
// `common.residue_tiles_f32` (src/repro/kernels/common.py:93).
#pragma once

#include "common.cuh"

// The moduli and the limb radix table, passed by value in the kernel's
// parameters (776 bytes).
struct CastParams {
  int n_mod;
  int n_limbs;
  int pi[REPRO_MAX_MODULI];
  float p[REPRO_MAX_MODULI];
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
    prm.recip[l] = static_cast<float>(1.0 / moduli[l]);
    for (int i = 0; i < n_limbs; ++i) prm.radix[i][l] = radix[i * n_mod + l];
  }
  return true;
}
