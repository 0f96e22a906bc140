// Shared device helpers of the port's Hopper kernels (sm_90a).
//
// Built with -fmad=false: every float multiply and add below rounds on its
// own, as the reference's op order needs.  A kernel that fuses on purpose
// says so with an explicit __fmaf_rn.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_MAX_MODULI 24
#define REPRO_MAX_LIMBS 5  // 2^(24*4) stays inside the f32 range

// The 32-bit shared-state-space address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Canonical symmetric residue of any int32: C's % keeps the sign of v, one
// correction moves it into [-(p-1)/2, (p-1)/2].  The residue is unique, so
// this exact integer route gives the bits of the reference's f32 route.
__device__ __forceinline__ int sym_mod_i32(int v, int p) {
  const int half = (p - 1) >> 1;
  int r = v % p;
  if (r > half) r -= p;
  if (r < -half) r += p;
  return r;
}

// Cheap symmetric mod of |v| <= 254 (a sum of two residues) for any odd
// p >= 85: at most two corrections in each direction.
__device__ __forceinline__ int sym_mod_small(int v, int p, int half) {
  if (v > half) v -= p;
  if (v > half) v -= p;
  if (v < -half) v += p;
  if (v < -half) v += p;
  return v;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
