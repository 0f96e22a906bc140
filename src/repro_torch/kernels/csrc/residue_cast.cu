// Residue cast: scale -> trunc -> limb peel -> N canonical int8 residues.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/residue_cast.py:37
// (`residue_cast`, :75), which runs `common.residue_tiles_f32`
// (src/repro/kernels/common.py:93).
//
// Bound on the H100: each element reads 4 bytes of f32 and writes N int8
// residues, (4 + N) bytes, at 3.35 TB/s; and it takes some N (4 limbs + 4)
// FMA-pipe instructions (a residue a limb in three, its radix fma, the final
// reduce and the byte), at 67 TFLOP/s (33.5 T instructions a second).  At N
// = 14 and 3 limbs the instructions weigh about as much as the bytes.
//
// Design: a grid of (column groups, rows, stack entries), each thread one
// group of 4 consecutive elements of a row: no division anywhere in the
// kernel.  It loads the group as one float4 and the row's scale once
// (scale_axis 0) or a float4 of column scales (scale_axis 1), and for each
// plane takes the four residues by residue_fma.cuh's division-free route
// (the megakernels' `residue_fma`), packs the four bytes and writes them
// with one 4-byte store: plane l of stack entry s at out[s, l, :, :], so a
// warp's stores of a plane are 128 contiguous bytes.  (Peeling the limbs
// once for all planes instead ran no faster on the H100, PERF.md section
// 6.)  A k that is not a multiple of 4, or an input or a scale vector that
// is not 16-byte aligned, takes the scalar instantiation (the same
// arithmetic, element by element, masked at the row's end).  The limb count
// is a template parameter, so the limb loop unrolls to exactly the limbs
// the context needs.  The canonical residue is unique, so the planes equal
// the reference's bit for bit; the route is exact only for odd 5 <= p <=
// 255, and the C entry rejects any other modulus.
#include "residue_fma.cuh"

namespace {

constexpr int THREADS = 128;  // a block covers 512 columns of a row
constexpr int MAX_ROWS = 65535;  // grid rows; a block walks rows further apart by as many

template <int NL, bool VEC>
__global__ void __launch_bounds__(THREADS) residue_cast_kernel(const float* __restrict__ a,
                                                               const float* __restrict__ s1,
                                                               const float* __restrict__ s2,
                                                               int8_t* __restrict__ out, int m, int k,
                                                               int scale_axis, CastParams prm) {
  const int c = 4 * (blockIdx.x * THREADS + threadIdx.x);  // the group's first column
  if (c >= k) return;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(m) * k;
  for (int row = blockIdx.y; row < m; row += gridDim.y) {
    const size_t at = (static_cast<size_t>(s) * m + row) * k + c;
    float v[4], scale[4];
    if (VEC) {
      const float4 x = *reinterpret_cast<const float4*>(a + at);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = c + q < k ? a[at + q] : 0.0f;
    }
    if (scale_axis == 0) {
      const float t = s1[row] * s2[row];
#pragma unroll
      for (int q = 0; q < 4; ++q) scale[q] = t;
    } else if (VEC) {
      const float4 x = *reinterpret_cast<const float4*>(s1 + c), y = *reinterpret_cast<const float4*>(s2 + c);
      scale[0] = x.x * y.x, scale[1] = x.y * y.y, scale[2] = x.z * y.z, scale[3] = x.w * y.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) scale[q] = c + q < k ? s1[c + q] * s2[c + q] : 0.0f;
    }
    int8_t* dst = out + static_cast<size_t>(s) * prm.n_mod * plane + static_cast<size_t>(row) * k + c;
    for (int l = 0; l < prm.n_mod; ++l, dst += plane) {
      const PlaneCast pc = plane_cast(prm, l);
      float r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = residue_fma(v[q], scale[q], NL, pc);
      if (VEC) {
        *reinterpret_cast<uint32_t*>(dst) = pack4_residues(r);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < k) dst[q] = static_cast<int8_t>(residue_byte(r[q]));
        }
      }
    }
  }
}

template <int NL>
int launch(const float* a, const float* s1, const float* s2, int8_t* out, int S, int m, int k, int scale_axis,
           bool vec, const CastParams& prm, cudaStream_t stream) {
  const dim3 grid((k + 4 * THREADS - 1) / (4 * THREADS), m < MAX_ROWS ? m : MAX_ROWS, S);
  if (vec) {
    residue_cast_kernel<NL, true><<<grid, THREADS, 0, stream>>>(a, s1, s2, out, m, k, scale_axis, prm);
  } else {
    residue_cast_kernel<NL, false><<<grid, THREADS, 0, stream>>>(a, s1, s2, out, m, k, scale_axis, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int residue_cast_launch(const void* a, const void* s1, const void* s2, void* out, long long S,
                                   long long m, long long k, int scale_axis, int n_mod, int n_limbs,
                                   const int* moduli, const float* radix, void* stream) {
  CastParams prm;
  if (!make_cast_params(prm, n_mod, n_limbs, moduli, radix) || !fma_moduli_ok(n_mod, moduli) || S < 0 ||
      m < 0 || k < 0 || S > 65535 || m > 0x7FFFFFFF || k > 0x7FFFFFFF - 4 * THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S * m * k == 0) return 0;
  const auto* x = static_cast<const float*>(a);
  const auto* y1 = static_cast<const float*>(s1);
  const auto* y2 = static_cast<const float*>(s2);
  auto* o = static_cast<int8_t*>(out);
  const bool vec = k % 4 == 0 && aligned(a, 16) && aligned(out, 4) &&
                   (scale_axis == 0 || (aligned(s1, 16) && aligned(s2, 16)));
  auto* st = static_cast<cudaStream_t>(stream);
  const int iS = static_cast<int>(S), im = static_cast<int>(m), ik = static_cast<int>(k);
  switch (n_limbs) {
    case 1: return launch<1>(x, y1, y2, o, iS, im, ik, scale_axis, vec, prm, st);
    case 2: return launch<2>(x, y1, y2, o, iS, im, ik, scale_axis, vec, prm, st);
    case 3: return launch<3>(x, y1, y2, o, iS, im, ik, scale_axis, vec, prm, st);
    case 4: return launch<4>(x, y1, y2, o, iS, im, ik, scale_axis, vec, prm, st);
    default: return launch<5>(x, y1, y2, o, iS, im, ik, scale_axis, vec, prm, st);
  }
}
