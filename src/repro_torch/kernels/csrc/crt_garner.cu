// Garner mixed-radix CRT reconstruction with exact inverse scaling.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/crt_garner.py:97
// (`crt_garner`, :139), which runs `garner_tile` (:61).
//
// Bound on the H100: f32 operations.  Each output element reads N int8
// residues and writes 4 bytes (8 for the double-single pair); the route
// below takes (N - 1)(N + 7) f32 flops for the digits, 18 a digit for the
// double-single sum and N for the byte conversions (an FMA counted 2;
// `chip_smoke.garner_flops`): 543 against 22 bytes at N = 14, so 67
// TFLOP/s is reached before 3.35 TB/s.
//
// Design.
//  * The digits by the mixed-radix form, one reduction a digit.  With M_u =
//    prod_{v<u} p_v and g_t = M_t^-1 mod p_t, digit t of the balanced mixed
//    radix expansion is
//        d_t = sym_mod(g_t x_t - sum_{u<t} (g_t M_u mod p_t) d_u, p_t),
//    with every coefficient symmetric (|c| <= 127) and d_0 = x_0.  The sum
//    is an exact f32 integer, |.| <= 24 * 127 * 128 < 2^19, so its terms are
//    fused multiply-adds (`__fmaf_rn`, exact here) and one reduction follows:
//    N(N+1)/2 - 1 FMAs and N - 1 reductions against the reference's N(N-1)/2
//    reductions.  Balanced mixed-radix digits are unique, so these are the
//    reference's digits, bit for bit (tests/test_torch_garner_schedule.py).
//    The coefficients come from the host (`kernels/crt_garner.py`
//    `route_tables`) in `garner_tile.cuh`'s GarnerParams, and the digits
//    and the double-single sum are `garner_tile.cuh`'s `garner_digits` and
//    `garner_sum`, four elements at a time, which the megakernels take one
//    element at a time.  On the H100 at
//    S = 2, 4096^2, N = 14, dd, the reference's recursion in this grid (one
//    row a thread) ran 2.4x slower.
//  * No FRND and no int-to-float conversion.  The reduction rounds v / p by
//    the f32 sum with 1.5 * 2^23 (`garner_tile.cuh`'s `garner_reduce`): for
//    the sums the route makes, |v| <= 24 * 127 * 128, and every odd modulus
//    in 3..255 the guess is the exact quotient (proven for each such v and
//    p, tests/test_torch_garner_schedule.py), so no correction follows.  A
//    residue byte b becomes an
//    f32 by its bits: 0x4B000000 | (b ^ 0x80) is 2^23 + 128 + b.  Neither
//    route makes a -0: every sum starts from +0, and a zero's sign would be
//    the one place where the magic sum and rintf differ.
//  * The double-single sum is the reference's (most significant digit
//    first, crt_garner.py:84-94) with `garner_tile.cuh`'s two shortcuts that
//    give its bits: split(w_hi) from the host, and split(d) = (d, +0).
//  * Grid (column groups, row groups, S) with no division: a thread takes
//    four consecutive columns of ROWS rows, one row after another, loads a
//    4-byte word a plane and stores float4s; the next row's words are
//    loaded while a row is computed (on the H100 at S = 2, 4096^2, N = 14,
//    dd, one row a thread without that ran 1.45x slower).  r1 r2 once a
//    row, c1 c2 once a thread.  Columns not a multiple of 4, or views not
//    aligned for those vectors, take the scalar instantiation (byte loads,
//    masked scalar stores).
#include "garner_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;             // a block: 128 threads x 4 columns
constexpr float BYTE_BIAS = 8388736.0f;  // 2^23 + 128
constexpr int ROWS = 8;                  // rows a block walks, with the next row's residues in flight
constexpr int MAX_ROWS = 65535;          // gridDim.y

// Byte i of `biased` (a residue word ^ 0x80808080) as the f32 of its int8.
__device__ __forceinline__ float byte_value(uint32_t biased, int i) {
  return __fsub_rn(__int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)), BYTE_BIAS);
}

template <int NMAX, bool VEC, bool DD>
__global__ void __launch_bounds__(THREADS) crt_garner_kernel(
    const int8_t* __restrict__ res, const float* __restrict__ r1, const float* __restrict__ r2,
    const float* __restrict__ c1, const float* __restrict__ c2, float* __restrict__ out, int m, int n,
    const __grid_constant__ GarnerParams g) {
  const int j0 = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (j0 >= n) return;
  const int N = g.n_mod, s = blockIdx.z;
  const size_t mn = static_cast<size_t>(m) * n;
  float cc[4];
  if (VEC) {
    const float4 x = *reinterpret_cast<const float4*>(c1 + j0), y = *reinterpret_cast<const float4*>(c2 + j0);
    cc[0] = __fmul_rn(x.x, y.x), cc[1] = __fmul_rn(x.y, y.y), cc[2] = __fmul_rn(x.z, y.z), cc[3] = __fmul_rn(x.w, y.w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cc[e] = j0 + e < n ? __fmul_rn(c1[j0 + e], c2[j0 + e]) : 0.0f;
  }
  // the residue words of row i, plane t at planes + t mn + i n
  const int8_t* planes = res + static_cast<size_t>(s) * N * mn + j0;
  uint32_t next[NMAX];
  const auto load_row = [&](int i) {
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < N) next[t] = load_word(planes + t * mn + static_cast<size_t>(i) * n, n - j0, VEC);
    }
  };
  if (static_cast<int>(blockIdx.y) < m) load_row(blockIdx.y);
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    float d[NMAX][4];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < N) {
        const uint32_t w = next[t] ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e) d[t][e] = byte_value(w, e);
      }
    }
    if (i + gridDim.y < m) load_row(i + gridDim.y);  // in flight while this row is computed
    const float rr = __fmul_rn(r1[i], r2[i]);
    const size_t at = static_cast<size_t>(i) * n + j0;
    garner_digits<NMAX, 4>(d, g);  // d_0 = x_0; d_t = reduce(sum_{u<=t} coef[u][t] y_u)
    DS v[4];
    garner_sum<NMAX, 4>(d, g, v);
    // exact inverse power-of-two scaling (folds in 2^S)
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (DD) {
        hi[e] = __fmul_rn(__fmul_rn(v[e].hi, rr), cc[e]);
        lo[e] = __fmul_rn(__fmul_rn(v[e].lo, rr), cc[e]);
      } else {
        hi[e] = __fmul_rn(__fmul_rn(__fadd_rn(v[e].hi, v[e].lo), rr), cc[e]);
      }
    }
    float* dst = out + static_cast<size_t>(s) * (DD ? 2 : 1) * mn + at;
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      if (DD) *reinterpret_cast<float4*>(dst + mn) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + e < n) {
          dst[e] = hi[e];
          if (DD) dst[mn + e] = lo[e];
        }
      }
    }
  }
}

template <int NMAX, bool VEC>
void launch(dim3 grid, cudaStream_t st, const int8_t* R, const float* R1, const float* R2, const float* C1,
            const float* C2, float* O, int m, int n, bool out_dd, const GarnerParams& prm) {
  if (out_dd) {
    crt_garner_kernel<NMAX, VEC, true><<<grid, THREADS, 0, st>>>(R, R1, R2, C1, C2, O, m, n, prm);
  } else {
    crt_garner_kernel<NMAX, VEC, false><<<grid, THREADS, 0, st>>>(R, R1, R2, C1, C2, O, m, n, prm);
  }
}

template <int NMAX>
void launch(bool vec, dim3 grid, cudaStream_t st, const int8_t* R, const float* R1, const float* R2,
            const float* C1, const float* C2, float* O, int m, int n, bool out_dd, const GarnerParams& prm) {
  if (vec) {
    launch<NMAX, true>(grid, st, R, R1, R2, C1, C2, O, m, n, out_dd, prm);
  } else {
    launch<NMAX, false>(grid, st, R, R1, R2, C1, C2, O, m, n, out_dd, prm);
  }
}

}  // namespace

// `moduli` (N,) odd in 3..255; `coef` (N, N) int32 and `split` (N, 2) f32
// from `route_tables`, `weights` (N, 2) f32 from `_weight_table`.
extern "C" int crt_garner_launch(const void* res, const void* r1, const void* r2, const void* c1, const void* c2,
                                 void* out, long long S, int n_mod, long long m, long long n, int out_dd,
                                 const int* moduli, const int* coef, const float* weights, const float* split,
                                 void* stream) {
  GarnerParams prm;
  if (!make_garner_params(prm, n_mod, moduli, coef, weights, split) || S < 0 || S > 65535 || m < 0 || n < 0 ||
      m > INT32_MAX || n > INT32_MAX - 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int t = 0; t < n_mod; ++t) {
    if (moduli[t] < 3 || moduli[t] > 255 || moduli[t] % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || m == 0 || n == 0) return 0;
  const bool vec = n % 4 == 0 && aligned(res, 4) && aligned(out, 16) && aligned(c1, 16) && aligned(c2, 16);
  const long long groups = (n + 3) / 4;
  const long long rows = (m + ROWS - 1) / ROWS;
  const dim3 grid(static_cast<unsigned>((groups + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows < MAX_ROWS ? rows : MAX_ROWS), static_cast<unsigned>(S));
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* R = static_cast<const int8_t*>(res);
  const auto* R1 = static_cast<const float*>(r1);
  const auto* R2 = static_cast<const float*>(r2);
  const auto* C1 = static_cast<const float*>(c1);
  const auto* C2 = static_cast<const float*>(c2);
  auto* O = static_cast<float*>(out);
  const int M = static_cast<int>(m), Nc = static_cast<int>(n);
  if (n_mod <= 8) {
    launch<8>(vec, grid, st, R, R1, R2, C1, C2, O, M, Nc, out_dd != 0, prm);
  } else if (n_mod <= 16) {
    launch<16>(vec, grid, st, R, R1, R2, C1, C2, O, M, Nc, out_dd != 0, prm);
  } else {
    launch<24>(vec, grid, st, R, R1, R2, C1, C2, O, M, Nc, out_dd != 0, prm);
  }
  return static_cast<int>(cudaGetLastError());
}
