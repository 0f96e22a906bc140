// Modulus-batched Karatsuba residue GEMM on the e4m3 engine: for every
// plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p)
//   CR = sym_mod(m(D) - m(E) (+ carry_R)), CI = sym_mod(m(F) - m(D) - m(E) (+ carry_I))
// with m() the symmetric mod by p_l, each residue product formed from
// balanced base-16 digits (fp8_tiles.cuh).
//
// Replaces the Pallas kernel `_karatsuba_kernel` of
// src/repro/kernels/fp8_mod_gemm.py:171 (`fp8_karatsuba_mod_gemm_batched`, :271).
//
// Bound on the H100: e4m3 tensor-core operations, 3 products x 4 digit
// products x 2 m n k per plane, 24 N m n k in all, at 1,979 TFLOP/s dense
// (4096^3 at N = 14: 11.67 ms, 4x the int8 Karatsuba kernel's bound).
//
// Design: the skeleton of karatsuba_fused.cu.  Grid (ceil(n/64),
// ceil(m/128), N); each block loops over all of K.  The sums (AR+AI) mod p
// and (BR+BI) mod p are formed canonically per byte while staging (as the
// TPU kernel forms them in VMEM, fp8_mod_gemm.py:191-192), then all six
// operands are split into hi and lo e4m3 digits: twelve staged tiles, 90 KB
// of dynamic shared memory.  Eight warps, each a 32x32 sub-tile; per
// m16n8k32 step and product four e4m3 `mma.sync` (HH, LL, both halves of
// X), each from a zero or bounded C (fp8_tiles.cuh).
//
// Registers.  The TPU kernel keeps nine f32 digit sums (HH, X, LL for D, E
// and F); on the 32x32 warp tile that is 288 registers a thread, over the
// cap of 255.  So each step's three exact digit sums are folded at once
// into the product they stand for, r_a r_b summed over the step =
// 256 HH + 16 X + LL (|.| < 2^20, exact in f32 with two explicit fmas),
// and added as an int32 to one running sum per product: at most
// 127^2 2^16 < 2^30 at k = 2^16, exact.  Three int32 accumulators a thread,
// as in karatsuba_fused.cu, and one symmetric mod per product in the
// epilogue, which yields the same canonical residue as the TPU kernel's
// m8 m(HH) + m4 m(X) + m(LL).  The two k32 sub-steps of a K step are not
// unrolled, which keeps ptxas's spills at the 255-register cap small.
//
// Epilogue (fp8_mod_gemm.py:213-233): the three exact int32 symmetric
// mods, CR = D - E and CI = F - D - E, + carry, a final mod, two int8
// planes, masked at the ragged edge.  Exact for k <= 2^16 per launch.
#include "fp8_tiles.cuh"

namespace {

constexpr int BM = 128, BN = 64, THREADS = 256;
constexpr int MT = 2, NT = 4;  // warp tile 32 x 32
constexpr int A_TILE = BM * LDS, B_TILE = BN * LDS;
// [AR, AI, AS] x [hi, lo] A tiles, then [BR, BI, BS] x [hi, lo] B tiles
constexpr int SMEM_BYTES = 6 * A_TILE + 6 * B_TILE;

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS) fp8_karatsuba_kernel(
    const int8_t* __restrict__ AR, const int8_t* __restrict__ AI,
    const int8_t* __restrict__ BR, const int8_t* __restrict__ BI,
    const int8_t* __restrict__ carry_r, const int8_t* __restrict__ carry_i,
    int8_t* __restrict__ out_r, int8_t* __restrict__ out_i, int m, int n, int k,
    ModParams prm) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                 // operand g, digit d at As + (2 g + d) * A_TILE
  int8_t* Bs = smem + 6 * A_TILE;    // likewise, B_TILE apart
  const int plane = blockIdx.z;
  const int p = prm.p[plane], half = (p - 1) >> 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t a_off = static_cast<size_t>(plane) * m * k + static_cast<size_t>(m0) * k;
  const size_t b_off = static_cast<size_t>(plane) * k * n;
  AR += a_off;
  AI += a_off;
  BR += b_off;
  BI += b_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  const int a_row = tid >> 2, a_col = (tid & 3) * 16;
  const int nb = (lane & 7) + 8 * (warp & 1);
  const int kb = (lane >> 3) + 4 * (warp >> 1);

  uint4 rar[2], rai[2];
  uint32_t rbr[4], rbi[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rar[r] = load_a16<VEC>(AR, m - m0, k, a_row + 64 * r, k0 + a_col);
      rai[r] = load_a16<VEC>(AI, m - m0, k, a_row + 64 * r, k0 + a_col);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rbr[r] = load_b4<VEC>(BR, k, n, k0 + 4 * kb + r, n0 + 4 * nb);
      rbi[r] = load_b4<VEC>(BI, k, n, k0 + 4 * kb + r, n0 + 4 * nb);
    }
  };

  int acc[3][MT][NT][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = 0;

  load(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (a_row + 64 * r) * LDS + a_col;
      store_a_digits(As, As + A_TILE, off, rar[r]);
      store_a_digits(As + 2 * A_TILE, As + 3 * A_TILE, off, rai[r]);
      store_a_digits(As + 4 * A_TILE, As + 5 * A_TILE, off, sum_mod16(rar[r], rai[r], p, half));
    }
    uint32_t rbs[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rbs[r] = sum_mod4(rbr[r], rbi[r], p, half);
    store_b_digits(Bs, Bs + B_TILE, rbr, 4 * nb, 4 * kb);
    store_b_digits(Bs + 2 * B_TILE, Bs + 3 * B_TILE, rbi, 4 * nb, 4 * kb);
    store_b_digits(Bs + 4 * B_TILE, Bs + 5 * B_TILE, rbs, 4 * nb, 4 * kb);
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll 1  // one k32 sub-step's fragments live at a time
    for (int ks = 0; ks < BK; ks += 32) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
        load_a_frags<MT>(ah, As + 2 * g * A_TILE, wm, ks, lane);
        load_a_frags<MT>(al, As + (2 * g + 1) * A_TILE, wm, ks, lane);
        load_b_frags<NT>(bh, Bs + 2 * g * B_TILE, wn, ks, lane);
        load_b_frags<NT>(bl, Bs + (2 * g + 1) * B_TILE, wn, ks, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float h[4], x[4], l[4];
            digit_products(h, x, l, ah[mt], al[mt], bh[nt], bl[nt]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              // 256 HH + 16 X + LL: every term and partial sum an integer below 2^20
              const float v = __fmaf_rn(h[c], 256.f, __fmaf_rn(x[c], 16.f, l[c]));
              acc[g][mt][nt][c] += __float2int_rn(v);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t base = static_cast<size_t>(plane) * m * n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + mt * 16 + (lane >> 2) + (c >> 1) * 8;
        const int col = n0 + wn + nt * 8 + (lane & 3) * 2 + (c & 1);
        if (row < m && col < n) {
          const size_t idx = base + static_cast<size_t>(row) * n + col;
          const int d = sym_mod_i32(acc[0][mt][nt][c], p);
          const int e = sym_mod_i32(acc[1][mt][nt][c], p);
          const int f = sym_mod_i32(acc[2][mt][nt][c], p);
          int cr = d - e, ci = f - d - e;
          if (carry_r != nullptr) {
            cr += carry_r[idx];
            ci += carry_i[idx];
          }
          out_r[idx] = static_cast<int8_t>(sym_mod_i32(cr, p));
          out_i[idx] = static_cast<int8_t>(sym_mod_i32(ci, p));
        }
      }
    }
  }
}

template <bool VEC>
int launch(const int8_t* AR, const int8_t* AI, const int8_t* BR, const int8_t* BI,
           const int8_t* CR, const int8_t* CI, int8_t* OR, int8_t* OI, int n_mod, int m, int n,
           int k, const ModParams& prm, cudaStream_t s) {
  auto kernel = fp8_karatsuba_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(AR, AI, BR, BI, CR, CI, OR, OI, m, n, k, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fp8_karatsuba_launch(const void* ar, const void* ai, const void* br,
                                    const void* bi, const void* carry_r, const void* carry_i,
                                    void* out_r, void* out_i, int n_mod, int m, int n, int k,
                                    const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const bool vec = k % 16 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ar) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ai) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(br) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(bi) % 4 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* AR = static_cast<const int8_t*>(ar);
  const auto* AI = static_cast<const int8_t*>(ai);
  const auto* BR = static_cast<const int8_t*>(br);
  const auto* BI = static_cast<const int8_t*>(bi);
  const auto* CR = static_cast<const int8_t*>(carry_r);
  const auto* CI = static_cast<const int8_t*>(carry_i);
  auto* OR = static_cast<int8_t*>(out_r);
  auto* OI = static_cast<int8_t*>(out_i);
  return vec ? launch<true>(AR, AI, BR, BI, CR, CI, OR, OI, n_mod, m, n, k, prm, s)
             : launch<false>(AR, AI, BR, BI, CR, CI, OR, OI, n_mod, m, n, k, prm, s);
}
