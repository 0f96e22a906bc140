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
// Design: the skeleton of karatsuba_fused.cu.  Grid (ceil(n/BN),
// ceil(m/BM), N); each block loops over all of K.  The sums (AR+AI) mod p
// and (BR+BI) mod p are formed canonically per byte while staging (as the
// TPU kernel forms them in VMEM, fp8_mod_gemm.py:191-192), then all six
// operands are split into hi and lo e4m3 digits: twelve staged tiles, 90 KB
// of dynamic shared memory at the default tile (128, 64, 64), 60 KB at the
// other one, (64, 64, 64) (`kernels/common.COMPILED_TILES`).  Eight warps,
// each a 32x32 sub-tile at the default tile and 16 x 32 at the other; per
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

// [AR, AI, AS] x [hi, lo] A tiles, then [BR, BI, BS] x [hi, lo] B tiles
template <class T>
constexpr int smem_bytes() {
  return 6 * (T::BM + T::BN) * T::LDS;
}

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS) fp8_karatsuba_kernel(
    const int8_t* __restrict__ AR, const int8_t* __restrict__ AI,
    const int8_t* __restrict__ BR, const int8_t* __restrict__ BI,
    const int8_t* __restrict__ carry_r, const int8_t* __restrict__ carry_i,
    int8_t* __restrict__ out_r, int8_t* __restrict__ out_i, int m, int n, int k,
    ModParams prm) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  constexpr int A_TILE = BM * LDS, B_TILE = BN * LDS;
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
  const int wm = (warp >> T::WN_LOG2) * T::WTM, wn = (warp & (T::WARPS_N - 1)) * T::WTN;

  // staging (see Tile): A rows a_row + r A_ROWS, 16 bytes at a_col; the B
  // 4x4 blocks at n = 4 nb, k = 4 (kb + i KB_STEP)
  const int a_row = tid >> T::A_CPR_LOG2, a_col = (tid & (T::A_CPR - 1)) * 16;
  const int nb = (lane & 7) + 8 * (warp & (T::NB_GROUPS - 1));
  const int kb = (lane >> 3) + 4 * (warp >> T::NBG_LOG2);

  uint4 rar[T::A_ITERS], rai[T::A_ITERS];
  uint32_t rbr[T::B_WARP_ITERS][4], rbi[T::B_WARP_ITERS][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      const bool in = T::A_EXACT || row < BM;
      rar[r] = in ? load_a16<VEC>(AR, m - m0, k, row, k0 + a_col) : make_uint4(0, 0, 0, 0);
      rai[r] = in ? load_a16<VEC>(AI, m - m0, k, row, k0 + a_col) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool in = T::B_WARP_EXACT || kbi < BK / 4;
        rbr[i][r] = in ? load_b4<VEC>(BR, k, n, k0 + 4 * kbi + r, n0 + 4 * nb) : 0u;
        rbi[i][r] = in ? load_b4<VEC>(BI, k, n, k0 + 4 * kbi + r, n0 + 4 * nb) : 0u;
      }
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
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      if (T::A_EXACT || row < BM) {
        const int off = row * LDS + a_col;
        store_a_digits(As, As + A_TILE, off, rar[r]);
        store_a_digits(As + 2 * A_TILE, As + 3 * A_TILE, off, rai[r]);
        store_a_digits(As + 4 * A_TILE, As + 5 * A_TILE, off, sum_mod16(rar[r], rai[r], p, half));
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
      if (T::B_WARP_EXACT || kbi < BK / 4) {
        uint32_t rbs[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rbs[r] = sum_mod4(rbr[i][r], rbi[i][r], p, half);
        store_b_digits<BK>(Bs, Bs + B_TILE, rbr[i], 4 * nb, 4 * kbi);
        store_b_digits<BK>(Bs + 2 * B_TILE, Bs + 3 * B_TILE, rbi[i], 4 * nb, 4 * kbi);
        store_b_digits<BK>(Bs + 4 * B_TILE, Bs + 5 * B_TILE, rbs, 4 * nb, 4 * kbi);
      }
    }
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll 1  // one k32 sub-step's fragments live at a time
    for (int ks = 0; ks < BK; ks += 32) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
        load_a_frags<MT, BK>(ah, As + 2 * g * A_TILE, wm, ks, lane);
        load_a_frags<MT, BK>(al, As + (2 * g + 1) * A_TILE, wm, ks, lane);
        load_b_frags<NT, BK>(bh, Bs + 2 * g * B_TILE, wn, ks, lane);
        load_b_frags<NT, BK>(bl, Bs + (2 * g + 1) * B_TILE, wn, ks, lane);
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

struct Args {
  const int8_t *ar, *ai, *br, *bi, *cr, *ci;
  int8_t *out_r, *out_i;
};

template <class T, bool VEC>
int launch_vec(const Args& x, int n_mod, int m, int n, int k, const ModParams& prm,
               cudaStream_t s) {
  auto kernel = fp8_karatsuba_kernel<T, VEC>;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, n_mod);
  kernel<<<grid, T::THREADS, smem, s>>>(x.ar, x.ai, x.br, x.bi, x.cr, x.ci, x.out_r, x.out_i, m,
                                        n, k, prm);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const Args& x, int n_mod, int m, int n, int k, bool vec, const ModParams& prm,
           cudaStream_t s) {
  return vec ? launch_vec<T, true>(x, n_mod, m, n, k, prm, s)
             : launch_vec<T, false>(x, n_mod, m, n, k, prm, s);
}

}  // namespace

extern "C" int fp8_karatsuba_launch(const void* ar, const void* ai, const void* br,
                                    const void* bi, const void* carry_r, const void* carry_i,
                                    void* out_r, void* out_i, int n_mod, int m, int n, int k,
                                    int bm, int bn, int bk, const int* moduli, void* stream) {
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
  const Args x = {static_cast<const int8_t*>(ar),      static_cast<const int8_t*>(ai),
                  static_cast<const int8_t*>(br),      static_cast<const int8_t*>(bi),
                  static_cast<const int8_t*>(carry_r), static_cast<const int8_t*>(carry_i),
                  static_cast<int8_t*>(out_r),         static_cast<int8_t*>(out_i)};
#define REPRO_TILE(BM, BN, BK, WN) \
  if (bm == BM && bn == BN && bk == BK)  \
    return launch<Tile<BM, BN, BK, WN>>(x, n_mod, m, n, k, vec, prm, s);
  REPRO_TILE(128, 64, 64, 2)
  REPRO_TILE(64, 64, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
