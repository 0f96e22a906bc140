// Modulus-batched fused-Karatsuba residue GEMM: for every plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p)
//   CR = sym_mod(m(D) - m(E) (+ carry_R)), CI = sym_mod(m(F) - m(D) - m(E) (+ carry_I))
// with m() the symmetric mod by p_l.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/karatsuba_fused.py:60
// (`karatsuba_mod_gemm_batched`, :138).
//
// Bound on the H100: int8 tensor-core operations, 3 * 2 N m n k of them, at
// 1,979 TOP/s dense (4096^3 at N = 14: about 2.9 ms).
//
// Design: the skeleton of int8_mod_gemm.cu with four input tiles.  Grid
// (ceil(n/BN), ceil(m/BM), N); each block loops over all of K.  The sums
// (AR+AI) mod p and (BR+BI) mod p are formed per byte while the tiles are
// staged to shared memory (|sum| <= 254, at most two +/-p fixes), so they
// never reach device memory.  Three int32 accumulators D, E, F triple the
// register tile, so the default tile (128, 64, 64) has a 32x32 warp tile
// (eight warps as 4 x 2), 96 accumulator registers a thread under the 255
// cap; the three A and three B staged tiles, 3 (BM + BN) x 80 bytes, fill
// 45 KB of the 48 KB of static shared memory.  The alternatives (64, 128, 64; 2 x 4 warps, the
// same warp tile) and (64, 64, 64; 4 x 2 warps, 16 x 32) fit the same
// budget (`kernels/common.COMPILED_TILES`).  Epilogue: the three exact
// int32 symmetric mods, the CR/CI combine, + carry, a final mod, two int8
// planes.  Exact for k <= 2^17.
#include "gemm_tiles.cuh"

namespace {

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS) karatsuba_kernel(
    const int8_t* __restrict__ AR, const int8_t* __restrict__ AI,
    const int8_t* __restrict__ BR, const int8_t* __restrict__ BI,
    const int8_t* __restrict__ carry_r, const int8_t* __restrict__ carry_i,
    int8_t* __restrict__ out_r, int8_t* __restrict__ out_i, int m, int n, int k,
    ModParams prm) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  __shared__ __align__(16) int8_t As[3][BM * LDS];  // AR, AI, (AR+AI) mod p
  __shared__ __align__(16) int8_t Bs[3][BN * LDS];  // BR, BI, (BR+BI) mod p
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
        *reinterpret_cast<uint4*>(As[0] + off) = rar[r];
        *reinterpret_cast<uint4*>(As[1] + off) = rai[r];
        *reinterpret_cast<uint4*>(As[2] + off) = sum_mod16(rar[r], rai[r], p, half);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
      if (T::B_WARP_EXACT || kbi < BK / 4) {
        uint32_t rbs[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rbs[r] = sum_mod4(rbr[i][r], rbi[i][r], p, half);
        store_b_block<BK>(Bs[0], rbr[i], 4 * nb, 4 * kbi);
        store_b_block<BK>(Bs[1], rbi[i], 4 * nb, 4 * kbi);
        store_b_block<BK>(Bs[2], rbs, 4 * nb, 4 * kbi);
      }
    }
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll
    for (int g = 0; g < 3; ++g) warp_tile_mma<MT, NT, BK>(acc[g], As[g], Bs[g], wm, wn, lane);
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

template <class T>
int launch(const Args& x, int n_mod, int m, int n, int k, bool vec, const ModParams& prm,
           cudaStream_t s) {
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, n_mod);
  if (vec) {
    karatsuba_kernel<T, true><<<grid, T::THREADS, 0, s>>>(x.ar, x.ai, x.br, x.bi, x.cr, x.ci,
                                                          x.out_r, x.out_i, m, n, k, prm);
  } else {
    karatsuba_kernel<T, false><<<grid, T::THREADS, 0, s>>>(x.ar, x.ai, x.br, x.bi, x.cr, x.ci,
                                                           x.out_r, x.out_i, m, n, k, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int karatsuba_mod_gemm_launch(const void* ar, const void* ai, const void* br,
                                         const void* bi, const void* carry_r,
                                         const void* carry_i, void* out_r, void* out_i,
                                         int n_mod, int m, int n, int k, int bm, int bn, int bk,
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
  const Args x = {static_cast<const int8_t*>(ar),      static_cast<const int8_t*>(ai),
                  static_cast<const int8_t*>(br),      static_cast<const int8_t*>(bi),
                  static_cast<const int8_t*>(carry_r), static_cast<const int8_t*>(carry_i),
                  static_cast<int8_t*>(out_r),         static_cast<int8_t*>(out_i)};
#define REPRO_TILE(BM, BN, BK, WN) \
  if (bm == BM && bn == BN && bk == BK)  \
    return launch<Tile<BM, BN, BK, WN>>(x, n_mod, m, n, k, vec, prm, s);
  REPRO_TILE(128, 64, 64, 2)
  REPRO_TILE(64, 128, 64, 4)
  REPRO_TILE(64, 64, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
