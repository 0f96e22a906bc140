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
// (ceil(n/64), ceil(m/128), N); each block loops over all of K.  The sums
// (AR+AI) mod p and (BR+BI) mod p are formed per byte while the tiles are
// staged to shared memory (|sum| <= 254, at most two +/-p fixes), so they
// never reach device memory.  Three int32 accumulators D, E, F triple the
// register tile, so the warp tile is 32x32 (eight warps as 4 x 2), 96
// accumulator registers a thread under the 255 cap.  Epilogue: the three
// exact int32 symmetric mods, the CR/CI combine, + carry, a final mod, two
// int8 planes.  Exact for k <= 2^17.
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 128, BN = 64, THREADS = 256;
constexpr int MT = 2, NT = 4;  // warp tile 32 x 32

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS) karatsuba_kernel(
    const int8_t* __restrict__ AR, const int8_t* __restrict__ AI,
    const int8_t* __restrict__ BR, const int8_t* __restrict__ BI,
    const int8_t* __restrict__ carry_r, const int8_t* __restrict__ carry_i,
    int8_t* __restrict__ out_r, int8_t* __restrict__ out_i, int m, int n, int k,
    ModParams prm) {
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
      *reinterpret_cast<uint4*>(As[0] + off) = rar[r];
      *reinterpret_cast<uint4*>(As[1] + off) = rai[r];
      *reinterpret_cast<uint4*>(As[2] + off) = sum_mod16(rar[r], rai[r], p, half);
    }
    uint32_t rbs[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rbs[r] = sum_mod4(rbr[r], rbi[r], p, half);
    store_b_block(Bs[0], rbr, 4 * nb, 4 * kb);
    store_b_block(Bs[1], rbi, 4 * nb, 4 * kb);
    store_b_block(Bs[2], rbs, 4 * nb, 4 * kb);
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll
    for (int g = 0; g < 3; ++g) warp_tile_mma<MT, NT>(acc[g], As[g], Bs[g], wm, wn, lane);
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

}  // namespace

extern "C" int karatsuba_mod_gemm_launch(const void* ar, const void* ai, const void* br,
                                         const void* bi, const void* carry_r,
                                         const void* carry_i, void* out_r, void* out_i,
                                         int n_mod, int m, int n, int k,
                                         const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
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
  if (vec) {
    karatsuba_kernel<true><<<grid, THREADS, 0, s>>>(AR, AI, BR, BI, CR, CI, OR, OI, m, n, k, prm);
  } else {
    karatsuba_kernel<false><<<grid, THREADS, 0, s>>>(AR, AI, BR, BI, CR, CI, OR, OI, m, n, k, prm);
  }
  return static_cast<int>(cudaGetLastError());
}
