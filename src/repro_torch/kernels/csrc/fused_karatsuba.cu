// The one-launch complex megakernel: (CR, CI) = (AR + i AI)(BR + i BI)
// emulated end to end.  For one BM x BN output tile it casts AR/AI (and
// BR/BI) to residues, runs the Karatsuba triple for every plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p),
//   CR = m(m(D) - m(E)), CI = m(m(F) - m(D) - m(E))   (m: symmetric mod p_l)
// with the K-chunk reduction inside, and reconstructs CR and CI by Garner
// with exact inverse scaling.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/karatsuba_fused.py:194 (`fused_karatsuba_mod_gemm`, :337).
//
// Bound on the H100: int8 tensor-core operations, 3 * 2 N m n k of them at
// 1,979 TOP/s dense (4096^3 at N = 14: 2.917 ms); the f32 operands and
// outputs, 8 (m k + k n + m n) bytes, take less at 3.35 TB/s.
//
// Design: the plane-outer, K-inner loop of fused_mod_gemm.cu (which see)
// with four input tiles.  The TPU kernel keeps three (N, 256, 256) int32
// accumulators live across its K grid axis, about 11 MB at N = 14; here the
// three accumulators of one plane live in registers (a 32x16 warp tile,
// 48 a thread, at the default 64 x 64 tile) and only the canonical int8 CR
// and CI residues of each finished plane are stashed in dynamic shared
// memory, 2 * N * BM * BN bytes (112 KB at N = 14, 192 KB at N = 24 for
// 64 x 64).  A larger tile does not fit beside the 30 KB of staging at
// N = 24, so the other compiled tile is smaller, (64, 32, 64) with a
// 16 x 16 warp tile and half the stash (`kernels/common.COMPILED_TILES`).
// The sums (AR+AI) mod p and (BR+BI) mod p are formed per byte while the
// cast tiles are staged, as in karatsuba_fused.cu.  The epilogue runs
// Garner twice, on the CR and the CI stash.  Every residue is the unique
// canonical one, so the output equals
// the 4-launch cast/Karatsuba/Garner composition bit for bit.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"

namespace {

struct Operands {
  const float* ar;       // (m, k) f32 real and imaginary parts
  const float* ai;
  const float* sa1;      // (m,) row scale factors
  const float* sa2;
  const float* br;       // (k, n) f32, or null when prepared
  const float* bi;
  const int8_t* brr;     // (N, k, n) int8 planes, or null
  const int8_t* bri;
  const float* sb1;      // (n,) column scale factors, or null when prepared
  const float* sb2;
  const float* r1;       // (m,) inverse scale factors
  const float* r2;
  const float* c1;       // (n,)
  const float* c2;
  float* out_r;          // (m, n) f32, or (2, m, n) double-single
  float* out_i;
};

template <class T, int NMAX>
__device__ __forceinline__ void garner_store(const int8_t* st, int e, int gi, int gj, float rr,
                                             float cc, float* out, size_t mn, int n, int out_dd,
                                             const GarnerParams& gp) {
  float d[NMAX];
#pragma unroll
  for (int t = 0; t < NMAX; ++t) {
    if (t < gp.n_mod) d[t] = static_cast<float>(st[t * (T::BM * T::BN) + e]);
  }
  const DS v = garner_value<NMAX>(d, gp);
  const size_t o = static_cast<size_t>(gi) * n + gj;
  if (out_dd) {
    out[o] = (v.hi * rr) * cc;
    out[mn + o] = (v.lo * rr) * cc;
  } else {
    out[o] = ((v.hi + v.lo) * rr) * cc;
  }
}

template <class T, int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(T::THREADS) fused_karatsuba_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS;
  extern __shared__ __align__(16) int8_t stash[];  // CR [N][BM * BN], then CI
  __shared__ __align__(16) int8_t As[3][BM * LDS];  // AR, AI, (AR+AI) mod p
  __shared__ __align__(16) int8_t Bs[3][BN * LDS];  // BR, BI, (BR+BI) mod p
  const int N = cp.n_mod;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> T::WN_LOG2) * T::WTM, wn = (warp & (T::WARPS_N - 1)) * T::WTN;

  // staging (see Tile): A rows a_row + r A_ROWS, 16 values at a_col; the B
  // 4x4 blocks at n = n0 + 4 b_nb, k = 4 (b_kb + i B_KBS), the same columns
  // every round
  const int a_row = tid >> T::A_CPR_LOG2, a_col = (tid & (T::A_CPR - 1)) * 16;
  const int b_nb = tid & (T::NB - 1), b_kb = tid >> T::NB_LOG2;
  float scale_a[T::A_ITERS];
#pragma unroll
  for (int r = 0; r < T::A_ITERS; ++r) {
    const int ga = m0 + a_row + r * T::A_ROWS;
    scale_a[r] = ga < m ? op.sa1[ga] * op.sa2[ga] : 0.0f;
  }
  float scale_b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gc = n0 + 4 * b_nb + j;
    scale_b[j] = (!PREPARED && gc < n) ? op.sb1[gc] * op.sb2[gc] : 0.0f;
  }

  float rar[T::A_ITERS][16], rai[T::A_ITERS][16];
  float rbr[T::B_ITERS][4][4], rbi[T::B_ITERS][4][4];
  uint32_t qr[T::B_ITERS][4], qi[T::B_ITERS][4];
  auto load = [&](int l, int k0) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      const int rows = (T::A_EXACT || row < BM) ? m : 0;  // past the tile: zeros
      load_f32_16<VEC>(op.ar, rows, k, m0 + row, k0 + a_col, rar[r]);
      load_f32_16<VEC>(op.ai, rows, k, m0 + row, k0 + a_col, rai[r]);
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int kbi = b_kb + i * T::B_KBS;
      const int kk = k0 + 4 * kbi;
      const int rows = (T::B_EXACT || kbi < BK / 4) ? k : 0;  // past the tile: zeros
      if (PREPARED) {
        const size_t off = static_cast<size_t>(l) * k * n;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qr[i][r] = load_b4<VEC>(op.brr + off, rows, n, kk + r, n0 + 4 * b_nb);
          qi[i][r] = load_b4<VEC>(op.bri + off, rows, n, kk + r, n0 + 4 * b_nb);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          load_f32_4<VEC>(op.br, rows, n, kk + r, n0 + 4 * b_nb, rbr[i][r]);
          load_f32_4<VEC>(op.bi, rows, n, kk + r, n0 + 4 * b_nb, rbi[i][r]);
        }
      }
    }
  };

  for (int l = 0; l < N; ++l) {
    const int p = cp.pi[l], half = (p - 1) >> 1;
    int acc[3][MT][NT][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = 0;

    load(l, 0);
    int step = 0;
    for (int k0 = 0; k0 < k; k0 += BK, ++step) {
#pragma unroll
      for (int r = 0; r < T::A_ITERS; ++r) {
        const int row = a_row + r * T::A_ROWS;
        if (T::A_EXACT || row < BM) {
          const int off = row * LDS + a_col;
          const uint4 xr = cast_row16(rar[r], scale_a[r], l, cp);
          const uint4 xi = cast_row16(rai[r], scale_a[r], l, cp);
          *reinterpret_cast<uint4*>(As[0] + off) = xr;
          *reinterpret_cast<uint4*>(As[1] + off) = xi;
          *reinterpret_cast<uint4*>(As[2] + off) = sum_mod16(xr, xi, p, half);
        }
      }
#pragma unroll
      for (int i = 0; i < T::B_ITERS; ++i) {
        const int kbi = b_kb + i * T::B_KBS;
        if (T::B_EXACT || kbi < BK / 4) {
          uint32_t wr[4], wi[4], ws[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            wr[r] = PREPARED ? qr[i][r] : cast_pack4(rbr[i][r], scale_b, l, cp);
            wi[r] = PREPARED ? qi[i][r] : cast_pack4(rbi[i][r], scale_b, l, cp);
            ws[r] = sum_mod4(wr[r], wi[r], p, half);
          }
          store_b_block<BK>(Bs[0], wr, 4 * b_nb, 4 * kbi);
          store_b_block<BK>(Bs[1], wi, 4 * b_nb, 4 * kbi);
          store_b_block<BK>(Bs[2], ws, 4 * b_nb, 4 * kbi);
        }
      }
      __syncthreads();
      if (k0 + BK < k) load(l, k0 + BK);
#pragma unroll
      for (int g = 0; g < 3; ++g) warp_tile_mma<MT, NT, BK>(acc[g], As[g], Bs[g], wm, wn, lane);
      __syncthreads();
      if ((step + 1) % chunk_steps == 0 && k0 + BK < k) {
        // in-kernel K-chunk reduction: keeps the int32 sums exact for any k
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = sym_mod_i32(acc[g][mt][nt][c], p);
      }
    }

    int8_t* st_r = stash + l * (BM * BN);
    int8_t* st_i = stash + (N + l) * (BM * BN);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = wm + mt * 16 + (lane >> 2) + (c >> 1) * 8;
          const int col = wn + nt * 8 + (lane & 3) * 2 + (c & 1);
          const int d = sym_mod_i32(acc[0][mt][nt][c], p);
          const int e = sym_mod_i32(acc[1][mt][nt][c], p);
          const int f = sym_mod_i32(acc[2][mt][nt][c], p);
          st_r[row * BN + col] = static_cast<int8_t>(sym_mod_i32(d - e, p));
          st_i[row * BN + col] = static_cast<int8_t>(sym_mod_i32(f - d - e, p));
        }
      }
    }
  }
  __syncthreads();

  // epilogue: two Garner reconstructions + inverse scaling per element
  const size_t mn = static_cast<size_t>(m) * n;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gi = m0 + e / BN, gj = n0 + e % BN;
    if (gi >= m || gj >= n) continue;
    const float rr = op.r1[gi] * op.r2[gi];
    const float cc = op.c1[gj] * op.c2[gj];
    garner_store<T, NMAX>(stash, e, gi, gj, rr, cc, op.out_r, mn, n, out_dd, gp);
    garner_store<T, NMAX>(stash + N * (BM * BN), e, gi, gj, rr, cc, op.out_i, mn, n, out_dd, gp);
  }
}

template <class T, int NMAX, bool PREPARED, bool VEC>
int launch(const Operands& op, int m, int n, int k, int chunk_limit, int out_dd,
           const CastParams& cp, const GarnerParams& gp, cudaStream_t stream) {
  auto kernel = fused_karatsuba_kernel<T, NMAX, PREPARED, VEC>;
  const int smem = 2 * cp.n_mod * T::BM * T::BN;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk_steps = chunk_limit / T::BK > 1 ? chunk_limit / T::BK : 1;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, smem, stream>>>(op, m, n, k, chunk_steps, out_dd, cp, gp);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int NMAX>
int dispatch(const Operands& op, bool prepared, bool vec, int m, int n, int k, int chunk_limit,
             int out_dd, const CastParams& cp, const GarnerParams& gp, cudaStream_t s) {
  if (prepared) {
    return vec ? launch<T, NMAX, true, true>(op, m, n, k, chunk_limit, out_dd, cp, gp, s)
               : launch<T, NMAX, true, false>(op, m, n, k, chunk_limit, out_dd, cp, gp, s);
  }
  return vec ? launch<T, NMAX, false, true>(op, m, n, k, chunk_limit, out_dd, cp, gp, s)
             : launch<T, NMAX, false, false>(op, m, n, k, chunk_limit, out_dd, cp, gp, s);
}

template <class T>
int dispatch_n(const Operands& op, bool prepared, bool vec, int m, int n, int k, int chunk_limit,
               int out_dd, const CastParams& cp, const GarnerParams& gp, cudaStream_t s) {
  const int nm = cp.n_mod;
  if (nm <= 8) return dispatch<T, 8>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
  if (nm <= 16) return dispatch<T, 16>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
  return dispatch<T, 24>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

extern "C" int fused_karatsuba_launch(const void* ar, const void* ai, const void* sa1,
                                      const void* sa2, const void* br, const void* bi,
                                      const void* brr, const void* bri, const void* sb1,
                                      const void* sb2, const void* r1, const void* r2,
                                      const void* c1, const void* c2, void* out_r, void* out_i,
                                      int m, int n, int k, int chunk_limit, int out_dd, int n_mod,
                                      int n_limbs, int bm, int bn, int bk, const int* moduli,
                                      const float* radix, const int* garner_inv,
                                      const float* weights, void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, garner_inv, weights) || chunk_limit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  const Operands op = {
      static_cast<const float*>(ar),   static_cast<const float*>(ai),
      static_cast<const float*>(sa1),  static_cast<const float*>(sa2),
      static_cast<const float*>(br),   static_cast<const float*>(bi),
      static_cast<const int8_t*>(brr), static_cast<const int8_t*>(bri),
      static_cast<const float*>(sb1),  static_cast<const float*>(sb2),
      static_cast<const float*>(r1),   static_cast<const float*>(r2),
      static_cast<const float*>(c1),   static_cast<const float*>(c2),
      static_cast<float*>(out_r),      static_cast<float*>(out_i)};
  const bool prepared = brr != nullptr;
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned(ar, 16) && aligned(ai, 16) &&
                   (prepared ? aligned(brr, 4) && aligned(bri, 4)
                             : aligned(br, 16) && aligned(bi, 16));
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM, BN, BK, WN)                                                            \
  if (bm == BM && bn == BN && bk == BK)                                                       \
    return dispatch_n<Tile<BM, BN, BK, WN>>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, \
                                            gp, s);
  REPRO_TILE(64, 64, 64, 4)
  REPRO_TILE(64, 32, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
