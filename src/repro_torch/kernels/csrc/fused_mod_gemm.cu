// The one-launch real megakernel: C = A @ B emulated end to end.  For one
// 64x64 output tile it casts the f32 operand tiles to residues, runs the N
// int8 plane products with the K-chunk reduction inside, and reconstructs
// the tile by Garner with exact inverse scaling.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/int8_mod_gemm.py:162 (`fused_mod_gemm`, :303).
//
// Bound on the H100: int8 tensor-core operations, 2 N m n k of them at
// 1,979 TOP/s dense (4096^3 at N = 8: 0.556 ms); the f32 operands and the
// output, 4 (m k + k n + m n) bytes, take less at 3.35 TB/s.
//
// Design.  The TPU kernel keeps all N planes' int32 accumulators, an
// (N, 256, 256) block of VMEM, live across its K grid axis; an H100 block
// has 227 KB of shared memory and 255 registers a thread, so the loops are
// turned round: planes outside, K inside, one BM x BN output tile a block.
//  - For plane l, each BK-deep K step loads the raw f32 A tile (and B tile)
//    into registers, casts them to residues mod p_l with `cast_tile.cuh`
//    (the residue_cast kernel's exact op sequence) into the padded
//    [rows][LDS] staging of `gemm_tiles.cuh`, B transposed on the way, and
//    accumulates the product by s8 `mma.sync` in int32 registers.  A
//    prepared operand's int8 plane l is loaded as it is instead of cast.
//  - Every `chunk_steps` K steps the accumulators are reduced by the exact
//    int32 symmetric mod (the reference's in-kernel chunk reduction,
//    int8_mod_gemm.py:217-225), so any k stays exact.
//  - The canonical int8 residue of plane l is stashed in dynamic shared
//    memory, N * BM * BN bytes (96 KB at N = 24 for the default 64 x 64
//    tile, 192 KB for the other, 128 x 64, which casts each B tile for half
//    as many output tiles; `kernels/common.COMPILED_TILES`).
//  - The epilogue runs Garner (`garner_tile.cuh`, the crt_garner kernel's
//    exact op sequence) on the stash, one thread per output element, and
//    applies the inverse scaling.
// Every residue is the unique canonical one, so the output equals the
// 4-launch cast/product/Garner composition bit for bit.  The cast is
// recomputed for every plane and every output tile it feeds: this simple
// version is bound by that integer work, not by the tensor cores.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"

namespace {

struct Operands {
  const float* a;        // (m, k) f32
  const float* sa1;      // (m,) row scale factors
  const float* sa2;
  const float* b;        // (k, n) f32, or null when prepared
  const int8_t* b_res;   // (N, k, n) int8 planes, or null
  const float* sb1;      // (n,) column scale factors, or null when prepared
  const float* sb2;
  const float* r1;       // (m,) inverse scale factors
  const float* r2;
  const float* c1;       // (n,)
  const float* c2;
  float* out;            // (m, n) f32, or (2, m, n) double-single
};

template <class T, int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(T::THREADS) fused_mod_gemm_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS;
  extern __shared__ __align__(16) int8_t stash[];  // [N][BM * BN]
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
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

  float ra[T::A_ITERS][16];
  float rb[T::B_ITERS][4][4];
  uint32_t rq[T::B_ITERS][4];
  auto load = [&](int l, int k0) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      // rows past the tile read as past the matrix: zeros
      load_f32_16<VEC>(op.a, (T::A_EXACT || row < BM) ? m : 0, k, m0 + row, k0 + a_col, ra[r]);
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int kbi = b_kb + i * T::B_KBS;
      const int kk = k0 + 4 * kbi;
      const int rows = (T::B_EXACT || kbi < BK / 4) ? k : 0;  // past the tile: zeros
      if (PREPARED) {
        const int8_t* plane = op.b_res + static_cast<size_t>(l) * k * n;
#pragma unroll
        for (int r = 0; r < 4; ++r) rq[i][r] = load_b4<VEC>(plane, rows, n, kk + r, n0 + 4 * b_nb);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) load_f32_4<VEC>(op.b, rows, n, kk + r, n0 + 4 * b_nb, rb[i][r]);
      }
    }
  };

  for (int l = 0; l < cp.n_mod; ++l) {
    const int p = cp.pi[l];
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

    load(l, 0);
    int step = 0;
    for (int k0 = 0; k0 < k; k0 += BK, ++step) {
#pragma unroll
      for (int r = 0; r < T::A_ITERS; ++r) {
        const int row = a_row + r * T::A_ROWS;
        if (T::A_EXACT || row < BM) {
          *reinterpret_cast<uint4*>(As + row * LDS + a_col) = cast_row16(ra[r], scale_a[r], l, cp);
        }
      }
#pragma unroll
      for (int i = 0; i < T::B_ITERS; ++i) {
        const int kbi = b_kb + i * T::B_KBS;
        if (T::B_EXACT || kbi < BK / 4) {
          uint32_t x[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[r] = PREPARED ? rq[i][r] : cast_pack4(rb[i][r], scale_b, l, cp);
          }
          store_b_block<BK>(Bs, x, 4 * b_nb, 4 * kbi);
        }
      }
      __syncthreads();
      if (k0 + BK < k) load(l, k0 + BK);
      warp_tile_mma<MT, NT, BK>(acc, As, Bs, wm, wn, lane);
      __syncthreads();
      if ((step + 1) % chunk_steps == 0 && k0 + BK < k) {
        // in-kernel K-chunk reduction: keeps the int32 sums exact for any k
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] = sym_mod_i32(acc[mt][nt][c], p);
      }
    }

    int8_t* st = stash + l * (BM * BN);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = wm + mt * 16 + (lane >> 2) + (c >> 1) * 8;
          const int col = wn + nt * 8 + (lane & 3) * 2 + (c & 1);
          st[row * BN + col] = static_cast<int8_t>(sym_mod_i32(acc[mt][nt][c], p));
        }
      }
    }
  }
  __syncthreads();

  // epilogue: Garner + inverse scaling, one thread per output element
  const size_t mn = static_cast<size_t>(m) * n;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gi = m0 + e / BN, gj = n0 + e % BN;
    if (gi >= m || gj >= n) continue;
    float d[NMAX];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < gp.n_mod) d[t] = static_cast<float>(stash[t * (BM * BN) + e]);
    }
    const DS v = garner_value<NMAX>(d, gp);
    const float rr = op.r1[gi] * op.r2[gi];
    const float cc = op.c1[gj] * op.c2[gj];
    const size_t o = static_cast<size_t>(gi) * n + gj;
    if (out_dd) {
      op.out[o] = (v.hi * rr) * cc;
      op.out[mn + o] = (v.lo * rr) * cc;
    } else {
      op.out[o] = ((v.hi + v.lo) * rr) * cc;
    }
  }
}

template <class T, int NMAX, bool PREPARED, bool VEC>
int launch(const Operands& op, int m, int n, int k, int chunk_limit, int out_dd,
           const CastParams& cp, const GarnerParams& gp, cudaStream_t stream) {
  auto kernel = fused_mod_gemm_kernel<T, NMAX, PREPARED, VEC>;
  const int smem = cp.n_mod * T::BM * T::BN;
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

}  // namespace

extern "C" int fused_mod_gemm_launch(const void* a, const void* sa1, const void* sa2,
                                     const void* b, const void* b_res, const void* sb1,
                                     const void* sb2, const void* r1, const void* r2,
                                     const void* c1, const void* c2, void* out, int m, int n,
                                     int k, int chunk_limit, int out_dd, int n_mod, int n_limbs,
                                     int bm, int bn, int bk, const int* moduli, const float* radix,
                                     const int* garner_inv, const float* weights, void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, garner_inv, weights) || chunk_limit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  const Operands op = {
      static_cast<const float*>(a),   static_cast<const float*>(sa1),
      static_cast<const float*>(sa2), static_cast<const float*>(b),
      static_cast<const int8_t*>(b_res), static_cast<const float*>(sb1),
      static_cast<const float*>(sb2), static_cast<const float*>(r1),
      static_cast<const float*>(r2),  static_cast<const float*>(c1),
      static_cast<const float*>(c2),  static_cast<float*>(out)};
  const bool prepared = b_res != nullptr;
  const uintptr_t b_addr = reinterpret_cast<uintptr_t>(prepared ? b_res : b);
  const bool vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   b_addr % (prepared ? 4 : 16) == 0;
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM, BN, BK, WN)                                                            \
  if (bm == BM && bn == BN && bk == BK)                                                       \
    return dispatch_n<Tile<BM, BN, BK, WN>>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, \
                                            gp, s);
  REPRO_TILE(64, 64, 64, 4)
  REPRO_TILE(128, 64, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
