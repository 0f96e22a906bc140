// Modulus-batched int8 residue GEMM with a symmetric-mod epilogue:
// out[l] = sym_mod(A[l] @ B[l] (+ carry[l]), p_l) for every plane l.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/int8_mod_gemm.py:51
// (`int8_mod_gemm_batched`, :112).
//
// Bound on the H100: int8 tensor-core operations, 2 N m n k of them, at
// 1,979 TOP/s dense; the N (m k + k n + 2 m n) bytes are far below that
// line at the main path's sizes.
//
// Design, simple first: grid (ceil(n/BN), ceil(m/BM), N); each block owns
// one BM x BN output tile of one plane and loops over all of K itself,
// which replaces the TPU's sequential k grid axis.  Per BK-deep K step the
// A and B tiles go global -> registers -> shared memory (the next step's
// loads are issued before this step's products), B transposed on the way
// so both operands are k-contiguous.  Eight warps, each a sub-tile of
// m16n8k32 s8 `mma.sync` products with int32 accumulators in registers.
// The int32 sums are exact for k <= 2^17 (|sum| <= 127^2 2^17 < 2^31) in
// any order.  Epilogue: + carry, exact int32 symmetric mod by p_l, int8
// store, masked at the ragged edge.
//
// Tiles (BM, BN, BK; warps): (128, 128, 64; 2 x 4) is the default, with a
// 64 x 32 warp tile; (128, 128, 128; 2 x 4), (64, 128, 64; 2 x 4) and
// (128, 64, 64; 4 x 2) are the autotuner's alternatives
// (`kernels/common.COMPILED_TILES`).
#include "gemm_tiles.cuh"

namespace {

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS) int8_mod_gemm_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B,
    const int8_t* __restrict__ carry, int8_t* __restrict__ out, int m, int n,
    int k, ModParams prm) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int plane = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += static_cast<size_t>(plane) * m * k + static_cast<size_t>(m0) * k;
  B += static_cast<size_t>(plane) * k * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> T::WN_LOG2) * T::WTM, wn = (warp & (T::WARPS_N - 1)) * T::WTN;

  // staging (see Tile): A rows a_row + r A_ROWS, 16 bytes at a_col; the B
  // 4x4 blocks at n = 4 nb, k = 4 (kb + i KB_STEP)
  const int a_row = tid >> T::A_CPR_LOG2, a_col = (tid & (T::A_CPR - 1)) * 16;
  const int nb = (lane & 7) + 8 * (warp & (T::NB_GROUPS - 1));
  const int kb = (lane >> 3) + 4 * (warp >> T::NBG_LOG2);

  uint4 ra[T::A_ITERS];
  uint32_t rb[T::B_WARP_ITERS][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      const bool in = T::A_EXACT || row < BM;
      ra[r] = in ? load_a16<VEC>(A, m - m0, k, row, k0 + a_col) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
      const bool in = T::B_WARP_EXACT || kbi < BK / 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rb[i][r] = in ? load_b4<VEC>(B, k, n, k0 + 4 * kbi + r, n0 + 4 * nb) : 0u;
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  load(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      if (T::A_EXACT || row < BM) *reinterpret_cast<uint4*>(As + row * LDS + a_col) = ra[r];
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
      if (T::B_WARP_EXACT || kbi < BK / 4) store_b_block<BK>(Bs, rb[i], 4 * nb, 4 * kbi);
    }
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
    warp_tile_mma<MT, NT, BK>(acc, As, Bs, wm, wn, lane);
    __syncthreads();
  }

  const int p = prm.p[plane];
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
          int v = acc[mt][nt][c];
          if (carry != nullptr) v += carry[idx];
          out[idx] = static_cast<int8_t>(sym_mod_i32(v, p));
        }
      }
    }
  }
}

template <class T>
int launch(const int8_t* A, const int8_t* B, const int8_t* C, int8_t* O, int n_mod, int m, int n,
           int k, bool vec, const ModParams& prm, cudaStream_t s) {
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, n_mod);
  if (vec) {
    int8_mod_gemm_kernel<T, true><<<grid, T::THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  } else {
    int8_mod_gemm_kernel<T, false><<<grid, T::THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int int8_mod_gemm_launch(const void* a, const void* b, const void* carry,
                                    void* out, int n_mod, int m, int n, int k, int bm, int bn,
                                    int bk, const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const bool vec = k % 16 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 4 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  const auto* C = static_cast<const int8_t*>(carry);
  auto* O = static_cast<int8_t*>(out);
#define REPRO_TILE(BM, BN, BK, WN)                                      \
  if (bm == BM && bn == BN && bk == BK)                                 \
    return launch<Tile<BM, BN, BK, WN>>(A, B, C, O, n_mod, m, n, k, vec, prm, s);
  REPRO_TILE(128, 128, 64, 4)
  REPRO_TILE(128, 128, 128, 4)
  REPRO_TILE(64, 128, 64, 4)
  REPRO_TILE(128, 64, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
