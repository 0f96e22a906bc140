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
// Design, simple first: grid (ceil(n/128), ceil(m/128), N); each block owns
// one 128x128 output tile of one plane and loops over all of K itself,
// which replaces the TPU's sequential k grid axis.  Per 64-deep K step the
// A and B tiles go global -> registers -> shared memory (the next step's
// loads are issued before this step's products), B transposed on the way
// so both operands are k-contiguous.  Eight warps, each a 64x32 sub-tile of
// m16n8k32 s8 `mma.sync` products with int32 accumulators in registers.
// The int32 sums are exact for k <= 2^17 (|sum| <= 127^2 2^17 < 2^31) in
// any order.  Epilogue: + carry, exact int32 symmetric mod by p_l, int8
// store, masked at the ragged edge.
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int MT = 4, NT = 4;  // warp tile 64 x 32 in m16 x n8 products

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_mod_gemm_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B,
    const int8_t* __restrict__ carry, int8_t* __restrict__ out, int m, int n,
    int k, ModParams prm) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int plane = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += static_cast<size_t>(plane) * m * k + static_cast<size_t>(m0) * k;
  B += static_cast<size_t>(plane) * k * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // staging assignment: A rows (tid >> 2) and +64, 16 bytes at (tid & 3) * 16;
  // B 4x4 blocks at n = 4 nb, k = 4 kb (two per thread)
  const int a_row = tid >> 2, a_col = (tid & 3) * 16;
  const int nb = (lane & 7) + 8 * (warp & 3);
  int kb[2];
  kb[0] = (lane >> 3) + 4 * (warp >> 2);
  kb[1] = kb[0] + 8;

  uint4 ra[2];
  uint32_t rb[2][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) ra[r] = load_a16<VEC>(A, m - m0, k, a_row + 64 * r, k0 + a_col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) rb[i][r] = load_b4<VEC>(B, k, n, k0 + 4 * kb[i] + r, n0 + 4 * nb);
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
    for (int r = 0; r < 2; ++r) *reinterpret_cast<uint4*>(As + (a_row + 64 * r) * LDS + a_col) = ra[r];
#pragma unroll
    for (int i = 0; i < 2; ++i) store_b_block(Bs, rb[i], 4 * nb, 4 * kb[i]);
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
    warp_tile_mma<MT, NT>(acc, As, Bs, wm, wn, lane);
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

}  // namespace

extern "C" int int8_mod_gemm_launch(const void* a, const void* b, const void* carry,
                                    void* out, int n_mod, int m, int n, int k,
                                    const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  const bool vec = k % 16 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 4 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  const auto* C = static_cast<const int8_t*>(carry);
  auto* O = static_cast<int8_t*>(out);
  if (vec) {
    int8_mod_gemm_kernel<true><<<grid, THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  } else {
    int8_mod_gemm_kernel<false><<<grid, THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  }
  return static_cast<int>(cudaGetLastError());
}
