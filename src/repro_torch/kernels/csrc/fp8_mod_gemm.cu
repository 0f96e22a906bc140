// Modulus-batched residue GEMM on the e4m3 engine:
// out[l] = sym_mod(A[l] @ B[l] (+ carry[l]), p_l) for every plane l, each
// residue product formed from balanced base-16 digits (fp8_tiles.cuh).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/fp8_mod_gemm.py:85
// (`fp8_mod_gemm_batched`, :336).
//
// Bound on the H100: e4m3 tensor-core operations, four digit products of
// 2 m n k each per plane (HH, LL and the doubled-K X), 8 N m n k in all, at
// 1,979 TFLOP/s dense (4096^3 at N = 8: 2.22 ms, 4x the int8 kernel's
// bound); the N (m k + k n + m n) bytes are far below that line.
//
// Design, simple first: the skeleton of int8_mod_gemm.cu.  Grid
// (ceil(n/BN), ceil(m/BM), N); each block owns one BM x BN output tile of
// one plane and loops over all of K.  Per BK-deep K step the int8 A and B
// tiles go global -> registers -> shared memory, each residue split into
// its hi and lo e4m3 digits on the way (B transposed first), so the staged
// bytes double: Ah, Al, Bh, Bl, 30 KB at the default tile (128, 64, 64).
// Eight warps, there each a 32x32 sub-tile; per m16n8k32 step four e4m3
// `mma.sync` products (HH, LL, and the two halves of X), each from a zero
// or bounded C, added into three f32 register sums HH, X, LL (96 registers
// a thread).  The two k32 sub-steps of a K step are not unrolled:
// unrolled, ptxas keeps both sub-steps' fragments and the products'
// temporaries live and spills at the cap of 255 registers.  The other
// tile, (64, 64, 64) with a 16 x 32 warp tile, halves the register sums
// (`kernels/common.COMPILED_TILES`).
//
// The accumulation hazard.  The tensor core's fp8 sum keeps about 14 bits,
// so it never holds more than one step: every product it returns is an
// exact integer of at most 2^11 (HH, LL) or 2^12 (X), see fp8_tiles.cuh.
// The register sums are plain f32 adds of integers (-fmad=false): at
// k = 2^16 they reach at most 64 k = 2^22 (HH, LL) and 128 k = 2^23 (X),
// below 2^24, so they are exact in any order.
//
// Epilogue, the reference's (fp8_mod_gemm.py:118-132): each digit sum to
// int32 and its canonical residue mod p_l, m8 eh + m4 ex + el with
// m4 = 16 mod p_l and m8 = m4^2 mod p_l, + carry, the final symmetric mod,
// int8 store, masked at the ragged edge.  The canonical residue is unique,
// so the bits are int8_mod_gemm.cu's.  Ragged m/n/k are masked at load
// (zeros split into zero digits, which add nothing).
#include "fp8_tiles.cuh"

namespace {

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS) fp8_mod_gemm_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B,
    const int8_t* __restrict__ carry, int8_t* __restrict__ out, int m, int n,
    int k, ModParams prm) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  __shared__ __align__(16) int8_t Ah[BM * LDS];
  __shared__ __align__(16) int8_t Al[BM * LDS];
  __shared__ __align__(16) int8_t Bh[BN * LDS];
  __shared__ __align__(16) int8_t Bl[BN * LDS];
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

  float hh[MT][NT][4], xx[MT][NT][4], ll[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) hh[mt][nt][c] = xx[mt][nt][c] = ll[mt][nt][c] = 0.f;

  load(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int r = 0; r < T::A_ITERS; ++r) {
      const int row = a_row + r * T::A_ROWS;
      if (T::A_EXACT || row < BM) store_a_digits(Ah, Al, row * LDS + a_col, ra[r]);
    }
#pragma unroll
    for (int i = 0; i < T::B_WARP_ITERS; ++i) {
      const int kbi = kb + i * T::KB_STEP;
      if (T::B_WARP_EXACT || kbi < BK / 4) store_b_digits<BK>(Bh, Bl, rb[i], 4 * nb, 4 * kbi);
    }
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll 1  // one k32 sub-step's fragments live at a time
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
      load_a_frags<MT, BK>(ah, Ah, wm, ks, lane);
      load_a_frags<MT, BK>(al, Al, wm, ks, lane);
      load_b_frags<NT, BK>(bh, Bh, wn, ks, lane);
      load_b_frags<NT, BK>(bl, Bl, wn, ks, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float h[4], x[4], l[4];
          digit_products(h, x, l, ah[mt], al[mt], bh[nt], bl[nt]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            hh[mt][nt][c] += h[c];
            xx[mt][nt][c] += x[c];
            ll[mt][nt][c] += l[c];
          }
        }
      }
    }
    __syncthreads();
  }

  const int p = prm.p[plane];
  const int m4 = sym_mod_i32(16, p), m8 = sym_mod_i32(m4 * m4, p);
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
          // the f32 sums are exact integers below 2^24: the conversion is exact
          const int eh = sym_mod_i32(static_cast<int>(hh[mt][nt][c]), p);
          const int ex = sym_mod_i32(static_cast<int>(xx[mt][nt][c]), p);
          const int el = sym_mod_i32(static_cast<int>(ll[mt][nt][c]), p);
          int v = m8 * eh + m4 * ex + el;  // |v| <= 2 * 127^2 + 127
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
    fp8_mod_gemm_kernel<T, true><<<grid, T::THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  } else {
    fp8_mod_gemm_kernel<T, false><<<grid, T::THREADS, 0, s>>>(A, B, C, O, m, n, k, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fp8_mod_gemm_launch(const void* a, const void* b, const void* carry,
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
  REPRO_TILE(128, 64, 64, 2)
  REPRO_TILE(64, 64, 64, 2)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
