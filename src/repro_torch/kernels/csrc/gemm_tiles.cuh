// Tile machinery of the mma.sync residue-GEMM kernels (int8_mod_gemm.cu and
// the two megakernels): the block tile shape, global -> register -> shared
// staging of int8 tiles, the 8-bit fragment loads, and the tensor-core
// product of an int8 warp tile by mma.sync.  The wgmma kernels
// (karatsuba_fused.cu, and through fp8_tiles.cuh the two e4m3 kernels) take
// its 4 x 4 byte transpose.
//
// The block tile.  Each of those kernels is a template on `Tile<BM, BN, BK,
// WARPS_N>`: a block of 256 threads (eight warps, WARPS_M x WARPS_N) owns a
// BM x BN output tile and steps over K in BK-deep slices; each warp owns a
// (BM / WARPS_M) x (BN / WARPS_N) sub-tile of MT x NT m16n8 products.  A
// source compiles a short list of tiles, its first the default, and its C
// entry point launches the one the caller names (the Python wrappers' `tile`
// argument, `kernels/common.COMPILED_TILES`).  Int32 sums are exact in any
// order and every residue is the unique canonical one, so the tile changes
// which threads add which products, never the bits.
//
// Layout.  A planes are (m, k) row-major, B planes (k, n) row-major.  The
// s8 `mma.sync.m16n8k32.row.col` wants both operands with k contiguous, so
// an A tile is stored as it is, [BM rows][BK bytes], and a B tile is
// transposed while it is staged, [BN rows][BK bytes], by a 4x4 byte
// transpose in registers (__byte_perm).  Rows are padded to BK + 16 bytes:
// 16-byte aligned for ldmatrix, and the eight rows of one 8x8 ldmatrix
// block fall in eight different bank groups (for BK = 64 and 128 alike).
//
// Ragged edges.  Loads outside the (rows, k) or (k, cols) extent read as
// zero, which is residue-exact: a zero contributes nothing to any dot
// product.  The vector path (16-byte A loads, 4-byte B loads) needs k % 16
// == 0 and n % 4 == 0; other shapes take the byte path.
#pragma once

#include "common.cuh"

// Padded row stride, in bytes, of a staged tile BK bytes deep.
__host__ __device__ constexpr int lds_for(int bk) { return bk + 16; }

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

template <int BM_, int BN_, int BK_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int THREADS = 256, WARPS_N = WARPS_N_, WARPS_M = 8 / WARPS_N_;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;             // m16 x n8 products
  static constexpr int LDS = lds_for(BK);
  // A staging: thread t stages the 16-byte row segment at row
  // t / A_CPR + r A_ROWS, byte 16 (t % A_CPR), in rounds r < A_ITERS
  static constexpr int A_CPR = BK / 16, A_ROWS = THREADS / A_CPR;
  static constexpr int A_ITERS = (BM + A_ROWS - 1) / A_ROWS;
  // B staging of the megakernels: thread t stages the 4(k) x 4(n) block
  // at n block t % NB, k block t / NB + i B_KBS, in rounds i < B_ITERS
  static constexpr int NB = BN / 4, B_KBS = THREADS / NB;
  static constexpr int B_ITERS = (BK / 4 + B_KBS - 1) / B_KBS;
  // B staging of the int8 kernels, by warp: lane l of warp w stages the
  // block at n block l % 8 + 8 (w % NB_GROUPS), k block l / 8 +
  // 4 (w / NB_GROUPS) + i KB_STEP, in rounds i < B_WARP_ITERS: 8
  // consecutive n blocks x 4 k blocks a warp, so its transposed stores
  // spread over the banks
  static constexpr int NB_GROUPS = BN / 32, KB_STEP = 32 / NB_GROUPS;
  static constexpr int B_WARP_ITERS = (BK / 4 + KB_STEP - 1) / KB_STEP;
  // whether the rounds cover the tile exactly, so no bounds test is needed
  // (every compiled tile but fused_karatsuba's 64x32x64 for B)
  static constexpr bool A_EXACT = BM % A_ROWS == 0;
  static constexpr bool B_EXACT = (BK / 4) % B_KBS == 0;
  static constexpr bool B_WARP_EXACT = (BK / 4) % KB_STEP == 0;
  // shifts for the divisions by these powers of two (as the fixed-tile
  // kernels wrote them: a signed division costs extra instructions)
  static constexpr int A_CPR_LOG2 = ilog2(A_CPR), NB_LOG2 = ilog2(NB);
  static constexpr int NBG_LOG2 = ilog2(NB_GROUPS), WN_LOG2 = ilog2(WARPS_N);
  static_assert(8 % WARPS_N == 0 && WTM % 16 == 0 && WTN % 16 == 0, "warp tile of m16 x n16 steps");
  static_assert(BK % 32 == 0 && BN % 32 == 0 && 8 % NB_GROUPS == 0, "staging layout");
  static_assert((1 << A_CPR_LOG2) == A_CPR && (1 << NB_LOG2) == NB && (1 << NBG_LOG2) == NB_GROUPS,
                "powers of two");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc += a (16x32, k contiguous) . b (32x8, k contiguous), exact in int32.
__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of an A row segment: row `r`, columns [c, c + 16).
template <bool VEC>
__device__ __forceinline__ uint4 load_a16(const int8_t* A, int rows, int k, int r, int c) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= rows) return v;
  const int8_t* src = A + static_cast<size_t>(r) * k + c;
  if (VEC) {
    if (c < k) v = *reinterpret_cast<const uint4*>(src);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (c + b < k) w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// 4 bytes of a B row: row `r` (a k index), columns [c, c + 4).
template <bool VEC>
__device__ __forceinline__ uint32_t load_b4(const int8_t* B, int k, int cols, int r, int c) {
  if (r >= k) return 0;
  const int8_t* src = B + static_cast<size_t>(r) * cols + c;
  if (VEC) return c < cols ? *reinterpret_cast<const uint32_t*>(src) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c + b < cols) w |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
  }
  return w;
}

// Transpose a 4x4 byte block: x[r] holds row r (4 columns); returns in
// w[j] the column j (4 rows), low byte first.
__device__ __forceinline__ void transpose4x4(const uint32_t (&x)[4], uint32_t (&w)[4]) {
  const uint32_t t01lo = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t01hi = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t23lo = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t23hi = __byte_perm(x[2], x[3], 0x7362);
  w[0] = __byte_perm(t01lo, t23lo, 0x5410);
  w[1] = __byte_perm(t01lo, t23lo, 0x7632);
  w[2] = __byte_perm(t01hi, t23hi, 0x5410);
  w[3] = __byte_perm(t01hi, t23hi, 0x7632);
}

// Store a staged 4(k) x 4(n) B block transposed: column j of the block goes
// to row (n + j) of the [BN][lds_for(BK)] tile, at byte offset kk.
template <int BK>
__device__ __forceinline__ void store_b_block(int8_t* Bs, const uint32_t (&x)[4], int n, int kk) {
  uint32_t w[4];
  transpose4x4(x, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(Bs + (n + j) * lds_for(BK) + kk) = w[j];
  }
}

// Per-byte symmetric mod of the sum of two packed int8 residue words.
__device__ __forceinline__ uint32_t sum_mod4(uint32_t x, uint32_t y, int p, int half) {
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = static_cast<int>(static_cast<int8_t>(x >> (8 * b))) +
                  static_cast<int>(static_cast<int8_t>(y >> (8 * b)));
    out |= static_cast<uint32_t>(static_cast<uint8_t>(sym_mod_small(v, p, half))) << (8 * b);
  }
  return out;
}

__device__ __forceinline__ uint4 sum_mod16(uint4 x, uint4 y, int p, int half) {
  return make_uint4(sum_mod4(x.x, y.x, p, half), sum_mod4(x.y, y.y, p, half),
                    sum_mod4(x.z, y.z, p, half), sum_mod4(x.w, y.w, p, half));
}

// The m16n8k32 A fragments of rows [wm, wm + 16 MT) at depth ks of a
// [rows][lds_for(BK)] tile (the 8-bit fragment layout, int8 and e4m3 alike).
template <int MT, int BK>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[MT][4], const int8_t* As, int wm,
                                             int ks, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    ldmatrix_x4(af[mt], As + (wm + mt * 16 + (lane & 15)) * lds_for(BK) + ks + (lane >> 4) * 16);
  }
}

// The B fragments of columns [wn, wn + 8 NT) at depth ks of a
// [cols][lds_for(BK)] tile.
template <int NT, int BK>
__device__ __forceinline__ void load_b_frags(uint32_t (&bf)[NT][2], const int8_t* Bs, int wn,
                                             int ks, int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t r[4];
    const int q = lane >> 3;
    ldmatrix_x4(r, Bs + (wn + (2 * np + (q >> 1)) * 8 + (lane & 7)) * lds_for(BK) + ks +
                       (q & 1) * 16);
    bf[2 * np][0] = r[0];
    bf[2 * np][1] = r[1];
    bf[2 * np + 1][0] = r[2];
    bf[2 * np + 1][1] = r[3];
  }
}

// One warp's product over one staged BK slice: acc[MT][NT] += A rows
// [wm, wm + 16 MT) . B cols [wn, wn + 8 NT), from [rows][lds_for(BK)] tiles.
template <int MT, int NT, int BK>
__device__ __forceinline__ void warp_tile_mma(int (&acc)[MT][NT][4], const int8_t* As,
                                              const int8_t* Bs, int wm, int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t af[MT][4];
    load_a_frags<MT, BK>(af, As, wm, ks, lane);
    uint32_t bf[NT][2];
    load_b_frags<NT, BK>(bf, Bs, wn, ks, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}
