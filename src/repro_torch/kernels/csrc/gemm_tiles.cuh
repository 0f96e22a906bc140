// Tile machinery of the mma.sync residue-GEMM kernels (the two megakernels,
// fused_mod_gemm.cu and fused_karatsuba.cu): the block tile shape, the
// 8-bit fragment loads, and the tensor-core product of an int8 warp tile by
// mma.sync.  The wgmma kernels (int8_mod_gemm.cu, karatsuba_fused.cu, and
// through fp8_tiles.cuh the two e4m3 kernels) take its 4 x 4 byte
// transpose, fused_karatsuba.cu its per-byte sum mod p.
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
// Layout.  The s8 `mma.sync.m16n8k32.row.col` wants both operands with k
// contiguous: a staged A tile is [BM rows][BK bytes] and a B tile [BN
// rows][BK bytes].  Rows are padded to BK + 16 bytes: 16-byte aligned for
// ldmatrix, and the eight rows of one 8x8 ldmatrix block fall in eight
// different bank groups (for BK = 64 and 128 alike).
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
  static constexpr int WN_LOG2 = ilog2(WARPS_N);  // a shift for the division by WARPS_N
  static_assert(8 % WARPS_N == 0 && WTM % 16 == 0 && WTN % 16 == 0, "warp tile of m16 x n16 steps");
  static_assert(BK % 32 == 0 && (1 << WN_LOG2) == WARPS_N, "k32 steps; a power of two");
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
