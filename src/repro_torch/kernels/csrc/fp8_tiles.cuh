// e4m3 machinery of the fp8 residue-GEMM kernel fp8_mod_gemm.cu: the
// balanced base-16 digit split of int8 residues into e4m3 bytes while a
// tile is staged, and the three exact digit products of one m16n8k32 step.
// fp8_karatsuba.cu shares the f16x2 arithmetic and the e4m3 pair
// conversion, and splits by the same rule.
//
// Digits.  A residue r (|r| <= 127) is r = 16 hi + lo with hi = round(r/16),
// half to even, and lo = r - 16 hi: |hi|, |lo| <= 8, so each digit has at
// most 4 significant bits and is exact in e4m3 (the TPU kernel's `_digits`,
// src/repro/kernels/fp8_mod_gemm.py:76).  The split runs in f16x2, where
// every step is exact: the byte u = r + 128 becomes the half 1024 + u
// (exponent byte 0x64, ulp 1), minus 1152 gives r; r / 16 is exact; adding
// 1536 (ulp 1 there, 1536 even) rounds to the nearest integer, half to even;
// subtracting 1536 and forming r - 16 hi are exact.  `cvt...e4m3x2.f16x2`
// then packs two digits.  Both operands are split on k-contiguous words,
// the A rows as loaded and the B columns after their transpose, so the
// byte order within a word is the same for A and B and any fixed order of
// the packed pair leaves every dot product unchanged.
//
// Products and the accumulation hazard.  Hopper's fp8 tensor-core sum keeps
// only about 14 bits (DeepSeek-V3 report, arXiv:2412.19437, 3.3.2), so the
// C operand never carries a long K range.  Each m16n8k32 digit product
// starts from C = 0 and is at most 32 * 8 * 8 = 2^11; the cross term X
// chains its two products, ah.bl then al.bh on that C, to at most 2^12.
// The kernels add these exact integers into registers with ordinary adds.
#pragma once

#include "gemm_tiles.cuh"

// f16x2 arithmetic with an explicit rounding mode: never contracted.
__device__ __forceinline__ uint32_t hadd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two f16 integers (|v| <= 8, exact) as two e4m3 bytes.
__device__ __forceinline__ uint32_t e4m3x2(uint32_t h) {
  unsigned short d;
  asm("cvt.rn.satfinite.e4m3x2.f16x2 %0, %1;\n" : "=h"(d) : "r"(h));
  return d;
}

// The hi and lo e4m3 digit words of a word of four int8 residues.
__device__ __forceinline__ void split_digits(uint32_t w, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kMagic = 0x64646464u;  // exponent bytes of 1024 + u
  constexpr uint32_t k1152 = 0x64806480u, kSixteenth = 0x2C002C00u;
  constexpr uint32_t k1536 = 0x66006600u, k16 = 0x4C004C00u;
  const uint32_t u = w ^ 0x80808080u;  // r + 128 per byte
  uint32_t h[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t r = hsub2(__byte_perm(u, kMagic, i ? 0x7362 : 0x5140), k1152);
    const uint32_t d = hsub2(hadd2(hmul2(r, kSixteenth), k1536), k1536);
    h[i] = e4m3x2(d);
    l[i] = e4m3x2(hsub2(r, hmul2(d, k16)));
  }
  hi = h[0] | (h[1] << 16);
  lo = l[0] | (l[1] << 16);
}

// Stage 16 k-contiguous bytes of an A row as their hi and lo digits.
__device__ __forceinline__ void store_a_digits(int8_t* Ah, int8_t* Al, int off, uint4 v) {
  uint4 h, l;
  split_digits(v.x, h.x, l.x);
  split_digits(v.y, h.y, l.y);
  split_digits(v.z, h.z, l.z);
  split_digits(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(Ah + off) = h;
  *reinterpret_cast<uint4*>(Al + off) = l;
}

// Stage a 4(k) x 4(n) B block transposed (as `store_b_block`), as digits.
template <int BK>
__device__ __forceinline__ void store_b_digits(int8_t* Bh, int8_t* Bl, const uint32_t (&x)[4],
                                               int n, int kk) {
  uint32_t w[4];
  transpose4x4(x, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t h, l;
    split_digits(w[j], h, l);
    *reinterpret_cast<uint32_t*>(Bh + (n + j) * lds_for(BK) + kk) = h;
    *reinterpret_cast<uint32_t*>(Bl + (n + j) * lds_for(BK) + kk) = l;
  }
}

// d = a (16x32 e4m3, k contiguous) . b (32x8 e4m3, k contiguous) + c in f32.
__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// The three digit products of one m16n8k32 step, each an exact integer:
// hh = ah.bh, ll = al.bl (|.| <= 2^11) and x = ah.bl + al.bh (<= 2^12).
__device__ __forceinline__ void digit_products(float (&hh)[4], float (&x)[4], float (&ll)[4],
                                               const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                               const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_e4m3(hh, ah, bh[0], bh[1], zero);
  mma_e4m3(ll, al, bl[0], bl[1], zero);
  mma_e4m3(t, ah, bl[0], bl[1], zero);
  mma_e4m3(x, al, bh[0], bh[1], t);
}
