// e4m3 machinery of the fp8 residue-GEMM kernels fp8_mod_gemm.cu and
// fp8_karatsuba.cu: the balanced base-16 digit split of int8 residues into
// e4m3 bytes, in f16x2 arithmetic, and the wgmma e4m3 step the kernels sum
// the digit products with.
//
// Digits.  A residue r (|r| <= 127) is r = 16 hi + lo with hi = round(r/16),
// half to even, and lo = r - 16 hi: |hi|, |lo| <= 8, so each digit has at
// most 4 significant bits and is exact in e4m3 (the TPU kernel's `_digits`,
// src/repro/kernels/fp8_mod_gemm.py:76).  The split runs in f16x2, where
// every step is exact: the byte u = r + 128 becomes the half 1024 + u
// (exponent byte 0x64, ulp 1), minus 1152 gives r; r / 16 is exact and
// adding 1536 to it (one fma; ulp 1 there, 1536 even) rounds to the nearest
// integer, half to even; subtracting 1536 and forming r - 16 hi (one fma)
// are exact.  `cvt...e4m3x2.f16x2` then packs two digits.  Both operands
// are split on k-contiguous words, the A rows as loaded and the B columns
// after their transpose, so the byte order within a word is the same for A
// and B and any fixed order of the packed pair leaves every dot product
// unchanged.
//
// The accumulation hazard.  Hopper's fp8 tensor-core sum keeps only about
// 14 bits (DeepSeek-V3 report, arXiv:2412.19437, 3.3.2): a digit product is
// at most 8 * 8 = 64 and a k32 step at most 2^11, so the kernels sum the
// digit products on the tensor cores in chains of at most 2^12, each from
// zero, and add the chains' exact integers into f32 registers with FADDs.
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

__device__ __forceinline__ uint32_t hfma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two f16 integers (|v| <= 8, exact) as two e4m3 bytes.
__device__ __forceinline__ uint32_t e4m3x2(uint32_t h) {
  unsigned short d;
  asm("cvt.rn.satfinite.e4m3x2.f16x2 %0, %1;\n" : "=h"(d) : "r"(h));
  return d;
}

// The hi and lo e4m3 digit pairs of two f16 integers |r| <= 255: hi =
// round(r / 16), half to even (r / 16 exact; + 1536 rounds to the integer,
// 1536 even; - 1536 exact), lo = r - 16 hi (exact).
__device__ __forceinline__ void digits2(uint32_t r, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kSixteenth = 0x2C002C00u, k1536 = 0x66006600u, kNeg16 = 0xCC00CC00u;
  const uint32_t d = hsub2(hfma2(r, kSixteenth, k1536), k1536);
  hi = e4m3x2(d);
  lo = e4m3x2(hfma2(d, kNeg16, r));
}

// The hi and lo e4m3 digit words of a word of four int8 residues.
__device__ __forceinline__ void split_digits(uint32_t w, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kMagic = 0x64646464u;  // exponent bytes of 1024 + u
  constexpr uint32_t k1152 = 0x64806480u;
  const uint32_t u = w ^ 0x80808080u;  // r + 128 per byte
  uint32_t h[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) digits2(hsub2(__byte_perm(u, kMagic, i ? 0x7362 : 0x5140), k1152), h[i], l[i]);
  hi = h[0] | (h[1] << 16);
  lo = l[0] | (l[1] << 16);
}

// D = A B (scale_d = 0) or D += A B (1) on one m64n64k32 e4m3 step: A and B
// from shared memory, both K-major (8-bit types take no transpose).
__device__ __forceinline__ void wgmma_e4m3(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
