// Modulus-batched Karatsuba residue GEMM on the e4m3 engine: for every
// plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p)
//   CR = sym_mod(m(D) - m(E) (+ carry_R)), CI = sym_mod(m(F) - m(D) - m(E) (+ carry_I))
// with m() the symmetric mod by p_l, each residue product formed from
// balanced base-16 digits (fp8_tiles.cuh): r_a r_b = 256 HH + 16 X + LL.
//
// Replaces the Pallas kernel `_karatsuba_kernel` of
// src/repro/kernels/fp8_mod_gemm.py:171 (`fp8_karatsuba_mod_gemm_batched`, :271).
//
// Bound on the H100: e4m3 tensor-core operations, 3 products x 4 digit
// products x 2 m n k per plane, 24 N m n k in all, at 1,979 TFLOP/s dense
// (4096^3 at N = 14: 11.67 ms).  Beside them the digit split (some 20
// CUDA-core instructions a 4-byte word of an operand) and the fold of the
// digit sums (an FADD per element a chain) compete for issue slots, and the
// operand tiles for shared-memory bandwidth.  As measured (PERF.md section
// 6) the split warpgroup and the product warpgroups take about as long a
// slice as each other, far above the bound: the split runs one warp a
// scheduler, the products one chain a warpgroup at a time.
//
// Design.  A block owns a 64 x 64 output tile of one plane (grid: n tiles,
// m tiles, planes) and walks K in BK-deep slices; 512 threads in four
// warpgroups.
//  * Warpgroups 1-3 own one Karatsuba product each (D, E, F).  Each runs
//    its digit products on wgmma.m64n64k32.f32.e4m3.e4m3, A and B from
//    shared memory (K-major, the 64- or 128-byte swizzle), and folds each
//    chain into three f32 digit accumulators HH, X and LL with an FADD:
//    the TPU kernel's nine accumulators (fp8_mod_gemm.py:177-211), three a
//    warpgroup, 96 registers a thread.  No conversion in the K loop.
//  * Warpgroup 0 splits.  Its first thread brings the block's raw int8 AR,
//    AI, BR and BI shares of the coming slices by TMA into a ring of raw
//    stages (an mbarrier with transaction bytes each); all its threads form
//    the sums (AR+AI) mod p and (BR+BI) mod p per byte, split the six
//    operands into hi and lo e4m3 digits in f16x2, transpose B on the way
//    (TMA cannot transpose bytes; B arrives (k, n) n-major, wgmma wants it
//    K-major) and write the digits into a ring of ST digit stages in the
//    swizzled layout the wgmma descriptors name.
//  * The split is shared by a CM x CN thread-block cluster, as
//    fused_karatsuba.cu shares its cast: the CN blocks of a cluster row
//    multiply the same A rows, the CM blocks of a cluster column the same B
//    columns, so block (cx, cy) splits A rows [64 cx / CN, 64 (cx + 1) / CN)
//    and B columns [64 cy / CM, 64 (cy + 1) / CM) of each slice into its own
//    stage, then its first thread copies that share into the same stage of
//    the peers that read it with cp.async.bulk (shared::cta to
//    shared::cluster), each copy completing the peer's "stage full"
//    mbarrier by its bytes.  The product warps release a stage by arriving
//    on the "stage empty" mbarrier of every block that writes into it; a
//    block waits on its own before it splits into the stage again.  The
//    grid is padded to whole clusters; a padding block splits its share and
//    stores no output.  On the H100 at 4096^3, N = 14, CM = 2 blocks along
//    m sharing the split of B (the costlier operand: it is transposed) ran
//    faster than no cluster (PERF.md section 6) and, in development runs,
//    than 2 x 2 and 2 x 4: what a block saves in splitting, the copies and
//    the coupling of the blocks cost again.
//  * Shapes TMA cannot map (k or n not a multiple of 16, or an operand
//    not 16-byte aligned) take the second instantiation, in which the
//    split threads load their shares from global memory themselves (4-byte
//    words where k, n and the pointers allow it, else bytes).  Which one a
//    launch takes depends on shape and alignment alone (hopper.cuh's
//    `uses_tma`); everything after the load is the same.
//
// The accumulation rule.  Hopper's fp8 tensor-core sum keeps only about 14
// bits (arXiv:2412.19437, 3.3.2), so no wgmma chain may sum past 2^12.  A
// digit product is at most 8 * 8 = 64, a k32 step at most 32 * 64 = 2^11:
// the HH and LL chains run over HH_CHAIN_K32 = LL_CHAIN_K32 = 2 k32 steps
// (at most 2^12) and each X chain over X_CHAIN_K32 = 1 step, ah.bl then
// al.bh (at most 2^12).  Every chain starts from zero (scale-d = 0).  The
// f32 accumulators stay exact integers to k = FP8_K_CHUNK_LIMIT = 2^16:
// |HH|, |LL| <= 64 k = 2^22 and |X| <= 128 k = 2^23, below 2^24.
// tests/test_torch_fp8_schedule.py models this schedule in exact integers,
// reading the chain constants from this file.
//
// Epilogue (fp8_mod_gemm.py:213-233): each product warpgroup takes the
// exact symmetric mod of its three accumulators and forms m8 m(HH) + m4
// m(X) + m(LL) mod p; D and E pass theirs to F through shared memory, and
// F writes CR = D - E and CI = F - D - E (+ carry) mod p, masked at the
// ragged edge.  Every residue is the canonical one, so the output is
// bitwise fp8_karatsuba_mod_gemm_plain's and the int8 kernel's.
#include "fp8_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int CM = 2, CN = 1;  // the cluster: CM blocks along m, CN along n
constexpr int BM = 64, BN = 64;  // the block's output tile (one wgmma m64n64 a product)
constexpr int THREADS = 512;   // the split warpgroup, then the D, E and F warpgroups
constexpr int SPLIT_REGS = 56, PRODUCT_REGS = 152;  // 128 x 56 + 384 x 152 = 65,536
// k32 steps a wgmma chain sums over (see the accumulation rule above)
constexpr int HH_CHAIN_K32 = 2;
constexpr int LL_CHAIN_K32 = 2;
constexpr int X_CHAIN_K32 = 1;

constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use

// The shared memory of tile BK with a ring of ST digit stages and, where
// they fit beside it, as many raw stages (else one).
template <int BK, int ST>
struct Layout {
  static constexpr int K32 = BK / 32;
  static constexpr int LAYOUT = BK == 128 ? 1 : 2;  // the descriptors' swizzle mode: 128 or 64 bytes
  static constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // one digit of one operand, [rows][BK]
  static constexpr int STAGE = 6 * (A_TILE + B_TILE);       // [AR, AI, AS] x [hi, lo] of A, then of B
  static constexpr int A_ROWS = BM / CN, B_COLS = BN / CM;  // the block's share of a slice
  static constexpr int RAW_A = A_ROWS * BK, RAW_B = BK * B_COLS;  // [A_ROWS][BK], [BK][B_COLS] bytes
  static constexpr int RAW_STAGE = 2 * (RAW_A + RAW_B);     // AR, AI, BR, BI
  static constexpr int RST =
      1024 + ST * (STAGE + RAW_STAGE + 3 * 8) + 2 * BM * BN <= SMEM_MAX ? ST : 1;  // raw stages
  static constexpr int A_ITERS = A_ROWS * BK / (8 * 128);   // rounds of 8 A bytes a split thread
  static constexpr int B_ITERS = (B_COLS / 4) * (BK / 4) / 128;  // rounds of a 4 x 4 B block
  static constexpr int RAW_OFF = ST * STAGE;
  static constexpr int XCHG_OFF = RAW_OFF + RST * RAW_STAGE;  // D and E residues for the epilogue
  static constexpr int BAR_OFF = XCHG_OFF + 2 * BM * BN;     // RST + 2 ST mbarriers
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (RST + 2 * ST);  // 1024: alignment of the swizzle atoms
  // the digit bytes a block receives from its peers a slice
  static constexpr int INCOMING = 6 * ((CN - 1) * A_ROWS * BK + (CM - 1) * B_COLS * BK);
  static_assert(BK == 64 || BK == 128, "one swizzle row a slice");
  static_assert(A_ITERS * 8 * 128 == A_ROWS * BK && B_ITERS * 128 * 16 == B_COLS * BK && B_ITERS > 0,
                "the split threads cover the shares in whole rounds");
  static_assert(K32 % HH_CHAIN_K32 == 0 && K32 % LL_CHAIN_K32 == 0 && K32 % X_CHAIN_K32 == 0, "chains");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

struct Operands {
  const int8_t *ar, *ai, *br, *bi;
  const int8_t *carry_r, *carry_i;  // null without a carry
  int8_t *out_r, *out_i;
  int a_vec, b_vec;                 // the global loads may take 4-byte words (A rows, B rows)
};

// ---- the digit split, in f16x2 (every step exact; fp8_tiles.cuh) -------------

// 1.0 where a > b (a < b), else 0.0, per half
__device__ __forceinline__ uint32_t hgt2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.gt.f16x2.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t hlt2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.lt.f16x2.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// An integer |v| <= 255 as an f16, in both halves.
__device__ __forceinline__ uint32_t half2_of(int v) {
  unsigned short h;
  asm("cvt.rn.f16.f32 %0, %1;\n" : "=h"(h) : "f"(static_cast<float>(v)));
  return static_cast<uint32_t>(h) * 0x10001u;
}

// The plane's modulus as f16x2 constants.
struct HalfMod {
  uint32_t p, neg_p, half, neg_half;
};

// Split a word of four real residues x and the matching imaginary ones y
// (k-contiguous) into out[2 g + d]: operand g (0: x, 1: y, 2: the sum (x + y)
// mod p per byte) and digit d (0: hi, 1: lo).  One f16 conversion of each
// byte serves its digits and the sum (fp8_tiles.cuh's split_digits converts
// one word for its digits alone).  The sum's symmetric mod is
// sym_mod_small's (common.cuh): two corrections each way.
__device__ __forceinline__ void split_pair(uint32_t x, uint32_t y, const HalfMod& hm, uint32_t (&out)[6]) {
  constexpr uint32_t kMagic = 0x64646464u;  // exponent bytes of 1024 + u
  constexpr uint32_t k1152 = 0x64806480u;
  const uint32_t ux = x ^ 0x80808080u, uy = y ^ 0x80808080u;  // r + 128 per byte
  uint32_t h[6][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t sel = i ? 0x7362 : 0x5140;
    const uint32_t rx = hsub2(__byte_perm(ux, kMagic, sel), k1152);
    const uint32_t ry = hsub2(__byte_perm(uy, kMagic, sel), k1152);
    uint32_t s = hadd2(rx, ry);  // exact: |s| <= 254
    s = hfma2(hgt2(s, hm.half), hm.neg_p, s);
    s = hfma2(hgt2(s, hm.half), hm.neg_p, s);
    s = hfma2(hlt2(s, hm.neg_half), hm.p, s);
    s = hfma2(hlt2(s, hm.neg_half), hm.p, s);
    digits2(rx, h[0][i], h[1][i]);
    digits2(ry, h[2][i], h[3][i]);
    digits2(s, h[4][i], h[5][i]);
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) out[q] = h[q][0] | (h[q][1] << 16);
}

// the split warpgroup's own barrier (named barrier 2)
__device__ __forceinline__ void split_barrier() { asm volatile("bar.sync 2, 128;" ::: "memory"); }

template <int BK, int ST, bool TMA>
__global__ void __launch_bounds__(THREADS, 1) fp8_karatsuba_kernel(
    const __grid_constant__ CUtensorMap tm_ar, const __grid_constant__ CUtensorMap tm_ai,
    const __grid_constant__ CUtensorMap tm_br, const __grid_constant__ CUtensorMap tm_bi,
    const Operands op, int m, int n, int k, const __grid_constant__ ModParams prm) {
  using L = Layout<BK, ST>;
  extern __shared__ uint4 smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  int8_t* const gbase = reinterpret_cast<int8_t*>(smem_raw) + (base - smem_addr(smem_raw));
  const uint32_t raw0 = base + L::RAW_OFF, bar0 = base + L::BAR_OFF;
  // the rings' barriers, by stage: raw slot filled by TMA, digit stage
  // written (this block's share, and the peers' by bulk copy), digit stage
  // read (by every block it is copied into)
  const auto raw_full = [&](int r) { return bar0 + 8 * r; };
  const auto dig_full = [&](int s) { return bar0 + 8 * (L::RST + s); };
  const auto dig_empty = [&](int s) { return bar0 + 8 * (L::RST + ST + s); };
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, plane = blockIdx.z;
  const int p = prm.p[plane];
  const int S = k > BK ? (k + BK - 1) / BK : 1;  // K slices
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int r = 0; r < L::RST; ++r) mbar_init(raw_full(r), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(dig_full(s), 1);                       // the split's first thread, with the bytes the peers send
      mbar_init(dig_empty(s), 4 * 3 * (CN + CM - 1));  // each product warp of each reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster has started: its barriers may be reached
  cluster_wait();

  if (wg == 0) {
    // ------------------------------------------------------------ the split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(SPLIT_REGS));
    const int tid = threadIdx.x;
    HalfMod hm;
    hm.p = half2_of(p);
    hm.neg_p = hm.p ^ 0x80008000u;
    hm.half = half2_of((p - 1) >> 1);
    hm.neg_half = hm.half ^ 0x80008000u;
    // the digits of this block's share go to the blocks of its cluster row (A)
    // and column (B), this one included
    uint32_t a_peer[CN], b_peer[CM];
#pragma unroll
    for (int x = 0; x < CN; ++x) a_peer[x] = cluster_map(base, x + cy * CN);
#pragma unroll
    for (int y = 0; y < CM; ++y) b_peer[y] = cluster_map(base, cx + y * CN);
    const int a_row0 = cx * L::A_ROWS, b_col0 = cy * L::B_COLS;  // the share in the block's tile
    const size_t a_plane = static_cast<size_t>(plane) * m * k, b_plane = static_cast<size_t>(plane) * k * n;

    // split slice j into digit stage j % ST of every block that reads it
    const auto split = [&](int j) {
      const uint32_t stage = (j % ST) * L::STAGE;
      const uint32_t slot = raw0 + (j % L::RST) * L::RAW_STAGE;
      const int k0 = j * BK;
      if (TMA) mbar_wait(raw_full(j % L::RST), (j / L::RST) & 1);
      // A: 8 bytes (two words) of a row of the share a round, one 8-byte
      // store a digit tile (not unrolled: the split has few registers)
#pragma unroll 1
      for (int i = 0; i < L::A_ITERS; ++i) {
        const int e = 8 * (tid + 128 * i), ra = e / BK, ca = e % BK;
        uint32_t xr[2], xi[2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (TMA) {
            xr[w] = ld_shared(slot + e + 4 * w);
            xi[w] = ld_shared(slot + L::RAW_A + e + 4 * w);
          } else {
            const int gm = m0 + a_row0 + ra, kk = k0 + ca + 4 * w;
            const int valid = gm < m ? k - kk : 0;
            const size_t off = a_plane + static_cast<size_t>(gm) * k + kk;
            xr[w] = load_word(op.ar + off, valid, op.a_vec);
            xi[w] = load_word(op.ai + off, valid, op.a_vec);
          }
        }
        uint32_t o0[6], o1[6];
        split_pair(xr[0], xi[0], hm, o0);
        split_pair(xr[1], xi[1], hm, o1);
        const uint32_t dst = base + stage + swizzled<BK>(a_row0 + ra, ca);
#pragma unroll
        for (int q = 0; q < 6; ++q) st_shared(dst + q * L::A_TILE, o0[q], o1[q]);
      }
      // B: a 4(k) x 4(n) block a round, transposed to 4 k-contiguous columns
#pragma unroll 1
      for (int i = 0; i < L::B_ITERS; ++i) {
        const int b = tid + 128 * i, nb = b % (L::B_COLS / 4), kb = b / (L::B_COLS / 4);
        uint32_t rr[4], ri[4];
        if (TMA) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            rr[r] = ld_shared(slot + 2 * L::RAW_A + (4 * kb + r) * L::B_COLS + 4 * nb);
            ri[r] = ld_shared(slot + 2 * L::RAW_A + L::RAW_B + (4 * kb + r) * L::B_COLS + 4 * nb);
          }
        } else {
          const int gn = n0 + b_col0 + 4 * nb;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int kk = k0 + 4 * kb + r;
            const int valid = kk < k ? n - gn : 0;
            const size_t off = b_plane + static_cast<size_t>(kk) * n + gn;
            rr[r] = load_word(op.br + off, valid, op.b_vec);
            ri[r] = load_word(op.bi + off, valid, op.b_vec);
          }
        }
        uint32_t wr[4], wi[4];  // column j4 of the block: 4 consecutive k
        transpose4x4(rr, wr);
        transpose4x4(ri, wi);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          uint32_t o[6];
          split_pair(wr[j4], wi[j4], hm, o);
          const uint32_t dst = base + stage + 6 * L::A_TILE + swizzled<BK>(b_col0 + 4 * nb + j4, 4 * kb);
#pragma unroll
          for (int q = 0; q < 6; ++q) st_shared(dst + q * L::B_TILE, o[q]);
        }
      }
      fence_proxy_async_shared();  // the digits are read by bulk copies and wgmma
    };

    int next = 0;  // the next slice to bring by TMA
    for (int j = 0; j < S; ++j) {
      const int s = j % ST;
      const uint32_t stage = s * L::STAGE;
      if (TMA && tid == 0) {
        // keep slices j .. j + RST - 1 in flight: the slot of slice j - 1 was
        // read by every split thread before the barrier that ended it
        for (; next < S && next < j + L::RST; ++next) {
          const int r = next % L::RST;
          const uint32_t slot = raw0 + r * L::RAW_STAGE;
          mbar_expect_tx(raw_full(r), L::RAW_STAGE);
          tma_load(slot, tm_ar, raw_full(r), next * BK, m0 + a_row0, plane);
          tma_load(slot + L::RAW_A, tm_ai, raw_full(r), next * BK, m0 + a_row0, plane);
          tma_load(slot + 2 * L::RAW_A, tm_br, raw_full(r), n0 + b_col0, next * BK, plane);
          tma_load(slot + 2 * L::RAW_A + L::RAW_B, tm_bi, raw_full(r), n0 + b_col0, next * BK, plane);
        }
      }
      // Every split thread waits itself until every block that reads stage s
      // is done with slice j - ST (a fresh barrier passes the wait on parity
      // 1), so each thread's own wait orders its writes into the stage.  A
      // named barrier after thread 0's wait alone would not: bar.sync counts
      // whole warps, and after a branch that only thread 0 takes it can let
      // lanes 1-31 of warp 0 through while thread 0 still waits (a
      // write-after-read race on the stage with the peers' product warps).
      mbar_wait_cluster(dig_empty(s), ((j / ST) & 1) ^ 1);
      split(j);  // this block's share, into its own stage s
      __syncwarp();  // converge each warp (its lanes leave the waits one by one) before the named barrier
      split_barrier();
      if (tid == 0) {
        // this block's share is written; the peers' shares of the slice are
        // expected; then the share goes to the peers that read it
        mbar_expect_tx(dig_full(s), L::INCOMING);
#pragma unroll
        for (int x = 0; x < CN; ++x) {
          if (x == cx) continue;
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const uint32_t off = stage + q * L::A_TILE + a_row0 * BK;
            bulk_copy_cluster(a_peer[x] + off, base + off, L::A_ROWS * BK, a_peer[x] + (dig_full(s) - base));
          }
        }
#pragma unroll
        for (int y = 0; y < CM; ++y) {
          if (y == cy) continue;
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const uint32_t off = stage + 6 * L::A_TILE + q * L::B_TILE + b_col0 * BK;
            bulk_copy_cluster(b_peer[y] + off, base + off, L::B_COLS * BK, b_peer[y] + (dig_full(s) - base));
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- the products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PRODUCT_REGS));
    const int g = wg - 1;  // 0: D = AR.BR, 1: E = AI.BI, 2: F = AS.BS
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    float hh[32], xx[32], ll[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hh[i] = xx[i] = ll[i] = 0.f;

    // Descriptors of the digit tiles of this product in stage 0: K-major,
    // 8-row groups 8 BK bytes apart; a k32 step moves the start by 32
    // bytes (2 in the address field), a stage by STAGE bytes.
    constexpr uint32_t SBO = 8 * BK;
    const uint64_t ah0 = smem_desc(base + (2 * g) * L::A_TILE, 16, SBO, L::LAYOUT);
    const uint64_t al0 = smem_desc(base + (2 * g + 1) * L::A_TILE, 16, SBO, L::LAYOUT);
    const uint64_t bh0 = smem_desc(base + 6 * L::A_TILE + (2 * g) * L::B_TILE, 16, SBO, L::LAYOUT);
    const uint64_t bl0 = smem_desc(base + 6 * L::A_TILE + (2 * g + 1) * L::B_TILE, 16, SBO, L::LAYOUT);
    // one chain, c = a0 b0 + a1 b1 from zero, then its fold into acc
    float c[32];
    const auto chain = [&](uint64_t a0, uint64_t b0, uint64_t a1, uint64_t b1) {
      wgmma_fence();
      wgmma_e4m3(c, a0, b0, 0);
      wgmma_e4m3(c, a1, b1, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(c);
    };
    const auto fold = [&](float (&acc)[32]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], c[i]);  // exact: integers below 2^24
    };

    // the blocks whose split writes into this block's stages: its cluster
    // row (A) and column (B)
    uint32_t writer[CN + CM - 1];
#pragma unroll
    for (int x = 0; x < CN; ++x) writer[x] = cluster_map(base, x + cy * CN);
#pragma unroll
    for (int y = 0; y < CM - 1; ++y) writer[CN + y] = cluster_map(base, cx + (y + (y >= cy)) * CN);
    for (int t = 0; t < S; ++t) {
      const int s = t % ST;
      mbar_wait(dig_full(s), (t / ST) & 1);
      const uint64_t st = static_cast<uint64_t>(s * L::STAGE) >> 4;
      const uint64_t ah = ah0 + st, al = al0 + st, bh = bh0 + st, bl = bl0 + st;
      static_assert(HH_CHAIN_K32 == 2 && LL_CHAIN_K32 == 2 && X_CHAIN_K32 == 1, "the chains below");
#pragma unroll
      for (int q = 0; q < L::K32; q += 2) {
        chain(ah + 2 * q, bh + 2 * q, ah + 2 * (q + 1), bh + 2 * (q + 1));  // HH over k32 steps q, q + 1
        fold(hh);
        chain(al + 2 * q, bl + 2 * q, al + 2 * (q + 1), bl + 2 * (q + 1));  // LL
        fold(ll);
      }
#pragma unroll
      for (int q = 0; q < L::K32; ++q) {
        chain(ah + 2 * q, bl + 2 * q, al + 2 * q, bh + 2 * q);  // X over k32 step q: ah.bl + al.bh
        if (q == L::K32 - 1 && lane == 0) {  // this warp is done with the stage
#pragma unroll
          for (int w = 0; w < CN + CM - 1; ++w) mbar_arrive_cluster(writer[w] + (dig_empty(s) - base));
        }
        fold(xx);
      }
    }

    // epilogue: this product's residue m8 m(HH) + m4 m(X) + m(LL) mod p
    const int m4 = sym_mod_i32(16, p), m8 = sym_mod_i32(m4 * m4, p);
    int res[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // exact: the sums are integers below 2^24
      const int eh = sym_mod_i32(__float2int_rn(hh[i]), p);
      const int ex = sym_mod_i32(__float2int_rn(xx[i]), p);
      const int el = sym_mod_i32(__float2int_rn(ll[i]), p);
      res[i] = sym_mod_i32(m8 * eh + m4 * ex + el, p);
    }
    // the accumulator layout: lane (q, r) = (lane / 4, lane % 4) of warp w
    // holds rows 16 w + q (+ 8) and, of each 8-wide n block j, columns 8 j +
    // 2 r (+ 1)
    const auto row_of = [&](int i) { return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1); };
    const auto col_of = [&](int i) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); };
    int8_t* xchg = gbase + L::XCHG_OFF;
    if (g < 2) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[g * BM * BN + row_of(i) * BN + col_of(i)] = static_cast<int8_t>(res[i]);
    }
    asm volatile("bar.sync 1, 384;" ::: "memory");  // the three product warpgroups
    if (g == 2) {
      const size_t out0 = static_cast<size_t>(plane) * m * n;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = m0 + row_of(i), col = n0 + col_of(i);
        if (row < m && col < n) {
          const int e = row_of(i) * BN + col_of(i);
          const int d = xchg[e], ee = xchg[BM * BN + e];
          int cr = d - ee, ci = res[i] - d - ee;
          const size_t idx = out0 + static_cast<size_t>(row) * n + col;
          if (op.carry_r != nullptr) {
            cr += op.carry_r[idx];
            ci += op.carry_i[idx];
          }
          op.out_r[idx] = static_cast<int8_t>(sym_mod_i32(cr, p));
          op.out_i[idx] = static_cast<int8_t>(sym_mod_i32(ci, p));
        }
      }
    }
  }
  // no block leaves while a peer may still write into it or arrive on its barriers
  cluster_arrive();
  cluster_wait();
}

// The launch configuration: the grid padded to whole CM x CN clusters.
template <int BK, int ST, bool TMA>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n, int n_mod,
                      cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  return cluster_launch_config(cfg, cluster, fp8_karatsuba_kernel<BK, ST, TMA>, grid, THREADS,
                               Layout<BK, ST>::BYTES, CN, CM, stream);
}

template <int BK, int ST, bool TMA>
int launch_path(const Operands& op, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  using L = Layout<BK, ST>;
  CUtensorMap maps[4] = {};
  if (TMA) {
    constexpr CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!tensor_map(&maps[0], op.ar, k, m, n_mod, BK, L::A_ROWS, none) ||
        !tensor_map(&maps[1], op.ai, k, m, n_mod, BK, L::A_ROWS, none) ||
        !tensor_map(&maps[2], op.br, n, k, n_mod, L::B_COLS, BK, none) ||
        !tensor_map(&maps[3], op.bi, n, k, n_mod, L::B_COLS, BK, none)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BK, ST, TMA>(cfg, cluster, m, n, n_mod, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fp8_karatsuba_kernel<BK, ST, TMA>, maps[0], maps[1], maps[2], maps[3], op, m,
                           n, k, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BK, int ST>
int launch(const Operands& op, bool tma, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  return tma ? launch_path<BK, ST, true>(op, n_mod, m, n, k, prm, s)
             : launch_path<BK, ST, false>(op, n_mod, m, n, k, prm, s);
}

// info = {CM, CN, the most clusters the card holds at once, shared bytes a
// block, digit stages, raw stages}, for the TMA launch of tile BK at n_mod planes
template <int BK, int ST>
int cluster_info_of(int n_mod, int* info) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BK, ST, true>(cfg, cluster, CM * BM, CN * BN, n_mod, 0);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, fp8_karatsuba_kernel<BK, ST, true>, &cfg);
  }
  info[0] = CM;
  info[1] = CN;
  info[2] = clusters;
  info[3] = Layout<BK, ST>::BYTES;
  info[4] = ST;
  info[5] = Layout<BK, ST>::RST;
  return static_cast<int>(err);
}

}  // namespace

REPRO_USES_TMA_ENTRY

// The tiles: REPRO_TILE(BM, BN, BK, digit stages); the first is the default.
#define REPRO_TILES \
  REPRO_TILE(64, 64, 64, 3) \
  REPRO_TILE(64, 64, 128, 2)

extern "C" int fp8_karatsuba_launch(const void* ar, const void* ai, const void* br,
                                    const void* bi, const void* carry_r, const void* carry_i,
                                    void* out_r, void* out_i, int n_mod, int m, int n, int k,
                                    int bm, int bn, int bk, const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI || m < 0 || n < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const bool tma = uses_tma(ar, ai, br, bi, n, k);
  const Operands op = {static_cast<const int8_t*>(ar),      static_cast<const int8_t*>(ai),
                       static_cast<const int8_t*>(br),      static_cast<const int8_t*>(bi),
                       static_cast<const int8_t*>(carry_r), static_cast<const int8_t*>(carry_i),
                       static_cast<int8_t*>(out_r),         static_cast<int8_t*>(out_i),
                       k % 4 == 0 && aligned(ar, 4) && aligned(ai, 4),
                       n % 4 == 0 && aligned(br, 4) && aligned(bi, 4)};
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM_, BN_, BK_, RAW_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<BK_, RAW_>(op, tma, n_mod, m, n, k, prm, s);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}

// The cluster shape and occupancy of the launch of tile (bm, bn, bk) at
// n_mod planes: info[6] = {CM, CN, max active clusters, shared bytes a
// block, digit stages, raw stages}.
extern "C" int fp8_karatsuba_cluster_info(int bm, int bn, int bk, int n_mod, int* info) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TILE(BM_, BN_, BK_, RAW_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return cluster_info_of<BK_, RAW_>(n_mod, info);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
