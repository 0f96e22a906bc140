// Modulus-batched residue GEMM on the e4m3 engine:
// out[l] = sym_mod(A[l] @ B[l] (+ carry[l]), p_l) for every plane l, each
// residue product formed from balanced base-16 digits (fp8_tiles.cuh):
// r_a r_b = 256 HH + 16 X + LL.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/fp8_mod_gemm.py:85
// (`fp8_mod_gemm_batched`, :336).
//
// Bound on the H100: e4m3 tensor-core operations, four digit products of
// 2 m n k each per plane (HH, LL and the two halves of X), 8 N m n k in all,
// at 1,979 TFLOP/s dense (4096^3 at N = 8: 2.22 ms); the N (m k + k n + m n)
// bytes are far below that line.  Beside the products, the digit split
// (some 16 CUDA-core instructions a 4-byte word of an operand, and B's
// transpose) and the fold of the chains (an FADD per element a chain)
// compete for issue slots.
//
// Design (fp8_karatsuba.cu's split-and-wgmma plan, with karatsuba_fused.cu's
// warp roles).  A block owns a 128 x 64 output tile of one plane (grid: n
// tiles, m tiles, planes) and walks K in BK-deep slices through a ring of ST
// stages; 512 threads in four warpgroups.
//  * Warpgroups 2-3 own 64 rows of the tile each and run its digit products
//    on wgmma.m64n64k32.f32.e4m3.e4m3, A and B from shared memory (K-major,
//    the 64- or 128-byte swizzle), in chains that start from zero and are
//    folded into three f32 accumulators HH, X and LL with an FADD (96
//    registers a thread); no conversion in the K loop.  The two warpgroups'
//    chains interleave on the tensor cores, one folding while the other's
//    chain runs (a second chain in flight a warpgroup ran 1-3 % slower on
//    the H100, PERF.md section 6).
//  * Warpgroups 0-1 prepare.  Their first warp's thread brings the block's
//    raw int8 shares of A, (m, k) k-contiguous, and of B, (k, n)
//    n-contiguous, by TMA into the stage's raw slot (an mbarrier with
//    transaction bytes) once every reader has released the stage.  The next
//    warp's thread pushes (below).  The other six warps split: A's share 16
//    bytes at a time, B's as 4 x 4 blocks transposed to K-major (TMA cannot
//    transpose bytes), into hi and lo e4m3 digits in f16x2 (`split_digits`)
//    at their swizzled places.  Each warp runs on its own, synchronised by
//    the ring's mbarriers alone: no named barrier, so none follows a
//    branch that only some lanes of a warp take.
//  * The split is shared by a CM x CN thread-block cluster: the CN blocks of
//    a cluster row multiply the same A rows, the CM blocks of a cluster
//    column the same B columns, so block (cx, cy) splits A rows [BM cx / CN,
//    BM (cx + 1) / CN) and B columns [BN cy / CM, BN (cy + 1) / CM) of each
//    slice into its own stage, and the push warp's thread copies that share
//    into the same stage of each peer that reads it with cp.async.bulk
//    (shared::cta to shared::cluster), each copy completing the peer's
//    "stage full" mbarrier by its bytes.  The product warps release a stage
//    by arriving on the "stage empty" mbarrier of every block that writes
//    into it, with the default, CTA-scope release (`mbar_arrive_remote`):
//    the order they carry is write-after-read of reads that have completed
//    (wgmma.wait_group returned them); the cluster-scope release cost this
//    kernel 2.6x, as it cost the int8 kernels 1.8-2.3x (PERF.md section 6).
//    On the H100 at 4096^3, N = 8, no cluster ran 1.36x slower, 2 x 1, 4 x 1
//    and 1 x 2 1.1-1.2x; 4 x 2 and 2 x 4 were within 3 % of 2 x 2, the
//    smallest of the three.  The grid is padded to whole clusters; a padding
//    block splits its share and stores no output.
//  * Shapes TMA cannot map (k or n not a multiple of 16, or an operand not
//    16-byte aligned) take the second instantiation, in which the split
//    warps load their shares from global memory themselves (4-byte words
//    where k, n and the pointers allow it, else bytes) once the stage is
//    free.  Which one a launch takes depends on shape and alignment alone
//    (hopper.cuh's `uses_tma`); everything after the load is the same.
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
// Epilogue, the reference's (fp8_mod_gemm.py:118-132): each digit sum to
// int32 and its canonical residue mod p_l, m8 eh + m4 ex + el with m4 = 16
// mod p_l and m8 = m4^2 mod p_l, + carry, the final symmetric mod, int8
// store, masked at the ragged edge.  The canonical residue is unique, so the
// bits are fp8_mod_gemm_plain's and int8_mod_gemm.cu's.  Ragged m/n/k read
// zeros (TMA's out-of-bounds fill, or masked loads), which split into zero
// digits and add nothing.
#include "fp8_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int CM = 2, CN = 2;  // the cluster: CM blocks along m, CN along n
constexpr int BM = 128, BN = 64;  // the block's output tile: two wgmma m64n64 row blocks
constexpr int PREP_WGS = 2;       // the preparing warpgroups: the load warp, the push warp, the split warps
constexpr int PREP_THREADS = 128 * PREP_WGS;
constexpr int SPLIT_THREADS = PREP_THREADS - 64;  // the split warps
constexpr int PRODUCT_WGS = BM / 64;
constexpr int THREADS = PREP_THREADS + 128 * PRODUCT_WGS;
// Registers a thread: LAUNCH_REGS at launch (the register file over the
// threads, in steps of 8), then setmaxnreg; the products' increase must be
// covered by what the preparing threads release.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PREP_REGS = 88, PRODUCT_REGS = 168;
static_assert(PREP_THREADS * (LAUNCH_REGS - PREP_REGS) >= 128 * PRODUCT_WGS * (PRODUCT_REGS - LAUNCH_REGS),
              "the register pool");
// k32 steps a wgmma chain sums over (see the accumulation rule above)
constexpr int HH_CHAIN_K32 = 2;
constexpr int LL_CHAIN_K32 = 2;
constexpr int X_CHAIN_K32 = 1;

constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use

// The shared memory of tile BK with a ring of ST stages, each with its raw
// slot.
template <int BK, int ST>
struct Layout {
  static constexpr int K32 = BK / 32;
  static constexpr int LAYOUT = BK == 128 ? 1 : 2;  // the descriptors' swizzle mode: 128 or 64 bytes
  static constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // one digit of one operand, [rows][BK]
  static constexpr int STAGE = 2 * (A_TILE + B_TILE);       // Ah, Al, then Bh, Bl
  static constexpr int A_ROWS = BM / CN, B_COLS = BN / CM;  // the block's share of a slice
  static constexpr int RAW_A = A_ROWS * BK, RAW_B = BK * B_COLS;  // [A_ROWS][BK], [BK][B_COLS] bytes
  static constexpr int RAW_STAGE = RAW_A + RAW_B;
  static constexpr int A_CHUNKS = RAW_A / 16, B_BLOCKS = (B_COLS / 4) * (BK / 4);  // 16-byte A chunks, 4 x 4 B blocks
  static constexpr int A_ITERS = (A_CHUNKS + SPLIT_THREADS - 1) / SPLIT_THREADS;  // rounds of the split threads
  static constexpr int B_ITERS = (B_BLOCKS + SPLIT_THREADS - 1) / SPLIT_THREADS;
  // B blocks start with the threads that have one A chunk fewer
  static constexpr int B_SHIFT = SPLIT_THREADS - A_CHUNKS % SPLIT_THREADS;
  static constexpr int RAW_OFF = ST * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + ST * RAW_STAGE;  // 4 ST mbarriers
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * 4 * ST;  // 1024: alignment of the swizzle atoms
  // the digit bytes a block receives from its peers a slice
  static constexpr int INCOMING = 2 * ((CN - 1) * A_ROWS * BK + (CM - 1) * B_COLS * BK);
  static_assert(BK == 64 || BK == 128, "one swizzle row a slice");
  static_assert(B_COLS % 16 == 0, "a TMA box row of B is a multiple of 16 bytes");
  static_assert(K32 % HH_CHAIN_K32 == 0 && K32 % LL_CHAIN_K32 == 0 && K32 % X_CHAIN_K32 == 0, "chains");
  static_assert(ST >= 2, "a ring");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

struct Operands {
  const int8_t *a, *b;
  const int8_t* carry;  // null without a carry
  int8_t* out;
  int a_vec, b_vec;     // the global loads may take 4-byte words (A rows, B rows)
};

template <int BK, int ST, bool TMA>
__global__ void __launch_bounds__(THREADS, 1) fp8_mod_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, const Operands op,
    int m, int n, int k, const __grid_constant__ ModParams prm) {
  using L = Layout<BK, ST>;
  extern __shared__ uint4 smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  const uint32_t raw0 = base + L::RAW_OFF, bar0 = base + L::BAR_OFF;
  // the ring's barriers, by stage: the raw shares loaded by TMA; this
  // block's share split by every split warp; the stage complete (this
  // block's share, and the peers' by bulk copy); the stage read (by every
  // block whose share it holds, and so its raw slot by every split warp,
  // which the products wait for)
  const auto loaded = [&](int s) { return bar0 + 8 * s; };
  const auto prepared = [&](int s) { return bar0 + 8 * (ST + s); };
  const auto full = [&](int s) { return bar0 + 8 * (2 * ST + s); };
  const auto empty = [&](int s) { return bar0 + 8 * (3 * ST + s); };
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, plane = blockIdx.z;
  const int S = k > BK ? (k + BK - 1) / BK : 1;  // K slices
  const int wg = threadIdx.x >> 7;
  const int a_row0 = cx * L::A_ROWS, b_col0 = cy * L::B_COLS;  // the block's shares in its tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(loaded(s), 1);                                 // the load thread, with the TMA bytes
      mbar_init(prepared(s), SPLIT_THREADS / 32);              // each split warp
      mbar_init(full(s), 1);                                   // the push thread, with the bytes the peers send
      mbar_init(empty(s), 4 * PRODUCT_WGS * (CN + CM - 1));    // each product warp of each reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster has started: its barriers may be reached
  cluster_wait();

  if (wg < PREP_WGS) {
    // ------------------------------------------------------ the preparation
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PREP_REGS));
    if (threadIdx.x < 64) {
      // Two producer threads, each waiting on one barrier a slice in the
      // ring's order: the load thread issues every TMA load, the push thread
      // every bulk copy, so that no split warp waits on either.
      if (TMA && threadIdx.x == 0) {
        for (int j = 0; j < S; ++j) {
          // every reader is done with the stage's last slice, and so every
          // split warp with its raw slot (a fresh barrier passes the wait on
          // parity 1)
          const int s = j % ST;
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
          const uint32_t slot = raw0 + s * L::RAW_STAGE;
          mbar_expect_tx(loaded(s), L::RAW_STAGE);
          tma_load(slot, tm_a, loaded(s), j * BK, m0 + a_row0, plane);
          tma_load(slot + L::RAW_A, tm_b, loaded(s), n0 + b_col0, j * BK, plane);
        }
      } else if (threadIdx.x == 32) {
        // this block's shares go to the blocks of its cluster row (A) and
        // column (B)
        uint32_t a_peer[CN], b_peer[CM];
#pragma unroll
        for (int x = 0; x < CN; ++x) a_peer[x] = cluster_map(base, x + cy * CN);
#pragma unroll
        for (int y = 0; y < CM; ++y) b_peer[y] = cluster_map(base, cx + y * CN);
        for (int j = 0; j < S; ++j) {
          // slice j split: the peers' shares are expected, and this block's
          // shares go to the peers that read them
          const int s = j % ST;
          mbar_wait(prepared(s), (j / ST) & 1);
          mbar_expect_tx(full(s), L::INCOMING);
#pragma unroll
          for (int x = 0; x < CN; ++x) {
            if (x == cx) continue;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const uint32_t off = s * L::STAGE + d * L::A_TILE + a_row0 * BK;
              bulk_copy_cluster(a_peer[x] + off, base + off, L::A_ROWS * BK, a_peer[x] + (full(s) - base));
            }
          }
#pragma unroll
          for (int y = 0; y < CM; ++y) {
            if (y == cy) continue;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              const uint32_t off = s * L::STAGE + 2 * L::A_TILE + d * L::B_TILE + b_col0 * BK;
              bulk_copy_cluster(b_peer[y] + off, base + off, L::B_COLS * BK, b_peer[y] + (full(s) - base));
            }
          }
        }
      }
      __syncwarp();
    } else {
      // The split warps: this block's shares of every slice, each warp on
      // its own, synchronised by the barriers alone.
      const int ct = threadIdx.x - 64;
      const size_t a_plane = static_cast<size_t>(plane) * m * k, b_plane = static_cast<size_t>(plane) * k * n;
      for (int j = 0; j < S; ++j) {
        const int s = j % ST;
        const uint32_t stage = base + s * L::STAGE;
        const uint32_t slot = raw0 + s * L::RAW_STAGE;
        const int k0 = j * BK;
        if (TMA) {
          mbar_wait(loaded(s), (j / ST) & 1);  // and so the stage is free: the load thread waited for it
        } else {
          // every block that reads stage s is done with slice j - ST
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
        }
        // A: one 16-byte chunk of a row of the share a round, its hi and lo
        // digits to the chunk's (swizzled) place in the Ah and Al tiles
#pragma unroll
        for (int i = 0; i < L::A_ITERS; ++i) {
          const int c = ct + SPLIT_THREADS * i;
          if (L::A_CHUNKS % SPLIT_THREADS != 0 && c >= L::A_CHUNKS) break;
          const int ra = c / (BK / 16), ca = (c % (BK / 16)) * 16;
          uint32_t w[4];
          if (TMA) {
            const uint4 v = ld_shared4(slot + 16 * c);
            w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
          } else {
            const int gm = m0 + a_row0 + ra, kk = k0 + ca;
            const size_t off = a_plane + static_cast<size_t>(gm) * k + kk;
#pragma unroll
            for (int q = 0; q < 4; ++q) w[q] = load_word(op.a + off + 4 * q, gm < m ? k - kk - 4 * q : 0, op.a_vec);
          }
          uint4 hi, lo;
          split_digits(w[0], hi.x, lo.x);
          split_digits(w[1], hi.y, lo.y);
          split_digits(w[2], hi.z, lo.z);
          split_digits(w[3], hi.w, lo.w);
          const uint32_t dst = stage + swizzled<BK>(a_row0 + ra, ca);
          st_shared4(dst, hi);
          st_shared4(dst + L::A_TILE, lo);
        }
        // B: a 4(k) x 4(n) block a round, transposed to 4 k-contiguous columns
#pragma unroll
        for (int i = 0; i < L::B_ITERS; ++i) {
          const int b = (ct + L::B_SHIFT) % SPLIT_THREADS + SPLIT_THREADS * i;
          if (L::B_BLOCKS % SPLIT_THREADS != 0 && b >= L::B_BLOCKS) break;
          const int nb = b % (L::B_COLS / 4), kb = b / (L::B_COLS / 4);
          uint32_t rb[4];
          if (TMA) {
#pragma unroll
            for (int r = 0; r < 4; ++r) rb[r] = ld_shared(slot + L::RAW_A + (4 * kb + r) * L::B_COLS + 4 * nb);
          } else {
            const int gn = n0 + b_col0 + 4 * nb;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int kk = k0 + 4 * kb + r;
              rb[r] = load_word(op.b + b_plane + static_cast<size_t>(kk) * n + gn, kk < k ? n - gn : 0, op.b_vec);
            }
          }
          uint32_t wb[4];  // column j4 of the block: 4 consecutive k
          transpose4x4(rb, wb);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            uint32_t hi, lo;
            split_digits(wb[j4], hi, lo);
            const uint32_t dst = stage + 2 * L::A_TILE + swizzled<BK>(b_col0 + 4 * nb + j4, 4 * kb);
            st_shared(dst, hi);
            st_shared(dst + L::B_TILE, lo);
          }
        }
        fence_proxy_async_shared();  // the digits are read by bulk copies and wgmma
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(prepared(s));  // this warp's part of the slice is written
      }
    }
  } else {
    // ---------------------------------------------------------- the products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PRODUCT_REGS));
    const int g = wg - PREP_WGS;  // rows [64 g, 64 g + 64) of the block's tile
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    float hh[32], xx[32], ll[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hh[i] = xx[i] = ll[i] = 0.f;

    // Descriptors of the digit tiles in stage 0: K-major, 8-row groups 8 BK
    // bytes apart; a k32 step moves the start by 32 bytes (2 in the address
    // field), a stage by STAGE bytes.
    constexpr uint32_t SBO = 8 * BK;
    const uint64_t ah0 = smem_desc(base + 64 * g * BK, 16, SBO, L::LAYOUT);
    const uint64_t al0 = smem_desc(base + L::A_TILE + 64 * g * BK, 16, SBO, L::LAYOUT);
    const uint64_t bh0 = smem_desc(base + 2 * L::A_TILE, 16, SBO, L::LAYOUT);
    const uint64_t bl0 = smem_desc(base + 2 * L::A_TILE + L::B_TILE, 16, SBO, L::LAYOUT);

    // The chains of a slice, in order: for each pair of k32 steps (q, q + 1),
    // HH over both, LL over both, X over q, X over q + 1; each is folded
    // into its accumulator once it is complete.
    static_assert(HH_CHAIN_K32 == 2 && LL_CHAIN_K32 == 2 && X_CHAIN_K32 == 1, "the chains below");
    float c[32];
    const auto chain = [&](uint64_t a0, uint64_t b0, uint64_t a1, uint64_t b1, float (&acc)[32]) {
      wgmma_fence();
      wgmma_e4m3(c, a0, b0, 0);
      wgmma_e4m3(c, a1, b1, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(c);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], c[e]);  // exact: integers below 2^24
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
      mbar_wait(full(s), (t / ST) & 1);
      const uint64_t st = static_cast<uint64_t>(s * L::STAGE) >> 4;
      const uint64_t ah = ah0 + st, al = al0 + st, bh = bh0 + st, bl = bl0 + st;
#pragma unroll
      for (int q = 0; q < L::K32; q += 2) {
        chain(ah + 2 * q, bh + 2 * q, ah + 2 * (q + 1), bh + 2 * (q + 1), hh);  // HH over k32 steps q, q + 1
        chain(al + 2 * q, bl + 2 * q, al + 2 * (q + 1), bl + 2 * (q + 1), ll);  // LL
        chain(ah + 2 * q, bl + 2 * q, al + 2 * q, bh + 2 * q, xx);  // X over k32 step q: ah.bl + al.bh
        chain(ah + 2 * (q + 1), bl + 2 * (q + 1), al + 2 * (q + 1), bh + 2 * (q + 1), xx);  // X over step q + 1
      }
      if (lane == 0) {  // this warp is done with the stage
#pragma unroll
        for (int w = 0; w < CN + CM - 1; ++w) mbar_arrive_remote(writer[w] + (empty(s) - base));
      }
    }

    // epilogue: m8 m(HH) + m4 m(X) + m(LL) (+ carry) mod p
    const int p = prm.p[plane];
    const int m4 = sym_mod_i32(16, p), m8 = sym_mod_i32(m4 * m4, p);
    // the accumulator layout: lane (q, r) = (lane / 4, lane % 4) of warp w
    // holds rows 16 w + q (+ 8) and, of each 8-wide n block j, columns 8 j +
    // 2 r (+ 1)
    const size_t out0 = static_cast<size_t>(plane) * m * n;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = m0 + 64 * g + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (row < m && col < n) {
        const size_t idx = out0 + static_cast<size_t>(row) * n + col;
        // exact: the sums are integers below 2^24
        const int eh = sym_mod_i32(__float2int_rn(hh[i]), p);
        const int ex = sym_mod_i32(__float2int_rn(xx[i]), p);
        const int el = sym_mod_i32(__float2int_rn(ll[i]), p);
        int v = m8 * eh + m4 * ex + el;  // |v| <= 2 * 127^2 + 127
        if (op.carry != nullptr) v += op.carry[idx];
        op.out[idx] = static_cast<int8_t>(sym_mod_i32(v, p));
      }
    }
  }
  // no block leaves while a peer may still write into it or arrive on its barriers
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

// The launch configuration: the grid padded to whole CM x CN clusters.
template <int BK, int ST, bool TMA>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n, int n_mod,
                      cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  return cluster_launch_config(cfg, cluster, fp8_mod_gemm_kernel<BK, ST, TMA>, grid, THREADS,
                               Layout<BK, ST>::BYTES, CN, CM, stream);
}

template <int BK, int ST, bool TMA>
int launch_path(const Operands& op, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  using L = Layout<BK, ST>;
  CUtensorMap maps[2] = {};
  if (TMA) {
    constexpr CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!tensor_map(&maps[0], op.a, k, m, n_mod, BK, L::A_ROWS, none) ||
        !tensor_map(&maps[1], op.b, n, k, n_mod, L::B_COLS, BK, none)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BK, ST, TMA>(cfg, cluster, m, n, n_mod, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fp8_mod_gemm_kernel<BK, ST, TMA>, maps[0], maps[1], op, m, n, k, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BK, int ST>
int launch(const Operands& op, bool tma, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  return tma ? launch_path<BK, ST, true>(op, n_mod, m, n, k, prm, s)
             : launch_path<BK, ST, false>(op, n_mod, m, n, k, prm, s);
}

// info = {CM, CN, the most clusters the card holds at once, shared bytes a
// block, stages}, for the TMA launch of tile BK at n_mod planes
template <int BK, int ST>
int cluster_info_of(int n_mod, int* info) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BK, ST, true>(cfg, cluster, CM * BM, CN * BN, n_mod, 0);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, fp8_mod_gemm_kernel<BK, ST, true>, &cfg);
  }
  info[0] = CM;
  info[1] = CN;
  info[2] = clusters;
  info[3] = Layout<BK, ST>::BYTES;
  info[4] = ST;
  return static_cast<int>(err);
}

}  // namespace

REPRO_USES_TMA_ENTRY

// The tiles: REPRO_TILE(BM, BN, BK, stages); the first is the default.  On
// the H100 six stages of BK = 64 ran 6 % faster than four (seven, the most
// that fit, no faster), and BK = 128 with three stages 6-8 % slower.
#define REPRO_TILES \
  REPRO_TILE(128, 64, 64, 6) \
  REPRO_TILE(128, 64, 128, 3)

extern "C" int fp8_mod_gemm_launch(const void* a, const void* b, const void* carry, void* out, int n_mod, int m,
                                   int n, int k, int bm, int bn, int bk, const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI || m < 0 || n < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) prm.p[l] = moduli[l];
  const bool tma = uses_tma(a, a, b, b, n, k);
  const Operands op = {static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                       static_cast<const int8_t*>(carry), static_cast<int8_t*>(out),
                       k % 4 == 0 && aligned(a, 4), n % 4 == 0 && aligned(b, 4)};
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM_, BN_, BK_, ST_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<BK_, ST_>(op, tma, n_mod, m, n, k, prm, s);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}

// The cluster shape and occupancy of the launch of tile (bm, bn, bk) at
// n_mod planes: info[5] = {CM, CN, max active clusters, shared bytes a
// block, stages}.
extern "C" int fp8_mod_gemm_cluster_info(int bm, int bn, int bk, int n_mod, int* info) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TILE(BM_, BN_, BK_, ST_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return cluster_info_of<BK_, ST_>(n_mod, info);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
