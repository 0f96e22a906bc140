// Modulus-batched int8 residue GEMM with a symmetric-mod epilogue:
// out[l] = sym_mod(A[l] @ B[l] (+ carry[l]), p_l) for every plane l.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/int8_mod_gemm.py:51
// (`int8_mod_gemm_batched`, :112).
//
// Bound on the H100: int8 tensor-core operations, 2 N m n k of them, at
// 1,979 TOP/s dense (4096^3 at N = 8: 0.556 ms); the N (m k + k n + m n)
// bytes are far below that line.  Beside the products, only B's transpose
// takes CUDA-core work: 8-bit wgmma reads both operands K-major, and B
// planes are (k, n) n-major.
//
// Design (fp8_mod_gemm.cu's skeleton without the digit split, on
// karatsuba_fused.cu's s8 products).  A block owns a BM x BN output tile of
// one plane (grid: n tiles, m tiles, planes) and walks K in BK-deep slices
// through a ring of ST stages; one preparing warpgroup (two on the
// global-load path) and BM / 64 product warpgroups.
//  * Each product warpgroup owns 64 rows of the tile and runs
//    wgmma.m64n{BN}k32.s32.s8.s8 on them, A and B from shared memory
//    (K-major, the 64- or 128-byte swizzle by BK), accumulating in int32
//    registers over all of K: |sum| <= 127^2 k < 2^31 for k <= 2^17, the
//    wrapper's limit, so nothing is reduced or converted in the loop.  One
//    slice's wgmma group stays in flight while the next is issued; a stage
//    is released when its group has completed.
//  * The preparing warpgroup: one thread of its first warp waits for a
//    stage to be free and brings A, (m, k) k-contiguous, by TMA straight
//    into the stage's swizzled K-major tile (no thread touches it), and the
//    block's share of raw B, (k, n) n-major, into the stage's raw slot, all
//    on one mbarrier with transaction bytes.  One thread of the next warp
//    pushes (below).  The other two warps transpose the raw B share, 4 x 4
//    bytes at a time, into the K-major swizzled B tile (TMA cannot
//    transpose bytes), taking turns by slice, so that two slices are
//    prepared at once.  Every warp runs on its own, synchronised by the
//    ring's mbarriers alone: no named barrier.  A warp that takes slice j
//    has waited only for slice j - W - ST to be read (W warps take turns),
//    and an mbarrier's parity wait cannot tell a phase from the one two
//    before it, so the stage's wait for slice j - ST is sound only with W
//    <= ST (a static_assert).  On the H100 at 4096^3, N = 8, eight stages
//    ran 4 % faster than six and 1.3x faster than four.
//  * B's transpose is shared by a CM x 1 thread-block cluster along m: the
//    CM blocks of a cluster column multiply the same B columns, so block cy
//    transposes columns [BN cy / CM, BN (cy + 1) / CM) of each slice into
//    its own stage, and the push thread copies that share into the same
//    stage of each peer with cp.async.bulk (shared::cta to shared::cluster),
//    each copy completing the peer's "stage full" mbarrier by its bytes.
//    The product warps release a stage by arriving on the "stage empty"
//    mbarrier of every block that writes into it, with the default,
//    CTA-scope release (`mbar_arrive_remote`): the order they carry is
//    write-after-read of reads that have completed (wgmma.wait_group
//    returned them); cluster scope cost the int8 kernels 1.8-2.3x (PERF.md
//    section 6).  On the H100 at 4096^3, N = 8, no cluster ran 2.2x slower,
//    2 x 1 and 8 x 1 1.2x.  The grid is padded to whole clusters; a padding
//    block transposes its share and stores no output.
//  * Shapes TMA cannot map (k or n not a multiple of 16, or an operand not
//    16-byte aligned) take the second instantiation, with a second
//    preparing warpgroup: its six preparing warps (seven where the ring
//    has seven stages: the load warp, idle there, joins), again a slice
//    each in turn, load A and their B share from global memory themselves
//    (A by 16-byte chunks where k is a multiple of 16 and A 16-byte
//    aligned, else by 4-byte words where k and A allow it, else bytes; B
//    by 4-byte words where n and B allow it, else bytes), issuing the
//    loads before they wait for the stage and storing once it is free.
//    On the H100 at 4096 x 4096 x 4092, N = 8, this path ran 3.05 ms (the
//    TMA path 2.18 at 4096^3); with A by 4-byte words it ran 1.4x slower,
//    without the seventh warp 2-4 % slower (6 % at k = 4092).  Which one a
//    launch takes depends on shape and alignment alone (hopper.cuh's
//    `uses_tma`); everything after the load is the same.
//
// Epilogue: + carry, the exact int32 symmetric mod by p_l, int8 store,
// masked at the ragged edge.  Int32 sums are exact in any order and the
// canonical residue is unique, so the bits are int8_mod_gemm_plain's.
// Ragged m/n/k read zeros (TMA's out-of-bounds fill, or masked loads),
// which add nothing.  tests/test_torch_int8_schedule.py models the
// transpose, the shares, the shared memory and the int32 bound from this
// file.
#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int CM = 4, CN = 1;  // the cluster: CM blocks along m, CN along n
constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use

// The block of tile (BM, BN, BK) with a ring of ST stages, each with its raw
// B slot, on the TMA path or the global-load path.
template <int BM, int BN, int BK, int ST, bool TMA>
struct Layout {
  // the preparing warpgroups: the load warp, the push warp, then the
  // preparing warps, which also load A and B on the global-load path
  static constexpr int PREP_WGS = TMA ? 1 : 2;
  static constexpr int PREP_THREADS = 128 * PREP_WGS;
  // the warps that take slices in turn: the two after the load and push
  // warps; on the global-load path the six after them, and the load warp,
  // idle there, too where the ring has room for a seventh (no more than ST)
  static constexpr int PREP_WARPS = TMA ? 2 : (ST >= 7 ? 7 : 6);
  static constexpr int PRODUCT_WGS = BM / 64;
  static constexpr int THREADS = PREP_THREADS + 128 * PRODUCT_WGS;
  // Registers a thread: LAUNCH_REGS at launch (the register file over the
  // threads, in steps of 8); on the TMA path with two product warpgroups,
  // setmaxnreg then moves what the preparing warpgroup releases to the
  // products.  The global-load path keeps the launch's split: its
  // preparing warps hold a slice's loads in registers.
  static constexpr bool MOVE_REGS = TMA && THREADS > 256;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PREP_REGS = 72;
  static constexpr int FREED = LAUNCH_REGS + PREP_THREADS * (LAUNCH_REGS - PREP_REGS) / (128 * PRODUCT_WGS);
  static constexpr int PRODUCT_REGS = (FREED < 232 ? FREED : 232) / 8 * 8;
  static constexpr int K32 = BK / 32;
  static constexpr int LAYOUT = BK == 128 ? 1 : 2;  // the descriptors' swizzle mode: 128 or 64 bytes
  static constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // [rows][BK]
  static constexpr int STAGE = A_TILE + B_TILE;
  static constexpr int B_COLS = BN / CM;   // the block's share of B's columns
  static constexpr int RAW_B = BK * B_COLS;  // [BK][B_COLS] bytes, n contiguous
  // a preparing warp takes whole slices: A in 16-byte chunks (global
  // loads only), B in 4 x 4 blocks, a lane one of each a round; the loads
  // of all of B and of A's first batch are in flight before the first store
  static constexpr int A_CHUNKS = A_TILE / 16, B_BLOCKS = (B_COLS / 4) * (BK / 4);
  static constexpr int A_ITERS = A_CHUNKS / 32, B_ITERS = B_BLOCKS / 32;
  static constexpr int A_BATCH = A_ITERS < 16 ? A_ITERS : 16;
  static constexpr int RAW_OFF = ST * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + ST * RAW_B;  // 4 ST mbarriers
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * 4 * ST;  // 1024: alignment of the swizzle atoms
  // the transposed B bytes a block receives from its peers a slice
  static constexpr int INCOMING = (CM - 1) * B_COLS * BK;
  static_assert(BM == 64 || BM == 128, "one or two product warpgroups");
  static_assert(BN == 64 || BN == 128, "a wgmma n hopper.cuh spells out");
  static_assert(BK == 64 || BK == 128, "one swizzle row a slice");
  static_assert(B_COLS % 16 == 0, "a TMA box row of B is a multiple of 16 bytes");
  static_assert(!MOVE_REGS || (PREP_THREADS * (LAUNCH_REGS - PREP_REGS) >=
                                   128 * PRODUCT_WGS * (PRODUCT_REGS - LAUNCH_REGS) &&
                               PRODUCT_REGS >= LAUNCH_REGS), "the register pool");
  static_assert(A_ITERS % A_BATCH == 0 && B_ITERS > 0 && B_ITERS <= 8, "whole rounds");
  static_assert(ST >= 3, "a ring of at least three stages");
  static_assert(PREP_WARPS <= ST, "a preparing warp's stage wait must not pass a phase early");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

struct ModParams {
  int p[REPRO_MAX_MODULI];
};

struct Operands {
  const int8_t *a, *b;
  const int8_t* carry;  // null without a carry
  int8_t* out;
  int a_width;          // the global loads of A: 16-byte chunks (16), 4-byte words (4) or bytes (1)
  bool b_vec;           // the global loads of B may take 4-byte words
};

// 16 bytes of an A row at src, of which the first `valid` exist (zeros for
// the rest), by loads `width` bytes wide.  At width 16 k is a multiple of
// 16, so a chunk is whole or absent.
__device__ __forceinline__ void load_chunk(uint32_t (&w)[4], const int8_t* src, int valid, int width) {
  if (width == 16) {
    const uint4 v = valid > 0 ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = load_word(src + 4 * q, valid - 4 * q, width == 4);
  }
}

template <int BM, int BN, int BK, int ST, bool TMA>
__global__ void __launch_bounds__(Layout<BM, BN, BK, ST, TMA>::THREADS, 1) int8_mod_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, const Operands op,
    int m, int n, int k, const __grid_constant__ ModParams prm) {
  using L = Layout<BM, BN, BK, ST, TMA>;
  extern __shared__ uint4 smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  const uint32_t raw0 = base + L::RAW_OFF, bar0 = base + L::BAR_OFF;
  // the ring's barriers, by stage: A and the raw B share loaded by TMA;
  // the block's B share transposed by the slice's preparing warp; the
  // stage complete (this block's share, and the peers' by bulk copy); the
  // stage read (by every block whose share it holds, and so its raw slot by
  // the preparing warp, which the products wait for)
  const auto loaded = [&](int s) { return bar0 + 8 * s; };
  const auto prepared = [&](int s) { return bar0 + 8 * (ST + s); };
  const auto full = [&](int s) { return bar0 + 8 * (2 * ST + s); };
  const auto empty = [&](int s) { return bar0 + 8 * (3 * ST + s); };
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, plane = blockIdx.z;
  const int S = k > BK ? (k + BK - 1) / BK : 1;  // K slices
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(loaded(s), 1);                                   // the load thread, with the TMA bytes
      mbar_init(prepared(s), 1);                                 // the preparing warp of the slice
      mbar_init(full(s), 1);                                     // the push thread, with the bytes the peers send
      mbar_init(empty(s), 4 * L::PRODUCT_WGS * (CN + CM - 1));   // each product warp of each reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster has started: its barriers may be reached
  cluster_wait();

  if (wg < L::PREP_WGS) {
    // ------------------------------------------------------ the preparation
    if constexpr (L::MOVE_REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(L::PREP_REGS));
    const int b_col0 = cy * L::B_COLS;  // the block's share of B in its tile
    if (threadIdx.x < 64 && (TMA || threadIdx.x >= 32 || L::PREP_WARPS < 7)) {  // the producer warps
      // Two producer threads, each waiting on one barrier a slice in the
      // ring's order: the load thread issues every TMA load, the push thread
      // every bulk copy, so that no preparing warp waits on either.
      if (TMA && threadIdx.x == 0) {
        for (int j = 0; j < S; ++j) {
          // every reader is done with the stage's last slice, and so its
          // preparing warp with its raw slot (a fresh barrier passes the
          // wait on parity 1)
          const int s = j % ST;
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
          mbar_expect_tx(loaded(s), L::A_TILE + L::RAW_B);
          tma_load(base + s * L::STAGE, tm_a, loaded(s), j * BK, m0, plane);
          tma_load(raw0 + s * L::RAW_B, tm_b, loaded(s), n0 + b_col0, j * BK, plane);
        }
      } else if (threadIdx.x == 32) {
        // this block's B share goes to the blocks of its cluster column
        uint32_t b_peer[CM];
#pragma unroll
        for (int y = 0; y < CM; ++y) b_peer[y] = cluster_map(base, cx + y * CN);
        for (int j = 0; j < S; ++j) {
          // slice j transposed: the peers' shares are expected, and this
          // block's share goes to the peers that read it
          const int s = j % ST;
          mbar_wait(prepared(s), (j / ST) & 1);
          mbar_expect_tx(full(s), L::INCOMING);
          const uint32_t off = s * L::STAGE + L::A_TILE + b_col0 * BK;
#pragma unroll
          for (int y = 0; y < CM; ++y) {
            if (y != cy) bulk_copy_cluster(b_peer[y] + off, base + off, L::B_COLS * BK, b_peer[y] + (full(s) - base));
          }
        }
      }
      __syncwarp();
    } else {
      // The preparing warps take turns, slice j by warp j mod PREP_WARPS, so
      // that several slices are prepared at once: this block's B share (and,
      // without TMA, the A tile), synchronised by the barriers alone.
      const int lane = threadIdx.x & 31, pw = threadIdx.x >= 64 ? (threadIdx.x - 64) >> 5 : L::PREP_WARPS - 1;
      const size_t a_plane = static_cast<size_t>(plane) * m * k, b_plane = static_cast<size_t>(plane) * k * n;
      for (int j = pw; j < S; j += L::PREP_WARPS) {
        const int s = j % ST;
        const uint32_t stage = base + s * L::STAGE;
        const uint32_t slot = raw0 + s * L::RAW_B;
        const int k0 = j * BK;
        // B: 4 x 4 blocks, lane + 32 i; A: 16-byte chunks, lane + 32 i
        uint32_t rb[L::B_ITERS][4];
        const auto b_block = [&](int i, int& nb, int& kb) {
          const int b = lane + 32 * i;
          nb = b % (L::B_COLS / 4), kb = b / (L::B_COLS / 4);
        };
        const auto a_chunk = [&](int i, int& ra, int& ca) {
          const int c = lane + 32 * i;
          ra = c / (BK / 16), ca = (c % (BK / 16)) * 16;
        };
        if (TMA) {
          mbar_wait(loaded(s), (j / ST) & 1);  // and so the stage is free: the load thread waited for it
#pragma unroll
          for (int i = 0; i < L::B_ITERS; ++i) {
            int nb, kb;
            b_block(i, nb, kb);
#pragma unroll
            for (int r = 0; r < 4; ++r) rb[i][r] = ld_shared(slot + (4 * kb + r) * L::B_COLS + 4 * nb);
          }
        } else {
          // A's chunks of rounds [i0, i0 + A_BATCH) into w
          uint32_t w[L::A_BATCH][4];
          const auto load_a = [&](int i0) {
#pragma unroll
            for (int i = 0; i < L::A_BATCH; ++i) {
              int ra, ca;
              a_chunk(i0 + i, ra, ca);
              const int gm = m0 + ra, kk = k0 + ca;
              load_chunk(w[i], op.a + a_plane + static_cast<size_t>(gm) * k + kk, gm < m ? k - kk : 0, op.a_width);
            }
          };
          const auto store_a = [&](int i0) {
#pragma unroll
            for (int i = 0; i < L::A_BATCH; ++i) {
              int ra, ca;
              a_chunk(i0 + i, ra, ca);
              st_shared4(stage + swizzled<BK>(ra, ca), make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]));
            }
          };
          // the loads go out before the wait: they need no free stage
          load_a(0);
#pragma unroll
          for (int i = 0; i < L::B_ITERS; ++i) {
            int nb, kb;
            b_block(i, nb, kb);
            const int gn = n0 + b_col0 + 4 * nb;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int kk = k0 + 4 * kb + r;
              rb[i][r] = load_word(op.b + b_plane + static_cast<size_t>(kk) * n + gn, kk < k ? n - gn : 0, op.b_vec);
            }
          }
          // every block that reads stage s is done with slice j - ST
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
          store_a(0);
#pragma unroll
          for (int i0 = L::A_BATCH; i0 < L::A_ITERS; i0 += L::A_BATCH) {
            load_a(i0);
            store_a(i0);
          }
        }
        // B transposed to 4 k-contiguous columns a block
#pragma unroll
        for (int i = 0; i < L::B_ITERS; ++i) {
          int nb, kb;
          b_block(i, nb, kb);
          uint32_t wb[4];  // column j4 of the block: 4 consecutive k
          transpose4x4(rb[i], wb);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            st_shared(stage + L::A_TILE + swizzled<BK>(b_col0 + 4 * nb + j4, 4 * kb), wb[j4]);
          }
        }
        fence_proxy_async_shared();  // the tiles are read by bulk copies and wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(prepared(s));  // the slice is written
      }
    }
  } else {
    // ---------------------------------------------------------- the products
    if constexpr (L::MOVE_REGS) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(L::PRODUCT_REGS));
    const int g = wg - L::PREP_WGS;  // rows [64 g, 64 g + 64) of the block's tile
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    // Descriptors of the tiles in stage 0: K-major, 8-row groups 8 BK bytes
    // apart; a k32 step moves the start by 32 bytes (2 in the address
    // field), a stage by STAGE bytes.
    constexpr uint32_t SBO = 8 * BK;
    const uint64_t a0 = smem_desc(base + 64 * g * BK, 16, SBO, L::LAYOUT);
    const uint64_t b0 = smem_desc(base + L::A_TILE, 16, SBO, L::LAYOUT);

    // the blocks whose preparation writes into this block's stages: its
    // cluster row (A) and column (B)
    uint32_t writer[CN + CM - 1];
#pragma unroll
    for (int x = 0; x < CN; ++x) writer[x] = cluster_map(base, x + cy * CN);
#pragma unroll
    for (int y = 0; y < CM - 1; ++y) writer[CN + y] = cluster_map(base, cx + (y + (y >= cy)) * CN);
    const auto release = [&](int s) {  // this warp is done with stage s
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < CN + CM - 1; ++w) mbar_arrive_remote(writer[w] + (empty(s) - base));
      }
    };
    for (int t = 0; t < S; ++t) {
      const int s = t % ST;
      if (TMA) mbar_wait(loaded(s), (t / ST) & 1);
      mbar_wait(full(s), (t / ST) & 1);
      const uint64_t st = static_cast<uint64_t>(s * L::STAGE) >> 4;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < L::K32; ++q) wgmma_s8<BN>(acc, a0 + st + 2 * q, b0 + st + 2 * q);
      wgmma_commit();
      wgmma_wait<1>();  // slice t - 1's group has read its stage
      if (t > 0) release((t - 1) % ST);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release((S - 1) % ST);

    // epilogue: + carry, the canonical residue mod p, int8 store.  The
    // accumulator layout: lane (q, r) = (lane / 4, lane % 4) of warp w holds
    // rows 16 w + q (+ 8) and, of each 8-wide n block j, columns 8 j + 2 r
    // (+ 1)
    const int p = prm.p[plane];
    const size_t out0 = static_cast<size_t>(plane) * m * n;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = m0 + 64 * g + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (row < m && col < n) {
        const size_t idx = out0 + static_cast<size_t>(row) * n + col;
        int v = acc[i];
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
template <int BM, int BN, int BK, int ST, bool TMA>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n, int n_mod,
                      cudaStream_t stream) {
  using L = Layout<BM, BN, BK, ST, TMA>;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  return cluster_launch_config(cfg, cluster, int8_mod_gemm_kernel<BM, BN, BK, ST, TMA>, grid, L::THREADS,
                               L::BYTES, CN, CM, stream);
}

template <int BM, int BN, int BK, int ST, bool TMA>
int launch_path(const Operands& op, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  using L = Layout<BM, BN, BK, ST, TMA>;
  CUtensorMap maps[2] = {};
  if (TMA) {
    const CUtensorMapSwizzle sw = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (!tensor_map(&maps[0], op.a, k, m, n_mod, BK, BM, sw) ||
        !tensor_map(&maps[1], op.b, n, k, n_mod, L::B_COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BM, BN, BK, ST, TMA>(cfg, cluster, m, n, n_mod, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, int8_mod_gemm_kernel<BM, BN, BK, ST, TMA>, maps[0], maps[1], op, m, n, k, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int ST>
int launch(const Operands& op, bool tma, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  return tma ? launch_path<BM, BN, BK, ST, true>(op, n_mod, m, n, k, prm, s)
             : launch_path<BM, BN, BK, ST, false>(op, n_mod, m, n, k, prm, s);
}

}  // namespace

REPRO_USES_TMA_ENTRY

// The tiles: REPRO_TILE(BM, BN, BK, stages); the first is the default.
#define REPRO_TILES \
  REPRO_TILE(128, 128, 64, 8) \
  REPRO_TILE(128, 128, 128, 6) \
  REPRO_TILE(64, 128, 64, 6) \
  REPRO_TILE(128, 64, 64, 6)

extern "C" int int8_mod_gemm_launch(const void* a, const void* b, const void* carry, void* out, int n_mod, int m,
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
                       k % 16 == 0 && aligned(a, 16) ? 16 : k % 4 == 0 && aligned(a, 4) ? 4 : 1,
                       n % 4 == 0 && aligned(b, 4)};
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM_, BN_, BK_, ST_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<BM_, BN_, BK_, ST_>(op, tma, n_mod, m, n, k, prm, s);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
