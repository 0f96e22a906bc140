// Modulus-batched fused-Karatsuba residue GEMM: for every plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p)
//   CR = sym_mod(m(D) - m(E) (+ carry_R)), CI = sym_mod(m(F) - m(D) - m(E) (+ carry_I))
// with m() the symmetric mod by p_l.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/karatsuba_fused.py:60
// (`karatsuba_mod_gemm_batched`, :138).
//
// Bound on the H100: int8 tensor-core operations, 3 * 2 N m n k of them, at
// 1,979 TOP/s dense (4096^3 at N = 14: 2.917 ms).  Beside them the
// preparation of the operands (the sums mod p, B's transpose) takes issue
// slots and shared-memory bandwidth; as measured (PERF.md section 6) it,
// and not the tensor cores, sets the time a slice.
//
// Design (fp8_karatsuba.cu's skeleton on s8 wgmma).  A block owns a 64 x BN
// output tile of one plane (grid: n tiles, m tiles, planes) and walks K in
// BK-deep slices through a ring of ST stages; 640 threads in five
// warpgroups.
//  * Warpgroups 2-4 own one Karatsuba product each (D, E, F) and run it on
//    wgmma.m64n{BN}k32.s32.s8.s8, A and B from shared memory (8-bit wgmma
//    takes both K-major, the 64- or 128-byte swizzle by BK), accumulating
//    in int32 registers over all of K: |sum| <= 127^2 k < 2^31 for k <=
//    2^17, the wrapper's limit, so nothing is reduced or converted in the
//    loop.  One slice's wgmma group stays in flight while the next is
//    issued; a stage is released when its group has completed.
//  * Warpgroups 0-1 prepare.  Their first warp loads: one thread waits for
//    a stage to be free and brings AR and AI, (m, k) with k contiguous, by
//    TMA straight into the stage's swizzled K-major tiles (no thread
//    touches them), and the block's share of raw BR and BI, (k, n)
//    n-major, into the stage's raw slot, all on one mbarrier with
//    transaction bytes.  The next warp pushes (below).  The other six
//    warps form the A sum (AR+AI) mod p 16 bytes at a time on the swizzled
//    chunks (AR, AI and the sum tile share one swizzle, and a swizzle only
//    permutes 16-byte chunks, so nothing is unswizzled), and transpose the
//    raw B share into K-major swizzled BR and BI tiles (TMA cannot
//    transpose bytes), forming (BR+BI) mod p on the way.  The sums mod p
//    are exact integer arithmetic without division (`sum_mod_word`).  Each
//    warp runs on its own, synchronised by the ring's mbarriers alone; a
//    single thread that issued every load and copy between the preparing
//    threads' barriers held them up, polling or not (PERF.md section 6).
//  * B's preparation is shared by a CM x CN = 4 x 1 thread-block cluster:
//    the CM blocks of a cluster column multiply the same B columns, so
//    block cy prepares B columns [BN cy / CM, BN (cy + 1) / CM) of each
//    slice into its own stage, and the push warp's thread copies that
//    share into the same stage of each peer with cp.async.bulk (shared::cta
//    to shared::cluster), each copy completing the peer's "stage full"
//    mbarrier by its bytes.  The product warps release a stage by arriving
//    on the "stage empty" mbarrier of every block that writes into it; the
//    load warp waits on its own before it loads into the stage again.
//    Those arrivals and waits take the default, CTA-scope release and
//    acquire (`mbar_arrive_remote`): the order they carry is
//    write-after-read of reads that have completed.  The grid is padded to
//    whole clusters; a padding block prepares its share and stores no
//    output.
//  * Shapes TMA cannot map (k or n not a multiple of 16, or an operand not
//    16-byte aligned) take the second instantiation, in which the
//    preparing threads load A and their B share from global memory
//    themselves (4-byte words where k, n and the pointers allow it, else
//    bytes) once the stage is free.  Which one a launch takes depends on
//    shape and alignment alone (hopper.cuh's `uses_tma`); everything after
//    the load is the same.
//
// Epilogue (unchanged): each product warpgroup takes the exact symmetric
// mod of its accumulators; D and E pass theirs to F through shared memory,
// and F writes CR = D - E and CI = F - D - E (+ carry) mod p, masked at the
// ragged edge.  Every residue is the canonical one and int32 sums are exact
// in any order, so the output is bitwise karatsuba_mod_gemm_plain's.
#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int CM = 4, CN = 1;  // the cluster: CM blocks along m, CN along n
constexpr int BM = 64;         // the block's output rows (one wgmma m64 a product)
constexpr int PREP_WGS = 2;    // the preparing warpgroups: the load warp, the push warp, the preparing warps
constexpr int PREP_THREADS = 128 * PREP_WGS;
constexpr int COMPUTE_THREADS = PREP_THREADS - 64;  // the preparing warps
constexpr int THREADS = PREP_THREADS + 384;  // the preparing warpgroups, then the D, E and F warpgroups
// Registers a thread: LAUNCH_REGS at launch (the register file over the
// threads, in steps of 8), then setmaxnreg; the products' increase must be
// covered by what the preparing threads release.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PREP_REGS = 72, PRODUCT_REGS = 112;
static_assert(PREP_THREADS * (LAUNCH_REGS - PREP_REGS) >= 384 * (PRODUCT_REGS - LAUNCH_REGS), "the register pool");
constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use

// The shared memory of tile (BN, BK) with a ring of ST stages, each with its
// raw B slot.
template <int BN, int BK, int ST>
struct Layout {
  static constexpr int K32 = BK / 32;
  static constexpr int LAYOUT = BK == 128 ? 1 : 2;  // the descriptors' swizzle mode: 128 or 64 bytes
  static constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // one operand, [rows][BK]
  static constexpr int STAGE = 3 * (A_TILE + B_TILE);       // AR, AI, AS, then BR, BI, BS
  static constexpr int B_COLS = BN / CM;                    // the block's share of B's columns
  static constexpr int RAW_B = BK * B_COLS;                 // [BK][B_COLS] bytes, n contiguous
  static constexpr int RAW_STAGE = 2 * RAW_B;               // BR, BI
  static constexpr int A_CHUNKS = A_TILE / 16, B_BLOCKS = (B_COLS / 4) * (BK / 4);  // 16-byte A chunks, 4 x 4 B blocks
  static constexpr int A_ITERS = (A_CHUNKS + COMPUTE_THREADS - 1) / COMPUTE_THREADS;  // rounds of the preparing threads
  static constexpr int B_ITERS = (B_BLOCKS + COMPUTE_THREADS - 1) / COMPUTE_THREADS;
  // B blocks start with the threads that have one A chunk fewer
  static constexpr int B_SHIFT = COMPUTE_THREADS - A_CHUNKS % COMPUTE_THREADS;
  static constexpr int RAW_OFF = ST * STAGE;
  static constexpr int XCHG_OFF = RAW_OFF + ST * RAW_STAGE;  // D and E residues for the epilogue
  static constexpr int BAR_OFF = XCHG_OFF + 2 * BM * BN;     // 4 ST mbarriers
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * 4 * ST;  // 1024: alignment of the swizzle atoms
  // the prepared B bytes a block receives from its peers a slice
  static constexpr int INCOMING = 3 * (CM - 1) * B_COLS * BK;
  static_assert(BK == 64 || BK == 128, "one swizzle row a slice");
  static_assert(BN == 64 || BN == 128, "a wgmma n the kernel spells out");
  static_assert(ST >= 3, "a ring of at least three stages");
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

// ---- the sums mod p, without division ---------------------------------------
// For int8 x and y, v = x + y lies in [-256, 254].  With t = v + K p (K p >=
// 256, so t >= 0) and q = floor((t + h) / p), h = (p - 1) / 2, the residue
// r = t - q p = ((v + h) mod p) - h is the canonical one, |r| <= h, for any
// odd p.  q is a multiply-high: with M = ceil(2^32 / p), (t + h) M / 2^32
// exceeds (t + h) / p by less than (t + h) / 2^32 < 1 / p, so its floor is
// exact (t + h < 1024).  The biased bytes x ^ 0x80 = x + 128 give t = (x ^
// 0x80) + (y ^ 0x80) + (K p - 256).  tests/test_torch_int8_schedule.py
// runs this op sequence in numpy for every pair of bytes and every modulus.

struct SumMod {
  uint32_t p, bias, m;  // p, K p - 256, M
  uint64_t hm;          // h M
};

__device__ __forceinline__ SumMod sum_mod_of(int p) {
  SumMod sm;
  sm.p = static_cast<uint32_t>(p);
  sm.bias = static_cast<uint32_t>((256 + p - 1) / p * p - 256);
  sm.m = 0xFFFFFFFFu / sm.p + 1;  // ceil(2^32 / p): p is odd, so it does not divide 2^32
  sm.hm = static_cast<uint64_t>((p - 1) >> 1) * sm.m;
  return sm;
}

// Per byte, the canonical (x_b + y_b) mod p of two words of four int8 values.
__device__ __forceinline__ uint32_t sum_mod_word(uint32_t x, uint32_t y, const SumMod& sm) {
  const uint32_t ux = x ^ 0x80808080u, uy = y ^ 0x80808080u;
  uint32_t r[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t t = __byte_perm(ux, 0, 0x4440 + b) + __byte_perm(uy, 0, 0x4440 + b) + sm.bias;
    const uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(t) * sm.m + sm.hm) >> 32);
    r[b] = t - q * sm.p;  // the residue's two's-complement bits; its low byte is the int8
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

__device__ __forceinline__ uint4 sum_mod_chunk(uint4 x, uint4 y, const SumMod& sm) {
  return make_uint4(sum_mod_word(x.x, y.x, sm), sum_mod_word(x.y, y.y, sm), sum_mod_word(x.z, y.z, sm),
                    sum_mod_word(x.w, y.w, sm));
}

template <int BN, int BK, int ST, bool TMA>
__global__ void __launch_bounds__(THREADS, 1) karatsuba_kernel(
    const __grid_constant__ CUtensorMap tm_ar, const __grid_constant__ CUtensorMap tm_ai,
    const __grid_constant__ CUtensorMap tm_br, const __grid_constant__ CUtensorMap tm_bi,
    const Operands op, int m, int n, int k, const __grid_constant__ ModParams prm) {
  using L = Layout<BN, BK, ST>;
  extern __shared__ uint4 smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  int8_t* const gbase = reinterpret_cast<int8_t*>(smem_raw) + (base - smem_addr(smem_raw));
  const uint32_t raw0 = base + L::RAW_OFF, bar0 = base + L::BAR_OFF;
  // the ring's barriers, by stage: AR, AI and the raw B share loaded by TMA;
  // the block's share prepared by every preparing warp; the stage complete
  // (this block's share, and the peers' by bulk copy); the stage read (by
  // every block whose share it holds, and so its raw slot by every
  // preparing warp, which the products wait for)
  const auto loaded = [&](int s) { return bar0 + 8 * s; };
  const auto prepared = [&](int s) { return bar0 + 8 * (ST + s); };
  const auto full = [&](int s) { return bar0 + 8 * (2 * ST + s); };
  const auto empty = [&](int s) { return bar0 + 8 * (3 * ST + s); };
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, plane = blockIdx.z;
  const int p = prm.p[plane];
  const int S = k > BK ? (k + BK - 1) / BK : 1;  // K slices
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(loaded(s), 1);                       // the load warp, with the TMA bytes
      mbar_init(prepared(s), COMPUTE_THREADS / 32);  // each preparing warp
      mbar_init(full(s), 1);                         // the push warp, with the bytes the peers send
      mbar_init(empty(s), 4 * 3 * (CN + CM - 1));    // each product warp of each reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster has started: its barriers may be reached
  cluster_wait();

  if (wg < PREP_WGS) {
    // ------------------------------------------------------ the preparation
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PREP_REGS));
    const int b_col0 = cy * L::B_COLS;  // the block's share of B in its tile
    if (threadIdx.x < 64) {
      // Two producer threads, each waiting on one barrier a slice in the
      // ring's order: the load warp issues every TMA load, the push warp
      // every bulk copy, so that no preparing warp waits on either.
      if (TMA && threadIdx.x == 0) {
        for (int j = 0; j < S; ++j) {
          // every reader is done with the stage's last slice, and so every
          // preparing warp with its raw slot (a fresh barrier passes the
          // wait on parity 1)
          const int s = j % ST;
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
          const uint32_t stage = base + s * L::STAGE, slot = raw0 + s * L::RAW_STAGE;
          mbar_expect_tx(loaded(s), 2 * L::A_TILE + L::RAW_STAGE);
          tma_load(stage, tm_ar, loaded(s), j * BK, m0, plane);
          tma_load(stage + L::A_TILE, tm_ai, loaded(s), j * BK, m0, plane);
          tma_load(slot, tm_br, loaded(s), n0 + b_col0, j * BK, plane);
          tma_load(slot + L::RAW_B, tm_bi, loaded(s), n0 + b_col0, j * BK, plane);
        }
      } else if (threadIdx.x == 32) {
        // this block's B share goes to the blocks of its cluster column
        uint32_t b_peer[CM];
#pragma unroll
        for (int y = 0; y < CM; ++y) b_peer[y] = cluster_map(base, cx + y * CN);
        for (int j = 0; j < S; ++j) {
          // slice j prepared: the peers' shares are expected, and this
          // block's share goes to the peers that read it
          const int s = j % ST;
          mbar_wait(prepared(s), (j / ST) & 1);
          mbar_expect_tx(full(s), L::INCOMING);
#pragma unroll
          for (int y = 0; y < CM; ++y) {
            if (y == cy) continue;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const uint32_t off = s * L::STAGE + 3 * L::A_TILE + q * L::B_TILE + b_col0 * BK;
              bulk_copy_cluster(b_peer[y] + off, base + off, L::B_COLS * BK, b_peer[y] + (full(s) - base));
            }
          }
        }
      }
      __syncwarp();
    } else {
      // The preparing warps: the A sum and this block's B share of every
      // slice, each warp on its own, synchronised by the barriers alone.
      const int ct = threadIdx.x - 64;
      const SumMod sm = sum_mod_of(p);
      const size_t a_plane = static_cast<size_t>(plane) * m * k, b_plane = static_cast<size_t>(plane) * k * n;
      for (int j = 0; j < S; ++j) {
        const int s = j % ST;
        const uint32_t stage = base + s * L::STAGE;
        const uint32_t slot = raw0 + s * L::RAW_STAGE;
        const int k0 = j * BK;
        if (TMA) {
          mbar_wait(loaded(s), (j / ST) & 1);  // and so the stage is free: the load warp waited for it
        } else {
          // every block that reads stage s is done with slice j - ST
          mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
        }
        // A: the sum tile, one 16-byte chunk a round, at the chunk's own
        // (swizzled) place; without TMA, AR and AI are stored there too
#pragma unroll
        for (int i = 0; i < L::A_ITERS; ++i) {
          const int c = ct + COMPUTE_THREADS * i;
          if (L::A_CHUNKS % COMPUTE_THREADS != 0 && c >= L::A_CHUNKS) break;
          uint4 xr, xi;
          uint32_t at;
          if (TMA) {
            at = 16 * c;
            xr = ld_shared4(stage + at);
            xi = ld_shared4(stage + L::A_TILE + at);
          } else {
            const int ra = c / (BK / 16), ca = (c % (BK / 16)) * 16;
            const int gm = m0 + ra, kk = k0 + ca;
            const size_t off = a_plane + static_cast<size_t>(gm) * k + kk;
            uint32_t wr[4], wi[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int valid = gm < m ? k - kk - 4 * w : 0;
              wr[w] = load_word(op.ar + off + 4 * w, valid, op.a_vec);
              wi[w] = load_word(op.ai + off + 4 * w, valid, op.a_vec);
            }
            xr = make_uint4(wr[0], wr[1], wr[2], wr[3]);
            xi = make_uint4(wi[0], wi[1], wi[2], wi[3]);
            at = swizzled<BK>(ra, ca);
            st_shared4(stage + at, xr);
            st_shared4(stage + L::A_TILE + at, xi);
          }
          st_shared4(stage + 2 * L::A_TILE + at, sum_mod_chunk(xr, xi, sm));
        }
        // B: a 4(k) x 4(n) block a round, transposed to 4 k-contiguous columns
#pragma unroll
        for (int i = 0; i < L::B_ITERS; ++i) {
          const int b = (ct + L::B_SHIFT) % COMPUTE_THREADS + COMPUTE_THREADS * i;
          if (L::B_BLOCKS % COMPUTE_THREADS != 0 && b >= L::B_BLOCKS) break;
          const int nb = b % (L::B_COLS / 4), kb = b / (L::B_COLS / 4);
          uint32_t rr[4], ri[4];
          if (TMA) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              rr[r] = ld_shared(slot + (4 * kb + r) * L::B_COLS + 4 * nb);
              ri[r] = ld_shared(slot + L::RAW_B + (4 * kb + r) * L::B_COLS + 4 * nb);
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
            const uint32_t dst = stage + 3 * L::A_TILE + swizzled<BK>(b_col0 + 4 * nb + j4, 4 * kb);
            st_shared(dst, wr[j4]);
            st_shared(dst + L::B_TILE, wi[j4]);
            st_shared(dst + 2 * L::B_TILE, sum_mod_word(wr[j4], wi[j4], sm));
          }
        }
        fence_proxy_async_shared();  // the prepared tiles are read by bulk copies and wgmma
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(prepared(s));  // this warp's share of the slice is written
      }
    }
  } else {
    // ---------------------------------------------------------- the products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PRODUCT_REGS));
    const int g = wg - PREP_WGS;  // 0: D = AR.BR, 1: E = AI.BI, 2: F = AS.BS
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    // Descriptors of this product's tiles in stage 0: K-major, 8-row groups
    // 8 BK bytes apart; a k32 step moves the start by 32 bytes (2 in the
    // address field), a stage by STAGE bytes.
    constexpr uint32_t SBO = 8 * BK;
    const uint64_t a0 = smem_desc(base + g * L::A_TILE, 16, SBO, L::LAYOUT);
    const uint64_t b0 = smem_desc(base + 3 * L::A_TILE + g * L::B_TILE, 16, SBO, L::LAYOUT);

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

    // epilogue: this product's canonical residues, in place
    int* const res = acc;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) res[i] = sym_mod_i32(acc[i], p);
    // the accumulator layout: lane (q, r) = (lane / 4, lane % 4) of warp w
    // holds rows 16 w + q (+ 8) and, of each 8-wide n block j, columns 8 j +
    // 2 r (+ 1)
    const auto row_of = [&](int i) { return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1); };
    const auto col_of = [&](int i) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); };
    int8_t* xchg = gbase + L::XCHG_OFF;
    if (g < 2) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) xchg[g * BM * BN + row_of(i) * BN + col_of(i)] = static_cast<int8_t>(res[i]);
    }
    asm volatile("bar.sync 1, 384;" ::: "memory");  // the three product warpgroups
    if (g == 2) {
      const size_t out0 = static_cast<size_t>(plane) * m * n;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
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
template <int BN, int BK, int ST, bool TMA>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n, int n_mod,
                      cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_mod);
  return cluster_launch_config(cfg, cluster, karatsuba_kernel<BN, BK, ST, TMA>, grid, THREADS,
                               Layout<BN, BK, ST>::BYTES, CN, CM, stream);
}

template <int BN, int BK, int ST, bool TMA>
int launch_path(const Operands& op, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  using L = Layout<BN, BK, ST>;
  CUtensorMap maps[4] = {};
  if (TMA) {
    const CUtensorMapSwizzle sw = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (!tensor_map(&maps[0], op.ar, k, m, n_mod, BK, BM, sw) ||
        !tensor_map(&maps[1], op.ai, k, m, n_mod, BK, BM, sw) ||
        !tensor_map(&maps[2], op.br, n, k, n_mod, L::B_COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensor_map(&maps[3], op.bi, n, k, n_mod, L::B_COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<BN, BK, ST, TMA>(cfg, cluster, m, n, n_mod, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, karatsuba_kernel<BN, BK, ST, TMA>, maps[0], maps[1], maps[2], maps[3], op, m,
                           n, k, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int BK, int ST>
int launch(const Operands& op, bool tma, int n_mod, int m, int n, int k, const ModParams& prm, cudaStream_t s) {
  return tma ? launch_path<BN, BK, ST, true>(op, n_mod, m, n, k, prm, s)
             : launch_path<BN, BK, ST, false>(op, n_mod, m, n, k, prm, s);
}

}  // namespace

REPRO_USES_TMA_ENTRY

// The tiles: REPRO_TILE(BM, BN, BK, stages); the first is the default.
#define REPRO_TILES \
  REPRO_TILE(64, 128, 64, 4) \
  REPRO_TILE(64, 64, 64, 4) \
  REPRO_TILE(64, 64, 128, 3)

extern "C" int karatsuba_mod_gemm_launch(const void* ar, const void* ai, const void* br,
                                         const void* bi, const void* carry_r,
                                         const void* carry_i, void* out_r, void* out_i,
                                         int n_mod, int m, int n, int k, int bm, int bn, int bk,
                                         const int* moduli, void* stream) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI || m < 0 || n < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  ModParams prm;
  for (int l = 0; l < n_mod; ++l) {
    if (moduli[l] < 3 || moduli[l] > 255 || moduli[l] % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
    prm.p[l] = moduli[l];
  }
  const bool tma = uses_tma(ar, ai, br, bi, n, k);
  const Operands op = {static_cast<const int8_t*>(ar),      static_cast<const int8_t*>(ai),
                       static_cast<const int8_t*>(br),      static_cast<const int8_t*>(bi),
                       static_cast<const int8_t*>(carry_r), static_cast<const int8_t*>(carry_i),
                       static_cast<int8_t*>(out_r),         static_cast<int8_t*>(out_i),
                       k % 4 == 0 && aligned(ar, 4) && aligned(ai, 4),
                       n % 4 == 0 && aligned(br, 4) && aligned(bi, 4)};
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM_, BN_, BK_, ST_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<BN_, BK_, ST_>(op, tma, n_mod, m, n, k, prm, s);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}
