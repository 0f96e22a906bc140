// The one-launch real megakernel: C = A @ B emulated end to end.  For one
// BM x BN output tile it casts the f32 operand tiles to residues, runs the N
// int8 plane products with the K-chunk reduction inside, and reconstructs
// the tile by Garner with exact inverse scaling.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/int8_mod_gemm.py:162 (`fused_mod_gemm`, :303).
//
// Bound on the H100: int8 tensor-core operations, 2 N m n k of them at
// 1,979 TOP/s dense (4096^3 at N = 8: 0.556 ms); the f32 operands and the
// output, 4 (m k + k n + m n) bytes, take less at 3.35 TB/s.  What limits
// it is the cast: every raw value is cast once per plane and per cluster
// of output tiles that reads it, some 20 f32 operations a cast against
// 1/64 of an mma.sync.
//
// Design (fused_karatsuba.cu's, for one operand a side).  The plane loop
// stays outside the K loop: the TPU kernel keeps all N planes' int32
// accumulators, an (N, 256, 256) block of VMEM, across its K grid axis;
// here one plane's accumulators live in registers and only the canonical
// int8 residue of each finished plane is stashed in shared memory, N BM BN
// bytes (96 KB at N = 24 for the default 64 x 64 tile, 192 KB for the
// other, 128 x 64; `kernels/common.COMPILED_TILES`).  Three things make
// the cast cheap:
//  1. The cast is residue_fma.cuh's: no integer division, the plane's
//     constants in registers, residues packed to bytes by the f32 shifter.
//  2. The blocks of a CM x CN = 4 x 2 thread-block cluster share it.  The
//     CN blocks of a cluster row read the same A rows, the CM blocks of a
//     cluster column the same B columns.  Of each K slice, block (cx, cy)
//     casts the A rows [cx BM/CN, (cx+1) BM/CN) and the B columns
//     [cy BN/CM, (cy+1) BN/CM) into its own staging, and its first thread
//     pushes each share to the peers that read it with one cp.async.bulk
//     (shared::cta to shared::cluster) that completes the peer's "stage
//     full" mbarrier by its bytes.  A block's warps release a staging
//     buffer by arriving on the "stage empty" mbarrier of every block that
//     wrote into it, with the default CTA-scope release
//     (`mbar_arrive_remote`); a block waits on its own before it casts
//     into the buffer again.  (On the H100 at 4096^3, N = 8, 4 x 2 ran faster than
//     2 x 4, 2 x 2 and no cluster, and the bulk copies faster than every
//     thread storing into its peers' staging with a cluster barrier a
//     slice: PERF.md section 6.)  The grid is padded to whole clusters; a
//     padding block casts its share and synchronises, and stores no
//     output (its rows or columns lie outside C).
//  3. The staging is double-buffered: slice t + 1 is cast into one buffer
//     while slice t is multiplied from the other (every compiled tile has
//     room for two beside the stash of N = 24: 196,608 + 2 x 15,360 B for
//     128 x 64).  The planes run back to back in one flattened loop, so the
//     pipeline does not drain at a plane boundary.
// Products: s8 mma.sync (gemm_tiles.cuh) from the padded [rows][LDS]
// staging; every `chunk_steps` K steps the accumulators are reduced by the
// exact int32 symmetric mod (the reference's in-kernel chunk reduction,
// int8_mod_gemm.py:217-225), so any k stays exact.  A prepared operand's
// int8 plane l is loaded as it is instead of cast, and shared the same way.
// The epilogue runs Garner (`garner_tile.cuh`) on the stash, one thread per
// output element, and applies the inverse scaling.
//
// Bits.  Every residue is the unique canonical one (residue_fma.cuh), the
// int32 products and sums are exact in any order (|acc| < 2^31 between
// chunk reductions), and the stash and Garner are as in the 4-launch path:
// the output equals fused_mod_gemm_plain and the 4-launch cast/product/
// Garner composition bit for bit, whichever block cast a value.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"
#include "residue_fma.cuh"

namespace {

constexpr int CM = 4, CN = 2;       // the cluster: CM blocks along m, CN along n
constexpr int SMEM_MAX = 232448;    // the dynamic shared memory a block may use

struct Operands {
  const float* a;        // (m, k) f32
  const float* sa1;      // (m,) row scale factors
  const float* sa2;
  const float* b;        // (k, n) f32, or null when prepared
  const int8_t* b_res;   // (N, k, n) int8 planes, or null
  const float* sb1;      // (n,) column scale factors, or null when prepared
  const float* sb2;
  const float* r1;       // (m,) inverse scale factors
  const float* r2;
  const float* c1;       // (n,)
  const float* c2;
  float* out;            // (m, n) f32, or (2, m, n) double-single
};

__host__ __device__ constexpr int min_of(int a, int b) { return a < b ? a : b; }

// The staging of one K slice, shared by a cluster, and who casts what.
template <class T>
struct Stage {
  static constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS;
  static constexpr int A_BYTES = BM * LDS, B_BYTES = BN * LDS;  // [rows][LDS] tiles: A, then B
  static constexpr int BYTES = A_BYTES + B_BYTES;
  // A: the block's A_ROWS rows, all BK columns; A_SEG consecutive k of a
  // row a thread and round, A_ROUNDS rounds
  static constexpr int A_ROWS = BM / CN, A_VALS = A_ROWS * BK;
  static constexpr int A_SEG = min_of(16, A_VALS / T::THREADS), A_SPR = BK / A_SEG;
  static constexpr int A_ROUNDS = A_VALS / (T::THREADS * A_SEG);
  // B: the block's B_COLS columns, all BK rows; B_SEG consecutive k of a
  // column a thread and round (neighbouring threads, neighbouring columns)
  static constexpr int B_COLS = BN / CM, B_VALS = B_COLS * BK;
  static constexpr int B_SEG = min_of(16, B_VALS / T::THREADS);
  static constexpr int B_ROUNDS = B_VALS / (T::THREADS * B_SEG);
  // the bytes a block receives from its peers a slice
  static constexpr int INCOMING = (CN - 1) * A_ROWS * LDS + (CM - 1) * B_COLS * LDS;
  static_assert(A_SEG % 4 == 0 && A_ROUNDS * T::THREADS * A_SEG == A_VALS, "A share");
  static_assert(B_SEG % 4 == 0 && B_ROUNDS * T::THREADS * B_SEG == B_VALS, "B share");
};

// Two staging buffers where they fit beside the largest stash of NMAX.
template <class T, int NMAX>
__host__ __device__ constexpr int stages() {
  return NMAX * T::BM * T::BN + 2 * Stage<T>::BYTES <= SMEM_MAX ? 2 : 1;
}

// The staging buffers, the stash of n_mod planes, then 2 mbarriers a buffer.
template <class T, int NMAX>
__host__ __device__ constexpr int smem_bytes(int n_mod) {
  return stages<T, NMAX>() * Stage<T>::BYTES + n_mod * T::BM * T::BN + 16 * stages<T, NMAX>();
}

// The launch bound: the blocks an SM holds by the shared memory of the
// largest N (228 KB an SM, 1 KB of it reserved a block), between 2 and 4,
// so that the registers do not hold the occupancy below what the shared
// memory allows, and a thread may use up to 128 of them (64 at 4 blocks).
template <class T, int NMAX>
__host__ __device__ constexpr int min_blocks() {
  constexpr int by_smem = 233472 / (smem_bytes<T, NMAX>(NMAX) + 1024);
  return by_smem < 2 ? 2 : by_smem > 4 ? 4 : by_smem;
}

// SEG values of row `r`, columns [c, c + SEG); zeros outside (rows, cols).
template <int SEG, bool VEC>
__device__ __forceinline__ void load_row(const float* X, int rows, int cols, int r, int c,
                                         float (&v)[SEG]) {
#pragma unroll
  for (int q = 0; q < SEG; ++q) v[q] = 0.0f;
  if (r >= rows) return;
  const float* src = X + static_cast<size_t>(r) * cols + c;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < SEG / 4; ++q) {
      if (c + 4 * q < cols) {
        const float4 f = *reinterpret_cast<const float4*>(src + 4 * q);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < SEG; ++q) {
      if (c + q < cols) v[q] = src[q];
    }
  }
}

// SEG values of column `c`, rows [r, r + SEG); zeros outside (rows, cols).
template <int SEG, class V>
__device__ __forceinline__ void load_col(const V* X, int rows, int cols, int r, int c, V (&v)[SEG]) {
#pragma unroll
  for (int q = 0; q < SEG; ++q) {
    v[q] = (c < cols && r + q < rows) ? X[static_cast<size_t>(r + q) * cols + c] : V(0);
  }
}

// Store W packed words (4 W bytes, 4 W-byte aligned) into this block's shared memory.
template <int W>
__device__ __forceinline__ void st_local_words(int8_t* p, const uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) reinterpret_cast<uint32_t*>(p)[j] = w[j];
  }
}

template <class T, int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(T::THREADS, (min_blocks<T, NMAX>())) fused_mod_gemm_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  using S = Stage<T>;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS, STAGES = stages<T, NMAX>(), WARPS = THREADS / 32;
  extern __shared__ __align__(16) int8_t smem[];  // STAGES staging buffers, the stash, the barriers
  int8_t* stash = smem + STAGES * S::BYTES;        // [N][BM * BN]
  const int N = cp.n_mod, n_limbs = cp.n_limbs;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> T::WN_LOG2) * T::WTM, wn = (warp & (T::WARPS_N - 1)) * T::WTN;
  const uint32_t base = smem_addr(smem);
  // "stage full" (this block's cast and its peers' copies) and "stage
  // empty" (read by every block that reads the block's share) barriers
  const uint32_t bar0 = base + STAGES * S::BYTES + N * (BM * BN);
  const auto full = [&](int s) { return bar0 + 8 * s; };
  const auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };

  // this thread's share of a slice, round r: A row a_row[r] (in the tile)
  // at k = a_k[r]..+A_SEG-1, and B column b_col[r] at k = b_k[r]..+B_SEG-1
  int a_row[S::A_ROUNDS], a_k[S::A_ROUNDS], b_col[S::B_ROUNDS], b_k[S::B_ROUNDS];
  float scale_a[S::A_ROUNDS], scale_b[S::B_ROUNDS];
#pragma unroll
  for (int r = 0; r < S::A_ROUNDS; ++r) {
    const int c = tid + r * THREADS;
    a_row[r] = cx * S::A_ROWS + c / S::A_SPR;
    a_k[r] = (c % S::A_SPR) * S::A_SEG;
    const int ga = m0 + a_row[r];
    scale_a[r] = ga < m ? op.sa1[ga] * op.sa2[ga] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < S::B_ROUNDS; ++r) {
    const int c = tid + r * THREADS;
    b_col[r] = cy * S::B_COLS + c % S::B_COLS;
    b_k[r] = (c / S::B_COLS) * S::B_SEG;
    const int gb = n0 + b_col[r];
    scale_b[r] = (!PREPARED && gb < n) ? op.sb1[gb] * op.sb2[gb] : 0.0f;
  }

  float ra[S::A_ROUNDS][S::A_SEG];
  float rb[S::B_ROUNDS][S::B_SEG];
  int8_t qb[S::B_ROUNDS][S::B_SEG];
  auto load = [&](int l, int k0) {
#pragma unroll
    for (int r = 0; r < S::A_ROUNDS; ++r) load_row<S::A_SEG, VEC>(op.a, m, k, m0 + a_row[r], k0 + a_k[r], ra[r]);
#pragma unroll
    for (int r = 0; r < S::B_ROUNDS; ++r) {
      if (PREPARED) {
        load_col<S::B_SEG>(op.b_res + static_cast<size_t>(l) * k * n, k, n, k0 + b_k[r], n0 + b_col[r], qb[r]);
      } else {
        load_col<S::B_SEG>(op.b, k, n, k0 + b_k[r], n0 + b_col[r], rb[r]);
      }
    }
  };

  // cast the loaded share with plane constants `pc` into this block's
  // staging buffer `buf`
  auto cast_store = [&](int buf, const PlaneCast& pc) {
#pragma unroll
    for (int r = 0; r < S::A_ROUNDS; ++r) {
      uint32_t w[S::A_SEG / 4];
#pragma unroll
      for (int j = 0; j < S::A_SEG / 4; ++j) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = residue_fma(ra[r][4 * j + q], scale_a[r], n_limbs, pc);
        w[j] = pack4_residues(v);
      }
      st_local_words(smem + buf * S::BYTES + a_row[r] * LDS + a_k[r], w);
    }
#pragma unroll
    for (int r = 0; r < S::B_ROUNDS; ++r) {
      uint32_t w[S::B_SEG / 4];
#pragma unroll
      for (int j = 0; j < S::B_SEG / 4; ++j) {
        if (PREPARED) {
          w[j] = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) w[j] |= static_cast<uint32_t>(static_cast<uint8_t>(qb[r][4 * j + q])) << (8 * q);
        } else {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = residue_fma(rb[r][4 * j + q], scale_b[r], n_limbs, pc);
          w[j] = pack4_residues(v);
        }
      }
      st_local_words(smem + buf * S::BYTES + S::A_BYTES + b_col[r] * LDS + b_k[r], w);
    }
  };

  // push this block's share of buffer `buf` to the peers that read it,
  // completing its bytes of each peer's "stage full" barrier (one thread)
  auto push_share = [&](int buf) {
    const uint32_t a_off = buf * S::BYTES + cx * S::A_ROWS * LDS;
    const uint32_t b_off = buf * S::BYTES + S::A_BYTES + cy * S::B_COLS * LDS;
#pragma unroll
    for (int x = 0; x < CN; ++x) {
      if (x == cx) continue;
      const uint32_t peer = cluster_map(base, x + cy * CN);
      bulk_copy_cluster(peer + a_off, base + a_off, S::A_ROWS * LDS, peer + (full(buf) - base));
    }
#pragma unroll
    for (int y = 0; y < CM; ++y) {
      if (y == cy) continue;
      const uint32_t peer = cluster_map(base, cx + y * CN);
      bulk_copy_cluster(peer + b_off, base + b_off, S::B_COLS * LDS, peer + (full(buf) - base));
    }
  };

  // the slices run plane by plane, S_K of them a plane, total in all; the
  // next slice to load is (ld_l, ld_s)
  const int S_K = k > BK ? (k + BK - 1) / BK : 1;
  const int total = N * S_K;
  int ld_l = 0, ld_s = 0;
  auto load_next = [&]() {
    load(ld_l, ld_s * BK);
    if (++ld_s == S_K) ld_s = 0, ++ld_l;
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                        // this block's thread 0, with the peers' bytes
      mbar_init(empty(s), WARPS * (CN + CM - 1));   // each warp of each block that reads the share
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster has started: its shared memory may be written
  cluster_wait();
  // the blocks whose shares this block reads (its cluster row and column)
  uint32_t writer[CN + CM - 1];
#pragma unroll
  for (int x = 0; x < CN; ++x) writer[x] = cluster_map(base, x + cy * CN);
#pragma unroll
  for (int y = 0; y < CM - 1; ++y) writer[CN + y] = cluster_map(base, cx + (y + (y >= cy)) * CN);
  load_next();
  PlaneCast pc;
  int l = 0, s = 0, p = cp.pi[0];  // the slice being multiplied, and its modulus
  // step t multiplies slice t and casts slice t + 1; step -1 only casts
  // slice 0 (one call site, so the cast is inlined)
  for (int t = -1; t < total; ++t) {
    if (t >= 0) {
      const int buf = t % STAGES;
      mbar_wait(full(buf), (t / STAGES) & 1);
      const int8_t* cur = smem + buf * S::BYTES;
      warp_tile_mma<MT, NT, BK>(acc, cur, cur + S::A_BYTES, wm, wn, lane);
      __syncwarp();
      if (lane == 0) {  // this warp is done with the buffer: release it to its writers
#pragma unroll
        for (int w = 0; w < CN + CM - 1; ++w) mbar_arrive_remote(writer[w] + (empty(buf) - base));
      }
    }
    if (t + 1 < total) {
      const int buf = (t + 1) % STAGES;
      if (t < 0 || s + 1 == S_K) pc = plane_cast(cp, t < 0 ? 0 : l + 1);
      // every reader of this block's share is done with the buffer's last
      // slice (a fresh barrier passes the wait on parity 1)
      mbar_wait(empty(buf), (((t + 1) / STAGES) & 1) ^ 1);
      cast_store(buf, pc);
      fence_proxy_async_shared();  // the share is read by bulk copies
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(full(buf), S::INCOMING);
        push_share(buf);
      }
    }
    if (t >= 0 && s + 1 == S_K) {
      // the plane is done: its canonical residue into the stash
      int8_t* st = stash + l * (BM * BN);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = wm + mt * 16 + (lane >> 2) + (c >> 1) * 8;
            const int col = wn + nt * 8 + (lane & 3) * 2 + (c & 1);
            st[row * BN + col] = static_cast<int8_t>(sym_mod_i32(acc[mt][nt][c], p));
            acc[mt][nt][c] = 0;
          }
        }
      }
    } else if (t >= 0 && (s + 1) % chunk_steps == 0) {
      // in-kernel K-chunk reduction: keeps the int32 sums exact for any k
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = sym_mod_i32(acc[mt][nt][c], p);
    }
    if (t + 2 < total) load_next();
    if (t >= 0 && ++s == S_K) {
      s = 0;
      if (++l < N) p = cp.pi[l];
    }
  }
  // no block leaves while a peer may still write into it or arrive on its
  // barriers; and every stash write is ordered before the epilogue's reads
  cluster_arrive();
  cluster_wait();

  // epilogue: Garner + inverse scaling, one thread per output element, one
  // element at a time (the N = 24 instantiation's digits fill the registers)
  const size_t mn = static_cast<size_t>(m) * n;
#pragma unroll 1
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gi = m0 + e / BN, gj = n0 + e % BN;
    if (gi >= m || gj >= n) continue;
    float d[NMAX];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) {
      if (t < gp.n_mod) d[t] = static_cast<float>(stash[t * (BM * BN) + e]);
    }
    const DS v = garner_value<NMAX>(d, gp);
    const float rr = op.r1[gi] * op.r2[gi];
    const float cc = op.c1[gj] * op.c2[gj];
    const size_t o = static_cast<size_t>(gi) * n + gj;
    if (out_dd) {
      op.out[o] = (v.hi * rr) * cc;
      op.out[mn + o] = (v.lo * rr) * cc;
    } else {
      op.out[o] = ((v.hi + v.lo) * rr) * cc;
    }
  }
}

// The launch configuration: the grid padded to whole CM x CN clusters.
template <class T, int NMAX, bool PREPARED, bool VEC>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n,
                      int n_mod, cudaStream_t stream) {
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  return cluster_launch_config(cfg, cluster, fused_mod_gemm_kernel<T, NMAX, PREPARED, VEC>, grid,
                               T::THREADS, smem_bytes<T, NMAX>(n_mod), CN, CM, stream);
}

template <class T, int NMAX, bool PREPARED, bool VEC>
int launch(const Operands& op, int m, int n, int k, int chunk_limit, int out_dd,
           const CastParams& cp, const GarnerParams& gp, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<T, NMAX, PREPARED, VEC>(cfg, cluster, m, n, cp.n_mod, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk_steps = chunk_limit / T::BK > 1 ? chunk_limit / T::BK : 1;
  err = cudaLaunchKernelEx(&cfg, fused_mod_gemm_kernel<T, NMAX, PREPARED, VEC>, op, m, n, k,
                           chunk_steps, out_dd, cp, gp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int NMAX>
int dispatch(const Operands& op, bool prepared, bool vec, int m, int n, int k, int chunk_limit,
             int out_dd, const CastParams& cp, const GarnerParams& gp, cudaStream_t s) {
  if (prepared) {
    return vec ? launch<T, NMAX, true, true>(op, m, n, k, chunk_limit, out_dd, cp, gp, s)
               : launch<T, NMAX, true, false>(op, m, n, k, chunk_limit, out_dd, cp, gp, s);
  }
  return vec ? launch<T, NMAX, false, true>(op, m, n, k, chunk_limit, out_dd, cp, gp, s)
             : launch<T, NMAX, false, false>(op, m, n, k, chunk_limit, out_dd, cp, gp, s);
}

template <class T>
int dispatch_n(const Operands& op, bool prepared, bool vec, int m, int n, int k, int chunk_limit,
               int out_dd, const CastParams& cp, const GarnerParams& gp, cudaStream_t s) {
  const int nm = cp.n_mod;
  if (nm <= 8) return dispatch<T, 8>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
  if (nm <= 16) return dispatch<T, 16>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
  return dispatch<T, 24>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, gp, s);
}

// The cluster of the raw-B, vector-load launch of tile T at N moduli:
// info = {CM, CN, the most clusters the card holds at once, shared bytes
// a block, staging buffers}.
template <class T, int NMAX>
int cluster_info_of(int n_mod, int* info) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = configure<T, NMAX, false, true>(cfg, cluster, CM * T::BM, CN * T::BN, n_mod, 0);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, fused_mod_gemm_kernel<T, NMAX, false, true>, &cfg);
  }
  info[0] = CM;
  info[1] = CN;
  info[2] = clusters;
  info[3] = smem_bytes<T, NMAX>(n_mod);
  info[4] = stages<T, NMAX>();
  return static_cast<int>(err);
}

template <class T>
int cluster_info_n(int n_mod, int* info) {
  if (n_mod <= 8) return cluster_info_of<T, 8>(n_mod, info);
  if (n_mod <= 16) return cluster_info_of<T, 16>(n_mod, info);
  return cluster_info_of<T, 24>(n_mod, info);
}

}  // namespace

#define REPRO_TILES    \
  REPRO_TILE(64, 64, 64, 4) \
  REPRO_TILE(128, 64, 64, 2)

extern "C" int fused_mod_gemm_launch(const void* a, const void* sa1, const void* sa2,
                                     const void* b, const void* b_res, const void* sb1,
                                     const void* sb2, const void* r1, const void* r2,
                                     const void* c1, const void* c2, void* out, int m, int n,
                                     int k, int chunk_limit, int out_dd, int n_mod, int n_limbs,
                                     int bm, int bn, int bk, const int* moduli, const float* radix,
                                     const int* coef, const float* weights, const float* split,
                                     void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, coef, weights, split) || chunk_limit < 1 ||
      !fma_moduli_ok(n_mod, moduli)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  const Operands op = {
      static_cast<const float*>(a),   static_cast<const float*>(sa1),
      static_cast<const float*>(sa2), static_cast<const float*>(b),
      static_cast<const int8_t*>(b_res), static_cast<const float*>(sb1),
      static_cast<const float*>(sb2), static_cast<const float*>(r1),
      static_cast<const float*>(r2),  static_cast<const float*>(c1),
      static_cast<const float*>(c2),  static_cast<float*>(out)};
  const bool prepared = b_res != nullptr;
  // the vector path: 16-byte A loads (B is read one value a thread and row)
  const bool vec = k % 4 == 0 && aligned(a, 16);
  auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM, BN, BK, WN)                                                            \
  if (bm == BM && bn == BN && bk == BK)                                                       \
    return dispatch_n<Tile<BM, BN, BK, WN>>(op, prepared, vec, m, n, k, chunk_limit, out_dd, cp, \
                                            gp, s);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);  // a tile that was not compiled
}

// The cluster shape and occupancy of the launch of tile (bm, bn, bk) at
// n_mod moduli: info[5] = {CM, CN, max active clusters, shared bytes a
// block, staging buffers}.
extern "C" int fused_mod_gemm_cluster_info(int bm, int bn, int bk, int n_mod, int* info) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TILE(BM, BN, BK, WN) \
  if (bm == BM && bn == BN && bk == BK) return cluster_info_n<Tile<BM, BN, BK, WN>>(n_mod, info);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
