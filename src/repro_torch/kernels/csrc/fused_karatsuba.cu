// The one-launch complex megakernel: (CR, CI) = (AR + i AI)(BR + i BI)
// emulated end to end.  For one BM x BN output tile it casts AR/AI (and
// BR/BI) to residues, runs the Karatsuba triple for every plane l,
//   D = AR.BR, E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p),
//   CR = m(m(D) - m(E)), CI = m(m(F) - m(D) - m(E))   (m: symmetric mod p_l)
// with the K-chunk reduction inside, and reconstructs CR and CI by Garner
// with exact inverse scaling.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/karatsuba_fused.py:194 (`fused_karatsuba_mod_gemm`, :337).
//
// Bound on the H100: int8 tensor-core operations, 3 * 2 N m n k of them at
// 1,979 TOP/s dense (4096^3 at N = 14: 2.917 ms); the f32 operands and
// outputs, 8 (m k + k n + m n) bytes, take less at 3.35 TB/s.  What limits
// it is the cast: every raw value is cast once per plane and per output
// tile that reads it, some 30 f32 operations a cast against 1/85 of an
// mma.sync.
//
// Design.  The plane loop stays outside the K loop: the TPU kernel keeps
// three (N, 256, 256) int32 accumulators across its K grid axis (about
// 11 MB at N = 14); here the three accumulators of one plane live in
// registers (a 32x16 warp tile, 48 a thread, at the default 64 x 64 tile)
// and only the canonical int8 CR and CI residues of each finished plane are
// stashed in shared memory, 2 N BM BN bytes (112 KB at N = 14, 168 KB at
// N = 21 for 64 x 64).  Three things make the cast cheap:
//  1. The cast is residue_fma.cuh's: no integer division, the plane's
//     constants in registers, residues packed to bytes by the f32 shifter.
//  2. The blocks of a thread-block cluster share it: CM = 2 blocks along m
//     by CN = 4 along n.  The CN blocks of a cluster row read the same A
//     rows, the CM blocks of a cluster column the same B columns.  Of each
//     K slice, block (cx, cy) casts the A columns [cx BK/CN, (cx+1) BK/CN)
//     and the B rows [cy BK/CM, (cy+1) BK/CM) and stores the residues (and
//     the per-element (AR+AI) and (BR+BI) mod p) into the staging of every
//     block that reads them, its own included, through distributed shared
//     memory: each block casts a quarter of the A values and half of the B
//     values it multiplies.  (On the H100 at 4096^3, N = 14, 2 x 4 ran
//     faster than 2 x 2, 4 x 2 and no cluster: PERF.md section 6.)
//     The grid is padded to whole clusters; a padding block casts its
//     share and synchronises, and stores no output (its rows or columns
//     lie outside C).
//  3. The staging is double-buffered (where the stash leaves room: every
//     compiled tile at N <= 16, and 64 x 32 at any N; 64 x 64 at N > 16
//     has one buffer and a second barrier per slice).  Slice t + 1 is cast
//     into one buffer while slice t is multiplied from the other, and one
//     cluster barrier a slice separates them; the global loads of slice
//     t + 2 are issued between its arrive and its wait.  The planes run
//     back to back in one flattened loop, so the pipeline does not drain
//     at a plane boundary.
// The epilogue runs Garner twice, on the CR and the CI stash.
//
// Bits.  Every residue is the unique canonical one (residue_fma.cuh), the
// int32 products and sums are exact in any order (|D| < 2^31 between chunk
// reductions), and the stash, the combine and Garner are as in the 4-launch path:
// the output equals fused_karatsuba_mod_gemm_plain and the 4-launch
// cast/Karatsuba/Garner composition bit for bit, whichever block cast a
// value and in whichever order the slices arrive.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"
#include "residue_fma.cuh"

namespace {

constexpr int CM = 2, CN = 4;       // the cluster: CM blocks along m, CN along n
constexpr int SMEM_MAX = 232448;    // the dynamic shared memory a block may use

struct Operands {
  const float* ar;       // (m, k) f32 real and imaginary parts
  const float* ai;
  const float* sa1;      // (m,) row scale factors
  const float* sa2;
  const float* br;       // (k, n) f32, or null when prepared
  const float* bi;
  const int8_t* brr;     // (N, k, n) int8 planes, or null
  const int8_t* bri;
  const float* sb1;      // (n,) column scale factors, or null when prepared
  const float* sb2;
  const float* r1;       // (m,) inverse scale factors
  const float* r2;
  const float* c1;       // (n,)
  const float* c2;
  float* out_r;          // (m, n) f32, or (2, m, n) double-single
  float* out_i;
};

// The staging of one K slice, shared by a cluster, and who casts what.
template <class T>
struct Stage {
  static constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS;
  static constexpr int A_BYTES = BM * LDS, B_BYTES = BN * LDS;  // [rows][LDS] tiles
  static constexpr int BYTES = 3 * (A_BYTES + B_BYTES);  // AR, AI, AS, then BR, BI, BS
  // A: A_SEG consecutive k of one row a thread, in the block's BK / CN columns
  static constexpr int AK = BK / CN, A_SEG = BM * AK / T::THREADS, A_TPR = AK / A_SEG;
  // B: B_SEG consecutive k of one column a thread, in the block's BK / CM rows
  static constexpr int BKR = BK / CM, B_SEG = BKR * BN / T::THREADS;
  static_assert(A_SEG % 4 == 0 && A_SEG <= 16 && BM * A_TPR == T::THREADS, "A share");
  static_assert(B_SEG % 4 == 0 && B_SEG <= 16 && BN * (BKR / B_SEG) == T::THREADS, "B share");
};

// Double-buffered staging where it fits beside the largest stash of NMAX.
template <class T, int NMAX>
__host__ __device__ constexpr int stages() {
  return 2 * NMAX * T::BM * T::BN + 2 * Stage<T>::BYTES <= SMEM_MAX ? 2 : 1;
}

template <class T, int NMAX>
int smem_bytes(int n_mod) {
  return stages<T, NMAX>() * Stage<T>::BYTES + 2 * n_mod * T::BM * T::BN;
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

// Store W packed words (4 W bytes, 4 W-byte aligned) at a shared::cluster address.
template <int W>
__device__ __forceinline__ void st_cluster_words(uint32_t addr, const uint32_t (&w)[W]) {
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    if (j + 1 < W) {
      st_cluster(addr + 4 * j, make_uint2(w[j], w[j + 1]));
    } else {
      st_cluster(addr + 4 * j, w[j]);
    }
  }
}

template <class T, int NMAX>
__device__ __forceinline__ void garner_store(const int8_t* st, int e, int gi, int gj, float rr,
                                             float cc, float* out, size_t mn, int n, int out_dd,
                                             const GarnerParams& gp) {
  float d[NMAX];
#pragma unroll
  for (int t = 0; t < NMAX; ++t) {
    if (t < gp.n_mod) d[t] = static_cast<float>(st[t * (T::BM * T::BN) + e]);
  }
  const DS v = garner_value<NMAX>(d, gp);
  const size_t o = static_cast<size_t>(gi) * n + gj;
  if (out_dd) {
    out[o] = (v.hi * rr) * cc;
    out[mn + o] = (v.lo * rr) * cc;
  } else {
    out[o] = ((v.hi + v.lo) * rr) * cc;
  }
}

template <class T, int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(T::THREADS) fused_karatsuba_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  using S = Stage<T>;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDS = T::LDS, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS, STAGES = stages<T, NMAX>();
  extern __shared__ __align__(16) int8_t smem[];  // STAGES staging buffers, then the stash
  int8_t* stash = smem + STAGES * S::BYTES;        // CR [N][BM * BN], then CI
  const int N = cp.n_mod, n_limbs = cp.n_limbs;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cx = blockIdx.x % CN, cy = blockIdx.y % CM;  // the block's place in its cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> T::WN_LOG2) * T::WTM, wn = (warp & (T::WARPS_N - 1)) * T::WTN;

  // this thread's share of a slice: the A row a_row at k = a_k..a_k+A_SEG-1,
  // and the B column b_col at k = b_k..b_k+B_SEG-1 (offsets in the slice)
  const int a_row = tid / S::A_TPR, a_k = cx * S::AK + (tid % S::A_TPR) * S::A_SEG;
  const int b_col = tid % BN, b_k = cy * S::BKR + (tid / BN) * S::B_SEG;
  const int ga = m0 + a_row, gb = n0 + b_col;
  const float scale_a = ga < m ? op.sa1[ga] * op.sa2[ga] : 0.0f;
  const float scale_b = (!PREPARED && gb < n) ? op.sb1[gb] * op.sb2[gb] : 0.0f;
  // the blocks that read this thread's A values are its cluster row, ranks
  // x + cy CN; its B values, its cluster column, ranks cx + y CN
  const uint32_t base = smem_addr(smem);

  float rar[S::A_SEG], rai[S::A_SEG];
  float rbr[S::B_SEG], rbi[S::B_SEG];
  int8_t qbr[S::B_SEG], qbi[S::B_SEG];
  auto load = [&](int l, int k0) {
    load_row<S::A_SEG, VEC>(op.ar, m, k, ga, k0 + a_k, rar);
    load_row<S::A_SEG, VEC>(op.ai, m, k, ga, k0 + a_k, rai);
    if (PREPARED) {
      const size_t off = static_cast<size_t>(l) * k * n;
      load_col<S::B_SEG>(op.brr + off, k, n, k0 + b_k, gb, qbr);
      load_col<S::B_SEG>(op.bri + off, k, n, k0 + b_k, gb, qbi);
    } else {
      load_col<S::B_SEG>(op.br, k, n, k0 + b_k, gb, rbr);
      load_col<S::B_SEG>(op.bi, k, n, k0 + b_k, gb, rbi);
    }
  };

  // cast the loaded share with plane constants `pc` into the staging
  // buffer at byte `buf`, in every block that reads it
  auto cast_store = [&](uint32_t buf, const PlaneCast& pc) {
    {
      uint32_t wr[S::A_SEG / 4], wi[S::A_SEG / 4], ws[S::A_SEG / 4];
#pragma unroll
      for (int j = 0; j < S::A_SEG / 4; ++j) {
        float vr[4], vi[4], vs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vr[q] = residue_fma(rar[4 * j + q], scale_a, n_limbs, pc);
          vi[q] = residue_fma(rai[4 * j + q], scale_a, n_limbs, pc);
          vs[q] = sum_residue(vr[q], vi[q], pc);
        }
        wr[j] = pack4_residues(vr);
        wi[j] = pack4_residues(vi);
        ws[j] = pack4_residues(vs);
      }
      const uint32_t at = base + buf + a_row * LDS + a_k;
#pragma unroll
      for (int x = 0; x < CN; ++x) {
        const uint32_t dst = cluster_map(at, x + cy * CN);
        st_cluster_words(dst, wr);
        st_cluster_words(dst + S::A_BYTES, wi);
        st_cluster_words(dst + 2 * S::A_BYTES, ws);
      }
    }
    uint32_t wr[S::B_SEG / 4], wi[S::B_SEG / 4], ws[S::B_SEG / 4];
#pragma unroll
    for (int j = 0; j < S::B_SEG / 4; ++j) {
      if (PREPARED) {
        wr[j] = wi[j] = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wr[j] |= static_cast<uint32_t>(static_cast<uint8_t>(qbr[4 * j + q])) << (8 * q);
          wi[j] |= static_cast<uint32_t>(static_cast<uint8_t>(qbi[4 * j + q])) << (8 * q);
        }
        ws[j] = sum_mod4(wr[j], wi[j], pc.pi, pc.half);
      } else {
        float vr[4], vi[4], vs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vr[q] = residue_fma(rbr[4 * j + q], scale_b, n_limbs, pc);
          vi[q] = residue_fma(rbi[4 * j + q], scale_b, n_limbs, pc);
          vs[q] = sum_residue(vr[q], vi[q], pc);
        }
        wr[j] = pack4_residues(vr);
        wi[j] = pack4_residues(vi);
        ws[j] = pack4_residues(vs);
      }
    }
    const uint32_t bt = base + buf + 3 * S::A_BYTES + b_col * LDS + b_k;
#pragma unroll
    for (int y = 0; y < CM; ++y) {
      const uint32_t dst = cluster_map(bt, cx + y * CN);
      st_cluster_words(dst, wr);
      st_cluster_words(dst + S::B_BYTES, wi);
      st_cluster_words(dst + 2 * S::B_BYTES, ws);
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

  int acc[3][MT][NT][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = 0;

  cluster_arrive();  // every block of the cluster has started: its shared memory may be written
  cluster_wait();
  load_next();
  PlaneCast pc;
  int l = 0, s = 0, p = cp.pi[0];  // the slice being multiplied, and its modulus
  // step t multiplies slice t and casts slice t + 1; step -1 only casts
  // slice 0 (one call site, so the cast is inlined)
  for (int t = -1; t < total; ++t) {
    if (t >= 0) {
      const int8_t* cur = smem + (t % STAGES) * S::BYTES;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        warp_tile_mma<MT, NT, BK>(acc[g], cur + g * S::A_BYTES,
                                  cur + 3 * S::A_BYTES + g * S::B_BYTES, wm, wn, lane);
      }
      if (STAGES == 1) {  // every block has read the one buffer before it is cast into again
        cluster_arrive();
        cluster_wait();
      }
    }
    if (t + 1 < total) {
      if (t < 0 || s + 1 == S_K) pc = plane_cast(cp, t < 0 ? 0 : l + 1);
      cast_store(((t + 1) % STAGES) * S::BYTES, pc);
    }
    if (t >= 0 && s + 1 == S_K) {
      // the plane is done: its canonical CR and CI into the stash
      int8_t* st_r = stash + l * (BM * BN);
      int8_t* st_i = stash + (N + l) * (BM * BN);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = wm + mt * 16 + (lane >> 2) + (c >> 1) * 8;
            const int col = wn + nt * 8 + (lane & 3) * 2 + (c & 1);
            const int d = sym_mod_i32(acc[0][mt][nt][c], p);
            const int e = sym_mod_i32(acc[1][mt][nt][c], p);
            const int f = sym_mod_i32(acc[2][mt][nt][c], p);
            st_r[row * BN + col] = static_cast<int8_t>(sym_mod_i32(d - e, p));
            st_i[row * BN + col] = static_cast<int8_t>(sym_mod_i32(f - d - e, p));
#pragma unroll
            for (int g = 0; g < 3; ++g) acc[g][mt][nt][c] = 0;
          }
        }
      }
    } else if (t >= 0 && (s + 1) % chunk_steps == 0) {
      // in-kernel K-chunk reduction: keeps the int32 sums exact for any k
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = sym_mod_i32(acc[g][mt][nt][c], p);
    }
    cluster_arrive();
    if (t + 2 < total) load_next();  // in flight across the barrier
    cluster_wait();
    if (t >= 0 && ++s == S_K) {
      s = 0;
      if (++l < N) p = cp.pi[l];
    }
  }

  // epilogue: two Garner reconstructions + inverse scaling per element (the
  // last cluster barrier ordered every stash write before these reads)
  const size_t mn = static_cast<size_t>(m) * n;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gi = m0 + e / BN, gj = n0 + e % BN;
    if (gi >= m || gj >= n) continue;
    const float rr = op.r1[gi] * op.r2[gi];
    const float cc = op.c1[gj] * op.c2[gj];
    garner_store<T, NMAX>(stash, e, gi, gj, rr, cc, op.out_r, mn, n, out_dd, gp);
    garner_store<T, NMAX>(stash + N * (BM * BN), e, gi, gj, rr, cc, op.out_i, mn, n, out_dd, gp);
  }
}

// The launch configuration: the grid padded to whole CM x CN clusters.
template <class T, int NMAX, bool PREPARED, bool VEC>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int m, int n,
                      int n_mod, cudaStream_t stream) {
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  return cluster_launch_config(cfg, cluster, fused_karatsuba_kernel<T, NMAX, PREPARED, VEC>, grid,
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
  err = cudaLaunchKernelEx(&cfg, fused_karatsuba_kernel<T, NMAX, PREPARED, VEC>, op, m, n, k,
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
    err = cudaOccupancyMaxActiveClusters(&clusters, fused_karatsuba_kernel<T, NMAX, false, true>, &cfg);
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
  REPRO_TILE(64, 32, 64, 2)

extern "C" int fused_karatsuba_launch(const void* ar, const void* ai, const void* sa1,
                                      const void* sa2, const void* br, const void* bi,
                                      const void* brr, const void* bri, const void* sb1,
                                      const void* sb2, const void* r1, const void* r2,
                                      const void* c1, const void* c2, void* out_r, void* out_i,
                                      int m, int n, int k, int chunk_limit, int out_dd, int n_mod,
                                      int n_limbs, int bm, int bn, int bk, const int* moduli,
                                      const float* radix, const int* coef,
                                      const float* weights, const float* split, void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, coef, weights, split) || chunk_limit < 1 ||
      !fma_moduli_ok(n_mod, moduli)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  const Operands op = {
      static_cast<const float*>(ar),   static_cast<const float*>(ai),
      static_cast<const float*>(sa1),  static_cast<const float*>(sa2),
      static_cast<const float*>(br),   static_cast<const float*>(bi),
      static_cast<const int8_t*>(brr), static_cast<const int8_t*>(bri),
      static_cast<const float*>(sb1),  static_cast<const float*>(sb2),
      static_cast<const float*>(r1),   static_cast<const float*>(r2),
      static_cast<const float*>(c1),   static_cast<const float*>(c2),
      static_cast<float*>(out_r),      static_cast<float*>(out_i)};
  const bool prepared = brr != nullptr;
  // the vector path: 16-byte A loads (B is read one value a thread and row)
  const bool vec = k % 4 == 0 && aligned(ar, 16) && aligned(ai, 16);
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
extern "C" int fused_karatsuba_cluster_info(int bm, int bn, int bk, int n_mod, int* info) {
  if (n_mod < 1 || n_mod > REPRO_MAX_MODULI) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TILE(BM, BN, BK, WN) \
  if (bm == BM && bn == BN && bk == BK) return cluster_info_n<Tile<BM, BN, BK, WN>>(n_mod, info);
  REPRO_TILES
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
