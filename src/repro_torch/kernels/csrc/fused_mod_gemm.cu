// The one-launch real megakernel: C = A @ B emulated end to end.  For one
// 64x64 output tile it casts the f32 operand tiles to residues, runs the N
// int8 plane products with the K-chunk reduction inside, and reconstructs
// the tile by Garner with exact inverse scaling.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/int8_mod_gemm.py:162 (`fused_mod_gemm`, :303).
//
// Bound on the H100: int8 tensor-core operations, 2 N m n k of them at
// 1,979 TOP/s dense (4096^3 at N = 8: 0.556 ms); the f32 operands and the
// output, 4 (m k + k n + m n) bytes, take less at 3.35 TB/s.
//
// Design.  The TPU kernel keeps all N planes' int32 accumulators, an
// (N, 256, 256) block of VMEM, live across its K grid axis; an H100 block
// has 227 KB of shared memory and 255 registers a thread, so the loops are
// turned round: planes outside, K inside, one 64x64 output tile a block.
//  - For plane l, each 64-deep K step loads the raw f32 A tile (and B tile)
//    into registers, casts them to residues mod p_l with `cast_tile.cuh`
//    (the residue_cast kernel's exact op sequence) into the padded
//    [rows][LDS] staging of `gemm_tiles.cuh`, B transposed on the way, and
//    accumulates the product by s8 `mma.sync` in int32 registers.  A
//    prepared operand's int8 plane l is loaded as it is instead of cast.
//  - Every `chunk_steps` K steps the accumulators are reduced by the exact
//    int32 symmetric mod (the reference's in-kernel chunk reduction,
//    int8_mod_gemm.py:217-225), so any k stays exact.
//  - The canonical int8 residue of plane l is stashed in dynamic shared
//    memory, N * 64 * 64 bytes (96 KB at N = 24).
//  - The epilogue runs Garner (`garner_tile.cuh`, the crt_garner kernel's
//    exact op sequence) on the stash, one thread per output element, and
//    applies the inverse scaling.
// Every residue is the unique canonical one, so the output equals the
// 4-launch cast/product/Garner composition bit for bit.  The cast is
// recomputed for every plane and every output tile it feeds: this simple
// version is bound by that integer work, not by the tensor cores.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 64, BN = 64, THREADS = 256;
constexpr int MT = 2, NT = 2;  // warp tile 32 x 16; 2 x 4 warps

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

template <int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(THREADS) fused_mod_gemm_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  extern __shared__ __align__(16) int8_t stash[];  // [N][BM * BN]
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;

  // staging: A row a_row, 16 bytes at a_col; B the 4x4 block at
  // n = n0 + 4 b_nb, k = 4 b_kb
  const int a_row = tid >> 2, a_col = (tid & 3) * 16;
  const int b_nb = tid & 15, b_kb = tid >> 4;
  const int ga = m0 + a_row;
  const float scale_a = ga < m ? op.sa1[ga] * op.sa2[ga] : 0.0f;
  float scale_b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gc = n0 + 4 * b_nb + j;
    scale_b[j] = (!PREPARED && gc < n) ? op.sb1[gc] * op.sb2[gc] : 0.0f;
  }

  float ra[16];
  float rb[4][4];
  uint32_t rq[4];
  auto load = [&](int l, int k0) {
    load_f32_16<VEC>(op.a, m, k, ga, k0 + a_col, ra);
    if (PREPARED) {
      const int8_t* plane = op.b_res + static_cast<size_t>(l) * k * n;
#pragma unroll
      for (int r = 0; r < 4; ++r) rq[r] = load_b4<VEC>(plane, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) load_f32_4<VEC>(op.b, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb, rb[r]);
    }
  };

  for (int l = 0; l < cp.n_mod; ++l) {
    const int p = cp.pi[l];
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

    load(l, 0);
    int step = 0;
    for (int k0 = 0; k0 < k; k0 += BK, ++step) {
      *reinterpret_cast<uint4*>(As + a_row * LDS + a_col) = cast_row16(ra, scale_a, l, cp);
      uint32_t x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = PREPARED ? rq[r] : cast_pack4(rb[r], scale_b, l, cp);
      store_b_block(Bs, x, 4 * b_nb, 4 * b_kb);
      __syncthreads();
      if (k0 + BK < k) load(l, k0 + BK);
      warp_tile_mma<MT, NT>(acc, As, Bs, wm, wn, lane);
      __syncthreads();
      if ((step + 1) % chunk_steps == 0 && k0 + BK < k) {
        // in-kernel K-chunk reduction: keeps the int32 sums exact for any k
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] = sym_mod_i32(acc[mt][nt][c], p);
      }
    }

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
        }
      }
    }
  }
  __syncthreads();

  // epilogue: Garner + inverse scaling, one thread per output element
  const size_t mn = static_cast<size_t>(m) * n;
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

template <int NMAX, bool PREPARED, bool VEC>
int launch(const Operands& op, int m, int n, int k, int chunk_steps, int out_dd,
           const CastParams& cp, const GarnerParams& gp, cudaStream_t stream) {
  auto kernel = fused_mod_gemm_kernel<NMAX, PREPARED, VEC>;
  const int smem = cp.n_mod * BM * BN;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(op, m, n, k, chunk_steps, out_dd, cp, gp);
  return static_cast<int>(cudaGetLastError());
}

template <int NMAX>
int dispatch(const Operands& op, bool prepared, bool vec, int m, int n, int k, int chunk_steps,
             int out_dd, const CastParams& cp, const GarnerParams& gp, cudaStream_t s) {
  if (prepared) {
    return vec ? launch<NMAX, true, true>(op, m, n, k, chunk_steps, out_dd, cp, gp, s)
               : launch<NMAX, true, false>(op, m, n, k, chunk_steps, out_dd, cp, gp, s);
  }
  return vec ? launch<NMAX, false, true>(op, m, n, k, chunk_steps, out_dd, cp, gp, s)
             : launch<NMAX, false, false>(op, m, n, k, chunk_steps, out_dd, cp, gp, s);
}

}  // namespace

extern "C" int fused_mod_gemm_launch(const void* a, const void* sa1, const void* sa2,
                                     const void* b, const void* b_res, const void* sb1,
                                     const void* sb2, const void* r1, const void* r2,
                                     const void* c1, const void* c2, void* out, int m, int n,
                                     int k, int chunk_limit, int out_dd, int n_mod, int n_limbs,
                                     const int* moduli, const float* radix,
                                     const int* garner_inv, const float* weights, void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, garner_inv, weights) || chunk_limit < 1) {
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
  const uintptr_t b_addr = reinterpret_cast<uintptr_t>(prepared ? b_res : b);
  const bool vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   b_addr % (prepared ? 4 : 16) == 0;
  const int chunk_steps = chunk_limit / BK > 1 ? chunk_limit / BK : 1;
  auto* s = static_cast<cudaStream_t>(stream);
  if (n_mod <= 8) return dispatch<8>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
  if (n_mod <= 16) return dispatch<16>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
  return dispatch<24>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
}
