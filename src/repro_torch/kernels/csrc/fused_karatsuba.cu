// The one-launch complex megakernel: (CR, CI) = (AR + i AI)(BR + i BI)
// emulated end to end.  For one 64x64 output tile it casts AR/AI (and
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
// outputs, 8 (m k + k n + m n) bytes, take less at 3.35 TB/s.
//
// Design: the plane-outer, K-inner loop of fused_mod_gemm.cu (which see)
// with four input tiles.  The TPU kernel keeps three (N, 256, 256) int32
// accumulators live across its K grid axis, about 11 MB at N = 14; here the
// three accumulators of one plane live in registers (a 32x16 warp tile,
// 48 a thread) and only the canonical int8 CR and CI residues of each
// finished plane are stashed in dynamic shared memory, 2 * N * 64 * 64
// bytes (112 KB at N = 14, 192 KB at N = 24).  The sums (AR+AI) mod p and
// (BR+BI) mod p are formed per byte while the cast tiles are staged, as in
// karatsuba_fused.cu.  The epilogue runs Garner twice, on the CR and the CI
// stash.  Every residue is the unique canonical one, so the output equals
// the 4-launch cast/Karatsuba/Garner composition bit for bit.
#include "cast_tile.cuh"
#include "garner_tile.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 64, BN = 64, THREADS = 256;
constexpr int MT = 2, NT = 2;  // warp tile 32 x 16; 2 x 4 warps

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

template <int NMAX>
__device__ __forceinline__ void garner_store(const int8_t* st, int e, int gi, int gj, float rr,
                                             float cc, float* out, size_t mn, int n, int out_dd,
                                             const GarnerParams& gp) {
  float d[NMAX];
#pragma unroll
  for (int t = 0; t < NMAX; ++t) {
    if (t < gp.n_mod) d[t] = static_cast<float>(st[t * (BM * BN) + e]);
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

template <int NMAX, bool PREPARED, bool VEC>
__global__ void __launch_bounds__(THREADS) fused_karatsuba_kernel(
    Operands op, int m, int n, int k, int chunk_steps, int out_dd, CastParams cp,
    GarnerParams gp) {
  extern __shared__ __align__(16) int8_t stash[];  // CR [N][BM * BN], then CI
  __shared__ __align__(16) int8_t As[3][BM * LDS];  // AR, AI, (AR+AI) mod p
  __shared__ __align__(16) int8_t Bs[3][BN * LDS];  // BR, BI, (BR+BI) mod p
  const int N = cp.n_mod;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;

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

  float rar[16], rai[16];
  float rbr[4][4], rbi[4][4];
  uint32_t qr[4], qi[4];
  auto load = [&](int l, int k0) {
    load_f32_16<VEC>(op.ar, m, k, ga, k0 + a_col, rar);
    load_f32_16<VEC>(op.ai, m, k, ga, k0 + a_col, rai);
    if (PREPARED) {
      const size_t off = static_cast<size_t>(l) * k * n;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qr[r] = load_b4<VEC>(op.brr + off, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb);
        qi[r] = load_b4<VEC>(op.bri + off, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        load_f32_4<VEC>(op.br, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb, rbr[r]);
        load_f32_4<VEC>(op.bi, k, n, k0 + 4 * b_kb + r, n0 + 4 * b_nb, rbi[r]);
      }
    }
  };

  for (int l = 0; l < N; ++l) {
    const int p = cp.pi[l], half = (p - 1) >> 1;
    int acc[3][MT][NT][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][mt][nt][c] = 0;

    load(l, 0);
    int step = 0;
    for (int k0 = 0; k0 < k; k0 += BK, ++step) {
      const int off = a_row * LDS + a_col;
      const uint4 xr = cast_row16(rar, scale_a, l, cp);
      const uint4 xi = cast_row16(rai, scale_a, l, cp);
      *reinterpret_cast<uint4*>(As[0] + off) = xr;
      *reinterpret_cast<uint4*>(As[1] + off) = xi;
      *reinterpret_cast<uint4*>(As[2] + off) = sum_mod16(xr, xi, p, half);
      uint32_t wr[4], wi[4], ws[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wr[r] = PREPARED ? qr[r] : cast_pack4(rbr[r], scale_b, l, cp);
        wi[r] = PREPARED ? qi[r] : cast_pack4(rbi[r], scale_b, l, cp);
        ws[r] = sum_mod4(wr[r], wi[r], p, half);
      }
      store_b_block(Bs[0], wr, 4 * b_nb, 4 * b_kb);
      store_b_block(Bs[1], wi, 4 * b_nb, 4 * b_kb);
      store_b_block(Bs[2], ws, 4 * b_nb, 4 * b_kb);
      __syncthreads();
      if (k0 + BK < k) load(l, k0 + BK);
#pragma unroll
      for (int g = 0; g < 3; ++g) warp_tile_mma<MT, NT>(acc[g], As[g], Bs[g], wm, wn, lane);
      __syncthreads();
      if ((step + 1) % chunk_steps == 0 && k0 + BK < k) {
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
    }

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
        }
      }
    }
  }
  __syncthreads();

  // epilogue: two Garner reconstructions + inverse scaling per element
  const size_t mn = static_cast<size_t>(m) * n;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gi = m0 + e / BN, gj = n0 + e % BN;
    if (gi >= m || gj >= n) continue;
    const float rr = op.r1[gi] * op.r2[gi];
    const float cc = op.c1[gj] * op.c2[gj];
    garner_store<NMAX>(stash, e, gi, gj, rr, cc, op.out_r, mn, n, out_dd, gp);
    garner_store<NMAX>(stash + N * (BM * BN), e, gi, gj, rr, cc, op.out_i, mn, n, out_dd, gp);
  }
}

template <int NMAX, bool PREPARED, bool VEC>
int launch(const Operands& op, int m, int n, int k, int chunk_steps, int out_dd,
           const CastParams& cp, const GarnerParams& gp, cudaStream_t stream) {
  auto kernel = fused_karatsuba_kernel<NMAX, PREPARED, VEC>;
  const int smem = 2 * cp.n_mod * BM * BN;
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

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

extern "C" int fused_karatsuba_launch(const void* ar, const void* ai, const void* sa1,
                                      const void* sa2, const void* br, const void* bi,
                                      const void* brr, const void* bri, const void* sb1,
                                      const void* sb2, const void* r1, const void* r2,
                                      const void* c1, const void* c2, void* out_r, void* out_i,
                                      int m, int n, int k, int chunk_limit, int out_dd, int n_mod,
                                      int n_limbs, const int* moduli, const float* radix,
                                      const int* garner_inv, const float* weights, void* stream) {
  CastParams cp;
  GarnerParams gp;
  if (!make_cast_params(cp, n_mod, n_limbs, moduli, radix) ||
      !make_garner_params(gp, n_mod, moduli, garner_inv, weights) || chunk_limit < 1) {
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
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned(ar, 16) && aligned(ai, 16) &&
                   (prepared ? aligned(brr, 4) && aligned(bri, 4)
                             : aligned(br, 16) && aligned(bi, 16));
  const int chunk_steps = chunk_limit / BK > 1 ? chunk_limit / BK : 1;
  auto* s = static_cast<cudaStream_t>(stream);
  if (n_mod <= 8) return dispatch<8>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
  if (n_mod <= 16) return dispatch<16>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
  return dispatch<24>(op, prepared, vec, m, n, k, chunk_steps, out_dd, cp, gp, s);
}
