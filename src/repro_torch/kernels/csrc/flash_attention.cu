// Causal (or full) GQA flash attention, forward: o = softmax(q k^T / sqrt(D)) v.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py:24
// (`flash_attention`, :65; `pallas_call` at :91).  q and o are (B, S, H, D),
// k and v (B, Sk, KV, D), read and written in place with their head strides
// (the reference's transposes to (B*H, S, D) and back would move ~1.3 GB
// more at Qwen2.5-32B's 32k prefill).  Query head h reads kv head h / G,
// G = H / KV.  The mask is the reference's: logits of keys with k_pos >
// q_pos (causal, top-left aligned) are -1e30, and the running (m, l, acc)
// follow its update order, m starting at -1e30, o = acc / max(l, 1e-30).
//
// Bound on the H100: tensor-core operations.  At B = 1, S = 32768, H = 40,
// KV = 8, D = 128 (bf16) the causal half needs 2 D H S^2 = 1.1e13 flop,
// 11.1 ms at 989 TFLOP/s, against 0.8 GB of q, k, v and o (0.24 ms at 3.35
// TB/s).  The S^2 H / 2 = 2.1e10 exponentials take about 5 ms of the SFU
// (16 a clock per SM), so the softmax must overlap the products.
//
// Design: one block owns one (batch, query head, 64-row q tile) and walks
// the kv tiles itself, keeping m, l and acc in registers (the TPU carries
// them in VMEM across a sequential grid axis; here blocks run in no order).
// The q tile is staged once; each 64-key K and V tile goes through shared
// memory, zero-filled past Sk.  Causal blocks stop at the diagonal: the kv
// tiles wholly above it are skipped, which is exact (there the reference's
// p is 0 and its correction 1).  The diagonal tile and the ragged tail are
// masked per element; the q tiles run heaviest first.  No pipelining yet.
//
//  * bf16 in: QK^T and PV on mma.sync.m16n8k16 (bf16 operands, f32
//    accumulators), four warps of 16 q rows each.  The scale (times log2 e,
//    for ex2) is applied to the f32 logits, because q * 2^-3.5 is not exact
//    in bf16.  P is rounded to bf16 for the PV product; l sums the f32 p.
//  * f32 in: SIMT float FMAs, no TF32, q * (1/sqrt(D)) rounded in f32 as the
//    reference does.  The build has -fmad=false, so the dot products are
//    written with explicit __fmaf_rn (one rounding each).
//
// Head dims 32, 64, 128 and 256 are compiled; the entry point refuses others.
#include <cmath>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // q rows a block owns
constexpr int BK = 64;        // keys a kv tile holds
constexpr int THREADS = 128;  // four warps
constexpr float MASK = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, Sk, H, KV, causal;
  float scale;  // f32: 1/sqrt(D); bf16: log2(e)/sqrt(D)
};

// The block's slice of the problem: its q tile, its (batch, head), the kv
// tiles it visits.
struct Slice {
  int q0, b, h, kvh, n_tiles;

  __device__ Slice(const Params& p) {
    const int bh = blockIdx.x;
    b = bh / p.H;
    h = bh - b * p.H;
    kvh = h / (p.H / p.KV);
    q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q tiles first
    const int q_last = min(q0 + BQ, p.S) - 1;
    n_tiles = (p.Sk + BK - 1) / BK;
    if (p.causal) n_tiles = min(n_tiles, q_last / BK + 1);
  }
  // offset of (position s, head) in a (B, seq, heads, D) tensor
  __device__ long long q_row(const Params& p, int s, int D) const {
    return ((static_cast<long long>(b) * p.S + s) * p.H + h) * D;
  }
  __device__ long long kv_row(const Params& p, int s, int D) const {
    return ((static_cast<long long>(b) * p.Sk + s) * p.KV + kvh) * D;
  }
  // whether any element of the kv tile at k0 is masked for this q tile
  __device__ bool needs_mask(const Params& p, int k0) const {
    return (p.causal && k0 + BK - 1 > q0) || k0 + BK > p.Sk;
  }
};

// Copy `valid` rows (zeros for the rest of the 64) of D elements, `heads`
// rows of D apart in global memory (one position of a (B, seq, heads, D)
// tensor to the next), into shared rows LD elements apart, 16 bytes a
// thread at a time.
template <int D, int LD, typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          int heads, int valid) {
  const long long stride = static_cast<long long>(heads) * D;
  constexpr int PER = 16 / sizeof(T);
  constexpr int CPR = D / PER;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, col = (c - r * CPR) * PER;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = x;
  }
}

// ------------------------------------------------------------ f32 (SIMT)

// Thread (ty, tx) = (tid / 8, tid % 8) owns q rows ty + 16 i (i < 4): the
// logits of keys tx + 8 j (j < 8) and the output columns 32 jj + 4 tx + e.
// Shared rows are padded to D + 4 floats, so the float4 reads of eight rows
// at one column fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(THREADS) fa_f32_kernel(Params p) {
  constexpr int LD = D + 4, LDP = BK + 4, NJ = D / 32;
  extern __shared__ uint4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BQ x LD: q * scale
  float* sKV = sQ + BQ * LD;                       // BK x LD: k, then v
  float* sP = sKV + BK * LD;                       // BQ x LDP: p
  const Slice sl(p);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const auto* q = static_cast<const float*>(p.q);
  const auto* k = static_cast<const float*>(p.k);
  const auto* v = static_cast<const float*>(p.v);

  load_tile<D, LD>(sQ, q + sl.q_row(p, sl.q0, D), p.H, p.S - sl.q0);
  __syncthreads();
  for (int c = tid; c < BQ * D; c += THREADS) {
    const int r = c / D;
    sQ[r * LD + c - r * D] *= p.scale;  // the reference's q * scale, one rounding
  }

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  for (int t = 0; t < sl.n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's v and p are consumed
    load_tile<D, LD>(sKV, k + sl.kv_row(p, k0, D), p.KV, p.Sk - k0);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(sKV + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = __fmaf_rn(qa[i].x, kb.x, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].y, kb.y, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].z, kb.z, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].w, kb.w, s[i][j]);
        }
      }
    }

    const bool masked = sl.needs_mask(p, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = sl.q0 + ty + 16 * i;
      float mx = MASK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        if (masked && ((p.causal && kp > qp) || kp >= p.Sk)) s[i][j] = MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row are 8 neighbouring lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        sP[(ty + 16 * i) * LDP + tx + 8 * j] = e;
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= corr;
    }
    __syncthreads();  // k consumed, p written
    load_tile<D, LD>(sKV, v + sl.kv_row(p, k0, D), p.KV, p.Sk - k0);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vb = *reinterpret_cast<const float4*>(sKV + (c + cc) * LD + 32 * jj + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][jj][0] = __fmaf_rn(pw, vb.x, acc[i][jj][0]);
            acc[i][jj][1] = __fmaf_rn(pw, vb.y, acc[i][jj][1]);
            acc[i][jj][2] = __fmaf_rn(pw, vb.z, acc[i][jj][2]);
            acc[i][jj][3] = __fmaf_rn(pw, vb.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

  auto* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float den = fmaxf(li, 1e-30f);
    const int qp = sl.q0 + ty + 16 * i;
    if (qp >= p.S) continue;
    float* row = o + sl.q_row(p, qp, D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      *reinterpret_cast<float4*>(row + 32 * jj + 4 * tx) = make_float4(
          acc[i][jj][0] / den, acc[i][jj][1] / den, acc[i][jj][2] / den, acc[i][jj][3] / den);
    }
  }
}

// ----------------------------------------------------- bf16 (tensor cores)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b on one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// round two f32 to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warp w owns q rows 16 w .. 16 w + 15.  In the mma fragments lane (g, t) =
// (lane / 4, lane % 4) holds rows g and g + 8, columns 2 t and 2 t + 1 of
// each 8-wide n tile.  Shared rows are padded to D + 8 elements, so the
// eight 16-byte rows of an ldmatrix fall in distinct banks.  Up to D = 128
// the warp's q fragments stay in registers; at 256 they are re-read from
// shared memory for every kv tile.
template <int D>
__global__ void __launch_bounds__(THREADS) fa_bf16_kernel(Params p) {
  constexpr int LD = D + 8, KS = D / 16, NS = BK / 8, ND = D / 8;
  constexpr bool Q_IN_REGS = D <= 128;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* sK = sQ + BQ * LD;                       // BK x LD
  bf16* sV = sK + BK * LD;                       // BK x LD
  const Slice sl(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const auto* q = static_cast<const bf16*>(p.q);
  const auto* k = static_cast<const bf16*>(p.k);
  const auto* v = static_cast<const bf16*>(p.v);

  load_tile<D, LD>(sQ, q + sl.q_row(p, sl.q0, D), p.H, p.S - sl.q0);
  __syncthreads();
  // ldmatrix addresses: the A tile (16 rows x 16) of q, the B tiles of k
  // (two 8-key n tiles x 16 of d) and of v (16 keys x two 8-wide d tiles)
  const bf16* q_frag = sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* k_frag = sK + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const bf16* v_frag = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
  const int qp[2] = {sl.q0 + warp * 16 + g, sl.q0 + warp * 16 + g + 8};

  for (int t = 0; t < sl.n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's k and v are consumed
    load_tile<D, LD>(sK, k + sl.kv_row(p, k0, D), p.KV, p.Sk - k0);
    load_tile<D, LD>(sV, v + sl.kv_row(p, k0, D), p.KV, p.Sk - k0);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int jn = 0; jn < NS / 2; ++jn) {
        uint32_t b[4];
        ldsm_x4(b, k_frag + jn * 16 * LD + kk * 16);
        mma_bf16(s[2 * jn], a, b[0], b[1]);
        mma_bf16(s[2 * jn + 1], a, b[2], b[3]);
      }
    }

    // online softmax in the log2 domain: x = (q . k) log2(e) / sqrt(D)
    const bool masked = sl.needs_mask(p, k0);
    float mx[2] = {MASK, MASK};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (masked) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          if ((p.causal && kp > qp[e >> 1]) || kp >= p.Sk) x = MASK;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = ex2(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = ex2(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = ex2(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr + sum;  // this thread's share of the row sum
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // acc += P V, P rounded to bf16: the logits' accumulator layout is the
    // A fragment of 16 keys = two 8-key n tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_frag + kk * 16 * LD + dn * 16);
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }

  auto* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float den = fmaxf(lr, 1e-30f);
    if (qp[r] >= p.S) continue;
    bf16* row = o + sl.q_row(p, qp[r], D);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t4) =
          pack_bf16(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

template <int D>
constexpr int smem_f32() {
  return ((BQ + BK) * (D + 4) + BQ * (BK + 4)) * 4;
}

template <int D>
constexpr int smem_bf16() {
  return (BQ + 2 * BK) * (D + 8) * 2;
}

template <int D>
int launch(const Params& p, int B, int dtype, cudaStream_t st) {
  const dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f32<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_f32_kernel<D><<<grid, THREADS, smem_f32<D>(), st>>>(p);
  } else {
    err = cudaFuncSetAttribute(fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bf16<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bf16_kernel<D><<<grid, THREADS, smem_bf16<D>(), st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t code.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int Sk, int H, int KV, int D, int causal, int dtype,
                                      void* stream) {
  if (B < 0 || S < 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H > 0x7fffffff || (S + BQ - 1) / BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  const double inv_sqrt = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = dtype == 0 ? static_cast<float>(inv_sqrt)
                                 : static_cast<float>(inv_sqrt * 1.4426950408889634);
  const Params p{q, k, v, o, S, Sk, H, KV, causal, scale};
  auto* st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, dtype, st);
    case 64: return launch<64>(p, B, dtype, st);
    case 128: return launch<128>(p, B, dtype, st);
    case 256: return launch<256>(p, B, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
