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
// Both paths: a block owns one (batch, query head, q tile) and walks the kv
// tiles itself, keeping m, l and acc in registers (the TPU carries them in
// VMEM across a sequential grid axis; here blocks run in no order).  Causal
// blocks stop at the diagonal: the kv tiles wholly above it are skipped,
// which is exact (there the reference's p is 0 and its correction 1).  Only
// the tiles on the diagonal and the ragged tail are masked per element; K and V rows
// past Sk arrive as zeros (0 times stale data could be NaN).  The q tiles
// run heaviest first, and blockIdx.x runs over b H + h fastest, so the G
// query heads of a kv head run together and meet their K and V in L2.
//
//  * bf16 in, every head dim (32, 64, 128, 256): FlashAttention-3's shape
//    (fa_bf16_kernel).  A block of three warpgroups owns 128 q rows.  One
//    producer thread brings the q tile once and the K and V tiles through
//    a ring in shared memory by TMA (three stages; two at D = 256),
//    signalling full barriers (mbarrier, transaction bytes) and waiting on
//    empty ones; no __syncthreads in the kv loop.  The tensor maps are
//    4-D, (D, heads, seq, B), so rows past S or Sk are zeros within their
//    batch.  Each of the two consumer warpgroups owns 64 q rows: S = Q K^T
//    on wgmma.m64n{BK}k16 (Q and K from shared memory, K-major, 128-byte
//    swizzle; 64-byte at D = 32) and O += P V on wgmma.m64n{D}k16 (two of
//    n128 at D = 256) with P from registers (the logits' accumulator
//    layout is the A fragment) and V from shared memory through the
//    descriptor's transpose bit (MN-major), so V is never transposed.
//    Within a warpgroup the softmax of tile j runs while the P V product
//    of tile j - 1 is in flight: S_j and PV_{j-1} are issued together, the
//    softmax waits for S_j only, and O takes its correction while S_j is
//    computed.  (Taking turns between the two warpgroups with named
//    barriers, FA3's ping-pong, was slower here.)  setmaxnreg gives the
//    producer 40 registers and the consumers 232.  BK = 128 keys a tile
//    for D <= 128, 64 at D = 256 (its P V accumulator alone is 128
//    registers a thread).  The scale (times log2 e, for ex2) is applied to
//    the f32 logits, because q * 2^-3.5 is not exact in bf16; P is rounded
//    to bf16 for the PV product only; l sums the f32 p.  What bounds it:
//    the softmax's exponentials and float work, which the products do not
//    fully hide (PERF.md, section 6).
//  * f32 in: 64-row q tiles of four warps, 64-key K and V tiles staged
//    through shared memory without pipelining; SIMT float FMAs, no TF32,
//    q * (1/sqrt(D)) rounded in f32 as the reference does.  The build has
//    -fmad=false, so the dot products are written with explicit __fmaf_rn
//    (one rounding each).
//
// Head dims 32, 64, 128 and 256 are compiled; the entry point refuses others.
#include <cmath>
#include <cuda_bf16.h>

#include "hopper.cuh"

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

// --------------------------------- bf16 (Hopper: TMA ring, warp-specialised wgmma)

// S = A B^T (scale_d = 0) or S += A B^T (1): A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D += A B: A (64 x 16 bf16) from registers, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
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

constexpr int BQ_BF16 = 128;       // q rows a bf16 block owns: 64 per consumer warpgroup
constexpr int THREADS_BF16 = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65,536

// The bf16 tiles of head dim D.  A row of D elements lies in shared memory
// as D / CH chunks of SW bytes, each chunk a (rows x SW) block in TMA's
// swizzled layout; a tile is its chunks one after another.
template <int D>
struct Bf16Tile {
  static constexpr int BK = D <= 128 ? 128 : 64;         // keys a kv tile holds
  static constexpr int ST = D <= 128 ? 3 : 2;            // stages of the K and V ring
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;   // swizzle span: one row's chunk, bytes
  static constexpr int CH = SW / 2;                       // elements a chunk
  static constexpr int NCH = D / CH;
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;        // the descriptors' swizzle mode
  static constexpr int PV_N = D < 128 ? D : 128;          // columns of O one PV wgmma writes
  static constexpr int NPV = D / PV_N;
  static constexpr int Q_BYTES = BQ_BF16 * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int BARS = 1 + 4 * ST;                 // q; full and empty, K and V, a stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 8 * BARS;  // 1024: alignment
};

// Warpgroup 0 is the producer (its first thread issues every TMA load; the
// rest exit); warpgroups 1 and 2 own q rows q0 + 64 (wg - 1) .. + 63.  In a
// consumer warp w, lane (g, t) = (lane / 4, lane % 4) holds rows 16 w + g
// and 16 w + g + 8 and, of each 8-wide n block of an accumulator, columns
// 2 t and 2 t + 1 (the wgmma accumulator layout; the same as mma.sync's).
template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
    fa_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = Bf16Tile<D>;
  constexpr int BK = T::BK, SW = T::SW, CH = T::CH;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint4 smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  const uint32_t sK = sQ + T::Q_BYTES, sV = sK + T::ST * T::KV_BYTES;
  const uint32_t q_full = sV + T::ST * T::KV_BYTES;
  const auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  const auto full_v = [&](int s) { return q_full + 8 * (1 + T::ST + s); };
  const auto empty_k = [&](int s) { return q_full + 8 * (1 + 2 * T::ST + s); };
  const auto empty_v = [&](int s) { return q_full + 8 * (1 + 3 * T::ST + s); };

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H, kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_BF16;  // heaviest q tiles first
  int n_tiles = (p.Sk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + BQ_BF16, p.S) - 1) / BK + 1);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // lane 0 of each consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c) tma_load(sQ + c * BQ_BF16 * SW, tm_q, q_full, c * CH, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::ST;
        const uint32_t parity = ((j / T::ST) & 1) ^ 1;  // the release of tile j - T::ST
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sK + s * T::KV_BYTES + c * BK * SW, tm_k, full_k(s), c * CH, kvh, j * BK, b);
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sV + s * T::KV_BYTES + c * BK * SW, tm_v, full_v(s), c * CH, kvh, j * BK, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1, ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * cw;  // this warpgroup's first q row
    const int qp[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
    const uint32_t q_rows = sQ + 64 * cw * SW;

    // Descriptors: K-major Q and K (elements 16 kk .. 16 kk + 15 of every
    // row), MN-major V (keys 16 kk .. 16 kk + 15, columns PV_N hf ..).  Each
    // is a base (stage 0) plus an offset in 16-byte units, which only moves
    // the address field.  The base goes through an empty asm once per tile,
    // so the compiler derives the per-kk descriptors in the loop instead of
    // keeping them all live in registers across it.
    const uint64_t q_base = smem_desc(q_rows, 16, 8 * SW, T::LAYOUT);
    const uint64_t k_base = smem_desc(sK, 16, 8 * SW, T::LAYOUT);
    const uint64_t v_base = smem_desc(sV, BK * SW, 8 * SW, T::LAYOUT);
    constexpr auto kmajor_off = [](int kk, int rows) {
      return ((16 * kk / CH) * rows * SW + (16 * kk % CH) * 2) >> 4;
    };
    constexpr auto v_off = [](int kk, int hf) { return (16 * kk * SW + hf * (T::PV_N / CH) * BK * SW) >> 4; };

    float sc[BK / 2];              // logits, then p, of the current kv tile
    float o[T::NPV][T::PV_N / 2];  // acc
    uint32_t pf[BK / 16][4];       // p in bf16, the A fragments of the PV product
    float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int hf = 0; hf < T::NPV; ++hf)
#pragma unroll
      for (int i = 0; i < T::PV_N / 2; ++i) o[hf][i] = 0.f;

    const auto issue_qk = [&](int j) {
      const int s = j % T::ST;
      uint64_t qd = q_base, kd = k_base + s * (T::KV_BYTES >> 4);
      asm volatile("" : "+l"(qd), "+l"(kd));
      mbar_wait(full_k(s), (j / T::ST) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(sc, qd + kmajor_off(kk, BQ_BF16), kd + kmajor_off(kk, BK), kk > 0);
      }
    };
    const auto issue_pv = [&](int j) {
      const int s = j % T::ST;
      uint64_t vd = v_base + s * (T::KV_BYTES >> 4);
      asm volatile("" : "+l"(vd));
      mbar_wait(full_v(s), (j / T::ST) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < T::NPV; ++hf) wgmma_rs<T::PV_N>(o[hf], pf[kk], vd + v_off(kk, hf));
    };
    const auto fence_o = [&]() {
#pragma unroll
      for (int hf = 0; hf < T::NPV; ++hf) fence_regs(o[hf]);
    };
    const auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // online softmax of tile j in the log2 domain, x = (q . k) log2(e) / sqrt(D):
    // sc becomes p, (m, l) move on, corr is the factor for acc
    const auto softmax = [&](int j) {
      const int k0 = j * BK;
      const bool masked = (p.causal && k0 + BK - 1 > wq0) || k0 + BK > p.Sk;
      float mx[2] = {MASK, MASK};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * p.scale;
          if (masked) {
            const int kp = k0 + 8 * n + 2 * t4 + (e & 1);
            if ((p.causal && kp > qp[e >> 1]) || kp >= p.Sk) x = MASK;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 threads of a row are the 4 lanes of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          sc[4 * n + 2 * r] = ex2(sc[4 * n + 2 * r] - m_new);
          sc[4 * n + 2 * r + 1] = ex2(sc[4 * n + 2 * r + 1] - m_new);
          sum += sc[4 * n + 2 * r] + sc[4 * n + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + sum;  // this thread's share of the row sum
        m[r] = m_new;
      }
    };
    const auto rescale_o = [&]() {
#pragma unroll
      for (int hf = 0; hf < T::NPV; ++hf)
#pragma unroll
        for (int i = 0; i < T::PV_N / 2; ++i) o[hf][i] *= corr[(i >> 1) & 1];
    };
    // P rounded to bf16: the logits' accumulator layout is the A fragment of
    // 16 keys = two 8-key n blocks
    const auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    mbar_wait(q_full, 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    release(empty_k(0));
    softmax(0);
    pack_p();
    for (int j = 1; j < n_tiles; ++j) {
      // S_j and PV_{j-1} in flight together; the softmax of tile j waits for
      // S_j only and runs while PV_{j-1} is on the tensor cores.  acc takes
      // tile j - 1's correction while S_j is computed, before PV_{j-1} adds
      // to it (acc = acc corr + p v, the reference's order; acc is 0 at j = 1)
      wgmma_fence();
      issue_qk(j);
      wgmma_commit();
      rescale_o();
      wgmma_fence();
      issue_pv(j - 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      release(empty_k(j % T::ST));
      softmax(j);
      wgmma_wait<0>();
      fence_o();
      release(empty_v((j - 1) % T::ST));
      pack_p();
    }
    rescale_o();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o();

    auto* out = static_cast<bf16*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float den = fmaxf(lr, 1e-30f);
      if (qp[r] >= p.S) continue;
      bf16* row = out + ((static_cast<long long>(b) * p.S + qp[r]) * p.H + h) * D;
#pragma unroll
      for (int hf = 0; hf < T::NPV; ++hf)
#pragma unroll
        for (int n = 0; n < T::PV_N / 8; ++n) {
          *reinterpret_cast<uint32_t*>(row + hf * T::PV_N + 8 * n + 2 * t4) =
              pack_bf16(o[hf][4 * n + 2 * r] / den, o[hf][4 * n + 2 * r + 1] / den);
        }
    }
  }
}

template <int D>
constexpr int smem_f32() {
  return ((BQ + BK) * (D + 4) + BQ * (BK + 4)) * 4;
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t st) {
  const dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
  const cudaError_t err =
      cudaFuncSetAttribute(fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f32<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_f32_kernel<D><<<grid, THREADS, smem_f32<D>(), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of a (B, seq, heads, D) bf16 tensor as 4-D (D, heads, seq,
// B): `geom` is the wrapper's {D, heads, seq, B, heads', seq' and batch
// strides in bytes}.  A box is one chunk of CH elements of `rows` rows of
// one head; rows past seq are zeros within the batch.
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, const long long* geom, int rows) {
  using T = Bf16Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(geom[0]), static_cast<cuuint64_t>(geom[1]),
                              static_cast<cuuint64_t>(geom[2]), static_cast<cuuint64_t>(geom[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(geom[4]), static_cast<cuuint64_t>(geom[5]),
                                 static_cast<cuuint64_t>(geom[6])};
  const cuuint32_t box[4] = {T::CH, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const Params& p, int B, const long long* q_geom, const long long* kv_geom, cudaStream_t st) {
  using T = Bf16Tile<D>;
  const long long q_dims[4] = {D, p.H, p.S, B}, kv_dims[4] = {D, p.KV, p.Sk, B};
  for (int i = 0; i < 4; ++i) {
    if (q_geom[i] != q_dims[i] || kv_geom[i] != kv_dims[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map<D>(&tm_q, p.q, q_geom, BQ_BF16) || !tensor_map<D>(&tm_k, p.k, kv_geom, T::BK) ||
      !tensor_map<D>(&tm_v, p.v, kv_geom, T::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(B * p.H, (p.S + BQ_BF16 - 1) / BQ_BF16);
  const cudaError_t err =
      cudaFuncSetAttribute(fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bf16_kernel<D><<<grid, THREADS_BF16, T::SMEM, st>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, int B, int dtype, const long long* q_geom, const long long* kv_geom,
           cudaStream_t st) {
  return dtype == 0 ? launch_f32<D>(p, B, st) : launch_bf16<D>(p, B, q_geom, kv_geom, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  For bfloat16, q_geom and kv_geom are the
// tensor maps' {D, heads, seq, B, heads', seq' and batch strides in bytes}
// of q (and o) and of k and v; float32 ignores them.  Returns a cudaError_t
// code.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int Sk, int H, int KV, int D, int causal, int dtype,
                                      const long long* q_geom, const long long* kv_geom, void* stream) {
  const int rows = dtype == 0 ? BQ : BQ_BF16;  // q rows a block owns
  if (B < 0 || S < 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H > 0x7fffffff || (S + rows - 1) / rows > 65535 ||
      (dtype == 1 && (q_geom == nullptr || kv_geom == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  const double inv_sqrt = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = dtype == 0 ? static_cast<float>(inv_sqrt)
                                 : static_cast<float>(inv_sqrt * 1.4426950408889634);
  const Params p{q, k, v, o, S, Sk, H, KV, causal, scale};
  auto* st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, dtype, q_geom, kv_geom, st);
    case 64: return launch<64>(p, B, dtype, q_geom, kv_geom, st);
    case 128: return launch<128>(p, B, dtype, q_geom, kv_geom, st);
    case 256: return launch<256>(p, B, dtype, q_geom, kv_geom, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
