// Hopper (sm_90a) primitives shared by the port's warp-specialised kernels
// (flash_attention.cu, fp8_karatsuba.cu, fp8_mod_gemm.cu,
// int8_mod_gemm.cu, karatsuba_fused.cu), its cluster kernels
// (fused_karatsuba.cu and fused_mod_gemm.cu through residue_fma.cuh) and
// crt_garner.cu: mbarriers, TMA loads, the tensor-map encoder and the 3-D
// int8 tensor map with its TMA rule (`uses_tma`, and `REPRO_USES_TMA_ENTRY`,
// its C entry), wgmma shared-memory descriptors, the swizzled byte layout
// they name, the wgmma fence / commit / wait and the s8 wgmma products,
// masked 4-byte global loads, shared-memory loads and stores by address,
// and the thread-block-cluster barrier, launch configuration and
// distributed-shared-memory stores.
#pragma once

#include <cuda.h>

#include "common.cuh"

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The same across a cluster: an arrival on a barrier of another block of
// the cluster (a `shared::cluster` address), releasing this thread's
// writes to the threads that then acquire the phase with mbar_wait_cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

// An arrival on a barrier of another block of the cluster with the
// default, CTA-scope release; its owner waits with mbar_wait (CTA-scope
// acquire).  Enough where the order carried is write-after-read of reads
// already complete (wgmma.wait_group or ldmatrix returned them), as in a
// stage ring's "empty" barriers, and far cheaper than the cluster-scope
// release above: in karatsuba_fused.cu and fused_mod_gemm.cu that cost
// thousands of cycles a slice (PERF.md section 6).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// one box of a 3-D tensor map at coordinates (c0 innermost .. c2) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 4-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query,
// so that a library needs no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

inline bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

// The TMA rule of the int8 GEMM kernels that load by TMA: an operand is
// mapped when its rows are a multiple of 16 bytes apart and its base is
// 16-byte aligned (A rows are k bytes, B rows n bytes).  Shape and alignment
// alone decide; a launch that fails it takes the kernel's global-load path.
inline bool uses_tma(const void* a0, const void* a1, const void* b0, const void* b1, int n, int k) {
  return k > 0 && k % 16 == 0 && n % 16 == 0 && aligned(a0, 16) && aligned(a1, 16) && aligned(b0, 16) &&
         aligned(b1, 16);
}

// The 3-D tensor map (inner, outer, planes) of an int8 stack, box (bi, bo, 1)
// in the given swizzle; boxes past the edge read zeros.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer, int planes, int box_inner,
                       int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner),
                                 static_cast<cuuint64_t>(inner) * static_cast<cuuint64_t>(outer)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The C entry `repro_uses_tma` of the rule, which each kernel source that
// loads by TMA expands once (fp8_karatsuba.cu, fp8_mod_gemm.cu,
// int8_mod_gemm.cu, karatsuba_fused.cu; the wrappers read it through `build.uses_tma`): whether
// a launch on operands (a0, a1) (m, k) and (b0, b1) (k, n) takes the TMA path
// (1) or the global-load path (0); a kernel of one A and one B operand passes
// each twice.
#define REPRO_USES_TMA_ENTRY                                                                                \
  extern "C" int repro_uses_tma(const void* a0, const void* a1, const void* b0, const void* b1, int n, int k) { \
    return uses_tma(a0, a1, b0, b1, n, k) ? 1 : 0;                                                         \
  }

// Four bytes at src, of which the first `valid` exist (zeros for the rest);
// one 4-byte load when `vec` and all four exist.
__device__ __forceinline__ uint32_t load_word(const int8_t* src, int valid, bool vec) {
  if (valid <= 0) return 0u;
  if (vec && valid >= 4) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < valid) w |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
  }
  return w;
}

// ---- shared memory by address ------------------------------------------------

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 ld_shared4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v0, uint32_t v1) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v0), "r"(v1) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (given in bytes, stored in 16-byte units), swizzle mode (1:
// 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | static_cast<uint64_t>(layout) << 62;
}

// Byte offset of (row, byte col) in a [rows][BK] tile in the swizzle that
// TMA and wgmma name for BK-byte rows: the 16-byte chunk index XOR bits of
// the row (64 bytes: row / 2 mod 4; 128 bytes: row mod 8).
template <int BK>
__device__ __forceinline__ int swizzled(int row, int col) {
  const int x = BK == 128 ? (row & 7) : ((row >> 1) & 3);
  return row * BK + (((col >> 4) ^ x) << 4) + (col & 15);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma accumulators
// across the issue and wait instructions
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D += A B on one m64n{N}k32 s8 step (karatsuba_fused.cu, int8_mod_gemm.cu): A and B from shared memory, both
// K-major (8-bit types take no transpose), int32 accumulators.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) wgmma_s8_n64(d, a, b);
  else wgmma_s8_n128(d, a, b);
}

// keep the compiler from moving reads or writes of the accumulators across
// the wgmma issue and wait instructions
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- thread-block clusters ---------------------------------------------------
// A cluster's blocks write into each other's shared memory (distributed
// shared memory) through `shared::cluster` addresses.  The rank of the block
// at cluster position (x, y) is x + y * (cluster width).

__device__ __forceinline__ uint32_t cluster_map(uint32_t smem_addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

// Copy `bytes` (a multiple of 16) of this block's shared memory at `src`
// into another block's at `dst` (a shared::cluster address) on the async
// proxy, completing `bytes` of the transaction count of that block's
// barrier `bar` (a shared::cluster address).  The source must be written
// before the copy is issued and be made visible to the async proxy
// (fence_proxy_async_shared by each writer, then a barrier).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// order this thread's shared-memory writes before later async-proxy reads
// (wgmma, bulk copies)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (its shared-memory writes, local and remote, released)
// before any passes the wait (and acquires them).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch of `kernel` on `grid` (x along n, y along m) padded to whole
// cn x cm thread-block clusters, with `smem` bytes of dynamic shared memory;
// `attr` holds the cluster attribute `cfg` points to.
template <class Kernel>
cudaError_t cluster_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, Kernel kernel, dim3 grid,
                                  int threads, int smem, int cn, int cm, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((grid.x + cn - 1) / cn * cn, (grid.y + cm - 1) / cm * cm, grid.z);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cn;
  attr.val.clusterDim.y = cm;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}
