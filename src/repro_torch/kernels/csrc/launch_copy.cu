// Launch-timing copy: out = x for a small f32 tile.
//
// Replaces the Pallas kernel `_copy` of src/repro/tune/calibrate.py:138
// (inside `_measure_gemm_launch_s`, :130), whose wall time is the
// per-launch overhead the performance model prices (`HW.gemm_launch_s`).
//
// Bound on the H100: bytes.  The calibration's (8, 128) tile moves 4 KiB
// in and 4 KiB out, 8 KiB at 3.35 TB/s: about 2.4 ns, far below any launch,
// so the wall time of a call through the wrapper is the launch path itself
// (ctypes, the C entry point, the CUDA launch and its error check) of the
// GEMM kernels, which share that path.
//
// Design: one vector a thread.  Thread g copies the values [4g, 4g + 4): when
// both pointers are 16-byte aligned as one float4 load and one store, and
// the grid covers the n / 4 vectors in one round (one block of 256 threads
// for the (8, 128) tile).  The scalar tail of fewer than four values, and
// every group when a pointer is not aligned, is copied by scalar loads,
// all issued before any store, so a thread waits on memory once.
#include "common.cuh"

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) launch_copy_kernel(const float* __restrict__ x,
                                                               float* __restrict__ out, int n,
                                                               int vec) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int i = 4 * g;
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    reinterpret_cast<float4*>(out)[g] = reinterpret_cast<const float4*>(x)[g];
    return;
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i + j < n) v[j] = x[i + j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i + j < n) out[i + j] = v[j];
  }
}

extern "C" int launch_copy_launch(const void* x, void* out, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int groups = (n + 3) / 4;
  launch_copy_kernel<<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                            static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}
