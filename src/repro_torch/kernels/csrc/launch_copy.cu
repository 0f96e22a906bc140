// Launch-timing copy: one block copies a small f32 tile, out = x.
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
// Design: one block of 256 threads, each copying every 256th element.
#include "common.cuh"

__global__ void __launch_bounds__(256) launch_copy_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i];
}

extern "C" int launch_copy_launch(const void* x, void* out, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  launch_copy_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
