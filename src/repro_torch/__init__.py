"""PyTorch/CUDA port of `repro`: Ozaki-II CRT emulation of SGEMM/DGEMM/
CGEMM/ZGEMM on int8 tensor cores, for one NVIDIA H100.

This package imports torch and numpy, never JAX and nothing of `repro`.
Its entry points are `repro_torch.linalg` (`matmul`, `sgemm`, `dgemm`,
`cgemm`, `zgemm`, and `prepare_weights` for serving) under a `GemmPolicy`:
the default `execution="reference"` runs the scheme in plain PyTorch at
float64 grade, `execution="kernel"` on four hand-written Hopper kernels,
`execution="per_modulus_kernel"` on the same kernels one modulus at a
time, `execution="fused"` on one of two megakernels per GEMM, and
`execution="fp8"` with the residue products on two e4m3 tensor-core
kernels (`repro_torch.kernels`), and `execution="sharded"` the kernel
execution spread over a `torch.distributed` device mesh
(`repro_torch.distributed`, `launch.mesh`); all differentiate through
`torch.autograd`.  They compute on the card unless the caller passes
``device="cpu"``.
`python -m repro_torch.tune` calibrates the card and tunes the kernels'
tiles for the policies' automatic choices (`repro_torch.tune`).
`repro_torch.models`, `configs`, `checkpoint` and `serve` (with
`python -m repro_torch.launch.serve`) serve the model zoo's
attention-family archs with every linear on the emulated GEMM.
"""
from . import linalg
from .core.policy import GemmPolicy
from .linalg import current_mesh, current_policy, use_mesh, use_policy

__all__ = ["GemmPolicy", "current_mesh", "current_policy", "linalg", "use_mesh", "use_policy"]
