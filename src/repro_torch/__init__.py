"""PyTorch/CUDA port of `repro`: Ozaki-II CRT emulation of SGEMM/DGEMM/
CGEMM/ZGEMM on int8 tensor cores, for one NVIDIA H100.

This package imports torch and numpy, never JAX and nothing of `repro`.
Its entry points are `repro_torch.linalg` (`matmul`, `sgemm`, `dgemm`,
`cgemm`, `zgemm`, and `prepare_weights` for serving) under a
`GemmPolicy(execution="kernel")`, which runs four hand-written Hopper
kernels, `GemmPolicy(execution="fused")`, which runs one of two
megakernels per GEMM, or `GemmPolicy(execution="fp8")`, which runs the
residue products on two e4m3 tensor-core kernels (`repro_torch.kernels`);
they compute on the card unless the caller passes ``device="cpu"``.
`python -m repro_torch.tune` calibrates the card and tunes the kernels'
tiles for the policies' automatic choices (`repro_torch.tune`).
"""
from . import linalg
from .core.policy import GemmPolicy
from .linalg import current_policy, use_policy

__all__ = ["GemmPolicy", "current_policy", "linalg", "use_policy"]
