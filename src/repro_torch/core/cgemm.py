"""DEPRECATED complex-GEMM entry point — use `repro_torch.linalg` + `GemmPolicy`.

The port's copy of `repro.core.cgemm`: `ozaki2_cgemm` is a shim over
`repro_torch.linalg.matmul` under the equivalent policy, the complex
strategy chosen by its `formulation` ('karatsuba' | 'block_a' | 'block_b'
| 'auto'), so its results are that call's bit for bit.  It warns
`DeprecationWarning` on every call.
"""
from __future__ import annotations

import torch

from .gemm import _deprecated, _shim_matmul, _shim_policy
from .plan import DEFAULT_N_BLOCK, dtype_name

__all__ = ["DEFAULT_N_BLOCK", "ozaki2_cgemm"]


def ozaki2_cgemm(a: torch.Tensor, b: torch.Tensor, n_moduli: int | None = None, mode: str = "fast",
                 method: str = "paper", formulation: str = "karatsuba", out_dtype=None,
                 n_block: int | None = None, *, device=None) -> torch.Tensor:
    """Emulated complex GEMM: C ~= A @ B for complex64 (CGEMM) / complex128
    (ZGEMM) operands, per the paper's Ozaki-II complex extension.

    .. deprecated:: use ``repro_torch.linalg.cgemm``/``zgemm`` (or
       ``repro_torch.linalg.matmul`` with a ``GemmPolicy(backend=
       "ozaki2_c64" / "ozaki2_c128", formulation=...)``) instead.
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch {a.dtype} vs {b.dtype}")
    if not a.is_complex():
        raise ValueError("ozaki2_cgemm expects complex operands")
    policy = _shim_policy(
        a.dtype, n_moduli=n_moduli, mode=mode, method=method, formulation=formulation,
        out_dtype=None if out_dtype is None else dtype_name(out_dtype), n_block=n_block,
    )
    _deprecated("ozaki2_cgemm", policy)
    return _shim_matmul(a, b, policy, device)
