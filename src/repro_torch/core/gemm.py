"""DEPRECATED real-GEMM entry point — use `repro_torch.linalg` + `GemmPolicy`.

The port's copy of `repro.core.gemm`: `ozaki2_gemm` is a shim over

    repro_torch.linalg.matmul(a, b, policy=GemmPolicy(backend=..., ...))

under the equivalent policy (the default `reference` execution), so its
results are that call's bit for bit.  It warns `DeprecationWarning` on
every call.
"""
from __future__ import annotations

import warnings

import torch

from .executor import PreparedOperand, gemm_prepared
from .plan import DEFAULT_MODULI, default_n_moduli, dtype_name, n_limbs_for_ctx

__all__ = [
    "DEFAULT_MODULI",
    "PreparedOperand",
    "default_n_moduli",
    "gemm_prepared",
    "ozaki2_gemm",
]

# limb count for the residue decomposition, under the reference's old name
_n_limbs = n_limbs_for_ctx


def _deprecated(name: str, policy, stacklevel: int = 3) -> None:
    """The deprecation warning of every legacy ozaki2_* entry point."""
    warnings.warn(
        f"{name} is deprecated; call repro_torch.linalg.matmul under "
        f"repro_torch.use_policy({policy!r}) (or pass policy= explicitly)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )


def _shim_policy(dtype, **kw):
    from .policy import BACKEND_FOR_DTYPE, GemmPolicy

    name = dtype_name(dtype)
    return GemmPolicy(backend=BACKEND_FOR_DTYPE[name], **kw)


def _shim_matmul(a, b, policy, device):
    """The shims' product: `linalg.matmul` for 2-D operands; batched
    operands keep the reference's per-slice semantics (`emulated_matmul`)."""
    from .. import linalg
    from .executor import resolve_device
    from .policy import emulated_matmul

    if a.ndim == 2 and b.ndim == 2:
        return linalg.matmul(a, b, policy=policy, device=device)
    device = resolve_device(device)
    return emulated_matmul(a.to(device), b.to(device), policy)


def ozaki2_gemm(a: torch.Tensor, b: torch.Tensor, n_moduli: int | None = None, mode: str = "fast",
                method: str = "paper", out_dtype=None, n_block: int | None = None, *,
                device=None) -> torch.Tensor:
    """Emulated high-precision real GEMM: C ~= A @ B.

    .. deprecated:: use ``repro_torch.linalg.matmul`` with a
       ``GemmPolicy(backend="ozaki2_f32"/"ozaki2_f64", ...)`` instead.

    a: (..., m, k), b: (..., k, n) tensors of one dtype (batched over
    leading dims); complex operands take the complex plan.  ``device``: as
    for the `linalg` entry points (None: the card).
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch {a.dtype} vs {b.dtype}")
    policy = _shim_policy(
        a.dtype, n_moduli=n_moduli, mode=mode, method=method,
        out_dtype=None if out_dtype is None else dtype_name(out_dtype), n_block=n_block,
    )
    _deprecated("ozaki2_gemm", policy)
    return _shim_matmul(a, b, policy, device)
