"""`repro_torch.linalg` — drop-in matmul routed by the ambient GemmPolicy.

The port's copy of `repro.linalg`: `matmul` and the BLAS-shaped
`sgemm`/`dgemm`/`cgemm`/`zgemm` run the emulated GEMM under the given or
ambient policy (`use_policy` scopes a thread-local stack; the default is
the native policy).

Device rule: every entry point takes ``device=None``, which means
``"cuda"``.  Operands (tensors or numpy arrays) are moved to that device
and the result is returned there.  Without a CUDA device it raises; it
never computes on the CPU unless asked with ``device="cpu"``, which runs
the kernels' plain PyTorch versions.  On the kernel execution the d/zgemm
results are float64-shaped but f32-grade, as in the reference: the residue
cast quantizes through float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from .core.executor import PreparedOperand
from .core.plan import DTYPES, dtype_name
from .core.policy import (
    BACKEND_FOR_DTYPE,
    NATIVE,
    GemmPolicy,
    emulated_matmul,
    policy_matmul,
    prepare_weights,
)

__all__ = [
    "GemmPolicy",
    "PreparedOperand",
    "cgemm",
    "current_policy",
    "dgemm",
    "matmul",
    "prepare_weights",
    "resolve_device",
    "sgemm",
    "use_policy",
    "zgemm",
]

_STATE = threading.local()


def current_policy() -> GemmPolicy:
    """The innermost active `use_policy` policy (default: native)."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else NATIVE


@contextlib.contextmanager
def use_policy(policy: GemmPolicy | str):
    """Scope every `linalg.matmul` in this thread to `policy` (or a backend
    name, shorthand for ``GemmPolicy(backend=name)``).  Nestable; the
    innermost scope wins."""
    if isinstance(policy, str):
        policy = GemmPolicy(backend=policy)
    if not isinstance(policy, GemmPolicy):
        raise TypeError(
            f"use_policy expects a GemmPolicy (or backend name); got {type(policy).__name__}"
        )
    hash(policy)
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(policy)
    try:
        yield policy
    finally:
        stack.pop()


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on: `device`, else the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the emulated GEMM runs on the card; pass "
            "device='cpu' to run the kernels' plain PyTorch versions"
        )
    return device


def matmul(x, w, *, policy: GemmPolicy | None = None, rtol: float | None = None, device=None):
    """Drop-in `torch.matmul(x, w)` under `policy` (default: the ambient
    `use_policy` scope; native when none is active), on `device`.

    x: (..., m, k); w: (k, n) or a batched (..., k, n) operand.  A 2D `w`
    flattens x's leading dims into rows, as in the reference.  `rtol` is
    shorthand for ``dataclasses.replace(policy, rtol=rtol)``.
    """
    policy = current_policy() if policy is None else policy
    if rtol is not None:
        policy = dataclasses.replace(policy, rtol=rtol)
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    w = torch.as_tensor(w, device=device)
    if x.ndim < 2 or w.ndim < 2:
        raise ValueError(
            "linalg.matmul expects matrix operands (ndim >= 2); got shapes "
            f"{tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if w.ndim == 2:
        return policy_matmul(x, w, policy)
    if policy.backend == "native":
        y = torch.matmul(x, w)
        return y if policy.out_dtype is None else y.to(DTYPES[policy.out_dtype])
    return emulated_matmul(x, w, policy)


def _blas(dtype, x, w, policy: GemmPolicy | None, device):
    base = current_policy() if policy is None else policy
    pol = dataclasses.replace(base, backend=BACKEND_FOR_DTYPE[dtype_name(dtype)])
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device).to(dtype)
    w = torch.as_tensor(w, device=device).to(dtype)
    return matmul(x, w, policy=pol, device=device)


def sgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated SGEMM: f32 compute, every other knob (mode, execution,
    n_block, ...) from `policy` / the ambient scope."""
    return _blas(torch.float32, x, w, policy, device)


def dgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated DGEMM: f64 compute, every other knob from the policy.  On
    the kernel execution the output is f64-shaped but f32-grade."""
    return _blas(torch.float64, x, w, policy, device)


def cgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated CGEMM (paper SIII): complex64 compute; the complex product
    strategy is the policy's `formulation`, default Karatsuba."""
    return _blas(torch.complex64, x, w, policy, device)


def zgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated ZGEMM (paper SIII): complex128 compute (f32-grade on the
    kernel execution)."""
    return _blas(torch.complex128, x, w, policy, device)
