"""`repro_torch.linalg` — drop-in matmul routed by the ambient GemmPolicy.

The port's copy of `repro.linalg`: `matmul` and the BLAS-shaped
`sgemm`/`dgemm`/`cgemm`/`zgemm` run the emulated GEMM under the given or
ambient policy (`use_policy` scopes a thread-local stack; the default is
the native policy).

Device rule: every entry point takes ``device=None``, which means
``"cuda"``.  Operands (tensors or numpy arrays) are moved to that device
and the result is returned there.  Without a CUDA device it raises; it
never computes on the CPU unless asked with ``device="cpu"``, which runs
the kernels' plain PyTorch versions.  Five executions run: the default
``execution="reference"`` (plain PyTorch in float64 with every CRT method:
f64-grade d/zgemm, no hand-written kernel), ``"kernel"`` (4 launches per
GEMM), ``"per_modulus_kernel"`` (one product launch per modulus),
``"fused"`` (1 megakernel launch) and ``"fp8"`` (4 launches, the products
on the e4m3 engine).  The four kernel executions are bitwise equal, and
their d/zgemm results are float64-shaped but f32-grade, as in the
reference: the residue cast quantizes through float32 (at f32 grade,
s/cgemm, they are also the reference execution's bits).  Every execution
differentiates: the backward emulates dX = G W^H and dW = X^H G under the
same policy (conjugate transposes for complex operands, `torch.matmul`'s
convention).

Automatic choices: ``GemmPolicy(formulation="auto")``, ``mode="auto"`` with
``rtol`` (or ``matmul(..., rtol=)``) and a pinned ``calibration=`` file
written by ``python -m repro_torch.tune`` run as in the reference, priced
by the port's performance model against the measured card (the GH200
preset without a calibration); a calibration also picks the kernels'
tuned tiles, which never change the bits.

Prepared serving: `prepare_weights` casts the ``"w"`` weights of a param
tree once; `matmul` and the BLAS wrappers accept such a right-side
`PreparedOperand` in place of the weight::

    pol = GemmPolicy(backend="ozaki2_c128", execution="fused")
    params = prepare_weights({"w": w}, pol)          # on the card
    y = zgemm(x, params["w"], policy=pol)            # 1 launch per request
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from .core.executor import PreparedOperand, resolve_device
from .core.plan import DTYPES, dtype_name
from .core.policy import (
    BACKEND_FOR_DTYPE,
    NATIVE,
    GemmPolicy,
    current_mesh,
    emulated_matmul,
    policy_matmul,
    prepare_weights,
    use_mesh,
)

__all__ = [
    "GemmPolicy",
    "PreparedOperand",
    "cgemm",
    "current_mesh",
    "current_policy",
    "dgemm",
    "matmul",
    "prepare_weights",
    "resolve_device",
    "sgemm",
    "use_mesh",
    "use_policy",
    "zgemm",
]

_STATE = threading.local()


def current_policy() -> GemmPolicy:
    """The innermost active `use_policy` policy (default: native)."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else NATIVE


@contextlib.contextmanager
def use_policy(policy: GemmPolicy | str, *, mesh=None):
    """Scope every `linalg.matmul` in this thread to `policy` (or a backend
    name, shorthand for ``GemmPolicy(backend=name)``).  Nestable; the
    innermost scope wins.  `mesh` (a `DeviceMesh`) also scopes the default
    mesh (`use_mesh`) that a ``GemmPolicy(execution="sharded", mesh=None)``
    runs on, so one statement spreads every matmul of a model over it."""
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
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        stack.append(policy)
        try:
            yield policy
        finally:
            stack.pop()


@contextlib.contextmanager
def _no_ambient_policy():
    """Clear the ambient stack for the scope: the registry configs built at
    import time stay scope-independent (the configs registry re-pins the
    ambient policy at lookup instead)."""
    stack = getattr(_STATE, "stack", None)
    _STATE.stack = []
    try:
        yield
    finally:
        _STATE.stack = stack if stack is not None else []


def matmul(x, w, *, policy: GemmPolicy | None = None, rtol: float | None = None, device=None):
    """Drop-in `torch.matmul(x, w)` under `policy` (default: the ambient
    `use_policy` scope; native when none is active), on `device`.

    x: (..., m, k); w: (k, n), a batched (..., k, n) operand, or a
    right-side `PreparedOperand` (which stays where it was prepared).  A 2D
    `w` flattens x's leading dims into rows, as in the reference.  `rtol`
    is shorthand for ``dataclasses.replace(policy, rtol=rtol)``: the moduli
    count (and with ``mode="auto"`` the scaling mode) is then resolved per
    call as the cheapest plan whose componentwise error bound provably meets
    the tolerance (`core.accuracy`), a 2D product probing its operands.
    """
    policy = current_policy() if policy is None else policy
    if rtol is not None:
        policy = dataclasses.replace(policy, rtol=rtol)
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    if isinstance(w, PreparedOperand):
        return policy_matmul(x, w, policy)
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
    if policy.is_adaptive:
        # resolve statically (one plan for every batch element); the 2D
        # path above additionally probes the concrete operands
        policy = policy.resolve_adaptive(x.shape[-2], x.shape[-1], w.shape[-1])
    return emulated_matmul(x, w, policy)


def _blas(routine, dtype, x, w, policy: GemmPolicy | None, device):
    base = current_policy() if policy is None else policy
    name = dtype_name(dtype)
    pol = dataclasses.replace(base, backend=BACKEND_FOR_DTYPE[name])
    if isinstance(w, PreparedOperand):
        if w.dtype != name:
            raise ValueError(
                f"{routine} computes in {name} but the prepared operand was cast for {w.dtype}"
            )
        return matmul(x, w, policy=pol, device=device)
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device).to(dtype)
    w = torch.as_tensor(w, device=device).to(dtype)
    return matmul(x, w, policy=pol, device=device)


def sgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated SGEMM: f32 compute, every other knob (mode, execution,
    n_block, ...) from `policy` / the ambient scope."""
    return _blas("sgemm", torch.float32, x, w, policy, device)


def dgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated DGEMM: f64 compute, every other knob from the policy.  On
    the kernel executions the output is f64-shaped but f32-grade; on the
    reference execution it is f64-grade."""
    return _blas("dgemm", torch.float64, x, w, policy, device)


def cgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated CGEMM (paper SIII): complex64 compute; the complex product
    strategy is the policy's `formulation`, default Karatsuba."""
    return _blas("cgemm", torch.complex64, x, w, policy, device)


def zgemm(x, w, *, policy: GemmPolicy | None = None, device=None):
    """Emulated ZGEMM (paper SIII): complex128 compute (f32-grade on the
    kernel executions, f64-grade on the reference execution)."""
    return _blas("zgemm", torch.complex128, x, w, policy, device)
