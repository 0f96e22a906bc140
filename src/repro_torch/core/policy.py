"""GEMM backend policy — the framework-facing integration of the technique.

The port's copy of `repro.core.policy`, forward only.  A :class:`GemmPolicy`
answers every static question about a matmul: *what* to emulate
(``backend``), *how precisely* (``n_moduli``/``mode``/``method``/
``out_dtype``), *which complex strategy* (``formulation``/``n_block``) and
*where* to run it (``execution``).  The port runs ``execution="kernel"``:
the four hand-written kernels, 4 launches per GEMM at any N.

The reference's other knobs keep their names and defaults here and raise
`NotImplementedError`, naming the ROADMAP item (queue 1) that brings them,
when a value other than the default asks for them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .executor import run_plan
from .plan import DTYPES, dtype_name, make_plan

Backend = Literal["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"]
Execution = Literal["reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused"]

EXECUTIONS = ("reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused")

# the ROADMAP (queue 1) item that ports each execution still missing here
_EXECUTION_ITEM = {
    "reference": "the 'reference' execution",
    "per_modulus_kernel": "the 'per_modulus_kernel' execution",
    "fused": "the 'fused' execution",
    "fp8": "the 'fp8' execution",
    "sharded": "distributed + the 'sharded' execution",
}

_COMPUTE_DTYPES = {
    "native": None,
    "ozaki2_f32": torch.float32,
    "ozaki2_f64": torch.float64,
    "ozaki2_c64": torch.complex64,
    "ozaki2_c128": torch.complex128,
}

# the ozaki2_* backend matching each compute dtype (the BLAS wrappers)
BACKEND_FOR_DTYPE = {
    "float32": "ozaki2_f32",
    "float64": "ozaki2_f64",
    "complex64": "ozaki2_c64",
    "complex128": "ozaki2_c128",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {item})")


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Static (hashable) matmul policy, field for field the reference's.

    ``backend``: ``"native"`` (plain ``torch.matmul``) or ``"ozaki2_f32"`` /
    ``"ozaki2_f64"`` / ``"ozaki2_c64"`` / ``"ozaki2_c128"``
    (SGEMM/DGEMM/CGEMM/ZGEMM emulation).  ``n_moduli``: CRT moduli count
    (None: the paper's per-(dtype, mode) default).  ``mode``: ``"fast"``
    (eqs. 11-12) or ``"accu"`` (eqs. 13-14).  ``method``: ``"auto"`` or
    ``"garner"`` on the kernel execution.  ``formulation``: ``"karatsuba"``,
    ``"block_a"`` or ``"block_b"``.  ``n_block``: an int, None or
    ``"auto"``.  ``execution``: ``"kernel"`` runs; the default
    ``"reference"`` and the others raise when used.  ``out_dtype``: result
    dtype name.  ``mesh``, ``shard_axes``, ``calibration``, ``rtol`` and
    ``mode="auto"`` raise.  The reference's ``interpret`` has no
    counterpart: tensors on the CPU take the plain versions.
    """

    backend: Backend = "native"
    n_moduli: int | None = None
    mode: str = "fast"
    method: str = "auto"
    formulation: str = "karatsuba"
    n_block: int | str | None = None
    execution: Execution = "reference"
    out_dtype: str | None = None
    mesh: object | None = None
    shard_axes: tuple | None = None
    calibration: str | None = None
    rtol: float | None = None

    def __post_init__(self):
        if self.backend not in _COMPUTE_DTYPES:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.mode not in ("fast", "accu", "auto"):
            raise ValueError(f"unknown mode {self.mode!r}; expected 'fast', 'accu' or 'auto'")
        if self.execution not in EXECUTIONS:
            raise ValueError(f"unknown execution {self.execution!r}; expected one of {EXECUTIONS}")
        if self.execution != "reference" and self.method not in ("auto", "garner"):
            raise ValueError(
                f"execution={self.execution!r} reconstructs via the Garner "
                f"kernel only; method={self.method!r} is reference-path only"
            )
        if self.rtol is not None or self.mode == "auto":
            raise _not_ported("accuracy-adaptive rtol / mode='auto'",
                              "'Performance model + accuracy bounds'")
        if self.mesh is not None or self.shard_axes is not None:
            raise _not_ported("a mesh", "'Distributed + sharded execution'")
        if self.calibration is not None:
            raise _not_ported("a calibration file", "'Tuning'")
        if self.out_dtype is not None:
            object.__setattr__(self, "out_dtype", dtype_name(self.out_dtype))

    @property
    def compute_dtype(self):
        return _COMPUTE_DTYPES[self.backend]

    @property
    def is_complex(self) -> bool:
        return self.backend in ("ozaki2_c64", "ozaki2_c128")

    @property
    def resolved_method(self) -> str:
        """The CRT reconstruction this policy actually runs."""
        if self.method != "auto":
            return self.method
        return "paper" if self.execution == "reference" else "garner"

    def execution_backend(self):
        """The residue backend of this policy's execution."""
        if self.execution != "kernel":
            raise _not_ported(f"execution={self.execution!r}", _EXECUTION_ITEM[self.execution])
        from ..kernels.ops import KernelBackend

        return KernelBackend()

    def plan_for(self, m: int, k: int, n: int):
        """The `EmulationPlan` this policy runs for an (m,k)x(k,n) product."""
        if self.backend == "native":
            raise ValueError("native policy has no emulation plan")
        self.execution_backend()  # raises for an execution not ported yet
        return make_plan(
            self.compute_dtype,
            n_moduli=self.n_moduli,
            mode=self.mode,
            method=self.resolved_method,
            formulation=self.formulation if self.is_complex else None,
            out_dtype=self.out_dtype,
            n_block=self.n_block,
            shape=(m, k, n),
        )


NATIVE = GemmPolicy()


def _real_cast(y: torch.Tensor, dtype) -> torch.Tensor:
    """`.to` that is explicit about dropping an imaginary part."""
    dtype = DTYPES[dtype_name(dtype)]
    if y.is_complex() and not dtype.is_complex:
        y = y.real
    return y.to(dtype)


def emulated_matmul(x: torch.Tensor, w: torch.Tensor, policy: GemmPolicy) -> torch.Tensor:
    """The emulated forward product x @ w (batched over leading dims)."""
    if x.requires_grad or w.requires_grad:
        raise _not_ported("the backward pass of an emulated matmul",
                          "'torch.autograd.Function backward'")
    ct = policy.compute_dtype
    plan = policy.plan_for(x.shape[-2], x.shape[-1], w.shape[-1])
    y = run_plan(plan, x.to(ct), w.to(ct), policy.execution_backend())
    return _real_cast(y, policy.out_dtype or x.dtype)


def policy_matmul(x: torch.Tensor, w, policy: GemmPolicy) -> torch.Tensor:
    """x: (..., k) @ w: (k, n) under the policy's backend and execution."""
    if policy.backend == "native":
        y = torch.matmul(x, w)
        return y if policy.out_dtype is None else y.to(DTYPES[policy.out_dtype])
    lead = x.shape[:-1]
    y = emulated_matmul(x.reshape(-1, x.shape[-1]), w, policy)
    return y.reshape(*lead, w.shape[-1])


def prepare_weights(params, policy: GemmPolicy):
    """Pre-cast every linear weight in a param tree (serving): not ported."""
    raise _not_ported("prepare_weights", "'PreparedOperand / prepare_weights'")
