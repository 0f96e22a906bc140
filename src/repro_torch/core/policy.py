"""GEMM backend policy — the framework-facing integration of the technique.

The port's copy of `repro.core.policy`.  A :class:`GemmPolicy` answers
every static question about a matmul: *what* to emulate (``backend``),
*how precisely* (``n_moduli``/``mode``/``method``/``out_dtype``), *which
complex strategy* (``formulation``/``n_block``) and *where* to run it
(``execution``).  The port runs the reference's six executions: the
default ``"reference"`` (plain PyTorch in float64, every CRT method,
f64-grade; no hand-written kernel), ``"kernel"`` (four hand-written
kernels, 4 launches per GEMM at any N), ``"per_modulus_kernel"`` (the
same kernels, one product launch per modulus), ``"fused"`` (one
megakernel launch per GEMM), ``"fp8"`` (the kernel execution's casts and
Garner around residue products on the e4m3 engine, 4 launches per GEMM)
and ``"sharded"`` (the kernel execution spread over a `torch.distributed`
device mesh, `distributed/sharded_gemm.py`).  The kernel executions
quantize through float32 (f32-grade) and are bitwise equal to one
another.  `policy_matmul` also serves a weight prepared up
front (`prepare_weights`, a right-side `PreparedOperand`).

Backward: `emulated_matmul` is a `torch.autograd.Function` whose cotangent
products are emulated under the same policy, dX = G W^T and dW = X^T G;
for complex operands with conjugate transposes, dX = G W^H and dW = X^H G,
`torch.matmul`'s own rule (the reference takes plain transposes, JAX's
convention).

The automatic choices run as in the reference: ``formulation="auto"`` and
``n_block="auto"`` through the performance model (`core/perfmodel.py`),
``rtol`` / ``mode="auto"`` through the accuracy bounds (`core/accuracy.py`,
`resolve_adaptive`), both priced against `perfmodel.default_hw()`: the
measured card under a `repro_torch.tune` calibration (``calibration=`` or
an ambient `use_calibration`), else the GH200 preset.  The calibration's
tuned tiles are what the kernels launch.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with dims named
from ``("pod", "data", "model", "residue")``: pinned in the policy
(``mesh=``) or scoped by `use_mesh` / `linalg.use_policy(policy,
mesh=...)`; ``execution="fused"`` under a mesh runs sharded too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Literal

import numpy as np
import torch

from .executor import REFERENCE, PreparedOperand, gemm_prepared, run_plan
from .plan import DTYPES, default_n_moduli, dtype_name, make_plan

Backend = Literal["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"]
Execution = Literal["reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused"]

EXECUTIONS = ("reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused")

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


_MESH_STATE = threading.local()


def _check_mesh(mesh):
    from torch.distributed.device_mesh import DeviceMesh

    from ..distributed.sharding import MESH_AXES

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch.distributed DeviceMesh; got {type(mesh).__name__}")
    if not mesh.mesh_dim_names or not set(mesh.mesh_dim_names) <= set(MESH_AXES):
        raise ValueError(f"mesh dims must be named from {MESH_AXES}; got {mesh.mesh_dim_names}")


def current_mesh():
    """The innermost `use_mesh` mesh (None outside any scope): the mesh a
    ``GemmPolicy(execution="sharded", mesh=None)`` runs on."""
    stack = getattr(_MESH_STATE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Scope the thread's default mesh for sharded policies.  Nestable; the
    innermost scope wins.  `linalg.use_policy(policy, mesh=...)` enters
    this scope with the policy's."""
    _check_mesh(mesh)
    stack = getattr(_MESH_STATE, "stack", None)
    if stack is None:
        stack = _MESH_STATE.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Static (hashable) matmul policy, field for field the reference's.

    ``backend``: ``"native"`` (plain ``torch.matmul``) or ``"ozaki2_f32"`` /
    ``"ozaki2_f64"`` / ``"ozaki2_c64"`` / ``"ozaki2_c128"``
    (SGEMM/DGEMM/CGEMM/ZGEMM emulation).  ``n_moduli``: CRT moduli count
    (None: the paper's per-(dtype, mode) default).  ``mode``: ``"fast"``
    (eqs. 11-12) or ``"accu"`` (eqs. 13-14).  ``method``: ``"auto"``,
    ``"paper"``, ``"dd"`` or ``"garner"`` on the reference execution (auto:
    ``"paper"``), ``"auto"`` or ``"garner"`` on the others.
    ``formulation``: ``"karatsuba"``, ``"block_a"``, ``"block_b"`` or
    ``"auto"`` (the strategy the performance model prices fastest).
    ``n_block``: an int, None or ``"auto"``.  ``execution``: the default
    ``"reference"``, ``"kernel"``, ``"per_modulus_kernel"``, ``"fused"``,
    ``"fp8"`` or ``"sharded"``.
    ``out_dtype``: result dtype name.  ``mode="auto"`` (needs ``rtol``) and
    ``rtol``: the cheapest (mode, n_moduli) whose proven error bound meets
    the tolerance (`resolve_adaptive`).  ``calibration``: the path of a
    `repro_torch.tune` cache pinned for this policy's 'auto' decisions and
    kernel tiles (an unfit file warns once and changes nothing).  ``mesh``:
    the `DeviceMesh` of the sharded execution (None: the `use_mesh`
    scope's); ``shard_axes``: an optional (residue, m, n) triple of its dim
    names.  The reference's ``interpret`` has no counterpart: tensors on
    the CPU take the plain versions.
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
        if self.rtol is not None and not float(self.rtol) > 0.0:
            raise ValueError(f"rtol must be > 0, got {self.rtol!r}")
        if self.mode == "auto" and self.rtol is None:
            raise ValueError(
                "mode='auto' picks the cheapest (mode, n_moduli) pair meeting "
                "an accuracy target — pass GemmPolicy(rtol=...) to declare it"
            )
        if self.execution not in EXECUTIONS:
            raise ValueError(f"unknown execution {self.execution!r}; expected one of {EXECUTIONS}")
        if self.execution != "reference" and self.method not in ("auto", "garner"):
            raise ValueError(
                f"execution={self.execution!r} reconstructs via the Garner "
                f"kernel only; method={self.method!r} is reference-path only"
            )
        if self.mesh is not None:
            _check_mesh(self.mesh)
        if self.shard_axes is not None:
            from ..distributed.sharding import MESH_AXES

            if len(self.shard_axes) != 3 or any(ax is not None and ax not in MESH_AXES
                                                for ax in self.shard_axes):
                raise ValueError(
                    f"shard_axes is a (residue, m, n) triple of mesh dims from {MESH_AXES} "
                    f"or None; got {self.shard_axes!r}")
            object.__setattr__(self, "shard_axes", tuple(self.shard_axes))
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

    def resolved_mesh(self):
        """The mesh a sharded execution runs on: the pinned one, else the
        `use_mesh` scope's."""
        mesh = self.mesh if self.mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError(
                "execution='sharded' needs a mesh: pass GemmPolicy(mesh=...) or enter "
                "use_mesh(mesh) / repro_torch.use_policy(policy, mesh=mesh)"
            )
        return mesh

    def _mesh_pinned(self) -> "GemmPolicy":
        """This policy with the `use_mesh` scope's mesh pinned where its
        execution reads one: the backward's products then run on the
        forward's mesh, wherever `backward` is called."""
        if self.mesh is None and current_mesh() is not None and self._sharded():
            return dataclasses.replace(self, mesh=current_mesh())
        return self

    def _sharded(self) -> bool:
        """Whether this policy runs over a mesh: `sharded`, or `fused`
        with a pinned or scoped mesh."""
        return self.execution == "sharded" or (
            self.execution == "fused" and (self.mesh is not None or current_mesh() is not None))

    def execution_backend(self):
        """The residue backend of this policy's execution."""
        if self.execution == "reference":
            return REFERENCE
        from ..kernels.ops import Fp8Backend, FusedBackend, KernelBackend, PerModulusKernelBackend

        be = {"kernel": KernelBackend, "per_modulus_kernel": PerModulusKernelBackend,
              "fused": FusedBackend, "fp8": Fp8Backend, "sharded": KernelBackend}[self.execution]()
        if self._sharded():  # the kernels (or, fused, the megakernel) on each rank's blocks
            from ..distributed.sharded_gemm import ShardedBackend

            return ShardedBackend(be, self.resolved_mesh(), self.shard_axes)
        return be

    def resolved_calibration(self):
        """The `repro_torch.tune.Calibration` this policy's decisions read:
        the pinned ``calibration`` file (memoized; warns once and yields None
        when unfit), else the ambient `use_calibration` / `set_calibration`
        one, else None (presets + default tiles)."""
        from ..tune.cache import current_calibration, load_calibration_cached

        if self.calibration is not None:
            return load_calibration_cached(self.calibration)
        return current_calibration()

    def _calibration_scope(self):
        """Context manager activating the pinned calibration file (a no-op
        without one: the ambient scope then applies as it is).  Entered
        around plan selection AND the kernel launches, so the perfmodel's
        `default_hw` and the kernels' `resolve_blocks` both see it."""
        if self.calibration is None:
            return contextlib.nullcontext()
        from ..tune.cache import load_calibration_cached, use_calibration

        cal = load_calibration_cached(self.calibration)
        if cal is None:
            return contextlib.nullcontext()
        return use_calibration(cal)

    @property
    def is_adaptive(self) -> bool:
        """True when (mode, n_moduli) are resolved per call: ``mode='auto'``,
        or ``rtol`` with no pinned ``n_moduli`` (see :meth:`resolve_adaptive`)."""
        return self.backend != "native" and (
            self.mode == "auto" or (self.rtol is not None and self.n_moduli is None)
        )

    def resolve_adaptive(self, m: int, k: int, n: int, *, stats=None):
        """Resolve ``rtol`` / ``mode='auto'`` to a concrete policy.

        Returns ``self`` unchanged when nothing is adaptive.  Otherwise the
        admissible (mode, n_moduli) pairs come from the arXiv:2602.02549
        bound calculator (`core.accuracy`): ``n_moduli=None`` resolves via
        `min_moduli_for`, a pinned ``n_moduli`` is validated against
        `rel_bound`; and `perfmodel.select_mode` picks the cheapest pair on
        this machine (the calibration's measured card when one is active).
        ``stats``: an optional `core.accuracy.GemmStats` probe of the
        operands that tightens the bound.  The returned policy keeps
        ``rtol``.
        """
        if not self.is_adaptive:
            return self
        from . import accuracy, perfmodel

        dtype = dtype_name(self.compute_dtype)
        form = self.formulation if self.is_complex else None
        modes = ("fast", "accu") if self.mode == "auto" else (self.mode,)
        cands, reasons = [], []
        for mode in modes:
            if self.n_moduli is not None:
                bound = accuracy.rel_bound(
                    dtype, mode, self.n_moduli, k, formulation=form,
                    stats=stats, out_dtype=self.out_dtype,
                )
                if self.rtol is not None and bound > self.rtol:
                    reasons.append(
                        f"{mode}: bound {bound:g} at the pinned "
                        f"n_moduli={self.n_moduli} exceeds rtol"
                    )
                    continue
                cands.append((mode, self.n_moduli))
            else:
                try:
                    cands.append((mode, accuracy.min_moduli_for(
                        self.rtol, dtype, k=k, mode=mode, formulation=form,
                        stats=stats, out_dtype=self.out_dtype,
                    )))
                except ValueError as e:
                    reasons.append(f"{mode}: {e}")
        if not cands:
            raise ValueError(
                f"no (mode, n_moduli) meets rtol={self.rtol:g} for "
                f"backend={self.backend!r} at k={k}: " + "; ".join(reasons)
            )
        prec = {"float32": "s", "float64": "d", "complex64": "c", "complex128": "z"}[dtype]
        with self._calibration_scope():
            mode, n_moduli = perfmodel.select_mode(
                m, n, k, cands, prec=prec,
                engine="fp8" if self.execution == "fp8" else "int8",
            )
        if (mode, n_moduli) == (self.mode, self.n_moduli):
            return self  # already concrete (and re-validated): fixed point
        return dataclasses.replace(self, mode=mode, n_moduli=n_moduli)

    def plan_for(self, m: int, k: int, n: int):
        """The `EmulationPlan` this policy runs for an (m,k)x(k,n) product.

        Selected inside the policy's calibration scope, so the 'auto'
        selections of `make_plan` price against the calibration's measured
        card when one is active, and charge launches and engine operations
        as this execution's backend issues them.  An adaptive policy
        (``rtol`` / ``mode='auto'``) resolves its concrete (mode, n_moduli)
        first, statically here; `policy_matmul` probes concrete operands
        and resolves before reaching this point.
        """
        if self.backend == "native":
            raise ValueError("native policy has no emulation plan")
        if self.is_adaptive:
            resolved = self.resolve_adaptive(m, k, n)
            if resolved is not self:
                return resolved.plan_for(m, k, n)
        with self._calibration_scope():
            be = self.execution_backend()
            shape, comm_s = (m, k, n), 0.0
            factors = getattr(be, "shard_factors", None)
            if factors is not None:
                # sharded: price each rank's block plus the all-reduce, so
                # the 'auto' selections see what a rank runs
                from . import perfmodel

                md, nd, r = factors(m, n)
                shape = (m // md, k, n // nd)
                comm_s = perfmodel.sharded_comm_time_s(
                    shape[0], shape[2], self.n_moduli or default_n_moduli(self.compute_dtype, self.mode),
                    r, complex_=self.is_complex)
            return make_plan(
                self.compute_dtype,
                n_moduli=self.n_moduli,
                mode=self.mode,
                method=self.resolved_method,
                formulation=self.formulation if self.is_complex else None,
                out_dtype=self.out_dtype,
                n_block=self.n_block,
                shape=shape,
                fused_karatsuba=getattr(be, "fused_karatsuba", False),
                modulus_batched=getattr(be, "modulus_batched", False),
                megakernel=getattr(be, "megakernel", False),
                comm_s=comm_s,
                engine=getattr(be, "engine", "int8"),
                rtol=self.rtol,
            )


NATIVE = GemmPolicy()


def _real_cast(y: torch.Tensor, dtype) -> torch.Tensor:
    """`.to` that is explicit about dropping an imaginary part.  `dtype` is
    a name or any torch dtype (a bfloat16 activation's product returns in
    bfloat16, as in the reference)."""
    if not isinstance(dtype, torch.dtype):
        dtype = DTYPES[dtype_name(dtype)]
    if y.is_complex() and not dtype.is_complex:
        y = y.real
    return y.to(dtype)


def _emulated_forward(x: torch.Tensor, w: torch.Tensor, policy: GemmPolicy) -> torch.Tensor:
    """The emulated product x @ w (batched over leading dims), cast to the
    policy's `out_dtype` or x's dtype."""
    ct = policy.compute_dtype
    plan = policy.plan_for(x.shape[-2], x.shape[-1], w.shape[-1])
    # launch under the pinned calibration (a no-op without one), so the
    # kernels' `resolve_blocks` launches the policy's tuned tiles
    with policy._calibration_scope():
        y = run_plan(plan, x.to(ct), w.to(ct), policy.execution_backend())
    return _real_cast(y, policy.out_dtype or x.dtype)


def _adjoint(x: torch.Tensor) -> torch.Tensor:
    """The transpose of the last two dims, conjugated for complex x."""
    x = x.transpose(-1, -2)
    return x.conj_physical() if x.is_complex() else x


class _EmulatedMatmul(torch.autograd.Function):
    """x @ w with emulated cotangent products under the same policy (port of
    the reference's `emulated_matmul` custom VJP): dX = G W^H, dW = X^H G,
    each cast to its input's dtype.  For real operands W^H = W^T, the
    reference's rule; for complex ones the conjugate transposes are
    `torch.matmul`'s convention (the reference pairs plain transposes with
    JAX's)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        ctx.save_for_backward(x, w)
        ctx.policy = policy
        return _emulated_forward(x, w, policy)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _real_cast(_emulated_forward(g, _adjoint(w), ctx.policy), x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _real_cast(_emulated_forward(_adjoint(x), g, ctx.policy), w.dtype)
        return dx, dw, None


def emulated_matmul(x: torch.Tensor, w: torch.Tensor, policy: GemmPolicy) -> torch.Tensor:
    """The emulated product x @ w (batched over leading dims), differentiable:
    with `requires_grad` on an operand the backward runs two more emulated
    GEMMs under the same policy (`_EmulatedMatmul`).  An adaptive policy
    (``rtol`` / ``mode='auto'``) is resolved here, for the forward's shape,
    so the backward's products run the forward's (mode, n_moduli); a sharded
    policy's scoped mesh is pinned here, so they run on the forward's mesh."""
    policy = policy._mesh_pinned()
    if policy.is_adaptive:
        policy = policy.resolve_adaptive(x.shape[-2], x.shape[-1], w.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _EmulatedMatmul.apply(x, w, policy)
    return _emulated_forward(x, w, policy)


def _prepared_matmul(x: torch.Tensor, w: PreparedOperand, policy: GemmPolicy) -> torch.Tensor:
    """x @ w with the weight prepared up front (inference only)."""
    if x.requires_grad:
        # the prepared planes carry only the weight-side scaling, the wrong
        # axis for the cotangent products: training uses raw weights
        raise ValueError(
            "prepared-weight matmuls are inference-only; differentiate through "
            "raw weights (emulated_matmul) instead"
        )
    with policy._calibration_scope():
        y = gemm_prepared(
            w,
            x.to(policy.compute_dtype),
            method=policy.resolved_method,
            formulation=policy.formulation,
            out_dtype=policy.out_dtype,
            n_block=policy.n_block,
            backend=policy.execution_backend(),
            mode=policy.mode,
        )
    return _real_cast(y, policy.out_dtype or x.dtype)


def _check_prepared(w: PreparedOperand, policy: GemmPolicy) -> GemmPolicy:
    """The policy resolved for a prepared weight; raises when the weight
    does not match it.

    An adaptive policy resolves *statically* here — no operand probe, and
    the canonical pricing shape (m := n) of `prepare_weights` — so a weight
    prepared by the same policy always matches; drift raises instead of
    returning wrong answers."""
    if policy.backend == "native":
        raise ValueError(
            "prepared weights require an emulated (ozaki2_*) policy "
            "backend; the native policy runs torch.matmul on raw weights"
        )
    if w.side != "right":
        raise ValueError("policy_matmul expects a side='right' prepared weight")
    _refuse_sharded_prepared(policy, "prepared weights are")
    k, n = w.operand_shape
    policy = policy.resolve_adaptive(n, k, n)
    if policy.mode == "accu" and w.raw is None:
        raise ValueError(
            "accu-mode prepared matmuls re-cast from the raw operand "
            "(the accurate exponents couple both operands); re-prepare "
            "with prepare_weights(accu policy) / keep_raw=True"
        )
    adaptive = " (adaptive resolution)" if policy.rtol is not None else ""
    if w.mode != policy.mode:
        raise ValueError(
            f"prepared weight was prepared for mode={w.mode!r} but the "
            f"policy resolves to mode={policy.mode!r}{adaptive}; re-prepare "
            "with prepare_weights(policy)"
        )
    expect = policy.n_moduli or default_n_moduli(policy.compute_dtype, policy.mode)
    if w.n_moduli != expect:
        raise ValueError(
            f"prepared weight has n_moduli={w.n_moduli} but the policy "
            f"resolves to {expect}{adaptive}; re-prepare with prepare_weights(policy)"
        )
    if w.dtype != dtype_name(policy.compute_dtype):
        raise ValueError(
            f"prepared weight was cast for {w.dtype} but the policy "
            f"computes in {dtype_name(policy.compute_dtype)}; "
            "re-prepare with prepare_weights(policy)"
        )
    return policy


def _refuse_sharded_prepared(policy: GemmPolicy, what: str):
    if policy._sharded():
        raise NotImplementedError(
            f"{what} not supported under a sharded execution (the prepared residue planes "
            "live unsharded on one device); serve prepared weights with GemmPolicy("
            "execution='kernel') or execution='fused' outside any mesh scope, or pass raw "
            "weights to shard this matmul"
        )


def policy_matmul(x: torch.Tensor, w, policy: GemmPolicy) -> torch.Tensor:
    """x: (..., k) @ w: (k, n) under the policy's backend and execution.

    `w` may be a raw tensor or a right-side `PreparedOperand` (weights cast
    once, amortized across calls: the serving path)."""
    if isinstance(w, PreparedOperand):
        policy = _check_prepared(w, policy)
        n = w.operand_shape[1]
        lead = x.shape[:-1]
        y = _prepared_matmul(x.reshape(-1, x.shape[-1]), w, policy)
        return y.reshape(*lead, n)
    if policy.backend == "native":
        y = torch.matmul(x, w)
        return y if policy.out_dtype is None else y.to(DTYPES[policy.out_dtype])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if policy.is_adaptive:
        # a cheap dynamic-range probe of the operands tightens the bound
        # (possibly fewer moduli); either way provably within rtol
        from .accuracy import probe_operands

        policy = policy.resolve_adaptive(
            x2.shape[0], x2.shape[1], w.shape[-1], stats=probe_operands(x2, w))
    y = emulated_matmul(x2, w, policy)
    return y.reshape(*lead, w.shape[-1])


def prepare_weights(params, policy: GemmPolicy, device=None):
    """Pre-residue-cast every linear weight in a param tree (serving).

    Walks dicts, lists and tuples and replaces each ``"w"`` value (a
    tensor or numpy array of ndim >= 2, possibly stacked with leading
    layer dims, or a list/tuple of such stacks) by a right-side
    `PreparedOperand` cast with the policy's execution backend (the
    float64 cast on the reference execution, the shared kernel cast on the
    others), so prepared serving stays bitwise equal to the unprepared run.  Fast mode stores
    the weight's residue planes; accu mode its bound and the raw weight
    (`keep_raw`).  A stacked weight is one operand with leading batch dims;
    `PreparedOperand.layer(i)` takes layer i.  A native policy returns the
    tree unchanged.  `device`: where the prepared weights live (None = the
    card).
    """
    if policy.backend == "native":
        return params
    _refuse_sharded_prepared(policy, "prepare_weights is")
    cast_backend = policy.execution_backend()
    ct = policy.compute_dtype
    return _map_weights(params, policy, lambda val, n_moduli, keep_raw: PreparedOperand(
        torch.as_tensor(val).to(ct), n_moduli, side="right", backend=cast_backend,
        keep_raw=keep_raw, device=device))


def prepared_like(params, policy: GemmPolicy):
    """`prepare_weights(params, policy)`'s tree with each prepared weight
    an abstract `PreparedOperand` (fields on the "meta" device) and no cast
    run: where the weights it prepares sit, and their structure (the port's
    `jax.eval_shape(prepare_weights)`)."""
    if policy.backend == "native":
        return params
    ct = policy.compute_dtype
    return _map_weights(params, policy, lambda val, n_moduli, keep_raw: PreparedOperand.abstract(
        tuple(val.shape), ct, n_moduli, side="right", keep_raw=keep_raw))


def _map_weights(params, policy: GemmPolicy, make):
    """`params` with each weight that preparation consumes replaced by
    ``make(weight, n_moduli, keep_raw)``: the one rule of which leaves are
    prepared and with what, for `prepare_weights` and `prepared_like`."""
    ct = policy.compute_dtype

    def is_weight_leaf(val):
        if isinstance(val, np.ndarray):  # a checkpoint restore may hand numpy
            return val.ndim >= 2 and np.issubdtype(val.dtype, np.inexact)
        return (
            isinstance(val, torch.Tensor)
            and val.ndim >= 2
            and (val.is_floating_point() or val.is_complex())
        )

    def prep(val):
        """Rewrite one "w" value: a weight, or a list/tuple of stacked
        weights; the "w" context runs through the sequence nesting."""
        if is_weight_leaf(val):
            # adaptive policies resolve statically per weight, with the
            # canonical pricing shape (m := n) the prepared matmul uses
            k, n = int(val.shape[-2]), int(val.shape[-1])
            pol = policy.resolve_adaptive(n, k, n)
            return make(val, pol.n_moduli or default_n_moduli(ct, pol.mode), pol.mode == "accu")
        if isinstance(val, (list, tuple)):
            return type(val)(prep(v) for v in val)
        return walk(val)

    def walk(node):
        if isinstance(node, dict):
            return {key: (prep(val) if key == "w" else walk(val)) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
