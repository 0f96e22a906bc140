"""Passes certifying the residue pipeline's invariants from a `Trace`.

The port of `repro.analysis.passes`.  Each pass has a ``name`` and a
``run(trace) -> list[Finding]``; an empty list is a certificate, and a
finding names the invariant broken and where.  The passes:

``OverflowPass``
    The paper's SIII-A accumulation bound, proved from the trace's shapes,
    dtypes and tables instead of trusted from the chunking code:

    * an int8-residue launch (`int8_mod_gemm`, `karatsuba_fused`, and
      their one-plane calls on `per_modulus_kernel`) contracts
      k <= ``K_CHUNK_LIMIT`` (2^17): with |residue| <= 127 the int32
      accumulator stays below 2^31;
    * a megakernel launch (`fused_mod_gemm`, `fused_karatsuba`) reduces
      mod p at least every ``K_CHUNK_LIMIT`` (its ``chunk_limit``);
    * an e4m3 launch (`fp8_mod_gemm`, `fp8_karatsuba`) contracts
      k <= ``FP8_K_CHUNK_LIMIT`` (2^16), the bound the kernels' f32 digit
      sums are exact to;
    * a product outside every launch follows the reference's rules: both
      operands of int8 provenance (`core.intmul.int8_matmul`, a float64
      matmul cast to int32), K <= ``K_CHUNK_LIMIT``; both of float8
      provenance, K <= 2 * ``FP8_K_CHUNK_LIMIT``; a float64 product whose
      operands are both bounded, |lhs| * |rhs| * K <= 2^53, the exact
      window of the CRT partial combines.  Any other float product is
      ordinary compute and never flagged.

    The limits default to the modules' values read when the pass runs
    (`core.executor.K_CHUNK_LIMIT`, `kernels.fp8_mod_gemm.
    FP8_K_CHUNK_LIMIT`), so a test's patch of either governs it.

``CollectiveSafetyPass``
    No array narrower than 4 bytes crosses the mesh: any collective record
    of such a dtype is a finding.  The sharded execution sends only exact
    f64 CRT partials, int32 bound maxima and output blocks.

``LaunchCountPass``
    The trace's kernel launches number what `perfmodel.
    kernel_launch_count` predicts (`expected_launch_count` derives the
    prediction from a backend, a plan and a shape).

``AccuracyPass``
    A plan that declares a tolerance (``EmulationPlan.rtol``) meets it:
    `core.accuracy.rel_bound` for the plan is at most the tolerance.  A
    static check; the trace is not read.

`certify_partial_split` certifies the CRT partial-split tables
statically, and `passes_for_backend` assembles the suite the backends'
``analyze(plan, shape)`` hooks return.

The reference's ``ScanIndexWidthPass`` is deliberately not ported: it
guards a crash of XLA's SPMD partitioner on s64 indices that a weakly
typed scan carry takes under x64, and torch has neither the partitioner
nor weak types.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .trace import Trace, dtype_name, trace

__all__ = [
    "AccuracyPass",
    "COLLECTIVE_OPS",
    "CollectiveSafetyPass",
    "Finding",
    "LaunchCountPass",
    "OverflowPass",
    "certify_launch_count",
    "certify_partial_split",
    "collect_collectives",
    "expected_launch_count",
    "passes_for_backend",
    "run_passes",
]

#: the int8-residue products, the megakernels and the e4m3 products
INT8_KERNELS = frozenset({"int8_mod_gemm", "karatsuba_fused"})
MEGAKERNELS = frozenset({"fused_mod_gemm", "fused_karatsuba"})
FP8_KERNELS = frozenset({"fp8_mod_gemm", "fp8_karatsuba"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One broken invariant found by a pass.

    ``pass_name``  the pass that found it;
    ``message``    what bound was broken;
    ``primitive``  the op or kernel at fault (None for a static check);
    ``path``       the launches it ran inside, outermost first.
    """

    pass_name: str
    message: str
    primitive: str | None = None
    path: tuple = ()

    def __str__(self) -> str:
        where = "/".join(self.path + ((self.primitive,) if self.primitive else ()))
        return f"[{self.pass_name}] {where or '<static>'}: {self.message}"


def _default_k_limit() -> int:
    from ..core import executor

    return executor.K_CHUNK_LIMIT


def _default_fp8_limit() -> int:
    from ..kernels import fp8_mod_gemm

    return fp8_mod_gemm.FP8_K_CHUNK_LIMIT


@dataclasses.dataclass(frozen=True)
class OverflowPass:
    """Overflow and exactness certifier (paper SIII-A accumulation bound)."""

    k_limit: int | None = None
    fp8_limit: int | None = None
    f64_exact: float = 2.0**53

    name = "overflow"

    def run(self, tr: Trace) -> list:
        k_limit = self.k_limit if self.k_limit is not None else _default_k_limit()
        fp8_limit = self.fp8_limit if self.fp8_limit is not None else _default_fp8_limit()
        findings: list[Finding] = []
        for rec in tr.launches:
            findings += self._check_launch(rec, k_limit, fp8_limit)
        for op in tr.ops:
            if op.is_product and not op.path:
                findings += self._check_product(op, k_limit, fp8_limit)
        return findings

    def _check_launch(self, rec, k_limit, fp8_limit) -> list:
        if rec.name in INT8_KERNELS and rec.k > k_limit:
            msg = (f"int8 residue launch accumulates K={rec.k} > K_CHUNK_LIMIT={k_limit}; "
                   "127^2 * K no longer fits the exact int32 window (paper SIII-A bound)")
        elif rec.name in MEGAKERNELS and rec.chunk_limit > k_limit:
            msg = (f"megakernel reduces mod p every chunk_limit={rec.chunk_limit} > "
                   f"K_CHUNK_LIMIT={k_limit}; its int32 plane sums can wrap (paper SIII-A bound)")
        elif rec.name in FP8_KERNELS and rec.k > fp8_limit:
            msg = (f"e4m3 launch accumulates K={rec.k} > FP8_K_CHUNK_LIMIT={fp8_limit}; digit "
                   "products (<=64) would leave the exact f32 window (2^24)")
        else:
            return []
        return [Finding(self.name, msg, primitive=rec.name, path=rec.path)]

    def _check_product(self, op, k_limit, fp8_limit) -> list:
        kinds, (lb, rb), k = op.kinds, op.bounds, op.k
        if kinds == ("int8", "int8"):
            if k <= k_limit:
                return []
            msg = (f"int8 product accumulates K={k} > K_CHUNK_LIMIT={k_limit}; 127^2 * K no "
                   "longer fits the exact int32 window (paper SIII-A bound)")
        elif kinds == ("fp8", "fp8"):
            if k <= 2 * fp8_limit:
                return []
            msg = (f"fp8 product accumulates K={k} > 2*FP8_K_CHUNK_LIMIT={2 * fp8_limit}; digit "
                   "products (<=64) would leave the exact f32 window (2^24)")
        elif op.out_dtypes and dtype_name(op.out_dtypes[0]) == "float64" and lb is not None and rb is not None:
            worst = lb * rb * k
            if worst <= self.f64_exact:
                return []
            msg = (f"f64 product partial sum bounded by {lb:g} * {rb:g} * K={k} = {worst:.3g} > "
                   "2^53: CRT partial-combine would round")
        else:
            return []
        return [Finding(self.name, msg, primitive=op.name, path=op.path)]


#: the collectives `distributed.sharded_gemm.collective` issues
COLLECTIVE_OPS = frozenset({"sum", "max", "broadcast"})


@dataclasses.dataclass(frozen=True)
class CollectiveSafetyPass:
    """No int8, float8 or other sub-4-byte array may cross the mesh."""

    min_itemsize: int = 4

    name = "collective-safety"

    def run(self, tr: Trace) -> list:
        return [
            Finding(self.name,
                    f"{dtype_name(c.dtype)} array crosses the mesh via `{c.op}`; only exact f64 CRT "
                    "partials (and >=32-bit scalars) may be communicated",
                    primitive=c.op, path=(c.dim,))
            for c in tr.collectives if c.dtype.itemsize < self.min_itemsize
        ]


def collect_collectives(tr: Trace) -> list:
    """Every collective of `tr` as (op, [dtype]): positive evidence for
    tests (the safety pass alone also passes a program that sends nothing)."""
    return [(c.op, [c.dtype]) for c in tr.collectives]


@dataclasses.dataclass(frozen=True)
class LaunchCountPass:
    """The number of kernel launches must equal the perfmodel's prediction."""

    expected: int

    name = "launch-count"

    def run(self, tr: Trace) -> list:
        got = len(tr.launches)
        if got != self.expected:
            return [Finding(self.name,
                            f"traced program has {got} kernel launches, "
                            f"perfmodel.kernel_launch_count predicts {self.expected}",
                            primitive="launch")]
        return []


@dataclasses.dataclass(frozen=True)
class AccuracyPass:
    """The plan's static error bound must meet its declared tolerance.

    ``plan`` is the `EmulationPlan` under analysis, ``k`` the contraction
    length of the certified GEMM, ``rtol`` the tolerance (default: the
    plan's own ``rtol``).  The check is `core.accuracy.rel_bound(...) <=
    rtol`, static: quantization is the scheme's only inexact step and
    every execution is bitwise the reference's, so the bound depends on
    the plan alone.  A plan declaring no tolerance certifies.
    """

    plan: object
    k: int
    rtol: float | None = None

    name = "accuracy"

    def run(self, tr: Trace | None = None) -> list:
        rtol = self.rtol if self.rtol is not None else self.plan.rtol
        if rtol is None:
            return []
        from ..core.accuracy import rel_bound

        p = self.plan
        bound = rel_bound(p.dtype, p.mode, p.n_moduli, int(self.k), formulation=p.formulation,
                          out_dtype=p.out_dtype)
        if bound > rtol:
            return [Finding(self.name,
                            f"plan ({p.dtype}, mode={p.mode}, N={p.n_moduli}, {p.formulation}) has "
                            f"static componentwise bound {bound:.3g} at k={self.k} > declared "
                            f"rtol={rtol:.3g}")]
        return []


def certify_partial_split(moduli, u=None, part_bits=None) -> list:
    """Statically certify the CRT partial-split tables of `moduli`
    (`core.crt.partial_split`): every entry of the combine table ``u`` is
    a nonnegative integer below ``2**part_bits``, and the worst partial
    sum ``max(u) * 127 * N`` stays within 2^53, so `partial_combine`'s f64
    product is exact for any residues.  Pass `u` / `part_bits` to audit
    another table; by default both are recomputed from `moduli`."""
    from ..core import crt

    moduli = tuple(int(q) for q in moduli)
    if u is None or part_bits is None:
        u_tab, _, pb = crt.partial_split(moduli)
        u = u_tab if u is None else u
        part_bits = pb if part_bits is None else part_bits
    u = np.asarray(u, dtype=np.float64)
    findings: list[Finding] = []
    if np.any(u < 0) or np.any(u != np.floor(u)):
        findings.append(Finding("overflow", "partial-split table u has non-integer or negative "
                                            "entries; f64 reconstruction is not exact"))
    if u.size and float(np.max(u)) >= 2.0 ** int(part_bits):
        findings.append(Finding("overflow", f"partial-split table entry {np.max(u):.0f} >= "
                                            f"2^part_bits=2^{part_bits}; parts are wider than the "
                                            "split claims"))
    worst = (float(np.max(u)) if u.size else 0.0) * 127.0 * len(moduli)
    if worst > 2.0**53:
        findings.append(Finding("overflow", f"worst CRT partial sum max(u)*127*N = {worst:.3g} > "
                                            "2^53; partial_combine's f64 accumulation would round"))
    return findings


def expected_launch_count(backend, plan, shape, prepared: bool = False) -> int:
    """`perfmodel.kernel_launch_count` for `backend` running `plan` at
    ``shape = (m, k, n)``, from the backend's capabilities: none for a
    backend that launches no kernel (the reference execution); the K
    chunks of its engine's limit; one launch a block on a megakernel; a
    sharded backend's per-rank blocks (`shard_factors`), where the
    megakernel runs only when the residue dim is 1."""
    from ..core import perfmodel

    m, k, n = shape
    if not getattr(backend, "launches_kernels", True):
        return 0
    engine = getattr(backend, "engine", "int8")
    chunk_limit = _default_fp8_limit() if engine == "fp8" else _default_k_limit()
    fused = bool(getattr(backend, "megakernel", False))
    n_local = n
    shard_factors = getattr(backend, "shard_factors", None)
    if callable(shard_factors):
        _, nd, r = shard_factors(m, n)
        n_local = -(-n // nd)
        fused = fused and r == 1
    formulation = plan.formulation if plan.is_complex else "real"
    return perfmodel.kernel_launch_count(
        plan.n_moduli,
        formulation,
        modulus_batched=getattr(backend, "modulus_batched", False),
        fused_karatsuba=getattr(backend, "fused_karatsuba", False),
        n_chunks=max(1, -(-k // chunk_limit)),
        n_blocks=len(plan.n_block_slices(n_local)),
        prepared=prepared,
        fused=fused,
    )


def certify_launch_count(expected: int, fn, *args, **kwargs) -> list:
    """Trace ``fn(*args, **kwargs)`` and run ``LaunchCountPass(expected)``."""
    return LaunchCountPass(expected=expected).run(trace(fn, *args, **kwargs))


def passes_for_backend(backend, plan, shape=None) -> tuple:
    """The suite certifying `backend` running `plan`: the overflow pass
    (at the limits read now) and the collective-safety pass; given
    ``shape = (m, k, n)``, also the launch count the perfmodel predicts
    and, for a plan declaring ``rtol``, the accuracy pass at k.  The
    backends' ``analyze(plan, shape)`` hooks return it."""
    passes = [OverflowPass(k_limit=_default_k_limit(), fp8_limit=_default_fp8_limit()),
              CollectiveSafetyPass()]
    if shape is not None:
        passes.append(LaunchCountPass(expected=expected_launch_count(backend, plan, shape)))
        if getattr(plan, "rtol", None) is not None:
            passes.append(AccuracyPass(plan=plan, k=shape[1]))
    return tuple(passes)


def run_passes(passes, tr: Trace) -> list:
    """Every pass over `tr`, their findings in turn."""
    findings: list[Finding] = []
    for p in passes:
        findings.extend(p.run(tr))
    return findings
