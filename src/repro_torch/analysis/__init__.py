"""repro_torch.analysis — static certification of the port's emulated GEMMs.

The port of `repro.analysis`.  `trace` runs a call once, eagerly, and
records every kernel launch (through the wrappers' hook, the same records
on the CPU's plain versions as on the card), every aten op (through a
`TorchDispatchMode`, with each product's operand bounds) and every
collective of the sharded execution.  Four passes certify the invariants
every execution must uphold:

* :class:`OverflowPass` — int8 residue launches within ``K_CHUNK_LIMIT``,
  the megakernels' in-launch chunks within it, e4m3 launches within
  ``FP8_K_CHUNK_LIMIT``, and the products outside the kernels within the
  exact int32 and 2^53 windows (paper SIII-A accumulation bound);
* :class:`CollectiveSafetyPass` — only >=32-bit arrays cross the mesh;
* :class:`LaunchCountPass` — the trace's launches number what
  `perfmodel.kernel_launch_count` predicts;
* :class:`AccuracyPass` — a plan declaring ``rtol`` has a static
  `core.accuracy.rel_bound` within it.

The reference's ``ScanIndexWidthPass`` is deliberately not ported (it
guards an XLA SPMD-partitioner crash on s64 scan indices; torch has
neither).  Every residue backend has ``analyze(plan, shape=None)``, the
suite of `passes_for_backend`; `lint_repo` keeps the README and the CLIs
in step with `GemmPolicy`; ``python -m repro_torch.analysis`` runs it all.

Example::

    import torch
    from repro_torch import GemmPolicy, linalg
    from repro_torch.analysis import run_passes, trace

    pol = GemmPolicy(backend="ozaki2_f32", n_moduli=4, execution="kernel")
    x, w = torch.randn(32, 48), torch.randn(48, 16)
    tr = trace(lambda p, q: linalg.matmul(p, q, policy=pol, device="cpu"), x, w)
    backend = pol.execution_backend()
    assert run_passes(backend.analyze(pol.plan_for(32, 48, 16), (32, 48, 16)), tr) == []
    assert len(tr.launches) == 4          # cast, cast, product, Garner
"""
from .lint import EXECUTION_CLIS, execution_choices, lint_policy_surface, lint_repo  # noqa: F401
from .passes import (  # noqa: F401
    COLLECTIVE_OPS,
    AccuracyPass,
    CollectiveSafetyPass,
    Finding,
    LaunchCountPass,
    OverflowPass,
    certify_launch_count,
    certify_partial_split,
    collect_collectives,
    expected_launch_count,
    passes_for_backend,
    run_passes,
)
from .trace import Collective, Launch, Op, Trace, count_launches, trace  # noqa: F401

__all__ = [
    "AccuracyPass",
    "COLLECTIVE_OPS",
    "Collective",
    "CollectiveSafetyPass",
    "EXECUTION_CLIS",
    "Finding",
    "Launch",
    "LaunchCountPass",
    "Op",
    "OverflowPass",
    "Trace",
    "certify_launch_count",
    "certify_partial_split",
    "collect_collectives",
    "count_launches",
    "execution_choices",
    "expected_launch_count",
    "lint_policy_surface",
    "lint_repo",
    "passes_for_backend",
    "run_passes",
    "trace",
]
