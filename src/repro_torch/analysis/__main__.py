"""python -m repro_torch.analysis — certify the port's traced pipeline.

The port of `repro.analysis.__main__`.  Traces the deployment path
(`repro_torch.linalg.matmul` under each `GemmPolicy`, and a tiny model's
train step, forward and backward) across an execution x dtype x mode
matrix at the smoke shape, with adaptive rows (``rtol`` per dtype; the
`AccuracyPass` certifies the plan each resolves to), runs every pass the
policy's backend mandates (``backend.analyze(plan, shape)``), the static
CRT partial-split certificate and the source lints, and exits 1 if any
finding survives or any row fails to run::

    PYTHONPATH=src python -m repro_torch.analysis --matrix smoke            # on the card
    PYTHONPATH=src python -m repro_torch.analysis --matrix smoke --device cpu

The rows run on the card unless ``--device cpu`` asks for the kernels'
plain versions; both give the same launch records.  The sharded rows run
on a world of one rank (`launch.mesh.init_world`: NCCL on the card, gloo
on the CPU), a (1, 1, 1) mesh, the counterpart of the reference's
one-device mesh: it issues no collective, so the collective pass's
positive evidence comes from runs of several ranks.  The adaptive rows
choose among the modes of ``--modes`` (``mode="auto"`` when it names
both): at k > 2^17 accurate mode's bound product cannot run.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

#: smoke-matrix GEMM shape (the tier-1 fast profile)
SMOKE_SHAPE = (32, 96, 24)

#: small but valid moduli counts per compute dtype (the tier-1 profile)
N_MODULI = {"float32": 5, "float64": 6, "complex64": 5, "complex128": 6}

DTYPES = ("float32", "float64", "complex64", "complex128")
MODES = ("fast", "accu")

#: adaptive rows: the componentwise tolerance asked of each compute dtype
ADAPTIVE_RTOL = {"float32": 1e-4, "float64": 1e-9, "complex64": 1e-4, "complex128": 1e-9}

#: the model row's tiny config (the reference's `_run_model_row`)
MODEL_FIELDS = dict(name="analysis-tiny", n_layers=2, d_model=32, vocab=64, n_heads=2, n_kv_heads=2,
                    head_dim=16, d_ff=64, dtype="float32", remat=True)


@contextlib.contextmanager
def world_mesh(execution: str, device):
    """The (1, 1, 1) mesh of a world of one rank for a sharded row (None
    for the others); the world is joined here and left on exit unless it
    was there before."""
    if execution != "sharded":
        yield None
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import init_world

    _, created = init_world(device)
    try:
        yield DeviceMesh(device.type, torch.arange(1).reshape(1, 1, 1),
                         mesh_dim_names=("data", "model", "residue"))
    finally:
        if created:
            dist.destroy_process_group()


def operands(shape, dtype_name, device, seed=0):
    """Seeded normal operands (m, k) and (k, n) of `dtype_name` on `device`."""
    import numpy as np
    import torch

    m, k, n = shape
    rng = np.random.default_rng(seed)
    complex_ = dtype_name.startswith("complex")

    def draw(r, c):
        x = rng.standard_normal((r, c))
        return x + 1j * rng.standard_normal((r, c)) if complex_ else x

    dt = getattr(torch, dtype_name)
    return (torch.from_numpy(draw(m, k)).to(device, dt), torch.from_numpy(draw(k, n)).to(device, dt))


def run_matmul_row(execution, dtype_name, mode, shape, device, mesh=None, rtol=None):
    """Trace one GEMM row: (findings, pass names, plan, trace)."""
    from .. import linalg
    from ..core.policy import BACKEND_FOR_DTYPE, GemmPolicy
    from . import certify_partial_split, run_passes, trace

    m, k, n = shape
    kwargs = dict(backend=BACKEND_FOR_DTYPE[dtype_name], mode=mode, execution=execution, mesh=mesh)
    if rtol is None:
        kwargs["n_moduli"] = N_MODULI[dtype_name]
    else:  # adaptive: the policy resolves its own (mode, n_moduli)
        kwargs["rtol"] = rtol
    policy = GemmPolicy(**kwargs)
    if policy.is_adaptive:
        policy = policy.resolve_adaptive(m, k, n)
    plan = policy.plan_for(m, k, n)
    passes = policy.execution_backend().analyze(plan, (m, k, n))
    a, b = operands(shape, dtype_name, device)
    tr = trace(lambda x, w: linalg.matmul(x, w, policy=policy, device=device), a, b)
    findings = run_passes(passes, tr) + certify_partial_split(plan.ctx.moduli)
    return findings, [p.name for p in passes], plan, tr


def run_model_row(execution, device):
    """Trace a tiny model's train step, forward and backward, and run the
    shape-independent passes (overflow, collective safety)."""
    import torch

    from ..core.policy import GemmPolicy
    from ..models import Model, ModelConfig
    from ..optim import AdamWConfig
    from ..train.step import init_state, make_train_step
    from . import run_passes, trace

    policy = GemmPolicy(backend="ozaki2_f32", n_moduli=4, execution=execution)
    model = Model(ModelConfig(**MODEL_FIELDS, gemm_policy=policy))
    opt = AdamWConfig()
    step, _ = make_train_step(model, opt, donate=False)
    params, opt_state = init_state(model, opt, torch.Generator().manual_seed(0), device)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32, device=device)}
    tr = trace(step, params, opt_state, batch)
    # no launch expectation: the step runs many GEMM shapes
    passes = policy.execution_backend().analyze(policy.plan_for(*SMOKE_SHAPE), None)
    return run_passes(passes, tr), [p.name for p in passes], tr


def _report(label, findings, pass_names, verbose, all_findings, extra=""):
    """Print one row's verdict; True when it certified clean."""
    if findings:
        print(f"FAIL  {label}{extra}")
        for f in findings:
            print(f"      {f}")
        all_findings.extend(findings)
        return False
    if verbose:
        print(f"ok    {label}{extra}  [{', '.join(pass_names)}]")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="static certification of the port's emulated GEMMs")
    ap.add_argument("--matrix", choices=["smoke"], default="smoke",
                    help="shape profile for the traced matrix (smoke: the tier-1 fast dims %s)" % (SMOKE_SHAPE,))
    ap.add_argument("--executions", nargs="+", default=None,
                    help="subset of GemmPolicy executions (default: all)")
    ap.add_argument("--dtypes", nargs="+", default=None, choices=DTYPES,
                    help="subset of compute dtypes (default: all four)")
    ap.add_argument("--modes", nargs="+", default=None, choices=MODES,
                    help="subset of scaling modes (default: fast and accu)")
    ap.add_argument("--shape", nargs=3, type=int, metavar=("M", "K", "N"), default=None,
                    help="override the matrix GEMM shape")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="repro_torch.tune calibration cache to load first: the matrix then "
                         "certifies the tuned configuration (an unusable cache is an error)")
    ap.add_argument("--skip-model", action="store_true", help="skip the model forward+backward row")
    ap.add_argument("--skip-lint", action="store_true", help="skip the source-level policy-surface lints")
    ap.add_argument("--device", default=None,
                    help="where the rows run (default: the card, which must exist; cpu: the "
                         "kernels' plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true", help="print every clean row, not just a summary")
    args = ap.parse_args(argv)

    from ..core.executor import resolve_device
    from ..core.policy import EXECUTIONS
    from . import lint_repo

    device = resolve_device(args.device)
    if args.calibration is not None:
        import warnings

        from ..tune.cache import load_calibration, set_calibration

        reason = ""
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            try:
                cal = load_calibration(args.calibration)
            except RuntimeWarning as w:
                cal, reason = None, f" ({w})"
        if cal is None:
            ap.error(f"--calibration {args.calibration}: cache unusable{reason}")
        set_calibration(cal)
        print(f"repro_torch.analysis: calibration loaded ({cal.device_kind} x{cal.device_count}, "
              f"{len(cal.blocks)} tuned block slots)")

    executions = tuple(args.executions or EXECUTIONS)
    unknown = set(executions) - set(EXECUTIONS)
    if unknown:
        ap.error(f"unknown executions {sorted(unknown)}; valid: {EXECUTIONS}")
    dtypes = tuple(args.dtypes or DTYPES)
    modes = tuple(args.modes or MODES)
    adaptive_mode = "auto" if set(modes) == set(MODES) else modes[0]
    shape = tuple(args.shape) if args.shape else SMOKE_SHAPE

    all_findings: list = []
    rows = clean = 0
    for execution in executions:
        with world_mesh(execution, device) as mesh:
            for dtype_name in dtypes:
                for mode in modes:
                    rows += 1
                    label = f"{execution:>18s} x {dtype_name:>10s} x {mode}"
                    try:
                        findings, names, _, _ = run_matmul_row(execution, dtype_name, mode, shape, device, mesh)
                    except Exception as exc:  # a row must run to certify
                        print(f"ERROR {label}: trace failed: {exc!r}")
                        all_findings.append(exc)
                        continue
                    clean += _report(label, findings, names, args.verbose, all_findings)
            # adaptive rows: the resolved plan's static bound meets the rtol asked
            for dtype_name in dtypes:
                rows += 1
                rtol = ADAPTIVE_RTOL[dtype_name]
                label = f"{execution:>18s} x {dtype_name:>10s} x {adaptive_mode}(rtol={rtol:g})"
                try:
                    findings, names, plan, _ = run_matmul_row(execution, dtype_name, adaptive_mode, shape,
                                                              device, mesh, rtol=rtol)
                except Exception as exc:
                    print(f"ERROR {label}: trace failed: {exc!r}")
                    all_findings.append(exc)
                    continue
                clean += _report(label, findings, names, args.verbose, all_findings,
                                 f" -> {plan.mode}/N={plan.n_moduli}")

    if not args.skip_model:
        rows += 1
        label = f"{'model fwd+bwd':>18s} x kernel"
        try:
            findings, names, _ = run_model_row("kernel", device)
        except Exception as exc:
            print(f"ERROR {label}: trace failed: {exc!r}")
            all_findings.append(exc)
        else:
            clean += _report(label, findings, names, args.verbose, all_findings)

    if not args.skip_lint:
        rows += 1
        root = Path(__file__).resolve().parents[3]
        clean += _report(f"{'source lints':>18s}", lint_repo(root), ["policy-surface"], args.verbose,
                         all_findings)

    print(f"repro_torch.analysis: {clean}/{rows} rows certified clean "
          f"({len(all_findings)} findings) on {device}")
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())
