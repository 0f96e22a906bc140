"""The port's static analysis (`repro_torch.analysis`) against the
reference's (`repro.analysis`).

Each pass gets a positive certificate (the real pipeline or the boundary
case comes back clean) and a negative case (a deliberately broken program
or a tighter limit is flagged).  The negative programs are raw torch
products on purpose: the library entry points raise above their chunk
limits, so only a program that bypasses them holds an over-limit product.

Launch parity: on the CPU each execution's trace holds as many launch
records as the port's `expected_launch_count`, the reference's traced
`pallas_call`s (`count_pallas_calls`, interpret mode, traced and never
executed) and the reference's `expected_launch_count`, K-chunked shape
included.  The CLI runs its whole matrix in a subprocess, whose world of
one rank ends with it.  Tolerance: none; the passes' verdicts are exact.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N
from test_torch_train import one_thread  # noqa: F401  (autouse fixture: small products on one thread)

import repro
import repro.analysis as janalysis
from repro.core.policy import GemmPolicy as JPolicy
from repro_torch import GemmPolicy, linalg
from repro_torch.analysis import (
    AccuracyPass,
    Collective,
    CollectiveSafetyPass,
    Finding,
    OverflowPass,
    Trace,
    certify_launch_count,
    certify_partial_split,
    collect_collectives,
    count_launches,
    expected_launch_count,
    lint_policy_surface,
    passes_for_backend,
    run_passes,
    trace,
)
from repro_torch.analysis.__main__ import ADAPTIVE_RTOL, N_MODULI, SMOKE_SHAPE
from repro_torch.analysis.lint import EXECUTION_CLIS, PORT_SECTION, execution_choices
from repro_torch.core import executor
from repro_torch.core.executor import REFERENCE, chunked_residue_matmul, execute_plan
from repro_torch.core.moduli import K_CHUNK_LIMIT, make_crt_context
from repro_torch.core.policy import BACKEND_FOR_DTYPE, EXECUTIONS
from repro_torch.kernels import WRAPPERS, fp8_mod_gemm
from repro_torch.kernels.ops import Fp8Backend, FusedBackend, KernelBackend, PerModulusKernelBackend

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
CHUNKED_SHAPE = (4, K_CHUNK_LIMIT + 5, 4)  # 2 int8 K-chunks, 3 e4m3 ones
FP8_LIMIT = fp8_mod_gemm.FP8_K_CHUNK_LIMIT


@pytest.fixture(scope="module", autouse=True)
def cli_matrix():
    """``python -m repro_torch.analysis --device cpu`` in a fresh
    interpreter that then asserts it imported no JAX, started with the
    module's first test so that it runs beside the others;
    `test_cli_full_matrix_on_cpu` reads its result."""
    code = ("import sys; from repro_torch.analysis.__main__ import main; rc = main(['--device', 'cpu']); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules, 'the port imported JAX'; "
            "sys.exit(rc)")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:  # the CLI test did not run
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# OverflowPass: products outside the kernels
# ---------------------------------------------------------------------------

def _int8_product_trace(k):
    """A raw int8 x int8 product of contraction k, as `int8_matmul` runs it
    (a float64 matmul), on (2, k) and (k, 3) int8 zeros."""
    return trace(lambda x, y: torch.matmul(x.double(), y.double()),
                 torch.zeros((2, k), dtype=torch.int8), torch.zeros((k, 3), dtype=torch.int8))


def test_overflow_int8_at_limit_certifies():
    assert OverflowPass().run(_int8_product_trace(K_CHUNK_LIMIT)) == []


def test_overflow_int8_beyond_limit_flagged():
    findings = OverflowPass().run(_int8_product_trace(K_CHUNK_LIMIT + 1))
    assert len(findings) == 1
    f = findings[0]
    assert f.pass_name == "overflow" and f.primitive == "mm"
    assert "K_CHUNK_LIMIT" in f.message and "mm" in str(f)


def test_overflow_float_products_never_flagged():
    """Ordinary float compute is out of scope: no bound is provable, in
    float32 or in float64 derived from the input."""
    k = 4 * K_CHUNK_LIMIT
    for dt in (torch.float32, torch.float64):
        tr = trace(torch.matmul, torch.zeros((2, k), dtype=dt), torch.zeros((k, 3), dtype=dt))
        assert [op.name for op in tr.products()] == ["mm"]
        assert OverflowPass().run(tr) == []


def _const_product_trace(scale):
    """int8 input x a table: the CRT partial combine's shape of product."""
    table = torch.from_numpy(np.full((4, 3), scale))
    return trace(lambda x: torch.matmul(x.double(), table), torch.zeros((2, 4), dtype=torch.int8))


def test_overflow_f64_table_product_within_window():
    # 127 * 2^40 * 4 ~ 5.6e14 < 2^53: exact, certifies
    tr = _const_product_trace(2.0**40)
    assert tr.products()[0].bounds == (127.0, 2.0**40)
    assert OverflowPass().run(tr) == []


def test_overflow_f64_table_product_beyond_window_flagged():
    # 127 * 2^48 * 4 ~ 1.4e17 > 2^53: the partial combine would round
    findings = OverflowPass().run(_const_product_trace(2.0**48))
    assert len(findings) == 1 and "2^53" in findings[0].message


def test_overflow_reference_partial_combine_certifies():
    """The real partial combine (`core.crt.partial_combine`, the sharded
    execution's): int8 planes against the `partial_split` table, bounded by
    the table's value, within 2^53; a table scaled past the window is not."""
    from repro_torch.core import crt

    ctx = make_crt_context(14)
    u, _, _ = crt.partial_split(ctx.moduli)
    planes = torch.zeros((ctx.n, 3, 5), dtype=torch.int8)
    tr = trace(crt.partial_combine, planes, u)  # `u` a numpy table: no input of the trace
    assert [(op.name, op.k, op.bounds) for op in tr.products()] == [("mm", ctx.n, (float(u.max()), 127.0))]
    assert OverflowPass().run(tr) == []
    assert OverflowPass().run(trace(lambda e: crt.partial_combine(e, u * 2.0**12), planes)) != []


# ---------------------------------------------------------------------------
# OverflowPass: kernel launches
# ---------------------------------------------------------------------------

def test_overflow_kernel_launch_at_k_and_tighter_limit(rng):
    """The `kernel` launch at k = 256 certifies; a limit below its k flags
    the very same trace."""
    plan = GemmPolicy(backend="ozaki2_f32", n_moduli=4, execution="kernel").plan_for(8, 256, 8)
    a = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 8)).astype(np.float32))
    tr = trace(lambda x, y: execute_plan(plan, x, y, KernelBackend()), a, b)
    assert [r.k for r in tr.launches if r.name == "int8_mod_gemm"] == [256]
    assert OverflowPass().run(tr) == []
    findings = OverflowPass(k_limit=128).run(tr)
    assert [(f.primitive, f.path) for f in findings] == [("int8_mod_gemm", ())]


def test_overflow_fp8_launch_at_limit():
    """The e4m3 launch at its exact chunk limit certifies; a tighter limit
    flags the same trace."""
    ctx = make_crt_context(4)
    a = torch.zeros((ctx.n, 8, FP8_LIMIT), dtype=torch.int8)
    b = torch.zeros((ctx.n, FP8_LIMIT, 8), dtype=torch.int8)
    tr = trace(lambda x, y: fp8_mod_gemm.fp8_mod_gemm_batched(x, y, moduli=ctx.moduli), a, b)
    assert [(r.name, r.k) for r in tr.launches] == [("fp8_mod_gemm", FP8_LIMIT)]
    assert OverflowPass().run(tr) == []
    findings = OverflowPass(fp8_limit=FP8_LIMIT // 8).run(tr)
    assert len(findings) == 1 and "FP8_K_CHUNK_LIMIT" in findings[0].message


def test_overflow_megakernel_chunk_limit(rng):
    """A megakernel launch certifies by its in-launch chunk, whatever its k."""
    plan = GemmPolicy(backend="ozaki2_c64", n_moduli=5, execution="fused").plan_for(4, 300, 4)
    a = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.complex64))
    b = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.complex64))
    tr = trace(lambda x, y: execute_plan(plan, x, y, FusedBackend()), a, b)
    assert [(r.name, r.k, r.chunk_limit) for r in tr.launches] == [("fused_karatsuba", 300, K_CHUNK_LIMIT)]
    assert OverflowPass(k_limit=100).run(tr) != []  # k = 300 alone would not flag: the chunk does
    assert OverflowPass().run(tr) == []


def _fp8_product_trace(k):
    """A raw product of e4m3 digits, as the plain versions run them (f32)."""
    return trace(lambda x, y: torch.matmul(x.float(), y.float()),
                 torch.zeros((2, k), dtype=torch.float8_e4m3fn), torch.zeros((k, 3), dtype=torch.float8_e4m3fn))


def test_overflow_fp8_cross_term_bound():
    """The e4m3 rule admits the Karatsuba cross terms' concatenated digits,
    2 * FP8_K_CHUNK_LIMIT, and flags one element more."""
    assert OverflowPass().run(_fp8_product_trace(2 * FP8_LIMIT)) == []
    findings = OverflowPass().run(_fp8_product_trace(2 * FP8_LIMIT + 1))
    assert len(findings) == 1 and "FP8_K_CHUNK_LIMIT" in findings[0].message


def test_overflow_defaults_follow_patched_limits(monkeypatch, rng):
    """The passes read the limits when they run, as the chunking does: under
    patched limits the chunked launches certify and the counts follow."""
    monkeypatch.setattr(executor, "K_CHUNK_LIMIT", 64)
    monkeypatch.setattr(fp8_mod_gemm, "FP8_K_CHUNK_LIMIT", 48)
    a = torch.from_numpy(rng.standard_normal((4, 200)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((200, 4)).astype(np.float32))
    for backend, name, chunks in ((KernelBackend(), "int8_mod_gemm", 4), (Fp8Backend(), "fp8_mod_gemm", 5)):
        plan = GemmPolicy(backend="ozaki2_f32", n_moduli=4, execution="kernel").plan_for(4, 200, 4)
        tr = trace(lambda x, y: execute_plan(plan, x, y, backend), a, b)
        assert tr.launch_counts()[name] == chunks
        assert run_passes(passes_for_backend(backend, plan, (4, 200, 4)), tr) == []
        assert OverflowPass(k_limit=32, fp8_limit=24).run(tr) != []


try:
    from hypothesis import given, settings, strategies as st

    SET = settings(max_examples=20, deadline=None)
    HAVE_HYPOTHESIS = True
except ImportError:  # optional dependency
    HAVE_HYPOTHESIS = False


def _residue_stack(ctx):
    """The reference backend's residue product: (N,m,k) x (N,k,n) int8 ->
    (N,m,n) canonical residues, exact while k <= K_CHUNK_LIMIT."""
    from repro_torch.core.intmul import int8_matmul

    return lambda a, b: executor._sym_mod_stack(int8_matmul(a, b), ctx).to(torch.int8)


if HAVE_HYPOTHESIS:

    @given(st.integers(min_value=1, max_value=256), st.integers(min_value=8, max_value=64))
    @SET
    def test_chunked_residue_matmul_always_certifies(k, chunk_limit):
        """For any k and chunk limit the shared K-chunk loop certifies under
        OverflowPass(k_limit=chunk_limit); the unchunked product, the
        control, is flagged exactly when k exceeds the limit."""
        ctx = make_crt_context(3)
        stack = _residue_stack(ctx)
        a = torch.zeros((3, 2, k), dtype=torch.int8)
        b = torch.zeros((3, k, 2), dtype=torch.int8)
        chunked = trace(lambda x, y: chunked_residue_matmul(stack, x, y, ctx, chunk_limit=chunk_limit), a, b)
        assert OverflowPass(k_limit=chunk_limit).run(chunked) == []
        flagged = OverflowPass(k_limit=chunk_limit).run(trace(stack, a, b)) != []
        assert flagged == (k > chunk_limit)

    @given(st.integers(min_value=1, max_value=2 * K_CHUNK_LIMIT))
    @SET
    def test_int8_product_certification_is_exactly_the_limit(k):
        assert (OverflowPass().run(_int8_product_trace(k)) != []) == (k > K_CHUNK_LIMIT)

    @given(st.integers(min_value=1, max_value=512), st.integers(min_value=8, max_value=128))
    @SET
    def test_fp8_product_certification_is_twice_the_limit(k, fp8_limit):
        """The e4m3 rule is parametric in its limit and admits exactly twice it."""
        flagged = OverflowPass(fp8_limit=fp8_limit).run(_fp8_product_trace(k)) != []
        assert flagged == (k > 2 * fp8_limit)

else:  # pragma: no cover - surfaced as an explicit skip, not silence

    @pytest.mark.skip(reason="optional dependency: hypothesis not installed")
    def test_analysis_property_suite():
        pass


# ---------------------------------------------------------------------------
# CollectiveSafetyPass, LaunchCountPass
# ---------------------------------------------------------------------------

def _trace_of(collectives):
    tr = Trace()
    tr.collectives = [Collective(op, dt, (4, 4), dim) for op, dt, dim in collectives]
    return tr


def test_collective_safety_records():
    """Only >=32-bit arrays may cross the mesh: f64 sums, int32 maxima and
    complex broadcasts certify; an int8, float8 or bfloat16 record is a
    finding naming its dtype."""
    safe = _trace_of([("sum", torch.float64, "residue"), ("max", torch.int32, "model"),
                      ("broadcast", torch.complex64, "data")])
    assert CollectiveSafetyPass().run(safe) == []
    assert collect_collectives(safe) == [("sum", [torch.float64]), ("max", [torch.int32]),
                                         ("broadcast", [torch.complex64])]
    for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        findings = CollectiveSafetyPass().run(_trace_of([("sum", dt, "residue")]))
        assert len(findings) == 1
        f = findings[0]
        assert f.pass_name == "collective-safety" and str(dt).removeprefix("torch.") in f.message
        assert str(f).startswith("[collective-safety] residue/sum:")


def test_launch_count_zero_for_plain_torch():
    a = torch.zeros((4, 4))
    assert certify_launch_count(0, torch.matmul, a, a) == []
    findings = certify_launch_count(3, torch.matmul, a, a)
    assert len(findings) == 1
    assert "0 kernel launches" in findings[0].message and "predicts 3" in findings[0].message


def test_launch_count_against_real_kernel(rng):
    plan = GemmPolicy(backend="ozaki2_f32", n_moduli=4, execution="kernel").plan_for(8, 64, 8)
    a = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    want = expected_launch_count(KernelBackend(), plan, (8, 64, 8))
    run = lambda x, y: execute_plan(plan, x, y, KernelBackend())  # noqa: E731
    assert certify_launch_count(want, run, a, b) == []
    assert certify_launch_count(want + 1, run, a, b) != []
    assert count_launches(run, a, b) == want == 4


def test_expected_launch_count_zero_for_reference():
    plan = GemmPolicy(backend="ozaki2_f32", n_moduli=4).plan_for(8, 64, 8)
    assert expected_launch_count(REFERENCE, plan, (8, 64, 8)) == 0


def test_cpu_trace_counts_no_launch():
    """The records are written before the dispatch; the CPU's plain versions
    still leave every wrapper's `.launches` where it was."""
    pol = GemmPolicy(backend="ozaki2_c64", n_moduli=5, execution="kernel")
    x, w = torch.ones((4, 8), dtype=torch.complex64), torch.ones((8, 4), dtype=torch.complex64)
    before = {name: fn.launches for name, fn in WRAPPERS.items()}
    tr = trace(lambda p, q: linalg.matmul(p, q, policy=pol, device="cpu"), x, w)
    assert tr.launch_counts() == {"residue_cast": 2, "karatsuba_fused": 1, "crt_garner": 1}
    assert {name: fn.launches for name, fn in WRAPPERS.items()} == before
    # each plain version's ops are recorded inside its launch
    assert {op.path for op in tr.ops if op.path} == {("residue_cast",), ("karatsuba_fused",), ("crt_garner",)}


# ---------------------------------------------------------------------------
# launch parity with the reference
# ---------------------------------------------------------------------------

PARITY_EXECUTIONS = ("kernel", "per_modulus_kernel", "fused", "fp8", "reference")
# the four dtypes fast and the two ends accurate at the smoke shape; the two
# ends at the K-chunked one (rows cut to keep the suite in its time limit)
PARITY_CASES = ([(SMOKE_SHAPE, d, "fast") for d in N_MODULI]
                + [(shape, d, mode) for shape in (SMOKE_SHAPE, CHUNKED_SHAPE) for d in ("float32", "complex128")
                   for mode in (("accu",) if shape == SMOKE_SHAPE else ("fast", "accu"))])


def _policies(execution, dtype_name, mode):
    fields = dict(backend=BACKEND_FOR_DTYPE[dtype_name], n_moduli=N_MODULI[dtype_name], mode=mode,
                  execution=execution)
    return GemmPolicy(**fields), JPolicy(**fields, interpret=True)


@pytest.mark.parametrize("shape,dtype_name,mode", PARITY_CASES,
                         ids=[f"{'smoke' if s == SMOKE_SHAPE else 'chunked'}-{d}-{m}" for s, d, m in PARITY_CASES])
@pytest.mark.parametrize("execution", PARITY_EXECUTIONS)
def test_launch_parity_with_reference(execution, shape, dtype_name, mode):
    """Four numbers agree: the port's CPU trace's launch records, the port's
    `expected_launch_count`, the reference's traced `pallas_call`s and the
    reference's `expected_launch_count`.  Where the port refuses (k past
    2^17 in accurate mode's bound product, which the reference refuses
    too, and the per-modulus complex product, which neither package
    chunks), the reference's own trace is refused or flagged."""
    m, k, n = shape
    pol, jpol = _policies(execution, dtype_name, mode)
    a = torch.zeros((m, k), dtype=getattr(torch, dtype_name))
    b = torch.zeros((k, n), dtype=getattr(torch, dtype_name))
    ja, jb = jnp.zeros((m, k), dtype_name), jnp.zeros((k, n), dtype_name)
    jrun = lambda x, w: repro.linalg.matmul(x, w, policy=jpol)  # noqa: E731
    if k > K_CHUNK_LIMIT and mode == "accu":
        with pytest.raises(ValueError, match="exceeds"):
            trace(lambda x, w: linalg.matmul(x, w, policy=pol, device="cpu"), a, b)
        with pytest.raises(ValueError, match="exceeds"):
            janalysis.count_pallas_calls(jrun, ja, jb)
        return
    plan, jplan = pol.plan_for(m, k, n), jpol.plan_for(m, k, n)
    want = expected_launch_count(pol.execution_backend(), plan, shape)
    jwant = janalysis.expected_launch_count(jpol.execution_backend(), jplan, shape)
    assert want == jwant
    if k > K_CHUNK_LIMIT and execution == "per_modulus_kernel" and dtype_name.startswith("complex"):
        with pytest.raises(ValueError, match="exceeds the exact-int32 limit"):
            trace(lambda x, w: linalg.matmul(x, w, policy=pol, device="cpu"), a, b)
        jaxpr = jax.make_jaxpr(jrun)(ja, jb)
        assert janalysis.count_primitive(jaxpr, "pallas_call") == N_MODULI[dtype_name] + 6 != jwant
        assert len(janalysis.OverflowPass().run(jaxpr)) == 3 * N_MODULI[dtype_name]
        return
    tr = trace(lambda x, w: linalg.matmul(x, w, policy=pol, device="cpu"), a, b)
    assert len(tr.launches) == want == janalysis.count_pallas_calls(jrun, ja, jb)
    assert run_passes(pol.execution_backend().analyze(plan, shape), tr) == []


# ---------------------------------------------------------------------------
# static certifiers against the reference
# ---------------------------------------------------------------------------

def _messages(findings):
    return [(f.pass_name, f.message) for f in findings]


def test_partial_split_certificates_match_reference():
    for n in (2, 5, 14, 20):
        moduli = make_crt_context(n).moduli
        assert certify_partial_split(moduli) == [] == janalysis.certify_partial_split(moduli)
    moduli = make_crt_context(3).moduli
    for u, bits, word in ((np.array([[-1.0]]), 8, "negative"), (np.array([[300.0]]), 8, "part_bits"),
                          (np.array([[2.0**55]]), 60, "2^53")):
        got = _messages(certify_partial_split(moduli, u=u, part_bits=bits))
        assert got == _messages(janalysis.certify_partial_split(moduli, u=u, part_bits=bits))
        assert any(word in msg for _, msg in got)


@pytest.mark.parametrize("dtype_name", list(ADAPTIVE_RTOL))
def test_accuracy_pass_matches_reference(dtype_name):
    """The adaptive rows resolve to the reference's plan and certify; a
    tolerance below the plan's bound is flagged by both packages."""
    from repro_torch.core.accuracy import rel_bound

    m, k, n = SMOKE_SHAPE
    fields = dict(backend=BACKEND_FOR_DTYPE[dtype_name], mode="auto", rtol=ADAPTIVE_RTOL[dtype_name],
                  execution="kernel")
    plan = GemmPolicy(**fields).plan_for(m, k, n)
    jplan = JPolicy(**fields, interpret=True).plan_for(m, k, n)
    assert (plan.mode, plan.n_moduli, plan.rtol) == (jplan.mode, jplan.n_moduli, jplan.rtol)
    assert AccuracyPass(plan, k).run() == [] == janalysis.AccuracyPass(jplan, k).run(None)
    tight = rel_bound(plan.dtype, plan.mode, plan.n_moduli, k, formulation=plan.formulation,
                      out_dtype=plan.out_dtype) / 2
    got = AccuracyPass(plan, k, rtol=tight).run()
    assert _messages(got) == _messages(janalysis.AccuracyPass(jplan, k, rtol=tight).run(None))
    assert len(got) == 1 and "declared rtol" in got[0].message


def test_finding_str_matches_reference():
    assert str(Finding("overflow", "boom")) == "[overflow] <static>: boom" == str(janalysis.Finding("overflow", "boom"))
    f = Finding("overflow", "k", primitive="mm", path=("int8_mod_gemm",))
    assert str(f) == str(janalysis.Finding("overflow", "k", primitive="mm", path=("int8_mod_gemm",)))


# ---------------------------------------------------------------------------
# backend.analyze hooks; a traced call is an untraced one
# ---------------------------------------------------------------------------

def test_backend_analyze_hook_matches_passes_for_backend(rng):
    plan = GemmPolicy(backend="ozaki2_f32", n_moduli=4).plan_for(8, 64, 8)
    suite = REFERENCE.analyze(plan, (8, 64, 8))
    kinds = [type(p).__name__ for p in suite]
    assert kinds == ["OverflowPass", "CollectiveSafetyPass", "LaunchCountPass"]
    assert [type(p).__name__ for p in REFERENCE.analyze(plan)] == kinds[:-1]
    assert suite == passes_for_backend(REFERENCE, plan, (8, 64, 8))
    a = torch.from_numpy(rng.standard_normal((8, 64)))
    b = torch.from_numpy(rng.standard_normal((64, 8)))
    assert run_passes(suite, trace(lambda x, y: execute_plan(plan, x, y, REFERENCE), a, b)) == []
    # every kernel backend has the hook, with the accuracy pass for a plan declaring rtol
    rplan = dataclasses.replace(plan, rtol=1e-3)
    for backend in (KernelBackend(), PerModulusKernelBackend(), FusedBackend(), Fp8Backend()):
        names = [type(p).__name__ for p in backend.analyze(rplan, (8, 64, 8))]
        assert names == kinds + ["AccuracyPass"]


def _bits(t):
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("execution", ["reference", "kernel", "fused", "fp8", "per_modulus_kernel"])
def test_traced_call_is_bitwise_untraced(rng, execution):
    """The dispatch mode and the launch records only observe."""
    for dtype in (np.float32, np.complex128):
        name = np.dtype(dtype).name
        pol = GemmPolicy(backend=BACKEND_FOR_DTYPE[name], n_moduli=N_MODULI[name], execution=execution,
                         mode="accu")
        x = torch.from_numpy(rng.standard_normal((FAST_M, FAST_K)).astype(dtype))
        w = torch.from_numpy(rng.standard_normal((FAST_K, FAST_N)).astype(dtype))
        run = lambda p, q: linalg.matmul(p, q, policy=pol, device="cpu")  # noqa: E731
        assert torch.equal(_bits(trace(run, x, w).result), _bits(run(x, w)))


# ---------------------------------------------------------------------------
# source lint
# ---------------------------------------------------------------------------

def _fake_repo(tmp_path, *, skip_execution=None, break_cli=None, outside_section=None):
    """A minimal repo the policy-surface lint passes, with optional defects:
    an execution left out of the README's port section (or named only
    outside it), a CLI whose --execution choices miss one."""
    fields = " ".join(f.name for f in dataclasses.fields(GemmPolicy))
    execs = [e for e in EXECUTIONS if e not in (skip_execution, outside_section)]
    other = f"`{outside_section}`\n" if outside_section else ""
    (tmp_path / "README.md").write_text(
        f"# repo\n{other}\n{PORT_SECTION}\n" + " ".join(f"`{e}`" for e in execs) + f"\n{fields}\n\n## Next\n")
    body = ("import argparse\np = argparse.ArgumentParser()\n"
            "p.add_argument(\"--execution\", choices={!r})\n"
            "p.add_argument(\"--rtol\", type=float, default=None)\n")
    for rel in EXECUTION_CLIS:
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body.format(list(EXECUTIONS[:-1] if rel == break_cli else EXECUTIONS)))
    return tmp_path


def test_lint_clean_on_synced_repo(tmp_path):
    assert lint_policy_surface(_fake_repo(tmp_path)) == []


def test_lint_flags_undocumented_execution(tmp_path):
    findings = lint_policy_surface(_fake_repo(tmp_path, skip_execution="fused"))
    assert len(findings) == 1
    assert "`fused`" in findings[0].message and "README" in findings[0].message


def test_lint_reads_only_the_port_section(tmp_path):
    findings = lint_policy_surface(_fake_repo(tmp_path, outside_section="sharded"))
    assert len(findings) == 1 and "`sharded`" in findings[0].message


def test_lint_flags_out_of_sync_cli(tmp_path):
    broken = "src/repro_torch/launch/train.py"
    findings = lint_policy_surface(_fake_repo(tmp_path, break_cli=broken))
    assert len(findings) == 1
    assert broken in findings[0].message and "missing" in findings[0].message


def test_lint_flags_missing_rtol_flag(tmp_path):
    repo = _fake_repo(tmp_path)
    target = repo / "src/repro_torch/launch/serve.py"
    target.write_text("\n".join(line for line in target.read_text().splitlines() if "--rtol" not in line) + "\n")
    findings = lint_policy_surface(repo)
    assert len(findings) == 1 and "--rtol" in findings[0].message


def test_lint_flags_missing_cli(tmp_path):
    repo = _fake_repo(tmp_path)
    (repo / "src/repro_torch/launch/serve.py").unlink()
    findings = lint_policy_surface(repo)
    assert len(findings) == 1 and "not found" in findings[0].message


def test_execution_choices_none_without_flag(tmp_path):
    p = tmp_path / "noflag.py"
    p.write_text("import argparse\np = argparse.ArgumentParser()\n")
    assert execution_choices(p) is None


def test_real_repo_lints_clean():
    assert lint_policy_surface(REPO) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_full_matrix_on_cpu(cli_matrix):
    """Every row of the smoke matrix, the model's step and the lints
    certify clean on the CPU, in a fresh interpreter that imports no JAX
    (its world of one rank ends with it)."""
    out, err = cli_matrix.communicate(timeout=600)
    assert cli_matrix.returncode == 0, out[-4000:] + err[-4000:]
    rows = len(EXECUTIONS) * 4 * 3 + 2  # x dtypes x (fast, accu, adaptive), the model and the lints
    assert f"repro_torch.analysis: {rows}/{rows} rows certified clean (0 findings) on cpu" in out


def test_cli_refuses_unusable_calibration(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    bad = tmp_path / "cal.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "--calibration", str(bad)])
    assert exc.value.code == 2 and "cache unusable" in capsys.readouterr().err
