"""Parity of the port's GEMM entry points (`repro_torch.linalg`) with
`repro.linalg` on the kernel execution.

The same numpy operands go through `repro.linalg` under
`GemmPolicy(execution="kernel", interpret=True)` and through
`repro_torch.linalg` under the port's `GemmPolicy(execution="kernel")` with
``device="cpu"``, which runs the kernels' plain PyTorch versions.
Tolerance: none — the results are compared bit for bit, the contract the
reference holds among its own executions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
import repro.core.executor as j_executor
from repro.core.policy import GemmPolicy as JPolicy
import repro_torch
import repro_torch.core.executor as t_executor
from repro_torch import linalg as tl
from repro_torch.interop import policy_from_fields
from repro_torch.launch.mesh import init_world, make_host_mesh

ROUTINES = {"sgemm": np.float32, "dgemm": np.float64, "cgemm": np.complex64, "zgemm": np.complex128}


def _operands(rng, dtype, m=FAST_M, k=FAST_K, n=FAST_N, batch=()):
    a = phi_matrix(rng, (*batch, m, k), 0.5, dtype)
    b = phi_matrix(rng, (k, n), 0.5, dtype)
    return a, b


def _both(routine, a, b, **policy_fields):
    """(reference result, port result) of one BLAS routine, as numpy."""
    jpol = JPolicy(execution="kernel", interpret=True, **policy_fields)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(a), jnp.asarray(b), policy=jpol))
    got = getattr(tl, routine)(a, b, policy=tpol, device="cpu")
    assert got.device.type == "cpu"
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    return want, got.numpy()


@pytest.mark.parametrize("mode", ["fast", "accu"])
@pytest.mark.parametrize("routine", list(ROUTINES))
def test_blas_routines_bitwise(rng, routine, mode):
    a, b = _operands(rng, ROUTINES[routine])
    want, got = _both(routine, a, b, mode=mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("formulation", ["block_a", "block_b"])
@pytest.mark.parametrize("routine", ["cgemm", "zgemm"])
def test_block_formulations_bitwise(rng, routine, formulation):
    a, b = _operands(rng, ROUTINES[routine])
    want, got = _both(routine, a, b, formulation=formulation)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("routine,formulation", [("sgemm", None), ("cgemm", "block_b")])
def test_n_block_bitwise(rng, routine, formulation):
    a, b = _operands(rng, ROUTINES[routine], n=40)
    extra = {} if formulation is None else {"formulation": formulation}
    want, got = _both(routine, a, b, n_block=16, **extra)
    np.testing.assert_array_equal(got, want)


def test_batched_operands_bitwise(rng):
    """A (2, m, k) operand against a 2D weight flattens its rows (as the
    reference does); against a (2, k, n) operand it runs per batch entry."""
    a, b = _operands(rng, np.complex64, batch=(2,))
    want, got = _both("cgemm", a, b, mode="accu")
    assert got.shape == (2, FAST_M, FAST_N)
    np.testing.assert_array_equal(got, want)
    bb = np.stack([b, phi_matrix(rng, b.shape, 0.5, np.complex64)])
    want, got = _both("cgemm", a, bb, mode="accu")
    np.testing.assert_array_equal(got, want)


def test_chunked_k_bitwise(rng, monkeypatch):
    """K-chunking with the carry epilogue: K_CHUNK_LIMIT=64 at k=160 gives
    three chunks in both packages; the port also matches its own unchunked run."""
    cases = [("sgemm", _operands(rng, np.float32, k=160)), ("zgemm", _operands(rng, np.complex128, k=160))]
    whole = [getattr(tl, r)(a, b, policy=repro_torch.GemmPolicy(execution="kernel"), device="cpu") for r, (a, b) in cases]
    monkeypatch.setattr(j_executor, "K_CHUNK_LIMIT", 64)
    monkeypatch.setattr(t_executor, "K_CHUNK_LIMIT", 64)
    for (routine, (a, b)), unchunked in zip(cases, whole):
        want, got = _both(routine, a, b)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, unchunked.numpy())


def test_matmul_under_ambient_policy(rng):
    """`use_policy` scopes `matmul`; the default policy is the native one."""
    a, b = _operands(rng, np.float32)
    assert tl.current_policy().backend == "native"
    pol = repro_torch.GemmPolicy(backend="ozaki2_f32", execution="kernel")
    with repro_torch.use_policy(pol):
        assert tl.current_policy() is pol
        got = tl.matmul(a, b, device="cpu")
    np.testing.assert_array_equal(got.numpy(), tl.sgemm(a, b, policy=pol, device="cpu").numpy())
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(tl.matmul(ta, tb, device="cpu"), torch.matmul(ta, tb))


@pytest.mark.parametrize("fields", [{"execution": "sharded"}], ids=["sharded"])
def test_unported_executions_raise(rng, fields):
    """The last execution ported, `sharded`: without a mesh it raises; on a
    mesh of one rank it gives the kernel execution's bits (meshes of many
    ranks: tests/test_torch_sharded.py)."""
    a, b = _operands(rng, np.complex64)
    with pytest.raises(ValueError, match="needs a mesh"):
        tl.cgemm(a, b, policy=repro_torch.GemmPolicy(**fields), device="cpu")
    _, owned = init_world(torch.device("cpu"))
    try:
        mesh = make_host_mesh(1, 1, 1, device_type="cpu")
        got = tl.cgemm(a, b, policy=repro_torch.GemmPolicy(**fields, mesh=mesh), device="cpu")
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    want, kernel = _both("cgemm", a, b)
    np.testing.assert_array_equal(kernel, want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "fields,error",
    [({"mesh": object()}, (TypeError, "DeviceMesh")), ({"shard_axes": ("residue", "m", "n")}, (ValueError, "mesh dims"))],
    ids=["mesh", "shard_axes"],
)
def test_unported_policy_fields_raise(fields, error):
    """The mesh fields are checked: a mesh is a `DeviceMesh`, `shard_axes`
    names its dims ('m' and 'n' are no mesh dims)."""
    with pytest.raises(error[0], match=error[1]):
        repro_torch.GemmPolicy(backend="ozaki2_f32", execution="kernel", **fields)


#: a measured HW that makes mode='auto' pick differently from the presets
_MEAS = {"mem_bw": 1e9, "int8_ops": 5e12, "gemm_launch_s": 5e-3}


def _same_calibration():
    """The same measurement active on both sides, each keyed to its process."""
    from repro.core.perfmodel import HW as JHW
    from repro.tune import cache as jcache
    from repro_torch.core.perfmodel import HW as THW
    from repro_torch.tune import cache as tcache

    jcal = jcache.Calibration(hw=JHW.from_calibration(_MEAS), **jcache.live_key())
    tcal = tcache.Calibration(hw=THW.from_calibration(_MEAS), **tcache.live_key("cpu"))
    return jcache, jcal, tcache, tcal


@pytest.mark.parametrize(
    "fields",
    [
        {"rtol": 1e-6},
        {"rtol": 1e-3, "mode": "auto"},
        {"execution": "kernel", "formulation": "auto", "n_block": "auto"},
        {"execution": "fused", "formulation": "auto"},
        {"execution": "fp8", "formulation": "auto", "rtol": 1e-5, "mode": "auto"},
    ],
    ids=["rtol", "mode-auto", "formulation-auto", "fused-formulation-auto", "fp8-auto"],
)
@pytest.mark.parametrize("routine", ["dgemm", "cgemm", "zgemm"])
def test_automatic_policy_fields_bitwise(rng, routine, fields):
    """rtol / mode='auto' / formulation='auto' run in the port and resolve as
    in the reference (the same measured HW active on both sides): bitwise
    equal outputs."""
    fields = {"execution": "kernel", **fields}
    a, b = _operands(rng, ROUTINES[routine])
    jcache, jcal, tcache, tcal = _same_calibration()
    jpol = JPolicy(interpret=True, **fields)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    with jcache.use_calibration(jcal):
        want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(a), jnp.asarray(b), policy=jpol))
    with tcache.use_calibration(tcal):
        got = getattr(tl, routine)(a, b, policy=tpol, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_matmul_rtol_keyword_bitwise(rng):
    """linalg.matmul(..., rtol=) resolves the moduli count per call as the
    reference does (its operand probe included)."""
    a, b = _operands(rng, np.float64)
    jpol = JPolicy(backend="ozaki2_f64", execution="kernel", interpret=True)
    tpol = repro_torch.GemmPolicy(backend="ozaki2_f64", execution="kernel")
    for rtol in (1e-4, 1e-10):
        want = np.asarray(repro.linalg.matmul(jnp.asarray(a), jnp.asarray(b), policy=jpol, rtol=rtol))
        got = tl.matmul(a, b, policy=tpol, rtol=rtol, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    # a looser tolerance provably needs fewer moduli
    assert tpol.__class__(backend="ozaki2_f64", rtol=1e-4, execution="kernel").plan_for(32, 96, 24).n_moduli < \
        tpol.__class__(backend="ozaki2_f64", rtol=1e-10, execution="kernel").plan_for(32, 96, 24).n_moduli
    with pytest.raises(ValueError, match="rtol must be > 0"):
        repro_torch.GemmPolicy(backend="ozaki2_f64", rtol=0.0)
    with pytest.raises(ValueError, match="rtol"):
        repro_torch.GemmPolicy(backend="ozaki2_f64", mode="auto")


def test_pinned_calibration_file_bitwise(rng, tmp_path):
    """GemmPolicy(calibration=path) with a cache of the same measurement on
    each side (the port's with tuned tiles): bitwise equal outputs."""
    jcache, jcal, tcache, tcal = _same_calibration()
    from repro_torch.tune.cache import block_key

    tcal = tcal.with_blocks({block_key("kernel", "complex", 32, 24, 96): (64, 64, 64)})
    jpath = jcache.save_calibration(jcal, str(tmp_path / "repro.json"))
    tpath = tcache.save_calibration(tcal, str(tmp_path / "repro_torch.json"))
    fields = dict(backend="ozaki2_c128", formulation="auto", mode="auto", rtol=1e-6, execution="kernel")
    a, b = _operands(rng, np.complex128)
    want = np.asarray(repro.linalg.matmul(
        jnp.asarray(a), jnp.asarray(b), policy=JPolicy(interpret=True, calibration=jpath, **fields)))
    tpol = repro_torch.GemmPolicy(calibration=tpath, **fields)
    got = tl.matmul(a, b, policy=tpol, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tpol.resolved_calibration() == tcal


def test_default_device_is_the_card():
    """device=None means CUDA; without a card the call raises instead of
    computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    a = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.sgemm(a, a, policy=repro_torch.GemmPolicy(execution="kernel"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.matmul(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.PreparedOperand(a, side="right")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.prepare_weights({"w": a}, repro_torch.GemmPolicy(backend="ozaki2_f32", execution="fused"))
