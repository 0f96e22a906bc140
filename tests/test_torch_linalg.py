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


@pytest.mark.parametrize(
    "fields",
    [
        {"execution": "reference"},
        {"execution": "per_modulus_kernel"},
        {"execution": "fp8", "formulation": "auto"},
        {"execution": "kernel", "formulation": "auto"},
        {"execution": "sharded"},
    ],
    ids=["reference", "per_modulus_kernel", "fp8", "formulation-auto", "sharded"],
)
def test_unported_executions_raise(rng, fields):
    """Executions not ported raise; so does a knob not ported on one that is
    (the fp8 case: `execution="fp8"` runs, `formulation="auto"` does not)."""
    a, b = _operands(rng, np.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.cgemm(a, b, policy=repro_torch.GemmPolicy(**fields), device="cpu")


@pytest.mark.parametrize(
    "fields",
    [{"rtol": 1e-6}, {"mode": "auto"}, {"mesh": object()}, {"calibration": "cal.json"}],
    ids=["rtol", "mode-auto", "mesh", "calibration"],
)
def test_unported_policy_fields_raise(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        repro_torch.GemmPolicy(backend="ozaki2_f32", execution="kernel", **fields)


def test_unported_backward_raises(rng):
    a, b = _operands(rng, np.float32)
    pol = repro_torch.GemmPolicy(execution="kernel")
    x = torch.from_numpy(a).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.sgemm(x, torch.from_numpy(b), policy=pol, device="cpu")


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
