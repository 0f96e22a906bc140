"""The backward of the port's emulated matmul (`torch.autograd.Function`)
against the reference's custom VJP.

Real operands: ``x.grad`` / ``w.grad`` of the port after
``y.backward(g)`` equal `jax.vjp` of `repro`'s `policy_matmul` with the
same cotangent g, bit for bit, on every execution with a backward here
(reference, kernel, per_modulus_kernel, fused, fp8; each in one dtype, the
other held to the kernel execution's bits, which the forwards share).
Complex operands: the port follows `torch.matmul`'s rule, dX = G W^H and dW = X^H G, so its
gradients equal `repro`'s emulated forward products of (g, w^H) and
(x^H, g), bit for bit, and `torch.matmul`'s complex128 autograd within the
execution's grade (stated below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import policy_matmul as j_policy_matmul
import repro_torch
from repro_torch import linalg as tl
from repro_torch.interop import policy_from_fields

BACKENDS = {np.float32: "ozaki2_f32", np.float64: "ozaki2_f64",
            np.complex64: "ozaki2_c64", np.complex128: "ozaki2_c128"}


def _inputs(rng, dtype, batch=()):
    x = phi_matrix(rng, (*batch, FAST_M, FAST_K), 0.5, dtype)
    w = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    g = phi_matrix(rng, (*batch, FAST_M, FAST_N), 0.5, dtype)
    return x, w, g


def _port_grads(x, w, g, pol):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = tl.matmul(tx, tw, policy=pol, device="cpu")
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), tx.grad.numpy(), tw.grad.numpy()


# each execution once against JAX, the kernel ones at N = 4 (interpret-mode
# Pallas makes every case cost seconds, more with more planes);
# `test_real_grads_agree_across_executions` holds the rest at the default N
REAL_CASES = [(np.float32, "reference"), (np.float64, "reference"), (np.float32, "kernel"),
              (np.float64, "per_modulus_kernel"), (np.float32, "fused"), (np.float32, "fp8")]


@pytest.mark.parametrize("dtype,execution", REAL_CASES,
                         ids=[f"{np.dtype(d).name}-{e}" for d, e in REAL_CASES])
def test_real_grads_match_jax_vjp(rng, dtype, execution):
    x, w, g = _inputs(rng, dtype)
    jpol = JPolicy(backend=BACKENDS[dtype], execution=execution, interpret=True,
                   **({} if execution == "reference" else {"n_moduli": 4}))
    y, vjp = jax.vjp(lambda a, b: j_policy_matmul(a, b, jpol), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    ty, tdx, tdw = _port_grads(x, w, g, policy_from_fields(dataclasses.asdict(jpol)))
    np.testing.assert_array_equal(ty, np.asarray(y))
    np.testing.assert_array_equal(tdx, np.asarray(dx))
    np.testing.assert_array_equal(tdw, np.asarray(dw))
    assert tdx.dtype == x.dtype and tdw.dtype == w.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_real_grads_agree_across_executions(rng, dtype):
    """The four kernel executions' gradients are one another's bits (and,
    at f32 grade, the reference execution's), as their forwards are."""
    x, w, g = _inputs(rng, dtype)
    grads = {ex: _port_grads(x, w, g, repro_torch.GemmPolicy(backend=BACKENDS[dtype], execution=ex))[1:]
             for ex in ("kernel", "per_modulus_kernel", "fused", "fp8", "reference")}
    same = ("per_modulus_kernel", "fused", "fp8") + (("reference",) if dtype == np.float32 else ())
    for ex in same:
        for got, want in zip(grads[ex], grads["kernel"]):
            np.testing.assert_array_equal(got, want)


def test_batched_rows_grads(rng):
    """A (2, m, k) operand against a 2-D weight flattens its rows: the
    gradient flows back through the reshape, the bits of the flat run."""
    x, w, g = _inputs(rng, np.float64, batch=(2,))
    pol = repro_torch.GemmPolicy(backend="ozaki2_f64", method="dd")
    _, tdx, tdw = _port_grads(x, w, g, pol)
    _, fdx, fdw = _port_grads(x.reshape(-1, FAST_K), w, g.reshape(-1, FAST_N), pol)
    np.testing.assert_array_equal(tdx, fdx.reshape(tdx.shape))
    np.testing.assert_array_equal(tdw, fdw)


#: max|d - d_ref| / max|d_ref| against torch.matmul's complex128 autograd:
#: the f32-grade executions (cgemm anywhere, zgemm off the reference) and
#: the f64-grade reference zgemm
COMPLEX_TOL = {"f32": 1e-5, "f64": 1e-12}
COMPLEX_CASES = [(np.complex64, "reference"), (np.complex128, "reference"), (np.complex64, "kernel")]


@pytest.mark.parametrize("dtype,execution", COMPLEX_CASES,
                         ids=[f"{np.dtype(d).name}-{e}" for d, e in COMPLEX_CASES])
def test_complex_grads_are_conjugate_products(rng, dtype, execution):
    x, w, g = _inputs(rng, dtype)
    jpol = JPolicy(backend=BACKENDS[dtype], execution=execution, interpret=True, formulation="block_a")
    _, tdx, tdw = _port_grads(x, w, g, policy_from_fields(dataclasses.asdict(jpol)))
    want_dx = j_policy_matmul(jnp.asarray(g), jnp.asarray(w.conj().T), jpol)
    want_dw = j_policy_matmul(jnp.asarray(x.conj().T), jnp.asarray(g), jpol)
    np.testing.assert_array_equal(tdx, np.asarray(want_dx))
    np.testing.assert_array_equal(tdw, np.asarray(want_dw))
    # torch.matmul's own complex autograd, in complex128
    rx = torch.from_numpy(x.astype(np.complex128)).requires_grad_()
    rw = torch.from_numpy(w.astype(np.complex128)).requires_grad_()
    torch.matmul(rx, rw).backward(torch.from_numpy(g.astype(np.complex128)))
    grade = "f64" if (dtype == np.complex128 and execution == "reference") else "f32"
    for got, ref in ((tdx, rx.grad.numpy()), (tdw, rw.grad.numpy())):
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < COMPLEX_TOL[grade]


def test_adaptive_policy_through_backward(rng):
    """An rtol policy resolves (mode, n_moduli) before the Function: the
    backward runs the forward's plan, with `repro`'s bits."""
    x, w, g = _inputs(rng, np.float64)
    jpol = JPolicy(backend="ozaki2_f64", rtol=1e-9)
    _, vjp = jax.vjp(lambda a, b: j_policy_matmul(a, b, jpol), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    tpol = repro_torch.GemmPolicy(backend="ozaki2_f64", rtol=1e-9)
    _, tdx, tdw = _port_grads(x, w, g, tpol)
    assert np.all(np.isfinite(tdx)) and np.all(np.isfinite(tdw))
    np.testing.assert_array_equal(tdx, np.asarray(dx))
    np.testing.assert_array_equal(tdw, np.asarray(dw))


def test_grad_of_one_operand_and_no_grad(rng):
    """Only the operand that asks gets a gradient, and it is the one of the
    two-operand run; under no_grad nothing is recorded."""
    x, w, g = _inputs(rng, np.float32)
    pol = repro_torch.GemmPolicy(backend="ozaki2_f32", execution="kernel")
    _, tdx, _ = _port_grads(x, w, g, pol)
    tx = torch.from_numpy(x).requires_grad_()
    tl.matmul(tx, torch.from_numpy(w), policy=pol, device="cpu").backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), tdx)
    with torch.no_grad():
        y = tl.matmul(tx, torch.from_numpy(w), policy=pol, device="cpu")
    assert not y.requires_grad


@pytest.mark.parametrize("execution", ["reference", "kernel"])
def test_prepared_weights_still_raise(rng, execution):
    x, w, _ = _inputs(rng, np.float64)
    pol = repro_torch.GemmPolicy(backend="ozaki2_f64", execution=execution)
    prep = tl.prepare_weights({"w": w}, pol, device="cpu")["w"]
    with pytest.raises(ValueError, match="inference-only"):
        tl.matmul(torch.from_numpy(x).requires_grad_(), prep, policy=pol, device="cpu")
