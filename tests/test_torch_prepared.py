"""Parity of the port's prepared-weight serving (`PreparedOperand`,
`gemm_prepared`, `prepare_weights`, and `linalg` on a prepared weight) with
the reference's.

The reference prepares with its kernel or fused backend in interpret mode:
its default is the jnp `reference` execution, which the port does not have
and whose f64 cast gives other bits.  The port runs on the CPU, i.e. its
kernels' plain versions.  Tolerance: none — fields and products are
compared bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
from repro.core.executor import PreparedOperand as JPrepared
from repro.core.executor import gemm_prepared as j_gemm_prepared
from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import prepare_weights as j_prepare_weights
from repro.kernels.ops import FusedBackend as JFused
from repro.kernels.ops import KernelBackend as JKernel
import repro_torch
import repro_torch.kernels.ops as tops
from repro_torch import linalg as tl
from repro_torch.core.executor import PreparedOperand, gemm_prepared
from repro_torch.interop import policy_from_fields, prepared_from_numpy

BACKENDS = {"kernel": (JKernel, tops.KernelBackend), "fused": (JFused, tops.FusedBackend)}


def _fields(p) -> dict:
    """The fields of a reference `PreparedOperand`, arrays as numpy."""
    arr = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    return {
        "side": p.side, "n_moduli": p.n_moduli, "n_limbs": p.n_limbs, "dtype": p.dtype,
        "e_scale": arr(p.e_scale), "residues": tuple(map(arr, p.residues)),
        "bound": tuple(map(arr, p.bound)), "e_bound": arr(p.e_bound), "raw": arr(p.raw),
    }


def _assert_same_fields(got: PreparedOperand, want):
    for name in ("side", "n_moduli", "n_limbs", "dtype"):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.mode, got.batch_ndim, got.operand_shape) == (want.mode, want.batch_ndim, want.operand_shape)
    for name in ("e_scale", "e_bound", "raw"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name in ("residues", "bound"):
        g, w = getattr(got, name), getattr(want, name)
        assert len(g) == len(w), name
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)


FIELD_CASES = [
    (dt, side, keep_raw, batch)
    for dt in (np.float32, np.complex64)
    for side in ("left", "right")
    for keep_raw in (False, True)
    for batch in ((),)
] + [(np.float64, "right", False, (2,)), (np.complex128, "right", True, (2,))]


@pytest.mark.parametrize(
    "dtype,side,keep_raw,batch", FIELD_CASES,
    ids=[f"{np.dtype(d).name}-{s}-{'accu' if r else 'fast'}{'-batched' if b else ''}"
         for d, s, r, b in FIELD_CASES],
)
def test_prepared_fields_match(rng, dtype, side, keep_raw, batch):
    x = phi_matrix(rng, (*batch, FAST_M, FAST_K), 0.5, dtype)
    want = JPrepared(jnp.asarray(x), 6, side=side, backend=JKernel(interpret=True), keep_raw=keep_raw)
    got = PreparedOperand(x, 6, side=side, keep_raw=keep_raw, device="cpu")
    _assert_same_fields(got, want)
    assert repr(got) == repr(want)


GEMM_CASES = [
    (dt, execution, side, mode)
    for dt in (np.float32, np.complex128)
    for execution in ("kernel", "fused")
    for side in ("left", "right")
    for mode in ("fast", "accu")
]


@pytest.mark.parametrize(
    "dtype,execution,side,mode", GEMM_CASES,
    ids=[f"{np.dtype(d).name}-{e}-{s}-{m}" for d, e, s, m in GEMM_CASES],
)
def test_gemm_prepared_matches_reference(rng, dtype, execution, side, mode):
    """Both sides, both modes, on the kernel and the fused backends; also
    equal to the port's unprepared product on the same backend."""
    jbe, tbe = BACKENDS[execution]
    w = phi_matrix(rng, (FAST_K, FAST_N) if side == "right" else (FAST_M, FAST_K), 0.5, dtype)
    x = phi_matrix(rng, (FAST_M, FAST_K) if side == "right" else (FAST_K, FAST_N), 0.5, dtype)
    keep_raw = mode == "accu"
    jprep = JPrepared(jnp.asarray(w), 7, side=side, backend=jbe(interpret=True), keep_raw=keep_raw)
    want = np.asarray(j_gemm_prepared(
        jprep, jnp.asarray(x), method="garner", backend=jbe(interpret=True), mode=mode))
    prep = PreparedOperand(w, 7, side=side, backend=tbe(), keep_raw=keep_raw, device="cpu")
    tx = torch.from_numpy(x)
    got = gemm_prepared(prep, tx, backend=tbe(), mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    a, b = (tx, torch.from_numpy(w)) if side == "right" else (torch.from_numpy(w), tx)
    pol = repro_torch.GemmPolicy(n_moduli=7, mode=mode, execution=execution)
    direct = getattr(tl, "zgemm" if np.iscomplexobj(w) else "sgemm")(a, b, policy=pol, device="cpu")
    assert torch.equal(got, direct)


SERVE_CASES = [
    ("sgemm", np.float32, "fused", "fast", None),
    ("sgemm", np.float32, "kernel", "accu", None),
    ("cgemm", np.complex64, "fused", "accu", "block_b"),
    ("zgemm", np.complex128, "fused", "fast", "karatsuba"),
    ("zgemm", np.complex128, "kernel", "fast", "block_a"),
]


@pytest.mark.parametrize(
    "routine,dtype,execution,mode,formulation", SERVE_CASES,
    ids=[f"{r}-{e}-{m}-{f or 'real'}" for r, _, e, m, f in SERVE_CASES],
)
def test_serving_prepare_weights_matches_reference(rng, routine, dtype, execution, mode, formulation):
    """`prepare_weights` on a param tree, then the BLAS routine and
    `linalg.matmul` (with a batched activation) on its prepared "w"."""
    extra = {} if formulation is None else {"formulation": formulation}
    jpol = JPolicy(backend=tl.BACKEND_FOR_DTYPE[np.dtype(dtype).name], execution=execution,
                   mode=mode, interpret=True, **extra)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    w = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    x = phi_matrix(rng, (2, FAST_M // 2, FAST_K), 0.5, dtype)
    params = {"layer": [{"w": w, "b": np.zeros(FAST_N, dtype)}], "head": ({"w": w},)}
    jtree = j_prepare_weights(params, jpol)
    ttree = tl.prepare_weights(params, tpol, device="cpu")
    assert isinstance(ttree["head"], tuple) and ttree["layer"][0]["b"] is params["layer"][0]["b"]
    jw, tw = jtree["layer"][0]["w"], ttree["layer"][0]["w"]
    _assert_same_fields(tw, jw)
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(x[0]), jw, policy=jpol))
    got = getattr(tl, routine)(x[0], tw, policy=tpol, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(repro.linalg.matmul(jnp.asarray(x), jw, policy=jpol))
    got = tl.matmul(x, ttree["head"][0]["w"], policy=tpol, device="cpu")
    assert got.shape == (2, FAST_M // 2, FAST_N)
    np.testing.assert_array_equal(got.numpy(), want)
    unprepared = tl.matmul(x, w, policy=tpol, device="cpu")
    assert torch.equal(got, unprepared)


@pytest.mark.parametrize("dtype,mode", [(np.float32, "fast"), (np.complex64, "accu")])
def test_reference_prepared_weight_serves_from_the_port(rng, dtype, mode):
    """A weight prepared by the reference, carried over as numpy fields
    (`prepared_from_numpy`), gives the reference's bits from the port."""
    jpol = JPolicy(backend=tl.BACKEND_FOR_DTYPE[np.dtype(dtype).name], execution="fused",
                   mode=mode, interpret=True)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    w = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    x = phi_matrix(rng, (FAST_M, FAST_K), 0.5, dtype)
    jw = j_prepare_weights({"w": w}, jpol)["w"]
    tw = prepared_from_numpy(_fields(jw), device="cpu")
    _assert_same_fields(tw, jw)
    want = np.asarray(repro.linalg.matmul(jnp.asarray(x), jw, policy=jpol))
    got = tl.matmul(x, tw, policy=tpol, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _prepared(rng, dtype=np.float32, **policy_fields):
    w = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    pol = repro_torch.GemmPolicy(backend=tl.BACKEND_FOR_DTYPE[np.dtype(dtype).name], **policy_fields)
    return tl.prepare_weights({"w": w}, pol, device="cpu")["w"]


DRIFT = [
    ("mode", dict(execution="fused"), dict(mode="accu"), "re-cast from the raw operand"),
    ("mode-accu-to-fast", dict(execution="fused", mode="accu"), dict(), "prepared for mode='accu'"),
    ("n_moduli", dict(execution="kernel"), dict(n_moduli=6), "n_moduli=8"),
    ("dtype", dict(execution="kernel"), dict(backend="ozaki2_f64", n_moduli=8), "cast for float32"),
    ("native", dict(execution="kernel"), dict(backend="native"), "native policy"),
]


@pytest.mark.parametrize("prepared_with,served_with,match", [d[1:] for d in DRIFT], ids=[d[0] for d in DRIFT])
def test_prepared_drift_raises(rng, prepared_with, served_with, match):
    """A prepared weight served under a policy it was not prepared for
    raises the reference's ValueError instead of returning other bits."""
    w = _prepared(rng, **prepared_with)
    pol = repro_torch.GemmPolicy(**{"backend": "ozaki2_f32", "execution": "kernel", **served_with})
    x = phi_matrix(rng, (FAST_M, FAST_K), 0.5, np.float32)
    with pytest.raises(ValueError, match=match):
        tl.matmul(x, w, policy=pol, device="cpu")


def test_prepared_side_dtype_and_grad_raise(rng):
    x = phi_matrix(rng, (FAST_M, FAST_K), 0.5, np.float32)
    pol = repro_torch.GemmPolicy(backend="ozaki2_f32", execution="fused")
    left = PreparedOperand(phi_matrix(rng, (FAST_K, FAST_N), 0.5, np.float32), side="left", device="cpu")
    with pytest.raises(ValueError, match="side='right'"):
        tl.matmul(x, left, policy=pol, device="cpu")
    w = _prepared(rng, execution="fused")
    with pytest.raises(ValueError, match="zgemm computes in complex128"):
        tl.zgemm(x, w, policy=pol, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        tl.matmul(torch.from_numpy(x).requires_grad_(), w, policy=pol, device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        gemm_prepared(PreparedOperand(np.stack([x, x]), side="left", device="cpu"), torch.from_numpy(x.T))
