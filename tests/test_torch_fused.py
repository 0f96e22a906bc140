"""Parity of the port's `fused` execution (the two megakernels and
`FusedBackend`) with the reference's.

On the CPU each megakernel wrapper runs its plain PyTorch version; the same
numpy inputs go through the reference's Pallas megakernel in interpret mode.
Tolerance: none — outputs are compared bit for bit, the contract the
reference holds between its `fused` and `kernel` executions.  The kernel
cases mirror phase 2 of `chip_smoke.py`, which holds each CUDA megakernel
against its plain version on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
import repro.core.executor as j_executor
import repro.core.moduli as jmod
import repro.core.plan as jplan
from repro.core.policy import GemmPolicy as JPolicy
from repro.kernels.int8_mod_gemm import fused_mod_gemm as j_fused_mod_gemm
from repro.kernels.karatsuba_fused import fused_karatsuba_mod_gemm as j_fused_karatsuba
from repro.kernels.ops import FusedBackend as JFused
import repro_torch
import repro_torch.core.executor as t_executor
import repro_torch.core.moduli as tmod
import repro_torch.core.plan as tplan
import repro_torch.core.scaling as tscal
import repro_torch.kernels.ops as tops
from repro_torch import linalg as tl
from repro_torch.interop import policy_from_fields, tensors_from_numpy
from repro_torch.kernels.int8_mod_gemm import fused_mod_gemm
from repro_torch.kernels.karatsuba_fused import fused_karatsuba_mod_gemm
from repro_torch.kernels.residue_cast import residue_cast
from repro_torch.kernels.common import split_scale_exponent

RAGGED = (37, 100, 29)  # (m, k, n), off every tile multiple


def _scaled_operands(rng, shape, complex_, n):
    """Operands, their fast-mode exponents and the B planes cast at them."""
    m, k, n_cols = shape
    dtype = np.complex64 if complex_ else np.float32
    a = phi_matrix(rng, (m, k), 0.5, dtype)
    b = phi_matrix(rng, (k, n_cols), 0.5, dtype)
    ctx = tmod.make_crt_context(n)
    nl = tplan.n_limbs_for_ctx(ctx)
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    if complex_:
        e_mu, e_nu = tscal.scale_fast_complex(ta.real, ta.imag, tb.real, tb.imag, ctx)
        xb = torch.stack([tb.real, tb.imag])
    else:
        e_mu, e_nu = tscal.scale_fast_real(ta, tb, ctx)
        xb = tb[None]
    s1, s2 = split_scale_exponent(e_nu)
    planes = residue_cast(xb.contiguous(), s1, s2, moduli=ctx.moduli, n_limbs=nl, scale_axis=1)
    return a, b, e_mu, e_nu, planes, nl


CASES = [
    (8, False, False, (FAST_M, FAST_K, FAST_N)),
    (16, True, False, (FAST_M, FAST_K, FAST_N)),
    (8, False, True, (FAST_M, FAST_K, FAST_N)),
    (14, True, True, RAGGED),
    (7, False, False, RAGGED),
]
IDS = ["n8-f32", "n16-dd", "n8-prepared", "n14-dd-prepared-ragged", "n7-ragged"]


@pytest.mark.parametrize("n,out_dd,prepared,shape", CASES, ids=IDS)
def test_fused_mod_gemm_matches_pallas(rng, n, out_dd, prepared, shape):
    a, b, e_mu, e_nu, planes, nl = _scaled_operands(rng, shape, False, n)
    b_res = planes[0] if prepared else None
    jb_res = None if b_res is None else jnp.asarray(b_res.numpy())
    want = j_fused_mod_gemm(
        jnp.asarray(a), None if prepared else jnp.asarray(b), jnp.asarray(e_mu.numpy()),
        jnp.asarray(e_nu.numpy()), jmod.make_crt_context(n), n_limbs=nl, out_dd=out_dd,
        b_res=jb_res, interpret=True,
    )
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    got = fused_mod_gemm(
        ta, None if prepared else tb, e_mu, e_nu, tmod.make_crt_context(n), n_limbs=nl,
        out_dd=out_dd, b_res=b_res,
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,out_dd,prepared,shape", CASES, ids=IDS)
def test_fused_karatsuba_matches_pallas(rng, n, out_dd, prepared, shape):
    a, b, e_mu, e_nu, planes, nl = _scaled_operands(rng, shape, True, n)
    b_res = (planes[0], planes[1]) if prepared else None
    jb = (None, None) if prepared else (jnp.asarray(b.real), jnp.asarray(b.imag))
    want = j_fused_karatsuba(
        jnp.asarray(a.real), jnp.asarray(a.imag), *jb, jnp.asarray(e_mu.numpy()),
        jnp.asarray(e_nu.numpy()), jmod.make_crt_context(n), n_limbs=nl, out_dd=out_dd,
        b_res=None if b_res is None else tuple(jnp.asarray(r.numpy()) for r in b_res),
        interpret=True,
    )
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    tbb = (None, None) if prepared else (tb.real, tb.imag)
    got = fused_karatsuba_mod_gemm(
        ta.real, ta.imag, *tbb, e_mu, e_nu, tmod.make_crt_context(n), n_limbs=nl,
        out_dd=out_dd, b_res=b_res,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_megakernel_wrappers_check_their_operands(rng):
    a, b, e_mu, e_nu, planes, nl = _scaled_operands(rng, (8, 16, 4), False, 8)
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    ctx = tmod.make_crt_context(8)
    with pytest.raises(ValueError, match="exactly one"):
        fused_mod_gemm(ta, tb, e_mu, e_nu, ctx, n_limbs=nl, b_res=planes[0])
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_mod_gemm(ta, tb[:8], e_mu, e_nu, ctx, n_limbs=nl)
    with pytest.raises(ValueError, match="exactly one"):
        fused_karatsuba_mod_gemm(ta, ta, None, None, e_mu, e_nu, ctx, n_limbs=nl)


EXEC_CASES = [
    (np.float32, "fast", None), (np.float32, "accu", None),
    (np.float64, "fast", None), (np.float64, "accu", None),
] + [
    (dt, mode, form)
    for dt in (np.complex64, np.complex128)
    for mode in ("fast", "accu")
    for form in ("karatsuba", "block_a", "block_b")
]


@pytest.mark.parametrize(
    "dtype,mode,formulation", EXEC_CASES,
    ids=[f"{np.dtype(d).name}-{m}-{f or 'real'}" for d, m, f in EXEC_CASES],
)
def test_execute_plan_fused_matches_pallas(rng, dtype, mode, formulation):
    """`execute_plan` on the port's `FusedBackend` equals the reference's
    `FusedBackend(interpret=True)` and the port's own kernel execution."""
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, dtype)
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    jp = jplan.make_plan(dtype, mode=mode, method="garner", formulation=formulation)
    tp = tplan.make_plan(np.dtype(dtype).name, mode=mode, method="garner", formulation=formulation)
    want = np.asarray(j_executor.execute_plan(jp, jnp.asarray(a), jnp.asarray(b), JFused(interpret=True)))
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    got = t_executor.execute_plan(tp, ta, tb, tops.FusedBackend())
    np.testing.assert_array_equal(got.numpy(), want)
    kernel = t_executor.execute_plan(tp, ta, tb, tops.KernelBackend())
    assert torch.equal(got, kernel)


def _both(routine, a, b, **policy_fields):
    """(reference result, port result) of one BLAS routine under the fused
    execution, as numpy."""
    jpol = JPolicy(execution="fused", interpret=True, **policy_fields)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(a), jnp.asarray(b), policy=jpol))
    got = getattr(tl, routine)(a, b, policy=tpol, device="cpu")
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    return want, got.numpy()


@pytest.mark.parametrize("routine,dtype", [("sgemm", np.float32), ("zgemm", np.complex128)])
def test_fused_chunked_k_bitwise(rng, monkeypatch, routine, dtype):
    """K_CHUNK_LIMIT=64 at k=160 puts two in-kernel chunk reductions into
    the one launch, in both packages; the port also matches its own
    unchunked run."""
    a = phi_matrix(rng, (FAST_M, 160), 0.5, dtype)
    b = phi_matrix(rng, (160, FAST_N), 0.5, dtype)
    pol = repro_torch.GemmPolicy(execution="fused")
    whole = getattr(tl, routine)(a, b, policy=pol, device="cpu")
    monkeypatch.setattr(j_executor, "K_CHUNK_LIMIT", 64)
    monkeypatch.setattr(t_executor, "K_CHUNK_LIMIT", 64)
    assert tops.FusedBackend._chunk_limit() == 64
    want, got = _both(routine, a, b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, whole.numpy())


@pytest.mark.parametrize("routine,dtype,wrapper", [
    ("sgemm", np.float32, "fused_mod_gemm"),
    ("cgemm", np.complex64, "fused_karatsuba_mod_gemm"),
])
def test_fused_n_block_one_launch_per_block(rng, monkeypatch, routine, dtype, wrapper):
    """n_block=8 at n=24: one megakernel call per output-column block (3),
    no other kernel, and the reference's bits."""
    calls = []
    inner = getattr(tops, wrapper)

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(tops, wrapper, counting)
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, dtype)
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    want, got = _both(routine, a, b, n_block=8)
    assert len(calls) == 3
    np.testing.assert_array_equal(got, want)
