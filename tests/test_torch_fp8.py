"""Parity of the port's `fp8` execution (`repro_torch.kernels.fp8_mod_gemm`
and `Fp8Backend`) with the reference's.

On the CPU each e4m3 kernel wrapper runs its plain PyTorch version; the
same numpy inputs go through the reference's Pallas kernels in interpret
mode, as `tests/test_fp8.py` runs them.  Tolerance: none — outputs are
compared bit for bit, the contract the reference holds between its `fp8`
and `kernel` executions.  The kernel cases mirror phase 2 of
`chip_smoke.py`, which holds each CUDA kernel against its plain version
and against the int8 kernels on the card.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
import repro.core.moduli as jmod
from repro.core.executor import Fp8Backend as JFp8
from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import prepare_weights as j_prepare_weights
from repro.kernels.fp8_mod_gemm import _digits as j_digits
from repro.kernels.fp8_mod_gemm import fp8_karatsuba_mod_gemm_batched as j_fp8_karatsuba
from repro.kernels.fp8_mod_gemm import fp8_mod_gemm_batched as j_fp8_mod_gemm
import repro_torch
import repro_torch.core.moduli as tmod
import repro_torch.kernels.fp8_mod_gemm as tfp8
import repro_torch.kernels.ops as tops
from repro_torch import linalg as tl
from repro_torch.kernels.common import on_card
from repro_torch.interop import policy_from_fields, prepared_from_numpy, tensors_from_numpy
from repro_torch.kernels.int8_mod_gemm import int8_mod_gemm_plain
from repro_torch.kernels.karatsuba_fused import karatsuba_mod_gemm_plain

ROUTINES = {"sgemm": np.float32, "dgemm": np.float64, "cgemm": np.complex64, "zgemm": np.complex128}


def _residues(rng, moduli, shape):
    """Canonical symmetric residues, plane l drawn in [-(p_l-1)/2, (p_l-1)/2]."""
    return np.stack(
        [rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, size=shape) for p in moduli]
    ).astype(np.int8)


def test_digits_match_reference_for_every_residue():
    """All 255 residues, the ties +-8, +-24, ... included: the same digits,
    each exact in e4m3 and within [-8, 8]."""
    r = np.arange(-127, 128, dtype=np.float32)
    jh, jl = (np.asarray(x) for x in j_digits(jnp.asarray(r)))
    th, tl_ = tfp8.digits(torch.from_numpy(r))
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tl_.numpy(), jl)
    assert np.all(np.abs(jh) <= 8) and np.all(np.abs(jl) <= 8)
    np.testing.assert_array_equal(16 * jh + jl, r)
    for d in (th, tl_):
        assert torch.equal(d.to(torch.float8_e4m3fn).float(), d)


SHAPES = [(32, 64, 16), (33, 97, 25), (1, 31, 129)]


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_fp8_mod_gemm_matches_pallas(rng, shape, carry):
    m, k, n = shape
    ctx = jmod.make_crt_context(5)
    a = _residues(rng, ctx.moduli, (m, k))
    b = _residues(rng, ctx.moduli, (k, n))
    c = _residues(rng, ctx.moduli, (m, n)) if carry else None
    want = j_fp8_mod_gemm(
        jnp.asarray(a), jnp.asarray(b), moduli=ctx.moduli,
        carry=None if c is None else jnp.asarray(c), interpret=True,
    )
    ta, tb, tc = tensors_from_numpy((a, b, c), device="cpu")
    got = tfp8.fp8_mod_gemm_batched(ta, tb, moduli=ctx.moduli, carry=tc)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, int8_mod_gemm_plain(ta, tb, moduli=ctx.moduli, carry=tc))


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_fp8_karatsuba_matches_pallas(rng, shape, carry):
    m, k, n = shape
    ctx = jmod.make_crt_context(6)
    ar, ai = (_residues(rng, ctx.moduli, (m, k)) for _ in range(2))
    br, bi = (_residues(rng, ctx.moduli, (k, n)) for _ in range(2))
    c = tuple(_residues(rng, ctx.moduli, (m, n)) for _ in range(2)) if carry else None
    want = j_fp8_karatsuba(
        *map(jnp.asarray, (ar, ai, br, bi)), moduli=ctx.moduli,
        carry=None if c is None else tuple(map(jnp.asarray, c)), interpret=True,
    )
    ops = tensors_from_numpy((ar, ai, br, bi), device="cpu")
    tc = tensors_from_numpy(c, device="cpu")
    got = tfp8.fp8_karatsuba_mod_gemm_batched(*ops, moduli=ctx.moduli, carry=tc)
    int8 = karatsuba_mod_gemm_plain(*ops, moduli=ctx.moduli, carry=tc)
    for g, w, i in zip(got, want, int8):
        assert g.dtype == torch.int8 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, i)


def test_fp8_worst_case_accumulation_at_the_chunk_limit():
    """k = FP8_K_CHUNK_LIMIT with every residue -120 (hi = -8, lo = 8: the
    largest digit product in every term, so HH, LL and X reach their
    bounds 2^22, 2^22 and 2^23), on a 2x2 output with N = 2."""
    k = tfp8.FP8_K_CHUNK_LIMIT
    ctx = jmod.make_crt_context(2)
    a = np.full((2, 2, k), -120, np.int8)
    b = np.full((2, k, 2), -120, np.int8)
    b[:, ::2, 1] = 120  # one column of alternating signs
    want = np.asarray(j_fp8_mod_gemm(jnp.asarray(a), jnp.asarray(b), moduli=ctx.moduli, interpret=True))
    ta, tb = tensors_from_numpy((a, b), device="cpu")
    got = tfp8.fp8_mod_gemm_batched(ta, tb, moduli=ctx.moduli)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, int8_mod_gemm_plain(ta, tb, moduli=ctx.moduli))
    exact = [[(120 * 120 * k if j == 0 else 0) % p for j in range(2)] for p in ctx.moduli]
    exact = np.asarray([[v - p if v > (p - 1) // 2 else v for v in row] for row, p in zip(exact, ctx.moduli)])
    np.testing.assert_array_equal(got.numpy()[:, 0, :], exact)


def test_fp8_karatsuba_worst_case_accumulation_at_the_chunk_limit():
    """The complex kernel at k = FP8_K_CHUNK_LIMIT with AR = BR = -120 and
    AI = BI = 0: D and F take the largest digit mass in every term."""
    k = tfp8.FP8_K_CHUNK_LIMIT
    ctx = tmod.make_crt_context(2)
    ar, br = torch.full((2, 2, k), -120, dtype=torch.int8), torch.full((2, k, 2), -120, dtype=torch.int8)
    ai, bi = torch.zeros_like(ar), torch.zeros_like(br)
    got = tfp8.fp8_karatsuba_mod_gemm_batched(ar, ai, br, bi, moduli=ctx.moduli)
    want = karatsuba_mod_gemm_plain(ar, ai, br, bi, moduli=ctx.moduli)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fp8_wrappers_reject_oversized_k_bad_shapes_and_other_devices():
    ctx = tmod.make_crt_context(2)
    k = tfp8.FP8_K_CHUNK_LIMIT + 32
    a, b = torch.zeros((2, 8, k), dtype=torch.int8), torch.zeros((2, k, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="chunk"):
        tfp8.fp8_mod_gemm_batched(a, b, moduli=ctx.moduli)
    with pytest.raises(ValueError, match="chunk"):
        tfp8.fp8_karatsuba_mod_gemm_batched(a, a, b, b, moduli=ctx.moduli)
    a, b = torch.zeros((2, 8, 16), dtype=torch.int8), torch.zeros((2, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfp8.fp8_mod_gemm_batched(a, b[:, :8], moduli=ctx.moduli)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfp8.fp8_karatsuba_mod_gemm_batched(a, a, b, b[:1], moduli=ctx.moduli)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfp8.fp8_mod_gemm_batched(a, b, moduli=ctx.moduli[:1])
    # meta tensors take the card's branch up to its launch (the dry run's
    # shapes): meta outputs, no launch counted; a mix of devices and any
    # device with neither a kernel nor a plain version raise
    meta = (a.to("meta"), b.to("meta"))
    before = (tfp8.fp8_mod_gemm_batched.launches, tfp8.fp8_karatsuba_mod_gemm_batched.launches)
    out = tfp8.fp8_mod_gemm_batched(*meta, moduli=ctx.moduli)
    assert out.is_meta and out.dtype == torch.int8 and tuple(out.shape) == (2, 8, 8)
    cr, ci = tfp8.fp8_karatsuba_mod_gemm_batched(*meta[:1], *meta[:1], *meta[1:], *meta[1:], moduli=ctx.moduli)
    assert cr.is_meta and ci.is_meta and tuple(ci.shape) == (2, 8, 8)
    assert (tfp8.fp8_mod_gemm_batched.launches, tfp8.fp8_karatsuba_mod_gemm_batched.launches) == before
    with pytest.raises(ValueError, match="devices"):
        tfp8.fp8_mod_gemm_batched(a, meta[1], moduli=ctx.moduli)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        on_card(types.SimpleNamespace(device=torch.device("xpu")))


def test_fp8_chunked_matches_unchunked(rng, monkeypatch):
    """FP8_K_CHUNK_LIMIT patched to 32 at k = 100: four launches each, the
    chunk carry folded in, the same bits as one launch."""
    ctx = tmod.make_crt_context(4)
    a = _residues(rng, ctx.moduli, (8, 100))
    b = _residues(rng, ctx.moduli, (100, 8))
    ta, tb, ta2, tb2 = tensors_from_numpy((a, b, a[:, ::-1], b[:, ::-1]), device="cpu")
    be = tops.Fp8Backend()
    one = be.residue_matmul(ta, tb, ctx)
    one_c = be.karatsuba(ta, ta2, tb, tb2, ctx)
    calls = []

    def counting(wrapper):
        def call(*args, **kw):
            calls.append(wrapper.__name__)
            return wrapper(*args, **kw)
        return call

    monkeypatch.setattr(tfp8, "FP8_K_CHUNK_LIMIT", 32)
    for name in ("fp8_mod_gemm_batched", "fp8_karatsuba_mod_gemm_batched"):
        monkeypatch.setattr(tfp8, name, counting(getattr(tfp8, name)))
    many = be.residue_matmul(ta, tb, ctx)
    many_c = be.karatsuba(ta, ta2, tb, tb2, ctx)
    assert calls == ["fp8_mod_gemm_batched"] * 4 + ["fp8_karatsuba_mod_gemm_batched"] * 4
    assert torch.equal(one, many)
    assert all(torch.equal(x, y) for x, y in zip(one_c, many_c))
    want = JFp8(interpret=True).residue_matmul(jnp.asarray(a), jnp.asarray(b), jmod.make_crt_context(4))
    np.testing.assert_array_equal(many.numpy(), np.asarray(want))


def _both(routine, a, b, **policy_fields):
    """(reference result, port result) of one BLAS routine under the fp8
    execution, as numpy, after checking the port's result equals its own
    kernel execution."""
    jpol = JPolicy(execution="fp8", interpret=True, **policy_fields)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    assert tpol.execution == "fp8"
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(a), jnp.asarray(b), policy=jpol))
    got = getattr(tl, routine)(a, b, policy=tpol, device="cpu")
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    kernel = getattr(tl, routine)(a, b, policy=dataclasses.replace(tpol, execution="kernel"), device="cpu")
    assert torch.equal(got, kernel)
    return want, got.numpy()


@pytest.mark.parametrize("mode", ["fast", "accu"])
@pytest.mark.parametrize("routine", list(ROUTINES))
def test_fp8_blas_routines_bitwise(rng, routine, mode):
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, ROUTINES[routine])
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, ROUTINES[routine])
    want, got = _both(routine, a, b, mode=mode)
    np.testing.assert_array_equal(got, want)


FORMS = [("cgemm", "karatsuba"), ("cgemm", "block_a"), ("zgemm", "block_b")]


@pytest.mark.parametrize("routine,formulation", FORMS, ids=[f"{r}-{f}" for r, f in FORMS])
def test_fp8_complex_formulations_bitwise(rng, routine, formulation):
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, ROUTINES[routine])
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, ROUTINES[routine])
    want, got = _both(routine, a, b, formulation=formulation, mode="accu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("routine,formulation", [("sgemm", None), ("zgemm", "karatsuba")])
def test_fp8_n_block_bitwise(rng, routine, formulation):
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, ROUTINES[routine])
    b = phi_matrix(rng, (FAST_K, 40), 0.5, ROUTINES[routine])
    extra = {} if formulation is None else {"formulation": formulation}
    want, got = _both(routine, a, b, n_block=16, **extra)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("routine", ["sgemm", "cgemm"])
def test_fp8_execution_calls_cast_fp8_product_garner(rng, monkeypatch, routine):
    """One fp8 GEMM is cast, cast, one e4m3 product, Garner — the 4 launches
    of the card — and never an int8 product or a megakernel."""
    calls = []
    for name in ("residue_cast", "crt_garner"):
        inner = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=inner, _n=name, **k: calls.append(_n) or _f(*a, **k))
    for name in ("fp8_mod_gemm_batched", "fp8_karatsuba_mod_gemm_batched"):
        inner = getattr(tfp8, name)
        monkeypatch.setattr(tfp8, name, lambda *a, _f=inner, _n=name, **k: calls.append(_n) or _f(*a, **k))
    for name in ("int8_mod_gemm_batched", "karatsuba_mod_gemm_batched", "fused_mod_gemm",
                 "fused_karatsuba_mod_gemm"):
        monkeypatch.setattr(tops, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, ROUTINES[routine])
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, ROUTINES[routine])
    getattr(tl, routine)(a, b, policy=repro_torch.GemmPolicy(execution="fp8"), device="cpu")
    product = "fp8_karatsuba_mod_gemm_batched" if routine == "cgemm" else "fp8_mod_gemm_batched"
    assert calls == ["residue_cast", "residue_cast", product, "crt_garner"]


SERVE = [("sgemm", np.float32, "fast"), ("zgemm", np.complex128, "fast"), ("cgemm", np.complex64, "accu")]


@pytest.mark.parametrize("routine,dtype,mode", SERVE, ids=[f"{r}-{m}" for r, _, m in SERVE])
def test_fp8_prepared_serving_bitwise(rng, routine, dtype, mode):
    """`prepare_weights` under an fp8 policy: equal to the unprepared call,
    to the reference's prepared fp8 call, and — carried over with
    `prepared_from_numpy` — a reference preparation serves the same bits."""
    jpol = JPolicy(backend=tl.BACKEND_FOR_DTYPE[np.dtype(dtype).name], execution="fp8", mode=mode,
                   interpret=True)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    w = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dtype)
    x = phi_matrix(rng, (FAST_M, FAST_K), 0.5, dtype)
    tw = tl.prepare_weights({"w": w}, tpol, device="cpu")["w"]
    got = getattr(tl, routine)(x, tw, policy=tpol, device="cpu")
    assert torch.equal(got, getattr(tl, routine)(x, w, policy=tpol, device="cpu"))
    jw = j_prepare_weights({"w": jnp.asarray(w)}, jpol)["w"]
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(x), jw, policy=jpol))
    np.testing.assert_array_equal(got.numpy(), want)
    arr = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    fields = {
        "side": jw.side, "n_moduli": jw.n_moduli, "n_limbs": jw.n_limbs, "dtype": jw.dtype,
        "e_scale": arr(jw.e_scale), "residues": tuple(map(arr, jw.residues)),
        "bound": tuple(map(arr, jw.bound)), "e_bound": arr(jw.e_bound), "raw": arr(jw.raw),
    }
    carried = prepared_from_numpy(fields, device="cpu")
    assert torch.equal(getattr(tl, routine)(x, carried, policy=tpol, device="cpu"), got)
