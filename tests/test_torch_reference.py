"""Parity of the port's `execution="reference"` and
`execution="per_modulus_kernel"` with `repro`'s, and of the deprecated
entry points with `linalg.matmul`.

The same numpy operands go through `repro.linalg` (the reference
execution is plain jnp; the per-modulus one runs the Pallas kernels in
interpret mode) and through `repro_torch.linalg` with ``device="cpu"``.
Tolerance: none — every comparison is bit for bit.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
import repro.core.executor as j_executor
from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import policy_matmul as j_policy_matmul
from repro.core.policy import prepare_weights as j_prepare_weights
import repro_torch
import repro_torch.core.executor as t_executor
from repro_torch import linalg as tl
from repro_torch.core.executor import REFERENCE, PreparedOperand
from repro_torch.core.policy import policy_matmul, prepare_weights
from repro_torch.interop import policy_from_fields

ROUTINES = {"sgemm": np.float32, "dgemm": np.float64, "cgemm": np.complex64, "zgemm": np.complex128}
METHODS = ("paper", "dd", "garner")


def _operands(rng, dtype, m=FAST_M, k=FAST_K, n=FAST_N):
    return phi_matrix(rng, (m, k), 0.5, dtype), phi_matrix(rng, (k, n), 0.5, dtype)


def _both(routine, a, b, **fields):
    """(reference result, port result) of one BLAS routine, as numpy."""
    jpol = JPolicy(interpret=True, **fields)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    want = np.asarray(getattr(repro.linalg, routine)(jnp.asarray(a), jnp.asarray(b), policy=jpol))
    got = getattr(tl, routine)(a, b, policy=tpol, device="cpu")
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    return want, got.numpy()


_GRID = [
    (routine, mode, form)
    for routine in ROUTINES
    for mode in ("fast", "accu")
    for form in (("karatsuba", "block_a", "block_b") if routine in ("cgemm", "zgemm") else ("karatsuba",))
]
# the whole grid on the default method, 'paper'; 'dd' and 'garner' take
# turns along it (a diagonal), which keeps the file's time in bounds
REFERENCE_CASES = [(*c, "paper") for c in _GRID] + [(*c, METHODS[1 + i % 2]) for i, c in enumerate(_GRID)]


@pytest.mark.parametrize("routine,mode,formulation,method", REFERENCE_CASES,
                         ids=["-".join(c) for c in REFERENCE_CASES])
def test_reference_execution_bitwise(rng, routine, mode, formulation, method):
    """The default execution: every routine, mode and complex formulation
    on 'paper', and on 'dd' or 'garner' in turn."""
    a, b = _operands(rng, ROUTINES[routine])
    want, got = _both(routine, a, b, mode=mode, formulation=formulation, method=method)
    np.testing.assert_array_equal(got, want)


def test_reference_is_the_default_execution(rng):
    a, b = _operands(rng, np.complex128)
    pol = repro_torch.GemmPolicy(backend="ozaki2_c128")
    assert pol.execution == "reference" and pol.execution_backend() is REFERENCE
    assert pol.resolved_method == "paper"
    want, got = _both("zgemm", a, b)
    np.testing.assert_array_equal(tl.matmul(a, b, policy=pol, device="cpu").numpy(), want)


@pytest.mark.parametrize("routine,formulation", [("sgemm", "karatsuba"), ("zgemm", "block_b")])
def test_reference_n_block_bitwise(rng, routine, formulation):
    a, b = _operands(rng, ROUTINES[routine], n=32)
    want, got = _both(routine, a, b, n_block=16, formulation=formulation, method="dd")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("execution", ["reference", "per_modulus_kernel"])
def test_chunked_k_bitwise(rng, execution, monkeypatch):
    """K-chunking with the int32 combine between chunks: K_CHUNK_LIMIT=64
    at k=160 gives three chunks in both packages, the same bits as the
    unchunked run (the per-modulus execution also as the kernel one's)."""
    cases = [("dgemm", _operands(rng, np.float64, k=160)), ("cgemm", _operands(rng, np.complex64, k=160))]
    pol = repro_torch.GemmPolicy(execution=execution, formulation="block_a")
    whole = [getattr(tl, r)(a, b, policy=pol, device="cpu") for r, (a, b) in cases]
    monkeypatch.setattr(j_executor, "K_CHUNK_LIMIT", 64)
    monkeypatch.setattr(t_executor, "K_CHUNK_LIMIT", 64)
    for (routine, (a, b)), unchunked in zip(cases, whole):
        got = getattr(tl, routine)(a, b, policy=pol, device="cpu")
        np.testing.assert_array_equal(got.numpy(), unchunked.numpy())
        if execution == "reference":
            want, got = _both(routine, a, b, formulation="block_a")
            np.testing.assert_array_equal(got, want)
        else:
            kernel = getattr(tl, routine)(a, b, policy=dataclasses.replace(pol, execution="kernel"),
                                          device="cpu")
            np.testing.assert_array_equal(got.numpy(), kernel.numpy())


@pytest.mark.parametrize("shape", [(32, 96, 24), (512, 64, 512), (4096, 4096, 4096), (64, 8192, 20000)])
def test_reference_auto_plan_matches(shape):
    """formulation='auto' / n_block='auto' price the reference backend's
    launches (3 composed products, one launch per modulus) as `repro`
    does: the same plan."""
    for fields in ({"formulation": "auto"}, {"formulation": "auto", "n_block": "auto"},
                   {"formulation": "auto", "execution": "per_modulus_kernel"}):
        jpol = JPolicy(backend="ozaki2_c128", interpret=True, **fields)
        tpol = policy_from_fields(dataclasses.asdict(jpol))
        jplan, tplan = jpol.plan_for(*shape), tpol.plan_for(*shape)
        assert (tplan.formulation, tplan.n_block, tplan.n_moduli, tplan.method) == \
            (jplan.formulation, jplan.n_block, jplan.n_moduli, jplan.method)


def test_reference_auto_formulation_bitwise(rng):
    a, b = _operands(rng, np.complex64)
    want, got = _both("cgemm", a, b, formulation="auto")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["fast", "accu"])
@pytest.mark.parametrize("dtype", list(ROUTINES.values()), ids=list(ROUTINES))
def test_reference_prepared_parity(rng, dtype, mode):
    """`prepare_weights` on the reference execution casts in float64: the
    prepared run equals the unprepared one and `repro`'s prepared run."""
    x, w = _operands(rng, dtype)
    fields = dict(backend=tl.BACKEND_FOR_DTYPE[np.dtype(dtype).name], mode=mode, n_moduli=6)
    tpol = repro_torch.GemmPolicy(**fields)
    tx = torch.from_numpy(x)
    direct = policy_matmul(tx, torch.from_numpy(w), tpol)
    prep = prepare_weights({"w": w}, tpol, device="cpu")["w"]
    assert isinstance(prep, PreparedOperand) and (prep.raw is not None) == (mode == "accu")
    prepped = policy_matmul(tx, prep, tpol)
    assert torch.equal(prepped, direct)
    jpol = JPolicy(**fields)
    want = np.asarray(j_policy_matmul(jnp.asarray(x), j_prepare_weights({"w": jnp.asarray(w)}, jpol)["w"], jpol))
    np.testing.assert_array_equal(prepped.numpy(), want)


PER_MODULUS_CASES = [("sgemm", "fast", "karatsuba"), ("zgemm", "accu", "karatsuba")]


@pytest.mark.parametrize("routine,mode,formulation", PER_MODULUS_CASES,
                         ids=["-".join(c) for c in PER_MODULUS_CASES])
def test_per_modulus_matches_reference_per_modulus(rng, routine, mode, formulation):
    """Against `repro`'s per-modulus execution (interpret-mode Pallas, one
    launch per modulus: kept small, N = 3; each of the two products)."""
    a, b = _operands(rng, ROUTINES[routine], m=16, k=40, n=12)
    want, got = _both(routine, a, b, execution="per_modulus_kernel", mode=mode,
                      formulation=formulation, n_moduli=3)
    np.testing.assert_array_equal(got, want)


KERNEL_CASES = [
    (routine, mode, form)
    for routine in ROUTINES
    for mode in ("fast", "accu")
    for form in (("karatsuba", "block_a", "block_b") if routine in ("cgemm", "zgemm") else ("karatsuba",))
]


@pytest.mark.parametrize("routine,mode,formulation", KERNEL_CASES, ids=["-".join(c) for c in KERNEL_CASES])
def test_per_modulus_matches_kernel_execution(rng, routine, mode, formulation):
    """Against the port's batched kernel execution, the whole grid; at
    f32 grade (sgemm, cgemm) also the reference execution's bits."""
    a, b = _operands(rng, ROUTINES[routine])
    pol = repro_torch.GemmPolicy(execution="per_modulus_kernel", mode=mode, formulation=formulation)
    fn = getattr(tl, routine)
    got = fn(a, b, policy=pol, device="cpu")
    assert torch.equal(got, fn(a, b, policy=dataclasses.replace(pol, execution="kernel"), device="cpu"))
    if routine in ("sgemm", "cgemm"):
        ref = fn(a, b, policy=dataclasses.replace(pol, execution="reference"), device="cpu")
        assert torch.equal(got, ref)


def test_per_modulus_refuses_other_methods():
    with pytest.raises(ValueError, match="reference-path only"):
        repro_torch.GemmPolicy(execution="per_modulus_kernel", method="paper")


def _warns(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    assert any(issubclass(w.category, DeprecationWarning) and "deprecated" in str(w.message)
               for w in caught), caught
    return out


def test_deprecated_shims_warn_and_match(rng):
    """Each shim warns DeprecationWarning and equals `linalg.matmul` under
    the equivalent policy, bit for bit (the core shims also `repro`'s)."""
    from repro.core.cgemm import ozaki2_cgemm as j_cgemm
    from repro.core.gemm import ozaki2_gemm as j_gemm
    from repro_torch.core.cgemm import ozaki2_cgemm
    from repro_torch.core.gemm import ozaki2_gemm
    from repro_torch.kernels.ops import ozaki2_cgemm_kernels, ozaki2_gemm_kernels

    a, b = _operands(rng, np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _warns(lambda: ozaki2_gemm(ta, tb, n_moduli=12, mode="accu", method="dd", device="cpu"))
    pol = repro_torch.GemmPolicy(backend="ozaki2_f64", n_moduli=12, mode="accu", method="dd")
    assert torch.equal(got, tl.matmul(ta, tb, policy=pol, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(j_gemm(jnp.asarray(a), jnp.asarray(b), n_moduli=12, mode="accu", method="dd"))
    np.testing.assert_array_equal(got.numpy(), want)
    # batched operands: per-slice emulation
    a3 = np.stack([a, phi_matrix(rng, a.shape, 0.5, np.float64)])
    b3 = np.stack([b, b])
    got3 = _warns(lambda: ozaki2_gemm(torch.from_numpy(a3), torch.from_numpy(b3), device="cpu"))
    for i in range(2):
        one = _warns(lambda: ozaki2_gemm(torch.from_numpy(a3[i]), torch.from_numpy(b3[i]), device="cpu"))
        assert torch.equal(got3[i], one)

    c, d = _operands(rng, np.complex128)
    tc, td = torch.from_numpy(c), torch.from_numpy(d)
    got = _warns(lambda: ozaki2_cgemm(tc, td, formulation="block_b", method="garner", device="cpu"))
    pol = repro_torch.GemmPolicy(backend="ozaki2_c128", formulation="block_b", method="garner")
    assert torch.equal(got, tl.matmul(tc, td, policy=pol, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(j_cgemm(jnp.asarray(c), jnp.asarray(d), formulation="block_b", method="garner"))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="complex"):
        _warns(lambda: ozaki2_cgemm(ta, tb, device="cpu"))

    s, t = _operands(rng, np.float32)
    got = _warns(lambda: ozaki2_gemm_kernels(s, t, n_moduli=7, device="cpu"))
    pol = repro_torch.GemmPolicy(backend="ozaki2_f32", execution="kernel", n_moduli=7, out_dtype="float32")
    assert torch.equal(got, tl.matmul(s, t, policy=pol, device="cpu"))
    u, v = _operands(rng, np.complex64)
    got = _warns(lambda: ozaki2_cgemm_kernels(u, v, formulation="block_a", n_block=8, device="cpu"))
    pol = repro_torch.GemmPolicy(backend="ozaki2_c64", execution="kernel", formulation="block_a",
                                 n_block=8, out_dtype="complex64")
    assert torch.equal(got, tl.matmul(u, v, policy=pol, device="cpu"))
