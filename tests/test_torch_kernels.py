"""Parity of the port's kernels (`repro_torch.kernels`) with the Pallas ones.

On the CPU each wrapper runs its plain PyTorch version; the same numpy
inputs go through the reference's Pallas kernel in interpret mode.
Tolerance: none — outputs are compared bit for bit.  The cases mirror
phase 2 of `chip_smoke.py`, which holds each CUDA kernel against its plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, phi_matrix

import repro.core.expansion as jex
import repro.core.moduli as jmod
from repro.core.plan import n_limbs_for_ctx
from repro.kernels.crt_garner import _weight_table as j_weight_table
from repro.kernels.crt_garner import crt_garner as j_crt_garner
from repro.kernels.int8_mod_gemm import int8_mod_gemm_batched as j_int8_mod_gemm
from repro.kernels.karatsuba_fused import karatsuba_mod_gemm_batched as j_karatsuba
from repro.kernels.residue_cast import residue_cast as j_residue_cast
import repro_torch.core.moduli as tmod
import repro_torch.kernels as tk
from repro_torch.interop import tensors_from_numpy
from repro_torch.kernels.common import split_scale_exponent


def _residues(rng, moduli, shape):
    """Canonical symmetric residues, plane l drawn in [-(p_l-1)/2, (p_l-1)/2]."""
    return np.stack(
        [rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, size=shape) for p in moduli]
    ).astype(np.int8)


@pytest.mark.parametrize(
    "n,axis,shape",
    [(8, 0, (2, 257, 1000)), (14, 1, (2, 257, 1000)), (7, 0, (FAST_M, FAST_K)), (16, 1, (FAST_M, FAST_K))],
    ids=["n8-rows-stack-ragged", "n14-cols-stack-ragged", "n7-rows-2d", "n16-cols-2d"],
)
def test_residue_cast_matches_pallas(rng, n, axis, shape):
    ctx = jmod.make_crt_context(n)
    nl = n_limbs_for_ctx(ctx)
    x = phi_matrix(rng, shape, 0.5, np.float32)
    e = rng.integers(20, 40, size=shape[-2] if axis == 0 else shape[-1]).astype(np.int32)
    tx, te = tensors_from_numpy((x, e), device="cpu")
    s1, s2 = split_scale_exponent(te)
    want = j_residue_cast(
        jnp.asarray(x), jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()),
        moduli=ctx.moduli, n_limbs=nl, scale_axis=axis, interpret=True,
    )
    got = tk.residue_cast.residue_cast(tx, s1, s2, moduli=ctx.moduli, n_limbs=nl, scale_axis=axis)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_residue_cast_limbs_near_2_24(rng):
    """Scaled values just below 2^48 put a limb just below 2^24 in magnitude,
    where the f32 reciprocal trick's n*p passes 2^24: the residues must be
    the exact ones (Python integers) and the reference's."""
    ctx = jmod.make_crt_context(14)
    nl = n_limbs_for_ctx(ctx)
    x = (-0.25 * (1.0 - rng.integers(1, 2**12, size=(2, 8, 64)) * 2.0**-24)).astype(np.float32)
    x[1] *= -1
    e = np.full(64, 50, dtype=np.int32)
    tx, te = tensors_from_numpy((x, e), device="cpu")
    s1, s2 = split_scale_exponent(te)
    got = tk.residue_cast.residue_cast(tx, s1, s2, moduli=ctx.moduli, n_limbs=nl, scale_axis=1).numpy()
    exact = np.empty_like(got)
    for idx in np.ndindex(x.shape):
        v = int(np.float64(x[idx]) * 2.0**50)
        for l, p in enumerate(ctx.moduli):
            r = v % p
            exact[idx[0], l, idx[1], idx[2]] = r - p if r > (p - 1) // 2 else r
    np.testing.assert_array_equal(got, exact)
    want = j_residue_cast(
        jnp.asarray(x), jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()),
        moduli=ctx.moduli, n_limbs=nl, scale_axis=1, interpret=True,
    )
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("n,m,k,nn", [(8, 257, 1000, 129), (5, FAST_M, FAST_K, 24)], ids=["n8-ragged", "n5-fast"])
def test_int8_mod_gemm_matches_pallas(rng, carry, n, m, k, nn):
    ctx = jmod.make_crt_context(n)
    a = _residues(rng, ctx.moduli, (m, k))
    b = _residues(rng, ctx.moduli, (k, nn))
    c = _residues(rng, ctx.moduli, (m, nn)) if carry else None
    want = j_int8_mod_gemm(
        jnp.asarray(a), jnp.asarray(b), moduli=ctx.moduli,
        carry=None if c is None else jnp.asarray(c), interpret=True,
    )
    ta, tb, tc = tensors_from_numpy((a, b, c), device="cpu")
    got = tk.int8_mod_gemm.int8_mod_gemm_batched(ta, tb, moduli=ctx.moduli, carry=tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("n,m,k,nn", [(7, 257, 1000, 129), (14, FAST_M, FAST_K, 24)], ids=["n7-ragged", "n14-fast"])
def test_karatsuba_matches_pallas(rng, carry, n, m, k, nn):
    ctx = jmod.make_crt_context(n)
    ar, ai = (_residues(rng, ctx.moduli, (m, k)) for _ in range(2))
    br, bi = (_residues(rng, ctx.moduli, (k, nn)) for _ in range(2))
    c = tuple(_residues(rng, ctx.moduli, (m, nn)) for _ in range(2)) if carry else None
    want = j_karatsuba(
        *map(jnp.asarray, (ar, ai, br, bi)), moduli=ctx.moduli,
        carry=None if c is None else tuple(map(jnp.asarray, c)), interpret=True,
    )
    got = tk.karatsuba_fused.karatsuba_mod_gemm_batched(
        *tensors_from_numpy((ar, ai, br, bi), device="cpu"), moduli=ctx.moduli,
        carry=tensors_from_numpy(c, device="cpu"),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_dd", [False, True], ids=["f32", "dd"])
@pytest.mark.parametrize("n,stacked", [(14, True), (8, True), (16, False)], ids=["n14-s2", "n8-s2", "n16-2d"])
def test_crt_garner_matches_pallas(rng, out_dd, n, stacked):
    """With `out_dd` the low word exposes the fused multiply-add of the
    reference's crt_garner.py:89: an unfused sum differs in ~5% of it."""
    jc, tc = jmod.make_crt_context(n), tmod.make_crt_context(n)
    m, nn = 48, 200
    res = _residues(rng, jc.moduli, (m, nn))
    if stacked:
        res = np.stack([res, _residues(rng, jc.moduli, (m, nn))])
    e_mu = rng.integers(20, 70, size=m).astype(np.int32)
    e_nu = rng.integers(20, 70, size=nn).astype(np.int32)
    want = j_crt_garner(*map(jnp.asarray, (res, e_mu, e_nu)), jc, out_dd=out_dd, interpret=True)
    got = tk.crt_garner.crt_garner(*tensors_from_numpy((res, e_mu, e_nu), device="cpu"), tc, out_dd=out_dd)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_garner_fused_step_is_one_rounding():
    """`fma_f32` rounds once: for every weight of every context and every
    digit a Garner sum can hold, the float64 sum pe + w_lo * d is exact (its
    two_sum error is 0), so converting it to f32 is the only rounding —
    the bits of `__fmaf_rn` in the CUDA kernel and of XLA's contraction."""
    checked = 0
    for n in range(1, 22):
        ctx = jmod.make_crt_context(n)
        wt = j_weight_table(ctx)
        for t, p in enumerate(ctx.moduli):
            d = np.arange(-((p - 1) // 2), (p - 1) // 2 + 1, dtype=np.float32)
            _, pe = jex.two_prod(jnp.float32(wt[t, 0]), jnp.asarray(d))
            pe = np.asarray(pe).astype(np.float64)
            prod = np.float64(wt[t, 1]) * d.astype(np.float64)  # exact: 24 x 8 bits
            s = pe + prod
            bb = s - pe
            err = (pe - (s - bb)) + (prod - bb)
            assert not np.any(err), (n, t)
            fused = tk.crt_garner.fma_f32(wt[t, 1], torch.from_numpy(d), torch.from_numpy(pe.astype(np.float32)))
            np.testing.assert_array_equal(fused.numpy(), s.astype(np.float32))
            checked += d.size
    assert checked > 50_000


def test_cpu_wrappers_take_plain_version_and_count_nothing(rng):
    """On CPU tensors every wrapper runs its plain version: no launch."""
    ctx = tmod.make_crt_context(5)
    before = tk.launch_counts()
    x = torch.from_numpy(phi_matrix(rng, (8, 16), 0.5, np.float32))
    s1, s2 = split_scale_exponent(torch.full((8,), 30, dtype=torch.int32))
    a = tk.residue_cast.residue_cast(x, s1, s2, moduli=ctx.moduli, n_limbs=2)
    b = torch.from_numpy(_residues(rng, ctx.moduli, (16, 8)))
    e = tk.int8_mod_gemm.int8_mod_gemm_batched(a, b, moduli=ctx.moduli)
    tk.karatsuba_fused.karatsuba_mod_gemm_batched(a, a, b, b, moduli=ctx.moduli)
    tk.crt_garner.crt_garner(e, torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), ctx)
    assert tk.launch_counts() == before == {name: 0 for name in tk.WRAPPERS}


def test_wrappers_refuse_mixed_devices():
    ctx = tmod.make_crt_context(3)
    a = torch.zeros((3, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="devices"):
        tk.int8_mod_gemm.int8_mod_gemm_batched(a, a.to("meta"), moduli=ctx.moduli)
