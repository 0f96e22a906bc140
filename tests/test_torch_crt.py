"""Parity of the port's CRT core (`repro_torch.core.{expansion, moduli,
residues, crt}`) with `repro.core`, and exactness against Python integers.

The reference runs op by op (eager), as its own property tests call it:
under `jax.jit` XLA may contract its float64 expressions into fused
multiply-adds, which the port, like the eager reference, never does.
Tolerance: none (bitwise) unless a test states one; the reconstructions'
`hi + lo` is held to the reference's own error floors
(`tests/test_property.py`) against the exact CRT integer.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crt as j_crt
from repro.core import expansion as j_ex
from repro.core import moduli as j_moduli
from repro.core import residues as j_res
from repro_torch.core import crt as t_crt
from repro_torch.core import expansion as t_ex
from repro_torch.core import moduli as t_moduli
from repro_torch.core import residues as t_res
from repro_torch.core import scaling as t_scaling

RECON_N = (2, 8, 14, 16, 20)


def _same(got, want):
    """Bitwise equality of a torch result and a jax/numpy one (float
    outputs through their bytes, so the sign of a zero counts)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), (got, want)


def _wide_floats(rng, shape, dtype, span):
    """Signed floats of `dtype` with exponents spread over +-span."""
    m = rng.standard_normal(shape) * np.exp2(rng.integers(-span, span, shape))
    return m.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_expansion_bitwise(rng, dtype):
    span = 20 if dtype == np.float32 else 200
    a, b, c, d = (_wide_floats(rng, (257,), dtype, span) for _ in range(4))
    # quick_two_sum / dd_add assume |first| >= |second|
    big, small = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    ta, tb, tc, td, tbig, tsmall = map(torch.from_numpy, (a, b, c, d, big, small))
    ja, jb, jc, jd, jbig, jsmall = map(jnp.asarray, (a, b, c, d, big, small))
    cases = [
        (t_ex.two_sum(ta, tb), j_ex.two_sum(ja, jb)),
        (t_ex.quick_two_sum(tbig, tsmall), j_ex.quick_two_sum(jbig, jsmall)),
        (t_ex.two_prod(ta, tb), j_ex.two_prod(ja, jb)),
        (t_ex.dd_add(tbig, tsmall * 2.0**-30, tc, td * 2.0**-30),
         j_ex.dd_add(jbig, jsmall * 2.0**-30, jc, jd * 2.0**-30)),
        (t_ex.dd_add_fp(tbig, tsmall * 2.0**-30, tc), j_ex.dd_add_fp(jbig, jsmall * 2.0**-30, jc)),
        (t_ex.dd_mul_fp(tbig, tsmall * 2.0**-30, tc), j_ex.dd_mul_fp(jbig, jsmall * 2.0**-30, jc)),
        (t_ex.dd_neg(ta, tb), j_ex.dd_neg(ja, jb)),
        ((t_ex.dd_to_fp(tbig, tsmall),), (j_ex.dd_to_fp(jbig, jsmall),)),
    ]
    for got, want in cases:
        for g, w in zip(got, want):
            _same(g, w)
    # the error-free transforms are exact: checked against the rationals
    s, e = t_ex.two_prod(ta, tb)
    for x, y, hi, lo in list(zip(a, b, s.numpy(), e.numpy()))[:32]:
        from fractions import Fraction

        assert Fraction(float(x)) * Fraction(float(y)) == Fraction(float(hi)) + Fraction(float(lo))


_CTX_FIELDS = ("n", "moduli", "P", "log2_P", "w_hi", "w_lo", "w_dd_hi", "w_dd_lo", "P_exp",
               "garner_inv", "weights_dd", "moduli_arr", "half_arr", "p_half")


@pytest.mark.parametrize("moduli", [None, (253, 251, 247, 241, 239, 233, 229, 227), (7, 5, 3), (11,)],
                         ids=["default", "custom8", "custom3", "custom1"])
def test_crt_context_fields(moduli):
    ns = range(1, 22) if moduli is None else (len(moduli),)
    for n in ns:
        want = j_moduli.make_crt_context(n, moduli)
        got = t_moduli.make_crt_context(n, moduli if moduli is None else list(moduli))
        for field in _CTX_FIELDS:
            g, w = getattr(got, field), getattr(want, field)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (n, field)
            else:
                assert g == w and type(g) is type(w), (n, field)
    with pytest.raises(ValueError, match="159 bits"):
        t_moduli.make_crt_context(22)
    for bad, match in (((9, 3), "coprime"), ((4, 7), "odd"), ((257, 3), "odd"), ((5, 7), "len")):
        n = 3 if match == "len" else 2
        with pytest.raises(ValueError, match=match):
            t_moduli.make_crt_context(n, bad)


def test_min_moduli_for_bits():
    for bits in (0.5, 7.0, 30.0, 53.0, 100.0, 106.0, 150.0):
        assert t_moduli.min_moduli_for_bits(bits) == j_moduli.min_moduli_for_bits(bits)
    # past 21 moduli P needs a fourth float64 term: both refuse alike
    with pytest.raises(ValueError) as want:
        j_moduli.min_moduli_for_bits(1000.0)
    with pytest.raises(ValueError, match=str(want.value).replace(";", ".")):
        t_moduli.min_moduli_for_bits(1000.0)


def _sym(v: int, p: int) -> int:
    r = v % p
    return r - p if r > (p - 1) // 2 else r


def _limb_edge_values(n_limbs):
    """Integers at and around the base-2^24 limb edges that n_limbs hold."""
    vals = [0, 1, -1]
    for i in range(1, n_limbs):
        for off in (-1, 0, 1):
            vals += [(1 << (24 * i)) + off, -((1 << (24 * i)) + off)]
    top = (1 << (24 * n_limbs)) - 1
    # the largest magnitudes a float64 holds exactly near the top limb
    vals += [top >> max(0, top.bit_length() - 53) << max(0, top.bit_length() - 53)]
    vals += [-vals[-1]]
    return vals


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_split_limbs_and_residues_exact(rng, n_limbs):
    ints = _limb_edge_values(n_limbs)
    lim = 1 << (min(53, 24 * n_limbs) - 1)
    ints += [int(v) for v in rng.integers(-lim, lim, 24)]
    x = np.asarray([float(v) for v in ints], np.float64)
    ints = [int(v) for v in x]  # the values the float64 holds exactly
    ctx = t_moduli.make_crt_context(14)
    limbs = t_res.split_limbs(torch.from_numpy(x), n_limbs)
    _same(limbs, j_res.split_limbs(jnp.asarray(x), n_limbs))
    for j, v in enumerate(ints):
        assert sum(int(limbs[i, j]) << (24 * i) for i in range(n_limbs)) == v
        assert all(abs(int(limbs[i, j])) < (1 << 24) for i in range(n_limbs))
    res = t_res.residues_from_quantized(torch.from_numpy(x), ctx, n_limbs)
    _same(res, j_res.residues_from_quantized(jnp.asarray(x), j_moduli.make_crt_context(14), n_limbs))
    want = np.asarray([[_sym(v, p) for v in ints] for p in ctx.moduli], np.int8)
    np.testing.assert_array_equal(res.numpy(), want)
    assert np.array_equal(t_res._limb_radix_table(ctx, n_limbs),
                          j_res._limb_radix_table(j_moduli.make_crt_context(14), n_limbs))


def test_quantize_and_residues_bitwise(rng):
    a = rng.standard_normal((9, 13)) * 1e3
    e = rng.integers(-5, 30, 9).astype(np.int32)
    ctx_t, ctx_j = t_moduli.make_crt_context(16), j_moduli.make_crt_context(16)
    from repro.core import scaling as j_scaling

    tq, tr = t_res.residues(torch.from_numpy(a), t_scaling.exp2_vector(torch.from_numpy(e)), 0, ctx_t, 3)
    jq, jr = j_res.residues(jnp.asarray(a), j_scaling.exp2_vector(jnp.asarray(e)), 0, ctx_j, 3)
    _same(tq, jq)
    _same(tr, jr)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32], ids=["f64", "f32", "i32"])
def test_sym_mod_small_at_exact_halves(dtype):
    """round(v/p) at quotients that are exact halves: both packages round
    half to even (odd moduli on half-integers, even moduli on integers)."""
    cases = [(5.0, 2.0, np.arange(-25, 26) + 0.5), (4.0, 1.0, np.arange(-20, 21)),
             (255.0, 127.0, 255.0 * (np.arange(-8, 9) + 0.5)), (2.0, 0.0, np.arange(-9, 10))]
    for p, half, v in cases:
        if dtype == np.int32 and np.any(v != np.round(v)):
            continue
        v = v.astype(dtype)
        pv = int(p) if dtype == np.int32 else p
        hv = int(half) if dtype == np.int32 else half
        got = t_res.sym_mod_small(torch.from_numpy(v), pv, hv)
        want = j_res.sym_mod_small(jnp.asarray(v), pv, hv)
        _same(got, want)


def _planes_of(ints, ctx):
    return np.asarray([[_sym(v, p) for v in ints] for p in ctx.moduli], np.int8)


def _random_ints(rng, bound: int, count: int):
    """Uniform integers in [-bound, bound] from 64-bit draws."""
    words = -(-(2 * bound + 1).bit_length() // 63) + 1
    out = []
    for _ in range(count):
        r = 0
        for w in rng.integers(0, 1 << 63, words, dtype=np.int64):
            r = (r << 63) | int(w)
        out.append(r % (2 * bound + 1) - bound)
    return out


@pytest.mark.parametrize("n", RECON_N)
def test_reconstructors_bitwise_and_exact(rng, n):
    ctx_t, ctx_j = t_moduli.make_crt_context(n), j_moduli.make_crt_context(n)
    half = int(ctx_t.P * 0.49)
    ints = _random_ints(rng, half, 60) + [0, 1, -1, half, -half]
    exact = _planes_of(ints, ctx_t).reshape(n, 5, 13)
    # uniform planes reach every value up to (P-1)/2, the mod-P edges included
    uniform = np.stack([rng.integers(-(p // 2), p // 2 + 1, (5, 13)) for p in ctx_t.moduli]).astype(np.int8)
    tols = {"garner": 2.0**-100, "dd": 2.0**-93, "paper": 2.0**-78}
    for method in ("paper", "dd", "garner"):
        for planes in (exact, uniform):
            hi, lo = t_crt.reconstruct(torch.from_numpy(planes), ctx_t, method)
            jhi, jlo = j_crt.reconstruct(jnp.asarray(planes), ctx_j, method)
            _same(hi, jhi)
            _same(lo, jlo)
        hi, lo = t_crt.reconstruct(torch.from_numpy(exact), ctx_t, method)
        got = (hi + lo).reshape(-1).tolist()
        for x, g in zip(ints, got):
            tol = max(abs(x) * 2.0**-90, float(ctx_t.P) * tols[method], 1e-9)
            assert abs(g - float(x)) <= tol, (method, n, x, g)
    _same(t_crt.garner_digits(torch.from_numpy(uniform), ctx_t),
          j_crt.garner_digits(jnp.asarray(uniform), ctx_j))
    with pytest.raises(ValueError, match="unknown reconstruction"):
        t_crt.reconstruct(torch.from_numpy(exact), ctx_t, "exact")


def test_inverse_scale_exponent_extremes(rng):
    """The factor 2^-(e_mu + e_nu) at and past both ends of float64's
    exponent range: exact in [-1022, 1023], +0.0 below (the reference's
    XLA CPU flushes the subnormal powers), +inf above."""
    sums = np.asarray([-2000, -1100, -1075, -1074, -1030, -1024, -1023, -1022, -1021, -600, -1, 0, 1,
                       600, 1021, 1022, 1023, 1024, 1025, 1100, 2000], np.int64)
    e_mu = np.asarray([0, 3], np.int32)
    e_nu = (-sums).astype(np.int32)  # -(e_mu + e_nu) = sums (+ -3 on row 1)
    # integer-valued hi/lo, as every reconstruction returns
    hi = np.round(rng.standard_normal((2, sums.size)) * 2.0**60)
    hi[:, :3] = 0.0
    lo = np.round(rng.standard_normal((2, sums.size)) * 2.0**6)
    for out in (torch.float64, torch.float32):
        got = t_crt.inverse_scale(torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(e_mu),
                                  torch.from_numpy(e_nu), out)
        want = j_crt.inverse_scale(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(e_mu),
                                   jnp.asarray(e_nu), jnp.float64 if out == torch.float64 else jnp.float32)
        g, w = got.numpy(), np.asarray(want)
        # float32 values below 2^-126 are subnormal, which XLA's CPU flushes
        keep = ~((np.abs(g) < 2.0**-126) & (g != 0)) if out == torch.float32 else np.ones(g.shape, bool)
        assert keep.sum() > g.size // 2
        assert g[keep].tobytes() == w[keep].tobytes(), (out, g, w)
    for k in sums.tolist():
        want = math.ldexp(1.0, int(k)) if -1022 <= k <= 1023 else (0.0 if k < 0 else math.inf)
        assert t_scaling.exp2_vector(torch.tensor([k])).item() == want


@pytest.mark.parametrize("n", [2, 8, 16, 20])
def test_partial_reconstruction_round_trip(rng, n):
    ctx_t, ctx_j = t_moduli.make_crt_context(n), j_moduli.make_crt_context(n)
    u, radix, part_bits = t_crt.partial_split(ctx_t.moduli)
    ju, jradix, jbits = j_crt.partial_split(ctx_j.moduli)
    assert part_bits == jbits and u.tobytes() == np.asarray(ju).tobytes()
    assert np.array_equal(radix, jradix)
    planes = np.stack([rng.integers(-(p // 2), p // 2 + 1, (2, 7, 5)) for p in ctx_t.moduli], axis=1)
    planes = planes.astype(np.int8)  # (2, N, 7, 5): a leading batch dim
    t_parts = t_crt.partial_combine(torch.from_numpy(planes), u)
    _same(t_parts, j_crt.partial_combine(jnp.asarray(planes), jnp.asarray(ju)))
    # two shards' partials summed == the whole; then the planes come back
    cut = n // 2
    sharded = (t_crt.partial_combine(torch.from_numpy(planes[:, :cut]), u[:, :cut])
               + t_crt.partial_combine(torch.from_numpy(planes[:, cut:]), u[:, cut:]))
    _same(sharded, t_parts)
    for b in range(2):
        back = t_crt.residues_from_partial(t_parts[b], ctx_t)
        np.testing.assert_array_equal(back.numpy(), planes[b])
        _same(back, j_crt.residues_from_partial(jnp.asarray(t_parts[b].numpy()), ctx_j))
