"""The route of the Garner kernel (`csrc/crt_garner.cu`), modelled on the
CPU from its source and held bit for bit against the plain version.

The kernel takes the Garner digits by the mixed-radix form, one reduction a
digit, with the magic-sum rounding instead of rintf and the bits of a byte
instead of an int-to-float conversion; its double-single sum takes two
shortcuts (the host's split of each weight, and split(d) = (d, +0)).  Each
step is modelled in numpy f32 (an FMA in float64, asserted exact, then one
rounding to f32) and compared through int32 views, so a zero's sign counts:

* the digits against `garner_digits` (the reference's recursion) for every
  N of `make_crt_context(1..21)`, on random and extreme residue tuples;
* every shortcut exhaustively: the rounding over every integer a reduction
  can reach for every odd modulus 3..255, the byte conversion over every
  byte, and the product terms over every (weight, digit) pair of every
  weight table;
* a whole element (digits, sum, scaling) against `crt_garner_plain`.

Constants and op lines are read from the source.  CPU only; tolerance: none.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import expansion as ex
from repro_torch.core.moduli import make_crt_context
from repro_torch.kernels.common import sym_mod_f32
from repro_torch.kernels.crt_garner import (
    _inverse_scales, _weight_table, crt_garner_plain, fma_f32, garner_digits, route_tables,
)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SOURCE = CSRC / "crt_garner.cu"
TILE = CSRC / "garner_tile.cuh"  # the megakernels' digits and `garner_reduce`
MAX_MODULI = 24
CONTEXTS = range(1, 22)  # every N make_crt_context gives
REACH = MAX_MODULI * 127 * 128  # |sum_u coef[u, t] y_u|: 24 terms, |coef| <= 127, |y| <= 128


def code() -> str:
    text = SOURCE.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def constant(path: pathlib.Path, name: str) -> np.float32:
    m = re.search(rf"constexpr float {name} = ([0-9.]+)f;", path.read_text())
    assert m, name
    return np.float32(m.group(1))


MAGIC, BYTE_BIAS = constant(TILE, "GARNER_MAGIC"), constant(SOURCE, "BYTE_BIAS")


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def fma(a, b, c) -> np.ndarray:
    """a * b + c with one rounding, for f32 operands whose exact result
    float64 holds: the product of two f32 is exact there, the sum is
    checked exact (its two_sum error is 0), and the one rounding is the
    conversion to f32."""
    a, b, c = (np.asarray(x, dtype=np.float32).astype(np.float64) for x in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    assert not np.any((prod - (s - bb)) + (c - bb)), "the float64 sum rounded"
    return s.astype(np.float32)


def byte_perm(x: np.ndarray, y: int, selector: int) -> np.ndarray:
    """CUDA's __byte_perm: byte k of the result is byte (selector >> 4k) & 7
    of the 8-byte value y:x."""
    xy = (np.uint64(y) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for k in range(4):
        sel = np.uint64((selector >> (4 * k)) & 7)
        out |= ((xy >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def byte_values(b: np.ndarray) -> list[np.ndarray]:
    """`byte_value` of each byte of words of 4 int8 (b: (..., 4)) as the
    kernel computes it: the word ^ 0x80808080, byte i placed under the
    exponent bits 0x4B by __byte_perm, the bias subtracted."""
    word = b.astype(np.uint8).view(np.uint32)[..., 0] ^ np.uint32(0x80808080)
    return [(byte_perm(word, 0x4B000000, 0x7440 + i).view(np.float32) - BYTE_BIAS).astype(np.float32)
            for i in range(4)]


def reduce(v: np.ndarray, p: int) -> np.ndarray:
    """`garner_reduce`: q = (v recip + MAGIC) - MAGIC, each op rounded in
    f32; then fma(-q, p, v)."""
    recip = np.float32(1.0 / p)  # make_garner_params's static_cast<float>(1.0 / moduli[t])
    q = (v * recip + MAGIC) - MAGIC
    return fma(-q, np.float32(p), v)


def route_digits(x: list[np.ndarray], ctx) -> list[np.ndarray]:
    """The kernel's digits of N f32 residue arrays: d_0 = x_0, then one
    sum of fmas from +0 and one reduction a digit."""
    coef, _ = route_tables(ctx)
    d = [x[0]]
    for t in range(1, ctx.n):
        acc = fma(coef[t, t], x[t], np.float32(0.0))
        for u in range(t):
            acc = fma(coef[u, t], d[u], acc)
        d.append(reduce(acc, ctx.moduli[t]))
    return d


def weights(ctx) -> np.ndarray:
    """(N, 4) f32: w_hi, w_lo (`_weight_table`) and split(w_hi)'s (ah, al)
    (`route_tables`), the kernel's weight operands."""
    return np.concatenate([_weight_table(ctx), route_tables(ctx)[1]], axis=1)


def product_terms(w: np.ndarray, t: int, d: np.ndarray):
    """(ph, pe) of digit d at weight t by the kernel's shortcuts."""
    w_hi, w_lo, ah, al = w[t]
    ph = (w_hi * d).astype(np.float32)
    pe = fma(ah, d, -ph)
    pe = fma(al, d, pe)
    return ph, fma(w_lo, d, pe)


def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def route_value(d: list[np.ndarray], ctx):
    """The double-single value of the kernel's digits, `dd_add` in f32."""
    w = weights(ctx)
    hi = np.zeros_like(d[0])
    lo = np.zeros_like(d[0])
    for t in range(ctx.n - 1, -1, -1):
        ph, pe = product_terms(w, t, d[t])
        sh, se = two_sum(hi, ph)
        te = (lo + pe) + se
        hi = sh + te
        lo = te - (hi - sh)
    return hi, lo


def residue_tuples(rng, ctx, count):
    """(N, count) int8: canonical residues at random, the extremes +-(p-1)/2
    and 0 in random combination, all at +half, all at -half, and bytes
    over the whole int8 range (no canonical input needed: the digits are
    unique for any)."""
    half = np.asarray([(p - 1) // 2 for p in ctx.moduli])[:, None]
    canonical = rng.integers(-half, half + 1, (ctx.n, count))
    extremes = rng.integers(-1, 2, (ctx.n, count)) * half
    whole = rng.integers(-128, 128, (ctx.n, count))
    return np.concatenate([canonical, extremes, half, -half, whole], axis=1).astype(np.int8)


@pytest.mark.parametrize("n_mod", CONTEXTS)
def test_route_digits_are_garner_digits(n_mod):
    ctx = make_crt_context(n_mod)
    x = residue_tuples(np.random.default_rng(n_mod), ctx, 20_000)
    planes = [x[t].astype(np.float32) for t in range(ctx.n)]
    want = garner_digits([torch.from_numpy(p) for p in planes], ctx)
    got = route_digits(planes, ctx)
    for t in range(ctx.n):
        np.testing.assert_array_equal(bits(got[t]), bits(want[t].numpy()), err_msg=f"N={n_mod} digit {t}")


@pytest.mark.parametrize("n_mod", CONTEXTS)
def test_route_tables_are_the_mixed_radix_form(n_mod):
    """coef[t, t] M_t = 1 and coef[u, t] = -coef[t, t] M_u mod p_t, all
    symmetric, none above the diagonal; every digit's sum stays within
    REACH (< 2^22, where the magic rounding is exact).  The split of each
    weight's high word is exact: ah + al = w_hi, ah within 12 bits."""
    ctx = make_crt_context(n_mod)
    coef, split = route_tables(ctx)
    assert coef.dtype == np.int32
    p = ctx.moduli
    for t in range(ctx.n):
        radix = [int(np.prod(p[:u], dtype=object)) for u in range(t + 1)]
        assert (int(coef[t, t]) * radix[t] - 1) % p[t] == 0
        for u in range(t):
            assert (int(coef[u, t]) + int(coef[t, t]) * radix[u]) % p[t] == 0
        assert np.all(np.abs(coef[: t + 1, t]) <= (p[t] - 1) // 2)
        assert not coef[t + 1:, t].any()
        assert 128 * np.abs(coef[: t + 1, t]).sum() <= REACH
    assert REACH < 2**22
    hi = _weight_table(ctx)[:, 0]
    np.testing.assert_array_equal(split[:, 0].astype(np.float64) + split[:, 1], hi.astype(np.float64))
    mant, _ = np.frexp(split[:, 0].astype(np.float64))
    assert np.all(mant * 2**12 == np.round(mant * 2**12))


def test_rounding_is_rint_for_every_reachable_integer():
    """`garner_reduce` against the port's sym_mod_f32 for every integer |v| <=
    REACH and every odd modulus 3..255 (the C entry's range), int32 views:
    the magic sum's quotient is exact, so no correction is needed, and no
    result is -0."""
    v = np.arange(-REACH, REACH + 1, dtype=np.float32)
    vt = torch.from_numpy(v)
    for p in range(3, 256, 2):
        got = reduce(v, p)
        want = sym_mod_f32(vt, float(p), float((p - 1) // 2)).numpy()
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"p={p}")


def test_byte_value_is_the_int8_value_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int8).reshape(-1, 4)
    got = np.stack(byte_values(b), axis=1)
    np.testing.assert_array_equal(bits(got), bits(b.astype(np.float32)))
    assert not np.signbit(got[b == 0]).any()


@pytest.mark.parametrize("n_mod", CONTEXTS)
def test_product_shortcuts_give_the_reference_bits(n_mod):
    """For every weight of the N-moduli table and every digit -128..127:
    the kernel's (ph, pe) (host split, split(d) = (d, +0), three fmas)
    equal the reference's two_prod and fused w_lo d, int32 views."""
    ctx = make_crt_context(n_mod)
    w = weights(ctx)
    wt = _weight_table(ctx)
    d = np.arange(-128, 128, dtype=np.float32)
    dt = torch.from_numpy(d)
    for t in range(ctx.n):
        ph, pe = ex.two_prod(torch.tensor(wt[t, 0]), dt)
        pe = fma_f32(wt[t, 1], dt, pe)
        got = product_terms(w, t, d)
        np.testing.assert_array_equal(bits(got[0]), bits(ph.numpy()), err_msg=f"N={n_mod} t={t} ph")
        np.testing.assert_array_equal(bits(got[1]), bits(pe.numpy()), err_msg=f"N={n_mod} t={t} pe")


@pytest.mark.parametrize("out_dd", [False, True], ids=["f32", "dd"])
@pytest.mark.parametrize("n_mod", [1, 2, 8, 14, 21])
def test_route_element_is_the_plain_version(n_mod, out_dd):
    """A whole element as the kernel computes it (bytes, digits, sum, the
    inverse scaling) against crt_garner_plain, int32 views."""
    ctx = make_crt_context(n_mod)
    rng = np.random.default_rng(100 + n_mod)
    x = residue_tuples(rng, ctx, 2_000)
    cols = x.shape[1] // 4 * 4  # whole 4-byte words
    x = x[:, :cols]
    x4 = x.reshape(ctx.n, cols // 4, 4)
    planes = [np.stack(byte_values(x4[t]), axis=1).reshape(-1) for t in range(ctx.n)]
    e_mu = torch.from_numpy(rng.integers(20, 70, 1).astype(np.int32))
    e_nu = torch.from_numpy(rng.integers(20, 70, cols).astype(np.int32))
    want = crt_garner_plain(torch.from_numpy(x)[None, :, None, :], e_mu, e_nu, ctx, out_dd=out_dd)[0]
    r1, r2, c1, c2 = (t.numpy() for t in _inverse_scales(e_mu, e_nu, ctx))
    rr, cc = r1 * r2, c1 * c2
    hi, lo = route_value(route_digits(planes, ctx), ctx)
    if out_dd:
        got = np.stack([(hi * rr) * cc, (lo * rr) * cc])[:, None, :]
    else:
        got = (((hi + lo) * rr) * cc)[None, :]
    np.testing.assert_array_equal(bits(got), bits(want.numpy()))


def test_route_is_the_sources():
    """The op lines the models above follow, read from garner_tile.cuh
    (`garner_reduce`, `garner_digits`, `garner_sum`, which the Garner
    kernel runs four elements at a time and the megakernels' `garner_value`
    one at a time) and from crt_garner.cu (the bytes, the calls); neither
    the kernel nor the shared route divides or has rintf or an int-to-float
    cast, and the route no symmetric mod of the reference's recursion."""
    tile = TILE.read_text()
    for line in (
        "const float q = __fsub_rn(__fadd_rn(__fmul_rn(v, recip), GARNER_MAGIC), GARNER_MAGIC);",
        "return __fmaf_rn(-q, p, v);",
        "float acc = __fmaf_rn(prm.coef[t][t], d[t][e], 0.0f);",
        "for (int u = 0; u < t; ++u) acc = __fmaf_rn(prm.coef[u][t], d[u][e], acc);",
        "d[t][e] = garner_reduce(acc, prm.p[t], prm.recip[t]);",
        "prm.recip[t] = static_cast<float>(1.0 / moduli[t]);",
        "for (int u = 0; u < n_mod; ++u) prm.coef[u][t] = static_cast<float>(coef[u * n_mod + t]);",
        "pr.hi = __fmul_rn(prm.w_hi[t], dt);",
        "pr.lo = __fmaf_rn(prm.w_ah[t], dt, -pr.hi);",
        "pr.lo = __fmaf_rn(prm.w_al[t], dt, pr.lo);",
        "pr.lo = __fmaf_rn(prm.w_lo[t], dt, pr.lo);",
        "v[e] = dd_add(v[e], pr);",
        "for (int t = NMAX - 1; t >= 0; --t) {",
        "prm.w_ah[t] = split[2 * t];",
        "prm.w_al[t] = split[2 * t + 1];",
        "garner_digits<NMAX, 1>(x, prm);",
        "garner_sum<NMAX, 1>(x, prm, v);",
    ):
        assert line in tile, line
    route = tile[tile.index("__device__ __forceinline__ float garner_reduce("):]
    for banned in ("/", "%", "rintf", "static_cast<float>", "(float)", "__int2float", "__i2f", "sym_mod_f32"):
        assert banned not in re.sub(r"//[^\n]*", "", route), banned
    src = SOURCE.read_text()
    for line in (
        "return __fsub_rn(__int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)), BYTE_BIAS);",
        "if (t < N) next[t] = load_word(planes + t * mn + static_cast<size_t>(i) * n, n - j0, VEC);",
        "const uint32_t w = next[t] ^ 0x80808080u;",
        "garner_digits<NMAX, 4>(d, g);",
        "garner_sum<NMAX, 4>(d, g, v);",
        "if (!make_garner_params(prm, n_mod, moduli, coef, weights, split) ||",
    ):
        assert line in src, line
    assert MAGIC == np.float32(1.5 * 2**23) and BYTE_BIAS == np.float32(2**23 + 128)
    kernel = code()
    start = kernel.index("{", kernel.index("crt_garner_kernel("))
    depth, end = 0, start
    for end in range(start, len(kernel)):
        depth += {"{": 1, "}": -1}.get(kernel[end], 0)
        if depth == 0:
            break
    body = kernel[start:end + 1]
    for banned in ("/", "%", "rintf", "static_cast<float>", "(float)", "__int2float", "__i2f", "sym_mod_f32"):
        assert banned not in body, banned
