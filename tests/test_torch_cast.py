"""The division-free residue cast of the residue-cast kernel and the
megakernels (`src/repro_torch/kernels/csrc/residue_fma.cuh`), modelled op by
op in numpy, and the launch-timing copy's wrapper.

The model rounds where the card rounds: each f32 multiply and add in
float32 (numpy's float32 arithmetic is IEEE round-to-nearest-even, as the
card's under `-fmad=false`); each `__fmaf_rn` through float64, where every
product and sum of these integers is exact, and the test asserts that the
fma's one rounding to f32 changes nothing.  It is held against exact
integer residues: no tolerance.  The CUDA kernel itself runs only on the
card, where `chip_smoke.py` holds it bitwise against its plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.moduli import default_moduli, make_crt_context
from repro_torch.kernels import build
from repro_torch.kernels import launch_copy as lc
from repro_torch.kernels.common import limb_radix_f32, residue_tiles_f32
from repro_torch.kernels.residue_cast import residue_cast, residue_cast_plain

F32 = np.float32
SHIFT = F32(12582912.0)  # 1.5 * 2^23, the kernel's rint shifter
LIMB = 1 << 24
MODULI = make_crt_context(21).moduli


def fma_exact(a, b, c):
    """__fmaf_rn(a, b, c) for f32 integers whose a*b + c is an integer
    below 2^24: exact through float64, and so after the one rounding."""
    r64 = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    r = r64.astype(F32)
    assert np.array_equal(r.astype(np.float64), r64), "the fma would round"
    return r


def reduce_fma(v, p):
    """residue_fma.cuh's reduce_fma: v - rint(v * (1/p)) p.  The kernel's
    q = fma(v, 1/p, 1.5 * 2^23) - 1.5 * 2^23 rounds once, where the f32
    spacing is 1: it is the integer nearest the exact product v * f32(1/p),
    ties to even, which float64 holds exactly (24 + 25 bits) and np.rint
    rounds the same way."""
    pf, recip = F32(p), F32(1.0 / p)
    prod = v.astype(np.float64) * np.float64(recip)  # exact
    assert np.abs(prod).max() < 2.0**22, "the fma's sum stays in (2^23, 2^24)"
    q = np.rint(prod).astype(F32)
    return fma_exact(-q, np.full_like(v, pf), v)


def sym_mod(x, p):
    """Exact canonical symmetric residues of int64 (or Python int) values."""
    r = x % p
    return np.where(r > (p - 1) // 2, r - p, r)


def limbs_near_multiples(p):
    """Every L within +/-2 of a multiple of p in [-2^24, 2^24], the +/-2^24
    edges, and 10^6 random limbs below 2^24 in magnitude."""
    mult = np.arange(-(LIMB // p) - 1, LIMB // p + 2, dtype=np.int64) * p
    near = (mult[:, None] + np.arange(-2, 3)[None, :]).ravel()
    edges = np.array([s * (LIMB - d) for s in (1, -1) for d in range(4)], dtype=np.int64)
    rand = np.random.default_rng(p).integers(-(LIMB - 1), LIMB, 10**6)
    values = np.concatenate([near, edges, rand])
    return values[np.abs(values) <= LIMB]


@pytest.mark.parametrize("p", MODULI)
def test_division_free_residue_steps_are_exact(p):
    """One case for each modulus of make_crt_context(21):
    - a limb's residue L - rint(L/p) p is congruent to L and below
      p + (p-1)/2 in magnitude (so a sum over 5 limbs stays below 2^18);
    - the final reduce is the canonical residue for every |acc| <= 2^18;
    - the sum of two canonical residues reduces to the canonical residue."""
    half = (p - 1) // 2
    limbs = limbs_near_multiples(p)
    r = reduce_fma(limbs.astype(F32), p).astype(np.int64)
    assert np.array_equal(sym_mod(r - limbs, p), np.zeros_like(r))
    assert int(np.abs(r).max()) <= p + half
    assert 5 * (p + half) * half < 1 << 18

    acc = np.arange(-(1 << 18), (1 << 18) + 1, dtype=np.int64)
    got = reduce_fma(acc.astype(F32), p).astype(np.int64)
    assert np.array_equal(got, sym_mod(acc, p))

    res = np.arange(-half, half + 1, dtype=np.int64)
    x, y = np.meshgrid(res, res)
    got = reduce_fma(x.ravel().astype(F32) + y.ravel().astype(F32), p).astype(np.int64)
    assert np.array_equal(got, sym_mod(x.ravel() + y.ravel(), p))


def residue_fma(a, scale, n_limbs, p, radix):
    """residue_fma.cuh's residue_fma: trunc(a * scale), the base-2^24 peel
    (fma for the remainder), a division-free residue a limb, the radix sum
    by fma and one final reduce."""
    rem = np.trunc(a * scale)
    acc = np.zeros_like(rem)
    for i in range(n_limbs - 1, 0, -1):
        hi = np.trunc(rem * F32(2.0 ** (-24 * i)))
        rem64 = rem.astype(np.float64) - hi.astype(np.float64) * 2.0 ** (24 * i)
        assert np.array_equal(rem64.astype(F32).astype(np.float64), rem64)
        rem = rem64.astype(F32)
        acc = fma_exact(reduce_fma(hi, p), np.full_like(hi, radix[i]), acc)
    acc = fma_exact(reduce_fma(rem, p), np.full_like(rem, radix[0]), acc)
    return reduce_fma(acc, p)


@pytest.mark.parametrize("n_mod", [7, 14, 21])
def test_division_free_cast_matches_exact_and_plain(n_mod):
    """The whole cast at each NMAX bucket's N (2, 3 and 4 limbs) against the
    exact integer residue of trunc(a * scale) and against the port's plain
    `residue_tiles_f32`, which the card holds the kernel to."""
    from repro_torch.core.plan import n_limbs_for_ctx

    ctx = make_crt_context(n_mod)
    nl = n_limbs_for_ctx(ctx)
    rng = np.random.default_rng(n_mod)
    a = ((rng.random((64, 256)) - 0.5) * 2.0 ** rng.integers(-20, 20, (64, 256))).astype(F32)
    a[0, :8] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0**-30, -(2.0**-30)]
    # per-row power-of-two scales up to the largest |trunc(a * scale)| the limbs hold
    top = 24 * nl - 1
    e = top - np.ceil(np.log2(np.abs(a).max(1) + 1e-30)).astype(np.int64) - rng.integers(0, 3, 64)
    e1 = e // 2
    s1, s2 = (2.0 ** e1).astype(F32), (2.0 ** (e - e1)).astype(F32)
    scale = (s1 * s2)[:, None]
    x = np.trunc(a * scale)
    assert np.abs(x).max() < 2.0**top
    exact = np.vectorize(int, otypes=[object])(x.astype(np.float64))
    radix = limb_radix_f32(ctx.moduli, nl)
    plain = residue_tiles_f32(torch.from_numpy(a), torch.from_numpy(s1), torch.from_numpy(s2),
                              moduli=ctx.moduli, n_limbs=nl, scale_axis=0)
    for l, p in enumerate(ctx.moduli):
        got = residue_fma(a, scale.astype(F32), nl, p, radix[:, l])
        want = sym_mod(exact, p).astype(np.int64)
        assert np.array_equal(got.astype(np.int64), want), p
        assert np.array_equal(got, plain[l].numpy()), p


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4, 5])
def test_residue_cast_route_for_every_modulus(n_limbs):
    """The residue-cast kernel's route (`residue_fma`, a plane at a time)
    for each of the 24 default moduli
    (`default_moduli(24)`: make_crt_context refuses N = 24, P passing 159
    bits, but the cast takes any of them) at n_limbs 1-5, on values up to
    the largest |trunc(a * scale)| the limbs hold, row and column scales:
    the exact integer residues, and the plain version's (the wrapper's CPU
    path, which the card holds the kernel to), bitwise."""
    moduli = default_moduli(24)
    assert all(5 <= p <= 255 and p % 2 for p in moduli)  # the route's precondition, which the C entry checks
    rng = np.random.default_rng(100 + n_limbs)
    a = ((rng.random((16, 96)) - 0.5) * 2.0 ** rng.integers(-20, 20, (16, 96))).astype(F32)
    a[0, :6] = [0.0, -0.0, 1.0, -1.0, 0.5, -(2.0**-30)]
    top = 24 * n_limbs - 1
    radix = limb_radix_f32(moduli, n_limbs)
    for axis in (0, 1):
        mags = np.abs(a).max(1 - axis)
        e = top - np.ceil(np.log2(mags + 1e-30)).astype(np.int64) - rng.integers(0, 3, mags.shape)
        e1 = e // 2
        s1, s2 = (2.0 ** e1).astype(F32), (2.0 ** (e - e1)).astype(F32)
        scale = (s1 * s2)[:, None] if axis == 0 else (s1 * s2)[None, :]
        x = np.trunc(a * scale)
        assert np.abs(x).max() < 2.0**top
        exact = np.vectorize(int, otypes=[object])(x.astype(np.float64))
        plain = residue_cast_plain(torch.from_numpy(a)[None], torch.from_numpy(s1), torch.from_numpy(s2),
                                   moduli=moduli, n_limbs=n_limbs, scale_axis=axis)[0]
        wrapper = residue_cast(torch.from_numpy(a), torch.from_numpy(s1), torch.from_numpy(s2),
                               moduli=moduli, n_limbs=n_limbs, scale_axis=axis)
        assert torch.equal(wrapper, plain)
        for l, p in enumerate(moduli):
            got = residue_fma(a, scale.astype(F32), n_limbs, p, radix[:, l])
            assert np.array_equal(got.astype(np.int64), sym_mod(exact, p).astype(np.int64)), (p, axis)
            assert np.array_equal(got.astype(np.int8), plain[l].numpy()), (p, axis)


def test_residue_byte_is_the_twos_complement_byte():
    """residue_byte: the low byte of the bits of r + 1.5 * 2^23 is int8(r)."""
    r = np.arange(-127, 128, dtype=F32)
    low = ((r + SHIFT).view(np.uint32) & 0xFF).astype(np.uint8)
    assert np.array_equal(low.view(np.int8), r.astype(np.int8))


def test_every_header_is_hashed_into_the_build():
    """Each .cuh beside the kernel sources is in build.HEADERS, so an edit
    to it rebuilds every library (a stale build would survive otherwise)."""
    found = sorted(path.name for path in build.CSRC.glob("*.cuh"))
    assert sorted(build.HEADERS) == found
    assert all((build.CSRC / f"{name}.cu").exists() for name in build.SOURCES)


@pytest.mark.parametrize("size", [1, 3, 1023, 1024, 4097])
def test_launch_copy_odd_sizes_and_offset_views(size):
    """The copy at sizes off the kernel's 4-value groups, and on a view
    whose data starts 4 bytes into its storage (the kernel's misaligned
    path), on the CPU: the plain version, a copy, and no launch."""
    buf = torch.from_numpy(np.random.default_rng(size).standard_normal(size + 1).astype(F32))
    before = lc.launch_copy.launches
    for x in (buf[:size], buf[1:]):
        y = lc.launch_copy(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr() and y.shape == (size,)
    assert buf[1:].data_ptr() - buf.data_ptr() == 4
    assert lc.launch_copy.launches == before
