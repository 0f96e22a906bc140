"""The exactness argument of the e4m3 kernels (`csrc/fp8_karatsuba.cu`, the
Karatsuba one, and `csrc/fp8_mod_gemm.cu`, the real one), modelled in exact
integers.

The kernel forms each residue product from balanced base-16 digits, r = 16 hi
+ lo, and sums the digit products on wgmma in chains, each from zero: HH
(hi.hi) and LL (lo.lo) over HH_CHAIN_K32 / LL_CHAIN_K32 consecutive k32
steps, X over X_CHAIN_K32 steps of hi.lo then lo.hi.  Hopper's fp8 tensor-core
sum keeps only about 14 bits (arXiv:2412.19437, 3.3.2), so no chain may sum
past 2^12; each chain's value is added with an FADD to one of three f32
accumulators a product (HH, X, LL), which must stay below 2^24 to be exact.
The epilogue takes each accumulator's symmetric mod, forms m8 m(HH) + m4 m(X)
+ m(LL) mod p, and combines CR = D - E, CI = F - D - E (+ carry).

The real kernel runs the same chains on one product and its epilogue forms
m8 m(HH) + m4 m(X) + m(LL) (+ carry) mod p.

Here the chain lengths are read from each kernel's source, the schedule is
run in numpy int64 at k = FP8_K_CHUNK_LIMIT on the accumulation worst cases,
and the modelled epilogue is held bitwise against `karatsuba_mod_gemm_plain`
(Karatsuba) and against `fp8_mod_gemm_plain` and `int8_mod_gemm_plain`
(real).  CPU only; tolerance: none.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.moduli import make_crt_context
from repro_torch.kernels.fp8_mod_gemm import FP8_K_CHUNK_LIMIT, fp8_mod_gemm_plain
from repro_torch.kernels.int8_mod_gemm import int8_mod_gemm_plain
from repro_torch.kernels.karatsuba_fused import karatsuba_mod_gemm_plain

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/fp8_karatsuba.cu"
#: the two e4m3 kernels' sources, by name
SOURCES = {"fp8_karatsuba": SOURCE, "fp8_mod_gemm": SOURCE.with_name("fp8_mod_gemm.cu")}
CHAIN_LIMIT = 1 << 12  # the most a chain may sum (the fp8 accumulation rule)
F32_EXACT = 1 << 24    # f32 integers are exact below this


def chain_lengths(source: pathlib.Path = SOURCE) -> dict[str, int]:
    """{"HH", "LL", "X"}: k32 steps a chain sums over, from the kernel's constants."""
    src = source.read_text()
    out = {}
    for name in ("HH", "LL", "X"):
        m = re.search(rf"constexpr int {name}_CHAIN_K32 = (\d+);", src)
        assert m, f"{name}_CHAIN_K32 not found in {source.name}"
        out[name] = int(m.group(1))
    return out


def kernel_bks(source: pathlib.Path = SOURCE) -> list[int]:
    """The BK of each tile the kernel compiles (its REPRO_TILE lines)."""
    found = re.findall(r"^\s*REPRO_TILE\((\d+), (\d+), (\d+), (\d+)\)", source.read_text(), re.M)
    return [int(t[2]) for t in found]


def digits(r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's digits: hi = round(r / 16), half to even; lo = r - 16 hi."""
    hi = np.rint(r / 16.0).astype(np.int64)
    return hi, r.astype(np.int64) - 16 * hi


def sym_mod(v, p):
    """The canonical symmetric residue in [-(p-1)/2, (p-1)/2] (exact integers)."""
    r = np.mod(v, p)
    return np.where(r > (p - 1) // 2, r - p, r)


def sum_mod_small(x, y, p):
    """The kernel's (x + y) mod p of two int8 residues: two corrections each
    way, as common.cuh's sym_mod_small (and the f16x2 split) order them."""
    v = x.astype(np.int64) + y
    half = (p - 1) // 2
    for _ in range(2):
        v = np.where(v > half, v - p, v)
    for _ in range(2):
        v = np.where(v < -half, v + p, v)
    return v


def run_chains(a, b, lengths):
    """One plane's digit products as the kernel sums them.

    a: (m, k), b: (k, n) integer residues.  Returns the three accumulators
    {"HH", "X", "LL"} (int64 (m, n)) and the bounds the rule needs: the
    largest sum of |digit products| over any chain (a bound on every partial
    sum of that chain, in any order) and the largest sum of |chain values|
    into any accumulator (a bound on every partial sum of the FADDs)."""
    m, k = a.shape
    k32 = -(-k // 32)
    pad = k32 * 32 - k
    ah, al = (np.pad(d, ((0, 0), (0, pad))).reshape(m, k32, 32) for d in digits(a))
    bh, bl = (np.pad(d, ((0, pad), (0, 0))).reshape(k32, 32, -1) for d in digits(b))

    def step_products(x, y):  # (k32, m, n): each k32 step's exact digit product
        return np.einsum("msk,skn->smn", x, y), np.einsum("msk,skn->smn", np.abs(x), np.abs(y))

    terms = {"HH": [(ah, bh)], "LL": [(al, bl)], "X": [(ah, bl), (al, bh)]}
    acc, chain_bound, acc_bound = {}, 0, 0
    for name, pairs in terms.items():
        val = sum(step_products(x, y)[0] for x, y in pairs)
        mag = sum(step_products(x, y)[1] for x, y in pairs)
        g = lengths[name]
        steps = -(-k32 // g) * g  # whole chains (zero steps past k)
        val = np.pad(val, ((0, steps - k32), (0, 0), (0, 0))).reshape(steps // g, g, *val.shape[1:]).sum(1)
        mag = np.pad(mag, ((0, steps - k32), (0, 0), (0, 0))).reshape(steps // g, g, *mag.shape[1:]).sum(1)
        chain_bound = max(chain_bound, int(mag.max()))
        acc_bound = max(acc_bound, int(np.abs(val).sum(0).max()))
        acc[name] = val.sum(0)
    return acc, chain_bound, acc_bound


def modelled_real(a, b, moduli, carry=None):
    """The real kernel's function on stacks of planes, by its schedule and
    epilogue: m8 m(HH) + m4 m(X) + m(LL) (+ carry) mod p."""
    lengths = chain_lengths(SOURCES["fp8_mod_gemm"])
    out = []
    for pl, p in enumerate(moduli):
        m4 = sym_mod(16, p)
        m8 = sym_mod(m4 * m4, p)
        acc, _, _ = run_chains(a[pl], b[pl], lengths)
        v = m8 * sym_mod(acc["HH"], p) + m4 * sym_mod(acc["X"], p) + sym_mod(acc["LL"], p)
        if carry is not None:
            v = v + carry[pl]
        out.append(sym_mod(v, p))
    return np.stack(out).astype(np.int8)


def plain_real(a, b, moduli, carry=None):
    """fp8_mod_gemm_plain and int8_mod_gemm_plain on the same planes, which
    must agree with each other."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    c = None if carry is None else t(carry)
    fp8 = fp8_mod_gemm_plain(t(a), t(b), moduli=moduli, carry=c).numpy()
    int8 = int8_mod_gemm_plain(t(a), t(b), moduli=moduli, carry=c).numpy()
    np.testing.assert_array_equal(fp8, int8)
    return fp8


def modelled_karatsuba(ar, ai, br, bi, moduli, carry=None):
    """The kernel's function on stacks of planes, by its schedule and epilogue."""
    lengths = chain_lengths()
    out_r, out_i = [], []
    for pl, p in enumerate(moduli):
        m4 = sym_mod(16, p)
        m8 = sym_mod(m4 * m4, p)
        res = []
        for a, b in ((ar[pl], br[pl]), (ai[pl], bi[pl]),
                     (sum_mod_small(ar[pl], ai[pl], p), sum_mod_small(br[pl], bi[pl], p))):
            acc, _, _ = run_chains(a, b, lengths)
            res.append(sym_mod(m8 * sym_mod(acc["HH"], p) + m4 * sym_mod(acc["X"], p) + sym_mod(acc["LL"], p), p))
        d, e, f = res
        cr, ci = d - e, f - d - e
        if carry is not None:
            cr = cr + carry[0][pl]
            ci = ci + carry[1][pl]
        out_r.append(sym_mod(cr, p))
        out_i.append(sym_mod(ci, p))
    return np.stack(out_r).astype(np.int8), np.stack(out_i).astype(np.int8)


def plain(ar, ai, br, bi, moduli, carry=None):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    got = karatsuba_mod_gemm_plain(t(ar), t(ai), t(br), t(bi), moduli=moduli,
                                   carry=None if carry is None else (t(carry[0]), t(carry[1])))
    return tuple(x.numpy() for x in got)


def residues(rng, moduli, shape):
    return np.stack([rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, size=shape)
                     for p in moduli]).astype(np.int8)


def worst_cases(rng, k):
    """(m, k) and (k, n) planes as chip_smoke.py's worst cases: every residue
    -120 (hi = -8, lo = 8: the largest digit products), -120 against rows of
    alternating sign, and random int8 residues."""
    a = np.full((2, k), -120, dtype=np.int8)
    b = np.full((k, 3), -120, dtype=np.int8)
    alt = b.copy()
    alt[::2] = 120
    return {"-120": (a, b), "alternating": (a, alt),
            "random": (rng.integers(-127, 128, (2, k)).astype(np.int8),
                       rng.integers(-127, 128, (k, 3)).astype(np.int8))}


def test_chain_constants_fit_the_tiles():
    lengths = chain_lengths()
    assert all(v >= 1 for v in lengths.values())
    for bk in kernel_bks():
        assert bk % 32 == 0
        assert all((bk // 32) % v == 0 for v in lengths.values()), (bk, lengths)


@pytest.mark.parametrize("case", ["-120", "alternating", "random"])
def test_chains_and_accumulators_stay_exact_at_the_chunk_limit(rng, case):
    """At k = FP8_K_CHUNK_LIMIT every chain sums at most 2^12 and every
    accumulator stays below 2^24 (HH, LL <= 2^22, X <= 2^23); the model's
    residues are then the plain version's, bitwise (AR = a, AI = 0, as
    chip_smoke.py runs the complex kernel's worst cases)."""
    k = FP8_K_CHUNK_LIMIT
    a, b = worst_cases(rng, k)[case]
    acc, chain_bound, acc_bound = run_chains(a, b, chain_lengths())
    assert chain_bound <= CHAIN_LIMIT
    assert acc_bound < F32_EXACT
    np.testing.assert_array_equal(acc["HH"] * 256 + acc["X"] * 16 + acc["LL"],
                                  a.astype(np.int64) @ b.astype(np.int64))
    mods = make_crt_context(8).moduli
    ar = np.broadcast_to(a, (8, *a.shape))
    br = np.broadcast_to(b, (8, *b.shape))
    zr, zb = np.zeros_like(ar), np.zeros_like(br)
    got = modelled_karatsuba(ar, zr, br, zb, mods)
    want = plain(ar, zr, br, zb, mods)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_longer_chain_would_break_the_rule(rng):
    """The bound has teeth: HH chained over twice the kernel's k32 steps sums
    2^13 on the -120 planes."""
    a, b = worst_cases(rng, 4096)["-120"]
    lengths = chain_lengths()
    _, bound, _ = run_chains(a, b, dict(lengths, HH=2 * lengths["HH"]))
    assert bound > CHAIN_LIMIT


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("n_mod", [7, 14, 21])
def test_modelled_epilogue_matches_plain(rng, n_mod, carry):
    """The modelled schedule and epilogue equal karatsuba_mod_gemm_plain
    bitwise, at a ragged k (not a multiple of 32 or of any tile's BK)."""
    mods = make_crt_context(n_mod).moduli
    m, k, n = 3, 1000, 5
    ar, ai = residues(rng, mods, (m, k)), residues(rng, mods, (m, k))
    br, bi = residues(rng, mods, (k, n)), residues(rng, mods, (k, n))
    c = (residues(rng, mods, (m, n)), residues(rng, mods, (m, n))) if carry else None
    got = modelled_karatsuba(ar, ai, br, bi, mods, carry=c)
    want = plain(ar, ai, br, bi, mods, carry=c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_kernel_sum_mod_is_the_plain_sum_mod():
    """The kernel's two-correction (x + y) mod p equals the exact symmetric
    mod for every pair of int8 values and every default modulus."""
    x, y = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128))
    for p in make_crt_context(21).moduli:
        np.testing.assert_array_equal(sum_mod_small(x, y, p), sym_mod(x.astype(np.int64) + y, p))


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_each_e4m3_source_keeps_the_chain_rule(source, rng):
    """Both e4m3 kernels: their chain constants divide every compiled
    tile's k32 steps, and on every worst case at k = FP8_K_CHUNK_LIMIT no
    chain sums past 2^12 and no accumulator reaches 2^24."""
    lengths = chain_lengths(SOURCES[source])
    bks = kernel_bks(SOURCES[source])
    assert len(bks) >= 2 and all(v >= 1 for v in lengths.values())
    for bk in bks:
        assert bk % 32 == 0 and all((bk // 32) % v == 0 for v in lengths.values()), (source, bk, lengths)
    for case, (a, b) in worst_cases(rng, FP8_K_CHUNK_LIMIT).items():
        acc, chain_bound, acc_bound = run_chains(a, b, lengths)
        assert chain_bound <= CHAIN_LIMIT, (source, case)
        assert acc_bound < F32_EXACT, (source, case)
        np.testing.assert_array_equal(acc["HH"] * 256 + acc["X"] * 16 + acc["LL"],
                                      a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("case", ["-120", "alternating", "random"])
def test_real_model_matches_plain_at_the_chunk_limit(rng, case):
    """The real kernel's modelled schedule and epilogue at k =
    FP8_K_CHUNK_LIMIT on chip_smoke.py's worst cases, with and without a
    carry: bitwise fp8_mod_gemm_plain's and int8_mod_gemm_plain's."""
    a, b = worst_cases(rng, FP8_K_CHUNK_LIMIT)[case]
    mods = make_crt_context(8).moduli
    ap = np.ascontiguousarray(np.broadcast_to(a, (8, *a.shape)))
    bp = np.ascontiguousarray(np.broadcast_to(b, (8, *b.shape)))
    for carry in (None, residues(rng, mods, (a.shape[0], b.shape[1]))):
        np.testing.assert_array_equal(modelled_real(ap, bp, mods, carry), plain_real(ap, bp, mods, carry))


@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("n_mod", [8, 16, 21])
def test_real_modelled_epilogue_matches_plain(rng, n_mod, carry):
    """The real kernel's modelled schedule and epilogue equal
    fp8_mod_gemm_plain and int8_mod_gemm_plain bitwise, at a ragged k (not
    a multiple of 32 or of any tile's BK)."""
    mods = make_crt_context(n_mod).moduli
    m, k, n = 3, 1000, 5
    a, b = residues(rng, mods, (m, k)), residues(rng, mods, (k, n))
    c = residues(rng, mods, (m, n)) if carry else None
    np.testing.assert_array_equal(modelled_real(a, b, mods, c), plain_real(a, b, mods, c))
