"""Componentwise error bounds for the Ozaki-II scheme (arXiv:2602.02549).

The port's copy of `repro.core.accuracy`.

The Error Analysis paper bounds the emulated product C = A.B componentwise:
quantization a' = trunc(a * 2^e_mu) is the ONLY inexact step (residue
decomposition, the int8/fp8 GEMMs and CRT reconstruction are all exact by
construction), so with eps_a := 2^{-e_mu_i} / max_h|a_ih| the error telescopes to

    |C - C_emul|_ij  <=  k * amax_i * bmax_j * (eps_a + eps_b + eps_a eps_b)
                          + (output rounding)                       [thm. 3.1]

and everything reduces to bounding eps from the scaling exponents of
`core/scaling` (Alg. 1 step III).  Equation map:

  * fast mode (paper eqs. 11-12): e_mu = floor(P'_fast - bnd) - ilogb(amax)
    with bnd = max(1, DELTA log2 t) and t the scaled row 2-norm, so
    eps <= 2^{1 + bnd - P'_fast}.  A priori t <= 4k (real) / 8k (complex
    block embedding); `probe_operands` measures the actual t.
  * accu mode (paper eqs. 13-14): e_mu = floor(P'_accu - DELTA log2 cbar)
    + 5 - ilogb(amax), so eps <= 2^{-4 + DELTA log2 cbar - P'_accu}.  The
    7-bit bars are <= 64, so a priori cbar <= 4096k (real) / 12288k
    (complex Karatsuba combination); the probe bounds the actual cbar in
    O(mk + kn) without forming the int8 product.
  * complex formulations (paper eqs. 7/8/10): the eq.(10) Karatsuba
    combination C_I = F - D - E amplifies the per-product bound 6x (F's
    operands are 2x larger and three products combine); the eq.(7)/(8)
    block embeddings run one real GEMM over 2k, a 2x factor.
  * output rounding: reconstruction is exact, but the final cast to the
    output dtype plus block/chunk/Karatsuba accumulation round in
    floating point — ROUND_SLACK ulps of the real output dtype cover it
    and set the floor no rtol can go below.

The bound is *execution-independent*: every execution path ("kernel",
"fused", "fp8") is bitwise identical, so one static bound certifies them
all.  `rel_bound` and `min_moduli_for` are plain Python floats, equal to
the reference's; `probe_operands` and `rel_error` take tensors or numpy
arrays and reduce in float64 on the operands' device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .moduli import MAX_MODULI, CRTContext, make_crt_context
from .scaling import DELTA

__all__ = [
    "GemmStats",
    "ROUND_SLACK",
    "min_moduli_for",
    "probe_operands",
    "rel_bound",
    "rel_error",
]

#: ulps of the real output dtype charged for output rounding (final cast,
#: blocked/chunked accumulation, Karatsuba combines).  This is the floor
#: below which no ``rtol`` is reachable at any moduli count.
ROUND_SLACK = 16.0

_REAL_ULP = {
    "float32": 2.0**-24,
    "float64": 2.0**-53,
    "complex64": 2.0**-24,
    "complex128": 2.0**-53,
}
_COMPLEX = ("complex64", "complex128")

#: amplification of the per-product bound by the complex formulation
#: (paper eqs. (7)/(8)/(10); "real" operands have no combination step).
FORMULATION_FACTOR = {
    "real": 1.0,
    "karatsuba": 6.0,
    "block_a": 2.0,
    "block_b": 2.0,
}


@dataclasses.dataclass(frozen=True)
class GemmStats:
    """Dynamic-range probe of one GEMM's operands (see `probe_operands`).

    Any field left ``None`` falls back to the a-priori worst case, so a
    partially-filled (or absent) stats object is always safe.
    """

    k: int
    #: fast mode — log2 of max_i sum_h (a_ih / 2^ilogb(amax_i))^2 (and the
    #: column twin for B).  A priori <= log2(4k) real / log2(8k) complex.
    log2_norm_a: float | None = None
    log2_norm_b: float | None = None
    #: accu mode — log2 upper bound of the largest cbar entry.  A priori
    #: <= log2(4096k) real / log2(12288k) complex.
    log2_cbar: float | None = None


def _real_ulp(dtype: str, out_dtype: str | None) -> float:
    key = out_dtype or dtype
    if key not in _REAL_ULP:
        raise ValueError(f"unknown dtype {key!r}")
    return _REAL_ULP[key]


def _formulation_factor(dtype: str, formulation: str | None) -> float:
    if dtype not in _COMPLEX:
        return FORMULATION_FACTOR["real"]
    if formulation in (None, "auto"):
        # unresolved: charge the worst complex strategy (Karatsuba)
        return FORMULATION_FACTOR["karatsuba"]
    if formulation not in FORMULATION_FACTOR:
        raise ValueError(f"unknown formulation {formulation!r}")
    return FORMULATION_FACTOR[formulation]


def _eps_pair(
    dtype: str, mode: str, ctx: CRTContext, k: int, stats: GemmStats | None
) -> tuple[float, float]:
    """Per-operand quantization grids (eps_a, eps_b) = 2^{-e_mu}/amax bounds."""
    cplx = dtype in _COMPLEX
    if mode == "fast":
        # paper eqs. (11)-(12) via core/scaling._fast_exponent
        p = (ctx.log2_P - 1.0) / 2.0 - 1.0
        worst = math.log2((8.0 if cplx else 4.0) * k)
        la = worst if stats is None or stats.log2_norm_a is None else stats.log2_norm_a
        lb = worst if stats is None or stats.log2_norm_b is None else stats.log2_norm_b
        ea = 2.0 ** (1.0 + max(1.0, DELTA * min(la, worst)) - p)
        eb = 2.0 ** (1.0 + max(1.0, DELTA * min(lb, worst)) - p)
        return ea, eb
    if mode == "accu":
        # paper eqs. (13)-(14) via core/scaling._accu_exponent
        p = ctx.log2_P / 2.0 - 0.5
        worst = math.log2((12288.0 if cplx else 4096.0) * k)
        lc = worst if stats is None or stats.log2_cbar is None else stats.log2_cbar
        e = 2.0 ** (-4.0 + DELTA * max(min(lc, worst), 0.0) - p)
        return e, e
    raise ValueError(f"mode must be 'fast' or 'accu', got {mode!r}")


def rel_bound(
    dtype: str,
    mode: str,
    n_moduli: int,
    k: int,
    *,
    formulation: str | None = None,
    stats: GemmStats | None = None,
    out_dtype: str | None = None,
) -> float:
    """Static componentwise error bound, relative to ``k * amax_i * bmax_j``.

    Upper-bounds ``max_ij |C - C_emul|_ij / (k * amax_i * bmax_j)`` where
    ``amax_i = max_h |a_ih|`` (componentwise max for complex) and
    ``bmax_j`` the column twin — the certified metric of `rel_error` and of
    every accuracy-band test.  With ``stats=None`` the bound holds for ANY
    operands; a `probe_operands` result tightens it to these operands.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 1 <= n_moduli <= MAX_MODULI:
        raise ValueError(f"n_moduli must be in [1, {MAX_MODULI}], got {n_moduli}")
    ctx = make_crt_context(n_moduli)
    ea, eb = _eps_pair(dtype, mode, ctx, k, stats)
    factor = _formulation_factor(dtype, formulation)
    return factor * (ea + eb + ea * eb) + ROUND_SLACK * _real_ulp(dtype, out_dtype)


def min_moduli_for(
    rtol: float,
    dtype: str,
    *,
    k: int,
    mode: str = "fast",
    formulation: str | None = None,
    stats: GemmStats | None = None,
    out_dtype: str | None = None,
) -> int:
    """Smallest moduli count whose `rel_bound` meets ``rtol`` (inverse lookup).

    Monotone in ``rtol`` (looser tolerance never needs more moduli) and
    consistent with the forward bound by construction:
    ``rel_bound(..., min_moduli_for(rtol, ...), ...) <= rtol``.

    Raises ``ValueError`` when the tolerance is unreachable — either below
    the output-dtype rounding floor (``ROUND_SLACK`` ulps) or beyond the
    moduli the 159-bit CRT reconstruction supports.
    """
    if not rtol > 0.0:
        raise ValueError(f"rtol must be > 0, got {rtol}")
    best = math.inf
    for n in range(1, MAX_MODULI + 1):
        try:
            b = rel_bound(
                dtype, mode, n, k,
                formulation=formulation, stats=stats, out_dtype=out_dtype,
            )
        except ValueError:
            break  # make_crt_context: P exceeds the 159-bit reconstruction
        if b <= rtol:
            return n
        best = min(best, b)
    floor = ROUND_SLACK * _real_ulp(dtype, out_dtype)
    raise ValueError(
        f"rtol={rtol:g} is unreachable for dtype={dtype}/mode={mode} at k={k}: "
        f"the bound bottoms out at {best:g} (output-dtype rounding floor "
        f"{floor:g}); loosen rtol or move to a wider backend"
    )


def _f64(x) -> torch.Tensor:
    """A tensor or numpy array as a float64 / complex128 tensor, on its device."""
    x = torch.as_tensor(x)
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _parts(x: torch.Tensor) -> list[torch.Tensor]:
    if x.is_complex():
        return [x.real, x.imag]
    return [x]


def _row_absmax(parts: list[torch.Tensor], axis: int) -> torch.Tensor:
    """max |x| over the other axis, componentwise max across the parts."""
    red = 1 - axis
    absmax = None
    for p in parts:
        m = torch.amax(p.abs(), dim=red)
        absmax = m if absmax is None else torch.maximum(absmax, m)
    return absmax


def _fast_log2norm(parts: list[torch.Tensor], axis: int) -> float:
    """log2 of the max scaled 2-norm sum along ``axis`` — the quantity whose
    log the fast-mode exponent formula bounds (`scaling._fast_exponent`)."""
    red = 1 - axis
    absmax = _row_absmax(parts, axis)
    _, e = torch.frexp(torch.where(absmax > 0, absmax, torch.ones_like(absmax)))
    scale = torch.ldexp(torch.ones_like(absmax), -(e - 1))
    shape = [1, 1]
    shape[axis] = -1
    t = sum(torch.sum((p * scale.reshape(shape)) ** 2, dim=red) for p in parts)
    # headroom for f64 summation-order differences vs the on-device norm
    t_max = float(torch.amax(torch.clamp(t, min=1.0))) * (1.0 + 2.0**-20)
    return math.log2(t_max)


def _bar(parts: list[torch.Tensor], axis: int) -> list[torch.Tensor]:
    """The 7-bit upper-bound matrices of `scaling`'s accu mode, as f64."""
    absmax = _row_absmax(parts, axis)
    _, e = torch.frexp(torch.where(absmax > 0, absmax, torch.ones_like(absmax)))
    shape = [1, 1]
    shape[axis] = -1
    s = torch.ldexp(torch.ones_like(absmax), 5 - (e - 1)).reshape(shape)
    return [torch.clamp(torch.ceil(p.abs() * s), 0, 127) for p in parts]


def probe_operands(a, b) -> GemmStats:
    """Cheap O(mk + kn) dynamic-range probe of a GEMM's operands.

    Takes tensors (on any device; the reductions run there, in float64) or
    numpy arrays.  The reference returns None for a jax tracer; the port has
    none.  The accu-mode cbar is bounded from row/column sums of the 7-bit
    bars without forming the O(mkn) int8 product: cbar_ij <=
    min(rowsum_i(abar) * max(bbar), max(abar) * colsum_j(bbar)), doubled for
    the complex combination.
    """
    a, b = _f64(a), _f64(b)
    k = a.shape[-1]
    pa, pb = _parts(a.reshape(-1, k)), _parts(b.reshape(k, -1))
    la = _fast_log2norm(pa, axis=0)
    lb = _fast_log2norm(pb, axis=1)
    abar, bbar = _bar(pa, axis=0), _bar(pb, axis=1)
    a_sum = sum(abar)  # real: the bar itself; complex: bar_r + bar_i
    b_sum = sum(bbar)

    def _max(x):
        return float(torch.amax(x)) if x.numel() else 0.0

    row = _max(torch.sum(a_sum, dim=1)) * _max(b_sum)
    col = _max(a_sum) * _max(torch.sum(b_sum, dim=0))
    cbar = min(row, col) * (2.0 if len(pa) == 2 else 1.0)
    return GemmStats(
        k=k, log2_norm_a=la, log2_norm_b=lb,
        log2_cbar=math.log2(max(cbar, 1.0)),
    )


def rel_error(c_emul, c_ref, a, b) -> float:
    """Measured counterpart of `rel_bound`: the certified accuracy metric.

    ``max_ij |c_emul - c_ref|_ij / (k * amax_i * bmax_j)`` with the complex
    max taken componentwise (real and imaginary parts separately) — exactly
    the quantity `rel_bound` upper-bounds.  Tensors or numpy arrays.
    """
    a, b = _f64(a), _f64(b)
    k = a.shape[-1]
    a2, b2 = a.reshape(-1, k), b.reshape(k, -1)
    amax = _row_absmax(_parts(a2), axis=0)
    bmax = _row_absmax(_parts(b2), axis=1)
    m, n = a2.shape[0], b2.shape[1]
    d = _f64(c_emul).reshape(m, n) - _f64(c_ref).reshape(m, n)
    err = None
    for p in _parts(d):
        err = p.abs() if err is None else torch.maximum(err, p.abs())
    denom = k * torch.outer(amax, bmax)
    mask = denom > 0
    if not bool(torch.any(mask)):
        return 0.0
    return float(torch.amax(err[mask] / denom[mask]))
