"""Scaling-vector determination (Alg. 1 step III; paper SIII-B).

The port's copy of `repro.core.scaling`.  Two modes, real and complex:

* fast  — Cauchy-Schwarz bound on the row/column 2-norms (eqs. 11-12).
* accu  — an auxiliary 7-bit int8 product bounds sum_h |a'||b'| (eqs. 13-14).

Scale factors are exact powers of two carried as int32 exponents.  As in
the reference, log2 is taken in float64 with the safety factor
DELTA = 0.5*(1+2^-40) and floor(), and ilogb comes from frexp, so the
exponents match the reference bit for bit.
"""
from __future__ import annotations

import torch

from .intmul import int8_matmul
from .moduli import CRTContext

DELTA = 0.5 * (1.0 + 2.0**-40)
_F64 = torch.float64


def ilogb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) for x > 0, exact (frexp-based)."""
    _, e = torch.frexp(x)
    return (e - 1).to(torch.int32)


def _p_fast(ctx: CRTContext) -> float:
    # P'_fast = (log2(P-1) - 1)/2 - 1
    return (ctx.log2_P - 1.0) / 2.0 - 1.0


def _p_accu(ctx: CRTContext) -> float:
    # P'_accu = log2(P-1)/2 - 0.5
    return ctx.log2_P / 2.0 - 0.5


def exp2_vector(e: torch.Tensor) -> torch.Tensor:
    """2.0**e in float64 for integer e, as the reference's
    `jnp.ldexp(1.0, e)` gives it: exact in the normal range [-1022, 1023],
    +inf above it, and +0.0 below it (XLA's CPU backend flushes the
    subnormal powers to zero).  Built from the bit pattern (`torch.ldexp`
    takes 2**e in float32)."""
    return ((e.to(torch.int64).clamp(-1023, 1024) + 1023) << 52).view(_F64)


def _nonzero_or_one(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.ones_like(x))


def _fast_exponent(absmax, norm2_scaled, ctx: CRTContext) -> torch.Tensor:
    """floor(P'fast - max(1, delta*log2(sum a_hat^2))) - ilogb(max|a|);
    zero rows get exponent 0."""
    e_max = ilogb(_nonzero_or_one(absmax))
    t = torch.clamp(norm2_scaled, min=1.0)
    bound = torch.clamp(DELTA * torch.log2(t), min=1.0)
    e = torch.floor(_p_fast(ctx) - bound).to(torch.int32) - e_max
    return torch.where(absmax > 0, e, torch.zeros_like(e))


def scale_fast_real(a: torch.Tensor, b: torch.Tensor, ctx: CRTContext):
    """Returns integer exponents (e_mu[m], e_nu[n]); mu = 2^e_mu etc."""
    a = a.to(_F64)
    b = b.to(_F64)
    amax = a.abs().amax(dim=1)
    bmax = b.abs().amax(dim=0)
    an = a * exp2_vector(-ilogb(_nonzero_or_one(amax)))[:, None]
    bn = b * exp2_vector(-ilogb(_nonzero_or_one(bmax)))[None, :]
    e_mu = _fast_exponent(amax, (an * an).sum(dim=1), ctx)
    e_nu = _fast_exponent(bmax, (bn * bn).sum(dim=0), ctx)
    return e_mu, e_nu


def scale_fast_complex(ar, ai, br, bi, ctx: CRTContext):
    """Complex fast mode: rows i and i+m of the block embedding share norms,
    so mu stays an m-vector (paper SIII-B)."""
    ar, ai = ar.to(_F64), ai.to(_F64)
    br, bi = br.to(_F64), bi.to(_F64)
    amax = torch.maximum(ar.abs().amax(dim=1), ai.abs().amax(dim=1))
    bmax = torch.maximum(br.abs().amax(dim=0), bi.abs().amax(dim=0))
    sa = exp2_vector(-ilogb(_nonzero_or_one(amax)))[:, None]
    sb = exp2_vector(-ilogb(_nonzero_or_one(bmax)))[None, :]
    ars, ais = ar * sa, ai * sa
    brs, bis = br * sb, bi * sb
    na = (ars * ars + ais * ais).sum(dim=1)
    nb = (brs * brs + bis * bis).sum(dim=0)
    return _fast_exponent(amax, na, ctx), _fast_exponent(bmax, nb, ctx)


def _bar_int8(x_abs: torch.Tensor, e_bar: torch.Tensor, axis: int) -> torch.Tensor:
    """ceil(|x| * 2^e_bar) as int8 (<= 64; 7-bit upper-bound matrix)."""
    shape = [1] * x_abs.ndim
    shape[axis] = -1
    v = torch.ceil(x_abs * exp2_vector(e_bar).reshape(shape))
    return torch.clamp(v, 0, 127).to(torch.int8)


def _accu_exponent(cbar_max: torch.Tensor, e_bar: torch.Tensor, ctx: CRTContext):
    t = torch.clamp(cbar_max.to(_F64), min=1.0)
    e = torch.floor(_p_accu(ctx) - DELTA * torch.log2(t)).to(torch.int32)
    return e + e_bar


def accu_bound_real(x: torch.Tensor, side: str):
    """One operand's accurate-mode 7-bit bound: (bar, e_bar, nonzero);
    side='left' bounds rows of A, side='right' columns of B."""
    x = x.to(_F64)
    xmax = x.abs().amax(dim=1 if side == "left" else 0)
    # scale so the max-abs integer part fits 6 bits: max*2^e in [32, 64)
    e_bar = 5 - ilogb(_nonzero_or_one(xmax))
    bar = _bar_int8(x.abs(), e_bar, 0 if side == "left" else 1)
    return bar, e_bar, xmax > 0


def accu_bound_complex(xr: torch.Tensor, xi: torch.Tensor, side: str):
    """Complex twin of `accu_bound_real`: ((bar_r, bar_i), e_bar, nonzero)."""
    xr, xi = xr.to(_F64), xi.to(_F64)
    red = 1 if side == "left" else 0
    xmax = torch.maximum(xr.abs().amax(dim=red), xi.abs().amax(dim=red))
    e_bar = 5 - ilogb(_nonzero_or_one(xmax))
    axis = 0 if side == "left" else 1
    bar_r = _bar_int8(xr.abs(), e_bar, axis)
    bar_i = _bar_int8(xi.abs(), e_bar, axis)
    return (bar_r, bar_i), e_bar, xmax > 0


def accu_cbar_complex(abar, bbar) -> torch.Tensor:
    """Cbar_I = AbarI BbarR + AbarR BbarI, Cbar_R = Cbar_I + (AbarR - AbarI)
    (BbarR - BbarI); returns max(R, I)."""
    abar_r, abar_i = abar
    bbar_r, bbar_i = bbar
    cbar_i = int8_matmul(abar_i, bbar_r) + int8_matmul(abar_r, bbar_i)
    # (AbarR - AbarI) etc. are error-free in int8 (values in [-64, 64])
    cbar_r = cbar_i + int8_matmul(abar_r - abar_i, bbar_r - bbar_i)
    return torch.maximum(cbar_r, cbar_i)


def accu_exponents(cbar, e_abar, e_bbar, a_nz, b_nz, ctx: CRTContext, row_combine=None, col_combine=None):
    """cbar bound -> (e_mu, e_nu) integer exponents.

    `row_combine` / `col_combine` are the sharded execution's collectives:
    cbar's row maxima cover only this rank's output columns (and its
    column maxima its rows), so a rank combines them (an int32 MAX, exact)
    over the ranks that split the other axis.  Without them this is the
    paper's single-device computation."""
    rmax, cmax = cbar.amax(dim=1), cbar.amax(dim=0)
    if row_combine is not None:
        rmax = row_combine(rmax)
    if col_combine is not None:
        cmax = col_combine(cmax)
    e_mu = _accu_exponent(rmax, e_abar, ctx)
    e_nu = _accu_exponent(cmax, e_bbar, ctx)
    return (
        torch.where(a_nz, e_mu, torch.zeros_like(e_mu)),
        torch.where(b_nz, e_nu, torch.zeros_like(e_nu)),
    )


def scale_accurate_real(a: torch.Tensor, b: torch.Tensor, ctx: CRTContext, row_combine=None, col_combine=None):
    abar, e_abar, a_nz = accu_bound_real(a, "left")
    bbar, e_bbar, b_nz = accu_bound_real(b, "right")
    cbar = int8_matmul(abar, bbar)  # exact upper bound of sum mu|a| nu|b|
    return accu_exponents(cbar, e_abar, e_bbar, a_nz, b_nz, ctx, row_combine, col_combine)


def scale_accurate_complex(ar, ai, br, bi, ctx: CRTContext, row_combine=None, col_combine=None):
    abar, e_abar, a_nz = accu_bound_complex(ar, ai, "left")
    bbar, e_bbar, b_nz = accu_bound_complex(br, bi, "right")
    cmax = accu_cbar_complex(abar, bbar)
    return accu_exponents(cmax, e_abar, e_bbar, a_nz, b_nz, ctx, row_combine, col_combine)
