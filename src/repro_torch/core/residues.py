"""Integer conversion and residue decomposition (Alg. 1 steps IV, V-i/ii/iv).

The port's copy of `repro.core.residues`.  The scaled integers
a' = trunc(a * mu) can exceed 2^53, but they are exactly representable (mu
is a power of two, trunc is exact), so they are peeled into base-2^24
limbs, each exact and below 2^24, and each limb is reduced with the
precomputed (2^24)^i mod p_l in small exact arithmetic.  Every function is
built from separate tensor ops in the reference's order, so the float64
results are the reference's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .moduli import CRTContext

LIMB_BITS = 24
LIMB = float(1 << LIMB_BITS)


def num_limbs_for_bits(bits: float) -> int:
    """Limbs needed to hold |a'| <= 2^bits."""
    return max(1, math.ceil((bits + 1) / LIMB_BITS))


def quantize(a: torch.Tensor, scale: torch.Tensor, axis: int) -> torch.Tensor:
    """a' = trunc(a * scale) with the scale broadcast along `axis`.

    `scale` holds exact powers of two, so the product and trunc are exact.
    """
    shape = [1] * a.ndim
    shape[axis] = -1
    return torch.trunc(a * scale.reshape(shape))


def split_limbs(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Exactly split integer-valued float x into signed base-2^24 limbs.

    Returns (n_limbs, *x.shape) with x == sum_i limbs[i] * 2^(24*i) and
    |limbs[i]| < 2^24.  Each peel is exact: the low part is a contiguous
    lower-bit slice of x's significand.
    """
    limbs = []
    rem = x
    for i in reversed(range(1, n_limbs)):
        base = LIMB**i
        hi = torch.trunc(rem / base)
        rem = rem - hi * base
        limbs.append(hi)
    limbs.append(rem)
    return torch.stack(limbs[::-1], dim=0)


def _limb_radix_table(ctx: CRTContext, n_limbs: int) -> np.ndarray:
    """(n_limbs, N) table of 2^(24*i) mod p_l, symmetric range."""
    tab = np.zeros((n_limbs, ctx.n), dtype=np.int32)
    for i in range(n_limbs):
        for l, p in enumerate(ctx.moduli):
            r = pow(1 << LIMB_BITS, i, p)
            if r > (p - 1) // 2:
                r -= p
            tab[i, l] = r
    return tab


def sym_mod_small(v: torch.Tensor, p, half) -> torch.Tensor:
    """Symmetric mod for |v| small enough that v/p rounds within +/-1.

    |v| <= ~2^44 (f64) / ~2^20 (f32).  Result in [-(p-1)/2, (p-1)/2],
    exact: n is an integer, v - n*p is exact, and one correction step fixes
    a +/-1 rounding of n.  Integer `v` is taken in the float type the
    reference's true division promotes it to (float64 for int64, else
    float32), which the result then has.
    """
    if not v.is_floating_point():
        v = v.to(torch.float64 if v.dtype == torch.int64 else torch.float32)
    n = torch.round(v / p)  # half to even, as jnp.round
    r = v - n * p
    r = torch.where(r > half, r - p, r)
    r = torch.where(r < -half, r + p, r)
    return r


def sym_mod_int32(v: torch.Tensor, p) -> torch.Tensor:
    """Exact symmetric mod of integer tensors into [-(p-1)/2, (p-1)/2].

    `p` is an int or an integer tensor broadcast against `v` (one modulus
    per residue plane).  Returns the dtype of `v`.
    """
    r = torch.remainder(v, p)  # in [0, p)
    return torch.where(r > (p - 1) // 2, r - p, r)


def residues_from_quantized(aq: torch.Tensor, ctx: CRTContext, n_limbs: int) -> torch.Tensor:
    """Map integer-valued float a' -> (N, *shape) int8 symmetric residues.

    Steps V-i/ii of Alg. 1.  Exact for |a'| < 2^(24 * n_limbs).  Each
    plane is narrowed to int8 as it is made (the reference stacks the float
    planes first; the values are the same small integers).
    """
    limbs = split_limbs(aq, n_limbs)  # (L, ...) floats, |limb| < 2^24
    radix = _limb_radix_table(ctx, n_limbs)  # (L, N) int32 host constants
    outs = []
    for l, p in enumerate(ctx.moduli):
        half = (p - 1) // 2
        acc = torch.zeros_like(aq)
        for i in range(n_limbs):
            # |limb mod| <= (p-1)/2; times |radix| <= (p-1)/2 => < 2^14
            r_i = sym_mod_small(limbs[i], float(p), float(half))
            acc = acc + r_i * float(radix[i, l])
        # |acc| <= n_limbs * 127^2 < 2^17 -> exact final reduction
        outs.append(sym_mod_small(acc, float(p), float(half)).to(torch.int8))
    return torch.stack(outs, dim=0)


def residues(a: torch.Tensor, scale: torch.Tensor, axis: int, ctx: CRTContext, n_limbs: int):
    """quantize + residue-decompose; returns (a_quantized_float, int8 residues)."""
    aq = quantize(a, scale, axis)
    return aq, residues_from_quantized(aq, ctx, n_limbs)
