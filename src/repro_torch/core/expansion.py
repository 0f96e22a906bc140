"""Error-free floating-point transformations (Dekker/Knuth) on float32 and
float64 tensors.

The port's copy of `repro.core.expansion`, in the reference's op order: the
Garner kernel's double-single sum (float32) and the reference execution's
CRT reconstructions (float64) are held bitwise against it.  Each function
is built from separate +, -, * tensor ops, which PyTorch evaluates one
rounding at a time (no contraction into a fused multiply-add).
"""
from __future__ import annotations

import torch

_SPLITTERS = {
    torch.float32: 4097.0,        # 2^12 + 1
    torch.float64: 134217729.0,   # 2^27 + 1
}


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Requires |a| >= |b|. s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    # a Python float is a float64: its arithmetic rounds as a float64 tensor's
    c = _SPLITTERS[a.dtype if isinstance(a, torch.Tensor) else torch.float64] * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly (Dekker; no FMA dependence)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(xh, xl, yh, yl):
    """Double-double addition (Dekker add2, ~106-bit f64 / ~48-bit f32)."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return quick_two_sum(sh, te)


def dd_add_fp(xh, xl, y):
    sh, se = two_sum(xh, y)
    return quick_two_sum(sh, xl + se)


def dd_mul_fp(xh, xl, y):
    """(xh, xl) * y in double-double."""
    ph, pe = two_prod(xh, y)
    return quick_two_sum(ph, pe + xl * y)


def dd_neg(xh, xl):
    return -xh, -xl


def dd_to_fp(xh, xl):
    return xh + xl
