"""Error-free floating-point transformations (Dekker/Knuth) on float32
tensors.

The port's copy of the float32 use of `repro.core.expansion`, in the
reference's op order: the Garner reconstruction's double-single sum is held
bitwise against it.  Each function is built from separate +, -, * tensor
ops, which PyTorch evaluates one rounding at a time (no contraction).
"""
from __future__ import annotations

_SPLITTER = 4097.0  # 2^12 + 1: Dekker's split of a float32


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
    c = _SPLITTER * a
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
    """Double-double addition (Dekker add2)."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return quick_two_sum(sh, te)
