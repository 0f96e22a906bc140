"""Garner mixed-radix CRT reconstruction + exact inverse scaling.

Port of `repro.kernels.crt_garner`: the digit recursion is exact small
integer arithmetic in f32, the digit -> value sum accumulates in a
double-single (two-f32) pair against the prescaled weights W_t 2^-S, and
the exact power-of-two inverse scaling C = C' / (mu_i nu_j) follows.
Output is f32 (m, n), or the (2, m, n) double-single pair with `out_dd`
(f64-shaped output); a (S, N, m, n) residue stack reconstructs S outputs
sharing the scale exponents in one launch.

On CUDA tensors `crt_garner` launches `csrc/crt_garner.cu`, which takes
the same digits by the mixed-radix form (`route_tables`) without a
division, FRND or int-to-float conversion, bit for bit; on CPU tensors it
runs `crt_garner_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core import expansion as ex
from ..core.moduli import CRTContext
from . import build
from .common import check_tensor, on_card, split_scale_exponent, sym_mod_f32, traced_launch


def _prescale(ctx: CRTContext) -> int:
    """Weight prescale S keeping W_t * 2^-S * 127 within f32 range."""
    return max(0, math.ceil(ctx.log2_P) - 100)


def _weight_table(ctx: CRTContext) -> np.ndarray:
    """(N, 2) f32 double-single of W_t * 2^-S (exact power-of-two scaling)."""
    s = _prescale(ctx)
    tab = np.zeros((ctx.n, 2), dtype=np.float32)
    W = 1
    for t in range(ctx.n):
        hi = np.float32(np.ldexp(float(W), -s))
        lo = np.float32(np.ldexp(W - int(math.ldexp(float(np.float64(hi)), s)), -s))
        tab[t, 0], tab[t, 1] = hi, lo
        W *= ctx.moduli[t]
    return tab


def _sym(v: int, p: int) -> int:
    r = v % p
    return r - p if r > (p - 1) // 2 else r


def route_tables(ctx: CRTContext) -> tuple[np.ndarray, np.ndarray]:
    """The host tables of the CUDA kernels' Garner route (`crt_garner.cu`,
    and the megakernels through `garner_tile.cuh`).

    `coef` (N, N) int32: coef[u, t] is the symmetric coefficient of digit u
    in digit t's sum, -g_t M_u mod p_t for u < t and g_t = M_t^-1 mod p_t
    at u = t (of x_t), 0 below the diagonal; M_u = prod_{v<u} p_v.  Then
    d_t = sym_mod(sum_{u<=t} coef[u, t] y_u, p_t) are the balanced
    mixed-radix digits, which are the Garner recursion's.  `split` (N, 2)
    f32: Dekker's split of each weight's high word (`_weight_table`), in
    the reference's f32 op order (core/expansion.py `_split`)."""
    p = ctx.moduli
    radix = [math.prod(p[:u]) for u in range(ctx.n)]  # M_u
    coef = np.zeros((ctx.n, ctx.n), dtype=np.int32)
    for t in range(ctx.n):
        g = pow(radix[t], -1, p[t])
        coef[t, t] = _sym(g, p[t])
        for u in range(t):
            coef[u, t] = _sym(-g * radix[u], p[t])
    hi = _weight_table(ctx)[:, 0]
    c = np.float32(4097.0) * hi
    ah = c - (c - hi)
    return coef, np.stack([ah, hi - ah], axis=1)


def fma_f32(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 operands with ONE rounding, as a fused multiply-add.

    Computed in float64: the product of the f32 weight `a` and the digit `b`
    (|b| <= 127) is exact there, and for the operands of the Garner sum the
    float64 add is exact as well (checked exhaustively for every weight and
    digit in tests/test_torch_kernels.py), so the one rounding is the final
    conversion to f32 — the bits of `__fmaf_rn` and of XLA's contraction.
    """
    return (c.double() + float(a) * b.double()).to(torch.float32)


def garner_digits(planes, ctx):
    """The Garner digits of N f32 residue tensors (exact f32 integer
    arithmetic, all values < 2^17), in the reference's recursion."""
    moduli = ctx.moduli
    digits = []
    for t in range(ctx.n):
        pf, half = float(moduli[t]), float((moduli[t] - 1) // 2)
        r = planes[t]
        for s in range(t):
            r = sym_mod_f32((r - digits[s]) * float(ctx.garner_inv[s, t]), pf, half)
        digits.append(r)
    return digits


def garner_tile(planes, rr, cc, *, ctx, out_dd):
    """Garner digits -> double-single value -> inverse scaling.

    `planes` is a list of N f32 canonical residue tensors of C'; `rr`/`cc`
    the broadcast-ready inverse-scale factor products.  Returns the f32
    value, or the (hi, lo) double-single pair when `out_dd`.
    """
    n = ctx.n
    digits = garner_digits(planes, ctx)
    # --- digits -> value, double-single accumulation, MS digit first ---
    wt = _weight_table(ctx)
    hi = torch.zeros_like(digits[0])
    lo = torch.zeros_like(digits[0])
    for t in range(n - 1, -1, -1):
        w_hi = torch.tensor(wt[t, 0], dtype=torch.float32, device=hi.device)
        ph, pe = ex.two_prod(w_hi, digits[t])
        pe = fma_f32(wt[t, 1], digits[t], pe)  # reference crt_garner.py:89
        hi, lo = ex.dd_add(hi, lo, ph, pe)
    # --- exact inverse power-of-two scaling (folds in 2^S) ---
    if out_dd:
        return hi * rr * cc, lo * rr * cc
    return ((hi + lo) * rr) * cc


def _inverse_scales(e_mu, e_nu, ctx):
    s = _prescale(ctx)
    s_r = s // 2
    r1, r2 = split_scale_exponent(-e_mu.to(torch.int64), bias=s_r)
    c1, c2 = split_scale_exponent(-e_nu.to(torch.int64), bias=s - s_r)
    return r1, r2, c1, c2


def garner_scaled(planes, e_mu, e_nu, ctx, *, out_dd):
    """`garner_tile` with the inverse scaling of exponents (e_mu, e_nu):
    planes of shape (..., m, n) -> the f32 value, or the (hi, lo) pair."""
    r1, r2, c1, c2 = _inverse_scales(e_mu, e_nu, ctx)
    return garner_tile(planes, (r1 * r2)[:, None], (c1 * c2)[None, :], ctx=ctx, out_dd=out_dd)


def crt_garner_plain(e_res, e_mu, e_nu, ctx, *, out_dd):
    """(S, N, m, n) int8 -> (S, m, n) f32 or (S, 2, m, n), in PyTorch."""
    planes = [e_res[:, t].to(torch.float32) for t in range(ctx.n)]
    out = garner_scaled(planes, e_mu, e_nu, ctx, out_dd=out_dd)
    return torch.stack(out, dim=1) if out_dd else out


@functools.cache
def _entry():
    fn = build.library("crt_garner").crt_garner_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def _launch(e_res, e_mu, e_nu, ctx, *, out_dd):
    s, n_mod, m, n = e_res.shape
    r1, r2, c1, c2 = _inverse_scales(e_mu, e_nu, ctx)
    check_tensor("e_res", e_res, torch.int8, (s, ctx.n, m, n))
    for name, t, length in (("r1", r1, m), ("r2", r2, m), ("c1", c1, n), ("c2", c2, n)):
        check_tensor(name, t, torch.float32, (length,))
    shape = (s, 2, m, n) if out_dd else (s, m, n)
    out = torch.empty(shape, dtype=torch.float32, device=e_res.device)
    mod_arr = np.ascontiguousarray(ctx.moduli, dtype=np.int32)
    coef, split = (np.ascontiguousarray(t) for t in route_tables(ctx))
    weights = np.ascontiguousarray(_weight_table(ctx))
    if out.is_meta:  # shapes only: no launch
        return out
    status = _entry()(
        e_res.data_ptr(), r1.data_ptr(), r2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        out.data_ptr(), s, n_mod, m, n, int(out_dd),
        mod_arr.ctypes.data, coef.ctypes.data, weights.ctypes.data, split.ctypes.data,
        torch.cuda.current_stream(e_res.device).cuda_stream,
    )
    build.check_launch("crt_garner", status)
    crt_garner.launches += 1
    return out


def crt_garner(
    e_res: torch.Tensor,
    e_mu: torch.Tensor,
    e_nu: torch.Tensor,
    ctx: CRTContext,
    *,
    out_dd: bool = False,
) -> torch.Tensor:
    """e_res: (N, m, n) or stacked (S, N, m, n) int8 residues of C'; e_mu /
    e_nu: integer scale exponents (shared across the stack).  Returns
    C = C'/(mu nu) as (m, n) f32 or (2, m, n) double-single — with a leading
    (S, ...) dim for stacked input — in one launch either way."""
    stacked = e_res.ndim == 4
    if not stacked:
        e_res = e_res[None]
    if e_res.shape[1] != ctx.n:
        raise ValueError(f"e_res has {e_res.shape[1]} planes, the context {ctx.n}")
    with traced_launch("crt_garner", (e_res, e_mu, e_nu)):
        if on_card(e_res, e_mu, e_nu):
            out = _launch(e_res, e_mu, e_nu, ctx, out_dd=out_dd)
        else:
            out = crt_garner_plain(e_res, e_mu, e_nu, ctx, out_dd=out_dd)
    return out if stacked else out[0]


crt_garner.launches = 0
