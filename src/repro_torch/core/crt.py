"""CRT reconstruction (Alg. 1 steps V-v/vi): three interchangeable paths.

The port's copy of `repro.core.crt`, the reconstructions of the reference
execution:

paper   : the paper's eq. (5) unevaluated split S = S1 + S2, S1 summing the
          exact high parts of w_l = (P/p_l) q_l and S2 the rounded low
          parts, then mod(S, P) in double-double with P as an exact 3-term
          expansion.
dd      : full double-double accumulation of w_l * E_l.
garner  : mixed-radix (Garner) digits in small-integer arithmetic, summed
          in double-double.

All paths take E: (N, ...) int8/int32 symmetric residues of C' and return
the value of C' as a double-double pair (hi, lo) in float64.  Every float64
expression is built from separate *, + and - tensor ops in the reference's
order (no op that may contract into a fused multiply-add), so the results
are the reference's op-by-op bits on the CPU and on the card.  The
constants enter as Python floats, whose arithmetic rounds as float64's
(no host-to-device copy per constant).  Each plane is widened to float64
when it is read, not the whole stack at once.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .expansion import dd_add, two_prod
from .moduli import CRTContext
from .residues import num_limbs_for_bits, residues_from_quantized, sym_mod_int32, sym_mod_small
from .scaling import exp2_vector

_F64 = torch.float64


def reconstruct_paper(e_res: torch.Tensor, ctx: CRTContext):
    """Paper eq. (5): S1 (exact) + S2 (low parts), then mod(S, P) in dd."""
    s1 = torch.zeros(e_res.shape[1:], dtype=_F64, device=e_res.device)
    s2 = torch.zeros_like(s1)
    for l in range(ctx.n):  # fixed-order accumulation => bitwise reproducible
        ef = e_res[l].to(_F64)
        s1 = s1 + float(ctx.w_hi[l]) * ef
        s2 = s2 + float(ctx.w_lo[l]) * ef
    return _mod_P_dd(s1, s2, ctx)


def reconstruct_dd(e_res: torch.Tensor, ctx: CRTContext):
    """Full double-double accumulation (beyond-paper precision)."""
    hi = torch.zeros(e_res.shape[1:], dtype=_F64, device=e_res.device)
    lo = torch.zeros_like(hi)
    for l in range(ctx.n):
        ef = e_res[l].to(_F64)
        ph, pl = two_prod(float(ctx.w_dd_hi[l]), ef)
        pl = pl + float(ctx.w_dd_lo[l]) * ef
        hi, lo = dd_add(hi, lo, ph, pl)
    return _mod_P_dd(hi, lo, ctx)


def _mod_P_dd(s_hi, s_lo, ctx: CRTContext):
    """mod(S, P) = S - P*round(S/P), P held as an exact 3-term expansion.

    |S/P| < 2^15, so z = round(S/P) is a small exact integer; each P_t * z
    is formed with two_prod (error-free) and subtracted in double-double.
    """
    z = torch.round(s_hi / float(ctx.P))
    hi, lo = s_hi, s_lo
    for t in range(3):
        pt = float(ctx.P_exp[t])
        if pt == 0.0:
            continue
        ph, pl = two_prod(pt, z)
        hi, lo = dd_add(hi, lo, -ph, -pl)
    # one correction step in case round(S/P) was off by one; the compare
    # runs in double-double (results within one ulp of +/- P/2)
    hh = float(ctx.P_exp[0]) / 2.0  # exact (power-of-two division)
    hl = (float(ctx.P_exp[1]) + float(ctx.P_exp[2])) / 2.0
    dpos_hi, dpos_lo = dd_add(hi, lo, -hh, -hl)  # result - P/2
    dneg_hi, dneg_lo = dd_add(hi, lo, hh, hl)    # result + P/2
    pos = (dpos_hi > 0) | ((dpos_hi == 0) & (dpos_lo > 0))
    neg = (dneg_hi < 0) | ((dneg_hi == 0) & (dneg_lo < 0))
    adj = torch.where(pos, -1.0, torch.where(neg, 1.0, 0.0)).to(_F64)
    for t in range(3):
        pt = float(ctx.P_exp[t])
        if pt == 0.0:
            continue
        ph, pl = two_prod(pt, adj)
        hi, lo = dd_add(hi, lo, ph, pl)
    return hi, lo


def garner_digits(e_res: torch.Tensor, ctx: CRTContext) -> torch.Tensor:
    """Symmetric mixed-radix digits d_t, C' = sum_t d_t * prod_{s<t} p_s.

    Small-integer arithmetic: |(r - d_s) * inv| <= 254*254 < 2^16.
    """
    e32 = e_res.to(torch.int32)
    digits = []
    for t in range(ctx.n):
        p_t = int(ctx.moduli_arr[t])
        half_t = int(ctx.half_arr[t])
        r = e32[t]
        for s in range(t):
            r = (r - digits[s]) * int(ctx.garner_inv[s, t])
            r = sym_mod_small(r, p_t, half_t).to(torch.int32)
        digits.append(r)
    return torch.stack(digits, dim=0)


def reconstruct_garner(e_res: torch.Tensor, ctx: CRTContext):
    """Garner digits -> double-double value (exact digits; dd conversion)."""
    digits = garner_digits(e_res, ctx)
    hi = torch.zeros(e_res.shape[1:], dtype=_F64, device=e_res.device)
    lo = torch.zeros_like(hi)
    for t in range(ctx.n - 1, -1, -1):  # most-significant first
        d = digits[t].to(_F64)
        wh, wl = float(ctx.weights_dd[t, 0]), float(ctx.weights_dd[t, 1])
        ph, pl = two_prod(wh, d)
        pl = pl + wl * d
        hi, lo = dd_add(hi, lo, ph, pl)
    return hi, lo


RECONSTRUCTORS = {
    "paper": reconstruct_paper,
    "dd": reconstruct_dd,
    "garner": reconstruct_garner,
}


def reconstruct(e_res: torch.Tensor, ctx: CRTContext, method: str = "paper"):
    try:
        fn = RECONSTRUCTORS[method]
    except KeyError:
        raise ValueError(f"unknown reconstruction {method!r}") from None
    return fn(e_res, ctx)


def inverse_scale(hi, lo, e_mu, e_nu, out_dtype):
    """C = diag(mu)^-1 C' diag(nu)^-1, exact (powers of two).  The factor is
    the reference's `jnp.ldexp(1.0, -(e_mu + e_nu))` (`exp2_vector`: exact,
    +inf above 2^1023, +0.0 below 2^-1022)."""
    inv = exp2_vector(-(e_mu.to(torch.int64)[:, None] + e_nu.to(torch.int64)[None, :]))
    return ((hi * inv) + (lo * inv)).to(out_dtype)


# ============================== partial (sharded) reconstruction support
#
# A device holding only a SUBSET of the N residue planes can accumulate its
# planes' share of the eq. (5) linear form S = sum_l w_l E_l exactly, in an
# unevaluated multi-part f64 split: w_l is cut at fixed absolute bit
# positions into parts of at most 53 - 7 - ceil(log2 N) bits, so every
# product and every partial or total sum of them is an exact f64 integer,
# and a sum over devices is bitwise order-independent.  Since w_l === delta_li
# (mod p_i), the full S satisfies S === E_i (mod p_i), so after the sum each
# device re-derives the complete residue planes in small-integer arithmetic
# (`residues_from_partial`) and hands them to an ordinary reconstructor.


@functools.lru_cache(maxsize=None)
def partial_split(moduli: tuple[int, ...]):
    """Exact multi-part split of the eq. (5) weights for partial combines.

    Returns ``(u, radix, part_bits)``: ``u`` (n_parts, N) f64 with
    ``w_l == sum_j u[j, l] * 2**(j*part_bits)`` exactly; ``radix``
    (n_parts, N) int32, the symmetric residues of ``2**(j*part_bits) mod
    p_l``; ``part_bits`` = 53 - 7 - ceil(log2 N), so ``sum_l u[j, l] * E_l``
    over all N planes stays below 2^53.
    """
    n = len(moduli)
    P = math.prod(moduli)
    ws = [(P // p) * pow((P // p) % p, -1, p) for p in moduli]
    part_bits = 53 - 7 - max(1, math.ceil(math.log2(max(n, 2))))
    n_parts = max(1, -(-max(w.bit_length() for w in ws) // part_bits))
    u = np.zeros((n_parts, n), dtype=np.float64)
    radix = np.zeros((n_parts, n), dtype=np.int32)
    mask = (1 << part_bits) - 1
    for l, (w, p) in enumerate(zip(ws, moduli)):
        half = (p - 1) // 2
        for j in range(n_parts):
            u[j, l] = float((w >> (j * part_bits)) & mask)
            r = pow(2, j * part_bits, p)
            radix[j, l] = r - p if r > half else r
    return u, radix, part_bits


def partial_combine(e_res: torch.Tensor, u) -> torch.Tensor:
    """(..., N_local, m, n) int8 planes -> (..., n_parts, m, n) f64 partials.

    ``u`` is this shard's (n_parts, N_local) column slice of the
    `partial_split` table.  Every product and sum is an exact f64 integer
    by the part_bits budget, so any summation order gives the same bits.
    """
    ef = e_res.to(_F64)
    u = torch.as_tensor(np.asarray(u), dtype=_F64, device=ef.device)
    # contract the plane axis (third from last) against u's columns
    return torch.movedim(torch.tensordot(u, torch.movedim(ef, -3, 0), dims=([1], [0])), 0, -3)


def residues_from_partial(t_parts: torch.Tensor, ctx: CRTContext) -> torch.Tensor:
    """Exact f64 partial sums (n_parts, ...) -> full (N, ...) int8 residues.

    ``t_parts[j] == sum_l u[j, l] * E_l`` summed over ALL planes.  Rebuilds
    E_i = sym_mod(sum_j t_j 2^(j*part_bits), p_i) in small exact integer
    arithmetic: each t_j (< 2^53) goes through the standard residue
    decomposition and combines with the radix residues.
    """
    u, radix, _ = partial_split(ctx.moduli)
    nl = num_limbs_for_bits(53.0)
    acc = None
    for j in range(u.shape[0]):
        planes = residues_from_quantized(t_parts[j], ctx, nl).to(torch.int32)
        r = torch.as_tensor(radix[j], device=t_parts.device).reshape((ctx.n,) + (1,) * (t_parts.ndim - 1))
        term = planes * r  # |term| <= 127^2
        acc = term if acc is None else acc + term
    # |acc| <= n_parts * 127^2 << 2^31: exact final symmetric reduction
    outs = [sym_mod_int32(acc[l], int(p)) for l, p in enumerate(ctx.moduli)]
    return torch.stack(outs, dim=0).to(torch.int8)
