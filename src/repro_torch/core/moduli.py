"""Moduli selection and CRT constants for the Ozaki-II scheme.

The port's copy of `repro.core.moduli`, cut to the fields the kernel path
reads.  N pairwise-coprime *odd* moduli p_l <= 255 keep every symmetric
residue within |r| <= (p-1)/2 <= 127, so residues fit int8.  All big-integer
constants are exact Python ints computed on the host; the Garner tables are
small numpy arrays.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

MAX_MODULI = 24
# int8 residue products |r_a * r_b| <= 127^2; int32 accumulates exactly for
# k <= 2^31 / 127^2 ~= 133152.  The executor chunks K above this.
K_CHUNK_LIMIT = 1 << 17


def _pairwise_coprime_moduli(count: int) -> list[int]:
    """Greedy descending odd pairwise-coprime moduli <= 255."""
    chosen: list[int] = []
    cand = 255
    while len(chosen) < count and cand >= 3:
        if all(math.gcd(cand, c) == 1 for c in chosen):
            chosen.append(cand)
        cand -= 2
    if len(chosen) < count:
        raise ValueError(f"cannot find {count} pairwise-coprime odd moduli <= 255")
    return chosen


@functools.lru_cache(maxsize=None)
def default_moduli(n: int) -> tuple[int, ...]:
    if not 1 <= n <= MAX_MODULI:
        raise ValueError(f"N must be in [1, {MAX_MODULI}], got {n}")
    return tuple(_pairwise_coprime_moduli(n))


@dataclasses.dataclass(frozen=True)
class CRTContext:
    """Constants of an N-moduli instance that the kernel path reads."""

    n: int
    moduli: tuple[int, ...]   # p_l
    P: int                    # prod p_l (exact Python int)
    log2_P: float             # log2(P), drives the scaling exponents
    garner_inv: np.ndarray    # (N, N) int32: inverse of p_s modulo p_t (s < t), else 0
    moduli_arr: np.ndarray    # (N,) int32
    half_arr: np.ndarray      # (N,) int32, (p_l - 1) // 2


@functools.lru_cache(maxsize=None)
def make_crt_context(n: int) -> CRTContext:
    """The constants of the first n default moduli."""
    p = default_moduli(n)
    P = math.prod(p)
    # the reference keeps P as an exact 3-term f64 expansion and refuses
    # larger products; the same limit holds here so both accept the same N
    if _needs_fourth_term(P):
        raise ValueError("P needs more than 159 bits; reduce N")

    garner_inv = np.zeros((n, n), dtype=np.int32)
    for t in range(n):
        for s in range(t):
            garner_inv[s, t] = pow(p[s], -1, p[t])

    return CRTContext(
        n=n,
        moduli=p,
        P=P,
        log2_P=_log2_bigint(P),
        garner_inv=garner_inv,
        moduli_arr=np.asarray(p, dtype=np.int32),
        half_arr=np.asarray([(pl - 1) // 2 for pl in p], dtype=np.int32),
    )


def _needs_fourth_term(P: int) -> bool:
    """True when a greedy peel of 53-bit chunks leaves a remainder after
    three terms (the reference's `P_exp` construction)."""
    rem = P
    for _ in range(3):
        shift = max(0, rem.bit_length() - 53)
        rem -= (rem >> shift) << shift
        if rem == 0:
            return False
    return True


def _log2_bigint(x: int) -> float:
    top = x.bit_length()
    if top <= 53:
        return math.log2(x)
    shift = top - 53
    return math.log2(x >> shift) + shift
