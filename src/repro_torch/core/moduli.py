"""Moduli selection and CRT constants for the Ozaki-II scheme.

The port's copy of `repro.core.moduli`.  N pairwise-coprime *odd* moduli
p_l <= 255 keep every symmetric residue within |r| <= (p-1)/2 <= 127, so
residues fit int8.  All big-integer constants are exact Python ints
computed on the host; the reconstruction tables (eq. (5) splits,
double-double weights, P's 3-term expansion, Garner inverses) are small
numpy arrays.  Custom moduli go through every plain-PyTorch path; on the
card the residue cast and the megakernels refuse moduli outside odd 5..255
(`csrc/residue_fma.cuh`, `fma_moduli_ok`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

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


def _split_fp64_at(x: int, cutpos: int) -> tuple[float, float]:
    """Split an exact integer x into (hi, lo) doubles at absolute bit
    position `cutpos` (paper eq. (5): s_l1 / s_l2).

    Splitting every w_l at the SAME absolute position makes all S1 products
    multiples of 2^cutpos, so the N-term accumulation spans exactly 53 bits
    and is error-free.
    """
    if x == 0:
        return 0.0, 0.0
    shift = max(0, cutpos)
    hi_int = (x >> shift) << shift
    hi = float(hi_int)  # exact: <= 53-7-ceil(log2 N) significant bits
    lo = float(x - hi_int)  # rounded to nearest double (|err| <= 2^(cut-53))
    return hi, lo


def _dd_from_int(x: int) -> tuple[float, float]:
    """Round an exact integer to a double-double (hi, lo) pair."""
    hi = float(x)
    lo = float(x - int(hi))
    return hi, lo


@dataclasses.dataclass(frozen=True)
class CRTContext:
    """Precomputed constants of an N-moduli Ozaki-II instance: Python
    scalars and small numpy arrays, nothing data-dependent."""

    n: int
    moduli: tuple[int, ...]   # p_l
    P: int                    # prod p_l (exact Python int)
    log2_P: float             # log2(P), drives the scaling exponents
    # paper eq. (5): w_l = (P/p_l) q_l split at one absolute bit position
    w_hi: np.ndarray          # (N,) f64, exact top bits of w_l
    w_lo: np.ndarray          # (N,) f64
    # w_l rounded to double-double (the 'dd' reconstruction)
    w_dd_hi: np.ndarray       # (N,) f64
    w_dd_lo: np.ndarray       # (N,) f64
    P_exp: np.ndarray         # (3,) f64, P = sum(P_exp) exactly
    garner_inv: np.ndarray    # (N, N) int32: inverse of p_s modulo p_t (s < t), else 0
    weights_dd: np.ndarray    # (N, 2) f64: W_t = prod_{s<t} p_s as double-double
    moduli_arr: np.ndarray    # (N,) int32
    half_arr: np.ndarray      # (N,) int32, (p_l - 1) // 2

    @property
    def p_half(self) -> float:
        return float(self.P) / 2.0


def make_crt_context(n: int, moduli: Sequence[int] | None = None) -> CRTContext:
    """The constants of `moduli` (default: the first n default moduli),
    which must be n pairwise-coprime odd integers <= 255."""
    return _crt_context(int(n), None if moduli is None else tuple(int(p) for p in moduli))


@functools.lru_cache(maxsize=None)
def _crt_context(n: int, moduli: tuple[int, ...] | None) -> CRTContext:
    p = moduli if moduli is not None else default_moduli(n)
    if len(p) != n:
        raise ValueError("len(moduli) != n")
    for i in range(n):
        for j in range(i + 1, n):
            if math.gcd(p[i], p[j]) != 1:
                raise ValueError(f"moduli {p[i]}, {p[j]} not coprime")
        if p[i] % 2 == 0 or p[i] > 255:
            raise ValueError("moduli must be odd and <= 255")
    P = math.prod(p)

    # w_l = (P / p_l) * q_l with q_l = (P/p_l)^{-1} mod p_l  (Alg. 1 step II)
    ws = [(P // pl) * pow((P // pl) % pl, -1, pl) for pl in p]
    # symmetric-mod residues are 7-bit => hi part may keep 53-7-ceil(log2 N)
    hi_bits = 53 - 7 - max(1, math.ceil(math.log2(max(n, 2))))
    cutpos = max(w.bit_length() for w in ws) - hi_bits
    w_hi, w_lo = (np.asarray(v, dtype=np.float64) for v in zip(*(_split_fp64_at(w, cutpos) for w in ws)))
    w_dd_hi, w_dd_lo = (np.asarray(v, dtype=np.float64) for v in zip(*(_dd_from_int(w) for w in ws)))

    # P as an exact 3-term expansion (greedy peel of the top 53 bits)
    P_exp = np.zeros(3, dtype=np.float64)
    rem = P
    for t in range(3):
        shift = max(0, rem.bit_length() - 53)
        vi = (rem >> shift) << shift
        P_exp[t] = float(vi)
        rem -= vi
        if rem == 0:
            break
    if rem != 0:
        raise ValueError("P needs more than 159 bits; reduce N")

    garner_inv = np.zeros((n, n), dtype=np.int32)
    for t in range(n):
        for s in range(t):
            garner_inv[s, t] = pow(p[s], -1, p[t])

    weights_dd = np.asarray([_dd_from_int(math.prod(p[:t])) for t in range(n)], dtype=np.float64)

    return CRTContext(
        n=n,
        moduli=p,
        P=P,
        log2_P=_log2_bigint(P),
        w_hi=w_hi,
        w_lo=w_lo,
        w_dd_hi=w_dd_hi,
        w_dd_lo=w_dd_lo,
        P_exp=P_exp,
        garner_inv=garner_inv,
        weights_dd=weights_dd,
        moduli_arr=np.asarray(p, dtype=np.int32),
        half_arr=np.asarray([(pl - 1) // 2 for pl in p], dtype=np.int32),
    )


def _log2_bigint(x: int) -> float:
    top = x.bit_length()
    if top <= 53:
        return math.log2(x)
    shift = top - 53
    return math.log2(x >> shift) + shift


def min_moduli_for_bits(bits: float) -> int:
    """Smallest N whose product exceeds 2^bits."""
    for n in range(1, MAX_MODULI + 1):
        if make_crt_context(n).log2_P > bits:
            return n
    raise ValueError(f"cannot reach {bits} bits with {MAX_MODULI} moduli")
