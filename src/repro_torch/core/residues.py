"""Residue helpers shared by the kernel path (Alg. 1 steps V-i/iv).

The port's copy of the parts of `repro.core.residues` that the kernel
execution reads: the limb count and the exact symmetric mod of integers.
"""
from __future__ import annotations

import math

import torch

LIMB_BITS = 24


def num_limbs_for_bits(bits: float) -> int:
    """Limbs needed to hold |a'| <= 2^bits."""
    return max(1, math.ceil((bits + 1) / LIMB_BITS))


def sym_mod_int32(v: torch.Tensor, p) -> torch.Tensor:
    """Exact symmetric mod of integer tensors into [-(p-1)/2, (p-1)/2].

    `p` is an int or an integer tensor broadcast against `v` (one modulus
    per residue plane).  Returns the dtype of `v`.
    """
    r = torch.remainder(v, p)  # in [0, p)
    return torch.where(r > (p - 1) // 2, r - p, r)
