"""Exact int8 x int8 -> int32 matrix product outside the kernels.

Used by the accu scaling's auxiliary product `cbar = abar @ bbar` (paper
eqs. 13-14) and by the plain versions of the GEMM kernels.  Entries are
int8, so for k <= 2^17 every partial sum is an integer below
127^2 * 2^17 < 2^53 and a float64 matmul is exact on the CPU and on the
card alike (the card has no int32 matmul).
"""
from __future__ import annotations

import torch

from .moduli import K_CHUNK_LIMIT


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) x (..., k, n) int8 -> int32, exact."""
    if a.shape[-1] > K_CHUNK_LIMIT:
        raise ValueError(
            f"k={a.shape[-1]} exceeds exact-int32 limit {K_CHUNK_LIMIT}; chunk K"
        )
    return torch.matmul(a.double(), b.double()).to(torch.int32)
