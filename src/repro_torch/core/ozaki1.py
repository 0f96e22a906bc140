"""Ozaki-I scheme (the paper's comparison baseline, SIV: 'OS I-S').

The port's copy of `repro.core.ozaki1`.  Error-free slicing emulation on
int8 engines (Ootomo-Ozaki-Yokota [27] / cuBLAS 'Fixed Mantissa Control'
family): row/col-normalize to [0.5, 1), peel S signed 7-bit mantissa
slices per operand, and accumulate the S(S+1)/2 cross products with
i + j < S on the int8 engine:

    C ~= sum_{i+j < S} 2^{-7(i+j+2)} A_i B_j .

Versus Ozaki-II with N moduli (N int8 GEMMs), Ozaki-I needs S(S+1)/2, the
quadratic-vs-linear gap behind the paper's SIV-B throughput results.  The
complex variant uses the same Karatsuba trick (3 real emulations).

Every float64 op runs in the reference's order, so the result is its
bits.  Each cross product is one exact int8 x int8 -> int32 product
(`int8_product`): on the card `torch._int_mm`, cuBLASLt's int8 tensor-core
GEMM, on the CPU `intmul.int8_matmul`.  An exact integer is the same
whichever engine computes it.
"""
from __future__ import annotations

import torch

from .executor import resolve_device
from .intmul import int8_matmul
from .moduli import K_CHUNK_LIMIT
from .scaling import exp2_vector, ilogb

SLICE_BITS = 7
_F64 = torch.float64
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) int8 -> int32, exact.  On a CUDA tensor one
    `torch._int_mm`, the operands zero-padded to what it takes (m above 16,
    k and n multiples of 8; zeros add nothing) and B column-major (with a
    row-major B cuBLASLt has no int8 kernel for some m, 17-48 among them,
    on the H100), counted in ``int8_product.int_mm_calls``; on the CPU
    `int8_matmul`."""
    if a.shape[-1] > K_CHUNK_LIMIT:
        raise ValueError(f"k={a.shape[-1]} exceeds exact-int32 limit {K_CHUNK_LIMIT}; chunk K")
    if a.device.type != "cuda":
        return int8_matmul(a, b)
    (m, k), n = a.shape, b.shape[-1]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    int8_product.int_mm_calls += 1
    return torch._int_mm(a, b)[:m, :n]


int8_product.int_mm_calls = 0


def _slices(x: torch.Tensor, n_slices: int) -> list[torch.Tensor]:
    """Peel signed 7-bit slices of |x| < 1: x ~= sum_t q_t 2^{-7(t+1)}."""
    out = []
    r = x
    for t in range(n_slices):
        scale = 2.0 ** (SLICE_BITS * (t + 1))
        q = torch.trunc(r * scale)  # |q| <= 127 by normalization
        r = r - q / scale
        out.append(q.to(torch.int8))
    return out


def _gemm_2d(a: torch.Tensor, b: torch.Tensor, n_slices: int, out_dtype: torch.dtype) -> torch.Tensor:
    a64 = a.to(_F64)
    b64 = b.to(_F64)
    amax = torch.amax(torch.abs(a64), dim=1)
    bmax = torch.amax(torch.abs(b64), dim=0)
    one = torch.ones((), dtype=_F64, device=a.device)
    e_mu = -(ilogb(torch.where(amax > 0, amax, one)) + 1)
    e_nu = -(ilogb(torch.where(bmax > 0, bmax, one)) + 1)
    an = a64 * exp2_vector(e_mu)[:, None]   # rows in [0.5, 1)
    bn = b64 * exp2_vector(e_nu)[None, :]
    asl = _slices(an, n_slices)
    bsl = _slices(bn, n_slices)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=_F64, device=a.device)
    # low-order first so the final additions are the significant ones
    for s in range(n_slices - 1, -1, -1):  # s = i + j
        part = torch.zeros_like(acc)
        for i in range(s + 1):
            j = s - i
            part = part + int8_product(asl[i], bsl[j]).to(_F64)
        acc = acc + part * 2.0 ** (-SLICE_BITS * (s + 2))
    inv = exp2_vector(-e_mu)[:, None] * exp2_vector(-e_nu)[None, :]
    return (acc * inv).to(out_dtype)


def _gemm(a: torch.Tensor, b: torch.Tensor, n_slices: int, out_dtype: torch.dtype) -> torch.Tensor:
    """`_gemm_2d` over the broadcast leading dims of a and b, one matrix
    pair at a time (the reference's `jnp.vectorize`)."""
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"ozaki1 expects matrix operands; got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if not lead:
        return _gemm_2d(a, b, n_slices, out_dtype)
    a = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = [_gemm_2d(x, y, n_slices, out_dtype) for x, y in zip(a, b)]
    return torch.stack(out).reshape(lead + out[0].shape)


def _operands(a, b, device):
    device = resolve_device(device)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


def ozaki1_gemm(a, b, n_slices: int = 8, out_dtype=None, *, device=None) -> torch.Tensor:
    """Emulated real GEMM, Ozaki-I with S slices: S(S+1)/2 int8 GEMMs.
    a: (..., m, k), b: (..., k, n), tensors or arrays moved to `device`
    (None: the card)."""
    a, b = _operands(a, b, device)
    return _gemm(a, b, int(n_slices), out_dtype or a.dtype)


def ozaki1_cgemm(a, b, n_slices: int = 8, out_dtype=None, *, device=None) -> torch.Tensor:
    """Complex Ozaki-I via Karatsuba: 3 real emulations (paper SIV-B)."""
    a, b = _operands(a, b, device)
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _REAL:
        raise TypeError(f"ozaki1_cgemm computes complex64 or complex128, not {out_dtype}")
    n_slices = int(n_slices)
    ar, ai = a.real.to(_F64), a.imag.to(_F64)
    br, bi = b.real.to(_F64), b.imag.to(_F64)
    d = _gemm(ar, br, n_slices, _F64)
    e = _gemm(ai, bi, n_slices, _F64)
    f = _gemm(ar + ai, br + bi, n_slices, _F64)
    cr = (d - e).to(_REAL[out_dtype])
    ci = (f - d - e).to(_REAL[out_dtype])
    return torch.complex(cr, ci)


def int8_gemm_count(n_slices: int) -> int:
    return n_slices * (n_slices + 1) // 2
