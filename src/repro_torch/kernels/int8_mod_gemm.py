"""Modulus-batched int8 residue GEMM with a symmetric-mod epilogue.

Port of `repro.kernels.int8_mod_gemm.int8_mod_gemm_batched` (Alg. 1 steps
V-iii/iv for all N moduli in one launch).  The optional `carry` (N, m, n)
int8 residue stack is folded into the epilogue reduction,
out = sym_mod(acc + carry, p): K-chunked products thread the previous
chunk's residues through it.

On CUDA tensors `int8_mod_gemm_batched` launches `csrc/int8_mod_gemm.cu`;
on CPU tensors it runs `int8_mod_gemm_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.intmul import int8_matmul
from . import build
from .common import check_tensor, on_card, plane_mod_params, sym_mod_int32_dyn


def int8_mod_gemm_plain(a, b, *, moduli, carry=None):
    """The kernel's function in PyTorch: the exact product, + carry, and the
    reference's 16-bit-split f32 symmetric mod (`sym_mod_int32_dyn`)."""
    acc = int8_matmul(a, b)
    if carry is not None:
        acc = acc + carry.to(torch.int32)
    pf, half, m16 = plane_mod_params(moduli, a.device)
    return sym_mod_int32_dyn(acc, pf, half, m16).to(torch.int8)


@functools.cache
def _entry():
    fn = build.library("int8_mod_gemm").int8_mod_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b, *, moduli, carry=None):
    n_mod, m, k = a.shape
    n = b.shape[-1]
    check_tensor("a", a, torch.int8, (n_mod, m, k))
    check_tensor("b", b, torch.int8, (n_mod, k, n))
    if carry is not None:
        check_tensor("carry", carry, torch.int8, (n_mod, m, n))
    out = torch.empty((n_mod, m, n), dtype=torch.int8, device=a.device)
    mod_arr = np.ascontiguousarray(moduli, dtype=np.int32)
    status = _entry()(
        a.data_ptr(), b.data_ptr(), None if carry is None else carry.data_ptr(),
        out.data_ptr(), n_mod, m, n, k, mod_arr.ctypes.data,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check_launch("int8_mod_gemm", status)
    int8_mod_gemm_batched.launches += 1
    return out


def int8_mod_gemm_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: torch.Tensor | None = None,
) -> torch.Tensor:
    """E_l = sym_mod(A_l @ B_l [+ carry_l], p_l) for all l in ONE launch.

    a: (N, m, k) int8, b: (N, k, n) int8, carry: optional (N, m, n) int8;
    returns (N, m, n) int8 residues.  Any m/n/k is accepted; k <= 2^17.
    """
    n_mod, m, k = a.shape
    moduli = tuple(int(p) for p in moduli)
    if b.ndim != 3 or b.shape[0] != n_mod or b.shape[1] != k or len(moduli) != n_mod:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, N={len(moduli)}")
    if k > (1 << 17):
        raise ValueError(f"k={k} exceeds the exact-int32 limit 2^17; chunk K")
    tensors = (a, b) if carry is None else (a, b, carry)
    if on_card(*tensors):
        return _launch(a, b, moduli=moduli, carry=carry)
    return int8_mod_gemm_plain(a, b, moduli=moduli, carry=carry)


int8_mod_gemm_batched.launches = 0
