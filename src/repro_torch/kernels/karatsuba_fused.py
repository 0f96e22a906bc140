"""Modulus-batched fused-Karatsuba residue GEMM.

Port of `repro.kernels.karatsuba_fused.karatsuba_mod_gemm_batched`, the
paper's complex workhorse: the three Karatsuba products D = AR.BR,
E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p) run in one launch for all N
planes, and the epilogue emits CR = D - E and CI = F - D - E (mod p), with
an optional (CR, CI) carry folded in (K-chunk combine).

On CUDA tensors `karatsuba_mod_gemm_batched` launches
`csrc/karatsuba_fused.cu`; on CPU tensors it runs
`karatsuba_mod_gemm_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.intmul import int8_matmul
from . import build
from .common import check_tensor, on_card, plane_mod_params, sym_mod_f32, sym_mod_int32_dyn


def karatsuba_mod_gemm_plain(ar, ai, br, bi, *, moduli, carry=None):
    """The kernel's function in PyTorch, in the op order of the reference's
    kernel body (exact f32 residue arithmetic around exact products)."""
    pf, half, m16 = plane_mod_params(moduli, ar.device)
    asum = sym_mod_f32(ar.float() + ai.float(), pf, half).to(torch.int8)
    bsum = sym_mod_f32(br.float() + bi.float(), pf, half).to(torch.int8)
    dr = sym_mod_int32_dyn(int8_matmul(ar, br), pf, half, m16)
    de = sym_mod_int32_dyn(int8_matmul(ai, bi), pf, half, m16)
    df = sym_mod_int32_dyn(int8_matmul(asum, bsum), pf, half, m16)
    cr = dr - de
    ci = df - dr - de
    if carry is not None:
        cr = cr + carry[0].float()
        ci = ci + carry[1].float()
    return (
        sym_mod_f32(cr, pf, half).to(torch.int8),
        sym_mod_f32(ci, pf, half).to(torch.int8),
    )


@functools.cache
def _entry():
    fn = build.library("karatsuba_fused").karatsuba_mod_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _launch(ar, ai, br, bi, *, moduli, carry=None):
    n_mod, m, k = ar.shape
    n = br.shape[-1]
    for name, t in (("ar", ar), ("ai", ai)):
        check_tensor(name, t, torch.int8, (n_mod, m, k))
    for name, t in (("br", br), ("bi", bi)):
        check_tensor(name, t, torch.int8, (n_mod, k, n))
    carry_ptrs = (None, None)
    if carry is not None:
        for name, t in zip(("carry_r", "carry_i"), carry):
            check_tensor(name, t, torch.int8, (n_mod, m, n))
        carry_ptrs = tuple(t.data_ptr() for t in carry)
    cr = torch.empty((n_mod, m, n), dtype=torch.int8, device=ar.device)
    ci = torch.empty_like(cr)
    mod_arr = np.ascontiguousarray(moduli, dtype=np.int32)
    status = _entry()(
        ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(), *carry_ptrs,
        cr.data_ptr(), ci.data_ptr(), n_mod, m, n, k, mod_arr.ctypes.data,
        torch.cuda.current_stream(ar.device).cuda_stream,
    )
    build.check_launch("karatsuba_fused", status)
    karatsuba_mod_gemm_batched.launches += 1
    return cr, ci


def karatsuba_mod_gemm_batched(
    ar: torch.Tensor,
    ai: torch.Tensor,
    br: torch.Tensor,
    bi: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Residues of (CR', CI') = (AR'+iAI')(BR'+iBI') mod p_l, all planes in
    ONE launch.  Inputs (N, m, k) / (N, k, n) int8 stacks; `carry` is an
    optional (CR, CI) pair of (N, m, n) int8 residues folded into the
    epilogue.  Any m/n/k is accepted; k <= 2^17."""
    n_mod, m, k = ar.shape
    moduli = tuple(int(p) for p in moduli)
    if (
        ai.shape != ar.shape
        or br.shape != bi.shape
        or br.ndim != 3
        or tuple(br.shape[:2]) != (n_mod, k)
        or len(moduli) != n_mod
    ):
        raise ValueError(
            f"shape mismatch: ar {tuple(ar.shape)}, ai {tuple(ai.shape)}, "
            f"br {tuple(br.shape)}, bi {tuple(bi.shape)}, N={len(moduli)}"
        )
    if k > (1 << 17):
        raise ValueError(f"k={k} exceeds the exact-int32 limit 2^17; chunk K")
    tensors = (ar, ai, br, bi) + (() if carry is None else tuple(carry))
    if on_card(*tensors):
        return _launch(ar, ai, br, bi, moduli=moduli, carry=carry)
    return karatsuba_mod_gemm_plain(ar, ai, br, bi, moduli=moduli, carry=carry)


karatsuba_mod_gemm_batched.launches = 0
