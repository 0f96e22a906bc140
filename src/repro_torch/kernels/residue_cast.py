"""Residue cast: scale -> trunc -> limb split -> N int8 residue planes.

Port of `repro.kernels.residue_cast` (Alg. 1 steps IV + V-i/ii in one pass
over the input).  A (S, m, k) input casts S same-shaped matrices sharing one
scale vector in one launch — the complex pipeline stacks the real and
imaginary parts of an operand.  2D inputs are treated as S=1 and squeezed.

On a CUDA tensor `residue_cast` launches `csrc/residue_cast.cu`, whose
division-free residues (`csrc/residue_fma.cuh`) are exact for odd moduli
5 <= p <= 255: the card path raises on any other modulus, as the kernel's C
entry does.  On a CPU tensor it runs `residue_cast_plain`, the same op
sequence in PyTorch, for any modulus.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .common import check_tensor, limb_radix_f32, on_card, residue_tiles_f32, traced_launch


def residue_cast_plain(a, scale1, scale2, *, moduli, n_limbs, scale_axis):
    """(S, m, k) f32 -> (S, N, m, k) int8 canonical residues, in PyTorch."""
    tiles = residue_tiles_f32(
        a, scale1, scale2, moduli=moduli, n_limbs=n_limbs, scale_axis=scale_axis
    )
    return torch.stack(tiles, dim=1).to(torch.int8)


@functools.cache
def _entry():
    fn = build.library("residue_cast").residue_cast_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _launch(a, scale1, scale2, *, moduli, n_limbs, scale_axis):
    s, m, k = a.shape
    n_mod = len(moduli)
    bad = [p for p in moduli if not (5 <= p <= 255 and p % 2 == 1)]
    if bad:
        raise ValueError(f"residue_cast on the card takes odd moduli 5 <= p <= 255, got {bad}")
    check_tensor("a", a, torch.float32, (s, m, k))
    slen = m if scale_axis == 0 else k
    check_tensor("scale1", scale1, torch.float32, (slen,))
    check_tensor("scale2", scale2, torch.float32, (slen,))
    out = torch.empty((s, n_mod, m, k), dtype=torch.int8, device=a.device)
    mod_arr = np.ascontiguousarray(moduli, dtype=np.int32)
    radix = np.ascontiguousarray(limb_radix_f32(moduli, n_limbs))
    if out.is_meta:  # shapes only: no launch
        return out
    status = _entry()(
        a.data_ptr(), scale1.data_ptr(), scale2.data_ptr(), out.data_ptr(),
        s, m, k, scale_axis, n_mod, n_limbs,
        mod_arr.ctypes.data, radix.ctypes.data,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check_launch("residue_cast", status)
    residue_cast.launches += 1
    return out


def residue_cast(
    a: torch.Tensor,
    scale1: torch.Tensor,
    scale2: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    n_limbs: int,
    scale_axis: int = 0,
) -> torch.Tensor:
    """a: (m, k) or stacked (S, m, k) f32; scale1*scale2: power-of-two
    factors along `scale_axis` (shared by all S stack entries).  Returns
    (N, m, k) — or (S, N, m, k) for stacked input — int8 symmetric residues
    of trunc(a * scale), in one launch either way."""
    if scale_axis not in (0, 1):
        raise ValueError(f"scale_axis must be 0 or 1, got {scale_axis}")
    stacked = a.ndim == 3
    if not stacked:
        a = a[None]
    kw = dict(moduli=tuple(int(p) for p in moduli), n_limbs=int(n_limbs), scale_axis=scale_axis)
    with traced_launch("residue_cast", (a, scale1, scale2)):
        if on_card(a, scale1, scale2):
            out = _launch(a, scale1, scale2, **kw)
        else:
            out = residue_cast_plain(a, scale1, scale2, **kw)
    return out if stacked else out[0]


residue_cast.launches = 0
