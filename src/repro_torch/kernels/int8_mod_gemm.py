"""Modulus-batched int8 residue GEMM with a symmetric-mod epilogue, and
the one-launch real megakernel.

Port of `repro.kernels.int8_mod_gemm`:

* `int8_mod_gemm_batched` (Alg. 1 steps V-iii/iv for all N moduli in one
  launch), and `int8_mod_gemm`, the same kernel on one modulus.  The optional `carry` (N, m, n) int8 residue stack is folded
  into the epilogue reduction, out = sym_mod(acc + carry, p): K-chunked
  products thread the previous chunk's residues through it.  On CUDA
  tensors it launches `csrc/int8_mod_gemm.cu` (s8 `wgmma` in 4 x 1
  thread-block clusters that share B's transpose; it loads by TMA when k
  and n are multiples of 16 and both operands 16-byte aligned, else its
  threads load from global memory, and the wrapper counts the TMA launches
  in `.tma_launches` beside `.launches`); on CPU tensors it runs
  `int8_mod_gemm_plain`.
* `fused_mod_gemm`, the whole emulated GEMM in one launch: the residue
  cast of A (and of B, unless its planes come pre-cast) as prologue, the N
  plane products with the K-chunk reduction inside, Garner with inverse
  scaling as epilogue.  On CUDA tensors it launches
  `csrc/fused_mod_gemm.cu` (in thread-block clusters that share the casts;
  `fused_mod_cluster_info` reports the launch); on CPU tensors it runs
  `fused_mod_gemm_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.intmul import int8_matmul
from ..core.moduli import K_CHUNK_LIMIT, CRTContext
from . import build
from .common import (
    check_tensor,
    check_tile,
    chunked_mod_product,
    limb_radix_f32,
    on_card,
    plane_mod_params,
    residue_tiles_f32,
    split_scale_exponent,
    static_mod_params,
    sym_mod_int32_dyn,
    traced_launch,
)
from .crt_garner import _inverse_scales, _weight_table, garner_scaled, route_tables


def int8_mod_gemm_plain(a, b, *, moduli, carry=None):
    """The kernel's function in PyTorch: the exact product, + carry, and the
    reference's 16-bit-split f32 symmetric mod (`sym_mod_int32_dyn`)."""
    acc = int8_matmul(a, b)
    if carry is not None:
        acc = acc + carry.to(torch.int32)
    pf, half, m16 = plane_mod_params(moduli, a.device)
    return sym_mod_int32_dyn(acc, pf, half, m16).to(torch.int8)


@functools.cache
def _entry(source: str):
    fn = getattr(build.library(source), f"{source}_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def launch_mod_gemm(source: str, a, b, *, moduli, carry=None, tile, counter):
    """Launch the residue-GEMM kernel of `source` (`int8_mod_gemm.cu` or
    `fp8_mod_gemm.cu`, which share one C interface) with the block `tile`
    (bm, bn, bk) into a new (N, m, n) int8 output, counted on `counter`
    (the wrapper's `launches` and `tma_launches`); the caller checks the
    tile."""
    n_mod, m, k = a.shape
    n = b.shape[-1]
    check_tensor("a", a, torch.int8, (n_mod, m, k))
    check_tensor("b", b, torch.int8, (n_mod, k, n))
    if carry is not None:
        check_tensor("carry", carry, torch.int8, (n_mod, m, n))
    out = torch.empty((n_mod, m, n), dtype=torch.int8, device=a.device)
    mod_arr = np.ascontiguousarray(moduli, dtype=np.int32)
    if out.is_meta:  # shapes only: no launch
        return out
    status = _entry(source)(
        a.data_ptr(), b.data_ptr(), None if carry is None else carry.data_ptr(),
        out.data_ptr(), n_mod, m, n, k, *tile, mod_arr.ctypes.data,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check_launch(source, status)
    counter.launches += 1
    counter.tma_launches += build.uses_tma(source, a, a, b, b)
    return out


def int8_mod_gemm_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: torch.Tensor | None = None,
    tile: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """E_l = sym_mod(A_l @ B_l [+ carry_l], p_l) for all l in ONE launch.

    a: (N, m, k) int8, b: (N, k, n) int8, carry: optional (N, m, n) int8;
    returns (N, m, n) int8 residues.  Any m/n/k is accepted; k <= 2^17.
    `tile`: the kernel's block tile (bm, bn, bk), one of
    `COMPILED_TILES["kernel", "real"]` (None: the default); the plain
    version ignores it, and no tile changes the bits.
    """
    n_mod, m, k = a.shape
    moduli = tuple(int(p) for p in moduli)
    if b.ndim != 3 or b.shape[0] != n_mod or b.shape[1] != k or len(moduli) != n_mod:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, N={len(moduli)}")
    if k > (1 << 17):
        raise ValueError(f"k={k} exceeds the exact-int32 limit 2^17; chunk K")
    tile = check_tile("kernel", "real", tile)
    tensors = (a, b) if carry is None else (a, b, carry)
    with traced_launch("int8_mod_gemm", tensors, k=k, ops=("int8", 2 * n_mod * m * b.shape[-1] * k)):
        if on_card(*tensors):
            return launch_mod_gemm("int8_mod_gemm", a, b, moduli=moduli, carry=carry, tile=tile,
                                   counter=int8_mod_gemm_batched)
        return int8_mod_gemm_plain(a, b, moduli=moduli, carry=carry)


int8_mod_gemm_batched.launches = 0
int8_mod_gemm_batched.tma_launches = 0  # of them, those that loaded by TMA


def int8_mod_gemm(a: torch.Tensor, b: torch.Tensor, *, p: int,
                  tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """E = sym_mod(A @ B, p): (m,k) x (k,n) int8 -> (m,n) int8 residues.

    The per-modulus entry point (`execution="per_modulus_kernel"`): the
    batched kernel on a grid of one plane, so its launches count in
    `int8_mod_gemm_batched.launches`.
    """
    return int8_mod_gemm_batched(a[None], b[None], moduli=(int(p),), tile=tile)[0]


# --------------------------------------------------------------- megakernel


def fused_mod_gemm_plain(a, b, e_mu, e_nu, ctx, *, n_limbs, out_dd=False, b_res=None,
                         chunk_limit=K_CHUNK_LIMIT):
    """The megakernel's function in PyTorch, in the op order of the
    reference's `_fused_kernel`: `residue_tiles_f32` casts, per-plane exact
    products over `chunk_limit` K slices with the symmetric mod between
    them, and `garner_tile` with the inverse scaling."""
    sa1, sa2 = split_scale_exponent(e_mu)
    a_tiles = residue_tiles_f32(a, sa1, sa2, moduli=ctx.moduli, n_limbs=n_limbs, scale_axis=0)
    if b_res is None:
        sb1, sb2 = split_scale_exponent(e_nu)
        b_tiles = [t.to(torch.int8) for t in residue_tiles_f32(
            b, sb1, sb2, moduli=ctx.moduli, n_limbs=n_limbs, scale_axis=1)]
    else:
        b_tiles = list(b_res)
    planes = [
        chunked_mod_product(a_tiles[l].to(torch.int8), b_tiles[l], *static_mod_params(p), chunk_limit)
        for l, p in enumerate(ctx.moduli)
    ]
    out = garner_scaled(planes, e_mu, e_nu, ctx, out_dd=out_dd)
    return torch.stack(out) if out_dd else out


def fused_tables(ctx: CRTContext, n_limbs: int) -> dict[str, np.ndarray]:
    """The host tables a megakernel copies into its parameters: moduli,
    limb radix, the Garner digits' mixed-radix coefficients
    (`crt_garner.route_tables`, integers), the double-single weights and
    the split of each weight's high word (`route_tables`)."""
    coef, split = route_tables(ctx)
    return {
        "moduli": np.ascontiguousarray(ctx.moduli, dtype=np.int32),
        "radix": np.ascontiguousarray(limb_radix_f32(ctx.moduli, n_limbs)),
        "coef": np.ascontiguousarray(coef),
        "weights": np.ascontiguousarray(_weight_table(ctx)),
        "split": np.ascontiguousarray(split),
    }


def fused_scales(e_mu, e_nu, ctx: CRTContext, m: int, n: int, prepared: bool):
    """The f32 factor vectors of a megakernel launch, checked: the cast
    scales of A rows and B columns (None for B when prepared) and the
    inverse scales (r1, r2, c1, c2)."""
    if tuple(e_mu.shape) != (m,) or tuple(e_nu.shape) != (n,):
        raise ValueError(f"exponents {tuple(e_mu.shape)}, {tuple(e_nu.shape)} for an ({m}, {n}) output")
    sa = split_scale_exponent(e_mu)
    sb = (None, None) if prepared else split_scale_exponent(e_nu)
    return sa, sb, _inverse_scales(e_mu, e_nu, ctx)


def ptr(t: torch.Tensor | None):
    """The device address of `t` for a C entry point (None for null)."""
    return None if t is None else t.data_ptr()


@functools.cache
def _fused_entry():
    fn = build.library("fused_mod_gemm").fused_mod_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def _fused_launch(a, b, e_mu, e_nu, ctx, *, n_limbs, out_dd, b_res, chunk_limit, tile):
    m, k = a.shape
    n = b.shape[-1] if b_res is None else b_res.shape[-1]
    check_tensor("a", a, torch.float32, (m, k))
    if b_res is None:
        check_tensor("b", b, torch.float32, (k, n))
    else:
        check_tensor("b_res", b_res, torch.int8, (ctx.n, k, n))
    (sa1, sa2), (sb1, sb2), (r1, r2, c1, c2) = fused_scales(e_mu, e_nu, ctx, m, n, b_res is not None)
    out = torch.empty((2, m, n) if out_dd else (m, n), dtype=torch.float32, device=a.device)
    tab = fused_tables(ctx, n_limbs)
    if out.is_meta:  # shapes only: no launch
        return out
    status = _fused_entry()(
        a.data_ptr(), sa1.data_ptr(), sa2.data_ptr(), ptr(b), ptr(b_res), ptr(sb1), ptr(sb2),
        r1.data_ptr(), r2.data_ptr(), c1.data_ptr(), c2.data_ptr(), out.data_ptr(),
        m, n, k, chunk_limit, int(out_dd), ctx.n, n_limbs, *tile,
        *(t.ctypes.data for t in tab.values()),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check_launch("fused_mod_gemm", status)
    fused_mod_gemm.launches += 1
    return out


def fused_mod_cluster_info(n_mod: int, tile: tuple[int, int, int] | None = None) -> dict:
    """How the card runs the real megakernel at `n_mod` moduli with `tile`:
    the thread-block cluster it launches in (`cluster`, (CM, CN) blocks
    along m and n), the most such clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`), the shared memory of a block and
    its number of staging buffers.  Needs the card."""
    cm, cn, clusters, smem, stages = build.cluster_launch_info(
        "fused_mod_gemm", check_tile("fused", "real", tile), n_mod, 5)
    return {"cluster": (cm, cn), "max_active_clusters": clusters, "smem_bytes": smem, "stages": stages}


def fused_mod_gemm(
    a: torch.Tensor,
    b: torch.Tensor | None,
    e_mu: torch.Tensor,
    e_nu: torch.Tensor,
    ctx: CRTContext,
    *,
    n_limbs: int,
    out_dd: bool = False,
    b_res: torch.Tensor | None = None,
    chunk_limit: int | None = None,
    tile: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """The one-launch real megakernel: C = A @ B emulated end to end.

    a: (m, k); b: (k, n), or None with `b_res` the pre-cast (N, k, n) int8
    planes (prepared serving); both are cast to f32 first.  e_mu / e_nu:
    the integer scale exponents.  Returns the (m, n) f32 output, or the
    (2, m, n) double-single pair with `out_dd`.  The K sum is reduced mod p
    every `chunk_limit` columns (default 2^17) inside the launch, so any k
    is accepted.  `tile`: the block tile (bm, bn, bk), one of
    `COMPILED_TILES["fused", "real"]` (None: the default), ignored by the
    plain version.  Bitwise equal to the composed cast/product/Garner path.
    """
    if chunk_limit is None:
        chunk_limit = K_CHUNK_LIMIT
    if (b is None) == (b_res is None):
        raise ValueError("pass exactly one of b (raw) and b_res (pre-cast planes)")
    a = a.to(torch.float32).contiguous()
    if b is not None:
        b = b.to(torch.float32).contiguous()
    else:
        b_res = b_res.contiguous()
    kw = dict(n_limbs=int(n_limbs), out_dd=out_dd, b_res=b_res, chunk_limit=int(chunk_limit))
    rhs = b if b_res is None else b_res
    if rhs.shape[-2] != a.shape[-1]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(rhs.shape)}")
    tile = check_tile("fused", "real", tile)
    ops = ("int8", 2 * ctx.n * a.shape[0] * rhs.shape[-1] * a.shape[-1])
    with traced_launch("fused_mod_gemm", (a, rhs, e_mu, e_nu), k=a.shape[-1], chunk_limit=kw["chunk_limit"],
                       ops=ops):
        if on_card(a, rhs, e_mu, e_nu):
            return _fused_launch(a, b, e_mu, e_nu, ctx, tile=tile, **kw)
        return fused_mod_gemm_plain(a, b, e_mu, e_nu, ctx, **kw)


fused_mod_gemm.launches = 0
