"""Modulus-batched fused-Karatsuba residue GEMM.

Port of `repro.kernels.karatsuba_fused.karatsuba_mod_gemm_batched`, the
paper's complex workhorse: the three Karatsuba products D = AR.BR,
E = AI.BI, F = ((AR+AI) mod p).((BR+BI) mod p) run in one launch for all N
planes, and the epilogue emits CR = D - E and CI = F - D - E (mod p), with
an optional (CR, CI) carry folded in (K-chunk combine).

On CUDA tensors `karatsuba_mod_gemm_batched` launches
`csrc/karatsuba_fused.cu` (wgmma, in thread-block clusters that share the
preparation of B); on CPU tensors it runs `karatsuba_mod_gemm_plain`.  The
kernel loads its operands by TMA where k and n are multiples of 16 and
every operand is 16-byte aligned (`build.uses_tma`), else from its own
threads; the wrapper counts the TMA launches in `.tma_launches` beside
`.launches`.  `karatsuba_mod_gemm` runs it on one modulus (a grid of one
plane), the per-modulus execution's product.

`fused_karatsuba_mod_gemm` is the one-launch complex megakernel (port of
`repro.kernels.karatsuba_fused.fused_karatsuba_mod_gemm`): the casts of
AR/AI (and BR/BI, unless pre-cast) as prologue, the D/E/F triple for every
plane with the K-chunk reduction inside, the CR/CI combine and two Garner
reconstructions as epilogue.  On CUDA tensors it launches
`csrc/fused_karatsuba.cu` (in 2 x 4 thread-block clusters that share the
casts; `fused_cluster_info` reports the launch); on CPU tensors it runs
`fused_karatsuba_mod_gemm_plain`.
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
    on_card,
    plane_mod_params,
    residue_tiles_f32,
    split_scale_exponent,
    static_mod_params,
    sym_mod_f32,
    sym_mod_int32_dyn,
    traced_launch,
)
from .crt_garner import garner_scaled
from .int8_mod_gemm import fused_scales, fused_tables, ptr


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
def _entry(source: str, symbol: str):
    fn = getattr(build.library(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def launch_karatsuba(source: str, symbol: str, ar, ai, br, bi, *, moduli, carry=None, tile):
    """Launch the Karatsuba residue-GEMM entry `symbol` of `source`
    (`karatsuba_fused.cu` or `fp8_karatsuba.cu`, which share one C
    interface) with the block `tile` (bm, bn, bk) into a new (CR, CI) pair;
    the caller checks the tile and counts the launch."""
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
    status = _entry(source, symbol)(
        ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(), *carry_ptrs,
        cr.data_ptr(), ci.data_ptr(), n_mod, m, n, k, *tile, mod_arr.ctypes.data,
        torch.cuda.current_stream(ar.device).cuda_stream,
    )
    build.check_launch(source, status)
    return cr, ci


def karatsuba_mod_gemm_batched(
    ar: torch.Tensor,
    ai: torch.Tensor,
    br: torch.Tensor,
    bi: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,
    tile: tuple[int, int, int] | None = None,
):
    """Residues of (CR', CI') = (AR'+iAI')(BR'+iBI') mod p_l, all planes in
    ONE launch.  Inputs (N, m, k) / (N, k, n) int8 stacks; `carry` is an
    optional (CR, CI) pair of (N, m, n) int8 residues folded into the
    epilogue.  Any m/n/k is accepted; k <= 2^17.  `tile`: the block tile,
    one of `COMPILED_TILES["kernel", "complex"]` (None: the default),
    ignored by the plain version."""
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
    tile = check_tile("kernel", "complex", tile)
    tensors = (ar, ai, br, bi) + (() if carry is None else tuple(carry))
    with traced_launch("karatsuba_fused", tensors, k=k):
        if on_card(*tensors):
            out = launch_karatsuba("karatsuba_fused", "karatsuba_mod_gemm_launch", ar, ai, br, bi,
                                   moduli=moduli, carry=carry, tile=tile)
            karatsuba_mod_gemm_batched.launches += 1
            karatsuba_mod_gemm_batched.tma_launches += build.uses_tma("karatsuba_fused", ar, ai, br, bi)
            return out
        return karatsuba_mod_gemm_plain(ar, ai, br, bi, moduli=moduli, carry=carry)


karatsuba_mod_gemm_batched.launches = 0
karatsuba_mod_gemm_batched.tma_launches = 0  # of them, those that loaded by TMA


def karatsuba_mod_gemm(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor, *,
                       p: int, tile: tuple[int, int, int] | None = None):
    """Residues of (CR', CI') = (AR'+iAI')(BR'+iBI') mod p, all int8 (m,k) /
    (k,n).  The per-modulus entry point (`execution="per_modulus_kernel"`):
    the batched kernel on a grid of one plane, so its launches count in
    `karatsuba_mod_gemm_batched.launches`."""
    cr, ci = karatsuba_mod_gemm_batched(ar[None], ai[None], br[None], bi[None], moduli=(int(p),),
                                        tile=tile)
    return cr[0], ci[0]


# --------------------------------------------------------------- megakernel


def fused_karatsuba_mod_gemm_plain(ar, ai, br, bi, e_mu, e_nu, ctx, *, n_limbs, out_dd=False,
                                   b_res=None, chunk_limit=K_CHUNK_LIMIT):
    """The complex megakernel's function in PyTorch, in the op order of the
    reference's `_fused_kernel`: f32 residue tiles, per plane the exact
    D/E/F products over `chunk_limit` K slices, the CR/CI combine, and two
    `garner_tile` reconstructions with the inverse scaling."""
    cast = dict(moduli=ctx.moduli, n_limbs=n_limbs)
    sa1, sa2 = split_scale_exponent(e_mu)
    art, ait = (torch.stack(t) for t in zip(*residue_tiles_f32(
        torch.stack([ar, ai]), sa1, sa2, scale_axis=0, **cast)))
    if b_res is None:
        sb1, sb2 = split_scale_exponent(e_nu)
        brt, bit = (torch.stack(t) for t in zip(*residue_tiles_f32(
            torch.stack([br, bi]), sb1, sb2, scale_axis=1, **cast)))
    else:
        brt, bit = (r.to(torch.float32) for r in b_res)
    cr_planes, ci_planes = [], []
    for l, p in enumerate(ctx.moduli):
        pf, half, m16 = static_mod_params(p)
        asum = sym_mod_f32(art[l] + ait[l], pf, half).to(torch.int8)
        bsum = sym_mod_f32(brt[l] + bit[l], pf, half).to(torch.int8)
        prod = lambda x, y: chunked_mod_product(  # noqa: E731
            x.to(torch.int8), y.to(torch.int8), pf, half, m16, chunk_limit)
        dr, de, df = prod(art[l], brt[l]), prod(ait[l], bit[l]), prod(asum, bsum)
        cr_planes.append(sym_mod_f32(dr - de, pf, half))
        ci_planes.append(sym_mod_f32(df - dr - de, pf, half))
    outs = [garner_scaled(planes, e_mu, e_nu, ctx, out_dd=out_dd) for planes in (cr_planes, ci_planes)]
    return tuple(torch.stack(o) if out_dd else o for o in outs)


@functools.cache
def _fused_entry():
    fn = build.library("fused_karatsuba").fused_karatsuba_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def _fused_launch(ar, ai, br, bi, e_mu, e_nu, ctx, *, n_limbs, out_dd, b_res, chunk_limit, tile):
    m, k = ar.shape
    prepared = b_res is not None
    n = (b_res[0] if prepared else br).shape[-1]
    for name, t in (("ar", ar), ("ai", ai)):
        check_tensor(name, t, torch.float32, (m, k))
    if prepared:
        for name, t in zip(("brr", "bri"), b_res):
            check_tensor(name, t, torch.int8, (ctx.n, k, n))
        brr, bri = b_res
    else:
        for name, t in (("br", br), ("bi", bi)):
            check_tensor(name, t, torch.float32, (k, n))
        brr = bri = None
    (sa1, sa2), (sb1, sb2), (r1, r2, c1, c2) = fused_scales(e_mu, e_nu, ctx, m, n, prepared)
    shape = (2, m, n) if out_dd else (m, n)
    cr = torch.empty(shape, dtype=torch.float32, device=ar.device)
    ci = torch.empty_like(cr)
    tab = fused_tables(ctx, n_limbs)
    status = _fused_entry()(
        ar.data_ptr(), ai.data_ptr(), sa1.data_ptr(), sa2.data_ptr(), ptr(br), ptr(bi),
        ptr(brr), ptr(bri), ptr(sb1), ptr(sb2), r1.data_ptr(), r2.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        m, n, k, chunk_limit, int(out_dd), ctx.n, n_limbs, *tile,
        *(t.ctypes.data for t in tab.values()),
        torch.cuda.current_stream(ar.device).cuda_stream,
    )
    build.check_launch("fused_karatsuba", status)
    fused_karatsuba_mod_gemm.launches += 1
    return cr, ci


def fused_cluster_info(n_mod: int, tile: tuple[int, int, int] | None = None) -> dict:
    """How the card runs the complex megakernel at `n_mod` moduli with
    `tile`: the thread-block cluster it launches in (`cluster`, (CM, CN)
    blocks along m and n), the most such clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`), the shared memory of a block and
    its number of staging buffers.  Needs the card."""
    cm, cn, clusters, smem, stages = build.cluster_launch_info(
        "fused_karatsuba", check_tile("fused", "complex", tile), n_mod, 5)
    return {"cluster": (cm, cn), "max_active_clusters": clusters, "smem_bytes": smem, "stages": stages}


def fused_karatsuba_mod_gemm(
    ar: torch.Tensor,
    ai: torch.Tensor,
    br: torch.Tensor | None,
    bi: torch.Tensor | None,
    e_mu: torch.Tensor,
    e_nu: torch.Tensor,
    ctx: CRTContext,
    *,
    n_limbs: int,
    out_dd: bool = False,
    b_res: tuple[torch.Tensor, torch.Tensor] | None = None,
    chunk_limit: int | None = None,
    tile: tuple[int, int, int] | None = None,
):
    """The one-launch complex megakernel: C = (AR + i AI)(BR + i BI) emulated.

    ar/ai: (m, k); br/bi: (k, n), or None with `b_res` the pre-cast
    ((N, k, n), (N, k, n)) int8 plane pair (prepared serving); all are cast
    to f32 first.  Returns (cr, ci), each (m, n) f32 or (2, m, n)
    double-single with `out_dd`.  The K sums are reduced mod p every
    `chunk_limit` columns (default 2^17) inside the launch.  `tile`: the
    block tile, one of `COMPILED_TILES["fused", "complex"]` (None: the
    default), ignored by the plain version.  Bitwise equal to the composed
    cast/Karatsuba/Garner path.
    """
    if chunk_limit is None:
        chunk_limit = K_CHUNK_LIMIT
    if (br is None) != (bi is None) or (br is None) == (b_res is None):
        raise ValueError("pass exactly one of (br, bi) (raw) and b_res (pre-cast planes)")
    ar, ai = (x.to(torch.float32).contiguous() for x in (ar, ai))
    if b_res is None:
        br, bi = (x.to(torch.float32).contiguous() for x in (br, bi))
        rhs = (br, bi)
    else:
        b_res = tuple(r.contiguous() for r in b_res)
        rhs = b_res
    if ai.shape != ar.shape or rhs[0].shape != rhs[1].shape or rhs[0].shape[-2] != ar.shape[-1]:
        raise ValueError(
            f"shape mismatch: ar {tuple(ar.shape)}, ai {tuple(ai.shape)}, "
            f"b {tuple(rhs[0].shape)}, {tuple(rhs[1].shape)}"
        )
    kw = dict(n_limbs=int(n_limbs), out_dd=out_dd, b_res=b_res, chunk_limit=int(chunk_limit))
    tile = check_tile("fused", "complex", tile)
    with traced_launch("fused_karatsuba", (ar, ai, *rhs, e_mu, e_nu), k=ar.shape[-1],
                       chunk_limit=kw["chunk_limit"]):
        if on_card(ar, ai, *rhs, e_mu, e_nu):
            return _fused_launch(ar, ai, br, bi, e_mu, e_nu, ctx, tile=tile, **kw)
        return fused_karatsuba_mod_gemm_plain(ar, ai, br, bi, e_mu, e_nu, ctx, **kw)


fused_karatsuba_mod_gemm.launches = 0
