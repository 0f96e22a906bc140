"""Modulus-batched residue GEMMs on the e4m3 (fp8) engine.

Port of `repro.kernels.fp8_mod_gemm`, the arXiv:2603.10634 variant of the
scheme.  An e4m3 significand holds 4 bits, so a residue (|r| <= 127) is
split into two balanced base-16 digits

    r = 16 hi + lo,   hi = round(r / 16) (half to even),   lo = r - 16 hi,

with |hi|, |lo| <= 8: every digit is exact in e4m3.  One residue product
becomes three digit products accumulated in f32,

    r_a r_b = 256 (hi_a hi_b) + 16 (hi_a lo_b + lo_a hi_b) + (lo_a lo_b)
                   HH                  X (doubled K)             LL

and the epilogue rescales them into each plane's residue ring:
sym_mod(m8 sym_mod(HH) + m4 sym_mod(X) + sym_mod(LL) [+ carry], p) with
m4 = 16 mod p and m8 = m4^2 mod p.  Digit products are at most 64, so the
f32 sums stay exact integers for k <= `FP8_K_CHUNK_LIMIT` (2^16) per
launch.  The result is the canonical residue of the exact product:
bitwise the int8 engine's (`int8_mod_gemm_batched`,
`karatsuba_mod_gemm_batched`).

* `fp8_mod_gemm_batched`: all N planes in one launch, optional carry.  On
  CUDA tensors it launches `csrc/fp8_mod_gemm.cu` (wgmma, in thread-block
  clusters that share the digit split; `fp8_mod_cluster_info` reports the
  launch); on CPU tensors it runs `fp8_mod_gemm_plain`.  The kernel loads
  its operands by TMA under the same rule as the Karatsuba kernels
  (`build.uses_tma`), and the wrapper counts those launches in
  `.tma_launches` beside `.launches`.
* `fp8_karatsuba_mod_gemm_batched`: the D/E/F Karatsuba triple as digit
  products, the sums (AR+AI), (BR+BI) mod p formed in the kernel, the
  CR/CI combine and carries.  On CUDA tensors it launches
  `csrc/fp8_karatsuba.cu` (wgmma, in thread-block clusters that share
  the digit split; `fp8_cluster_info` reports the launch); on CPU
  tensors it runs `fp8_karatsuba_mod_gemm_plain`.  The kernel loads its
  operands by TMA where k and n are multiples of 16 and every operand is
  16-byte aligned (`build.uses_tma`), else from its own
  threads; the wrapper counts the TMA launches in `.tma_launches` beside
  `.launches`.
"""
from __future__ import annotations

import torch

from . import build
from .common import check_tile, on_card, plane_mod_params, sym_mod_f32, sym_mod_int32_dyn, traced_launch
from .int8_mod_gemm import launch_mod_gemm
from .karatsuba_fused import launch_karatsuba

# Per-launch K bound of the f32 digit sums: a k step adds at most 2 * 8 * 8
# = 128 to X, and f32 integers are exact below 2^24, so k <= 2^17; the
# reference keeps a 2x margin, and so does the port.
FP8_K_CHUNK_LIMIT = 1 << 16


def digits(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced base-16 digits of f32 integer residues (|r| <= 127): hi =
    round(r/16), half to even as `jnp.round`, and lo = r - 16 hi, both in
    [-8, 8] and exact in e4m3."""
    hi = torch.round(r * (1.0 / 16.0))
    lo = r - 16.0 * hi
    return hi, lo


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round through e4m3 and back (exact for the digits)."""
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def _digit_residue(a32, b32, pf, half, m16):
    """m8 sym_mod(HH) + m4 sym_mod(X) + sym_mod(LL) of two f32 residue
    stacks: the TPU kernel's three f32 digit products (X as the doubled-K
    product [ah | al] . [bl ; bh]) and its rescale, not yet reduced."""
    ah, al = map(_e4m3, digits(a32))
    bh, bl = map(_e4m3, digits(b32))
    hh = torch.matmul(ah, bh)
    ll = torch.matmul(al, bl)
    xx = torch.matmul(torch.cat([ah, al], dim=-1), torch.cat([bl, bh], dim=-2))
    m4 = sym_mod_f32(torch.full_like(pf, 16.0), pf, half)
    m8 = sym_mod_f32(m4 * m4, pf, half)
    # the f32 digit sums are exact integers below 2^24: int32 is exact
    eh = sym_mod_int32_dyn(hh.to(torch.int32), pf, half, m16)
    ex = sym_mod_int32_dyn(xx.to(torch.int32), pf, half, m16)
    el = sym_mod_int32_dyn(ll.to(torch.int32), pf, half, m16)
    return m8 * eh + m4 * ex + el  # |.| <= 2 * 127^2 + 127 < 2^16: exact


def fp8_mod_gemm_plain(a, b, *, moduli, carry=None):
    """The kernel's function in PyTorch, in the op order of the reference's
    kernel body."""
    pf, half, m16 = plane_mod_params(moduli, a.device)
    acc = _digit_residue(a.float(), b.float(), pf, half, m16)
    if carry is not None:
        acc = acc + carry.float()
    return sym_mod_f32(acc, pf, half).to(torch.int8)


def fp8_karatsuba_mod_gemm_plain(ar, ai, br, bi, *, moduli, carry=None):
    """The Karatsuba kernel's function in PyTorch, in the op order of the
    reference's kernel body."""
    pf, half, m16 = plane_mod_params(moduli, ar.device)
    ar, ai, br, bi = (x.float() for x in (ar, ai, br, bi))
    asum = sym_mod_f32(ar + ai, pf, half)  # |sum| <= 254: exact
    bsum = sym_mod_f32(br + bi, pf, half)
    dr, de, df = (
        sym_mod_f32(_digit_residue(x, y, pf, half, m16), pf, half)
        for x, y in ((ar, br), (ai, bi), (asum, bsum))
    )
    cr = dr - de
    ci = df - dr - de
    if carry is not None:
        cr = cr + carry[0].float()
        ci = ci + carry[1].float()
    return (
        sym_mod_f32(cr, pf, half).to(torch.int8),
        sym_mod_f32(ci, pf, half).to(torch.int8),
    )


def _check_k(k: int) -> None:
    if k > FP8_K_CHUNK_LIMIT:
        raise ValueError(
            f"fp8 digit accumulation is exact only for k <= "
            f"{FP8_K_CHUNK_LIMIT} per launch (got k={k}); chunk via "
            f"chunked_residue_matmul(chunk_limit=FP8_K_CHUNK_LIMIT)"
        )


def fp8_mod_gemm_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: torch.Tensor | None = None,
    tile: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """E_l = sym_mod(A_l @ B_l [+ carry_l], p_l) on the e4m3 engine, all N
    planes in ONE launch.

    a: (N, m, k) int8, b: (N, k, n) int8, carry: optional (N, m, n) int8;
    returns (N, m, n) int8 residues, bitwise `int8_mod_gemm_batched`'s.
    Any m/n is accepted; k <= `FP8_K_CHUNK_LIMIT` per launch.  `tile`: the
    block tile, one of `COMPILED_TILES["fp8", "real"]` (None: the default),
    ignored by the plain version.
    """
    n_mod, m, k = a.shape
    moduli = tuple(int(p) for p in moduli)
    _check_k(k)
    if b.ndim != 3 or b.shape[0] != n_mod or b.shape[1] != k or len(moduli) != n_mod:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, N={len(moduli)}")
    tile = check_tile("fp8", "real", tile)
    tensors = (a, b) if carry is None else (a, b, carry)
    with traced_launch("fp8_mod_gemm", tensors, k=k):
        if on_card(*tensors):
            out = launch_mod_gemm("fp8_mod_gemm", a, b, moduli=moduli, carry=carry, tile=tile)
            fp8_mod_gemm_batched.launches += 1
            fp8_mod_gemm_batched.tma_launches += build.uses_tma("fp8_mod_gemm", a, a, b, b)
            return out
        return fp8_mod_gemm_plain(a, b, moduli=moduli, carry=carry)


fp8_mod_gemm_batched.launches = 0
fp8_mod_gemm_batched.tma_launches = 0  # of them, those that loaded by TMA


def fp8_karatsuba_mod_gemm_batched(
    ar: torch.Tensor,
    ai: torch.Tensor,
    br: torch.Tensor,
    bi: torch.Tensor,
    *,
    moduli: tuple[int, ...],
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,
    tile: tuple[int, int, int] | None = None,
):
    """Residues of (CR', CI') = (AR'+iAI')(BR'+iBI') mod p_l on the e4m3
    engine, all planes and the three Karatsuba products in ONE launch.

    Inputs (N, m, k) / (N, k, n) int8 stacks; `carry` an optional (CR, CI)
    pair of (N, m, n) int8 residues folded into the epilogue.  Bitwise
    `karatsuba_mod_gemm_batched`'s; k <= `FP8_K_CHUNK_LIMIT` per launch.
    `tile`: the block tile, one of `COMPILED_TILES["fp8", "complex"]`
    (None: the default), ignored by the plain version.
    """
    n_mod, m, k = ar.shape
    moduli = tuple(int(p) for p in moduli)
    _check_k(k)
    if (
        ai.shape != ar.shape
        or br.shape != bi.shape
        or br.ndim != 3
        or tuple(br.shape[:2]) != (n_mod, k)
        or len(moduli) != n_mod
    ):
        raise ValueError(
            f"shape mismatch: ar {tuple(ar.shape)}, ai {tuple(ai.shape)}, br {tuple(br.shape)}, "
            f"bi {tuple(bi.shape)}, N={len(moduli)}"
        )
    tile = check_tile("fp8", "complex", tile)
    tensors = (ar, ai, br, bi) if carry is None else (ar, ai, br, bi, *carry)
    with traced_launch("fp8_karatsuba", tensors, k=k):
        if on_card(*tensors):
            out = launch_karatsuba("fp8_karatsuba", "fp8_karatsuba_launch", ar, ai, br, bi,
                                   moduli=moduli, carry=carry, tile=tile)
            fp8_karatsuba_mod_gemm_batched.launches += 1
            fp8_karatsuba_mod_gemm_batched.tma_launches += build.uses_tma("fp8_karatsuba", ar, ai, br, bi)
            return out
        return fp8_karatsuba_mod_gemm_plain(ar, ai, br, bi, moduli=moduli, carry=carry)


fp8_karatsuba_mod_gemm_batched.launches = 0
fp8_karatsuba_mod_gemm_batched.tma_launches = 0  # of them, those that loaded by TMA


def fp8_mod_cluster_info(n_mod: int, tile: tuple[int, int, int] | None = None) -> dict:
    """How the card runs the e4m3 real kernel at `n_mod` planes with
    `tile`: its thread-block cluster (`cluster`, (CM, CN) blocks along m
    and n), the most such clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`), the shared memory of a block and
    the stages of its ring.  Needs the card."""
    cm, cn, clusters, smem, stages = build.cluster_launch_info(
        "fp8_mod_gemm", check_tile("fp8", "real", tile), n_mod, 5)
    return {"cluster": (cm, cn), "max_active_clusters": clusters, "smem_bytes": smem, "stages": stages}


def fp8_cluster_info(n_mod: int, tile: tuple[int, int, int] | None = None) -> dict:
    """How the card runs the e4m3 Karatsuba kernel at `n_mod` planes with
    `tile`: its thread-block cluster (`cluster`, (CM, CN) blocks along m
    and n), the most such clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`), the shared memory of a block, and
    the stages of its digit ring and of its TMA ring of raw slices.  Needs
    the card."""
    cm, cn, clusters, smem, stages, raw_stages = build.cluster_launch_info(
        "fp8_karatsuba", check_tile("fp8", "complex", tile), n_mod, 6)
    return {"cluster": (cm, cn), "max_active_clusters": clusters, "smem_bytes": smem, "stages": stages,
            "raw_stages": raw_stages}
