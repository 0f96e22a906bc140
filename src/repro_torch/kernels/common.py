"""Shared helpers of the port's kernels and their plain PyTorch versions.

The port's copy of the exact f32/int32 arithmetic of
`repro.kernels.common`.  Values stay below 2^24 after the limb peel, where
f32 arithmetic on integers is error-free, and every symmetric mod returns
the canonical residue |r| <= (p-1)/2 — which is unique, so any exact route
to it (these f32 tricks, or the CUDA kernels' int32 `%`) gives the same
bits.

One step leaves the f32 route: the residue of a limb (|limb| < 2^24) is
taken in int32, because there the reciprocal trick's n*p can pass 2^24 and
round.

`on_card` is the dispatch rule of every kernel wrapper: tensors on the CPU
take the plain version, tensors on a CUDA device launch the kernel,
tensors on the meta device take the card's branch up to its launch (the
outputs and workspace allocated as for the card, then returned with no
launch: the dry run's shapes, `repro_torch.launch.dryrun`), and anything
else raises.  `traced_launch` is the scope every wrapper enters
just before that dispatch, so a trace (`repro_torch.analysis.trace`)
records the same launches whichever way it goes.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.intmul import int8_matmul
from ..core.residues import LIMB_BITS, sym_mod_int32
from ..core.scaling import exp2_vector

LIMB = float(1 << LIMB_BITS)


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device or all lie on the
    meta device (whose launches return their outputs once allocated),
    False when all lie on the CPU; raises for a mix or another device
    type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type in ("cuda", "meta"):
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


#: the active launch recorders (`repro_torch.analysis.trace.Trace`), each
#: told of every wrapper's launch before its dispatch
TRACERS: list = []

_UNTRACED = contextlib.nullcontext()


class _LaunchScope:
    """One wrapper call seen by the active recorders: `launch` on entry (the
    record), `end_launch` on exit (the ops between ran inside it)."""

    def __init__(self, record):
        self.record = record

    def __enter__(self):
        for tracer in TRACERS:
            tracer.launch(*self.record)
        return self

    def __exit__(self, *exc):
        for tracer in TRACERS:
            tracer.end_launch()
        return False


def traced_launch(name: str, tensors, *, k: int | None = None, chunk_limit: int | None = None,
                  ops: tuple[str, int] | None = None):
    """The scope a wrapper dispatches in: kernel `name` (its source's name,
    the key of `kernels.WRAPPERS`) on `tensors`, contracting `k` (None for
    a kernel that multiplies nothing), reducing mod p every `chunk_limit`
    inside the launch (the megakernels), its products doing `ops`, the
    (engine, operations) pair (engine 'int8' or 'e4m3'; 2 a MAC; None for
    a kernel that multiplies nothing).  Free when nothing traces."""
    if not TRACERS:
        return _UNTRACED
    return _LaunchScope((name, tuple(tensors), k, chunk_limit, ops))


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` has `dtype`, `shape` and a contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def sym_mod_f32(v, p, half):
    """Symmetric mod for f32 integer values |v| <~ 2^24 (exact).

    The initial guess n = round(v/p) is within +/-1 of the true quotient and
    the two correction steps make the result the canonical residue.
    """
    n = torch.round(v * (1.0 / p))
    r = v - n * p
    r = torch.where(r > half, r - p, r)
    r = torch.where(r < -half, r + p, r)
    return r


def sym_mod_int32_dyn(d, pf, half, m16):
    """Exact symmetric mod of int32 (|d| < 2^31) by the 16-bit split.

    d = dh*2^16 + dl with dh = d >> 16 (floor), dl = d & 0xffff; both below
    2^24, so the f32 modular arithmetic is exact.  `pf`/`half`/`m16` come
    from :func:`static_mod_params`, as floats or as tensors broadcast
    against `d` (one modulus per plane).
    """
    dh = torch.bitwise_right_shift(d, 16).to(torch.float32)  # arithmetic: floor
    dl = torch.bitwise_and(d, (1 << 16) - 1).to(torch.float32)
    rh = sym_mod_f32(dh, pf, half)
    rl = sym_mod_f32(dl, pf, half)
    return sym_mod_f32(rh * m16 + rl, pf, half)


def chunked_mod_product(a, b, pf, half, m16, chunk_limit):
    """The canonical residues (as f32) of the exact int8 product a @ b mod p,
    summed over K slices of `chunk_limit` with the symmetric mod between
    them: the megakernels' in-kernel chunk reduction, in PyTorch."""
    k = a.shape[-1]
    acc = None
    for k0 in range(0, max(k, 1), chunk_limit):
        d = int8_matmul(a[..., k0:k0 + chunk_limit], b[..., k0:k0 + chunk_limit, :])
        acc = d if acc is None else sym_mod_int32_dyn(acc, pf, half, m16).to(torch.int32) + d
    return sym_mod_int32_dyn(acc, pf, half, m16)


def static_mod_params(p: int) -> tuple[float, float, float]:
    """(pf, half, m16) as Python floats: p, (p-1)/2 and the symmetric
    residue of 2^16 mod p."""
    half = (p - 1) // 2
    m16 = pow(1 << 16, 1, p)
    if m16 > half:
        m16 -= p
    return float(p), float(half), float(m16)


def plane_mod_params(moduli, device) -> tuple[torch.Tensor, ...]:
    """:func:`static_mod_params` of every plane as (N, 1, 1) f32 tensors."""
    rows = np.asarray([static_mod_params(int(p)) for p in moduli], np.float32)
    t = torch.from_numpy(rows).to(device)
    return tuple(t[:, i].reshape(-1, 1, 1) for i in range(3))


def residue_tiles_f32(x, s1, s2, *, moduli, n_limbs, scale_axis):
    """Scale -> trunc -> limb-peel -> per-modulus canonical residues, in f32.

    `x` is an (..., m, k) f32 tensor; `s1*s2` the power-of-two factors along
    rows (scale_axis=0, length m) or columns (scale_axis=1, length k).
    Returns a list of N f32 tensors of x's shape, each the exact canonical
    symmetric residue (|r| <= (p-1)/2).
    """
    scale = s1 * s2
    scale = scale[:, None] if scale_axis == 0 else scale[None, :]
    x = torch.trunc(x * scale)  # exact: power-of-two scale, f32 trunc

    # exact base-2^24 limb peel
    limbs = []
    rem = x
    for i in reversed(range(1, n_limbs)):
        base = LIMB**i
        hi = torch.trunc(rem * (1.0 / base))  # 1/2^24i is a power of two: exact
        rem = rem - hi * base
        limbs.append(hi)
    limbs.append(rem)
    limbs = limbs[::-1]

    # A limb is an integer below 2^24 in magnitude, so its int32 is exact.
    # Its residue is taken in int32: the f32 route's n*p can pass 2^24 and
    # round (the reference gets the exact residue only where XLA contracts
    # v - n*p into an FMA).
    ilimbs = [limb.to(torch.int32) for limb in limbs]
    radix = limb_radix_f32(moduli, n_limbs)
    out = []
    for l, p in enumerate(moduli):
        pf, half = float(p), float((p - 1) // 2)
        acc = torch.zeros_like(x)
        for i in range(n_limbs):
            acc = acc + sym_mod_int32(ilimbs[i], p).to(torch.float32) * float(radix[i, l])
        # |acc| <= n_limbs * 127^2 < 2^17: the f32 route is exact here
        out.append(sym_mod_f32(acc, pf, half))
    return out


def limb_radix_f32(moduli, n_limbs: int) -> np.ndarray:
    """(n_limbs, N) f32 table of symmetric 2^(24 i) mod p_l."""
    tab = np.zeros((n_limbs, len(moduli)), dtype=np.float32)
    for i in range(n_limbs):
        for l, p in enumerate(moduli):
            r = pow(1 << LIMB_BITS, i, p)
            if r > (p - 1) // 2:
                r -= p
            tab[i, l] = float(r)
    return tab


def split_scale_exponent(e: torch.Tensor, bias: int = 0):
    """Split exponents e+bias into two f32-safe power-of-two factors.

    Returns (s1, s2) f32 with s1*s2 == 2^(e+bias) exactly, each factor's
    exponent within the f32 normal range for |e+bias| <= 252.
    """
    et = e.to(torch.int64) + bias
    e1 = torch.div(et, 2, rounding_mode="floor")
    e2 = et - e1
    return exp2_vector(e1).to(torch.float32), exp2_vector(e2).to(torch.float32)


# ------------------------------------------------------- GEMM kernel tiles

#: The block tiles (bm, bn, bk) each GEMM kernel compiles, by the
#: (family, dtype class) of `tune.cache.block_key`; the first of each is
#: the kernel's default, the tile it ran before it had alternatives.  A
#: tile changes which threads add which exact products, never the bits.
#: The CUDA sources instantiate exactly these (their `REPRO_TILE` lists).
COMPILED_TILES = {
    ("kernel", "real"): ((128, 128, 64), (128, 128, 128), (64, 128, 64), (128, 64, 64)),
    ("kernel", "complex"): ((64, 128, 64), (64, 64, 64), (64, 64, 128)),
    ("fused", "real"): ((64, 64, 64), (128, 64, 64)),
    ("fused", "complex"): ((64, 64, 64), (64, 32, 64)),
    ("fp8", "real"): ((128, 64, 64), (128, 64, 128)),
    ("fp8", "complex"): ((64, 64, 64), (64, 64, 128)),
}

#: the CUDA source of each (family, dtype class)
TILE_SOURCES = {
    ("kernel", "real"): "int8_mod_gemm",
    ("kernel", "complex"): "karatsuba_fused",
    ("fused", "real"): "fused_mod_gemm",
    ("fused", "complex"): "fused_karatsuba",
    ("fp8", "real"): "fp8_mod_gemm",
    ("fp8", "complex"): "fp8_karatsuba",
}


def check_tile(family: str, dclass: str, tile=None) -> tuple[int, int, int]:
    """`tile` as an (bm, bn, bk) tuple, the default when None; raises unless
    the kernel of (family, dclass) compiles it."""
    tiles = COMPILED_TILES.get((family, dclass))
    if tiles is None:
        raise ValueError(f"no GEMM kernel for family {family!r}, dtype class {dclass!r}")
    if tile is None:
        return tiles[0]
    tile = tuple(int(x) for x in tile)
    if tile not in tiles:
        raise ValueError(
            f"tile {tile} is not compiled for the {family}/{dclass} kernel "
            f"({TILE_SOURCES[family, dclass]}.cu); compiled tiles: {tiles}"
        )
    return tile


def resolve_blocks(
    family: str,
    dclass: str,
    m: int,
    n: int,
    k: int,
    bm: int | None = None,
    bn: int | None = None,
    bk: int | None = None,
) -> tuple[int, int, int]:
    """The (bm, bn, bk) a GEMM kernel launches for one (family, dclass,
    shape) slot: the port's `repro.kernels.common.resolve_blocks`.

    Explicit values win per axis.  Unset axes come from the active
    calibration's autotuned winner for this slot (`repro_torch.tune`,
    `current_calibration().block_for(block_key(...))`), else from the
    kernel's default tile — per family, unlike the reference's single
    Pallas block (256, 256, 512), which means nothing to these kernels.
    The result must be one of the kernel's compiled tiles
    (`COMPILED_TILES`); anything else, a tuned entry included, raises.
    """
    tuned = None
    if bm is None or bn is None or bk is None:
        # lazy import: tune.cache must stay importable without the kernels
        from ..tune.cache import block_key, current_calibration

        cal = current_calibration()
        if cal is not None:
            tuned = cal.block_for(block_key(family, dclass, m, n, k))
    base = tuned or check_tile(family, dclass)
    return check_tile(family, dclass, (
        bm if bm is not None else base[0],
        bn if bn is not None else base[1],
        bk if bk is not None else base[2],
    ))
