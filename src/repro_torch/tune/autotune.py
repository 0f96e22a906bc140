"""Tile autotuner for the port's batched and fused GEMM kernels.

The port's copy of `repro.tune.autotune`.  It times the kernels' public
wrappers — the functions the residue backends call — over each kernel's
compiled tiles (`kernels.common.COMPILED_TILES`) per (kernel family, dtype
class, shape bucket), and returns the winners in the `Calibration.blocks`
format (`cache.block_key` -> (bm, bn, bk)).

* a tile changes which threads add which exact int32 products, never the
  canonical residues, so a winner needs no accuracy re-validation;
* the kernel's default tile always leads the candidates, so a tuned tile
  was never measured slower than the default at tune time;
* on the CPU the wrappers run their plain versions, which ignore the tile:
  the winners are then structurally valid and mean nothing.

The shapes are the reference's; N = 8 moduli (smoke 4).  Timing: host wall
time around `torch.cuda.synchronize()`, one warm-up, the median of `iters`.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..core.executor import resolve_device
from .cache import DCLASSES, FAMILIES, block_key

#: tuned GEMM shapes (m, n, k): one bucket representative each
_SHAPES_FULL = ((512, 512, 1024), (2048, 2048, 2048))
_SHAPES_SMOKE = ((128, 128, 128), (256, 128, 256))

_N_MODULI_SMOKE = 4
_N_MODULI_FULL = 8


def _median_time_s(fn, iters: int, device: torch.device) -> float:
    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()  # build + warm
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def _make_entry(family: str, dclass: str, m: int, n: int, k: int, n_moduli: int,
                device: torch.device):
    """A closure tile -> thunk that launches the slot's kernel once."""
    from ..core.moduli import make_crt_context
    from ..core.plan import n_limbs_for_ctx
    from ..kernels.fp8_mod_gemm import fp8_karatsuba_mod_gemm_batched, fp8_mod_gemm_batched
    from ..kernels.int8_mod_gemm import fused_mod_gemm, int8_mod_gemm_batched
    from ..kernels.karatsuba_fused import fused_karatsuba_mod_gemm, karatsuba_mod_gemm_batched

    ctx = make_crt_context(n_moduli)
    rng = np.random.default_rng(0)

    def planes(shape):
        return torch.from_numpy(rng.integers(-60, 61, shape, dtype=np.int8)).to(device)

    if family in ("kernel", "fp8"):
        if dclass == "real":
            kern = fp8_mod_gemm_batched if family == "fp8" else int8_mod_gemm_batched
            a, b = planes((n_moduli, m, k)), planes((n_moduli, k, n))
            return lambda tile: lambda: kern(a, b, moduli=ctx.moduli, tile=tile)
        kern = fp8_karatsuba_mod_gemm_batched if family == "fp8" else karatsuba_mod_gemm_batched
        ops = (planes((n_moduli, m, k)), planes((n_moduli, m, k)),
               planes((n_moduli, k, n)), planes((n_moduli, k, n)))
        return lambda tile: lambda: kern(*ops, moduli=ctx.moduli, tile=tile)

    if family != "fused":
        raise ValueError(f"unknown kernel family {family!r}")
    n_limbs = n_limbs_for_ctx(ctx)
    e_mu = torch.zeros((m,), dtype=torch.int32, device=device)
    e_nu = torch.zeros((n,), dtype=torch.int32, device=device)

    def mant(shape):
        return torch.from_numpy(rng.integers(-500, 501, shape).astype(np.float32)).to(device)

    if dclass == "real":
        a, b = mant((m, k)), mant((k, n))
        return lambda tile: lambda: fused_mod_gemm(a, b, e_mu, e_nu, ctx, n_limbs=n_limbs, tile=tile)
    ar, ai, br, bi = mant((m, k)), mant((m, k)), mant((k, n)), mant((k, n))
    return lambda tile: lambda: fused_karatsuba_mod_gemm(
        ar, ai, br, bi, e_mu, e_nu, ctx, n_limbs=n_limbs, tile=tile)


def autotune_blocks(
    smoke: bool = False,
    *,
    families: tuple[str, ...] = FAMILIES,
    dclasses: tuple[str, ...] = DCLASSES,
    shapes: tuple[tuple[int, int, int], ...] | None = None,
    iters: int = 2,
    verbose: bool = False,
    device=None,
) -> dict:
    """Time every slot's candidate tiles; returns {block_key: (bm, bn, bk)}.

    `device=None` is the card (raises without one).
    """
    from ..kernels.common import COMPILED_TILES

    device = resolve_device(device)
    shapes = shapes or (_SHAPES_SMOKE if smoke else _SHAPES_FULL)
    n_moduli = _N_MODULI_SMOKE if smoke else _N_MODULI_FULL
    winners: dict = {}
    for family in families:
        for dclass in dclasses:
            for m, n, k in shapes:
                entry = _make_entry(family, dclass, m, n, k, n_moduli, device)
                key = block_key(family, dclass, m, n, k)
                best, best_t = None, float("inf")
                for tile in COMPILED_TILES[family, dclass]:  # the default first
                    t = _median_time_s(entry(tile), iters, device)
                    if verbose:
                        print(f"  tune {family}/{dclass} {m}x{n}x{k} {tile}: {t * 1e6:.0f} us")
                    if t < best_t:
                        best, best_t = tile, t
                winners[key] = best
    return winners
