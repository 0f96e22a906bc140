#!/usr/bin/env python3
"""Time the six GEMM kernels, the residue cast, the Garner reconstruction,
the attention kernel and the launch-timing copy kernel of one checkout's
`repro_torch` on the card.

Each GEMM kernel runs at the main path's shape (m = n = k = 4096; N = 8
moduli real, 14 complex) through its wrapper's plain call, which launches
the kernel's default tile; the int8 real kernel also at n = 4092
(`int8_mod_gemm:global`) and at k = 4092 (`int8_mod_gemm:global_k`): not
multiples of 16, so its global-load path where it has one, A by 16-byte
loads in the first, by 4-byte words in the second.  The residue cast runs at the complex main
path's casts (S = 2 stacked 4096 x 4096 f32 parts, N = 14), once with row
scales (`residue_cast:rows`, scale_axis 0, A's cast) and once with column
scales (`residue_cast:cols`, B's); the Garner reconstruction at its
(S = 2, N = 14, 4096 x 4096) residues to double-single output
(`crt_garner`); their exponents come from the port's fast scaling of phi =
0.5 operands (seed 0).  The attention kernel runs one causal 32k prefill
at Qwen2.5-32B's widths (B = 1, S = 32768, H = 40, KV = 8, D = 128, bf16)
through `flash_attention`, where the checkout has it.  Each is timed with
CUDA events (mean of `--reps` launches after a warm-up).  The copy
kernel (`launch_copy`, on the calibration's (8, 128) f32 tile) and
`x.clone()` beside it are timed as the device sees
them: 1000 launches each, enqueued while the stream is held busy, so the
host's launch path does not pace them (`launch_copy` and `x.clone` in the
output).  The calls take no tile argument, so the script also
times a checkout from before the kernels took one.  To compare two
checkouts, run it on both on the same card within one job, in turns (a, b,
b, a):

    python3 tools/kernel_times.py --src PATH/TO/CHECKOUT/src

It builds that checkout's kernels first (into its `build/`), holds each
GEMM kernel it times against its plain version, bitwise, at (m, k, n) =
(257, 1000, 129) and (257, 1024, 144) (ragged edges; k and n off and on
multiples of 16), the residue cast and the Garner reconstruction at a
ragged (S, m, k) = (2, 257, 1001) (odd k: the cast's scalar path), both
scale axes and both outputs (floating outputs through their integer views,
`chip_smoke.same_bits`, so a zero's sign counts), and prints one JSON line: {"src", "card",
"ms": {kernel: ms}, "bitwise": {kernel: bool}}; it exits 1 if a kernel
disagrees.  `--only NAME [NAME ...]` builds and times only those kernels
(a tree that differs from another in one source).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np


def check(name, rng, dev) -> bool:
    """GEMM kernel `name` against its plain version, bitwise, at two ragged
    shapes (N = 8 real, 14 complex; canonical residue planes for the
    product kernels, f32 integers for the megakernels, with and without
    chunk reductions)."""
    import torch

    from chip_smoke import same_bits
    from repro_torch.core.moduli import make_crt_context
    from repro_torch.core.plan import n_limbs_for_ctx
    from repro_torch.kernels import fp8_mod_gemm as f8, int8_mod_gemm as ig, karatsuba_fused as kf

    def same(got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        return all(same_bits(g, w) for g, w in pairs)

    if name in ("residue_cast", "crt_garner"):
        return check_cast_garner(name, rng, dev)
    ok = True
    for m, k, n in ((257, 1000, 129), (257, 1024, 144)):
        ctx = make_crt_context(14 if name in ("karatsuba_fused", "fused_karatsuba", "fp8_karatsuba") else 8)
        mods = ctx.moduli

        def planes(shape):
            return torch.from_numpy(np.stack([rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, shape)
                                              for p in mods]).astype(np.int8)).to(dev)

        def mant(shape):
            return torch.from_numpy(rng.integers(-500, 501, shape).astype(np.float32)).to(dev)

        zm, zn = (torch.zeros(x, dtype=torch.int32, device=dev) for x in (m, n))
        if name in ("int8_mod_gemm", "fp8_mod_gemm"):
            a, b = planes((m, k)), planes((k, n))
            mod = ig if name == "int8_mod_gemm" else f8
            fn, plain = (getattr(mod, f"{name}_batched"), getattr(mod, f"{name}_plain"))
            ok &= same(fn(a, b, moduli=mods), plain(a, b, moduli=mods))
        elif name in ("karatsuba_fused", "fp8_karatsuba"):
            ops = [planes(shape) for shape in ((m, k), (m, k), (k, n), (k, n))]
            fn, plain = ((kf.karatsuba_mod_gemm_batched, kf.karatsuba_mod_gemm_plain) if name == "karatsuba_fused"
                         else (f8.fp8_karatsuba_mod_gemm_batched, f8.fp8_karatsuba_mod_gemm_plain))
            ok &= same(fn(*ops, moduli=mods), plain(*ops, moduli=mods))
        elif name == "fused_mod_gemm":
            a, b = mant((m, k)), mant((k, n))
            for out_dd in (False, True):
                kw = dict(n_limbs=n_limbs_for_ctx(ctx), out_dd=out_dd, chunk_limit=256)
                ok &= same(ig.fused_mod_gemm(a, b, zm, zn, ctx, **kw), ig.fused_mod_gemm_plain(a, b, zm, zn, ctx, **kw))
        elif name == "fused_karatsuba":
            ops = [mant(shape) for shape in ((m, k), (m, k), (k, n), (k, n))]
            kw = dict(n_limbs=n_limbs_for_ctx(ctx), chunk_limit=256)
            ok &= same(kf.fused_karatsuba_mod_gemm(*ops, zm, zn, ctx, **kw),
                       kf.fused_karatsuba_mod_gemm_plain(*ops, zm, zn, ctx, **kw))
    return bool(ok)


def scaled_operands(rng, dev, ctx, m, k, n):
    """(A, B) complex phi = 0.5 operands as stacked (2, m, k) and (2, k, n)
    f32 parts on the card, with the port's fast-mode exponents (e_mu, e_nu)
    for `ctx`."""
    import torch

    from repro_torch.core import scaling

    def phi(shape):
        re_, im_ = ((rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * 0.5) for _ in range(2))
        return torch.from_numpy((re_ + 1j * im_).astype(np.complex64)).to(dev)

    a, b = phi((m, k)), phi((k, n))
    e_mu, e_nu = scaling.scale_fast_complex(a.real, a.imag, b.real, b.imag, ctx)
    return torch.stack([a.real, a.imag]).float(), torch.stack([b.real, b.imag]).float(), e_mu, e_nu


def check_cast_garner(name, rng, dev) -> bool:
    """The residue cast (both scale axes) or the Garner reconstruction (f32
    and double-single) against its plain version, bitwise, at (S, m, k) =
    (2, 257, 1001), N = 14."""
    import torch

    from chip_smoke import same_bits
    from repro_torch.core.moduli import make_crt_context
    from repro_torch.core.plan import n_limbs_for_ctx
    from repro_torch.kernels import crt_garner as cg, residue_cast as rc
    from repro_torch.kernels.common import split_scale_exponent

    ctx = make_crt_context(14)
    xa, xb, e_mu, e_nu = scaled_operands(rng, dev, ctx, 257, 1001, 129)
    if name == "residue_cast":
        ok = True
        for x, e, axis in ((xa, e_mu, 0), (xb, e_nu, 1)):
            kw = dict(moduli=ctx.moduli, n_limbs=n_limbs_for_ctx(ctx), scale_axis=axis)
            ok &= same_bits(rc.residue_cast(x, *split_scale_exponent(e), **kw),
                              rc.residue_cast_plain(x, *split_scale_exponent(e), **kw))
        return bool(ok)
    e_nu = torch.from_numpy(rng.integers(-30, 30, 1001).astype(np.int32)).to(dev)
    planes = torch.from_numpy(np.stack([rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, (2, 257, 1001))
                                        for p in ctx.moduli], axis=1).astype(np.int8)).to(dev)
    return all(same_bits(cg.crt_garner(planes, e_mu, e_nu, ctx, out_dd=dd),
                           cg.crt_garner_plain(planes, e_mu, e_nu, ctx, out_dd=dd)) for dd in (False, True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the `src` directory of the checkout to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="+", metavar="NAME", help="build and time only these kernels")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))  # chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.moduli import make_crt_context
    from repro_torch.core.plan import n_limbs_for_ctx
    import repro_torch.kernels as kernels
    from repro_torch.kernels import build, crt_garner, fp8_mod_gemm, int8_mod_gemm, karatsuba_fused, residue_cast
    from repro_torch.kernels.common import split_scale_exponent

    if args.only:
        for name in args.only:
            build.library(name)
    else:
        build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    size = 4096

    def planes(n_mod, shape):
        return torch.from_numpy(rng.integers(-60, 61, (n_mod, *shape), dtype=np.int8)).to(dev)

    def mant(shape):
        return torch.from_numpy(rng.integers(-500, 501, shape).astype(np.float32)).to(dev)

    real, cplx = make_crt_context(8), make_crt_context(14)
    a, b = planes(8, (size, size)), planes(8, (size, size))
    b_global = planes(8, (size, size - 4))  # n a multiple of 4, not of 16: the global-load path
    a_k, b_k = planes(8, (size, size - 4)), planes(8, (size - 4, size))  # k a multiple of 4, not of 16
    ar, ai, br, bi = (planes(14, (size, size)) for _ in range(4))
    fa, fb = mant((size, size)), mant((size, size))
    far, fai, fbr, fbi = (mant((size, size)) for _ in range(4))
    zeros = torch.zeros(size, dtype=torch.int32, device=dev)
    xa, xb, e_mu, e_nu = scaled_operands(rng, dev, cplx, size, size, size)
    cast = dict(moduli=cplx.moduli, n_limbs=n_limbs_for_ctx(cplx))
    sa, sb = split_scale_exponent(e_mu), split_scale_exponent(e_nu)
    e_res = torch.stack([planes(14, (size, size)) for _ in range(2)])  # (CR, CI) residues, |r| <= 60 < p / 2
    calls = {
        "residue_cast:rows": lambda: residue_cast.residue_cast(xa, *sa, scale_axis=0, **cast),
        "residue_cast:cols": lambda: residue_cast.residue_cast(xb, *sb, scale_axis=1, **cast),
        "crt_garner": lambda: crt_garner.crt_garner(e_res, e_mu, e_nu, cplx, out_dd=True),
        "int8_mod_gemm": lambda: int8_mod_gemm.int8_mod_gemm_batched(a, b, moduli=real.moduli),
        "int8_mod_gemm:global": lambda: int8_mod_gemm.int8_mod_gemm_batched(a, b_global, moduli=real.moduli),
        "int8_mod_gemm:global_k": lambda: int8_mod_gemm.int8_mod_gemm_batched(a_k, b_k, moduli=real.moduli),
        "karatsuba_fused": lambda: karatsuba_fused.karatsuba_mod_gemm_batched(ar, ai, br, bi, moduli=cplx.moduli),
        "fused_mod_gemm": lambda: int8_mod_gemm.fused_mod_gemm(
            fa, fb, zeros, zeros, real, n_limbs=n_limbs_for_ctx(real)),
        "fused_karatsuba": lambda: karatsuba_fused.fused_karatsuba_mod_gemm(
            far, fai, fbr, fbi, zeros, zeros, cplx, n_limbs=n_limbs_for_ctx(cplx)),
        "fp8_mod_gemm": lambda: fp8_mod_gemm.fp8_mod_gemm_batched(a, b, moduli=real.moduli),
        "fp8_karatsuba": lambda: fp8_mod_gemm.fp8_karatsuba_mod_gemm_batched(ar, ai, br, bi, moduli=cplx.moduli),
    }
    if "flash_attention" in kernels.WRAPPERS:
        # its own names: the GEMM calls above close over `a` and `b`
        bsz, seq, heads, kv_heads, hd = 1, 32768, 40, 8, 128
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).to(torch.bfloat16)
                   for shape in ((bsz, seq, heads, hd), (bsz, seq, kv_heads, hd), (bsz, seq, kv_heads, hd)))
        calls["flash_attention"] = lambda: kernels.flash_attention.flash_attention(q, k, v)
    if args.only:
        calls = {name: call for name, call in calls.items() if name.split(":")[0] in args.only}
    bitwise = {name: check(name, rng, dev) for name in dict.fromkeys(c.split(":")[0] for c in calls)
               if name != "flash_attention"}
    ms = {}
    if "launch_copy" in kernels.WRAPPERS and (not args.only or "launch_copy" in args.only):
        from chip_smoke import device_ms
        from repro_torch.kernels.launch_copy import launch_copy

        x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)).to(dev)
        for name, fn in (("launch_copy", lambda: launch_copy(x)), ("x.clone", x.clone)):
            ms[name] = device_ms(fn, 1000)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / args.reps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"src": args.src, "card": card, "ms": ms, "bitwise": bitwise}), flush=True)
    return 0 if all(bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
