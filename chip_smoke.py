#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (`nvcc`):

    python3 chip_smoke.py

It imports torch, numpy and `repro_torch` only.  Inputs come from
`np.random.default_rng(SEED)` with the paper's phi-generator (phi = 0.5).
Any mismatch or exception ends the run with a non-zero exit; no phase's
failure is caught.

1. Build the four CUDA kernels from `src/repro_torch/kernels/csrc`, one
   `nvcc` each, all at once.
2. Hold each kernel against its plain PyTorch version on the card, bitwise
   (`torch.equal`): the chain scale -> cast (rows and columns, S = 1 or 2)
   -> product (with and without carry) -> Garner (f32 and double-single) at
   a ragged (257, 1000, 129) and at the main path's 4096^3 (N = 8 real,
   N = 14 complex).  Times each kernel and its plain version at the main
   path's shapes with CUDA events; for the two GEMM kernels also
   `torch._int_mm` over the same int8 planes, a product-only yardstick.
3. End to end through `repro_torch.linalg` with
   `GemmPolicy(execution="kernel")`:
   (a) s/d/c/zgemm at 512^3, fast and accu: bitwise equal to the same call
       with device="cpu", which runs the plain versions;
   (b) the main path: s/d/c/zgemm at 4096^3 and zgemm at 8192^3, fast mode.
       The launch counters are zeroed just before and read just after: each
       GEMM is exactly 4 launches (cast, cast, product, reconstruct).  Times
       beside native `torch.matmul` in the same dtype (cuBLAS); relative
       error max|C - C_ref| / max|C_ref| against torch.matmul in
       float64/complex128 on the same operands must stay below 1e-4 (the
       kernel path is f32-grade by design; phase 3(a) is the exactness check).

The last lines are the kernels' JSON record, the card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
PHI = 0.5
# NVIDIA H100 SXM data-sheet peaks (dense), at the full 700 W power limit
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12

# the Pallas kernel each CUDA kernel replaces
KERNELS = {
    "residue_cast": "src/repro/kernels/residue_cast.py:37",
    "int8_mod_gemm": "src/repro/kernels/int8_mod_gemm.py:51",
    "karatsuba_fused": "src/repro/kernels/karatsuba_fused.py:60",
    "crt_garner": "src/repro/kernels/crt_garner.py:97",
}
RAGGED = (257, 1000, 129)  # (m, k, n) off every tile multiple
MAIN = 4096                # the main path's m = n = k
BIG = 8192                 # the largest zgemm of the main path
SMALL = 512                # the card-vs-cpu end-to-end parity size


def phi_matrix(rng, shape, phi, dtype):
    """The paper's SIV-A test-matrix generator: (rand-0.5)*exp(randn*phi)."""
    u = rng.random(shape)
    g = rng.standard_normal(shape)
    m = (u - 0.5) * np.exp(g * phi)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        u2 = rng.random(shape)
        g2 = rng.standard_normal(shape)
        m = m + 1j * (u2 - 0.5) * np.exp(g2 * phi)
    return m.astype(dtype)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


class KernelChecks:
    """Phase 2: each kernel against its plain version, bitwise, on the card."""

    def __init__(self, rng, dev):
        from repro_torch.kernels import crt_garner, int8_mod_gemm, karatsuba_fused, residue_cast

        self.rng, self.dev = rng, dev
        self.mods = (residue_cast, int8_mod_gemm, karatsuba_fused, crt_garner)
        self.record = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def compare(self, name, kernel, plain, *, timed=None):
        """Run `kernel()` and `plain()`, require equal bits, and with `timed`
        = (label, bytes, ops, ops_per_s, reps) time both and keep the numbers."""
        got, want = kernel(), plain()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = 0.0
        for g, w in pairs:
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}: kernel differs from its plain version in {bad} elements")
            err = max(err, float((g.double() - w.double()).abs().max()))
        self.record[name]["max_abs_err"] = max(self.record[name]["max_abs_err"], err)
        if timed is not None:
            label, nbytes, ops, ops_per_s, reps = timed
            byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
            row = {
                "ms": cuda_ms(kernel, reps),
                "plain_ms": cuda_ms(plain, max(1, reps // 5)),
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "shape": label,
            }
            self.record[name].update(row)
            print(f"  {name} {label}: kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        return got

    def int_mm_yardstick(self, name, planes):
        """torch._int_mm over the same int8 (m,k)x(k,n) planes: the products
        alone, without the mod epilogue (a yardstick, not the function)."""
        ms = cuda_ms(lambda: [torch._int_mm(a, b) for a, b in planes], 3)
        self.record[name]["int_mm_ms"] = ms
        print(f"  {name}: torch._int_mm over the same {len(planes)} int8 products "
              f"(product-only yardstick) ms={ms:.4f}", flush=True)

    def chain(self, shape, dtype, n_mod, timed):
        from repro_torch.core import scaling
        from repro_torch.core.moduli import make_crt_context
        from repro_torch.core.plan import n_limbs_for_ctx
        from repro_torch.kernels.common import split_scale_exponent

        rc, ig, kf, cg = self.mods
        m, k, n = shape
        ctx = make_crt_context(n_mod)
        nl = n_limbs_for_ctx(ctx)
        mods = ctx.moduli
        a = torch.from_numpy(phi_matrix(self.rng, (m, k), PHI, dtype)).to(self.dev)
        b = torch.from_numpy(phi_matrix(self.rng, (k, n), PHI, dtype)).to(self.dev)
        complex_ = a.is_complex()
        if complex_:
            e_mu, e_nu = scaling.scale_fast_complex(a.real, a.imag, b.real, b.imag, ctx)
            xa = torch.stack([a.real, a.imag]).float()
            xb = torch.stack([b.real, b.imag]).float()
        else:
            e_mu, e_nu = scaling.scale_fast_real(a, b, ctx)
            xa, xb = a.float()[None], b.float()[None]
        s = xa.shape[0]
        label = f"{m}x{k}x{n} N={n_mod} {'complex' if complex_ else 'real'}"

        def cast(x, e, axis, t=None):
            s1, s2 = split_scale_exponent(e)
            kw = dict(moduli=mods, n_limbs=nl, scale_axis=axis)
            return self.compare(
                "residue_cast",
                lambda: rc.residue_cast(x, s1, s2, **kw),
                lambda: rc.residue_cast_plain(x, s1, s2, **kw),
                timed=t,
            )

        rows, cols = xa.shape[1:]
        cast_t = None
        if timed:
            numel = s * rows * cols
            cast_t = (f"S={s} {rows}x{cols} N={n_mod}", numel * (4 + n_mod) + 8 * rows,
                      numel * (1 + 4 * n_mod * nl), F32_OPS_S, 20)
        ares = cast(xa, e_mu, 0, cast_t)
        bres = cast(xb, e_nu, 1)

        if complex_:
            arr, ari = ares[0], ares[1]
            brr, bri = bres[0], bres[1]
            prod_t = None
            if timed:
                prod_t = (label, n_mod * (2 * m * k + 2 * k * n + 2 * m * n),
                          3 * 2 * n_mod * m * n * k, INT8_OPS_S, 5)
            first = self.compare(
                "karatsuba_fused",
                lambda: kf.karatsuba_mod_gemm_batched(arr, ari, brr, bri, moduli=mods),
                lambda: kf.karatsuba_mod_gemm_plain(arr, ari, brr, bri, moduli=mods),
                timed=prod_t,
            )
            self.compare(
                "karatsuba_fused",
                lambda: kf.karatsuba_mod_gemm_batched(arr, ari, brr, bri, moduli=mods, carry=first),
                lambda: kf.karatsuba_mod_gemm_plain(arr, ari, brr, bri, moduli=mods, carry=first),
            )
            if timed:
                self.int_mm_yardstick("karatsuba_fused", [
                    (x[l], y[l]) for l in range(n_mod) for x, y in ((arr, brr), (ari, bri), (arr, bri))])
            e_res = torch.stack(first)
        else:
            prod_t = None
            if timed:
                prod_t = (label, n_mod * (m * k + k * n + m * n), 2 * n_mod * m * n * k, INT8_OPS_S, 5)
            first = self.compare(
                "int8_mod_gemm",
                lambda: ig.int8_mod_gemm_batched(ares[0], bres[0], moduli=mods),
                lambda: ig.int8_mod_gemm_plain(ares[0], bres[0], moduli=mods),
                timed=prod_t,
            )
            self.compare(
                "int8_mod_gemm",
                lambda: ig.int8_mod_gemm_batched(ares[0], bres[0], moduli=mods, carry=first),
                lambda: ig.int8_mod_gemm_plain(ares[0], bres[0], moduli=mods, carry=first),
            )
            if timed:
                self.int_mm_yardstick("int8_mod_gemm", [(ares[0][l], bres[0][l]) for l in range(n_mod)])
            e_res = first[None]

        for out_dd in (complex_, not complex_):
            garner_t = None
            if timed and out_dd == complex_:
                numel = e_res.shape[0] * m * n
                digit_ops = 8 * n_mod * (n_mod - 1) // 2 + 30 * n_mod + 4
                garner_t = (f"S={e_res.shape[0]} {m}x{n} N={n_mod} out_dd={out_dd}",
                            numel * (n_mod + (8 if out_dd else 4)) + 8 * (m + n),
                            numel * digit_ops, F32_OPS_S, 10)
            self.compare(
                "crt_garner",
                lambda: cg.crt_garner(e_res, e_mu, e_nu, ctx, out_dd=out_dd),
                lambda: cg.crt_garner_plain(e_res, e_mu, e_nu, ctx, out_dd=out_dd),
                timed=garner_t,
            )


ROUTINES = {"sgemm": np.float32, "dgemm": np.float64, "cgemm": np.complex64, "zgemm": np.complex128}


def end_to_end_cpu_parity(rng, dev, GemmPolicy, linalg):
    """Phase 3(a): SMALL^3 on the card (device=None) bitwise equal to device='cpu'."""
    for routine, dtype in ROUTINES.items():
        a = phi_matrix(rng, (SMALL, SMALL), PHI, dtype)
        b = phi_matrix(rng, (SMALL, SMALL), PHI, dtype)
        for mode in ("fast", "accu"):
            pol = GemmPolicy(execution="kernel", mode=mode)
            on_card = getattr(linalg, routine)(a, b, policy=pol)
            on_cpu = getattr(linalg, routine)(a, b, policy=pol, device="cpu")
            if on_card.device.type != dev.type or not torch.equal(on_card.cpu(), on_cpu):
                raise AssertionError(f"{routine} {mode} {SMALL}^3: the card differs from device='cpu'")
            print(f"  {routine} {mode} {SMALL}^3: card == cpu, bitwise", flush=True)


def main_path(rng, dev, GemmPolicy, linalg, kernels):
    """Phase 3(b): the main path, with the launch counters."""
    expect_real = {"residue_cast": 2, "int8_mod_gemm": 1, "karatsuba_fused": 0, "crt_garner": 1}
    expect_complex = {"residue_cast": 2, "int8_mod_gemm": 0, "karatsuba_fused": 1, "crt_garner": 1}
    runs = [(routine, dtype, MAIN) for routine, dtype in ROUTINES.items()]
    runs.append(("zgemm", np.complex128, BIG))
    pol = GemmPolicy(execution="kernel", mode="fast")
    operands = []
    for routine, dtype, size in runs:
        a = torch.from_numpy(phi_matrix(rng, (size, size), PHI, dtype)).to(dev)
        b = torch.from_numpy(phi_matrix(rng, (size, size), PHI, dtype)).to(dev)
        operands.append((a, b))
    torch.cuda.synchronize()

    kernels.reset_launches()
    for (routine, dtype, size), (a, b) in zip(runs, operands):
        fn = getattr(linalg, routine)
        reps = 3 if size < BIG else 1
        before = kernels.launch_counts()
        y = fn(a, b, policy=pol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            y = fn(a, b, policy=pol)
        torch.cuda.synchronize()
        emu_ms = (time.perf_counter() - t0) / reps * 1e3
        calls = 1 + reps
        expect = expect_complex if a.is_complex() else expect_real
        delta = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if delta != {k: v * calls for k, v in expect.items()}:
            raise AssertionError(f"{routine} {size}^3: launches {delta} for {calls} GEMMs, expected 4 each")
        native_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        wide = torch.complex128 if a.is_complex() else torch.float64
        ref = torch.matmul(a.to(wide), b.to(wide))
        rel = float((y.to(wide) - ref).abs().max() / ref.abs().max())
        del ref
        flops = (8 if a.is_complex() else 2) * size**3
        print(f"  {routine} {size}^3 fast: emulated_ms={emu_ms:.3f} ({flops / emu_ms / 1e9:.2f} TFLOPS) "
              f"torch.matmul_ms={native_ms:.3f} ({flops / native_ms / 1e9:.2f} TFLOPS) "
              f"speedup={native_ms / emu_ms:.3f} rel_err={rel:.3e} launches/GEMM=4", flush=True)
        if not rel < 1e-4:
            raise AssertionError(f"{routine} {size}^3: relative error {rel} >= 1e-4")
    counts = kernels.launch_counts()
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels as kernels
    from repro_torch import GemmPolicy, linalg
    from repro_torch.kernels import build

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {card_line()}", flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"  built {len(logs)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    print("phase 2: kernels against their plain versions, bitwise", flush=True)
    checks = KernelChecks(rng, dev)
    checks.chain(RAGGED, np.float32, 8, timed=False)
    checks.chain(RAGGED, np.complex64, 14, timed=False)
    checks.chain((MAIN, MAIN, MAIN), np.float32, 8, timed=True)
    checks.chain((MAIN, MAIN, MAIN), np.complex128, 14, timed=True)
    torch.cuda.synchronize()
    print("  all four kernels equal their plain versions", flush=True)

    print(f"phase 3a: {SMALL}^3 end to end, card vs device='cpu'", flush=True)
    end_to_end_cpu_parity(rng, dev, GemmPolicy, linalg)

    print("phase 3b: main path", flush=True)
    counts = main_path(rng, dev, GemmPolicy, linalg, kernels)
    print(f"  main-path launches: {counts}", flush=True)

    record = []
    for name, replaces in KERNELS.items():
        r = checks.record[name]
        record.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "int_mm_ms": r.get("int_mm_ms"),
            "shape": r["shape"],
        })
    print(json.dumps({"kernels": record}), flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
