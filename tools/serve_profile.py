#!/usr/bin/env python3
"""Profile the port's serving path on the card: how sensitive the model is
to its products' rounding, and where a decode step's time goes.

Run from the root of a checkout on a machine with the card:

    python3 tools/serve_profile.py [--arch starcoder2-3b] [--steps 2]

It builds the kernels, initialises the arch's published config in float32
(torch.Generator seed 0, drawn on the card; as `chip_smoke.py` phase 7b)
and takes 4 prompts of 128 tokens from `np.random.default_rng(0)`.

1. Sensitivity: the prompts' forward pass layer by layer with native
   float32 linears, with float64 linears (the same weights cast; norms,
   attention and head stay float32, as the model computes them) and with
   emulated linears (`GemmPolicy(backend="ozaki2_f32",
   execution="kernel")`).  Prints the residual stream's max|h| after each
   layer and, for the last position's hidden state and the logits,
   max|x - x64| / max|x64| of native float32 and of emulated.
2. Time: for the native engine and the prepared `kernel` engine, a prefill
   and then `--steps` decode steps (`Model.decode_step`) under
   `torch.profiler` (CPU and CUDA activities), then `--steps` more
   unprofiled.  Prints a step's wall time unprofiled (host clock around a
   synchronize), and profiled its host time (the CPU events' self time,
   the profiler's cost included), device time (the CUDA kernels' self
   time), kernel launches (`cudaLaunchKernel` calls) and the top
   operators by each.

Prints a JSON line {"card", "arch", "sensitivity": {...}, "decode":
{engine: {"wall_ms", "host_ms", "device_ms", "launches", "top_device":
[[kernel, ms], ...]}}} last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import GemmPolicy
    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve import ServeEngine

    card = card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch, dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = prompt_batch(cfg, 4, 128, rng, dev)
    emulated = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    (bk, mk, _), = cfg.layer_groups

    def trace(policy, p):
        model = Model(dataclasses.replace(cfg, gemm_policy=policy))
        with torch.no_grad():
            h, pos = model._embed_inputs(p, batch)
            mags, last = [], []
            for i in range(cfg.n_layers):
                h, _ = model._layer(layer_params(p["groups"][0], i), bk, mk, h, pos)
                mags.append(float(h.abs().max()))
                last.append(h[:, -1].double().cpu())
            logits = model._head(p, apply_norm(cfg.norm, p["final_norm"], h)[:, -1:]).double().cpu()
        return logits, mags, last

    n32, mags, h32 = trace(NATIVE, params)
    p64 = torch.utils._pytree.tree_map(lambda t: t.double(), params)
    n64, _, h64 = trace(NATIVE, p64)
    del p64
    torch.cuda.empty_cache()
    e32, _, he = trace(emulated, params)
    sens = {
        "residual_max_by_layer": mags,
        "native_f32_hidden_by_layer": [rel(a, b) for a, b in zip(h32, h64)],
        "emulated_hidden_by_layer": [rel(a, b) for a, b in zip(he, h64)],
        "native_f32_logits": rel(n32, n64),
        "emulated_logits": rel(e32, n64),
    }
    print("residual max|h| by layer:", " ".join(f"{x:.4g}" for x in mags), flush=True)
    for name in ("native_f32_hidden_by_layer", "emulated_hidden_by_layer"):
        print(f"{name} (last position, against float64 linears):",
              " ".join(f"{x:.3e}" for x in sens[name]), flush=True)
    print(f"logits against float64 linears: native float32 {sens['native_f32_logits']:.4e}, "
          f"emulated {sens['emulated_logits']:.4e}", flush=True)

    decode = {}
    for name, policy, prepare in (("native", NATIVE, False), ("kernel prepared", emulated, True)):
        eng = ServeEngine(Model(dataclasses.replace(cfg, gemm_policy=policy)), params, 128 + 2 * args.steps, 4,
                          prepare=prepare)
        eng.generate(batch, 2)  # warm-up
        with torch.no_grad():
            cache = eng.model.init_cache(4, 128 + 2 * args.steps)
            logits, cache = eng.model.prefill(eng.params, batch, cache)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(args.steps):
                    logits, cache = eng.model.decode_step(eng.params, tok, cache, 128 + i)
                torch.cuda.synchronize()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.steps):
                logits, cache = eng.model.decode_step(eng.params, tok, cache, 128 + args.steps + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        top = sorted(((e.key, e.self_device_time_total / 1e3 / args.steps) for e in kernels), key=lambda kv: -kv[1])
        decode[name] = {
            "wall_ms": wall_ms,
            "host_ms": sum(e.self_cpu_time_total for e in events if e.device_type == DeviceType.CPU)
            / 1e3 / args.steps,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps,
            "launches": launches / args.steps,
            "top_device": [[k, v] for k, v in top[:8]],
        }
        print(f"{name}: a decode step {wall_ms:.3f} ms unprofiled; profiled, "
              f"{decode[name]['host_ms']:.3f} ms of host time, {decode[name]['device_ms']:.3f} ms of device "
              f"time, {decode[name]['launches']:.0f} launches", flush=True)
        print(events.table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "arch": args.arch, "sensitivity": sens, "decode": decode}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
