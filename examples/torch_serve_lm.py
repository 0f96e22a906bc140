"""Batched serving on the PyTorch/CUDA port: prefill + KV-cache decode
with sampling, on the card by default.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen2.5-32b] \
        [--backend ozaki2_f32] [--execution kernel] \
        [--prepare] [--prepared-dir DIR] [--device cpu]

The twin of `examples/serve_lm.py` (uses the reduced config of the chosen
architecture).  With an emulated --backend, the whole model is routed
onto the selected GemmPolicy via a `repro_torch.use_policy` scope around
config construction, the context-scoped drop-in deployment path.
--prepare residue-casts the weights once at engine construction;
--prepared-dir persists those planes so a restarted server restores them
instead of re-preparing.
"""
import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

import repro_torch
from repro_torch import GemmPolicy
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.core.executor import resolve_device
from repro_torch.models import Model
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-32b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--backend", default="native",
                    choices=["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"])
    ap.add_argument("--execution", default="reference",
                    choices=["reference", "kernel", "per_modulus_kernel", "fused", "fp8"])
    ap.add_argument("--prepare", action="store_true",
                    help="residue-cast the weights once at construction")
    ap.add_argument("--prepared-dir", default=None,
                    help="persist/restore the prepared residue planes here")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scope = contextlib.nullcontext()
    if args.backend != "native":
        scope = repro_torch.use_policy(GemmPolicy(backend=args.backend, execution=args.execution))
    with scope:
        # the config pins the ambient policy at construction, so every
        # matmul in the model runs on the selected backend/execution
        cfg = get_reduced(args.arch)
    if args.backend != "native":
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    npre = cfg.n_prefix_embeds if cfg.frontend else 0
    cache_len = args.prompt_len + npre + args.new_tokens
    eng = ServeEngine(model, params, cache_len=cache_len, batch_size=args.batch,
                      prepare=args.prepare, prepared_dir=args.prepared_dir, device=dev)

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32))}
    if cfg.frontend:
        batch["prefix_embeds"] = torch.from_numpy(
            (rng.standard_normal((args.batch, npre, cfg.d_model)) * 0.02).astype(np.float32))
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    toks = eng.generate(batch, args.new_tokens, args.temperature, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"{args.arch}: generated {tuple(toks.shape)} in {dt:.2f}s ({total / dt:.1f} tok/s on {where})")
    print("sample:", toks[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
