"""Serving launcher (batched prefill + decode) of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
        --batch 8 --prompt-len 64 --new-tokens 64 [--temperature 0.8] \\
        [--backend ozaki2_f32] [--execution kernel] \\
        [--prepare] [--prepared-dir DIR] [--device cpu]

The reference's serving CLI (`repro.launch.serve`) with the same flags,
plus ``--device`` (default: the card; ``--device cpu`` runs the kernels'
plain versions).  It serves the arch's reduced config with random weights
(`torch.Generator` seed 0).  An emulated ``--backend`` scopes the model
onto that `GemmPolicy` via `repro_torch.use_policy` around the config
lookup and serves in float32, as the reference does; ``--execution``
picks the residue backend.  ``--execution sharded`` spreads every
emulated linear over a (1, 1, R) mesh of the run's ranks, R =
``--residue`` (default: every rank), clamped to the ranks there are:

    python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch starcoder2-3b --backend ozaki2_f32 --execution sharded --residue 2

Under the launcher each rank serves the same prompts and rank 0 alone
prints; without one it runs a world of one (`launch.mesh.init_world`).
A ``--residue`` other than 1 on another execution is refused.
``--prepare`` residue-casts the weights once at startup with the selected
execution; ``--prepared-dir`` keeps those planes so a restarted server
restores them instead of preparing again.  Every arch of
`configs.ARCHS` serves.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import use_policy
from ..configs import ARCHS, get_reduced
from ..core.executor import resolve_device
from ..core.policy import GemmPolicy
from ..models import Model
from ..serve import ServeEngine
from ..tune.cli import add_calibration_args, apply_calibration_args
from .mesh import init_world, make_host_mesh


def prompt_batch(cfg, batch: int, prompt_len: int, rng: np.random.Generator, device) -> dict:
    """Random prompts for `ServeEngine.generate`: (batch, prompt_len) int32
    tokens drawn from `rng`, then, for a frontend arch, its prefix
    embeddings (std 0.02, float32)."""
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(device)}
    if cfg.frontend:
        out["prefix_embeds"] = torch.from_numpy(
            (rng.standard_normal((batch, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)).to(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--prepare", action="store_true",
        help="residue-cast weights once at startup (emulated backends: "
             "amortizes the scheme's step 1 across all requests)",
    )
    ap.add_argument("--prepared-dir", default=None,
                    help="persist/restore prepared residue planes here")
    ap.add_argument("--backend", default="native",
                    choices=["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"])
    ap.add_argument("--execution", default="reference",
                    choices=["reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused"],
                    help="residue backend running the emulation plan (fp8: the e4m3 "
                         "digit-GEMM engine; fused: the one-launch megakernel)")
    ap.add_argument("--residue", type=int, default=1,
                    help="residue mesh-axis size of the sharded execution (default 1: "
                         "every rank of the run)")
    ap.add_argument("--mode", default="fast", choices=["fast", "accu", "auto"],
                    help="paper scaling mode; 'auto' picks the cheapest mode meeting "
                         "--rtol per shape")
    ap.add_argument("--rtol", type=float, default=None,
                    help="componentwise accuracy target (adaptive policy: fewest "
                         "moduli provably meeting it; required for --mode auto)")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    add_calibration_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    apply_calibration_args(args, device=device)
    if args.mode == "auto" and args.rtol is None:
        ap.error("--mode auto needs an accuracy target: pass --rtol")
    if args.residue != 1 and args.execution != "sharded":
        ap.error(f"--residue {args.residue} is the sharded execution's mesh axis; "
                 f"--execution {args.execution} has none")
    mesh, owned = None, False
    if args.execution == "sharded" and args.backend != "native":
        device, owned = init_world(device)
        mesh = make_host_mesh(1, 1, residue=args.residue if args.residue > 1 else dist.get_world_size(),
                              device_type=device.type)
    try:
        return _serve(args, device, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> int:
    scope = contextlib.nullcontext()
    if args.backend != "native":
        scope = use_policy(GemmPolicy(backend=args.backend, execution=args.execution, mesh=mesh,
                                      mode=args.mode, rtol=args.rtol))
    with scope:
        cfg = get_reduced(args.arch, **({} if args.backend == "native" else {"dtype": "float32"}))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    npre = cfg.n_prefix_embeds if cfg.frontend else 0
    eng = ServeEngine(
        model, params,
        cache_len=args.prompt_len + npre + args.new_tokens,
        batch_size=args.batch,
        prepare=args.prepare,
        prepared_dir=args.prepared_dir,
        device=device,
    )
    batch = prompt_batch(cfg, args.batch, args.prompt_len, np.random.default_rng(0), device)
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    toks = eng.generate(batch, args.new_tokens, args.temperature, gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if mesh is None or dist.get_rank() == 0:
        print(f"[{args.arch}] {tuple(toks.shape)} in {dt:.2f}s "
              f"({args.batch * args.new_tokens / dt:.1f} tok/s on {device.type})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
