"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 100 --batch 8 --seq 256 [--mesh DxM] [--ckpt-dir DIR] \\
        [--backend ozaki2_f32] [--execution kernel] [--mode accu] \\
        [--formulation auto] [--n-block auto] [--rtol 1e-6] \\
        [--seq-shard] [--vocab-chunk N] [--full] [--device cpu]

The reference's training CLI (`repro.launch.train`) with the same flags,
plus ``--device`` (default: the card; ``--device cpu`` runs the kernels'
plain versions).  The emulation flags mirror the `GemmPolicy` axes:
``--backend`` picks the compute dtype class (an emulated backend trains
in float32, as in the reference), ``--execution`` the residue backend,
``--mode`` / ``--formulation`` / ``--n-block`` the paper's accuracy and
strategy knobs.  It trains the arch's reduced config (``--full``: the
published one) from random weights (`torch.Generator` seed 0) on the
synthetic data, resuming from ``--ckpt-dir`` when it holds a
checkpoint, and prints ``[arch] loss first -> last``.

``--mesh DxM`` trains on a (data, model) mesh of the run's ranks, D x M
of them (`train.step`): the params split over 'model' by the reference's
rules, the optimizer state also over 'data' (ZeRO-1), the global batch's
rows over 'data'.  Its losses are bitwise those of one process with
``--grad-accum D`` (with ``--grad-accum G``: those of ``--grad-accum
D x G`` within rounding).  ``--residue R`` appends a
residue dim; ``--execution sharded`` then spreads every emulated linear
of the step over the model and residue dims (without ``--mesh``: a
(1, 1, R) mesh, R = ``--residue``, default every rank):

    python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train \
        --arch mamba2-130m --backend ozaki2_f32 --execution kernel --mesh 2x1

Under the launcher rank 0 alone prints and saves; without one it runs a
world of one.  The mesh must hold every rank of the run.  A ``--residue``
other than 1 on another execution is refused; ``--seq-shard`` is the
reference's activation layout hint, which changes no result (as its
`act_pspec` changes none there).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from ..configs import ARCHS, get_config, get_reduced
from ..core.executor import resolve_device
from ..core.policy import GemmPolicy
from ..data import DataConfig
from ..models import Model
from ..optim import AdamWConfig
from ..train import TrainLoopConfig, train_loop
from ..tune.cli import add_calibration_args, apply_calibration_args
from .mesh import init_world, make_host_mesh


def parse_n_block(s: str):
    """CLI n_block: an integer or the literal 'auto' (perfmodel-driven)."""
    return "auto" if s == "auto" else int(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) training mesh of the run's D x M ranks (params over model, "
                         "optimizer state also over data, batch rows over data)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--backend", default="native",
                    choices=["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"])
    ap.add_argument("--execution", default="reference",
                    choices=["reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused"],
                    help="residue backend running the emulation plan (fp8: the e4m3 digit-GEMM "
                         "engine; fused: the one-launch megakernel; sharded: over the run's ranks)")
    ap.add_argument("--residue", type=int, default=1,
                    help="residue mesh-axis size of the sharded execution, appended to the --mesh "
                         "layout (default 1; without --mesh: every rank of the run)")
    ap.add_argument("--mode", default="fast", choices=["fast", "accu", "auto"],
                    help="paper scaling mode; 'auto' picks the cheapest mode meeting --rtol per shape")
    ap.add_argument("--rtol", type=float, default=None,
                    help="componentwise accuracy target (adaptive policy: fewest moduli provably "
                         "meeting it; required for --mode auto)")
    ap.add_argument("--formulation", default="karatsuba",
                    choices=["karatsuba", "block_a", "block_b", "auto"],
                    help="complex strategy (complex backends only)")
    ap.add_argument("--n-block", default=None, type=parse_n_block,
                    help="output-column blocking: an int or 'auto'")
    ap.add_argument("--seq-shard", action="store_true",
                    help="the reference's sequence-sharded activation layout: a layout hint that changes "
                         "no result")
    ap.add_argument("--vocab-chunk", type=int, default=None,
                    help="chunked-vocab cross entropy over slabs of this size")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' runs the kernels' plain "
                         "versions)")
    add_calibration_args(ap)
    args = ap.parse_args(argv)
    if args.residue != 1 and args.execution != "sharded":
        ap.error(f"--residue {args.residue} is the sharded execution's mesh axis; "
                 f"--execution {args.execution} has none")
    device = resolve_device(args.device)
    apply_calibration_args(args, device=device)
    if args.mode == "auto" and args.rtol is None:
        ap.error("--mode auto needs an accuracy target: pass --rtol")
    mesh, owned = None, False
    if args.mesh or (args.execution == "sharded" and args.backend != "native"):
        dims = tuple(map(int, args.mesh.split("x"))) if args.mesh else (1, 1)
        device, owned = init_world(device)
        world = dist.get_world_size()
        residue = args.residue if args.residue > 1 or args.mesh else world // (dims[0] * dims[1])
        if dims[0] * dims[1] * residue != world:
            if owned:
                dist.destroy_process_group()
            ap.error(f"--mesh {args.mesh or '1x1'} with --residue {residue} needs "
                     f"{dims[0] * dims[1] * residue} ranks; the run has {world}")
        mesh = make_host_mesh(*dims, residue=residue, device_type=device.type)
    try:
        return _train(args, device, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, device, mesh) -> int:
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    over = {}
    if args.backend != "native":
        over["gemm_policy"] = GemmPolicy(
            backend=args.backend,
            mode=args.mode,
            formulation=args.formulation,
            n_block=args.n_block,
            execution=args.execution,
            rtol=args.rtol,
        )
        over["dtype"] = "float32"
    if args.seq_shard:
        over["act_pspec"] = (("data",), "model", None)
    if args.vocab_chunk:
        over["loss_vocab_chunk"] = args.vocab_chunk
    if over:
        cfg = dataclasses.replace(cfg, **over)

    model = Model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    loop = TrainLoopConfig(
        steps=args.steps,
        warmup=max(5, args.steps // 20),
        log_every=max(1, args.steps // 20),
        ckpt_every=max(10, args.steps // 4),
        ckpt_dir=args.ckpt_dir,
        grad_accum=args.grad_accum,
    )
    first = mesh is None or dist.get_rank() == 0
    _, hist = train_loop(model, data, loop, AdamWConfig(lr=args.lr, grad_clip=5.0), mesh=mesh,
                         log=print if first else (lambda line: None), device=device)
    if hist and first:
        print(f"[{args.arch}] loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
