"""End-to-end training on the PyTorch/CUDA port, on the card by default.

The default preset trains a small decoder LM for a few hundred steps with
checkpointing + auto-resume; `--preset 100m` is the full ~100M-param
configuration; `--emulated` routes every matmul through the paper's
Ozaki-II int8 emulation.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--preset small] [--device cpu]

The twin of `examples/train_lm.py`.  Its checkpoints go under the
temporary directory unless --ckpt-dir says where.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import GemmPolicy
from repro_torch.core.executor import resolve_device
from repro_torch.data import DataConfig
from repro_torch.models import Model, ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, train_loop

PRESETS = {
    # ~2.5M params: a few hundred steps run in minutes
    "small": ModelConfig(
        name="train-small", n_layers=4, d_model=128, vocab=2048,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512, mlp="swiglu",
    ),
    # ~100M params (the deliverable-scale config)
    "100m": ModelConfig(
        name="train-100m", n_layers=12, d_model=768, vocab=32768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, mlp="swiglu",
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--emulated", action="store_true",
                    help="run every matmul on the Ozaki-II int8 backend")
    ap.add_argument("--execution", default="reference",
                    choices=["reference", "kernel", "per_modulus_kernel", "fused", "fp8"],
                    help="residue backend for --emulated (GemmPolicy axis)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    if args.emulated:
        cfg = dataclasses.replace(
            cfg,
            gemm_policy=GemmPolicy(backend="ozaki2_f32", n_moduli=8, execution=args.execution),
            dtype="float32",
        )
    model = Model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    loop = TrainLoopConfig(
        steps=args.steps, warmup=max(10, args.steps // 20), log_every=20,
        ckpt_every=100, ckpt_dir=args.ckpt_dir,
    )
    params, hist = train_loop(model, data, loop, AdamWConfig(lr=args.lr, grad_clip=5.0), device=dev)
    print(f"done: loss {hist[0]:.3f} -> {hist[-1]:.3f} over {len(hist)} steps")


if __name__ == "__main__":
    main()
