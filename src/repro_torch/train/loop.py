"""The training loop: data -> step -> metrics and checkpoints, with
auto-resume, the preemption guard and the straggler watch.

The port's copy of `repro.train.loop`, on one device (`device`, None: the
card) or over a `mesh` of the run's ranks.  It logs the reference's lines
(``step ...``, ``[resume] ...``, ``[preempt] ...``) and saves as the
reference does, every `ckpt_every` steps and on preemption, in its
layout, so either package resumes the other's.  On a mesh
(`train.step.make_train_step`) the state is sharded: each rank places
its rows of `SyntheticLM`'s global batch (so the tokens are the
reference's), restores its blocks of a checkpoint, whatever mesh wrote
it, and at a save the state is gathered whole and rank 0 alone writes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..checkpoint import Checkpointer, latest_step
from ..core.executor import resolve_device
from ..data import DataConfig, SyntheticLM
from ..distributed.fault import PreemptionGuard, StragglerWatch
from ..distributed.sharded_gemm import full_tensor
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_warmup
from ..tree import tree_map
from .step import init_state, make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    warmup: int = 10
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    grad_accum: int = 1
    seed: int = 0
    async_ckpt: bool = True


def train_loop(
    model: Model,
    data_cfg: DataConfig,
    loop_cfg: TrainLoopConfig,
    opt_cfg: AdamWConfig | None = None,
    mesh=None,
    batch_hook: Callable | None = None,
    log: Callable = print,
    device=None,
):
    """Runs (or resumes) training; returns (params, history).  The initial
    params come from `Model.init` with ``torch.Generator`` seed
    `loop_cfg.seed`, drawn on `device`."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = cosine_warmup(loop_cfg.warmup, loop_cfg.steps)
    step_fn, shardings = make_train_step(model, opt_cfg, schedule, mesh=mesh, grad_accum=loop_cfg.grad_accum)
    params, opt = init_state(model, opt_cfg, torch.Generator().manual_seed(loop_cfg.seed), device, shardings)
    state_sh = None if shardings is None else {"params": shardings["params"], "opt": shardings["opt"]}

    start = 0
    ckpt = None
    writer = False
    if loop_cfg.ckpt_dir:
        ckpt = Checkpointer(loop_cfg.ckpt_dir)
        writer = mesh is None or mesh.get_rank() == 0
        last = latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state = ckpt.restore(last, {"params": params, "opt": opt}, device, state_sh)
            params, opt = state["params"], state["opt"]
            start = last
            log(f"[resume] restored step {last} from {loop_cfg.ckpt_dir}")

    data = SyntheticLM(data_cfg)
    watch = StragglerWatch()
    history = []
    with PreemptionGuard() as guard:
        for step in range(start, loop_cfg.steps):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
            batch = {k: v.to(device) if shardings is None else shardings["batch"].place(v) for k, v in batch.items()}
            if batch_hook:
                batch = batch_hook(batch)
            watch.step_begin()
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            watch.step_end(step)
            history.append(loss)
            if step % loop_cfg.log_every == 0 or step == loop_cfg.steps - 1:
                log(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics.get('grad_norm', np.nan)):.3f}")
            if ckpt and ((step + 1) % loop_cfg.ckpt_every == 0 or guard.should_stop):
                state = {"params": params, "opt": opt}
                if shardings is not None:
                    state = tree_map(full_tensor, state)  # a collective of every rank
                if writer:
                    ckpt.save(step + 1, state, blocking=not loop_cfg.async_ckpt)
            if guard.should_stop:
                log(f"[preempt] stopping cleanly at step {step}")
                break
    if ckpt:
        ckpt.wait()
    return params, history
