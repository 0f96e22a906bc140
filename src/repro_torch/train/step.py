"""The training step: loss -> grads (with microbatch accumulation) ->
AdamW.

The port's copy of `repro.train.step`, off the mesh: `make_train_step`
returns ``(train_step, None)`` as the reference does without a mesh.  A
mesh whose data and model dims are 1 (a residue mesh) scopes the step:
every emulated linear whose policy is sharded runs over it, the params
and batch whole on every rank; a mesh that would shard them raises (the
parameter-sharded training mesh, ROADMAP queue 1, item 11b).  The step runs
eagerly: the loss through autograd (each emulated linear's backward is
two more emulated products, `core.policy._EmulatedMatmul`; with
``cfg.remat`` each layer's forward is recomputed in the backward), the
grads by `torch.autograd.grad` over the param leaves, then
`optim.adamw_update`.  ``donate=True`` (the reference's buffer donation)
updates the params and the optimizer state in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..core.policy import MESH_ITEM, _not_ported, use_mesh
from ..models.transformer import Model
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of `model.loss` at `params`, the grads a tree
    like `params` (zeros for a leaf the loss does not reach, as JAX's)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    schedule: Callable | None = None,
    mesh=None,
    rules=None,
    grad_accum: int = 1,
    donate: bool = True,
):
    """Returns (train_step, None): ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)``.  With ``grad_accum > 1`` the batch
    splits along its first axis into `grad_accum` microbatches whose grads
    are summed in order (in at least float32) and averaged; its metrics
    are then the loss and the optimizer's only, as in the reference.
    `mesh`: a `DeviceMesh` whose other dims than `residue` are 1, scoped
    around each step (`use_mesh`); `rules` (the reference's sharding
    rules) has no effect on such a mesh."""
    if mesh is not None:
        split = {d: n for d, n in zip(mesh.mesh_dim_names, mesh.shape) if d != "residue" and n > 1}
        if split:
            raise _not_ported(f"a training mesh that shards parameters and batches ({split})", MESH_ITEM)

    def step_fn(params, opt_state, batch):
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            mbs = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:])) for k, v in batch.items()}
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.promote_types(torch.float32, p.dtype),
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(grad_accum):
                l, _, g = loss_and_grads(model, params, {k: v[i] for k, v in mbs.items()})
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            n = torch.tensor(grad_accum, dtype=torch.float32, device=loss.device)
            grads = tree_map(lambda g: g / n.to(g.dtype), grads)
            loss = loss / n
            metrics = {}
        lr_scale = schedule(opt_state["step"]) if schedule else 1.0
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg, lr_scale,
                                                      inplace=donate)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step_fn, None


def init_state(model: Model, opt_cfg: AdamWConfig, generator: torch.Generator | None = None, device=None):
    """(params, optimizer state) on `device` (None: the card), the params
    from `Model.init`'s rule for `generator`."""
    params = model.init(generator, device=device)
    return params, adamw_init(params, opt_cfg)
