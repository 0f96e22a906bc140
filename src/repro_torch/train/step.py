"""The training step: loss -> grads (with microbatch accumulation) ->
AdamW, on one process or over a device mesh.

The port's copy of `repro.train.step`.  It runs eagerly: the loss through
autograd (each emulated linear's backward is two more emulated products,
`core.policy._EmulatedMatmul`; with ``cfg.remat`` each layer's forward is
recomputed in the backward), the grads by `torch.autograd.grad` over the
param leaves, then `optim.adamw_update`.  ``donate=True`` (the
reference's buffer donation) updates the params and the optimizer state
in place.

On a mesh (a `DeviceMesh` over the run's ranks, dims named from
``("pod", "data", "model", "residue")``) the state is sharded by the
reference's rules (`distributed.sharding`):

* every param leaf is a `DTensor` placed by `tree_pspecs`; m, v and the
  master copy by `optimizer_spec` (ZeRO-1: also split over 'data'); the
  step counter is replicated;
* the batch is a `DTensor` split in contiguous rows over the 'batch'
  rule's dims ('pod', 'data'): the ranks of one model/residue group hold
  the same rows;
* each rank gathers every param leaf whole (`sharded_gemm.full_tensor`)
  and computes the loss and grads of its rows; an emulated linear whose
  policy is sharded (or fused) runs over the sub-mesh of the 'model' and
  'residue' dims, pinned in the policy (never 'data': its rows are the
  batch's).  Native products are
  not partitioned over 'model' as the reference's GSPMD partitions them;
  every rank of a model group computes them whole;
* the grads and losses of the D data ranks are gathered (broadcasts) and
  summed in rank order from zeros, then divided by D: the op sequence of
  the one-process ``grad_accum`` loop, so a data split is microbatch
  accumulation in rank order (no floating SUM collective, whose order is
  unspecified);
* `global_norm` runs over the whole averaged grads; each rank then
  updates its optimizer shard and the matching block of each param
  (`optim.apply_update`) and regathers the param's 'data' blocks.

So a (D, M[, R]) mesh step with ``grad_accum=1`` gives the bits of the
one-process step with ``grad_accum=D``: params, optimizer state and loss.
The reference's mesh step computes the global batch at once (its `aux`
and its rounding differ).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..distributed.sharded_gemm import full_tensor, gather
from ..distributed.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    batch_sharding,
    dim_size,
    entry_names,
    optimizer_spec,
    pspec_for_meta,
    tree_shardings,
)
from ..models.params import _map_like
from ..models.transformer import Model
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import apply_update, global_norm
from ..tree import tree_leaves, tree_map, unflatten

_F32 = torch.float32
#: the mesh dims an emulated linear of the step may be sharded over
GEMM_DIMS = ("model", "residue")


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


def _accumulated(model: Model, params, batch, grad_accum: int):
    """(loss, metrics, grads) of `batch` split along its first axis into
    `grad_accum` microbatches, their grads summed in order from zeros (in
    at least float32) and averaged; the metrics then empty, as the
    reference's."""
    if grad_accum == 1:
        return loss_and_grads(model, params, batch)
    mbs = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:])) for k, v in batch.items()}
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.promote_types(_F32, p.dtype), device=p.device),
                     params)
    loss = torch.zeros((), dtype=_F32, device=tree_leaves(params)[0].device)
    for i in range(grad_accum):
        l, _, g = loss_and_grads(model, params, {k: v[i] for k, v in mbs.items()})
        grads = tree_map(torch.add, grads, g)
        loss = loss + l
    n = torch.tensor(grad_accum, dtype=_F32, device=loss.device)
    return loss / n, {}, tree_map(lambda g: g / n.to(g.dtype), grads)


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    schedule: Callable | None = None,
    mesh=None,
    rules=None,
    grad_accum: int = 1,
    donate: bool = True,
):
    """Returns (train_step, shardings): ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)``.  With ``grad_accum > 1`` the
    batch splits along its first axis into `grad_accum` microbatches whose
    grads are summed in order (in at least float32) and averaged; its
    metrics are then the loss and the optimizer's only, as in the
    reference.  Off a mesh `shardings` is None.  On a `mesh` it is
    ``{"params", "opt", "batch"}``, trees of `NamedSharding` by `rules`
    (default `DEFAULT_RULES`): the step takes and returns the state as
    `DTensor`s placed by them (`init_state(..., shardings)`), and the batch
    as a `DTensor` of the global batch (`NamedSharding.place`)."""
    if mesh is None:
        def step_fn(params, opt_state, batch):
            loss, metrics, grads = _accumulated(model, params, batch, grad_accum)
            lr_scale = schedule(opt_state["step"]) if schedule else 1.0
            params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg, lr_scale,
                                                          inplace=donate)
            return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

        return step_fn, None
    step = _MeshStep(model, opt_cfg, schedule, mesh, rules or DEFAULT_RULES, grad_accum, donate)
    return step, step.shardings


def mesh_shardings(model: Model, opt_cfg: AdamWConfig, mesh, rules=None) -> dict:
    """The step's ``{"params", "opt", "batch"}`` sharding trees on `mesh`."""
    rules = rules or DEFAULT_RULES
    abstract = model.abstract_params()
    opt_leaf = _map_like(abstract, lambda _, m: NamedSharding(
        mesh, optimizer_spec(pspec_for_meta(m, rules, mesh), m.shape, mesh)))
    opt = {"step": NamedSharding(mesh, ()), "m": opt_leaf, "v": opt_leaf}
    if opt_cfg.use_master:
        opt["master"] = opt_leaf
    return {"params": tree_shardings(abstract, rules, mesh), "opt": opt, "batch": batch_sharding(mesh, rules)}


class _MeshStep:
    """The train step on a mesh (the module's docstring says how)."""

    def __init__(self, model, opt_cfg, schedule, mesh, rules, grad_accum, donate):
        pinned = getattr(model.cfg.gemm_policy, "mesh", None)
        if pinned is not None and any(dim_size(pinned, n) > 1 for n in ("pod", "data")
                                      if n in pinned.mesh_dim_names):
            raise ValueError("a policy pinned to a mesh with data ranks would mix the ranks' batch rows in its "
                             "products: leave GemmPolicy.mesh unset, the step scopes its model/residue sub-mesh")
        gemm = tuple(n for n in mesh.mesh_dim_names if n in GEMM_DIMS)
        pol = model.cfg.gemm_policy
        if gemm and pol is not None and pol.execution in ("sharded", "fused") and pinned is None:
            # pinned, not scoped: a remat recompute runs in the autograd
            # engine's device thread, which sees no thread-local scope
            model = Model(dataclasses.replace(model.cfg, gemm_policy=dataclasses.replace(pol, mesh=mesh[gemm])))
        self.model, self.opt_cfg, self.schedule, self.mesh = model, opt_cfg, schedule, mesh
        self.grad_accum, self.donate = grad_accum, donate
        self.shardings = mesh_shardings(model, opt_cfg, mesh, rules)
        self.batch_dims = entry_names(self.shardings["batch"].spec[0])
        self.data_ranks = dim_size(mesh, self.batch_dims)

    def __call__(self, params, opt_state, batch):
        whole = tree_map(full_tensor, params)
        rows = {k: v.to_local() for k, v in batch.items()}
        loss, metrics, grads = _accumulated(self.model, whole, rows, self.grad_accum)
        if self.data_ranks > 1:
            loss, metrics, grads = self._data_mean(loss, metrics, grads)
        return self._update(whole, grads, opt_state, {"loss": loss, **metrics})

    def _data_mean(self, loss, metrics, grads):
        """Every data rank's loss, metrics and grads gathered, summed in rank
        order from zeros (grads in at least float32) and divided by D."""
        scalars = {"loss": loss, **metrics}
        leaves = [g.to(torch.promote_types(_F32, g.dtype)) for g in tree_leaves(grads)]
        parts = list(scalars.values()) + leaves
        dtypes = sorted({t.dtype for t in parts}, key=str)
        out = [None] * len(parts)
        n = torch.tensor(self.data_ranks, dtype=_F32, device=loss.device)
        for dt in dtypes:
            idx = [i for i, t in enumerate(parts) if t.dtype == dt]
            flat = torch.cat([parts[i].reshape(-1) for i in idx])[None]
            for name in reversed(self.batch_dims):
                flat = gather(flat, 0, self.mesh, name)
            total = torch.zeros(flat.shape[1:], dtype=dt, device=flat.device)
            for r in range(flat.shape[0]):
                total = total + flat[r]
            total = total / n.to(dt)
            for i, t in zip(idx, torch.split(total, [parts[i].numel() for i in idx])):
                out[i] = t.reshape(parts[i].shape)
        k = len(scalars)
        return out[0], dict(zip(list(scalars)[1:], out[1:k])), unflatten(grads, out[k:])

    def _update(self, whole, grads, opt_state, metrics):
        """AdamW on this rank's optimizer shard and the matching blocks of
        the params, the norm over the whole grads; the params regathered
        over what ZeRO-1 split."""
        sh = self.shardings
        opt_sh = sh["opt"]["m"]
        step = opt_state["step"].to_local()
        lr_scale = self.schedule(step) if self.schedule else 1.0
        own = (lambda t: t) if self.donate else (lambda t: t.clone())
        state = {k: (step if k == "step" else tree_map(lambda x: own(x.to_local()), v))
                 for k, v in opt_state.items()}
        blocks = tree_map(lambda w, s: s.local(w).clone(), whole, opt_sh)
        g_blocks = tree_map(lambda g, s: s.local(g), grads, opt_sh)
        blocks, state, opt_metrics = apply_update(blocks, g_blocks, state, self.opt_cfg, lr_scale,
                                                  global_norm(grads))
        params = tree_map(self._regather, blocks, opt_sh, sh["params"])
        new_opt = {k: (sh["opt"]["step"].place(v) if k == "step" else
                       tree_map(lambda t, s: _dtensor(t, s), v, sh["opt"][k]))
                   for k, v in state.items()}
        return params, new_opt, {**metrics, **opt_metrics}

    def _regather(self, block, opt_s: NamedSharding, param_s: NamedSharding):
        """The param's block under `param_s` from this rank's block under
        `opt_s`: each dim the optimizer spec splits further is gathered."""
        spec = tuple(param_s.spec) + (None,) * (block.ndim - len(param_s.spec))
        for d, (e_opt, e_par) in enumerate(zip(opt_s.spec, spec)):
            for name in reversed([n for n in entry_names(e_opt) if n not in entry_names(e_par)]):
                block = gather(block, d, self.mesh, name)
        return _dtensor(block, param_s)


def _dtensor(local: torch.Tensor, s: NamedSharding):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, s.mesh, s.placements, run_check=False)


def init_state(model: Model, opt_cfg: AdamWConfig, generator: torch.Generator | None = None, device=None,
               shardings=None):
    """(params, optimizer state) on `device` (None: the card), the params
    from `Model.init`'s rule for `generator`.  With `shardings` (the mesh
    step's), each rank holds its blocks of that one-process state, as
    `DTensor`s."""
    params = model.init(generator, device=device)
    opt = adamw_init(params, opt_cfg)
    if shardings is not None:
        params = tree_map(lambda x, s: s.place(x), params, shardings["params"])
        opt = tree_map(lambda x, s: s.place(x), opt, shardings["opt"])
    return params, opt
