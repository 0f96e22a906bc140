"""AdamW with decoupled weight decay and global-norm clipping.

The port's copy of `repro.optim.adamw`.  The optimizer state mirrors the
params, with the reference's keys (``step``, ``m``, ``v`` and, with
`use_master`, the float32 ``master`` copy), so a checkpoint of either
package restores in the other.  Leaves are visited in the reference's
order (`repro_torch.tree`), which fixes the order of `global_norm`'s sum.

`adamw_update` computes the reference's values op by op, each Python
constant rounded as JAX's weak types round it (``1 - b1`` in float64,
then float32), and every division by a tensor on the leaves' device: a
Python divisor on the card becomes a multiply by its reciprocal.  Square
roots are correctly rounded (`_sqrt`).  `global_norm`'s sums run in
torch's reduction order, so the norm, and with it a clipped update, is
the reference's within float32 rounding; given the same norm, the update
is the reference's bit for bit.  With
``inplace=True`` (the train step's ``donate``) it writes the new params
and state into the given tensors, which halves the update's peak at full
width; the values are the same either way.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_master: bool = True  # keep f32 master weights for bf16 params


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``step`` an int32 0-d zero, ``m`` and ``v`` float32 zeros, and with
    `use_master` an independent float32 copy of the params, each on its
    leaf's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=_F32, device=p.device)

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.use_master:
        state["master"] = tree_map(lambda p: p.detach().to(_F32, copy=True), params)
    return state


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's, and CUDA's
    `sqrtf`): through float64, exact to round once more.  torch's
    vectorised float32 `sqrt` on the CPU misses it in about 0.7 % of
    elements."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares.  Each
    leaf's sum is torch's reduction, whose order differs from XLA's: the
    norm is the reference's within float32 rounding, not bit for bit."""
    leaves = [torch.sum(torch.square(g.to(_F32))) for g in tree_leaves(tree)]
    return _sqrt(torch.sum(torch.stack(leaves)))


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=like.device)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, inplace: bool = False):
    """Returns (new_params, new_state, {"grad_norm", "lr"})."""
    if not inplace:
        params = tree_map(lambda p: p.detach().clone(), params)
        state = tree_map(lambda t: t.clone(), state)
    return apply_update(params, grads, state, cfg, lr_scale, global_norm(grads))


@torch.no_grad()
def apply_update(params, grads, state, cfg: AdamWConfig, lr_scale, gnorm: torch.Tensor):
    """`adamw_update`'s step given the grads' global norm, in place on
    `params` and `state`.  Every op after the norm is elementwise, so a
    block of each leaf (the training mesh's ZeRO-1 shard) updates to the
    same bits as that block of the whole."""
    step = state["step"] + 1
    clip = torch.minimum(_const(1.0, gnorm), _const(cfg.grad_clip, gnorm) / torch.clamp_min(gnorm, 1e-9))
    b1c = 1.0 - cfg.b1 ** step.to(_F32)
    b2c = 1.0 - cfg.b2 ** step.to(_F32)
    lr = cfg.lr * lr_scale

    flat_p = tree_leaves(params)
    flat_w = tree_leaves(state["master"]) if cfg.use_master else flat_p
    for p, g, m, v, w in zip(flat_p, tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                             flat_w):
        g = g.to(_F32) * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = m / b1c
        upd.div_(_sqrt(v / b2c).add_(cfg.eps))
        w32 = w if w.dtype == _F32 else w.to(_F32)
        upd.add_(cfg.weight_decay * w32)
        w32.sub_(lr * upd)
        if w32 is not w:
            w.copy_(w32)
        if p is not w:
            p.copy_(w32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
