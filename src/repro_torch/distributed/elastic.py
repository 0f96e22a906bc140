"""Elastic scaling: resume the same checkpoint on another mesh.

The port's copy of `repro.distributed.elastic`.  When nodes fail, the run
goes on on a smaller mesh of the healthy ranks (or later a larger one).
Checkpoints hold whole host arrays, whatever mesh wrote them, and the
data is a pure function of the step, so the only work is deriving the
new mesh's shardings and giving each rank its blocks: `reshard`.
"""
from __future__ import annotations

from ..checkpoint import Checkpointer, latest_step
from ..tree import tree_map
from .sharded_gemm import full_tensor
from .sharding import DEFAULT_RULES, tree_shardings


def reshard(tree, shardings):
    """A tree of whole tensors or `DTensor`s (made whole first, a collective
    of their mesh) placed by `shardings`, a like tree of `NamedSharding`s
    of the new mesh."""
    return tree_map(lambda x, s: s.place(full_tensor(x)), tree, shardings)


def elastic_restore(ckpt_dir: str, abstract_params, new_mesh, rules=None, like=None):
    """Load the latest checkpoint of params under `ckpt_dir` and shard it for
    `new_mesh` by `rules` (default `DEFAULT_RULES`).  Returns (step,
    params), each leaf a `DTensor` of `new_mesh` holding this rank's block.
    `like` defaults to the shapes of `abstract_params` (meta tensors)."""
    from ..models.params import abstract_arrays

    rules = rules or DEFAULT_RULES
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    like = like if like is not None else abstract_arrays(abstract_params)
    shardings = tree_shardings(abstract_params, rules, new_mesh)
    return step, Checkpointer(ckpt_dir).restore(step, like, shardings=shardings)
