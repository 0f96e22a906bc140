"""GPipe pipeline parallelism over a mesh dim.

The port's copy of `repro.distributed.pipeline`.  The stacked layer
params of a homogeneous decoder split into `n_stages` contiguous stages,
stage s on the rank at coordinate s of the pipeline dim; microbatches flow
from stage to stage.  The schedule is GPipe's fill-drain: T = M + S - 1
ticks for M microbatches over S stages (bubble fraction (S - 1) / T); at
tick t stage s runs microbatch t - s.  The embedding and the head run on
every rank outside the pipelined region.

A stage's output reaches the next stage through `_Send` / `_Recv`,
`torch.autograd.Function`s whose backward sends the gradient back to the
previous stage: `torch.autograd.grad` of the pipelined loss runs the
reverse pipeline, as `jax.grad` derives it from the reference's
`ppermute`.  Each rank's sends are chained by a token, so that its
backward sends and receives in the reverse of the forward's order on
both sides of every pair of stages.  The last stage's outputs reach
every rank by a broadcast (the reference sums them with zeros, which
turns -0.0 into +0.0); its backward takes the last stage's own cotangent
(every rank computes the same loss from the same outputs).

So on each rank `torch.autograd.grad` of the loss gives the grads of what
that rank computes: its stage's block of the group's layer params (zeros
elsewhere), the final norm and the head; and on stage 0, which embeds
the pipeline's input, the whole embedding's.  The transport is the mesh
dim's process group: point-to-point on NCCL, through the host where gloo
carries card tensors (its CUDA path has no send or receive).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.layers import apply_mlp, apply_norm
from ..models.blocks import BLOCKS
from ..models.transformer import _n_layers, layer_params
from .sharded_gemm import collective


def _stage_fn(cfg: ModelConfig, lp, x, positions):
    """This stage's layers on activations x: (B, S, d)."""
    bk, mk, _ = cfg.layer_groups[0]
    for i in range(_n_layers(lp)):
        p = layer_params(lp, i)
        x = x + BLOCKS[bk]["apply"](cfg, p["block"], apply_norm(cfg.norm, p["norm1"], x), positions)
        if mk != "none":
            x = x + apply_mlp(mk, p["mlp"], apply_norm(cfg.norm, p["norm2"], x), cfg.gemm_policy)
    return x


def _p2p(op: str, t: torch.Tensor, peer: int) -> torch.Tensor:
    """Send `t` to, or receive it from, the global rank `peer`, in place."""
    staged = t.device.type == "cuda" and "nccl" not in str(dist.get_backend())
    buf = t.cpu() if staged else t
    if op == "send":
        dist.send(buf.contiguous(), peer)
        return t
    dist.recv(buf, peer)
    if staged:
        t.copy_(buf)
    return t


class _Send(torch.autograd.Function):
    """Stage output `y` to the next stage; returns the rank's next token.
    Backward: receives y's gradient from that stage."""

    @staticmethod
    def forward(ctx, y, token, peer):
        ctx.peer, ctx.like = peer, torch.empty_like(y)
        _p2p("send", y.detach(), peer)
        return token.detach().clone()

    @staticmethod
    def backward(ctx, g_token):
        return _p2p("recv", ctx.like, ctx.peer), g_token, None


class _Recv(torch.autograd.Function):
    """The previous stage's output, of `shape` and `dtype`.  Backward: sends
    its gradient back.  `anchor`, one element of the stage's params, ties
    it into the graph: `torch.autograd.grad` runs only the nodes on a path
    to the tensors it is asked for, and the stage's params are asked for
    whenever the pipeline trains (the anchor's gradient is zero)."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, peer):
        ctx.peer, ctx.anchor_dtype = peer, anchor.dtype
        return _p2p("recv", torch.empty(shape, dtype=dtype, device=anchor.device), peer)

    @staticmethod
    def backward(ctx, g):
        _p2p("send", g, ctx.peer)
        return torch.zeros(1, dtype=ctx.anchor_dtype, device=g.device), None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's `out` on every rank of the pipeline dim; `token`
    (the rank's last send) ties the rank's sends into the loss's graph.
    Backward: the last stage keeps its own cotangent."""

    @staticmethod
    def forward(ctx, out, token, mesh, axis, src):
        ctx.src = mesh.get_local_rank(axis) == src
        return collective("broadcast", out.detach().clone(), mesh, axis, src=src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.src else None), torch.zeros((), dtype=g.dtype, device=g.device), None, None, None


def pipeline_apply(cfg: ModelConfig, group_params, h: torch.Tensor, positions: torch.Tensor, mesh,
                   axis: str = "pp", n_micro: int = 4):
    """The pipelined layer stack. h: (B, S, d) embedded activations (the
    same on every rank of `axis`); returns the transformed activations on
    every rank, equal to the sequential stack's (`tests/test_pipeline.py`'s
    bounds)."""
    if len(cfg.layer_groups) != 1:
        raise ValueError("pipeline supports homogeneous layer stacks")
    n_stages = mesh.shape[mesh.mesh_dim_names.index(axis)]
    n_layers = cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} stages")
    b = h.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    per = n_layers // n_stages
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < n_stages - 1 else None
    stage_p = _slice_layers(group_params, idx * per, per)
    mb = h.reshape((n_micro, b // n_micro) + tuple(h.shape[1:]))  # (M, b/M, S, d)
    pos = positions[: b // n_micro]

    token = torch.zeros((), dtype=h.dtype, device=h.device)
    anchor = _first_leaf(stage_p).reshape(-1)[:1]
    outputs = []
    for t in range(n_micro + n_stages - 1):
        m = t - idx
        if not 0 <= m < n_micro:
            continue
        x = mb[m] if prev is None else _Recv.apply(anchor, mb.shape[1:], h.dtype, prev)
        y = _stage_fn(cfg, stage_p, x, pos)
        if nxt is None:
            outputs.append(y)
        else:
            token = _Send.apply(y, token, nxt)
    out = torch.stack(outputs) if nxt is None else torch.empty_like(mb)
    out = _Broadcast.apply(out, token, mesh, axis, n_stages - 1)
    return out.reshape(h.shape)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _slice_layers(tree, start: int, n: int):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, start, n) for k, v in tree.items()}
    return tree[start:start + n]


def pipeline_loss(model, params, batch, mesh, axis: str = "pp", n_micro: int = 4):
    """The pipelined `Model.loss` of a homogeneous decoder: the mean
    next-token cross entropy (no auxiliary loss, no vocab chunks)."""
    cfg = model.cfg
    h, positions = model._embed_inputs(params, batch)
    h = pipeline_apply(cfg, params["groups"][0], h, positions, mesh, axis, n_micro)
    h = apply_norm(cfg.norm, params["final_norm"], h)
    logits = model._head(params, h)
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    f32 = torch.float32
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=f32), torch.zeros_like(tokens[:, :1], dtype=f32)], dim=1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    return torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
