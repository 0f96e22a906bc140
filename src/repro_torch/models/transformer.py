"""Full decoder model: embedding -> layer groups -> norm -> head.

The port's copy of `repro.models.transformer`, with the same parameter
tree, ``{"embed", "groups": [per group, every leaf stacked along a
leading layer axis], "final_norm", "head"}``, so weights and prepared
planes carry across leaf for leaf.  Where the reference scans a group's
stacked params with `lax.scan`, the port loops over the layers in Python
and gives layer i ``leaf[i]`` (a prepared weight's `layer(i)`).  It runs
eagerly: no jit, no `torch.compile`.

Serving: `init_cache`, `prefill` and `decode_step`; every block writes
its layer's cache tensors (the attention ring, the SSD's conv carry and
state, the RG-LRU's conv carry and h) in place (see `blocks`).  Training: `loss`,
differentiable through autograd and, under an emulated policy, the
emulated matmul's backward; with ``cfg.remat`` a layer's activations are
recomputed in the backward (`torch.utils.checkpoint`).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..core.executor import PreparedOperand
from .blocks import BLOCKS, moe_abstract, moe_apply
from .config import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    mlp_abstract,
    norm_abstract,
    sinusoidal_embedding,
)
from .params import ParamMeta, abstract_arrays, materialize, stack_metas

_F32 = torch.float32


def layer_params(tree, i: int):
    """Layer i of a stacked group tree: ``leaf[i]`` for a tensor,
    ``layer(i)`` for a prepared weight."""
    if isinstance(tree, PreparedOperand):
        return tree.layer(i)
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(layer_params(v, i) for v in tree)
    return tree[i]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    if isinstance(tree, PreparedOperand):
        return (tree.residues or tree.bound)[0].shape[0]
    return tree.shape[0]


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------ params

    def _layer_abstract(self, block_kind: str, mlp_kind: str) -> dict:
        cfg = self.cfg
        out = {
            "norm1": norm_abstract(cfg.norm, cfg.d_model, cfg.dtype),
            "block": BLOCKS[block_kind]["abstract"](cfg),
        }
        if mlp_kind != "none":
            out["norm2"] = norm_abstract(cfg.norm, cfg.d_model, cfg.dtype)
            if mlp_kind == "moe":
                out["mlp"] = moe_abstract(cfg)
            elif mlp_kind == "dense_first":
                out["mlp"] = mlp_abstract(
                    cfg.mlp if cfg.mlp != "moe" else "swiglu", cfg.d_model, cfg.first_dense_ff,
                    cfg.dtype,
                )
            else:
                out["mlp"] = mlp_abstract(mlp_kind, cfg.d_model, cfg.d_ff, cfg.dtype)
        return out

    def abstract_params(self) -> dict:
        cfg = self.cfg
        out = {
            "embed": ParamMeta(
                (cfg.vocab, cfg.d_model),
                ("vocab", "embed"),
                cfg.dtype,
                scale=cfg.d_model**-0.5,  # sane tied-head logits at init
            ),
            "groups": [
                stack_metas(self._layer_abstract(bk, mk), cnt) for bk, mk, cnt in cfg.layer_groups
            ],
            "final_norm": norm_abstract(cfg.norm, cfg.d_model, cfg.dtype),
        }
        if not cfg.tie_embeddings:
            out["head"] = ParamMeta((cfg.d_model, cfg.vocab), ("embed", "vocab"), cfg.dtype)
        return out

    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        """Random params on `device` (None: the card), seeded by
        `generator`'s seed (`params.materialize`)."""
        return materialize(self.abstract_params(), generator, device)

    def param_shapes(self) -> dict:
        return abstract_arrays(self.abstract_params())

    # ------------------------------------------------------------ embedding

    def _embed_inputs(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        h = params["embed"][tokens.long()]
        if cfg.frontend is not None and "prefix_embeds" in batch:
            h = torch.cat([batch["prefix_embeds"].to(h.dtype), h], dim=1)
        s = h.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None, :].repeat(h.shape[0], 1)
        if cfg.pos == "sinusoidal":
            h = h + sinusoidal_embedding(positions, cfg.d_model).to(h.dtype)
        return h, positions

    def _head(self, params, h):
        """The f32 product of the head (native; TF32 stays off, torch's
        default for float32 matmuls)."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        return h.to(_F32) @ w.to(_F32)

    # ------------------------------------------------------------ forward

    def _layer(self, lp, bk, mk, x, positions):
        cfg = self.cfg
        hn = apply_norm(cfg.norm, lp["norm1"], x)
        x = x + BLOCKS[bk]["apply"](cfg, lp["block"], hn, positions)
        aux = torch.zeros((), dtype=_F32, device=x.device)
        if mk != "none":
            hn2 = apply_norm(cfg.norm, lp["norm2"], x)
            if mk == "moe":
                y, aux = moe_apply(cfg, lp["mlp"], hn2)
            elif mk == "dense_first":
                y = apply_mlp(cfg.mlp if cfg.mlp != "moe" else "swiglu", lp["mlp"], hn2,
                              cfg.gemm_policy)
            else:
                y = apply_mlp(mk, lp["mlp"], hn2, cfg.gemm_policy)
            x = x + y
        return x, aux

    def _run_group(self, gp, bk, mk, x, positions):
        remat = self.cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or _requires_grad(gp))
        aux_total = torch.zeros((), dtype=_F32, device=x.device)
        for i in range(_n_layers(gp)):
            lp = layer_params(gp, i)
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    self._layer, lp, bk, mk, x, positions, use_reentrant=False)
            else:
                x, aux = self._layer(lp, bk, mk, x, positions)
            aux_total = aux_total + aux
        return x, aux_total

    def backbone(self, params, batch):
        """Pre-head hidden states. Returns (h, positions, aux_loss)."""
        cfg = self.cfg
        h, positions = self._embed_inputs(params, batch)
        aux_total = torch.zeros((), dtype=_F32, device=h.device)
        for gp, (bk, mk, _) in zip(params["groups"], cfg.layer_groups):
            h, aux = self._run_group(gp, bk, mk, h, positions)
            aux_total = aux_total + aux
        h = apply_norm(cfg.norm, params["final_norm"], h)
        return h, positions, aux_total

    def forward(self, params, batch):
        """Full-sequence logits. Returns (logits_f32, aux_loss)."""
        h, _, aux_total = self.backbone(params, batch)
        return self._head(params, h), aux_total

    def _chunked_ce(self, params, h, targets, mask):
        """Cross entropy over vocab slabs: never materializes the
        (B, S, vocab) f32 logits."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        v = w.shape[-1]
        chunk = min(cfg.loss_vocab_chunk, v)
        n_chunks = -(-v // chunk)
        pad = n_chunks * chunk - v
        if pad:
            w = torch.nn.functional.pad(w, (0, pad))
        b, s = targets.shape
        dev = h.device
        m = torch.full((b, s), -1e30, dtype=_F32, device=dev)
        l = torch.zeros((b, s), dtype=_F32, device=dev)
        gold = torch.full((b, s), -1e30, dtype=_F32, device=dev)
        targets = targets.long()
        for i in range(n_chunks):
            base = i * chunk
            wi = w[:, base: base + chunk]
            logits = h.to(_F32) @ wi.to(_F32)
            idx = torch.arange(chunk, dtype=torch.int32, device=dev)[None, None, :] + base
            logits = torch.where(idx < v, logits, torch.tensor(-1e30, dtype=_F32, device=dev))
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            l = l * torch.exp(m - m_new) + torch.sum(torch.exp(logits - m_new[..., None]), dim=-1)
            in_chunk = (targets >= base) & (targets < base + chunk)
            g = torch.take_along_dim(logits, torch.clamp(targets - base, 0, chunk - 1)[..., None],
                                     dim=-1)[..., 0]
            gold = torch.where(in_chunk, g, gold)
            m = m_new
        logz = m + torch.log(torch.clamp_min(l, 1e-30))
        return torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)

    def loss(self, params, batch):
        """Next-token CE over the token region (prefix embeds excluded).
        The targets keep the full sequence length, the final position
        masked, as in the reference."""
        cfg = self.cfg
        n_prefix = (
            batch["prefix_embeds"].shape[1]
            if (cfg.frontend is not None and "prefix_embeds" in batch)
            else 0
        )
        tokens = batch["tokens"]
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        mask = batch.get("loss_mask", torch.ones_like(tokens, dtype=_F32)).to(_F32)
        mask = mask * torch.cat(
            [torch.ones_like(tokens[:, 1:], dtype=_F32), torch.zeros_like(tokens[:, :1], dtype=_F32)],
            dim=1,
        )
        if cfg.loss_vocab_chunk:
            h, _, aux = self.backbone(params, batch)
            ce = self._chunked_ce(params, h[:, n_prefix:, :], targets, mask)
        else:
            logits, aux = self.forward(params, batch)
            pred = logits[:, n_prefix:, :]
            logz = torch.logsumexp(pred, dim=-1)
            gold = torch.take_along_dim(pred, targets.long()[..., None], dim=-1)[..., 0]
            ce = torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ serving

    def cache_abstract(self, batch_size: int, cache_len: int) -> list:
        cfg = self.cfg
        return [
            stack_metas(BLOCKS[bk]["cache"](cfg, batch_size, cache_len), cnt)
            for bk, mk, cnt in cfg.layer_groups
        ]

    def init_cache(self, batch_size: int, cache_len: int, device=None) -> list:
        """An empty decode cache on `device` (None: the card)."""
        return materialize(self.cache_abstract(batch_size, cache_len), device=device)

    def prefill(self, params, batch, cache):
        """Run the prompt and fill `cache` (in place); returns
        (last-position logits, cache)."""
        cfg = self.cfg
        h, positions = self._embed_inputs(params, batch)
        for gp, gc, (bk, mk, _) in zip(params["groups"], cache, cfg.layer_groups):
            for i in range(_n_layers(gp)):
                lp, lc = layer_params(gp, i), layer_params(gc, i)
                hn = apply_norm(cfg.norm, lp["norm1"], h)
                y, _ = BLOCKS[bk]["prefill"](cfg, lp["block"], hn, positions, lc)
                h = self._apply_mlp_serve(lp, mk, h + y)
        h = apply_norm(cfg.norm, params["final_norm"], h)
        return self._head(params, h[:, -1:, :]), cache

    def decode_step(self, params, token, cache, pos: int):
        """One decode step (cache updated in place). token: (B, 1) int;
        pos: the new token's position, an int."""
        cfg = self.cfg
        pos = int(pos)
        h = params["embed"][token.long()]
        if cfg.pos == "sinusoidal":
            p1 = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
            h = h + sinusoidal_embedding(p1, cfg.d_model).to(h.dtype)
        for gp, gc, (bk, mk, _) in zip(params["groups"], cache, cfg.layer_groups):
            for i in range(_n_layers(gp)):
                lp, lc = layer_params(gp, i), layer_params(gc, i)
                hn = apply_norm(cfg.norm, lp["norm1"], h)
                y, _ = BLOCKS[bk]["decode"](cfg, lp["block"], hn, lc, pos)
                h = self._apply_mlp_serve(lp, mk, h + y)
        h = apply_norm(cfg.norm, params["final_norm"], h)
        return self._head(params, h), cache

    def _apply_mlp_serve(self, lp, mk, x):
        cfg = self.cfg
        if mk == "none":
            return x
        hn2 = apply_norm(cfg.norm, lp["norm2"], x)
        if mk == "moe":
            y, _ = moe_apply(cfg, lp["mlp"], hn2)
        elif mk == "dense_first":
            y = apply_mlp(cfg.mlp if cfg.mlp != "moe" else "swiglu", lp["mlp"], hn2, cfg.gemm_policy)
        else:
            y = apply_mlp(mk, lp["mlp"], hn2, cfg.gemm_policy)
        return x + y
