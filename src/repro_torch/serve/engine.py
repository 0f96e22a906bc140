"""Batched serving engine: prefill, then one-token decode steps.

The port's copy of `repro.serve.engine`.  It runs eagerly on `device`
(None: the card): the cache is allocated there and updated in place at
each step (the reference donates it to its jitted decode step).

With an emulated (Ozaki-II) GEMM policy, ``prepare=True`` residue-casts
every linear weight once at construction (`core.policy.prepare_weights`,
with the policy's execution backend, so prepared serving is bitwise the
unprepared run on every execution): step 1 of the scheme for the weight
side, its scaling, truncation and N int8 residue planes, is paid once,
and each request pays only the activation's cast.  On
``execution="kernel"`` an emulated linear is then 3 launches (cast,
product, Garner) instead of 4; on ``"fused"`` it stays 1.

``prepared_dir`` keeps that one-time work across restarts: the first
construction saves the prepared planes through the checkpointer, and a
later one restores them (bitwise: the planes are int8 and int32) instead
of preparing again.  The save records the policy and a fingerprint of the
weights it was cast from; a save made for another policy or other weights
warns and is prepared anew.

Greedy decoding takes the argmax.  Sampling at a temperature draws from
an explicit `torch.Generator` (`torch.multinomial`), so its draws are not
the reference's `jax.random.categorical` draws.
"""
from __future__ import annotations

import hashlib
import warnings

import torch

from ..core.executor import PreparedOperand, resolve_device
from ..core.policy import prepare_weights, prepared_like
from ..models.transformer import Model


def to_device(tree, device):
    """A param tree's tensors on `device` (those already there unchanged)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        cache_len: int,
        batch_size: int,
        prepare: bool = False,
        prepared_dir: str | None = None,
        device=None,
    ):
        self.model = model
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        policy = model.cfg.gemm_policy
        if prepare and policy.backend != "native":
            params = self._prepared_params(params, policy, prepared_dir, self.device)
        self.params = params
        self.cache_len = cache_len
        self.batch_size = batch_size

    @classmethod
    def _collect_prepared(cls, like, tree, out=None, prefix=""):
        """Flat {path: aligned node} at every PreparedOperand site of `like`.

        `like` is `prepared_like(params)`, so its PreparedOperand sites mark
        exactly the weights preparation consumes; walking an aligned tree
        next to it picks out those raw weights (tree=params) or the prepared
        planes (tree=prepped) without restating prepare_weights' rule.
        """
        if out is None:
            out = {}
        if isinstance(like, PreparedOperand):
            out[prefix[:-1]] = tree
        elif isinstance(like, dict):
            for k in sorted(like):
                cls._collect_prepared(like[k], tree[k], out, f"{prefix}{k}/")
        elif isinstance(like, (list, tuple)):
            for i, (lk, tr) in enumerate(zip(like, tree)):
                cls._collect_prepared(lk, tr, out, f"{prefix}{i}/")
        return out

    @classmethod
    def _graft_prepared(cls, like, params, restored, prefix=""):
        """`params` with each to-prepare weight swapped for restored[path]."""
        if isinstance(like, PreparedOperand):
            return restored[prefix[:-1]]
        if isinstance(like, dict):
            return {k: cls._graft_prepared(like[k], params[k], restored, f"{prefix}{k}/") for k in like}
        if isinstance(like, (list, tuple)):
            return type(like)(
                cls._graft_prepared(lk, pr, restored, f"{prefix}{i}/")
                for i, (lk, pr) in enumerate(zip(like, params))
            )
        return params

    @staticmethod
    def _weights_fingerprint(raw_weights: dict) -> str:
        """Content hash of the to-prepare weights (path-keyed, order-stable):
        the reference's, over each weight's path, its shape and dtype text
        and its bytes.  Only the weights preparation consumes take part, so
        editing a bias or a norm keeps valid planes."""
        h = hashlib.sha256()
        for path in sorted(raw_weights):
            t = raw_weights[path].detach()
            h.update(path.encode())
            h.update(f"{tuple(t.shape)}{str(t.dtype).removeprefix('torch.')}".encode())
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    @classmethod
    def _prepared_params(cls, params, policy, prepared_dir, device):
        """Prepared weights, restored from `prepared_dir` when a save there
        matches this (policy, weights), else prepared now and saved for the
        next restart.  Only the prepared planes are stored (the rest of the
        tree lives in the regular checkpoint).  A stale save (another
        policy, or updated weights) would break the bitwise guarantee, so
        it is detected by the saved metadata and prepared anew."""
        if prepared_dir is None:
            return prepare_weights(params, policy, device=device)
        from ..checkpoint import Checkpointer, latest_step

        ck = Checkpointer(prepared_dir, keep=1)
        step = latest_step(prepared_dir)
        like = prepared_like(params, policy)
        meta = {
            "gemm_policy": repr(policy),
            "weights_fingerprint": cls._weights_fingerprint(cls._collect_prepared(like, params)),
        }
        if step is not None:
            if all(ck.meta(step).get(k) == v for k, v in meta.items()):
                restored = ck.restore(step, cls._collect_prepared(like, like), device=device)
                return cls._graft_prepared(like, params, restored)
            warnings.warn(
                f"prepared-weight cache in {prepared_dir!r} was saved for a "
                "different policy or weights; re-preparing (the stale planes "
                "would not be bit-identical to this configuration)",
                stacklevel=3,
            )
            step += 1  # keep=1 drops the stale save after the rewrite
        prepped = prepare_weights(params, policy, device=device)
        ck.save(step or 0, cls._collect_prepared(like, prepped), extra_meta=meta)
        return prepped

    @torch.no_grad()
    def generate(
        self,
        batch: dict,
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: torch.Generator | None = None,
        return_logits: bool = False,
    ):
        """Greedy (or, with a temperature and a generator, sampled) tokens,
        (B, max_new_tokens) int32.  With `return_logits`, also the f32
        logits each token was taken from, (B, 1 + max_new_tokens, vocab):
        the prefill's and every decode step's."""
        cfg = self.model.cfg
        batch = to_device(batch, self.device)
        cache = self.model.init_cache(self.batch_size, self.cache_len, device=self.device)
        logits, cache = self.model.prefill(self.params, batch, cache)
        npre = cfg.n_prefix_embeds if cfg.frontend else 0
        pos = batch["tokens"].shape[1] + npre
        seen = [logits[:, -1]]
        out = []
        tok = self._sample(logits[:, -1, :], temperature, generator)
        for i in range(max_new_tokens):
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, cache, pos + i)
            seen.append(logits[:, -1])
            tok = self._sample(logits[:, -1, :], temperature, generator)
        tokens = torch.cat(out, dim=1) if out else tok[:, :0]
        return (tokens, torch.stack(seen, dim=1)) if return_logits else tokens

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
