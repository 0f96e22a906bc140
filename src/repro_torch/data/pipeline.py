"""Deterministic, shardable synthetic LM data pipeline.

The port's copy of `repro.data.pipeline`, the same numpy code: every
batch is a pure function of (seed, step, shard), so its tokens equal the
reference's bit for bit, and a restart after preemption or a re-sharding
replays exactly the same data.

The token stream is a Zipf-ish mixture with a Markov backbone, so small
models show a measurable, decreasing loss.  Batches are numpy int32; the
train loop moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Markov-chain synthetic corpus, deterministic per (step, shard)."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1, shard: int = 0):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard = shard
        self.local_batch = cfg.global_batch // num_shards
        # small deterministic transition structure shared by all shards
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._hot = rng.integers(0, v, size=(v, 4))  # 4 likely successors

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        jump = rng.random((b, s)) < 0.15
        pick = rng.integers(0, 4, size=(b, s))
        rand_tok = rng.integers(0, v, size=(b, s))
        for t in range(1, s):
            nxt = self._hot[toks[:, t - 1], pick[:, t]]
            toks[:, t] = np.where(jump[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks}


def make_batch_specs(cfg: DataConfig) -> dict:
    """A global batch's shapes and dtypes as tensors on the "meta" device
    (the dry run's input stand-ins; no allocation)."""
    return {"tokens": torch.empty((cfg.global_batch, cfg.seq_len), dtype=torch.int32, device="meta")}
