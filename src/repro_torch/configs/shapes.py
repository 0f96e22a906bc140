"""Input shapes and per-(arch x shape) applicability.

The port's copy of `repro.configs.shapes`:

  train_4k     seq_len=4096    global_batch=256   (train step)
  prefill_32k  seq_len=32768   global_batch=32    (serve prefill)
  decode_32k   seq_len=32768   global_batch=128   (one new token against a
                                                   cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     (long-context decode)

long_500k needs sub-quadratic attention: it runs only for the SSM/hybrid
archs (mamba2-130m, recurrentgemma-2b).  `input_specs` gives each input as
a tensor on the "meta" device (shape and dtype, no allocation).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.params import torch_dtype

SUBQUADRATIC = {"mamba2-130m", "recurrentgemma-2b"}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.name.split("-reduced")[0] not in SUBQUADRATIC:
        return False, "full-attention arch: 512k dense decode skipped"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Stand-ins for every model input of this cell.

    For train/prefill: the (tokens [+ prefix_embeds]) batch; the token
    count is cut by n_prefix_embeds so the whole sequence is seq_len.  For
    decode: one new token; the cache shapes come from
    `Model.cache_abstract`.
    """
    spec = SHAPES[shape]
    npre = cfg.n_prefix_embeds if cfg.frontend else 0
    if spec.kind in ("train", "prefill"):
        out = {"tokens": _spec((spec.global_batch, spec.seq_len - npre), torch.int32)}
        if npre:
            out["prefix_embeds"] = _spec((spec.global_batch, npre, cfg.d_model), torch_dtype(cfg.dtype))
        return out
    return {"tokens": _spec((spec.global_batch, 1), torch.int32)}
