"""Abstract parameter metadata -> initialisation and shapes.

The port's copy of `repro.models.params`.  Every layer describes its
parameters once as a tree of `ParamMeta` (shape, dtype, logical axis
names).  From that one description come:

  * `materialize`: random initial values, drawn per leaf from a
    `torch.Generator` seeded from the caller's seed and the leaf's path;
  * `abstract_arrays`: tensors on the "meta" device (shapes and dtypes, no
    allocation);
  * `logical_axes`: the axis names, kept as metadata (one card shards
    nothing).

The per-leaf seed is ``zlib.crc32`` of the path, which every process
computes alike.  The reference folds Python's ``hash`` of each path part
into its key, which Python salts per process, so its initial weights
repeat only within one process; the port does not copy that.  A
generator's stream depends on its device type (the CPU's and CUDA's
generators differ), so the same seed gives other values on the card than
on the CPU: to compare the two, initialise on one and move the tree.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch

from ..core.executor import resolve_device

#: torch dtype of each dtype name a config or a `ParamMeta` may carry
DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a name ('bfloat16', ...) or of a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return DTYPES[str(dtype)]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]        # logical axis names, len == ndim
    dtype: Any = torch.bfloat16         # a torch dtype or its name
    init: str = "normal"                # 'normal' | 'zeros' | 'ones' | 'future_pos'
    scale: float | None = None          # stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def _fan_in_scale(shape: tuple[int, ...]) -> float:
    """1/sqrt(shape[0]), the reference's rule.  For a leaf stacked along the
    layer axis, shape[0] is the layer count: stacked weights draw with std
    1/sqrt(n_layers), not 1/sqrt(k)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    return float(1.0 / np.sqrt(max(fan_in, 1)))


def _leaf_seed(seed: int, path: tuple[str, ...]) -> int:
    """A seed for one leaf, stable across processes and platforms."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32("/".join(path).encode())) % (1 << 63)


def _init_one(meta: ParamMeta, seed: int, device: torch.device) -> torch.Tensor:
    dtype = torch_dtype(meta.dtype)
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    if meta.init == "future_pos":  # KV-cache position sentinel (masked slot)
        return torch.full(meta.shape, 2**30, dtype=dtype, device=device)
    scale = meta.scale if meta.scale is not None else _fan_in_scale(meta.shape)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(meta.shape, generator=g, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def _iter_leaves(tree, path=()):
    if isinstance(tree, ParamMeta):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, path + (str(i),))
    else:
        raise TypeError(f"unexpected node {type(tree)} at {path}")


def _map_like(tree, fn, path=()):
    if isinstance(tree, ParamMeta):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_like(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_like(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    raise TypeError(f"unexpected node {type(tree)} at {path}")


def materialize(abstract: Any, generator: torch.Generator | None = None, device=None) -> Any:
    """Deterministic init on `device` (None: the card).  Each 'normal' leaf
    is drawn from a fresh generator on `device` seeded from
    ``generator.initial_seed()`` (0 without one) and the leaf's path, so a
    leaf's values do not depend on the other leaves or their order."""
    device = resolve_device(device)
    seed = 0 if generator is None else generator.initial_seed()
    return _map_like(abstract, lambda path, meta: _init_one(meta, _leaf_seed(seed, path), device))


def abstract_arrays(abstract: Any) -> Any:
    """Tensors on the "meta" device: shapes and dtypes, no allocation."""
    return _map_like(
        abstract, lambda _, m: torch.empty(m.shape, dtype=torch_dtype(m.dtype), device="meta"))


def logical_axes(abstract: Any) -> Any:
    return _map_like(abstract, lambda _, m: m.axes)


def stack_metas(meta_tree: Any, n: int) -> Any:
    """Add a leading 'layers' axis to every leaf (the stacked layer groups)."""
    return _map_like(
        meta_tree,
        lambda _, m: ParamMeta((n,) + m.shape, ("layers",) + m.axes, m.dtype, m.init, m.scale),
    )


def param_bytes(abstract: Any) -> int:
    return sum(
        int(np.prod(m.shape)) * torch_dtype(m.dtype).itemsize for _, m in _iter_leaves(abstract)
    )
