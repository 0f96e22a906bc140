"""Carry state across from the reference package as plain data.

`repro_torch` never imports JAX or `repro`; a caller that holds both
(the parity tests) hands state over as plain fields and numpy arrays:

* `policy_from_fields(d)` builds the port's `GemmPolicy` from
  `dataclasses.asdict` of a reference policy, minus the fields that have no
  counterpart here (`interpret`) or that stay at their defaults on the
  ported path (`mesh`, `shard_axes`, `calibration`).
* `tensors_from_numpy(tree, device)` turns numpy operands, residue planes
  and exponent vectors — alone or in tuples, lists and dicts — into
  tensors on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.policy import GemmPolicy

_DROPPED_FIELDS = ("interpret", "mesh", "shard_axes", "calibration")


def policy_from_fields(d: dict) -> GemmPolicy:
    fields = {k: v for k, v in d.items() if k not in _DROPPED_FIELDS}
    return GemmPolicy(**fields)


def tensors_from_numpy(tree, device="cpu"):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_from_numpy(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    return tree
