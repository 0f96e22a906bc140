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
* `prepared_from_numpy(fields, device)` builds the port's
  `PreparedOperand` from a reference preparation's fields, so a weight
  prepared by the reference (for example one restored from a checkpoint)
  serves from the port with equal bits.

Both follow the entry points' device rule: ``device=None`` means the card
(`core.executor.resolve_device`), and without one they raise; pass
``device="cpu"`` for tensors on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.executor import PreparedOperand, resolve_device
from .core.policy import GemmPolicy

_DROPPED_FIELDS = ("interpret", "mesh", "shard_axes", "calibration")


def policy_from_fields(d: dict) -> GemmPolicy:
    fields = {k: v for k, v in d.items() if k not in _DROPPED_FIELDS}
    return GemmPolicy(**fields)


def tensors_from_numpy(tree, device=None):
    device = resolve_device(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, order="C")).to(device)  # a copy: writable
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_from_numpy(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    return tree


def prepared_from_numpy(fields: dict, device=None) -> PreparedOperand:
    """The port's `PreparedOperand` from a reference preparation's fields:
    `side`, `n_moduli`, `n_limbs` and `dtype` (a name), and as numpy (or
    None) the arrays `e_scale`, `e_bound` and `raw` and the tuples
    `residues` and `bound`, placed on `device` (None: the card)."""
    device = resolve_device(device)
    prep = object.__new__(PreparedOperand)
    prep.side = fields["side"]
    prep.n_moduli, prep.n_limbs = int(fields["n_moduli"]), int(fields["n_limbs"])
    prep.dtype = str(fields["dtype"])
    prep.e_scale, prep.e_bound, prep.raw = (
        tensors_from_numpy(fields[k], device) for k in ("e_scale", "e_bound", "raw"))
    prep.residues, prep.bound = (
        tuple(tensors_from_numpy(tuple(fields[k]), device)) for k in ("residues", "bound"))
    return prep
