"""Carry state across from the reference package as plain data.

`repro_torch` never imports JAX or `repro`; a caller that holds both
(the parity tests) hands state over as plain fields and numpy arrays:

* `policy_from_fields(d)` builds the port's `GemmPolicy` from
  `dataclasses.asdict` of a reference policy, minus the fields that have no
  counterpart here (`interpret`; `mesh`, a JAX mesh of the reference's
  devices, and with it `shard_axes`: a port policy takes a
  `torch.distributed` `DeviceMesh` of its own ranks) or that stay at their
  defaults on the ported path (`calibration`).
* `model_config_from_fields(d)` builds the port's `ModelConfig` from
  `dataclasses.asdict` of a reference config, its `gemm_policy` through
  `policy_from_fields`.
* `params_from_numpy(tree, device)` (also named `tensors_from_numpy`)
  turns numpy param trees, operands, residue planes and exponent vectors
  (alone or in tuples, lists and dicts) into tensors on `device`,
  bfloat16 leaves included: `np.asarray` of a JAX bfloat16 array has
  ml_dtypes' bfloat16 (or is a bare 2-byte void ``|V2`` without it),
  which `torch.from_numpy` refuses, so their bits go across as uint16,
  exactly.
* `prepared_from_numpy(fields, device)` builds the port's
  `PreparedOperand` from a reference preparation's fields, so a weight
  prepared by the reference (for example one restored from a checkpoint)
  serves from the port with equal bits.

All follow the entry points' device rule: ``device=None`` means the card
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


def model_config_from_fields(d: dict):
    """The port's `ModelConfig` from `dataclasses.asdict` of a reference
    `ModelConfig` (its `gemm_policy` a dict of a reference policy's fields,
    or None)."""
    from .models.config import ModelConfig

    fields = dict(d)
    pol = fields.get("gemm_policy")
    if isinstance(pol, dict):
        fields["gemm_policy"] = policy_from_fields(pol)
    if fields.get("block_pattern") is not None:
        fields["block_pattern"] = tuple(fields["block_pattern"])
    return ModelConfig(**fields)


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def params_from_numpy(tree, device=None):
    """Tensors on `device` from numpy arrays, alone or in tuples, lists and
    dicts (a copy: writable).  bfloat16 arrays go across through a uint16
    view of their bits, exactly."""
    device = resolve_device(device)
    if isinstance(tree, np.ndarray):
        a = np.array(tree, order="C")
        if _is_bfloat16(a):
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tree


#: the name the operand and plane carriers use; the same conversion
tensors_from_numpy = params_from_numpy


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
