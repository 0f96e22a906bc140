"""Int8 error-feedback gradient compression for the data-parallel sum.

The port's copy of `repro.distributed.compression`.  Quantizing the
gradients to int8 before the data ranks' sum cuts its bytes 4x against
float32.  Error feedback keeps what the quantization dropped in a float32
buffer and adds it back the next step, so training tracks the
uncompressed sum to first order.  The quantizer is the residue cast's:
symmetric scaling and round-to-nearest, one "modulus" of 2^8.

The reference's `pmax` and `psum` over an axis name become a float32 MAX
and an int32 SUM all-reduce over a mesh dim's process group
(`sharded_gemm.collective`): both exact, so the result does not depend on
the order in which the ranks' values meet.  Every division is by a tensor,
as in the reference's float32 arithmetic.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, unflatten
from .sharded_gemm import collective
from .sharding import dim_size

_F32 = torch.float32


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / torch.tensor(127.0, dtype=amax.dtype, device=x.device),
                        torch.ones((), dtype=amax.dtype, device=x.device)).to(_F32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def error_feedback_psum(grad: torch.Tensor, err: torch.Tensor, mesh, dim: str):
    """The mean of `grad` over the ranks of the mesh dim `dim`, sent as int8
    values on one shared scale, with error feedback.  Returns (mean_grad,
    new_err)."""
    g32 = grad.to(_F32) + err
    _, scale = quantize_int8(g32)
    # one scale for every rank, so the integer sum is exact
    smax = collective("max", scale.clone(), mesh, dim)
    q = torch.clamp(torch.round(g32 / smax), -127, 127).to(torch.int32)
    new_err = g32 - q.to(_F32) * smax
    total = collective("sum", q, mesh, dim).to(_F32) * smax
    n = torch.tensor(float(dim_size(mesh, dim)), dtype=_F32, device=grad.device)
    return (total / n).to(grad.dtype), new_err


def tree_error_feedback_psum(grads, errs, mesh, dim: str):
    out = [error_feedback_psum(g, e, mesh, dim) for g, e in zip(tree_leaves(grads), tree_leaves(errs))]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])


def init_error_buffers(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)
