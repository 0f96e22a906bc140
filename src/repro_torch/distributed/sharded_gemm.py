"""`GemmPolicy(execution="sharded")`: the residue pipeline over a mesh.

The port's copy of `repro.distributed.sharded_gemm`.  One emulated GEMM
is spread over a `torch.distributed` device mesh on exactly the axes the
scheme makes cheap:

* the N residue planes over the `residue` dim (falling back to `model`):
  each modulus plane is an independent int8 GEMM;
* output rows m over `data` and columns n over `model`, like a GEMM.

K is never split.  Every rank runs the same program on the same full
operands and slices its own rows, columns and plane chunk; no operand is
sent.  Each rank casts its operand blocks itself (all N planes, keeping
its chunk: the cast kernel is static over the moduli tuple) and runs the
unchanged batched kernels on its chunk, the chunk's moduli passed as the
host tuple the kernels take.

What is communicated, through `collective` alone:

1. one SUM all-reduce over `residue` of the exact f64 partial planes
   (`core/crt.partial_split`): every partial sum is an integer below
   2^53, so any order gives the same bits; each rank then rebuilds the
   complete residue planes (`crt.residues_from_partial`) and runs the
   ordinary Garner reconstruction;
2. in accurate mode, an int32 MAX all-reduce of the bound maxima over
   the n dim (row maxima) and the m dim (column maxima);
3. the output blocks, gathered over m and n by a broadcast from each
   block's owner, in the output dtype (never by a sum, which would turn
   -0.0 into +0.0): `gather`, which `full_tensor` also runs to make a
   `DTensor` of the training mesh whole.

No int8 array is communicated.  Fast mode's scale exponents are the whole
product's, computed from the full operands every rank holds and sliced:
the norms then sum in the unsharded order on any mesh.  The output is
therefore bitwise the single-device `kernel` execution's on every mesh.
The transport is the process group's backend (NCCL where each rank has a
card of its own, gloo otherwise: `launch/mesh.init_world`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core import crt
from ..core.executor import execute_plan, scale_exponents
from ..core.moduli import make_crt_context
from .sharding import GemmShardAxes, dim_size, local_block, plane_chunk, residue_plane_specs, resolve_gemm_axes

__all__ = ["CollectiveLog", "ShardedBackend", "collective", "full_tensor", "gather"]

_LOGS: list["CollectiveLog"] = []


class CollectiveLog:
    """Context manager: every `collective` call inside it appends
    ``(op, dtype, shape, mesh dim)`` to `.calls`, in call order."""

    def __init__(self):
        self.calls: list[tuple[str, torch.dtype, tuple, str]] = []

    def __enter__(self):
        _LOGS.append(self)
        return self

    def __exit__(self, *exc):
        _LOGS.remove(self)
        return False


def collective(op: str, tensor: torch.Tensor, mesh, dim: str, src: int = 0) -> torch.Tensor:
    """The one door of the sharded pipeline's communication, in place on
    `tensor` over the mesh dim `dim`: ``"sum"`` or ``"max"`` all-reduce,
    or ``"broadcast"`` from the rank at coordinate `src` on `dim`."""
    for log in _LOGS:
        log.calls.append((op, tensor.dtype, tuple(tensor.shape), dim))
    group = mesh.get_group(dim)
    if op == "broadcast":
        # the transports move complex tensors as their (..., 2) real views
        buf = torch.view_as_real(tensor) if tensor.is_complex() else tensor
        dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    else:
        dist.all_reduce(tensor, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return tensor


class _ShardWorker:
    """The residue backend one rank runs inside `ShardedBackend.run_plan`:
    the executor's protocol for this rank's blocks and plane chunk, the
    data-touching work delegated to the wrapped single-device backend."""

    def __init__(self, inner, ctx, axes: GemmShardAxes, mesh):
        self.inner = inner
        r, md, nd = axes.sizes(mesh)
        if nd > 1:  # a row's bound maximum spans every column block
            self.accu_row_combine = lambda v: collective("max", v, mesh, axes.n)
        if md > 1:
            self.accu_col_combine = lambda v: collective("max", v, mesh, axes.m)
        if r == 1:
            # every rank holds all N planes: the inner backend as it is,
            # its megakernel one launch per rank (its Garner epilogue needs
            # the whole moduli set)
            for name in ("cast", "cast_stack", "residue_matmul", "karatsuba", "reconstruct",
                         "reconstruct_stack", "fused_gemm", "fused_karatsuba_gemm"):
                if hasattr(inner, name):
                    setattr(self, name, getattr(inner, name))
            self.megakernel = getattr(inner, "megakernel", False)
            return
        self.megakernel = False
        self.reconstruct = inner.reconstruct
        if hasattr(inner, "reconstruct_stack"):
            self.reconstruct_stack = inner.reconstruct_stack
        if hasattr(inner, "cast_stack"):
            self.cast_stack = self._cast_stack
        self.mesh, self.dim, self.ctx = mesh, axes.residue, ctx
        lo, hi = plane_chunk(ctx.n, r, mesh.get_local_rank(axes.residue))
        self.planes = slice(lo, hi)
        # the chunk's own context: its moduli are what the kernels take
        self.chunk_ctx = make_crt_context(hi - lo, ctx.moduli[lo:hi]) if hi > lo else None
        self.u_loc = np.ascontiguousarray(crt.partial_split(ctx.moduli)[0][:, lo:hi])
        # the two-phase hooks: the blocked pipelines run every block's
        # product, then ONE all-reduce of all their partials
        self.psum_partial = self._psum_partial
        self.psum_combine = self._psum_combine

    # ------------------------------------------------------------ casting

    def cast(self, x, e, axis, ctx, n_limbs):
        return self.inner.cast(x, e, axis, ctx, n_limbs)[self.planes]

    def _cast_stack(self, xs, e, axis, ctx, n_limbs):
        return self.inner.cast_stack(xs, e, axis, ctx, n_limbs)[:, self.planes]

    # ----------------------------------------------------------- products

    def residue_matmul(self, ares, bres, ctx):
        if self.chunk_ctx is None:  # an empty chunk: no launch, a zero partial
            return ares.new_empty((0, ares.shape[-2], bres.shape[-1]))
        return self.inner.residue_matmul(ares, bres, self.chunk_ctx)

    def karatsuba(self, arr, ari, brr, bri, ctx):
        if self.chunk_ctx is None:
            e = arr.new_empty((0, arr.shape[-2], brr.shape[-1]))
            return e, e
        return self.inner.karatsuba(arr, ari, brr, bri, self.chunk_ctx)

    # ----------------------------------------------------- reconstruction

    def _psum_partial(self, e_res):
        """(..., N_local, m, n) chunk -> (..., parts, m, n) exact f64
        partials (no collective: the executor collects them)."""
        return crt.partial_combine(e_res, self.u_loc)

    def _psum_combine(self, partials, stacked: bool = False):
        """ONE all-reduce of every block's partials, then each block's
        COMPLETE (.., N, m, n) residue planes, rebuilt locally."""
        flat = collective("sum", torch.cat([p.reshape(-1) for p in partials]), self.mesh, self.dim)
        sums = [t.reshape(p.shape) for t, p in zip(torch.split(flat, [p.numel() for p in partials]), partials)]
        if stacked:  # (2, parts, m, n): the CR/CI stack leads
            return [crt.residues_from_partial(t.movedim(0, 1), self.ctx).movedim(0, 1) for t in sums]
        return [crt.residues_from_partial(t, self.ctx) for t in sums]


@dataclasses.dataclass(frozen=True)
class ShardedBackend:
    """Residue backend running a plan over `mesh`, every rank the same
    program (port of `repro.distributed.sharded_gemm.ShardedBackend`).
    `shard_axes` is the policy's explicit (residue, m, n) dim names, None
    to resolve them by `sharding.resolve_gemm_axes`."""

    inner: Any
    mesh: Any
    shard_axes: tuple | None = None

    # the plan's 'auto' selections charge launches as the inner does
    @property
    def fused_karatsuba(self) -> bool:
        return getattr(self.inner, "fused_karatsuba", False)

    @property
    def modulus_batched(self) -> bool:
        return getattr(self.inner, "modulus_batched", False)

    @property
    def megakernel(self) -> bool:
        # priced as the inner; a rank runs it fused only where it holds
        # every residue plane (r == 1)
        return getattr(self.inner, "megakernel", False)

    @property
    def launches_kernels(self) -> bool:
        return getattr(self.inner, "launches_kernels", True)

    def analyze(self, plan, shape=None):
        """The static-analysis suite certifying this backend running `plan`
        (`repro_torch.analysis.passes_for_backend`): overflow and
        collective safety (the pass that bites here), and given ``shape =
        (m, k, n)`` the launch count the perfmodel predicts for a rank's
        blocks and plane chunk (`shard_factors`)."""
        from ..analysis import passes_for_backend

        return passes_for_backend(self, plan, shape)

    def resolve_axes(self, m: int, n: int) -> GemmShardAxes:
        return resolve_gemm_axes(self.mesh, m, n, self.shard_axes)

    def shard_factors(self, m: int, n: int) -> tuple[int, int, int]:
        """(m_shards, n_shards, residue_shards) applied at (m, n), which
        `GemmPolicy.plan_for` prices."""
        r, md, nd = self.resolve_axes(m, n).sizes(self.mesh)
        return md, nd, r

    def run_plan(self, plan, a, b):
        """`plan` on (m, k) x (k, n): this rank's block, then the output
        gathered, so every rank returns the whole product."""
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError(
                "sharded execution supports 2D operands; reshape leading batch dims into "
                f"rows (policy_matmul does) — got {tuple(a.shape)} @ {tuple(b.shape)}"
            )
        if self.mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh {self.mesh}")
        if a.device.type != self.mesh.device_type:
            raise ValueError(f"operands on {a.device} but the mesh is over {self.mesh.device_type} devices")
        axes = self.resolve_axes(a.shape[0], b.shape[1])
        specs = residue_plane_specs(axes)
        worker = _ShardWorker(self.inner, plan.ctx, axes, self.mesh)
        if plan.mode == "fast":
            e_mu, e_nu = scale_exponents(plan, a, b, None)
            worker.exponents = (local_block(e_mu, specs["out"][:1], self.mesh),
                                local_block(e_nu, specs["out"][1:], self.mesh))
        y = execute_plan(plan, local_block(a, specs["a"], self.mesh), local_block(b, specs["b"], self.mesh),
                         worker)
        for d, name in reversed(list(enumerate(specs["out"]))):
            y = gather(y, d, self.mesh, name)
        return y


def gather(y: torch.Tensor, d: int, mesh, name: str | None) -> torch.Tensor:
    """The whole of `y` along dim `d` from the equal blocks the ranks of the
    mesh dim `name` hold, in their order: one broadcast from each block's
    owner (bits kept, -0.0 included)."""
    size = dim_size(mesh, name)
    if size == 1:
        return y
    y = y.contiguous()
    me = mesh.get_local_rank(name)
    blocks = [collective("broadcast", y if j == me else torch.empty_like(y), mesh, name, src=j)
              for j in range(size)]
    return torch.cat(blocks, dim=d)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a `DTensor` (a plain tensor as it is): each dim
    split over mesh dims gathered by `gather`, the innermost mesh dim
    first."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    t = x.to_local()
    for i in reversed(range(x.device_mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            t = gather(t, p.dim, x.device_mesh, x.device_mesh.mesh_dim_names[i])
        elif not p.is_replicate():
            raise ValueError(f"placement {p} of a {tuple(x.shape)} DTensor: only Shard and Replicate are gathered")
    return t
