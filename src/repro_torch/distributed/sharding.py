"""Where each array lives on a device mesh: the parameter rules of the
training mesh and the residue-plane rules of the sharded emulated GEMM.

The port's copy of `repro.distributed.sharding`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose dims are named from
`MESH_AXES`; the spec functions read only its dim names and sizes, so
they also take an `AbstractMesh` (names and sizes, no process group).  A
spec is a tuple with one entry a tensor dim: a mesh dim name, a tuple of
names (the dim split over several mesh dims, the first major) or None
(whole on every rank), the reference's PartitionSpec as a tuple.

Parameters and caches declare logical axis names in their `ParamMeta`
('vocab', 'ff', 'qkv', 'experts', ...); `DEFAULT_RULES` maps them onto the
mesh dims ('pod', 'data', 'model'), size-aware (`_resolve`): a name whose
mesh dims are absent, already claimed by an earlier dim of the same
tensor, or do not divide the dim's size stays whole.  `optimizer_spec`
adds ZeRO-1's 'data' split to the optimizer state.  `NamedSharding`
turns a spec into `torch.distributed.tensor` placements and places a
whole tensor as a `DTensor` holding this rank's block.

The GEMM section: every rank holds the full operands of a product and
slices its own part of them itself (`local_block`): rows over `data`,
columns over `model`, and its chunk of the N residue planes over
`residue` (`plane_chunk`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

MESH_AXES = ("pod", "data", "model", "residue")
RESIDUE_AXIS = "residue"

# tensor-parallel over 'model'; data-parallel over ('pod', 'data'); ZeRO-1
# adds 'data' to the optimizer state on the first free dim (optimizer_spec).
# The KV cache splits its sequence dim over 'model': kv_heads (1-24 on the
# assigned archs) rarely divide a 16-way model dim, the cache length does.
DEFAULT_RULES: dict[str, Any] = {
    "vocab": "model",
    "ff": "model",
    "qkv": "model",
    "kv_qkv": "model",
    "heads": "model",
    "kv_heads": None,
    "kv_seq": "model",
    "experts": "model",      # expert parallelism
    "ssm_inner": "model",
    "embed": None,
    "layers": None,          # the stacked layer axis
    "batch": ("pod", "data"),
    "seq": None,             # 'model' under sequence parallelism
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names without devices or process groups: what
    the spec functions read of a `DeviceMesh`."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def entry_names(entry) -> tuple:
    """The mesh dim names of one spec entry (a name, a tuple of names or None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def dim_size(mesh, name) -> int:
    """The size of the mesh dim `name`, or the product of a tuple of them
    (1 for None)."""
    return math.prod(mesh.shape[mesh.mesh_dim_names.index(n)] for n in entry_names(name))


def _resolve(axis: str | None, rules: Mapping[str, Any], mesh, dim=None, used=None):
    """Map a logical axis onto mesh dims; None (whole) when its mesh dims are
    absent, already claimed by an earlier dim of the tensor (left-to-right
    precedence: MoE experts take 'model' before the per-expert ff), or do
    not divide the dim's size."""
    if axis is None:
        return None
    target = rules.get(axis, None)
    if target is None:
        return None
    names = set(mesh.mesh_dim_names)
    used = used if used is not None else set()
    if isinstance(target, (tuple, list)):
        kept = tuple(t for t in target if t in names and t not in used)
        if not kept:
            return None
        if dim is not None and dim % dim_size(mesh, kept):
            return None
        used.update(kept)
        return kept if len(kept) > 1 else kept[0]  # one name alone, as PartitionSpec normalizes it
    if target not in names or target in used:
        return None
    if dim is not None and dim % dim_size(mesh, target):
        return None
    used.add(target)
    return target


def pspec_for_axes(axes: Sequence[str | None], rules, mesh, shape=None) -> tuple:
    dims = shape if shape is not None else [None] * len(axes)
    used: set = set()
    return tuple(_resolve(a, rules, mesh, d, used) for a, d in zip(axes, dims))


def pspec_for_meta(meta, rules, mesh) -> tuple:
    return pspec_for_axes(meta.axes, rules, mesh, meta.shape)


def tree_pspecs(abstract_params, rules, mesh):
    """ParamMeta tree -> spec tree (size-aware)."""
    from ..models.params import _map_like

    return _map_like(abstract_params, lambda _, m: pspec_for_meta(m, rules, mesh))


def tree_shardings(abstract_params, rules, mesh):
    """ParamMeta tree -> `NamedSharding` tree on `mesh` (a DeviceMesh)."""
    from ..models.params import _map_like

    return _map_like(abstract_params, lambda _, m: NamedSharding(mesh, pspec_for_meta(m, rules, mesh)))


def optimizer_spec(param_spec: tuple, shape, mesh) -> tuple:
    """ZeRO-1: the optimizer state of a parameter also splits over 'data',
    on the first dim that is whole and whose size the data dim divides
    (the param's spec as it is when the mesh has no 'data', the spec
    already uses it, or no dim qualifies).  m, v and the master copy then
    take 1/D of the param's memory on each rank."""
    if "data" not in mesh.mesh_dim_names:
        return param_spec
    nd = dim_size(mesh, "data")
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if "data" in {n for p in parts for n in entry_names(p)}:  # already data-sharded
        return tuple(parts)
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % nd == 0:
            parts[i] = "data"
            return tuple(parts)
    return param_spec


def batch_pspec(mesh, rules=None) -> tuple:
    """The batch's spec: rows over the 'batch' rule's dims."""
    return (_resolve("batch", rules or DEFAULT_RULES, mesh),)


def batch_sharding(mesh, rules=None) -> "NamedSharding":
    return NamedSharding(mesh, batch_pspec(mesh, rules))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a `DeviceMesh`: its `placements` (`Shard(d)` for each mesh
    dim that splits tensor dim d, `Replicate()` for the others), this
    rank's block of a whole tensor (`local`) and that block as a `DTensor`
    (`place`).  Blocks are contiguous and equal: the rules split only dims
    their mesh dims divide."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        order = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(order)
        for d, entry in enumerate(self.spec):
            idx = [order.index(n) for n in entry_names(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} must list its mesh dims in the mesh's order {tuple(order)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `x` (a view)."""
        return local_block(x, self.spec, self.mesh)

    def place(self, x: torch.Tensor):
        """`x` as a `DTensor` on the mesh, holding a copy of this rank's block
        on this rank's device of the mesh's type (from anywhere: a whole
        tensor on the host moves only the block)."""
        from torch.distributed.tensor import DTensor

        dev = torch.device(self.mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        block = self.local(x).to(dev, copy=True, memory_format=torch.contiguous_format)
        return DTensor.from_local(block, self.mesh, self.placements, run_check=False)


@dataclasses.dataclass(frozen=True)
class GemmShardAxes:
    """Resolved mesh dims of one sharded emulated GEMM (names or None):
    `residue` carries the N residue planes, `m` the output rows, `n` the
    output columns."""

    residue: str | None = None
    m: str | None = None
    n: str | None = None

    def sizes(self, mesh) -> tuple[int, int, int]:
        """(residue_shards, m_shards, n_shards) on `mesh`."""
        return dim_size(mesh, self.residue), dim_size(mesh, self.m), dim_size(mesh, self.n)


def resolve_gemm_axes(mesh, m: int | None = None, n: int | None = None,
                      overrides: tuple | None = None) -> GemmShardAxes:
    """Map the (residue, m, n) logical GEMM axes onto `mesh`.

    residue -> 'residue' when the mesh has one, else 'model'; m -> 'data';
    n -> 'model' unless the residue fallback already claimed it (one mesh
    dim carries one role).  With shape hints, an m or n dim whose size does
    not divide the dimension drops to replicated; the residue dim never
    drops (a rank's plane chunk may be short or empty instead).
    `overrides` is the policy's explicit (residue, m, n) name triple, taken
    as given apart from the divisibility check.
    """
    names = set(mesh.mesh_dim_names)
    if overrides is not None:
        residue, m_ax, n_ax = overrides
        for ax in (residue, m_ax, n_ax):
            if ax is not None and ax not in names:
                raise ValueError(f"shard axis {ax!r} not on mesh axes {tuple(mesh.mesh_dim_names)}")
        given = [ax for ax in (residue, m_ax, n_ax) if ax is not None]
        if len(given) != len(set(given)):
            # residue and n both on one dim would sum partial outputs of
            # different column blocks: silently wrong, so refused
            raise ValueError(
                f"shard_axes must use each mesh axis at most once; got "
                f"(residue={residue!r}, m={m_ax!r}, n={n_ax!r})"
            )
    else:
        residue = RESIDUE_AXIS if RESIDUE_AXIS in names else ("model" if "model" in names else None)
        m_ax = "data" if "data" in names else None
        n_ax = "model" if "model" in names and residue != "model" else None
    if m_ax is not None and m is not None and m % dim_size(mesh, m_ax):
        m_ax = None
    if n_ax is not None and n is not None and n % dim_size(mesh, n_ax):
        n_ax = None
    return GemmShardAxes(residue=residue, m=m_ax, n=n_ax)


def residue_plane_specs(axes: GemmShardAxes) -> dict[str, tuple]:
    """Which mesh dim splits each dim of every array of the sharded
    pipeline (None: whole on every rank).

    Operands split rows and columns only; residue stacks also split the
    plane dim; the exact f64 partial planes are the only payload summed
    over `residue`; the output is split like a GEMM result and gathered.
    No int8 array is communicated.
    """
    return {
        "a": (axes.m, None),                                   # (m, k) operand
        "b": (None, axes.n),                                   # (k, n) operand
        "a_residues": (axes.residue, axes.m, None),            # (N, m, k) int8
        "b_residues": (axes.residue, None, axes.n),            # (N, k, n) int8
        "product_residues": (axes.residue, axes.m, axes.n),    # (N, m, n) int8
        "partial": (None, axes.m, axes.n),                     # (parts, m, n) f64, summed
        "out": (axes.m, axes.n),                               # (m, n), gathered
    }


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec` (a view): each dim split over
    mesh dims is narrowed to the rank's coordinate on them (the first of a
    tuple of dims major)."""
    for d, entry in enumerate(spec):
        size = dim_size(mesh, entry)
        if size > 1:
            index = 0
            for n in entry_names(entry):
                index = index * dim_size(mesh, n) + mesh.get_local_rank(n)
            step = x.shape[d] // size
            x = x.narrow(d, index * step, step)
    return x


def plane_chunk(n_moduli: int, shards: int, index: int) -> tuple[int, int]:
    """[lo, hi) of the residue planes shard `index` of `shards` holds: N
    padded to a multiple of the shard count, as in the reference, so the
    last shards' chunks may be short or empty (a padded plane is never
    launched)."""
    chunk = -(-n_moduli // shards)
    lo = min(index * chunk, n_moduli)
    return lo, min(lo + chunk, n_moduli)
