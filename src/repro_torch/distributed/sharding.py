"""Where each array of a sharded emulated GEMM lives on a device mesh.

The port's copy of the GEMM section of `repro.distributed.sharding`.  A
mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dims are named
from `MESH_AXES`.  Every rank holds the full operands of a product and
slices its own part of them itself (`local_block`): rows over `data`,
columns over `model`, and its chunk of the N residue planes over
`residue` (`plane_chunk`).  The parameter rules of the reference
(`DEFAULT_RULES`, `optimizer_spec`, ...) belong to the parameter-sharded
training mesh and are not ported yet (ROADMAP queue 1, item 11b).
"""
from __future__ import annotations

import dataclasses

import torch

MESH_AXES = ("pod", "data", "model", "residue")
RESIDUE_AXIS = "residue"


def dim_size(mesh, name: str | None) -> int:
    """The size of the mesh dim `name` (1 for None)."""
    return 1 if name is None else mesh.shape[mesh.mesh_dim_names.index(name)]


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
    a named mesh dim is narrowed to the rank's coordinate on it."""
    for d, name in enumerate(spec):
        size = dim_size(mesh, name)
        if size > 1:
            step = x.shape[d] // size
            x = x.narrow(d, mesh.get_local_rank(name) * step, step)
    return x


def plane_chunk(n_moduli: int, shards: int, index: int) -> tuple[int, int]:
    """[lo, hi) of the residue planes shard `index` of `shards` holds: N
    padded to a multiple of the shard count, as in the reference, so the
    last shards' chunks may be short or empty (a padded plane is never
    launched)."""
    chunk = -(-n_moduli // shards)
    lo = min(index * chunk, n_moduli)
    return lo, min(lo + chunk, n_moduli)
