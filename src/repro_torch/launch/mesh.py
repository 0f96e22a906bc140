"""Device meshes over the ranks of a `torch.distributed` run.

The port's copy of `repro.launch.mesh`.  `init_world` joins the run's
process group: the launcher's (``python -m torch.distributed.run`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ...) or, with
no launcher, a world of one.  Its transport is chosen from where the
ranks compute: NCCL where each rank of a host has a card of its own, gloo
where ranks share a card (NCCL refuses two ranks on one card) and on the
CPU.  `make_host_mesh` lays a (data, model, residue) mesh over the first
ranks of the world; `make_production_mesh` the reference's production
shapes, on a world of exactly that many ranks.

The optional `residue` dim carves residue-plane parallelism for
``GemmPolicy(execution="sharded")`` out of the model dim: the N residue
planes of every emulated GEMM are split over it, m and n over data and
model (`distributed/sharded_gemm.py`).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_world(device: torch.device) -> tuple[torch.device, bool]:
    """Join this run's process group, if not joined yet; returns this
    rank's device (``cuda:<local rank % cards>`` on the card) and whether
    the call created the group (its creator destroys it)."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        backend = "nccl" if ranks_here <= torch.cuda.device_count() else "cpu:gloo,cuda:gloo"
    else:
        backend = "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, rank=int(os.environ.get("RANK", "0")), world_size=world)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: start the ranks with "
                           "python -m torch.distributed.run")
    return device, True


def _mesh(shape: tuple, names: tuple, device_type: str) -> DeviceMesh:
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape), mesh_dim_names=names)


def production_mesh_shape(multi_pod: bool = False, residue: int = 1) -> tuple[tuple, tuple]:
    """(shape, dim names) of the production mesh: 16 x 16 = 256 chips a
    pod, 2 pods when `multi_pod`; residue > 1 splits the 16-way model dim
    into (model // residue, residue)."""
    model = 16
    if residue > 1:
        if model % residue:
            raise ValueError(f"residue={residue} must divide the model axis ({model})")
        if multi_pod:
            return (2, 16, model // residue, residue), ("pod", "data", "model", "residue")
        return (16, model // residue, residue), ("data", "model", "residue")
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod else ((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, residue: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The production mesh (`production_mesh_shape`) over a world of
    exactly its size."""
    shape, names = production_mesh_shape(multi_pod, residue)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} needs {need} ranks; the world has {world}")
    return _mesh(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1, residue: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the first ranks of the world, each size clamped
    to the ranks there are, as the reference clamps to its devices.
    residue > 1 appends a 'residue' dim; otherwise the mesh keeps the
    2-dim ('data', 'model') layout."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    if residue > 1:
        residue = min(residue, max(1, n // (data * model)))
        return _mesh((data, model, residue), ("data", "model", "residue"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)
