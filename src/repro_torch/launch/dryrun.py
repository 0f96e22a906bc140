"""Multi-pod dry run: every (arch x shape x mesh) cell on meta tensors in a
fake world of 256 / 512 ranks, without a device.

The port's copy of `repro.launch.dryrun`.  Where the reference lowers and
compiles each cell for 512 placeholder host devices and reads XLA's
memory and cost analyses, the port runs the cell's step once, eagerly, on
the "meta" device (shapes and dtypes, no data) as rank 0 of a fake
process group (`torch.distributed`'s "fake" backend: its collectives move
nothing) of the production mesh's size, and reads what the step
allocated, computed, launched and sent.  Every number is a prediction for
one rank; none is measured on a device.

How a cell runs:

* **train** (`train_4k`): one step of the port's mesh step
  (`train.step.make_train_step(mesh=...)`, ``donate=False`` as in the
  reference) on the params, the AdamW state and the batch, each a
  `DTensor` of meta blocks placed by the step's own shardings
  (`train.step.mesh_shardings`: the parameter rules, ZeRO-1, the batch's
  rows over ('pod', 'data')).  The step gathers every param whole on
  every rank, as it does on the card.
* **prefill / decode**: `Model.prefill` / `Model.decode_step` as the port
  serves on a mesh: every rank holds the whole params and serves its
  batch rows (the batch split over the data dims as the reference's
  ``batch_sh``, size-aware: a batch the data dims do not divide stays
  whole), with the whole decode cache of its rows; the products run under
  the cell's policy, an emulated ``sharded`` one over the mesh's
  ('model', 'residue') sub-mesh (the dims that do not split the rows),
  as the train step pins it.  A decode step writes position
  ``seq_len - 1`` of a cache of ``seq_len``.

The kernel wrappers take the card's branch on meta tensors up to their
launch (`kernels.common.on_card`): each writes its launch record and
allocates its outputs and workspace, then returns without a launch.  The
record of a cell (one JSON a cell under ``--out``) holds, under the
reference's keys where they mean the same:

* ``memory_analysis``: ``argument_size_in_bytes`` (the rank's blocks of
  params, optimizer state, batch and cache), ``output_size_in_bytes``,
  ``alias_size_in_bytes`` (outputs that are arguments, a cache written in
  place) and ``temp_size_in_bytes``, the peak of live bytes during the
  step above the arguments (`torch.distributed._tools.mem_tracker.
  MemTracker`, which follows every allocation and free);
* ``flops_per_device``: `torch.utils.flop_counter.FlopCounterMode` over
  the aten products (on meta a kernel computes nothing: its products are
  ``kernel_ops_per_device``, the int8 and e4m3 operations of each traced
  launch);
* ``launches``: the launches by kernel (`analysis.trace`);
* ``collectives``: count and bytes by the port's kinds (``broadcast``,
  ``all-reduce-sum``, ``all-reduce-max``; ``all-reduce`` their sum) from
  `distributed.sharded_gemm.CollectiveLog`, the reference's other kinds
  at 0 (the port has none of them);
* ``loop_scale`` 1.0: eager torch runs every layer, so no loop body is
  counted once and each ``*_corrected`` field equals its plain one;
* ``lower_s`` (building the cell's meta state) and ``compile_s`` (the
  traced step), seconds on the host;
* ``fits``: arguments plus temp within the card's memory (default 80
  GiB, ``--device-memory-gib``).  A cell that does not fit is recorded
  ``status: "ok"`` with ``fits: false``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k [--multi-pod] [--backend ozaki2_f32] [--seq-shard]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

`dry_run` takes any config, `ShapeSpec` and mesh (or none: one process)
and returns the record; the CLI offers the reference's production meshes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import torch
import torch.distributed as dist

from ..analysis.trace import trace
from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, applicable, input_specs
from ..core.policy import GemmPolicy
from ..distributed.sharding import DEFAULT_RULES, NamedSharding, pspec_for_axes
from ..models import Model
from ..models.params import abstract_arrays, materialize
from ..optim import AdamWConfig, adamw_init
from ..train.step import GEMM_DIMS, make_train_step
from ..tree import tree_leaves, tree_map
from ..tune.cli import add_calibration_args, apply_calibration_args
from .mesh import make_mesh, production_mesh_shape

#: the card's memory a cell must fit in (H100 80GB)
DEVICE_MEMORY = 80 * 2**30

#: the reference's collective kinds (XLA's HLO ops), and the port's own
REFERENCE_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
PORT_COLLECTIVES = {"broadcast": "broadcast", "sum": "all-reduce-sum", "max": "all-reduce-max"}


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of `size` ranks (its
    collectives complete at once and move nothing), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world; this process already joined a process group "
                           f"of {dist.get_world_size()} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ cells


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def storage_bytes(tree) -> dict:
    """The distinct storages of a tree's tensors (a `DTensor`'s local
    block), by identity: {id: bytes}."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _arrays(abstract, device: torch.device):
    """A `ParamMeta` tree as meta tensors, or on another device as
    `params.materialize`'s values (seed 0)."""
    if device.type == "meta":
        return abstract_arrays(abstract)
    return materialize(abstract, torch.Generator().manual_seed(0), device)


def build_cell(cfg, spec: ShapeSpec, mesh, *, rules=None, grad_accum: int = 1, opt_cfg=None, schedule=None,
               donate: bool = False, device="meta"):
    """(fn, args) of one cell: the train step and its placed state, or the
    serving call and its whole params, rows and cache (the module's
    docstring says how).  `mesh` None: one process.  On meta tensors, or
    on `device` (random params, zero inputs: the same calls with data)."""
    rules = rules or DEFAULT_RULES
    device = torch.device(device)
    model = Model(cfg)
    params = _arrays(model.abstract_params(), device)
    inputs = {k: v if device.type == "meta" else torch.zeros_like(v, device=device)
              for k, v in input_specs(cfg, spec).items()}
    if spec.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        step, sh = make_train_step(model, opt_cfg, schedule, mesh=mesh, rules=rules, grad_accum=grad_accum,
                                   donate=donate)
        opt = adamw_init(params, opt_cfg)
        batch = inputs
        if sh is not None:
            params = tree_map(lambda x, s: s.place(x), params, sh["params"])
            opt = tree_map(lambda x, s: s.place(x), opt, sh["opt"])
            batch = {k: sh["batch"].place(v) for k, v in batch.items()}
        return step, (params, opt, batch)
    if mesh is not None and cfg.gemm_policy is not None and cfg.gemm_policy.execution == "sharded":
        gemm = tuple(n for n in mesh.mesh_dim_names if n in GEMM_DIMS)
        model = Model(dataclasses.replace(
            cfg, gemm_policy=dataclasses.replace(cfg.gemm_policy, mesh=mesh[gemm] if gemm else None)))

    def rows(x):
        if mesh is None:
            return x
        axes = ("batch",) + (None,) * (x.ndim - 1)
        return NamedSharding(mesh, pspec_for_axes(axes, rules, mesh, tuple(x.shape))).local(x).clone()

    batch = {k: rows(v) for k, v in inputs.items()}
    cache = _arrays(model.cache_abstract(batch["tokens"].shape[0], spec.seq_len), device)
    if spec.kind == "prefill":
        return torch.no_grad()(model.prefill), (params, batch, cache)
    return torch.no_grad()(model.decode_step), (params, batch["tokens"], cache, spec.seq_len - 1)


def collective_summary(records) -> dict:
    """Bytes by kind, the count by kind (``counts``), ``count`` and
    ``total`` of `analysis.trace.Collective` records."""
    out = {c: 0 for c in REFERENCE_COLLECTIVES}
    out.update({kind: 0 for kind in PORT_COLLECTIVES.values()})
    counts = {kind: 0 for kind in PORT_COLLECTIVES.values()}
    for r in records:
        kind = PORT_COLLECTIVES[r.op]
        out[kind] += math.prod(r.shape) * r.dtype.itemsize
        counts[kind] += 1
    out["all-reduce"] = out["all-reduce-sum"] + out["all-reduce-max"]
    out["count"] = len(records)
    out["counts"] = counts
    out["total"] = out["broadcast"] + out["all-reduce"]
    return out


def _kernel_ops(launches) -> dict:
    out = {"int8": 0, "e4m3": 0}
    for r in launches:
        if r.ops is not None:
            out[r.ops[0]] += r.ops[1]
    return out


def dry_run(cfg, spec: ShapeSpec, mesh_shape=None, *, rules=None, grad_accum: int = 1, opt_cfg=None,
            schedule=None, donate: bool = False, device_memory: int = DEVICE_MEMORY) -> dict:
    """One cell on meta tensors: `cfg` (any config) at `spec`, on a mesh
    given as ``(shape, dim names)`` (`launch.mesh.production_mesh_shape`'s
    form) over a fake world of its size, this process rank 0, or with
    `mesh_shape` None the one-process step (no world).  Returns the
    readings (the module's docstring); the caller adds the cell's id."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    world = contextlib.nullcontext() if mesh_shape is None else fake_world(math.prod(mesh_shape[0]))
    with world:
        mesh = None if mesh_shape is None else make_mesh(*mesh_shape, device_type="meta")
        t0 = time.perf_counter()
        fn, args = build_cell(cfg, spec, mesh, rules=rules, grad_accum=grad_accum, opt_cfg=opt_cfg,
                              schedule=schedule, donate=donate)
        t_build = time.perf_counter() - t0
        arg_storages = storage_bytes(args)
        mt = MemTracker()
        mt.track_external(*[_local(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        t0 = time.perf_counter()
        with mt, FlopCounterMode(display=False) as flops:
            tr = trace(fn, *args)
        t_step = time.perf_counter() - t0
    peak = sum(dev["Total"] for dev in mt.get_tracker_snapshot("peak").values())
    arg_bytes = sum(arg_storages.values())
    out_storages = storage_bytes(tr.result)
    alias = sum(b for k, b in out_storages.items() if k in arg_storages)
    mem = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(out_storages.values()),
        "alias_size_in_bytes": alias,
        "temp_size_in_bytes": max(0, peak - arg_bytes),
    }
    coll = collective_summary(tr.collectives)
    n_flops = float(flops.get_total_flops())
    return {
        "mesh": None if mesh_shape is None else list(mesh_shape[0]),
        "mesh_dims": None if mesh_shape is None else list(mesh_shape[1]),
        "flops_per_device": n_flops,
        "flops_per_device_corrected": n_flops,
        "kernel_ops_per_device": _kernel_ops(tr.launches),
        "launches": tr.launch_counts(),
        "loop_scale": 1.0,
        "memory_analysis": mem,
        "collectives": coll,
        "collective_bytes_corrected": coll["total"],
        "fits": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] <= device_memory,
        "device_memory_bytes": device_memory,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_step, 2),
    }


def cell_id(arch: str, shape_name: str, multi_pod: bool, backend: str = "native", seq_shard: bool = False,
            grad_accum: int = 1, vocab_chunk: int | None = None, moe_shard_tokens: bool = False,
            zero3: bool = False, kv_chunk: int | None = None, moe_group: int | None = None, mode: str = "fast",
            formulation: str = "karatsuba", n_block=None, execution: str = "reference", residue: int = 1,
            rtol: float | None = None) -> str:
    """The reference's cell id, letter for letter."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if residue > 1:
        mesh_name += f"r{residue}"
    cid = f"{arch}__{shape_name}__{mesh_name}"
    if backend != "native":
        cid += f"__{backend}"
        if execution != "reference":
            cid += f"__{execution}"
        if mode != "fast":
            cid += f"__{mode}"
        if formulation != "karatsuba":
            cid += f"__{formulation}"
        if n_block:
            cid += f"__nb{n_block}"
        if rtol is not None:
            cid += f"__rtol{rtol:g}"
    if seq_shard:
        cid += "__sp"
    if grad_accum > 1:
        cid += f"__ga{grad_accum}"
    if vocab_chunk:
        cid += f"__vc{vocab_chunk}"
    if moe_shard_tokens:
        cid += "__moest"
    if zero3:
        cid += "__zero3"
    if kv_chunk:
        cid += f"__kv{kv_chunk}"
    if moe_group:
        cid += f"__mg{moe_group}"
    return cid


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    backend: str = "native",
    seq_shard: bool = False,
    grad_accum: int = 1,
    vocab_chunk: int | None = None,
    moe_shard_tokens: bool = False,
    zero3: bool = False,
    kv_chunk: int | None = None,
    moe_group: int | None = None,
    mode: str = "fast",
    formulation: str = "karatsuba",
    n_block=None,
    execution: str = "reference",
    residue: int = 1,
    rtol: float | None = None,
    out_dir: str | None = None,
    verbose: bool = True,
    device_memory: int = DEVICE_MEMORY,
):
    """One production cell, the reference's `run_cell`: its id, its skip
    record or its readings (`dry_run`) on the 16 x 16 (or 2 x 16 x 16)
    mesh, residue > 1 carved out of the model dim."""
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape_name)
    cid = cell_id(arch, shape_name, multi_pod, backend, seq_shard, grad_accum, vocab_chunk, moe_shard_tokens,
                  zero3, kv_chunk, moe_group, mode, formulation, n_block, execution, residue, rtol)
    if not ok:
        rec = {"cell": cid, "status": "skipped", "reason": why}
        _emit(rec, out_dir, verbose)
        return rec
    mesh_shape = production_mesh_shape(multi_pod, residue)
    overrides = {}
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if backend != "native":
        # the sharded execution runs over the cell's mesh (the step and the
        # serving call pin its model/residue sub-mesh)
        overrides["gemm_policy"] = GemmPolicy(backend=backend, mode=mode, formulation=formulation,
                                              n_block=n_block, execution=execution, rtol=rtol)
        overrides["embed_pspec"] = (batch_axes, None, None)
    if seq_shard:
        overrides["act_pspec"] = (batch_axes, "model", None)
    if vocab_chunk:
        overrides["loss_vocab_chunk"] = vocab_chunk
    if moe_shard_tokens:
        overrides["moe_dispatch_pspec"] = ((("pod", "data"),) if multi_pod else (("data",),))
    if kv_chunk:
        overrides["kv_chunk"] = kv_chunk
    if moe_group:
        overrides["moe_group_size"] = moe_group
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rules = dict(DEFAULT_RULES)
    if zero3:
        rules["embed"] = "data"
    rec = {"cell": cid, "status": "ok", "arch": arch, "shape": shape_name, "backend": backend,
           "execution": execution, "seq_shard": seq_shard, "grad_accum": grad_accum}
    rec.update(dry_run(cfg, SHAPES[shape_name], mesh_shape, rules=rules, grad_accum=grad_accum,
                       device_memory=device_memory))
    _emit(rec, out_dir, verbose)
    return rec


def _emit(rec: dict, out_dir: str | None, verbose: bool):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, rec["cell"] + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    if not verbose:
        return
    if rec["status"] == "skipped":
        print(f"[skip] {rec['cell']}: {rec['reason']}")
        return
    mem, c = rec["memory_analysis"], rec["collectives"]
    ops = rec["kernel_ops_per_device"]
    print(
        f"[ok]   {rec['cell']}: flops/dev={rec['flops_per_device']:.3e} "
        f"kernel_ops/dev=int8 {ops['int8']:.3e} e4m3 {ops['e4m3']:.3e} "
        f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
        f"out={mem['output_size_in_bytes'] / 2**30:.2f}GiB fits={rec['fits']} "
        f"coll={c['total'] / 2**20:.1f}MiB({c['count']} ops: bcast={c['broadcast'] / 2**20:.0f} "
        f"ar_sum={c['all-reduce-sum'] / 2**20:.0f} ar_max={c['all-reduce-max'] / 2**20:.0f}) "
        f"launches={sum(rec['launches'].values())} trace={rec['compile_s']:.1f}s",
        flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--backend", default="native",
                    choices=["native", "ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"])
    ap.add_argument("--execution", default="reference",
                    choices=["reference", "kernel", "per_modulus_kernel", "sharded", "fp8", "fused"],
                    help="residue backend running the emulation plan (fp8: the e4m3 digit-GEMM engine; "
                         "fused: the one-launch megakernel)")
    ap.add_argument("--residue", type=int, default=1,
                    help="residue mesh-axis size (sharded execution): carved out of the 16-way model axis")
    ap.add_argument("--mode", default="fast", choices=["fast", "accu", "auto"])
    ap.add_argument("--rtol", type=float, default=None,
                    help="componentwise accuracy target (adaptive policy: fewest moduli provably meeting it; "
                         "required for --mode auto)")
    ap.add_argument("--formulation", default="karatsuba", choices=["karatsuba", "block_a", "block_b", "auto"])
    ap.add_argument("--n-block", default=None, type=lambda s: "auto" if s == "auto" else int(s),
                    help="output-column blocking: an int or 'auto'")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device-memory-gib", type=float, default=DEVICE_MEMORY / 2**30,
                    help="the card's memory a cell must fit in (default: 80, an H100 80GB)")
    add_calibration_args(ap)
    args = ap.parse_args(argv)
    apply_calibration_args(args)
    if args.mode == "auto" and args.rtol is None:
        ap.error("--mode auto needs an accuracy target: pass --rtol")
    memory = int(args.device_memory_gib * 2**30)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        failures = []
        for arch in ARCHS:
            for shape in SHAPES:
                for mp in meshes:
                    try:
                        run_cell(arch, shape, mp, out_dir=args.out, device_memory=memory)
                    except Exception as e:  # keep sweeping; record the bug
                        failures.append((arch, shape, mp, f"{type(e).__name__}: {e}"))
                        print(f"[FAIL] {arch}/{shape}/mp={mp}: {type(e).__name__}: {e}", flush=True)
        print(f"sweep done, {len(failures)} failures")
        for f in failures:
            print("  FAIL:", f)
        return 1 if failures else 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required unless --all")
    for mp in meshes:
        run_cell(args.arch, args.shape, mp, backend=args.backend, seq_shard=args.seq_shard,
                 grad_accum=args.grad_accum, mode=args.mode, formulation=args.formulation, n_block=args.n_block,
                 execution=args.execution, residue=args.residue, rtol=args.rtol, out_dir=args.out,
                 device_memory=memory)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
