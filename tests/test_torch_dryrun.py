"""The port's dry run (`repro_torch.launch.dryrun`) against `repro.launch.dryrun`.

Cell ids and skip records are the reference's letter for letter; each
rank's parameter and ZeRO-1 optimizer bytes are the reference's shard
shapes under its rules (jax `AbstractMesh`, no devices); on a reduced cell
the meta run's launch records and outputs' shapes and dtypes equal a CPU
run's on every execution, and its flop count equals the CPU's; one
full-width cell runs through the CLI.  No tolerance: every comparison is
an equality.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from test_torch_train import one_thread  # noqa: F401  (autouse fixture: small products on one thread)

import repro.configs as jconfigs
from repro.distributed.sharding import DEFAULT_RULES as J_RULES
from repro.distributed.sharding import optimizer_spec as j_optimizer_spec
from repro.distributed.sharding import pspec_for_meta as j_pspec_for_meta
from repro.models import Model as JModel
from repro.models.params import _map_like as j_map_like
from repro_torch import GemmPolicy
from repro_torch.analysis.trace import trace
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core.policy import EXECUTIONS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, production_mesh_shape
from repro_torch.tree import tree_leaves

_xla_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdry  # noqa: E402  (sets XLA_FLAGS on import: restored at once)

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

NAMES = ("data", "model", "residue")


@pytest.fixture(autouse=True)
def no_world():
    """Each test starts and ends outside any process group."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ------------------------------------------------------------- cell ids

ID_CASES = [
    dict(),
    dict(multi_pod=True),
    dict(backend="ozaki2_f32", execution="kernel"),
    dict(backend="ozaki2_c64", execution="sharded", residue=4, multi_pod=True),
    dict(backend="ozaki2_f64", mode="accu", formulation="block_a", n_block=256, rtol=1e-6),
    dict(backend="ozaki2_c128", execution="fp8", mode="auto", rtol=2.5e-9, n_block="auto", formulation="auto"),
    dict(seq_shard=True, grad_accum=4, vocab_chunk=8192, moe_shard_tokens=True, zero3=True, kv_chunk=512,
         moe_group=1024),
    dict(backend="native", execution="fused", mode="accu", residue=2),
]


@pytest.mark.parametrize("kw", ID_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_cell_ids_are_the_reference_s(monkeypatch, capsys, kw):
    """The reference's `run_cell` with `applicable` patched to refuse
    returns its id without a mesh; the port's id is the same string."""
    monkeypatch.setattr(jdry, "applicable", lambda cfg, shape: (False, "patched"))
    kw = {"multi_pod": False, **kw}
    for arch, shape in (("qwen2.5-32b", "train_4k"), ("mamba2-130m", "decode_32k")):
        want = jdry.run_cell(arch, shape, **kw)["cell"]
        assert dryrun.cell_id(arch, shape, **kw) == want


def test_skip_records_are_the_reference_s():
    """The eight full-attention archs skip the 512k decode on both meshes
    with the reference's record; the SSM archs run it."""
    skipped = 0
    for arch in ARCHS:
        if jdry.applicable(jconfigs.get_config(arch), "long_500k")[0]:
            assert dryrun.applicable(get_config(arch), "long_500k")[0]
            continue
        for mp in (False, True):
            got = dryrun.run_cell(arch, "long_500k", mp, verbose=False)
            assert got == jdry.run_cell(arch, "long_500k", mp, verbose=False)
            skipped += 1
    assert skipped == 16


# ------------------------------------------------- the rank's argument bytes


def _ref_bytes(arch: str, multi_pod: bool) -> int:
    """Bytes of one rank's params and AdamW state under the reference's
    rules: each leaf's `NamedSharding(AbstractMesh, spec).shard_shape`."""
    shape, names = production_mesh_shape(multi_pod)
    jm = JAbstractMesh(shape, names)
    abstract = JModel(jconfigs.get_config(arch)).abstract_params()

    def leaf_bytes(meta, spec, dtype):
        return int(np.prod(JNamedSharding(jm, JP(*spec)).shard_shape(meta.shape))) * np.dtype(dtype).itemsize

    def one(_, m):
        spec = j_pspec_for_meta(m, J_RULES, jm)
        opt = j_optimizer_spec(spec, m.shape, jm)
        # the param in its dtype, then m, v and the master copy in float32
        return leaf_bytes(m, spec, jax.numpy.dtype(m.dtype)) + 3 * leaf_bytes(m, opt, np.float32)

    return sum(jax.tree.leaves(j_map_like(abstract, one))) + 4  # + the int32 step


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_bytes_are_the_reference_s(arch, multi_pod):
    shape, names = production_mesh_shape(multi_pod)
    with dryrun.fake_world(int(np.prod(shape))):
        mesh = make_mesh(shape, names, device_type="meta")
        _, (params, opt, _) = dryrun.build_cell(get_config(arch), SHAPES["train_4k"], mesh)
        got = sum(dryrun.storage_bytes({"params": params, "opt": opt}).values())
    assert got == _ref_bytes(arch, multi_pod)


# ------------------------------------------- meta against the CPU, reduced

TINY = ShapeSpec("tiny_train", 16, 2, "train")


def _run(cfg, device):
    """The tiny train cell on a (1, 1, 1) mesh: its launch records and
    its outputs' shapes and dtypes."""
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1, 1), NAMES, device_type=device)
        fn, args = dryrun.build_cell(cfg, TINY, mesh, device=device)
        tr = trace(fn, *args)
        out = [(tuple(t.shape), t.dtype) for t in tree_leaves(tr.result) if isinstance(t, torch.Tensor)]
    return tr.launches, out


@pytest.mark.parametrize("execution", EXECUTIONS)
def test_meta_launches_and_outputs_equal_the_cpu_s(execution):
    """On meta the wrappers record the launches the CPU's plain versions
    record (the card's), and allocate outputs of the same shapes and
    dtypes; no launch is counted."""
    import repro_torch.kernels as kernels

    cfg = get_reduced("mamba2-130m", dtype="float32", n_layers=1,
                      gemm_policy=GemmPolicy(backend="ozaki2_f32", execution=execution))
    before = kernels.launch_counts()
    meta, cpu = _run(cfg, "meta"), _run(cfg, "cpu")
    assert meta == cpu
    assert kernels.launch_counts() == before
    if execution != "reference":
        assert meta[0] and all(r.ops is not None for r in meta[0] if r.k is not None)


def test_meta_flops_equal_the_cpu_s():
    from torch.utils.flop_counter import FlopCounterMode

    spec = ShapeSpec("tiny_prefill", 32, 2, "prefill")
    counts = []
    for device in ("meta", "cpu"):
        fn, args = dryrun.build_cell(get_reduced("qwen2.5-32b", dtype="float32"), spec, None, device=device)
        with FlopCounterMode(display=False) as flops:
            fn(*args)
        counts.append(flops.get_total_flops())
    assert counts[0] == counts[1] > 0
    rec = dryrun.dry_run(get_reduced("qwen2.5-32b", dtype="float32"), spec)
    assert rec["flops_per_device"] == counts[0] and rec["launches"] == {}


def test_refuses_a_joined_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already joined"):
            dryrun.dry_run(get_reduced("mamba2-130m"), TINY, ((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ a full-width cell


def test_full_width_cell_through_the_cli(tmp_path, capsys):
    """mamba2-130m's 512k decode on the 16 x 16 mesh, as published: one
    record, its readings there and consistent."""
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--out", str(tmp_path)]) == 0
    assert "[ok]   mamba2-130m__long_500k__pod16x16:" in capsys.readouterr().out
    rec = json.loads((tmp_path / "mamba2-130m__long_500k__pod16x16.json").read_text())
    mem = rec["memory_analysis"]
    assert rec["status"] == "ok" and rec["mesh"] == [16, 16] and rec["fits"] is True
    assert rec["loop_scale"] == 1.0 and rec["flops_per_device_corrected"] == rec["flops_per_device"] > 0
    assert mem["argument_size_in_bytes"] > mem["alias_size_in_bytes"] > 0  # the cache, written in place
    assert mem["temp_size_in_bytes"] > 0 and rec["launches"] == {}
    assert rec["collectives"]["count"] == 0 and rec["collectives"]["all-gather"] == 0
