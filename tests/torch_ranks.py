"""A pool of gloo ranks for the port's multi-rank CPU tests, and the tasks
they run.

`RankPool(world, store)` spawns `world` processes once, each joined to one
gloo process group through a `FileStore` (no port to collide across the
suite's workers) and on one intra-op thread; `pool.run(task, *args)` hands
every rank the same task and returns each rank's result, raising if a rank
failed or did not answer within the timeout (a hang in a collective shows
so).  The ranks import torch, numpy and `repro_torch` only: the tasks live
here, and the tests hold their results against the JAX reference in the
test process.  A task's mesh is a `DeviceMesh` over the first ranks of the
world; a rank off the mesh returns None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import multiprocessing
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

NAMES = ("data", "model", "residue")


class RankPool:
    def __init__(self, world: int, store_path: str, timeout: float = 120.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, args=(r, world, store_path, self.tasks[r], self.results),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = None

    def run(self, task, *args, timeout: float | None = None) -> list:
        """`task(*args)` on every rank; the results by rank."""
        if self.broken:
            raise RuntimeError(f"the rank pool broke in an earlier task: {self.broken}")
        for q in self.tasks:
            q.put((task, args))
        got, errors = {}, []
        try:
            while len(got) < self.world:
                rank, ok, value = self.results.get(timeout=timeout or self.timeout)
                got[rank] = value
                if not ok:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.broken = f"{task.__name__}: ranks {sorted(set(range(self.world)) - set(got))} timed out"
            raise TimeoutError(self.broken) from None
        if errors:
            self.broken = f"{task.__name__} failed"
            raise AssertionError("\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _rank_main(rank, world, store_path, tasks, results):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        while (item := tasks.get()) is not None:
            task, args = item
            try:
                results.put((rank, True, task(*args)))
            except BaseException:  # reported to the test, which fails with it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ meshes

_MESHES = {}


def mesh_of(shape, names=NAMES):
    """The `DeviceMesh` of `shape` over ranks 0..prod(shape)-1, built once a
    process (every rank builds it: its groups are made collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=names)
    return _MESHES[key]


def _on(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _policy(fields, mesh):
    from repro_torch import GemmPolicy

    return GemmPolicy(**fields, mesh=mesh)


# ------------------------------------------------------------------- tasks


def sharded_matmul(shape, a, b, fields, names=NAMES):
    """`linalg.matmul(a, b)` under ``GemmPolicy(**fields, mesh=...)`` with
    the collectives logged: (output, log) on a rank of the mesh."""
    from repro_torch import linalg
    from repro_torch.distributed.sharded_gemm import CollectiveLog

    mesh = mesh_of(shape, names)
    if not _on(mesh):
        return None
    with CollectiveLog() as log:
        y = linalg.matmul(a, b, policy=_policy(fields, mesh), device="cpu")
    return y.numpy(), [(op, str(dt), shp, dim) for op, dt, shp, dim in log.calls]


def traced_collectives(shape, a, b, fields):
    """`linalg.matmul(a, b)` under the sharded policy, traced
    (`repro_torch.analysis.trace`): (the collective-safety pass's findings,
    each collective as (op, dtype)) on a rank of the mesh."""
    from repro_torch import linalg
    from repro_torch.analysis import CollectiveSafetyPass, trace

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    pol = _policy(fields, mesh)
    tr = trace(lambda x, w: linalg.matmul(x, w, policy=pol, device="cpu"), torch.from_numpy(a), torch.from_numpy(b))
    return [str(f) for f in CollectiveSafetyPass().run(tr)], [(c.op, str(c.dtype)) for c in tr.collectives]


def fused_calls(shape, a, b, fields):
    """(output, megakernel calls) of `execution="fused"` under a mesh."""
    from repro_torch import linalg
    from repro_torch.kernels.ops import FusedBackend

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    calls = []
    real, cplx = FusedBackend.fused_gemm, FusedBackend.fused_karatsuba_gemm

    def count(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    FusedBackend.fused_gemm, FusedBackend.fused_karatsuba_gemm = count(real), count(cplx)
    try:
        y = linalg.matmul(a, b, policy=_policy(fields, mesh), device="cpu")
    finally:
        FusedBackend.fused_gemm, FusedBackend.fused_karatsuba_gemm = real, cplx
    return y.numpy(), len(calls)


def reference_inner(shape, a, b, plan_kw):
    """`ShardedBackend(REFERENCE, mesh).run_plan` on the 2D operands."""
    from repro_torch.core.executor import REFERENCE
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import ShardedBackend

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    return ShardedBackend(REFERENCE, mesh).run_plan(make_plan(a.dtype, **plan_kw), a, b).numpy()


def sharded_grads(shape, a, b, fields):
    """(y, dX, dW) of sum(matmul(a, b)^2) under the sharded policy, the
    backward called outside the policy's scopes."""
    from repro_torch import linalg, use_policy
    from repro_torch.core.policy import GemmPolicy

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    x = torch.from_numpy(a).requires_grad_(True)
    w = torch.from_numpy(b).requires_grad_(True)
    with use_policy(GemmPolicy(**fields), mesh=mesh):  # the mesh from the scope
        y = linalg.matmul(x, w, device="cpu")
    (y * y).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def policy_surface(a, b):
    """The mesh scopes and refusals on a (1, 1, 2) mesh; returns the
    outputs of the scoped calls."""
    import pytest

    from repro_torch import GemmPolicy, current_mesh, linalg, use_mesh, use_policy
    from repro_torch.core.policy import policy_matmul, prepare_weights

    mesh, other = mesh_of((1, 1, 2)), mesh_of((2, 1, 1))
    if not _on(mesh):
        return None
    pol = GemmPolicy(backend="ozaki2_f32", execution="sharded", n_moduli=5)
    x, w = torch.from_numpy(a), torch.from_numpy(b)
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is mesh
        with use_mesh(other):  # nested: the innermost wins
            assert current_mesh() is other
        assert current_mesh() is mesh
        scoped = policy_matmul(x, w, pol)
    assert current_mesh() is None
    with use_policy(pol, mesh=mesh):
        assert current_mesh() is mesh and linalg.current_policy() is pol
        both = linalg.matmul(x, w, device="cpu")
    assert current_mesh() is None and linalg.current_policy().backend == "native"
    with pytest.raises(TypeError, match="DeviceMesh"):
        with use_mesh("not a mesh"):
            pass
    with pytest.raises(ValueError, match="needs a mesh"):
        policy_matmul(x, w, pol)
    # prepared weights meet a sharded execution: refused, naming the way out
    kpol = dataclasses.replace(pol, execution="kernel")
    prep = prepare_weights({"w": w}, kpol, device="cpu")["w"]
    spol = dataclasses.replace(pol, mesh=mesh)
    fpol = dataclasses.replace(pol, execution="fused", mesh=mesh)
    for p in (spol, fpol):
        with pytest.raises(NotImplementedError, match="execution='kernel'"):
            policy_matmul(x, prep, p)
        with pytest.raises(NotImplementedError, match="mesh"):
            prepare_weights({"w": w}, p, device="cpu")
    assert hash(spol) == hash(dataclasses.replace(spol))
    return scoped.numpy(), both.numpy()


def plan_fields(shape, fields, m, k, n):
    """What `plan_for` of a sharded policy picks for (m, k, n)."""
    from repro_torch import GemmPolicy

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    plan = GemmPolicy(**fields, mesh=mesh).plan_for(m, k, n)
    return plan.formulation, plan.n_block, plan.ctx.n, plan.mode


def measure_psum():
    from repro_torch.tune.calibrate import _measure_psum

    return _measure_psum(True, torch.device("cpu"))


def mesh_builders():
    """`make_host_mesh`'s meshes, clamped to this world, by their shapes
    and dim names; `make_production_mesh` refused (256 ranks needed)."""
    import pytest

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    meshes = [make_host_mesh(*dims, device_type="cpu") for dims in ((1, 1, 16), (2, 4, 1), (16, 1, 1), (2, 2, 2))]
    return [(tuple(m.shape), m.mesh_dim_names) for m in meshes]


# ---------------------------------------------------------- models and CLIs


def serve_tiny(shape, execution):
    """The reference's tiny sharded-serving model (`tests/test_sharded.py`)
    built under `use_policy`, served greedily: (tokens, logits); `shape`
    is the mesh of the sharded execution."""
    from repro_torch import GemmPolicy, use_policy
    from repro_torch.models import Model, ModelConfig
    from repro_torch.serve import ServeEngine

    mesh = mesh_of(shape) if execution == "sharded" else None
    if mesh is not None and not _on(mesh):
        return None
    pol = GemmPolicy(backend="ozaki2_f32", n_moduli=6, execution=execution, mesh=mesh)
    with use_policy(pol):
        cfg = ModelConfig(name="tiny-sharded", n_layers=1, d_model=32, vocab=64, n_heads=2, n_kv_heads=1,
                          head_dim=16, d_ff=64, dtype="float32")
    assert cfg.gemm_policy == pol
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, cache_len=8, batch_size=1, device="cpu")
    tok, logits = eng.generate({"tokens": torch.tensor([[3, 1, 4, 1]], dtype=torch.int32)}, 2,
                               return_logits=True)
    return tok.numpy(), logits.numpy()


def serve_cli(argv):
    """The serve CLI's main on this rank: (exit code, stdout, tokens)."""
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    toks, real = [], ServeEngine.generate

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        toks.append(out.numpy())
        return out

    ServeEngine.generate, out = recording, io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main(argv)
    finally:
        ServeEngine.generate = real
    return rc, out.getvalue(), toks


def train_cli(argv):
    """The train CLI's main on this rank: (exit code, stdout, every
    step's loss)."""
    from repro_torch.launch import train

    hist, real = [], train.train_loop

    def recording(*args, **kwargs):
        params, h = real(*args, **kwargs)
        hist.extend(h)
        return params, h

    train.train_loop, out = recording, io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = train.main(argv)
    finally:
        train.train_loop = real
    return rc, out.getvalue(), hist


def train_step_mesh_refused():
    """A policy pinned to a mesh whose data dim is 2 is refused by the mesh
    step (its products would mix the data ranks' rows); the same mesh with
    the policy unpinned returns the step and its shardings."""
    import pytest

    from repro_torch import GemmPolicy
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    mesh = mesh_of((2, 1, 1))
    if not _on(mesh):
        return None
    pinned = GemmPolicy(backend="ozaki2_f32", execution="sharded", mesh=mesh)
    with pytest.raises(ValueError, match="data ranks"):
        make_train_step(Model(get_reduced("mamba2-130m", gemm_policy=pinned)), AdamWConfig(), mesh=mesh)
    _, shardings = make_train_step(Model(get_reduced("mamba2-130m")), AdamWConfig(), mesh=mesh)
    return sorted(shardings)


# ------------------------------------------------------- the training mesh


@contextlib.contextmanager
def _deterministic():
    """The embedding's backward (`index_put_` with accumulation) in one
    order, as the one-process runs it compares with."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _numpy(tree):
    from repro_torch.distributed.sharded_gemm import full_tensor
    from repro_torch.tree import tree_map

    return tree_map(lambda t: full_tensor(t).detach().numpy(), tree)


def mesh_step(shape, cfg, params, state, tokens, grad_accum=1, steps=1):
    """`steps` train steps of `cfg` (a port `ModelConfig`) on the mesh,
    from numpy params and optimizer state and the global batch `tokens`
    (each step the same): the gathered params, state and every step's
    metrics, as numpy."""
    from repro_torch.distributed.elastic import reshard
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    step, sh = make_train_step(Model(cfg), AdamWConfig(lr=1e-3), mesh=mesh, grad_accum=grad_accum)
    p = reshard(params_from_numpy(params, "cpu"), sh["params"])
    o = reshard(params_from_numpy(state, "cpu"), sh["opt"])
    metrics = []
    with _deterministic():
        for _ in range(steps):
            p, o, met = step(p, o, {"tokens": sh["batch"].place(torch.from_numpy(tokens))})
            metrics.append({k: np.asarray(v) for k, v in met.items()})
    return _numpy(p), _numpy(o), metrics


def mesh_init(shape, cfg):
    """`init_state` with the mesh step's shardings: this rank's local
    blocks, each leaf's spec and its placements."""
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_state, mesh_shardings
    from repro_torch.tree import tree_leaves, tree_map

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    model, opt = Model(cfg), AdamWConfig()
    sh = mesh_shardings(model, opt, mesh)
    params, state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu", sh)
    local = tree_map(lambda t: t.to_local().numpy(), {"params": params, "opt": state})
    specs = [s.spec for s in tree_leaves({"params": sh["params"], "opt": sh["opt"]})]
    return local, specs, mesh.get_coordinate()


def save_params(shape, cfg, directory, step):
    """The one-process init placed on the mesh, gathered, and saved by rank 0
    at `step` (every rank gathers)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharded_gemm import full_tensor
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_state, mesh_shardings
    from repro_torch.tree import tree_map

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    model = Model(cfg)
    params, _ = init_state(model, AdamWConfig(), torch.Generator().manual_seed(1), "cpu",
                           mesh_shardings(model, AdamWConfig(), mesh))
    whole = tree_map(full_tensor, params)
    if dist.get_rank() == 0:
        Checkpointer(directory).save(step, whole)
    return True


def elastic(shape, cfg, directory):
    """`elastic_restore` of the latest params under `directory` onto the
    mesh: (step, this rank's local blocks, each leaf's placements as
    strings, this rank's coordinate)."""
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.models import Model
    from repro_torch.tree import tree_map

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    step, params = elastic_restore(directory, Model(cfg).abstract_params(), mesh)
    return (step, tree_map(lambda t: t.to_local().numpy(), params), tree_map(lambda t: str(t.placements), params),
            mesh.get_coordinate())


def mesh_train_loop(shape, cfg, data_fields, loop_fields):
    """`train_loop` on the mesh: every step's loss and the gathered final
    params (numpy); the log lines of rank 0."""
    from repro_torch.data import DataConfig
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig, train_loop

    mesh = mesh_of(shape)
    if not _on(mesh):
        return None
    logs = []
    with _deterministic():
        params, hist = train_loop(Model(cfg), DataConfig(**data_fields), TrainLoopConfig(**loop_fields),
                                  AdamWConfig(), mesh=mesh, log=logs.append, device="cpu")
    return hist, _numpy(params), logs


def compressed_mean(shape, names, dim, grads, errs, rounds=1):
    """`error_feedback_psum` over the mesh dim `dim`: rank r's grad is
    grads[r] (and its error errs[r]), numpy arrays or tensors; each round
    after the first feeds a zero grad.  (mean, new error) tensors of every
    round on this rank.  From zero errors `tree_error_feedback_psum` over
    `init_error_buffers` must give the same first round, leaf by leaf."""
    from repro_torch.distributed.compression import (
        error_feedback_psum,
        init_error_buffers,
        tree_error_feedback_psum,
    )

    mesh = mesh_of(shape, names)
    if not _on(mesh):
        return None
    r = mesh.get_local_rank(dim)
    g, e = torch.as_tensor(grads[r]), torch.as_tensor(errs[r])
    out = []
    for i in range(rounds):
        mean, e = error_feedback_psum(g if i == 0 else torch.zeros_like(g), e, mesh, dim)
        out.append((mean, e))
    if not torch.as_tensor(errs[r]).any():  # the tree form from fresh buffers: the same first round
        tree = {"w": [g, g[:3]]}
        means, news = tree_error_feedback_psum(tree, init_error_buffers(tree), mesh, dim)
        first = error_feedback_psum(g[:3], torch.zeros(g[:3].shape), mesh, dim)
        assert torch.equal(means["w"][0], out[0][0]) and torch.equal(news["w"][0], out[0][1])
        assert torch.equal(means["w"][1], first[0]) and torch.equal(news["w"][1], first[1])
    return out


def pipeline_grads(pp, cfg, params, tokens, n_micro):
    """`pipeline_loss` on a (pp,) mesh and its grads on this rank: (loss,
    stage index, grads as numpy)."""
    from repro_torch.distributed.pipeline import pipeline_loss
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, unflatten

    mesh = mesh_of((pp,), ("pp",))
    if not _on(mesh):
        return None
    params = params_from_numpy(params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    with _deterministic():
        loss = pipeline_loss(Model(cfg), unflatten(params, leaves), {"tokens": torch.from_numpy(tokens)}, mesh, "pp",
                             n_micro)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return float(loss), mesh.get_local_rank("pp"), unflatten(params, [g.numpy() for g in grads])
