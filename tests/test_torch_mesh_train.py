"""The train step, loop and CLI on a parameter-sharded mesh
(`repro_torch.train` on a `DeviceMesh`), run by gloo ranks on the CPU
(`torch_ranks.RankPool`, a pool of 4 for the module).

The contract: a (D, M[, R]) mesh step with ``grad_accum=1`` is bitwise
the port's one-process step with ``grad_accum=D``, every rank's gathered
params, optimizer state and loss; a sharded policy on the mesh is
bitwise `kernel` on one process.  Two configs from the same numpy
weights, both drawn by the port's crc32 init, the same in every process
(`test_torch_train.fixed_draw` for mamba2-130m): the tiny `ModelConfig`
of `tests/test_distributed.py` on
`GemmPolicy(backend="ozaki2_f32", execution="kernel")` and reduced
mamba2-130m (native linears), on meshes (2, 1), (1, 2), (2, 2) and, with
every linear sharded, (2, 1, 2).  The one-process step is held against
the reference's jitted single-device step from the same weights and
state (grad_accum 1 and 2) by `tests/test_torch_train.py`'s LOSS_RTOL,
NORM_RTOL and GRAD_TOL, for mamba2-130m: the reference's emulated steps
take 35-52 s each to compile here (its kernels in interpret mode), and
the emulated products are held bitwise against the reference in
`tests/test_torch_models.py` and `tests/test_torch_train_kernel.py`.
``grad_accum=2`` on (2, 1) is held to one process with ``grad_accum=4``
by the reference's own grad-accumulation tolerances (loss rtol 1e-5,
params rtol 1e-3 / atol 1e-5).  `init_state` with the step's shardings
gives each rank the blocks, under the reference's specs, of the
one-process init; a run resumed on another mesh continues as one process
with the new D resumes; ``--mesh 2x2`` prints the losses of one process
with ``--grad-accum 2``.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from conftest import SEED

import repro  # noqa: F401  (x64, as the reference runs)
from repro.configs import get_reduced as j_get_reduced
from repro.distributed.sharding import DEFAULT_RULES as J_RULES
from repro.distributed.sharding import optimizer_spec as j_optimizer_spec
from repro.distributed.sharding import pspec_for_meta as j_pspec_for_meta
from repro.models import Model as JModel
from repro.models.params import _map_like as j_map_like
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.step import make_train_step as j_make_train_step
import torch_ranks
from repro_torch import GemmPolicy
from repro_torch.data import DataConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop
from repro_torch.train.step import init_state
from repro_torch.tree import tree_leaves
from test_torch_param_sharding import _bitwise, _block, _on_mesh
from test_torch_train import LOSS_RTOL, NORM_RTOL, _hold_moments, fixed_draw

B, S = 8, 16
OPT = dict(lr=1e-3)
TINY = ModelConfig(name="tiny", n_layers=2, d_model=32, vocab=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                   dtype="float32", remat=True, gemm_policy=GemmPolicy(backend="ozaki2_f32", n_moduli=4,
                                                                       execution="kernel"))
# (mesh, execution of the mesh's linears)
MESHES = [((2, 1, 1), "kernel"), ((1, 2, 1), "kernel"), ((2, 2, 1), "kernel"), ((2, 1, 2), "sharded")]
NAMES = ("data", "model", "residue")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = torch_ranks.RankPool(4, str(tmp_path_factory.mktemp("ranks") / "store"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def one_thread_deterministic():
    """This process's side as the ranks run it: one intra-op thread and
    deterministic algorithms (the embedding's backward)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


class _Case:
    """One config: the weights and optimizer state as numpy (tiny: the
    port's init; mamba2-130m: `test_torch_train.fixed_draw`, the port's
    crc32 init and the reference's `adamw_init`), the tokens, and the
    port's one-process steps by grad_accum."""

    def __init__(self, name):
        if name == "tiny":
            self.cfg = TINY
            model = Model(self.cfg)
            params, state = init_state(model, AdamWConfig(**OPT), torch.Generator().manual_seed(0), "cpu")
            self.params = jax.tree.map(lambda t: t.numpy(), params)
            self.state = jax.tree.map(lambda t: t.numpy(), state)
            self.reference = None
        else:
            jcfg = dataclasses.replace(j_get_reduced("mamba2-130m"), dtype="float32")
            jmodel, jopt = JModel(jcfg), JAdamWConfig(**OPT)
            self.cfg, jparams, jstate = fixed_draw(jcfg, jopt)
            self.params = jax.tree.map(np.asarray, jparams)
            self.state = jax.tree.map(np.asarray, jstate)
            self.reference = (jmodel, jopt, jparams, jstate)
        self.tokens = np.random.default_rng(SEED).integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.steps = {}

    def one_process(self, grad_accum, execution=None):
        """The port's one-process step (params, state, metrics as numpy);
        `execution` replaces the policy's."""
        key = (grad_accum, execution)
        if key not in self.steps:
            cfg = self.cfg if execution is None else dataclasses.replace(
                self.cfg, gemm_policy=dataclasses.replace(self.cfg.gemm_policy, execution=execution))
            step, _ = make_train_step(Model(cfg), AdamWConfig(**OPT), grad_accum=grad_accum, donate=False)
            p, o, met = step(params_from_numpy(self.params, "cpu"), params_from_numpy(self.state, "cpu"),
                             {"tokens": torch.from_numpy(self.tokens)})
            self.steps[key] = (jax.tree.map(lambda t: t.numpy(), p), jax.tree.map(lambda t: t.numpy(), o),
                               {k: np.asarray(v) for k, v in met.items()})
        return self.steps[key]


@pytest.fixture(scope="module")
def cases():
    done = {}

    def get(name):
        if name not in done:
            done[name] = _Case(name)
        return done[name]

    return get


def _mesh_cfg(case, execution):
    if execution == "sharded":
        return dataclasses.replace(case.cfg, gemm_policy=dataclasses.replace(case.cfg.gemm_policy,
                                                                             execution="sharded"))
    return case.cfg


@pytest.mark.parametrize("shape,execution", MESHES, ids=["x".join(map(str, s)) + "-" + e for s, e in MESHES])
@pytest.mark.parametrize("name", ["tiny", "mamba2-130m"])
def test_mesh_step_bitwise_one_process(pool, cases, name, shape, execution):
    """Every rank's gathered new params, optimizer state and loss bitwise
    the one-process step with grad_accum = D (on `kernel` where the mesh
    runs `sharded`); the reference mesh step's metric keys."""
    case = cases(name)
    if execution == "sharded" and case.cfg.gemm_policy.backend == "native":
        execution = "kernel"  # no emulated linear to shard: the mesh's other dims only
    want_p, want_o, want_m = case.one_process(shape[0], "kernel" if execution == "sharded" else None)
    out = _on_mesh(pool.run(torch_ranks.mesh_step, shape, _mesh_cfg(case, execution), case.params, case.state,
                            case.tokens), int(np.prod(shape)))
    for p, o, [met] in out:
        assert sorted(met) == ["aux", "ce", "grad_norm", "loss", "lr"]
        _bitwise(met["loss"], want_m["loss"])
        _bitwise(met["grad_norm"], want_m["grad_norm"])
        for a, b in zip(jax.tree.leaves((p, o)), jax.tree.leaves((want_p, want_o))):
            _bitwise(a, b)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_one_process_step_matches_reference(cases, grad_accum):
    """The one-process step the meshes are held to, against the reference's
    jitted single-device step from the same weights and state: loss,
    grad_norm and the first moments by the training tolerances."""
    case = cases("mamba2-130m")
    jmodel, jopt, jparams, jstate = case.reference
    step, _ = j_make_train_step(jmodel, jopt, grad_accum=grad_accum, donate=False)
    _, want_state, want = step(jparams, jstate, {"tokens": jnp.asarray(case.tokens)})
    _, got_state, got = case.one_process(grad_accum)
    assert sorted(got) == sorted(want)
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_RTOL * abs(float(want["loss"]))
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= NORM_RTOL * float(want["grad_norm"])
    _hold_moments(params_from_numpy(got_state, "cpu"), jax.tree.map(np.asarray, want_state),
                  f"mamba2-130m grad_accum={grad_accum}")


def test_mesh_grad_accum_within_tolerance(pool, cases):
    """grad_accum=2 on (2, 1): each rank sums its two microbatches, then the
    two ranks' means are summed and halved, so not the bits of one process
    with grad_accum=4, but within the reference's grad-accumulation
    tolerances of it; the metrics those of a grad_accum step."""
    case = cases("tiny")
    want_p, _, want_m = case.one_process(4)
    out = _on_mesh(pool.run(torch_ranks.mesh_step, (2, 1, 1), case.cfg, case.params, case.state, case.tokens, 2), 2)
    for p, _, [met] in out:
        assert sorted(met) == ["grad_norm", "loss", "lr"]
        np.testing.assert_allclose(met["loss"], want_m["loss"], rtol=1e-5)
        for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(want_p)):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2)])
def test_init_state_places_one_process_init(pool, shape):
    """`init_state` with the step's shardings: each rank's local blocks are
    bitwise the one-process init's blocks under the reference's param and
    ZeRO-1 optimizer specs (the step counter whole)."""
    model = Model(TINY)
    params, state = init_state(model, AdamWConfig(), torch.Generator().manual_seed(0), "cpu")
    jm = JAbstractMesh(shape, NAMES)
    jabstract = JModel(repro.models.ModelConfig(**{**dataclasses.asdict(TINY), "gemm_policy": None})).abstract_params()
    pspecs = _leaves(j_map_like(jabstract, lambda _, m: tuple(j_pspec_for_meta(m, J_RULES, jm))))
    ospecs = _leaves(j_map_like(jabstract, lambda _, m: tuple(
        j_optimizer_spec(j_pspec_for_meta(m, J_RULES, jm), m.shape, jm))))
    whole = {"params": params, "opt": state}
    specs = {"params": pspecs, "opt": {"m": ospecs, "master": ospecs, "step": [()], "v": ospecs}}
    flat_specs = [s for k in sorted(specs["opt"]) for s in specs["opt"][k]] + specs["params"]  # leaf order
    for local, got_specs, coord in _on_mesh(pool.run(torch_ranks.mesh_init, shape, TINY), int(np.prod(shape))):
        assert [tuple(s) for s in got_specs] == flat_specs
        for b, a, spec in zip(tree_leaves(local), tree_leaves(whole), flat_specs):
            _bitwise(b, _block(a.numpy(), spec, shape, NAMES, coord))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


RESUME = dict(warmup=2, ckpt_every=4, log_every=1000)


def test_resume_on_another_mesh(pool, tmp_path):
    """`train_loop` on (2, 1) for 4 steps (rank 0 saves step_4 from the
    gathered state), then resumed on (1, 2) to 6: the first run's losses
    bitwise one process with grad_accum=2; the resumed losses and final
    params bitwise one process resumed with grad_accum=1 from a copy of
    the same checkpoint."""
    data = dict(vocab=TINY.vocab, seq_len=S, global_batch=4, seed=1)
    mesh_dir, one_dir = tmp_path / "mesh", tmp_path / "one"
    first = _on_mesh(pool.run(torch_ranks.mesh_train_loop, (2, 1, 1), TINY, data,
                              dict(steps=4, ckpt_dir=str(mesh_dir), async_ckpt=False, **RESUME)), 2)
    _, want, _ = _one_loop(data, dict(steps=4, grad_accum=2, **RESUME))
    assert all(hist == want for hist, _, _ in first)
    assert sorted(p.name for p in mesh_dir.iterdir()) == ["step_4"]
    shutil.copytree(mesh_dir, one_dir)
    resumed = _on_mesh(pool.run(torch_ranks.mesh_train_loop, (1, 2, 1), TINY, data,
                                dict(steps=6, ckpt_dir=str(mesh_dir), **RESUME)), 2)
    want_p, want, logs = _one_loop(data, dict(steps=6, ckpt_dir=str(one_dir), **RESUME))
    assert logs[0] == f"[resume] restored step 4 from {one_dir}"
    for hist, params, rank_logs in resumed:
        assert hist == want and len(hist) == 2
        assert rank_logs[0] == f"[resume] restored step 4 from {mesh_dir}"
        for a, b in zip(jax.tree.leaves(params), tree_leaves(want_p)):
            _bitwise(a, b)


def _one_loop(data, loop):
    logs = []
    params, hist = train_loop(Model(TINY), DataConfig(**data), TrainLoopConfig(**loop), AdamWConfig(),
                              log=logs.append, device="cpu")
    return params, hist, logs


CLI = ["--arch", "mamba2-130m", "--backend", "ozaki2_f32", "--execution", "kernel", "--steps", "3", "--batch", "4",
       "--seq", "16", "--device", "cpu"]


def test_train_cli_mesh_like_grad_accum(pool):
    """`launch/train.py --mesh 2x2` on the pool's 4 ranks: every rank's
    losses bitwise the one-process CLI's with --grad-accum 2; rank 0 alone
    prints."""
    rc, _, want = torch_ranks.train_cli(CLI + ["--grad-accum", "2"])
    assert rc == 0 and len(want) == 3
    for rank, (rc, out, hist) in enumerate(pool.run(torch_ranks.train_cli, CLI + ["--mesh", "2x2"])):
        assert rc == 0
        assert hist == want
        assert ("[mamba2-130m] loss" in out) == (rank == 0)
