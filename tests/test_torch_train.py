"""Parity of the port's training (`repro_torch.train`) with `repro.train`,
on the CPU, at reduced sizes.

The reference's train step is jitted for two configs only, each in one
module's fixture: here reduced starcoder2-3b cut to 1 layer with native
linears (grad_accum 1 and 4), and in `test_torch_train_kernel.py`
reduced mamba2-130m with every linear on
`GemmPolicy(backend="ozaki2_f32", execution="kernel")` (the reference's
kernels in interpret mode, the port's plain versions), both float32,
B = 8, S = 32 from the suite's seed.  Tracing and compiling the
interpreted kernels takes most of that file's time, so it runs on its
own xdist worker (``--dist loadfile``).  Both packages start from one
fixed weight draw, `fixed_draw`: the port's init (per-leaf seeds from
`zlib.crc32` of the path, generator seed 0) handed to the reference as
jax arrays, and the reference's `adamw_init` of them, which the port
takes by `interop.params_from_numpy` (the reference's own init seeds each
leaf by Python's salted `hash`, so it draws other weights in every
process).  Every arch's step is held the same way in
`tests/test_torch_train_archs.py`.

Tolerances, and why:
* the loss within 1e-5 relative (as `tests/test_torch_models.py`): the
  native float32 layers round differently in XLA and torch;
* `grad_norm` within 1e-4 relative, and the grads, read as the first
  moment after one step (m = (1 - b1) clip g), within GRAD_TOL x max|m|
  of each leaf: the same roundings moved through the backward (the
  emulated products themselves are bitwise, `tests/test_torch_models.py`
  and `tests/test_torch_autograd.py`);
* the update itself bitwise, given the same grads and norm
  (`test_adamw_on_reference_grads_bitwise`; the op-by-op reference);
* post-step params are never compared across packages elementwise:
  Adam's first step turns a grad that rounding moves across 0 into
  +-lr.  grad_accum=4 is held to the port's grad_accum=1 by the
  reference's own test's rtol 1e-3 / atol 1e-5 on the params;
* the complex policy trains as the reference's
  `test_model_with_complex_policy_trains` (loss within 1e-3 of native);
* resume: the port resuming the reference's checkpoint takes the same 2
  losses as the reference resuming it, within 1e-5 relative; the port
  resuming its own checkpoint is bitwise the uninterrupted run.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SEED

import repro  # noqa: F401  (x64, as the reference runs)
from repro.configs import get_reduced as j_get_reduced
from repro.core.policy import GemmPolicy as JPolicy
from repro.data import DataConfig as JDataConfig
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.adamw import global_norm as j_global_norm
from repro.train import TrainLoopConfig as JTrainLoopConfig
from repro.train import train_loop as j_train_loop
from repro.train.step import make_train_step as j_make_train_step
import repro_torch.optim.adamw as tadamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.core.policy import GemmPolicy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop
from repro_torch.train.step import init_state, loss_and_grads

B, S = 8, 32
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
GRAD_TOL = 5e-4  # x max|m| of each leaf
OPT = dict(lr=1e-3)
CONFIGS = {
    "starcoder2-3b-native": ("starcoder2-3b", dict(n_layers=1), JPolicy()),
    "mamba2-130m-kernel": ("mamba2-130m", {}, JPolicy(backend="ozaki2_f32", execution="kernel", interpret=True)),
}


def fixed_draw(jcfg, jopt):
    """The weights every train parity test starts from: the port's
    float32 init of `jcfg` (per-leaf seeds from `zlib.crc32` of the path,
    generator seed 0: the same arrays in every process) as the reference's
    jax arrays, and the reference's `adamw_init` of them.  Returns (the
    port's config, params, optimizer state)."""
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return cfg, jparams, j_adamw_init(jparams, jopt)


class _Reference:
    """One config's run: the fixed draw, the reference's jitted step on one
    batch (grad_accum 1, and 4 where asked) and the port's model."""

    def __init__(self, name, accums):
        arch, over, pol = CONFIGS[name]
        jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32", gemm_policy=pol, **over)
        jmodel = JModel(jcfg)
        jopt = JAdamWConfig(**OPT)
        cfg, jparams, jstate = fixed_draw(jcfg, jopt)
        self.tokens = np.random.default_rng(SEED).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        self.params_np = jax.tree.map(np.asarray, jparams)
        self.state_np = jax.tree.map(np.asarray, jstate)
        self.out = {}
        for ga in accums:
            step, _ = j_make_train_step(jmodel, jopt, grad_accum=ga, donate=False)
            p, o, met = step(jparams, jstate, {"tokens": jnp.asarray(self.tokens)})
            self.out[ga] = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o),
                            {k: np.asarray(v) for k, v in met.items()})
        self.model = Model(cfg)

    def port_state(self):
        return params_from_numpy(self.params_np, "cpu"), params_from_numpy(self.state_np, "cpu")

    def batch(self):
        return {"tokens": torch.from_numpy(self.tokens)}


@pytest.fixture(scope="module")
def reference():
    done = {}

    def get(name):
        if name not in done:
            done[name] = _Reference(name, (1, 4) if name.endswith("native") else (1,))
        return done[name]

    return get


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side of each test on one intra-op thread: these models
    are small, and under the suite's xdist workers torch's default of a
    thread a core makes each small op wait at its parallel region's
    barrier for threads the other workers keep busy (test_training_converges
    took 464 s so, against 5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def deterministic():
    """`torch.use_deterministic_algorithms(True)` for a test that compares
    two of the port's runs bit for bit: the embedding's backward
    (`index_put_` with accumulation) sums in a thread-dependent order
    otherwise, on the CPU as on the card."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _hold_moments(got_state, want_state, what, tol=GRAD_TOL):
    """Each leaf of the first moment (the scaled grads) within `tol` x its
    max|m|; returns the worst ratio."""
    worst = 0.0
    for a, b in zip(jax.tree.leaves(want_state["m"]), tree_leaves(got_state["m"])):
        scale = float(np.abs(a).max())
        err = float(np.abs(b.numpy().astype(np.float64) - a).max())
        assert np.isfinite(b.numpy()).all(), what
        assert err <= tol * scale, f"{what}: m leaf {a.shape}: {err:.3e} > {tol} x {scale:.3e}"
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def hold_train_step(r, name):
    """The port's step from the reference's weights and state against the
    reference's jitted step (grad_accum 1), by the module's tolerances."""
    params, state = r.port_state()
    step, shardings = make_train_step(r.model, AdamWConfig(**OPT), donate=False)
    assert shardings is None
    _, new_state, met = step(params, state, r.batch())
    _, want_state, want = r.out[1]
    assert sorted(met) == sorted(want) == ["aux", "ce", "grad_norm", "loss", "lr"]
    assert abs(float(met["loss"]) - float(want["loss"])) <= LOSS_RTOL * abs(float(want["loss"]))
    assert abs(float(met["ce"]) - float(want["ce"])) <= LOSS_RTOL * abs(float(want["ce"]))
    assert abs(float(met["grad_norm"]) - float(want["grad_norm"])) <= NORM_RTOL * float(want["grad_norm"])
    assert float(met["lr"]) == float(want["lr"])
    assert int(new_state["step"]) == int(want_state["step"]) == 1
    worst = _hold_moments(new_state, want_state, name)
    print(f"{name}: loss {float(met['loss'])!r} vs {float(want['loss'])!r}; grads within {worst:.2e} x max")


@pytest.mark.parametrize("name", ["starcoder2-3b-native"])
def test_train_step_matches_reference(reference, name):
    hold_train_step(reference(name), name)


def test_adamw_on_reference_grads_bitwise(reference, monkeypatch):
    """The reference's grads of the native step (from its first moment,
    g = m / (1 - b1) / clip, float32) and its norm into both updates, op
    by op: every new param and state leaf bitwise."""
    r = reference("starcoder2-3b-native")
    _, want_state, want = r.out[1]
    cfg, jcfg = AdamWConfig(**OPT), JAdamWConfig(**OPT)
    clip = np.float32(min(1.0, cfg.grad_clip / float(want["grad_norm"])))
    grads_np = jax.tree.map(lambda m: (m / np.float32(1 - cfg.b1) / clip).astype(np.float32), want_state["m"])
    jparams, jstate = jax.tree.map(jnp.asarray, r.params_np), jax.tree.map(jnp.asarray, r.state_np)
    with jax.disable_jit():
        jgrads = jax.tree.map(jnp.asarray, grads_np)
        jnorm = np.asarray(j_global_norm(jgrads))
        jp, js, jmet = j_adamw_update(jparams, jgrads, jstate, jcfg, 1.0)
    monkeypatch.setattr(tadamw, "global_norm", lambda tree: torch.from_numpy(np.array(jnorm, np.float32)))
    params, state = r.port_state()
    p, s, met = adamw_update(params, params_from_numpy(grads_np, "cpu"), state, cfg, 1.0)
    for a, b in zip(jax.tree.leaves((jp, js)), tree_leaves((p, s))):
        np.testing.assert_array_equal(b.numpy().view(np.int32) if b.dtype == torch.float32 else b.numpy(),
                                      np.asarray(a).view(np.int32) if a.dtype == np.float32 else np.asarray(a))
    assert float(met["grad_norm"]) == float(jmet["grad_norm"])


def test_grad_accum_matches_reference_and_full_batch(reference):
    """grad_accum=4 against the reference's grad_accum=4 (the step's
    tolerances) and against the port's own grad_accum=1 (the reference's
    `test_grad_accum_matches_full_batch`: loss rtol 1e-5, params rtol 1e-3
    / atol 1e-5)."""
    r = reference("starcoder2-3b-native")
    opt = AdamWConfig(**OPT)
    p4, s4, m4 = make_train_step(r.model, opt, grad_accum=4, donate=False)[0](*r.port_state(), r.batch())
    p1, _, m1 = make_train_step(r.model, opt, donate=False)[0](*r.port_state(), r.batch())
    _, want_state, want = r.out[4]
    assert sorted(m4) == sorted(want) == ["grad_norm", "loss", "lr"]
    assert abs(float(m4["loss"]) - float(want["loss"])) <= LOSS_RTOL * abs(float(want["loss"]))
    assert abs(float(m4["grad_norm"]) - float(want["grad_norm"])) <= NORM_RTOL * float(want["grad_norm"])
    _hold_moments(s4, want_state, "grad_accum=4")
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3, atol=1e-5)


def test_complex_policy_trains(rng):
    """The reference's `test_model_with_complex_policy_trains` on the port:
    reduced starcoder2-3b (1 layer, float32) with every linear on
    `ozaki2_c64` (N = 6): its loss within a relative 1e-3 of the native
    one, finite grads, and a train step with finite results."""
    cfg = get_reduced("starcoder2-3b", dtype="float32", n_layers=1,
                      gemm_policy=GemmPolicy(backend="ozaki2_c64", n_moduli=6))
    m_em, m_nat = Model(cfg), Model(dataclasses.replace(cfg, gemm_policy=GemmPolicy()))
    params, state = init_state(m_em, AdamWConfig(), torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    l_em, _, grads = loss_and_grads(m_em, params, batch)
    with torch.no_grad():
        l_nat, _ = m_nat.loss(params, batch)
    np.testing.assert_allclose(float(l_em), float(l_nat), rtol=1e-3)
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    params, state, met = make_train_step(m_em, AdamWConfig())[0](params, state, batch)
    assert np.isfinite(float(met["loss"])) and int(state["step"]) == 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))


def test_training_converges():
    """Reduced qwen2.5-32b trained by the port alone (the reference's
    `test_training_converges`: the same data, optimizer and warm-up, 100
    steps of its 120, the fewest that keep a margin: 80 give a drop of
    0.325, 100 of 0.376): the mean loss of the last 10 steps at least 0.3
    below that of the first 10."""
    cfg = get_reduced("qwen2.5-32b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    lcfg = TrainLoopConfig(steps=100, warmup=10, log_every=1000, ckpt_every=10**6)
    _, hist = train_loop(Model(cfg), dcfg, lcfg, AdamWConfig(lr=3e-3, grad_clip=5.0), log=lambda *_: None,
                         device="cpu")
    first, last = np.mean(hist[:10]), np.mean(hist[-10:])
    assert last < first - 0.3, (first, last)


RESUME_LOOP = dict(warmup=5, ckpt_every=4, log_every=1000)  # steps 0-3 in the warm-up at 4 and 6 steps


def test_cross_package_resume(tmp_path, deterministic):
    """The reference's `train_loop` (reduced mamba2-130m, float32) writes
    step_4; the port resumes it on the CPU for 2 steps, as the reference
    does from the same files (losses within 1e-5 relative).  The port
    resuming its own step_4 is bitwise the uninterrupted port run.  The
    reference's loop starts from the fixed draw, which the port writes as
    a step_0 checkpoint for it to resume (its own init draws other weights
    in every process)."""
    jcfg = dataclasses.replace(j_get_reduced("mamba2-130m"), dtype="float32")
    jmodel = JModel(jcfg)
    cfg, jparams, jstate = fixed_draw(jcfg, JAdamWConfig())
    model = Model(cfg)
    jdata = JDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=1)
    data = DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=1)
    quiet = dict(log=lambda *_: None)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    Checkpointer(str(ref_dir)).save(0, params_from_numpy(jax.tree.map(np.asarray, {"params": jparams, "opt": jstate}),
                                                         "cpu"))
    j_train_loop(jmodel, jdata, JTrainLoopConfig(steps=4, ckpt_dir=str(ref_dir), async_ckpt=False, **RESUME_LOOP),
                 JAdamWConfig(), **quiet)
    shutil.copytree(ref_dir, port_dir)
    _, want = j_train_loop(jmodel, jdata, JTrainLoopConfig(steps=6, ckpt_dir=str(ref_dir), **RESUME_LOOP),
                           JAdamWConfig(), **quiet)
    logs = []
    _, got = train_loop(model, data, TrainLoopConfig(steps=6, ckpt_dir=str(port_dir), **RESUME_LOOP),
                        AdamWConfig(), log=logs.append, device="cpu")
    assert logs[0] == f"[resume] restored step 4 from {port_dir}"
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    own = tmp_path / "own"
    train_loop(model, data, TrainLoopConfig(steps=4, ckpt_dir=str(own), async_ckpt=False, **RESUME_LOOP),
               AdamWConfig(), device="cpu", **quiet)
    p_resumed, resumed = train_loop(model, data, TrainLoopConfig(steps=6, ckpt_dir=str(own), **RESUME_LOOP),
                                    AdamWConfig(), device="cpu", **quiet)
    p_whole, whole = train_loop(model, data, TrainLoopConfig(steps=6, **RESUME_LOOP), AdamWConfig(),
                                device="cpu", **quiet)
    assert resumed == whole[4:]
    for a, b in zip(tree_leaves(p_resumed), tree_leaves(p_whole)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_train_loop_preemption_saves_and_resumes(tmp_path, deterministic):
    """A SIGTERM during step 2 (sent from the batch hook): the loop finishes
    the step, logs the reference's ``[preempt]`` line, saves step_3 and
    stops; the next run resumes there and ends bitwise where an
    uninterrupted run ends."""
    import os
    import signal

    cfg = get_reduced("mamba2-130m", dtype="float32")
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3)
    lcfg = TrainLoopConfig(steps=5, warmup=2, ckpt_every=100, log_every=1000, ckpt_dir=str(tmp_path))

    def hook(batch, seen=[]):
        seen.append(1)
        if len(seen) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch

    logs = []
    _, first = train_loop(Model(cfg), data, lcfg, batch_hook=hook, log=logs.append, device="cpu")
    assert len(first) == 3 and logs[-1] == "[preempt] stopping cleanly at step 2"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3"]
    p_resumed, rest = train_loop(Model(cfg), data, lcfg, log=logs.append, device="cpu")
    p_whole, whole = train_loop(Model(cfg), data, dataclasses.replace(lcfg, ckpt_dir=None), log=lambda *_: None,
                                device="cpu")
    assert first + rest == whole
    for a, b in zip(tree_leaves(p_resumed), tree_leaves(p_whole)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logistic_and_silu_grads(rng, dtype):
    """`layers.logistic` and `layers.silu` against `jax.nn.sigmoid` and
    `jax.nn.silu` under `jax.vjp` (op by op), out to inputs where exp(-x)
    overflows (the quotient rule's 0 * inf was NaN there: ROADMAP queue 3,
    fault 4): cotangents finite, and values and cotangents within 2 ulp of
    the dtype (relative; torch's and XLA's `exp` differ in the last ulp)."""
    from repro_torch.models.layers import logistic, silu

    x = np.concatenate([[-200.0, -100.0, -89.0, -20.0, -0.0, 0.0, 20.0, 89.0, 100.0, 200.0],
                        rng.standard_normal(54) * 8]).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ulp = {"float32": 2.0**-23, "bfloat16": 2.0**-7}[dtype]
    for jfn, fn in ((jax.nn.sigmoid, logistic), (jax.nn.silu, silu)):
        with jax.disable_jit():
            want, vjp = jax.vjp(jfn, jnp.asarray(x).astype(dtype))
            (want_dx,) = vjp(jnp.asarray(g).astype(dtype))
        tx = params_from_numpy(np.asarray(jnp.asarray(x).astype(dtype)), "cpu").requires_grad_(True)
        got = fn(tx)
        (got_dx,) = torch.autograd.grad(got, tx, params_from_numpy(np.asarray(jnp.asarray(g).astype(dtype)), "cpu"))
        for a, b in ((got, want), (got_dx, want_dx)):
            a = a.detach().double().numpy()
            b = np.asarray(jnp.asarray(b).astype(jnp.float64))
            assert np.isfinite(a).all() and np.isfinite(b).all()
            np.testing.assert_allclose(a, b, rtol=2 * ulp, atol=0)


def test_ssd_grads_finite_where_silu_saturates():
    """Fault 4's case (ROADMAP queue 3): reduced mamba2-130m, float32, the
    port's init from generator seed 4 and `SyntheticLM`'s first batch.  A
    conv channel's SiLU input there is so negative that exp(-x) overflows;
    the port's grads were NaN, the reference's finite.  Now finite, and
    within GRAD_TOL x max|g| of the reference's jitted grads, the loss
    within LOSS_RTOL."""
    cfg = get_reduced("mamba2-130m", dtype="float32")
    jmodel = JModel(dataclasses.replace(j_get_reduced("mamba2-130m"), dtype="float32"))
    model = Model(cfg)
    tokens = SyntheticLM(DataConfig(cfg.vocab, 32, 2)).batch(0)["tokens"]
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    loss, _, grads = loss_and_grads(model, params, {"tokens": torch.from_numpy(tokens)})
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jmodel.loss(q, {"tokens": jnp.asarray(tokens)})[0]))(jparams)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for a, b in zip(jax.tree.leaves(jgrads), tree_leaves(grads)):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all() and np.isfinite(a).all()
        assert np.abs(b.astype(np.float64) - a).max() <= GRAD_TOL * np.abs(a).max()
