"""Every arch's train step against the reference's, on the CPU, from one
weight draw that every process shares; and each block's backward against
`jax.vjp` of the reference's block.

The draw (`test_torch_train.fixed_draw`): the port's float32 init of the
arch's reduced config (per-leaf seeds from `zlib.crc32` of the path,
generator seed 0), handed to the reference as jax arrays, and the
reference's `adamw_init` of them, which the port takes by
`interop.params_from_numpy`.  The batch: B = 2 tokens from
`np.random.default_rng(SEED)`, S = 32 (48 for recurrentgemma-2b, past its
window), the frontend archs' prefix embeds drawn after the tokens as in
`tests/test_torch_models.py`.  Native linears (`GemmPolicy()`): the
emulated products' backward is bitwise (`tests/test_torch_autograd.py`).

Each arch runs one step of the reference's jitted `make_train_step(
grad_accum=1, donate=False)` and one of the port's (AdamW, lr 1e-3), and
holds the loss and `ce` within LOSS_RTOL relative, `aux` likewise (0 in
both packages but for the MoE archs), `grad_norm` within the arch's norm
bound, the step counter and `lr` equal, and every leaf of the first
moment (m = (1 - b1) clip g) within the arch's grad bound x max|m| of that
leaf.  The MoE archs also hold `tests/test_torch_models.py`'s routing
rule: no routed token within ROUTE_MARGIN of a tie (none at this draw and
batch).

The bounds.  The reference's own spread is its jitted step against the
same step under `jax.disable_jit()`, on the same draw and batch, in the
same process.  An arch's bound is `test_torch_train`'s GRAD_TOL 5e-4 (x
max|m|) and NORM_RTOL 1e-4, or 4x that spread where that is larger, and
no further.  The test does not run the eager step, which takes several
times the jitted one; ``PYTHONPATH=src python
tests/test_torch_train_archs.py`` measures it and prints this table,
with both packages' float32 step against the port's step widened to
float64 (every float32 computation of the model's modules in float64,
`_widened`) beside it.  Readings on this draw (first moment's worst
leaf / grad_norm, relative):

| arch | reference spread | port vs reference | bound | reference vs f64 | port vs f64 |
| --- | --- | --- | --- | --- | --- |
| mamba2-130m | 1.43e-5 / 7.79e-7 | 2.23e-5 / 8.65e-8 | 5e-4 / 1e-4 | 2.28e-5 / 3.36e-7 | 8.09e-6 / 2.49e-7 |
| internvl2-26b | 9.65e-5 / 1.22e-6 | 1.36e-4 / 5.03e-5 | 5e-4 / 1e-4 | 1.86e-4 / 8.47e-5 | 3.09e-4 / 3.44e-5 |
| qwen2.5-32b | 2.68e-4 / 7.03e-6 | 3.26e-4 / 3.18e-5 | 1.07e-3 / 1e-4 | 9.81e-5 / 3.55e-5 | 2.28e-4 / 3.78e-6 |
| nemotron-4-15b | 2.38e-5 / 5.10e-6 | 2.17e-5 / 6.46e-6 | 5e-4 / 1e-4 | 3.03e-5 / 1.78e-5 | 3.10e-5 / 1.13e-5 |
| starcoder2-3b | 3.30e-4 / 7.61e-5 | 6.59e-4 / 1.39e-4 | 1.31e-3 / 3.04e-4 | 1.15e-3 / 2.26e-4 | 1.81e-3 / 3.65e-4 |
| minitron-4b | 2.70e-5 / 1.78e-6 | 5.03e-5 / 1.62e-5 | 5e-4 / 1e-4 | 5.36e-5 / 3.04e-5 | 6.31e-5 / 4.66e-5 |
| recurrentgemma-2b | 1.79e-3 / 6.57e-4 | 3.50e-3 / 9.50e-4 | 7.16e-3 / 2.62e-3 | 7.81e-2 / 3.20e-2 | 7.49e-2 / 3.11e-2 |
| granite-moe-3b-a800m | 1.50e-4 / 5.00e-6 | 3.95e-4 / 9.09e-5 | 6.00e-4 / 1e-4 | 9.40e-4 / 1.29e-4 | 1.07e-3 / 3.81e-5 |
| deepseek-moe-16b | 2.00e-4 / 3.35e-5 | 1.30e-4 / 9.13e-6 | 8.01e-4 / 1.33e-4 | 7.73e-5 / 1.23e-5 | 9.95e-5 / 3.12e-6 |
| musicgen-medium | 1.08e-5 / 4.60e-7 | 1.68e-4 / 1.96e-5 | 5e-4 / 1e-4 | 9.72e-5 / 3.98e-6 | 2.03e-4 / 2.36e-5 |

Every arch reads inside its bound, and no fault was found: what the
port reads is float32 rounding that these random-init models amplify
(granite-moe-3b-a800m's grad_norm, 9.09e-5 against 1e-4, has the least
margin).  The spread understates how far two correct float32 steps may
lie apart: the jitted and the eager reference share XLA's `exp`, `tanh`,
`rsqrt` and `log`, whose last ulp torch's differ from on many float32
inputs, and Eigen's order of every product's sums.  Against the float64
step the port's worst leaf is within 2.4x of the reference's (closer in
two archs) and its grad_norm closer than the reference's in seven, so
neither package computes the step better.  The port's readings above the
spread are not a rule of its own: musicgen-medium's worst leaf is the
`embed` row of a token seen once, the backward's dh at one position, and
starcoder2-3b's, k's bias, has a true gradient of 0 (a softmax does not
see a shift of every key by q . b).  recurrentgemma-2b's float32 step is
7.8e-2 from float64 in both packages: at this init many of its RG-LRU
gates have 1 - a^2 near float32's rounding, where sqrt(max(1 - exp(2 log
a), 1e-12)) cancels and its derivative multiplies a last-ulp difference
of `exp` by thousands.  The block test below shows that this accounts for
the whole of its RG-LRU difference: with the reference's `exp` bits the
port's block reads the reference's own spread.

The blocks (`test_block_vjp_matches_reference`): layer 0's weights of an
arch's draw, an input of unit-normal entries and a unit-normal cotangent
from `np.random.default_rng(SEED)`, the port's autograd against
`jax.vjp` of the reference's jitted block: the output and every input's
cotangent within BLOCK_TOL x max of the reference's (its `x` and every
param leaf; `moe_apply` with a cotangent on `aux` too).  The readings
(port vs jit; jit vs eager, the reference's spread), from the script:

| block | port vs reference | reference spread |
| --- | --- | --- |
| attn-qkv-bias:qwen2.5-32b | 1.19e-5 | 1.14e-5 |
| attn:nemotron-4-15b | 6.26e-6 | 4.43e-6 |
| ssd:mamba2-130m | 1.01e-5 | 8.23e-6 |
| rglru:recurrentgemma-2b | 6.99e-5 | 3.94e-6 |
| rglru-reference-exp:recurrentgemma-2b | 3.94e-6 | 3.94e-6 |
| moe:granite-moe-3b-a800m | 1.16e-6 | 8.58e-8 |
| moe:deepseek-moe-16b | 1.94e-6 | 1.54e-7 |
| mlp-swiglu:qwen2.5-32b | 9.67e-8 | 9.67e-8 |
| mlp-geglu:recurrentgemma-2b | 1.24e-6 | 9.80e-7 |
| mlp-gelu:starcoder2-3b | 7.47e-7 | 5.76e-7 |
| mlp-sq_relu:nemotron-4-15b | 0 | 0 |
| norm-rmsnorm:qwen2.5-32b | 1.70e-7 | 1.51e-7 |
| norm-layernorm:musicgen-medium | 2.84e-7 | 1.06e-7 |
| ce-chunked:qwen2.5-32b | 1.51e-7 | 1.51e-7 |

The RG-LRU block reads 18x the reference's spread as it stands, and is
held at RGLRU_TOL, the arch bound's floor GRAD_TOL; with its gates' two
`exp` calls computed by XLA (`jnp.exp`, with JAX's rule g * exp(x): the
`rglru-reference-exp` case) it reads the reference's spread exactly.
Every other block is within BLOCK_TOL.  The port's derivative rules that
differ in form from JAX's agree to rounding: `torch.logaddexp`'s in
`blocks._softplus` against `jax.nn.softplus`'s custom JVP (`lam`, a leaf
of the RG-LRU cases), `torch.logsumexp`'s in the loss against
`jax.nn.logsumexp`'s (every arch's step), and autograd through the
router's softmax against `jax.nn.softmax`'s custom JVP (the MoE cases).
"""
import contextlib
import dataclasses
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SEED

import repro  # noqa: F401  (x64, as the reference runs)
from repro.configs import get_reduced as j_get_reduced
from repro.core.policy import GemmPolicy as JPolicy
from repro.models import Model as JModel
from repro.models import blocks as j_blocks
from repro.models import layers as j_layers
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.core.policy import GemmPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_transformer
from repro_torch.models.routing import RouteLog
from repro_torch.models.transformer import layer_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_leaves
from test_torch_train import GRAD_TOL, LOSS_RTOL, NORM_RTOL, _hold_moments, fixed_draw, one_thread  # noqa: F401

B = 2
SEQ = {"recurrentgemma-2b": 48}  # S by arch; 32 for the others
OPT = dict(lr=1e-3)
ROUTE_MARGIN = 1e-5  # relative gap to a routing tie (tests/test_torch_models.py)
# (first-moment bound x max|m|, grad_norm bound relative) by arch: GRAD_TOL
# and NORM_RTOL, or 4x the reference's jit-vs-eager spread on this draw
# where that is larger (the module's table)
BOUNDS = {
    "mamba2-130m": (GRAD_TOL, NORM_RTOL),
    "internvl2-26b": (GRAD_TOL, NORM_RTOL),
    "qwen2.5-32b": (1.07e-3, NORM_RTOL),
    "nemotron-4-15b": (GRAD_TOL, NORM_RTOL),
    "starcoder2-3b": (1.31e-3, 3.04e-4),
    "minitron-4b": (GRAD_TOL, NORM_RTOL),
    "recurrentgemma-2b": (7.16e-3, 2.62e-3),
    "granite-moe-3b-a800m": (6.00e-4, NORM_RTOL),
    "deepseek-moe-16b": (8.01e-4, 1.33e-4),
    "musicgen-medium": (GRAD_TOL, NORM_RTOL),
}
BLOCK_TOL = 2e-5  # x max|.| of each output and cotangent leaf
RGLRU_TOL = GRAD_TOL  # the RG-LRU block with torch's exp (the module's docstring)


def _s(arch):
    return SEQ.get(arch, 32)


def _jcfg(arch, **over):
    return dataclasses.replace(j_get_reduced(arch), dtype="float32", gemm_policy=JPolicy(), **over)


def _batch(cfg, arch):
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, _s(arch))).astype(np.int32)}
    if cfg.frontend:
        out["prefix_embeds"] = (rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(
            np.float32)
    return out


class _Step:
    """One arch: the fixed draw, the batch, the reference's jitted step and
    the port's step, as numpy (the port's MoE routing recorded)."""

    def __init__(self, arch):
        jcfg = _jcfg(arch)
        self.jmodel, self.jopt = JModel(jcfg), JAdamWConfig(**OPT)
        self.cfg, self.jparams, self.jstate = fixed_draw(jcfg, self.jopt)
        self.batch = _batch(self.cfg, arch)
        self.want = self.reference_step()
        with RouteLog() as log:
            params = params_from_numpy(jax.tree.map(np.asarray, self.jparams), "cpu")
            state = params_from_numpy(jax.tree.map(np.asarray, self.jstate), "cpu")
            step, _ = make_train_step(Model(self.cfg), AdamWConfig(**OPT), donate=False)
            _, new_state, met = step(params, state, {k: torch.from_numpy(v) for k, v in self.batch.items()})
        self.got = (new_state, {k: np.asarray(v) for k, v in met.items()})
        self.routes = log.routes

    def reference_step(self):
        """(new optimizer state, metrics) of the reference's step, jitted
        unless called under `jax.disable_jit()`."""
        step, _ = j_make_train_step(self.jmodel, self.jopt, grad_accum=1, donate=False)
        _, state, met = step(self.jparams, self.jstate, {k: jnp.asarray(v) for k, v in self.batch.items()})
        return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in met.items()}


def _rel(got, want):
    want = float(want)
    return abs(float(got) - want) / abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    run = _Step(arch)
    m_tol, norm_tol = BOUNDS[arch]
    got_state, got = run.got
    want_state, want = run.want
    assert sorted(got) == sorted(want) == ["aux", "ce", "grad_norm", "loss", "lr"]
    if run.cfg.mlp == "moe":
        gaps = torch.cat([r.rel_gap for r in run.routes])
        near = int((gaps < ROUTE_MARGIN).sum())
        print(f"{arch}: {near} of {gaps.numel()} routed tokens within {ROUTE_MARGIN} of a routing tie")
        assert near == 0
        assert _rel(got["aux"], want["aux"]) <= LOSS_RTOL
    else:
        assert not run.routes and float(got["aux"]) == float(want["aux"]) == 0.0
    assert _rel(got["loss"], want["loss"]) <= LOSS_RTOL
    assert _rel(got["ce"], want["ce"]) <= LOSS_RTOL
    norm = _rel(got["grad_norm"], want["grad_norm"])
    assert norm <= norm_tol, f"{arch}: grad_norm {norm:.3e} relative > {norm_tol}"
    assert float(got["lr"]) == float(want["lr"])
    assert int(got_state["step"]) == int(want_state["step"]) == 1
    worst = _hold_moments(got_state, want_state, arch, m_tol)
    print(f"{arch}: grads within {worst:.2e} x max|m| (bound {m_tol}), grad_norm {norm:.2e} (bound {norm_tol})")


# ------------------------------------------------------------------ blocks


def _layer(arch, want):
    """(reference config, port config, layer 0's params as numpy) of the
    first group of `arch` whose block kind or mlp kind is `want`."""
    jcfg = _jcfg(arch)
    cfg, jparams, _ = fixed_draw(jcfg, JAdamWConfig())
    for g, (bk, mk, _) in enumerate(cfg.layer_groups):
        if want in (bk, mk):
            lp = jax.tree.map(np.asarray, layer_params(jparams["groups"][g], 0))
            return jcfg, cfg, lp
    raise ValueError(f"{arch} has no {want} layer")


def _block(name):
    """(reference fn, port fn, inputs): both functions take the inputs' tree
    (numpy leaves as jax arrays / torch tensors) and return a tuple."""
    rng = np.random.default_rng(SEED)
    kind, _, arch = name.partition(":")
    if kind in ("attn", "attn-qkv-bias", "ssd", "rglru", "rglru-reference-exp"):
        block = kind.split("-")[0]
        jcfg, cfg, lp = _layer(arch, block)
        s = _s(arch)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
        inputs = {"p": lp["block"], "x": rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)}
        jfn, tfn = getattr(j_blocks, f"{block}_apply"), getattr(t_blocks, f"{block}_apply")
        return (lambda t: (jfn(jcfg, t["p"], t["x"], jnp.asarray(pos)),),
                lambda t: (tfn(cfg, t["p"], t["x"], torch.from_numpy(pos)),), inputs)
    if kind == "moe":
        jcfg, cfg, lp = _layer(arch, "moe")
        inputs = {"p": lp["mlp"], "x": rng.standard_normal((B, _s(arch), cfg.d_model)).astype(np.float32)}
        return (lambda t: j_blocks.moe_apply(jcfg, t["p"], t["x"]),
                lambda t: t_blocks.moe_apply(cfg, t["p"], t["x"]), inputs)
    if kind.startswith("mlp-"):
        mlp = kind.removeprefix("mlp-")
        jcfg, cfg, lp = _layer(arch, mlp)
        inputs = {"p": lp["mlp"], "x": rng.standard_normal((B, _s(arch), cfg.d_model)).astype(np.float32)}
        return (lambda t: (j_layers.apply_mlp(mlp, t["p"], t["x"], JPolicy()),),
                lambda t: (t_layers.apply_mlp(mlp, t["p"], t["x"], GemmPolicy()),), inputs)
    if kind.startswith("norm-"):
        norm = kind.removeprefix("norm-")
        jcfg, cfg, lp = _layer(arch, "attn")
        assert cfg.norm == norm
        inputs = {"p": lp["norm1"], "x": rng.standard_normal((B, _s(arch), cfg.d_model)).astype(np.float32)}
        return (lambda t: (j_layers.apply_norm(norm, t["p"], t["x"]),),
                lambda t: (t_layers.apply_norm(norm, t["p"], t["x"]),), inputs)
    if kind == "ce-chunked":
        jcfg = _jcfg(arch, loss_vocab_chunk=128)
        cfg, jparams, _ = fixed_draw(jcfg, JAdamWConfig())
        assert cfg.vocab > 128
        head = "embed" if cfg.tie_embeddings else "head"
        heads = {head: np.asarray(jparams[head])}
        tokens = rng.integers(0, cfg.vocab, (B, _s(arch))).astype(np.int32)
        targets = np.concatenate([tokens[:, 1:], np.zeros_like(tokens[:, :1])], axis=1)
        mask = np.ones((B, _s(arch)), np.float32)
        mask[:, -1] = 0.0
        inputs = {"p": heads, "x": rng.standard_normal((B, _s(arch), cfg.d_model)).astype(np.float32)}
        jm, tm = JModel(jcfg), Model(cfg)
        return (lambda t: (jm._chunked_ce(t["p"], t["x"], jnp.asarray(targets), jnp.asarray(mask)),),
                lambda t: (tm._chunked_ce(t["p"], t["x"], torch.from_numpy(targets), torch.from_numpy(mask)),),
                inputs)
    raise ValueError(name)


BLOCKS = [
    "attn-qkv-bias:qwen2.5-32b", "attn:nemotron-4-15b", "ssd:mamba2-130m", "rglru:recurrentgemma-2b",
    "rglru-reference-exp:recurrentgemma-2b", "moe:granite-moe-3b-a800m", "moe:deepseek-moe-16b",
    "mlp-swiglu:qwen2.5-32b", "mlp-geglu:recurrentgemma-2b", "mlp-gelu:starcoder2-3b", "mlp-sq_relu:nemotron-4-15b",
    "norm-rmsnorm:qwen2.5-32b", "norm-layernorm:musicgen-medium", "ce-chunked:qwen2.5-32b",
]


class _XlaExp(torch.autograd.Function):
    """exp by XLA's CPU kernel (`jnp.exp`), with JAX's rule g * exp(x)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.from_numpy(np.array(jnp.exp(jnp.asarray(x.detach().numpy()))))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


class _TorchWithXlaExp:
    """`torch` for `repro_torch.models.blocks`, but its `exp` by XLA."""

    exp = staticmethod(_XlaExp.apply)

    def __getattr__(self, name):
        return getattr(torch, name)


def _exp_of(name):
    """The `rglru-reference-exp` case's substitution of `blocks.torch`; no
    change for the others."""
    if name.startswith("rglru-reference-exp"):
        return mock.patch.object(t_blocks, "torch", _TorchWithXlaExp())
    return contextlib.nullcontext()


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs)


def _block_vjps(name, eager=False):
    """The reference's outputs and input cotangents (jitted, or op by op
    with `eager`) and the port's, as lists of numpy arrays: the outputs,
    then a cotangent for each leaf of the inputs."""
    jfn, tfn, inputs = _block(name)
    jin = jax.tree.map(jnp.asarray, inputs)
    fn = jfn if eager else jax.jit(jfn)
    with jax.disable_jit(eager):
        outs, vjp = jax.vjp(fn, jin)
        gs = _cotangents(outs, SEED + 1)
        (grads,) = vjp(tuple(jnp.asarray(g) for g in gs))
    want = [np.asarray(o) for o in outs] + [np.asarray(g) for g in jax.tree.leaves(grads)]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in jax.tree.leaves(inputs)]
    touts = tfn(jax.tree.unflatten(jax.tree.structure(inputs), leaves))
    tgrads = torch.autograd.grad(touts, leaves, [torch.from_numpy(g) for g in gs])
    got = [t.detach().numpy() for t in touts] + [g.numpy() for g in tgrads]
    return want, got


def _worst(got, want):
    """max over the arrays of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(np.abs(b).max()) or 1.0
        worst = max(worst, float(np.abs(np.asarray(a, np.float64) - b).max()) / scale)
    return worst


@pytest.mark.parametrize("name", BLOCKS)
def test_block_vjp_matches_reference(name):
    with _exp_of(name):
        want, got = _block_vjps(name)
    assert all(np.isfinite(g).all() for g in got)
    tol = RGLRU_TOL if name.startswith("rglru:") else BLOCK_TOL
    worst = _worst(got, want)
    print(f"{name}: {worst:.2e} x max (bound {tol})")
    assert worst <= tol, f"{name}: {worst:.3e} > {tol}"


# ------------------------------------------------------------------ the script


@contextlib.contextmanager
def _widened():
    """The port's model modules computing in float64 where they compute in
    float32 (their `_F32`), for the float64 step."""
    mods = (t_blocks, t_layers, t_transformer)
    for m in mods:
        m._F32 = torch.float64
    try:
        yield
    finally:
        for m in mods:
            m._F32 = torch.float32


def _m_of(state):
    return [np.asarray(a) for a in jax.tree.leaves(state["m"])]


def _f64_moments(run):
    """The first moment and grad_norm of the port's step widened to
    float64 (params, batch and computation), as the reference's AdamW
    forms them: m = (1 - b1) min(1, clip / norm) g."""
    cfg = dataclasses.replace(run.cfg, dtype="float64")
    params = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float64), run.jparams), "cpu")
    batch = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in run.batch.items()}
    with _widened():
        _, _, grads = loss_and_grads(Model(cfg), params, batch)
    g = [t.numpy() for t in tree_leaves(grads)]
    norm = float(np.sqrt(sum(float(np.sum(x * x)) for x in g)))
    opt = AdamWConfig(**OPT)
    return [(1 - opt.b1) * min(1.0, opt.grad_clip / norm) * x for x in g], norm


def main():
    torch.set_num_threads(1)
    print("| arch | reference spread | port vs reference | bound | reference vs f64 | port vs f64 |")
    for arch in ARCHS:
        run = _Step(arch)
        with jax.disable_jit():
            eager = run.reference_step()
        jit_m, port_m, eager_m = _m_of(run.want[0]), _m_of(run.got[0]), _m_of(eager[0])
        f64_m, f64_norm = _f64_moments(run)
        jn, pn, en = (float(x[1]["grad_norm"]) for x in (run.want, run.got, eager))
        spread = (_worst(eager_m, jit_m), abs(en - jn) / jn)
        bound = (max(GRAD_TOL, 4 * spread[0]), max(NORM_RTOL, 4 * spread[1]))
        cols = [spread, (_worst(port_m, jit_m), abs(pn - jn) / jn), bound,
                (_worst(jit_m, f64_m), abs(jn - f64_norm) / f64_norm),
                (_worst(port_m, f64_m), abs(pn - f64_norm) / f64_norm)]
        print(f"| {arch} | " + " | ".join(f"{a:.2e} / {b:.2e}" for a, b in cols) + " |", flush=True)
    print("| block | port vs reference | reference spread |")
    for name in BLOCKS:
        with _exp_of(name):
            want, got = _block_vjps(name)
            eager, _ = _block_vjps(name, eager=True)
        print(f"| {name} | {_worst(got, want):.2e} | {_worst(eager, want):.2e} |", flush=True)


if __name__ == "__main__":
    sys.exit(main())
