"""Parity of the port's attention-family models (`repro_torch.models`) with
`repro.models`, at the reduced configs, on the CPU.

The reference initialises each arch's weights once per file
(`Model(cfg).init(jax.random.PRNGKey(0))`, float32); they are carried across with `interop.params_from_numpy` and
never re-initialised.  Both packages see the same numpy batch (B = 2,
S = 32, from the suite's seed).  The native layers run in float32 in both
packages, but XLA and torch round `rsqrt`, `exp`, `tanh`, the einsum sums
and the means differently in the last ulps, so logits are held within
1e-4 x max|logits| (a stated tolerance, not bit for bit) and losses within
a relative 1e-5.  The emulated products themselves are bitwise, and
bfloat16 is held in `tests/test_torch_model_layers.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SEED

import repro  # noqa: F401  (x64, as the reference runs)
from repro.configs import get_reduced as j_get_reduced
from repro.models import Model as JModel
from repro_torch.configs import ATTENTION_ARCHS
from repro_torch.core.policy import GemmPolicy
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.models import Model

B, S = 2, 32
DECODE = 3  # decode steps after a prefill of S - DECODE tokens
LOGIT_TOL = 1e-4  # x max|logits|, float32
LOSS_RTOL = 1e-5


def _np_batch(cfg, rng, s=S):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.frontend:
        out["prefix_embeds"] = (rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(
            np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _npre(cfg):
    return cfg.n_prefix_embeds if cfg.frontend else 0


def _reference_serve(model, params, batch):
    """Prefill S - DECODE tokens, then decode the batch's next DECODE tokens
    one at a time: the logits of each call, (B, 1 + DECODE, vocab)."""
    cfg = model.cfg
    npre = _npre(cfg)
    sp = S - DECODE
    cache = model.init_cache(B, S + npre)
    lp, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :sp]), cache)
    out = [lp[:, -1]]
    for i in range(DECODE):
        ld, cache = model.decode_step(params, batch["tokens"][:, sp + i: sp + i + 1], cache,
                                      jnp.int32(npre + sp + i))
        out.append(ld[:, 0])
    return out


def _port_serve(model, params, batch):
    cfg = model.cfg
    npre = _npre(cfg)
    sp = S - DECODE
    cache = model.init_cache(B, S + npre, device="cpu")
    lp, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :sp]), cache)
    out = [lp[:, -1]]
    for i in range(DECODE):
        ld, cache = model.decode_step(params, batch["tokens"][:, sp + i: sp + i + 1], cache, npre + sp + i)
        out.append(ld[:, 0])
    return out


class _Runs:
    """Each arch's reference and port results (float32), computed once."""

    def __init__(self):
        self._done = {}

    def __call__(self, arch):
        key = arch
        if key not in self._done:
            rng = np.random.default_rng(SEED)
            jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
            jmodel = JModel(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            batch = _np_batch(jcfg, rng)
            cfg = model_config_from_fields(dataclasses.asdict(jcfg))
            model = Model(cfg)
            params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
            r = {"cfg": cfg, "model": model, "params": params, "batch": batch}
            with torch.no_grad():
                r["want_logits"] = np.asarray(jmodel.forward(jparams, _j(batch))[0], np.float32)
                r["got_logits"] = model.forward(params, _t(batch))[0].float().numpy()
                r["want_serve"] = [np.asarray(x, np.float32) for x in _reference_serve(jmodel, jparams, _j(batch))]
                r["got_serve"] = [x.float().numpy() for x in _port_serve(model, params, _t(batch))]
                for chunk in (None, 128):
                    jm = JModel(dataclasses.replace(jcfg, loss_vocab_chunk=chunk))
                    tm = Model(dataclasses.replace(cfg, loss_vocab_chunk=chunk))
                    r[("want_loss", chunk)] = float(jm.loss(jparams, _j(batch))[0])
                    r[("got_loss", chunk)] = float(tm.loss(params, _t(batch))[0])
            self._done[key] = r
        return self._done[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _assert_close_logits(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x max|logits| {scale:.3e}"


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_forward_logits_match(runs, arch):
    r = runs(arch)
    npre = _npre(r["cfg"])
    assert r["got_logits"].shape == (B, S + npre, r["cfg"].vocab)
    _assert_close_logits(r["got_logits"], r["want_logits"], LOGIT_TOL, f"{arch} forward")


@pytest.mark.parametrize("chunk", [None, 128], ids=["dense", "chunk128"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_loss_matches(runs, arch, chunk):
    r = runs(arch)
    got, want = r[("got_loss", chunk)], r[("want_loss", chunk)]
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_prefill_decode_match(runs, arch):
    r = runs(arch)
    for i, (got, want) in enumerate(zip(r["got_serve"], r["want_serve"])):
        assert got.shape == (B, r["cfg"].vocab)
        _assert_close_logits(got, want, LOGIT_TOL, f"{arch} {'prefill' if i == 0 else f'decode {i}'}")


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_decode_matches_forward(runs, arch):
    """The port's own incremental path against its full forward (the
    reference's `test_decode_matches_forward_f32`, same tolerance)."""
    r = runs(arch)
    npre = _npre(r["cfg"])
    sp = S - DECODE
    full = r["got_logits"]
    for i, got in enumerate(r["got_serve"]):
        np.testing.assert_allclose(got, full[:, npre + sp - 1 + i], rtol=2e-3, atol=2e-3)


def test_emulated_backend_model(runs):
    """starcoder2-3b (reduced, float32) with every linear on the emulated
    GEMM (the default reference execution, N = 8): its loss within a
    relative 1e-3 of the native one, and finite, nonzero gradients through
    the emulated backward (the reference's `test_emulated_backend_model`)."""
    r = runs("starcoder2-3b")
    cfg = dataclasses.replace(r["cfg"], gemm_policy=GemmPolicy(backend="ozaki2_f32", n_moduli=8))
    model = Model(cfg)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), r["params"])
    batch = _t(r["batch"])
    loss, _ = model.loss(params, batch)
    np.testing.assert_allclose(loss.item(), r[("got_loss", None)], rtol=1e-3)
    loss.backward()
    grads = [t.grad for t in jax.tree.leaves(params)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
