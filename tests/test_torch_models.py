"""Parity of the port's models (`repro_torch.models`) with `repro.models`,
every arch at its reduced config, on the CPU.

Each arch's weights are drawn once per file by the port
(`Model(cfg).init(torch.Generator().manual_seed(0))`, float32) and carried
to the reference as numpy arrays.  Both packages see the same numpy batch
(B = 2, S = 32 from the suite's seed; S = 48 for recurrentgemma-2b, past
its window of 32, so that its attention masks by the window and its
decode runs on a ring that wraps).  The native layers run in float32 in
both packages, but XLA and torch round `rsqrt`, `exp`, `tanh`, `cumsum`,
the einsum sums and the means differently in the last ulps, so logits
are held within 1e-4 x max|logits| (a stated tolerance, not bit for bit)
and losses within a relative 1e-5.  The emulated products themselves are
bitwise (`test_new_block_linears_bitwise` here for the SSD, RG-LRU and
MoE archs' linears), and bfloat16 is held in
`tests/test_torch_model_shapes.py`.

The MoE archs route by a native float32 product, so a token whose k-th
and (k+1)-th router logits nearly tie could go to other experts in the
two packages and move by O(1).  Their comparisons hold only if no more
than 1 % of the routed tokens lie within `ROUTE_MARGIN` of a tie in any
layer (`routing.RouteLog`'s relative gap), which at these sizes means
none; each run prints its count.
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
from repro.core.policy import GemmPolicy as JPolicy
from repro.models import layers as j_layers
from repro_torch.configs import ARCHS
from repro_torch.core.policy import GemmPolicy
from repro_torch.interop import model_config_from_fields, policy_from_fields
from repro_torch.models import Model, layers
from repro_torch.models.routing import RouteLog
from repro_torch.models.transformer import layer_params

B = 2
SEQ = {"recurrentgemma-2b": 48}  # S by arch; 32 for the others
DECODE = 3  # decode steps after a prefill of S - DECODE tokens
LOGIT_TOL = 1e-4  # x max|logits|, float32
LOSS_RTOL = 1e-5
ROUTE_MARGIN = 1e-5  # relative gap to a routing tie (see the docstring)
NEW_BLOCK_ARCHS = ("mamba2-130m", "recurrentgemma-2b", "granite-moe-3b-a800m", "deepseek-moe-16b")


def _s(cfg):
    return SEQ.get(cfg.name.removesuffix("-reduced"), 32)


def _np_batch(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, _s(cfg))).astype(np.int32)}
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
    npre, s = _npre(cfg), _s(cfg)
    sp = s - DECODE
    cache = model.init_cache(B, s + npre)
    lp, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :sp]), cache)
    out = [lp[:, -1]]
    for i in range(DECODE):
        ld, cache = model.decode_step(params, batch["tokens"][:, sp + i: sp + i + 1], cache,
                                      jnp.int32(npre + sp + i))
        out.append(ld[:, 0])
    return out


def _port_serve(model, params, batch):
    cfg = model.cfg
    npre, s = _npre(cfg), _s(cfg)
    sp = s - DECODE
    cache = model.init_cache(B, s + npre, device="cpu")
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
        if arch not in self._done:
            rng = np.random.default_rng(SEED)
            jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
            jmodel = JModel(jcfg)
            cfg = model_config_from_fields(dataclasses.asdict(jcfg))
            model = Model(cfg)
            params = model.init(torch.Generator().manual_seed(0), device="cpu")
            jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
            batch = _np_batch(jcfg, rng)
            r = {"cfg": cfg, "model": model, "params": params, "jparams": jparams, "batch": batch}
            with torch.no_grad(), RouteLog() as log:
                r["want_logits"] = np.asarray(jmodel.forward(jparams, _j(batch))[0], np.float32)
                r["got_logits"] = model.forward(params, _t(batch))[0].float().numpy()
                r["want_serve"] = [np.asarray(x, np.float32) for x in _reference_serve(jmodel, jparams, _j(batch))]
                r["got_serve"] = [x.float().numpy() for x in _port_serve(model, params, _t(batch))]
                for chunk in (None, 128):
                    jm = JModel(dataclasses.replace(jcfg, loss_vocab_chunk=chunk))
                    tm = Model(dataclasses.replace(cfg, loss_vocab_chunk=chunk))
                    r[("want_loss", chunk)] = float(jm.loss(jparams, _j(batch))[0])
                    r[("got_loss", chunk)] = float(tm.loss(params, _t(batch))[0])
            r["routes"] = log.routes
            if cfg.mlp == "moe":
                # no drops (capacity = the group's tokens): a token's route
                # no longer depends on the others', so the incremental path
                # meets the full forward
                nodrop = Model(dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_topk))
                with torch.no_grad():
                    r["self_logits"] = nodrop.forward(params, _t(batch))[0].float().numpy()
                    r["self_serve"] = [x.float().numpy() for x in _port_serve(nodrop, params, _t(batch))]
            else:
                r["self_logits"], r["self_serve"] = r["got_logits"], r["got_serve"]
            self._done[arch] = r
        return self._done[arch]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _assert_close_logits(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x max|logits| {scale:.3e}"


def _routing_holds(r, arch):
    """The MoE rule: at most 1 % of the routed tokens near a tie."""
    if r["cfg"].mlp != "moe":
        assert not r["routes"]
        return
    gaps = torch.cat([x.rel_gap for x in r["routes"]])
    near = int((gaps < ROUTE_MARGIN).sum())
    print(f"{arch}: {near} of {gaps.numel()} routed tokens within {ROUTE_MARGIN} of a routing tie")
    assert near <= 0.01 * gaps.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(runs, arch):
    r = runs(arch)
    _routing_holds(r, arch)
    npre = _npre(r["cfg"])
    assert r["got_logits"].shape == (B, _s(r["cfg"]) + npre, r["cfg"].vocab)
    _assert_close_logits(r["got_logits"], r["want_logits"], LOGIT_TOL, f"{arch} forward")


@pytest.mark.parametrize("chunk", [None, 128], ids=["dense", "chunk128"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches(runs, arch, chunk):
    r = runs(arch)
    _routing_holds(r, arch)
    got, want = r[("got_loss", chunk)], r[("want_loss", chunk)]
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match(runs, arch):
    r = runs(arch)
    _routing_holds(r, arch)
    for i, (got, want) in enumerate(zip(r["got_serve"], r["want_serve"])):
        assert got.shape == (B, r["cfg"].vocab)
        _assert_close_logits(got, want, LOGIT_TOL, f"{arch} {'prefill' if i == 0 else f'decode {i}'}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(runs, arch):
    """The port's own incremental path against its full forward (the
    reference's `test_decode_matches_forward_f32`, same tolerance); the
    MoE archs with capacity for every token, since a full-sequence group
    drops other tokens than a prefill's or a decode step's."""
    r = runs(arch)
    npre = _npre(r["cfg"])
    sp = _s(r["cfg"]) - DECODE
    full = r["self_logits"]
    for i, got in enumerate(r["self_serve"]):
        np.testing.assert_allclose(got, full[:, npre + sp - 1 + i], rtol=2e-3, atol=2e-3)


LINEAR_CASES = [(arch, ex) for arch in NEW_BLOCK_ARCHS if arch != "granite-moe-3b-a800m"
                for ex in ("reference", "kernel")]


@pytest.mark.parametrize("arch,execution", LINEAR_CASES, ids=["-".join(c) for c in LINEAR_CASES])
def test_new_block_linears_bitwise(runs, rng, arch, execution):
    """The emulated linears that the SSD, RG-LRU and MoE layers add, in
    layer 0 of their group (SSD: in_proj, out_proj; RG-LRU: in_x,
    in_gate, w_a, w_x, out; MoE: the shared expert, and deepseek's dense
    layer-0 FFN; the attention projections and dense MLPs are the
    attention archs' and held there) under `GemmPolicy(backend=
    "ozaki2_f32", n_moduli=8)` against the reference's `apply_linear` (its
    kernels in interpret mode on `kernel`), on the arch's own weights:
    bitwise."""
    r = runs(arch)
    jpol = JPolicy(backend="ozaki2_f32", n_moduli=8, execution=execution, interpret=True)
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    seen = set()
    for g, (bk, mk, _) in enumerate(r["cfg"].layer_groups):
        lp = layer_params(r["params"]["groups"][g], 0)
        mlp = lp.get("mlp", {})
        bundles = {f"block.{k}": v for k, v in lp["block"].items() if isinstance(v, dict) and bk != "attn"}
        if mk == "dense_first":
            bundles.update({f"mlp.{k}": v for k, v in mlp.items()})
        bundles.update({f"mlp.shared.{k}": v for k, v in mlp.get("shared", {}).items()})
        for name, p in bundles.items():
            seen.add(name)
            x = rng.standard_normal((B, 4, p["w"].shape[0])).astype(np.float32)
            want = np.asarray(j_layers.apply_linear({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                                    jnp.asarray(x), jpol))
            got = layers.apply_linear(p, torch.from_numpy(x), tpol)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{arch} {bk}/{mk} {name}")
    assert seen == LINEARS_OF[arch]


LINEARS_OF = {
    "mamba2-130m": {"block.in_proj", "block.out_proj"},
    "recurrentgemma-2b": {"block.in_x", "block.in_gate", "block.w_a", "block.w_x", "block.out"},
    "granite-moe-3b-a800m": set(),
    "deepseek-moe-16b": {"mlp.gate", "mlp.up", "mlp.down", "mlp.shared.gate", "mlp.shared.up", "mlp.shared.down"},
}


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
