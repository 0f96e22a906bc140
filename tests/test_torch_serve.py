"""The port's serving engine (`repro_torch.serve.ServeEngine`), its prepared
weights and the serve CLI, on the CPU.

* Greedy tokens against the reference's `ServeEngine` (reduced
  qwen2.5-32b, float32, the port's crc32 init from generator seed 0
  carried across, the same weights in every process): equal at
  every step whose context is still the same and where the reference's
  top-2 margin exceeds 2e-4 x max|logits|, twice the logit tolerance of
  `tests/test_torch_models.py` (both top logits may move by it).
* Prepared serving against unprepared serving (the attention archs and
  the SSD, RG-LRU and MoE archs), a `prepared_dir` restore against a
  fresh preparation, and a prepared stack's per-layer view against
  preparing that layer alone: bit for bit.  Preparation selects the
  reference's weights on every arch's tree.
* The serve CLI serves every arch on the CPU.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced as j_get_reduced
from repro.models import Model as JModel
from repro.core.executor import PreparedOperand as JPreparedOperand
from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import prepare_weights as j_prepare_weights
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.core.executor import PreparedOperand
from repro_torch.core.policy import GemmPolicy, prepare_weights, prepared_like
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod

B, PROMPT, NEW = 2, 8, 6
MARGIN = 2e-4  # x max|logits|


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 logits equal bit for bit (a zero's sign counts)."""
    return a.dtype == b.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_greedy_tokens_match_reference_engine(rng):
    jcfg = dataclasses.replace(j_get_reduced("qwen2.5-32b"), dtype="float32")
    jmodel = JModel(jcfg)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           Model(cfg).init(torch.Generator().manual_seed(0), device="cpu"))
    tokens = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jeng = JServeEngine(jmodel, jparams, cache_len=PROMPT + NEW, batch_size=B)
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(tokens)}, NEW))
    # the reference's logits at each step, its own tokens forced (its compiled steps)
    cache = jmodel.init_cache(B, PROMPT + NEW)
    logits, cache = jeng._prefill(jeng.params, {"tokens": jnp.asarray(tokens)}, cache)
    ref_logits = [np.asarray(logits[:, -1])]
    for i in range(NEW - 1):
        logits, cache = jeng._decode(jeng.params, jnp.asarray(want[:, i: i + 1]), cache, jnp.int32(PROMPT + i))
        ref_logits.append(np.asarray(logits[:, -1]))

    eng = ServeEngine(Model(cfg), params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                      cache_len=PROMPT + NEW, batch_size=B, device="cpu")
    got, got_logits = eng.generate({"tokens": torch.from_numpy(tokens)}, NEW, return_logits=True)
    assert got.shape == (B, NEW) and got.dtype == torch.int32
    assert got_logits.shape == (B, NEW + 1, cfg.vocab)
    got = got.numpy()
    compared = 0
    for row in range(B):
        for i in range(NEW):
            top2 = np.sort(ref_logits[i][row])[-2:]
            if top2[1] - top2[0] > MARGIN * np.abs(ref_logits[i][row]).max():
                assert got[row, i] == want[row, i], (row, i)
                compared += 1
            if got[row, i] != want[row, i]:
                break  # the contexts differ from here on
    assert compared >= B * NEW // 2


NEW_BLOCK_ARCHS = ("mamba2-130m", "recurrentgemma-2b", "granite-moe-3b-a800m", "deepseek-moe-16b")


def _engine_cfg(execution, n_layers=2, arch="starcoder2-3b"):
    return get_reduced(arch, dtype="float32", n_layers=n_layers,
                       gemm_policy=GemmPolicy(backend="ozaki2_f32", execution=execution))


def _prompt(rng, cfg, b=1, s=PROMPT):
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}


@pytest.mark.parametrize("execution", ["reference", "kernel"])
def test_prepared_serving_bitwise(rng, execution):
    cfg = _engine_cfg(execution)
    model = Model(cfg)
    params = model.init(device="cpu")
    batch = _prompt(rng, cfg, b=B)
    plain = ServeEngine(model, params, cache_len=PROMPT + 3, batch_size=B, device="cpu")
    prepped = ServeEngine(model, params, cache_len=PROMPT + 3, batch_size=B, prepare=True, device="cpu")
    w = prepped.params["groups"][0]["block"]["q"]["w"]
    assert isinstance(w, PreparedOperand) and w.batch_ndim == 1
    t1, l1 = plain.generate(batch, 3, return_logits=True)
    t2, l2 = prepped.generate(batch, 3, return_logits=True)
    assert torch.equal(t1, t2) and _same_bits(l1, l2)


@pytest.mark.parametrize("arch", NEW_BLOCK_ARCHS)
def test_prepared_serving_bitwise_new_blocks(rng, arch):
    """The SSD, RG-LRU and MoE archs (all their layers; recurrentgemma's
    third is its attention) served prepared and unprepared on `kernel`
    (prefill and two decode steps): the same tokens and logits, bit for
    bit."""
    cfg = get_reduced(arch, dtype="float32", gemm_policy=GemmPolicy(backend="ozaki2_f32", execution="kernel"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _prompt(rng, cfg, b=B)
    plain = ServeEngine(model, params, cache_len=PROMPT + 2, batch_size=B, device="cpu")
    prepped = ServeEngine(model, params, cache_len=PROMPT + 2, batch_size=B, prepare=True, device="cpu")
    t1, l1 = plain.generate(batch, 2, return_logits=True)
    t2, l2 = prepped.generate(batch, 2, return_logits=True)
    assert torch.isfinite(l1).all()
    assert torch.equal(t1, t2) and _same_bits(l1, l2)


def _prepared_paths(tree, kind, path=""):
    """The paths of the `kind` instances in a tree of dicts and lists."""
    if isinstance(tree, kind):
        return {path}
    if isinstance(tree, dict):
        return set().union(*(_prepared_paths(v, kind, f"{path}/{k}") for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return set().union(*(_prepared_paths(v, kind, f"{path}/{i}") for i, v in enumerate(tree)))
    return set()


# the linears each new block kind prepares (the "w" of each linear bundle);
# the conv, the router and the experts' stacked gate/up/down are not
PREPARED_OF = {
    "mamba2-130m": {"block/in_proj", "block/out_proj"},
    "recurrentgemma-2b": {"block/in_x", "block/in_gate", "block/w_a", "block/w_x", "block/out",
                          "block/q", "block/k", "block/v", "block/o", "mlp/gate", "mlp/up", "mlp/down"},
    "granite-moe-3b-a800m": {"block/q", "block/k", "block/v", "block/o"},
    "deepseek-moe-16b": {"block/q", "block/k", "block/v", "block/o", "mlp/gate", "mlp/up", "mlp/down",
                         "mlp/shared/gate", "mlp/shared/up", "mlp/shared/down"},
}


@pytest.mark.parametrize("arch", NEW_BLOCK_ARCHS)
def test_prepare_weights_selects_the_references_leaves(arch):
    """`prepare_weights` (through `prepared_like`, its structure) prepares
    exactly the leaves the reference's `prepare_weights` selects on the
    same tree: each linear bundle's "w"."""
    cfg = get_reduced(arch, dtype="float32")
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    jpol = JPolicy(backend="ozaki2_f32", execution="kernel", interpret=True)
    jshapes = jax.eval_shape(lambda p: j_prepare_weights(p, jpol), JModel(jcfg).param_shapes())
    want = _prepared_paths(jshapes, JPreparedOperand)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = _prepared_paths(prepared_like(params, GemmPolicy(backend="ozaki2_f32", execution="kernel")),
                          PreparedOperand)
    assert got == want
    assert {p.split("/", 3)[3].removesuffix("/w") for p in got} == PREPARED_OF[arch]


@pytest.mark.parametrize("mode", ["fast", "accu"])
def test_prepared_layer_view_is_preparing_that_layer(rng, mode):
    pol = GemmPolicy(backend="ozaki2_f32", execution="kernel", mode=mode)
    w = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    stacked = prepare_weights({"w": w}, pol, device="cpu")["w"]
    for i in range(3):
        one = prepare_weights({"w": w[i]}, pol, device="cpu")["w"]
        view = stacked.layer(i)
        assert view.batch_ndim == 0 and one.batch_ndim == 0
        for name in ("e_scale", "e_bound", "raw"):
            a, b = getattr(view, name), getattr(one, name)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
        for name in ("residues", "bound"):
            assert all(torch.equal(a, b) for a, b in zip(getattr(view, name), getattr(one, name))), name


@pytest.mark.parametrize("backend,mode", [("ozaki2_f32", "fast"), ("ozaki2_f32", "accu"),
                                          ("ozaki2_c64", "fast"), ("ozaki2_c64", "accu")])
def test_prepared_like_is_the_preparations_structure(rng, backend, mode):
    """`prepared_like` (no cast) has the fields, shapes, dtypes and metadata
    `prepare_weights` builds: the `like` tree a `prepared_dir` restores into."""
    pol = GemmPolicy(backend=backend, execution="kernel", mode=mode)
    w = torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32)).to(pol.compute_dtype)
    tree = {"mlp": {"up": {"w": w, "b": w[0, 0]}}}
    real = prepare_weights(tree, pol, device="cpu")["mlp"]["up"]
    like = prepared_like(tree, pol)["mlp"]["up"]
    assert like["b"] is tree["mlp"]["up"]["b"]
    a, b = real["w"], like["w"]
    assert (a.side, a.n_moduli, a.n_limbs, a.dtype) == (b.side, b.n_moduli, b.n_limbs, b.dtype)
    spec = lambda t: None if t is None else (tuple(t.shape), t.dtype)  # noqa: E731
    for name in ("e_scale", "e_bound", "raw"):
        assert spec(getattr(a, name)) == spec(getattr(b, name)), name
        assert getattr(b, name) is None or getattr(b, name).device.type == "meta"
    for name in ("residues", "bound"):
        assert [spec(t) for t in getattr(a, name)] == [spec(t) for t in getattr(b, name)], name


def test_prepared_dir_restores_without_casting(rng, tmp_path, monkeypatch):
    calls = []
    real = engine_mod.prepare_weights
    monkeypatch.setattr(engine_mod, "prepare_weights", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _engine_cfg("kernel")
    model = Model(cfg)
    params = model.init(device="cpu")
    batch = _prompt(rng, cfg)
    pdir = str(tmp_path / "prepared")
    plain = ServeEngine(model, params, cache_len=PROMPT + 2, batch_size=1, device="cpu")
    first = ServeEngine(model, params, cache_len=PROMPT + 2, batch_size=1, prepare=True,
                        prepared_dir=pdir, device="cpu")
    assert len(calls) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = ServeEngine(model, params, cache_len=PROMPT + 2, batch_size=1, prepare=True,
                               prepared_dir=pdir, device="cpu")
    assert len(calls) == 1  # restored, not prepared again
    a, b = first.params["groups"][0]["mlp"]["up"]["w"], restored.params["groups"][0]["mlp"]["up"]["w"]
    assert torch.equal(a.e_scale, b.e_scale) and torch.equal(a.residues[0], b.residues[0])
    t0, l0 = plain.generate(batch, 2, return_logits=True)
    t1, l1 = restored.generate(batch, 2, return_logits=True)
    assert torch.equal(t0, t1) and _same_bits(l0, l1)

    # the bias is not prepared: changing it keeps the planes
    bumped = jax.tree.map(lambda t: t, params)
    bumped["groups"][0]["block"]["q"]["b"] = params["groups"][0]["block"]["q"]["b"] + 1e-3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServeEngine(model, bumped, cache_len=8, batch_size=1, prepare=True, prepared_dir=pdir, device="cpu")
    assert len(calls) == 1
    # another policy, or another weight: warned and prepared again
    other = Model(dataclasses.replace(cfg, gemm_policy=GemmPolicy(backend="ozaki2_f32", execution="reference")))
    with pytest.warns(UserWarning, match="re-preparing"):
        ServeEngine(other, params, cache_len=8, batch_size=1, prepare=True, prepared_dir=pdir, device="cpu")
    assert len(calls) == 2
    changed = jax.tree.map(lambda t: t, params)
    changed["groups"][0]["mlp"]["down"]["w"] = params["groups"][0]["mlp"]["down"]["w"] + 1e-3
    with pytest.warns(UserWarning, match="re-preparing"):
        ServeEngine(other, changed, cache_len=8, batch_size=1, prepare=True, prepared_dir=pdir, device="cpu")
    assert len(calls) == 3


def test_weights_fingerprint_is_the_references(rng):
    """The stale-cache fingerprint hashes the same bytes and the same
    shape/dtype text as the reference's, float32 and bfloat16 alike."""
    w32 = rng.standard_normal((2, 4, 3)).astype(np.float32)
    wbf = np.asarray(jnp.asarray(rng.standard_normal((5, 6)), jnp.bfloat16))
    raw = {"g/0/w": w32, "h/w": wbf}
    want = JServeEngine._weights_fingerprint({k: jnp.asarray(v) for k, v in raw.items()})
    assert ServeEngine._weights_fingerprint(params_from_numpy(raw, "cpu")) == want


def test_temperature_sampling(rng):
    cfg = get_reduced("starcoder2-3b", dtype="float32", n_layers=1)
    model = Model(cfg)
    eng = ServeEngine(model, model.init(device="cpu"), cache_len=PROMPT + 4, batch_size=B, device="cpu")
    batch = _prompt(rng, cfg, b=B)
    a = eng.generate(batch, 4, temperature=1.0, generator=torch.Generator().manual_seed(0))
    b = eng.generate(batch, 4, temperature=1.0, generator=torch.Generator().manual_seed(0))
    assert a.shape == (B, 4) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    assert torch.equal(a, b)  # an explicit generator repeats its draws


def test_serve_cli_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--execution", "kernel",
                           "--prepare", "--batch", "1", "--prompt-len", "8", "--new-tokens", "2",
                           "--device", "cpu"]) == 0
    assert "tok/s" in capsys.readouterr().out
    # the sharded execution without a launcher: a world of one
    assert serve_cli.main(["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--execution", "sharded",
                           "--batch", "1", "--prompt-len", "4", "--new-tokens", "1", "--device", "cpu"]) == 0
    assert "[starcoder2-3b] (1, 1) in" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main(["--arch", "starcoder2-3b", "--new-tokens", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_every_arch(capsys, arch):
    """`python -m repro_torch.launch.serve --arch ARCH` on the CPU, the
    emulated kernel execution prepared, for each of the ten archs."""
    assert serve_cli.main(["--arch", arch, "--backend", "ozaki2_f32", "--execution", "kernel", "--prepare",
                           "--batch", "1", "--prompt-len", "8", "--new-tokens", "2", "--device", "cpu"]) == 0
    assert f"[{arch}] (1, 2) in" in capsys.readouterr().out


def test_serve_cli_residue_axis_raises(capsys):
    """--residue names the sharded execution's mesh axis: with another
    execution anything but 1 is refused instead of being ignored; with
    `sharded` and no launcher it is clamped to the world of one, as the
    reference clamps it to its devices (2 ranks: test_torch_sharded_models)."""
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--execution", "kernel",
                        "--residue", "2", "--batch", "1", "--prompt-len", "4", "--new-tokens", "1",
                        "--device", "cpu"])
    assert "--residue 2 is the sharded execution's mesh axis" in capsys.readouterr().err
    assert serve_cli.main(["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--execution", "sharded",
                           "--residue", "2", "--batch", "1", "--prompt-len", "4", "--new-tokens", "1",
                           "--device", "cpu"]) == 0
    assert "[starcoder2-3b] (1, 1) in" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["starcoder2-3b", "internvl2-26b"])
def test_prompt_batch(arch):
    """The CLI's prompts: tokens in the vocabulary, prefix embeddings for a
    frontend arch, the same draws from the same seed."""
    cfg = get_reduced(arch)
    a = serve_cli.prompt_batch(cfg, 2, 5, np.random.default_rng(0), torch.device("cpu"))
    b = serve_cli.prompt_batch(cfg, 2, 5, np.random.default_rng(0), torch.device("cpu"))
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == torch.int32
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab
    assert ("prefix_embeds" in a) == bool(cfg.frontend)
    if cfg.frontend:
        assert a["prefix_embeds"].shape == (2, cfg.n_prefix_embeds, cfg.d_model)
    assert all(torch.equal(a[k], b[k]) for k in a)
