"""The port's models in bfloat16, its shapes, initialisation, registry and
interop helpers, against `repro`'s.

* bfloat16 models against the reference's op-by-op run (`jax.disable_jit`).
* The ten published configs: parameter counts, every param and cache
  shape and dtype, and the input shapes of each cell.
* `materialize`, and the interop helpers that carry weights and configs
  across.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import applicable as j_applicable
from repro.configs.shapes import input_specs as j_input_specs
from repro.core.policy import GemmPolicy as JPolicy
from repro.models import Model as JModel
from repro_torch import use_policy
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.core.policy import NATIVE, GemmPolicy
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.models import Model
from repro_torch.models.params import ParamMeta, materialize

B, S = 2, 32


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "starcoder2-3b", "mamba2-130m"])
def test_bfloat16_forward_matches_op_by_op_reference(rng, arch):
    """A bfloat16 model's logits against the reference's own forward run op
    by op (`jax.disable_jit`), which the port mirrors: within 2e-2 x
    max|logits|.  Not bitwise: the float32 sums inside the native bfloat16
    products run in another order, and each moved rounding is a relative
    2^-8 (measured up to 6.5e-3 x max|logits| over eight weight draws; the
    reference draws its weights anew in each process).  The compiled
    reference is another computation in bfloat16: inside its `lax.scan`
    XLA keeps float32 excess precision between fused ops, and its logits
    move up to 9e-2 x max|logits| from its own op-by-op run.  mamba2-130m
    computes its SSD scan in float32 from bfloat16 linears and is held the
    same way (2.7e-3 to 5.8e-3 x max|logits| over five weight draws).
    recurrentgemma-2b is not: at the reference's init many RG-LRU gates
    saturate, where sqrt(1 - exp(2 log a)) either cancels in float32 or
    meets its 1e-12 floor, so one moved bfloat16 ulp can move such a
    channel's input by two orders of magnitude (3.4e-2 x max|logits| in
    one draw); its
    bfloat16 blocks are held in `tests/test_torch_blocks.py`.

    The weights are drawn once, by the port's init (its per-leaf seeds
    come from `zlib.crc32` of the path, the same in every process) from
    generator seed 0 and cast to bfloat16, and the same arrays feed both
    packages: the reference's own init seeds by Python's salted `hash`,
    so with it each process computed something else (starcoder2-3b read
    0.1404 against its bound 0.0928 in one run)."""
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="bfloat16")
    jmodel = JModel(jcfg)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    jparams = jax.tree.map(_to_jax, params)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})[0], np.float32)
    with torch.no_grad():
        got = Model(cfg).forward(params, {"tokens": torch.from_numpy(tokens)})[0].numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _to_jax(t: torch.Tensor):
    """A port tensor as a JAX array with the same bits (bfloat16 through
    its 16-bit view)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), np.dtype(a.dtype).name if not isinstance(a, torch.Tensor)
                                   else str(a.dtype).removeprefix("torch.")), tree)


def _meta_shapes(tree):
    return jax.tree.map(lambda m: (tuple(m.shape), np.dtype(m.dtype).name if not isinstance(m.dtype, torch.dtype)
                                   else str(m.dtype).removeprefix("torch.")),
                        tree, is_leaf=lambda m: hasattr(m, "axes"))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_metadata(arch):
    """The published configs: the reference's parameter counts and every
    param and decode-cache shape and dtype (metadata only, no allocation)."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg)["n_layers"] == jcfg.n_layers
    assert (cfg.param_count(), cfg.active_param_count()) == (jcfg.param_count(), jcfg.active_param_count())
    assert cfg.layer_groups == jcfg.layer_groups
    jm, m = JModel(jcfg), Model(cfg)
    assert _shapes(m.param_shapes()) == _shapes(jm.param_shapes())
    assert _meta_shapes(m.cache_abstract(4, 4096)) == _meta_shapes(jm.cache_abstract(4, 4096))
    for shape in SHAPES:
        assert applicable(cfg, shape)[0] == j_applicable(jcfg, shape)[0]
        assert _shapes(input_specs(cfg, shape)) == _shapes(j_input_specs(jcfg, shape))


def test_registry_matches_reference():
    assert ARCHS == J_ARCHS and set(SHAPES) == set(J_SHAPES)
    pol = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    with use_policy(pol):
        assert get_reduced("starcoder2-3b").gemm_policy == pol
        assert get_reduced("starcoder2-3b", gemm_policy=NATIVE).gemm_policy == NATIVE
    assert get_reduced("starcoder2-3b").gemm_policy == NATIVE


def test_materialize_deterministic_and_initialised_as_declared():
    tree = {
        "w": ParamMeta((256, 64), ("embed", "ff"), "float32"),
        "s": ParamMeta((128, 32), (None, None), torch.bfloat16, scale=0.5),
        "z": ParamMeta((7,), (None,), "float32", "zeros"),
        "o": [ParamMeta((5,), (None,), "bfloat16", "ones")],
        "pos": ParamMeta((9,), (None,), torch.int32, "future_pos"),
    }
    gen = torch.Generator().manual_seed(0)
    a, b = materialize(tree, gen, "cpu"), materialize(tree, gen, "cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    other = materialize(tree, torch.Generator().manual_seed(1), "cpu")
    assert not torch.equal(a["w"], other["w"])
    assert a["w"].dtype == torch.float32 and a["s"].dtype == torch.bfloat16
    assert abs(float(a["w"].std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(a["w"].mean())) < 0.02 * 256 ** -0.5 * 4
    assert abs(float(a["s"].float().std()) - 0.5) < 0.05 * 0.5
    assert torch.equal(a["z"], torch.zeros(7)) and torch.equal(a["o"][0], torch.ones(5, dtype=torch.bfloat16))
    assert a["pos"].dtype == torch.int32 and bool((a["pos"] == 2**30).all())
    assert not torch.equal(a["w"][:128, :32], a["s"].float())  # each leaf has its own stream
    # the reference's fan-in rule reads shape[0]: a stacked leaf's layer count
    stacked = materialize({"w": ParamMeta((4, 256, 64), ("layers", "embed", "ff"), "float32")}, gen, "cpu")
    assert abs(float(stacked["w"].std()) - 0.5) < 0.05 * 0.5


def test_model_init_on_the_card_by_default():
    cfg = get_reduced("starcoder2-3b", n_layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg).init()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg).init_cache(1, 8)
    params = Model(cfg).init(device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["groups"][0]["block"]["q"]["w"].shape == (1, 128, 128)


def test_params_from_numpy_carries_bfloat16_bits(rng):
    x = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"a": [np.asarray(x)], "b": np.asarray(x).view("V2"), "c": np.asarray(7, np.int32),
            "d": np.asarray(jnp.asarray(rng.standard_normal(4), jnp.float32))}
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(np.asarray(x)))
    got = params_from_numpy(tree, "cpu")
    for t in (got["a"][0], got["b"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    assert got["c"].dtype == torch.int32 and int(got["c"]) == 7
    np.testing.assert_array_equal(got["d"].numpy(), tree["d"])


def test_model_config_from_fields():
    jpol = JPolicy(backend="ozaki2_f32", n_moduli=8, execution="kernel", interpret=True)
    jcfg = dataclasses.replace(j_get_reduced("minitron-4b"), gemm_policy=jpol, loss_vocab_chunk=64)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.gemm_policy == GemmPolicy(backend="ozaki2_f32", n_moduli=8, execution="kernel")
    for f in dataclasses.fields(jcfg):
        if f.name != "gemm_policy":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg == get_reduced("minitron-4b", gemm_policy=cfg.gemm_policy, loss_vocab_chunk=64)
    assert repro.linalg.current_policy() == JPolicy()
