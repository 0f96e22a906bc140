"""The port's checkpointer (`repro_torch.checkpoint`): the reference's six
checkpoint cases, and checkpoints crossing between the two packages (same
layout, same keys).  Tolerance: none — every restore is bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import phi_matrix

import repro  # noqa: F401
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_reduced as j_get_reduced
from repro.core.policy import GemmPolicy as JPolicy
from repro.core.policy import prepare_weights as j_prepare_weights
from repro.models import Model as JModel
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch import linalg
from repro_torch.core.policy import prepare_weights, prepared_like
from repro_torch.interop import params_from_numpy, policy_from_fields


def _tree(rng):
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "groups": [
            {"w": torch.from_numpy(rng.standard_normal((2, 3))).to(torch.bfloat16)},
            {"w": torch.from_numpy(rng.integers(0, 5, (7,)).astype(np.int32))},
        ],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return jax.tree.leaves(tree)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(width), b.view(width))
    return torch.equal(a, b)


def test_roundtrip(tmp_path, rng):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(rng)
    ck.save(10, tree)
    out = ck.restore(10, tree, device="cpu")
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert _same_bits(a, b)


def test_latest_and_gc(tmp_path, rng):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree(rng)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert latest_step(str(tmp_path)) == 4
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]


def test_async_save(tmp_path, rng):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(rng)
    ck.save(5, tree, blocking=False)
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    out = ck.restore(5, tree, device="cpu")
    assert torch.equal(out["a"], tree["a"])


def test_async_save_snapshots_cpu_tensors(tmp_path, rng, monkeypatch):
    """An asynchronous save holds the values the tree had when `save` was
    called, also for CPU tensors that the caller then updates in place
    (the train step's donated update does): the write is delayed past
    the update."""
    import time

    import repro_torch.checkpoint.checkpointer as checkpointer

    real = np.savez

    def slow_savez(*args, **kwargs):
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(checkpointer.np, "savez", slow_savez)
    ck = Checkpointer(str(tmp_path))
    tree = _tree(rng)
    want = [t.clone() for t in _leaves(tree)]
    ck.save(5, tree, blocking=False)
    for t in _leaves(tree):
        t.add_(1)
    ck.wait()
    for a, b in zip(want, _leaves(ck.restore(5, tree, device="cpu"))):
        assert _same_bits(a, b)


def test_no_tmp_left_behind(tmp_path, rng):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(rng))
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_meta(tmp_path, rng):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(rng), extra_meta={"mesh": [16, 16]})
    assert ck.meta(3)["mesh"] == [16, 16]


def test_restore_into_meta_tensors(tmp_path, rng):
    """Restore without live tensors: a `like` tree on the "meta" device
    (the reference restores into ShapeDtypeStructs)."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree(rng)
    ck.save(2, tree)
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    out = ck.restore(2, like, device="cpu")
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert _same_bits(a, b)


def test_restore_defaults_to_the_card(tmp_path, rng):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, _tree(rng))
    if torch.cuda.is_available():
        assert ck.restore(0, _tree(rng))["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore(0, _tree(rng))


def test_bfloat16_leaves_roundtrip_bitwise(tmp_path, rng):
    """bfloat16 leaves (random bit patterns, both zeros, a subnormal and
    both infinities) restore bitwise, the reference reads the port's file,
    and the port the reference's."""
    bits = np.concatenate([rng.integers(0, 1 << 16, 4096), [0, 0x8000, 0x0001, 0x7F80, 0xFF80]])
    x = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    x = x[~torch.isnan(x)]
    tree = {"x": x, "y": [x[:7].clone()]}
    Checkpointer(str(tmp_path / "port")).save(0, tree)
    out = Checkpointer(str(tmp_path / "port")).restore(0, tree, device="cpu")
    assert _same_bits(out["x"], x) and _same_bits(out["y"][0], tree["y"][0])
    jout = JCheckpointer(str(tmp_path / "port")).restore(0, {"x": 0, "y": [0]})
    assert jout["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jout["x"]).view(np.int16), x.view(torch.int16).numpy())
    JCheckpointer(str(tmp_path / "ref")).save(0, jout)
    back = Checkpointer(str(tmp_path / "ref")).restore(0, tree, device="cpu")
    assert _same_bits(back["x"], x)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reference float32 param tree (reduced starcoder2-3b) and the
    residue planes the reference prepared from it (kernel execution, its
    Pallas cast in interpret mode) restore into the port bitwise, the
    planes as the port's `PreparedOperand`s."""
    jcfg = dataclasses.replace(j_get_reduced("starcoder2-3b"), dtype="float32", n_layers=1)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    jck = JCheckpointer(str(tmp_path / "params"))
    jck.save(3, jparams)
    port_model_params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    out = Checkpointer(str(tmp_path / "params")).restore(3, port_model_params, device="cpu")
    for a, b in zip(_leaves(out), _leaves(port_model_params)):
        assert _same_bits(a, b)

    jpol = JPolicy(backend="ozaki2_f32", execution="kernel", interpret=True)
    jmlp = jparams["groups"][0]["mlp"]
    JCheckpointer(str(tmp_path / "planes")).save(0, j_prepare_weights(jmlp, jpol))
    tpol = policy_from_fields(dataclasses.asdict(jpol))
    tmlp = out["groups"][0]["mlp"]
    restored = Checkpointer(str(tmp_path / "planes")).restore(0, prepared_like(tmlp, tpol), device="cpu")
    mine = prepare_weights(tmlp, tpol, device="cpu")
    for name in ("up", "down"):
        got, want = restored[name]["w"], mine[name]["w"]
        assert (got.n_moduli, got.n_limbs, got.dtype, got.side) == (want.n_moduli, want.n_limbs, want.dtype, want.side)
        assert torch.equal(got.e_scale, want.e_scale)
        assert all(torch.equal(a, b) for a, b in zip(got.residues, want.residues))
        x = torch.from_numpy(phi_matrix(np.random.default_rng(0), (3, got.operand_shape[0]), 0.5, np.float32))
        assert torch.equal(linalg.matmul(x, got.layer(0), policy=tpol, device="cpu"),
                           linalg.matmul(x, tmlp[name]["w"][0], policy=tpol, device="cpu"))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_new_block_params_cross_the_packages(tmp_path, arch):
    """An SSD, RG-LRU or MoE arch's param tree (reduced, float32: the
    conv, the recurrences' float32 vectors, the router and the stacked
    experts) saved by the port restores into the reference bitwise, and
    the reference's save of it back into the port."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model

    params = Model(get_reduced(arch, dtype="float32")).init(torch.Generator().manual_seed(0), device="cpu")
    Checkpointer(str(tmp_path / "port")).save(1, params)
    jparams = JCheckpointer(str(tmp_path / "port")).restore(1, jax.tree.map(lambda t: 0, params))
    for a, b in zip(_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    JCheckpointer(str(tmp_path / "ref")).save(2, jparams)
    back = Checkpointer(str(tmp_path / "ref")).restore(2, params, device="cpu")
    for a, b in zip(_leaves(params), _leaves(back)):
        assert _same_bits(a, b)
