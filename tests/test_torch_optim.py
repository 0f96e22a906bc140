"""Parity of the port's optimizer (`repro_torch.optim`) with `repro.optim`,
on the CPU.

* `cosine_warmup`: within 2 float32 ulp of the reference's op-by-op
  values (`jax.disable_jit`) at every step, and no further from its
  jitted values than 2 ulp plus the reference's own distance between its
  jitted and op-by-op values at that step.  That distance reaches 6 ulp
  at (10, 120): near the end of the cosine ``1 + cos`` cancels, and XLA
  fuses the jitted schedule otherwise, so no schedule is within 2 ulp of
  both there.
* `adamw_update`: bitwise against the reference's op-by-op update
  (`jax.disable_jit`), float32 leaves and a bfloat16 leaf with a float32
  master, with clipping on and off and a float32 schedule factor.  Under
  `jax.jit` XLA contracts the update into FMAs (one ulp in some elements,
  as ROADMAP queue 3 records for the reconstructions), which the port
  never does, so the eager call is the one held.  Where the clip is
  active the update scales by grad_clip / norm, and the two packages sum
  the squares in other orders: those cases hand the port the reference's
  norm (identical inputs), and `global_norm` itself is held within 2^-20
  relative (its leaves in `jax.tree.leaves`' order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the reference runs)
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim.adamw import global_norm as j_global_norm
from repro_torch.interop import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves

SCHEDULES = [(5, 40), (10, 120)]
ULP = 2


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps of two arrays of non-negative
    float32 values (their bit patterns are ordered like the values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("warmup,total", SCHEDULES)
def test_cosine_warmup_within_2_ulp(warmup, total):
    steps = np.arange(total + 3, dtype=np.int32)
    ref = j_cosine_warmup(warmup, total)
    jitted = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(steps)))
    with jax.disable_jit():
        eager = np.array([np.asarray(ref(jnp.int32(s))) for s in steps], np.float32)
    sched = cosine_warmup(warmup, total)
    got = np.array([sched(torch.tensor(int(s), dtype=torch.int32)).item() for s in steps], np.float32)
    assert sched(torch.tensor(0, dtype=torch.int32)).dtype == torch.float32
    own = np.abs(jitted.view(np.int32).astype(np.int64) - eager.view(np.int32).astype(np.int64))
    far = np.abs(got.view(np.int32).astype(np.int64) - jitted.view(np.int32).astype(np.int64))
    assert _ulps(got, eager) <= ULP, (got, eager)
    assert (far <= own + ULP).all(), (got, jitted, own)
    # a Python int step gives the same value
    assert sched(7).item() == got[7]


def _grad_tree(rng, scale):
    return {
        "w": (rng.standard_normal((64, 48)) * scale).astype(np.float32),
        "b": (rng.standard_normal((48,)) * scale).astype(np.float32),
        "groups": [{"norm": (rng.standard_normal((3, 16)) * scale).astype(np.float32)}],
    }


def _param_tree(rng):
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "b": rng.standard_normal((48,)).astype(np.float32),
        "groups": [{"norm": (1 + 0.1 * rng.standard_normal((3, 16))).astype(np.float32)}],
    }


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.itemsize == 2:
        return a.view(np.uint16)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


CASES = {
    # (param dtype, use_master, grad scale, grad_clip, lr_scale)
    "f32-noclip": ("float32", True, 1e-2, 1.0, 1.0),
    "f32-clip": ("float32", True, 1.0, 1.0, 1.0),
    "f32-nomaster-sched-noclip": ("float32", False, 1e-2, 5.0, "sched"),
    "bf16-master-clip": ("bfloat16", True, 1.0, 1.0, "sched"),
}


@pytest.mark.parametrize("case", CASES)
def test_adamw_update_bitwise(rng, monkeypatch, case):
    """Three updates in a row from `adamw_init`, every new param and state
    leaf and both metrics bitwise the reference's op-by-op values (a
    clipped case given the reference's norm)."""
    import repro_torch.optim.adamw as adamw

    dtype, use_master, scale, grad_clip, lr_scale = CASES[case]
    clipped = not case.endswith("noclip")
    if clipped:
        monkeypatch.setattr(adamw, "global_norm", lambda tree: torch.from_numpy(np.array(jnorm, np.float32)))
    jcfg = JAdamWConfig(lr=3e-3, grad_clip=grad_clip, use_master=use_master)
    cfg = AdamWConfig(lr=3e-3, grad_clip=grad_clip, use_master=use_master)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), _param_tree(rng))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with jax.disable_jit():
        jstate = j_adamw_init(jparams, jcfg)
    state = adamw_init(params, cfg)
    assert sorted(state) == sorted(jstate)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    for step in range(3):
        grads_np = _grad_tree(rng, scale)
        jgrads = jax.tree.map(jnp.asarray, grads_np)
        grads = params_from_numpy(grads_np, "cpu")
        with jax.disable_jit():
            jnorm = np.asarray(j_global_norm(jgrads))
        assert (jnorm > grad_clip) == clipped
        if lr_scale == "sched":
            jscale = j_cosine_warmup(1, 4)(jstate["step"])
            scale_t = torch.from_numpy(np.asarray(jscale).copy())
        else:
            jscale = scale_t = lr_scale
        with jax.disable_jit():
            jparams, jstate, jmet = j_adamw_update(jparams, jgrads, jstate, jcfg, jscale)
        params, state, met = adamw_update(params, grads, state, cfg, scale_t)
        for name, want, got in (("params", jparams, params), ("state", jstate, state)):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                np.testing.assert_array_equal(_torch_bits(b), _bits(a), err_msg=f"{case} step {step} {name}")
        want_norm, got_norm = float(jmet["grad_norm"]), float(met["grad_norm"])
        assert abs(got_norm - want_norm) <= (0 if clipped else 2**-20) * want_norm
        assert float(jmet["lr"]) == float(met["lr"])
    assert int(state["step"]) == 3


def test_adamw_inplace_equals_functional(rng):
    """``inplace=True`` (the train step's ``donate``) writes the same bits
    into the given tensors; ``inplace=False`` leaves them untouched."""
    cfg = AdamWConfig(lr=1e-2)
    params = params_from_numpy(_param_tree(rng), "cpu")
    grads = params_from_numpy(_grad_tree(rng, 1.0), "cpu")
    state = adamw_init(params, cfg)
    before = [t.clone() for t in tree_leaves((params, state))]
    p1, s1, m1 = adamw_update(params, grads, state, cfg, 0.5)
    for a, b in zip(before, tree_leaves((params, state))):
        assert torch.equal(a, b)
    p2, s2, m2 = adamw_update(params, grads, state, cfg, 0.5, inplace=True)
    assert p2["w"] is params["w"] and s2["m"]["w"] is state["m"]["w"]
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        np.testing.assert_array_equal(_torch_bits(a), _torch_bits(b))
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])


def test_adamw_init_master_is_a_copy(rng):
    params = params_from_numpy(_param_tree(rng), "cpu")
    params["w"] = params["w"].to(torch.bfloat16)
    state = adamw_init(params, AdamWConfig())
    assert state["master"]["w"].dtype == torch.float32
    assert state["master"]["b"].data_ptr() != params["b"].data_ptr()
    assert all(t.dtype == torch.float32 and not t.any() for t in tree_leaves((state["m"], state["v"])))
    assert "master" not in adamw_init(params, AdamWConfig(use_master=False))


def test_global_norm_in_reference_order(rng):
    tree = {"z": rng.standard_normal((7, 5)).astype(np.float32),
            "a": [rng.standard_normal((33,)).astype(np.float32), {"y": rng.standard_normal((2, 9)).astype(np.float32),
                                                                   "b": rng.standard_normal((4,)).astype(np.float32)}]}
    t = params_from_numpy(tree, "cpu")
    assert [x.shape for x in jax.tree.leaves(tree)] == [tuple(x.shape) for x in tree_leaves(t)]
    with jax.disable_jit():
        want = np.asarray(j_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm(t)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 2**-20 * float(want)
