"""The port's model layers against `repro`'s:

* `apply_linear` and `apply_mlp` under `GemmPolicy(backend="ozaki2_f32",
  n_moduli=8)` on the `reference` and `kernel` executions (the reference
  runs its Pallas kernels in interpret mode, the port their plain
  versions): **bitwise**, float32 and bfloat16 inputs, with bias.  The one
  exception is an MLP whose activation calls `tanh` or `exp` in float32
  (swiglu, geglu, gelu): XLA and torch round those in the last ulp, so the
  activations differ and the MLP is held within 1e-5 x max|y| (each
  emulated product in it is bitwise, as `apply_linear` shows).  In
  bfloat16 the port computes GELU and SiLU op by op with the reference's
  bfloat16 constants, and every MLP is bitwise.

Models, shapes and initialisation: `tests/test_torch_model_shapes.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import phi_matrix

from repro.core.policy import GemmPolicy as JPolicy
from repro.models import layers as j_layers
from repro_torch.interop import params_from_numpy, policy_from_fields
from repro_torch.models import layers

B = 2
D = 32  # every layer test's width: one shape, so the reference compiles its ops once
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy float32 (exact for bfloat16 and float32)."""
    return t.float().numpy()


def _policies(execution):
    jpol = JPolicy(backend="ozaki2_f32", n_moduli=8, execution=execution, interpret=True)
    return jpol, policy_from_fields(dataclasses.asdict(jpol))


def _linear_params(rng, d_in, d_out, dtype):
    w = phi_matrix(rng, (d_in, d_out), 0.5, np.float32)
    b = (rng.standard_normal(d_out) * 0.1).astype(np.float32)
    jp = {"w": jnp.asarray(w, JDT[dtype]), "b": jnp.asarray(b, JDT[dtype])}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


LAYER_CASES = [(ex, dt) for ex in ("reference", "kernel") for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("execution,dtype", LAYER_CASES, ids=["-".join(c) for c in LAYER_CASES])
def test_apply_linear_bitwise(rng, execution, dtype):
    jpol, tpol = _policies(execution)
    jp, tp = _linear_params(rng, D, D, dtype)
    x = phi_matrix(rng, (B, 4, D), 0.5, np.float32)
    want = np.asarray(j_layers.apply_linear(jp, jnp.asarray(x, JDT[dtype]), jpol), np.float32)
    got = layers.apply_linear(tp, torch.from_numpy(x).to(TDT[dtype]), tpol)
    assert got.dtype == TDT[dtype] and got.shape == (B, 4, D)
    np.testing.assert_array_equal(_np_bits(got), want)


# every kind on the reference execution; on the kernel execution (the
# reference's interpret-mode kernels are slow) one gated and one plain kind
MLP_CASES = [(kind, ex, dt) for kind in ("swiglu", "geglu", "gelu", "sq_relu")
             for ex in ("reference", "kernel") for dt in ("float32", "bfloat16")
             if ex == "reference" or kind in ("geglu", "sq_relu")]


@pytest.mark.parametrize("kind,execution,dtype", MLP_CASES, ids=["-".join(c) for c in MLP_CASES])
def test_apply_mlp(rng, kind, execution, dtype):
    jpol, tpol = _policies(execution)
    names = ("gate", "up", "down") if kind in ("swiglu", "geglu") else ("up", "down")
    jp, tp = {}, {}
    for name in names:
        jp[name], tp[name] = _linear_params(rng, D, D, dtype)
    x = phi_matrix(rng, (B, 4, D), 0.5, np.float32)
    want = np.asarray(j_layers.apply_mlp(kind, jp, jnp.asarray(x, JDT[dtype]), jpol), np.float32)
    got = _np_bits(layers.apply_mlp(kind, tp, torch.from_numpy(x).to(TDT[dtype]), tpol))
    if dtype == "float32" and kind != "sq_relu":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
