"""Parity of the port's train step with the reference's on the `kernel`
execution, on the CPU: reduced mamba2-130m, float32, every linear on
`GemmPolicy(backend="ozaki2_f32", execution="kernel")` (the reference's
kernels in interpret mode, the port's plain versions), B = 8, S = 32.

The reference's step is jitted once, in this module's fixture
(`test_torch_train.reference`); tracing and compiling its interpreted
kernels is most of this file's time, which is why it is a file of its own
(``--dist loadfile`` gives it its own worker).  The tolerances are
`test_torch_train`'s, stated there.
"""
import dataclasses

import pytest
import torch

import repro_torch.core.policy as tpolicy
from repro_torch.models import Model
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_leaves
from test_torch_train import deterministic, hold_train_step, one_thread, reference  # noqa: F401  (fixtures; one_thread autouse)


@pytest.mark.parametrize("name", ["mamba2-130m-kernel"])
def test_train_step_matches_reference(reference, name):
    hold_train_step(reference(name), name)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_emulated_step_products_per_linear(reference, monkeypatch, deterministic, remat):
    """Each emulated linear runs 4 products a step with remat (forward,
    its recompute, dX, dW; 16 kernel launches on `kernel`) and 3 without;
    both give the same grads, bitwise."""
    r = reference("mamba2-130m-kernel")
    model = Model(dataclasses.replace(r.model.cfg, remat=remat))
    calls = []
    real = tpolicy._emulated_forward

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tpolicy, "_emulated_forward", counted)
    params, _ = r.port_state()
    _, _, grads = loss_and_grads(model, params, r.batch())
    linears = 2 * model.cfg.n_layers  # in_proj and out_proj of each SSD layer
    assert len(calls) == (4 if remat else 3) * linears
    monkeypatch.setattr(tpolicy, "_emulated_forward", real)
    _, _, other = loss_and_grads(Model(dataclasses.replace(r.model.cfg, remat=not remat)), params, r.batch())
    for a, b in zip(tree_leaves(grads), tree_leaves(other)):
        assert torch.equal(a, b)
