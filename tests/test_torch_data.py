"""The port's data pipeline, fault guards and train CLI on the CPU.

* `SyntheticLM` (`repro_torch.data`): tokens bitwise equal to the
  reference's for every (seed, step, num_shards, shard) tried; no
  tolerance, it is the same numpy code.
* `make_batch_specs`: the reference's shapes as int32 tensors on the
  "meta" device.
* `PreemptionGuard` and `StragglerWatch` (`repro_torch.distributed`): the
  reference's two cases, and a real SIGTERM turning into a clean stop.
* `python -m repro_torch.launch.train` on ``--device cpu``: a run, a
  resumed run, and without a launcher ``--mesh`` raising, ``--execution
  sharded`` running in a world of one and ``--residue`` refused without
  it; without ``--device`` it asks for the card.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_batch_specs as j_make_batch_specs
from repro_torch.data import DataConfig, SyntheticLM, make_batch_specs
from repro_torch.distributed import PreemptionGuard, StragglerWatch
from repro_torch.launch import train as train_cli
from test_torch_train import one_thread  # noqa: F401  (autouse fixture: small models on one thread)

DATA_CASES = [  # (vocab, seq_len, global_batch, seed, num_shards)
    (128, 16, 8, 5, 1),
    (128, 16, 8, 5, 4),
    (512, 33, 6, 0, 3),
    (50280, 64, 4, 7, 2),
]


@pytest.mark.parametrize("vocab,seq,batch,seed,shards", DATA_CASES)
def test_synthetic_lm_bitwise(vocab, seq, batch, seed, shards):
    for shard in range(shards):
        want_src = JSyntheticLM(JDataConfig(vocab, seq, batch, seed), num_shards=shards, shard=shard)
        got_src = SyntheticLM(DataConfig(vocab, seq, batch, seed), num_shards=shards, shard=shard)
        for step in (0, 1, 7, 1000):
            want, got = want_src.batch(step)["tokens"], got_src.batch(step)["tokens"]
            assert got.dtype == np.int32 and got.shape == (batch // shards, seq)
            np.testing.assert_array_equal(got, want, err_msg=f"shard {shard} step {step}")


def test_synthetic_lm_shards_and_refusal():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8, seed=5)
    again = SyntheticLM(cfg, num_shards=4, shard=2).batch(7)["tokens"]
    np.testing.assert_array_equal(SyntheticLM(cfg, num_shards=4, shard=2).batch(7)["tokens"], again)
    assert not np.array_equal(SyntheticLM(cfg, num_shards=4, shard=1).batch(7)["tokens"], again)
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(cfg, num_shards=3)


def test_make_batch_specs_on_meta():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8)
    want = j_make_batch_specs(JDataConfig(128, 16, 8))["tokens"]
    got = make_batch_specs(cfg)["tokens"]
    assert got.device.type == "meta" and got.dtype == torch.int32
    assert tuple(got.shape) == tuple(want.shape)


def test_preemption_guard_flag():
    with PreemptionGuard() as g:
        assert not g.should_stop
        g._handler(None, None)
        assert g.should_stop


def test_preemption_guard_takes_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not g.should_stop and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g.should_stop
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_watch():
    w = StragglerWatch(threshold=5.0)
    for s in range(3):
        w.step_begin()
        time.sleep(0.01)
        w.step_end(s)
    w.step_begin()
    time.sleep(0.2)
    assert w.step_end(3) is True
    assert w.flagged and w.flagged[0][0] == 3


CLI = ["--arch", "mamba2-130m", "--batch", "2", "--seq", "16", "--device", "cpu"]


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    assert train_cli.main(CLI + ["--steps", "10", "--ckpt-dir", str(tmp_path)]) == 0
    first = capsys.readouterr().out
    assert "step     0 loss" in first and "[mamba2-130m] loss" in first
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10"]  # ckpt_every = max(10, steps // 4)
    assert train_cli.main(CLI + ["--steps", "12", "--ckpt-dir", str(tmp_path)]) == 0
    second = capsys.readouterr().out.splitlines()
    assert second[0] == f"[resume] restored step 10 from {tmp_path}"
    assert [line.split()[1] for line in second if line.startswith("step ")] == ["10", "11"]


@pytest.mark.parametrize("flags,error", [
    (["--mesh", "2x2"], (SystemExit, "2")),
    (["--mesh", "1x1"], None),
    (["--execution", "sharded", "--backend", "ozaki2_f32"], None),
    (["--residue", "2"], (SystemExit, "2")),
], ids=["mesh", "mesh1x1", "sharded", "residue"])
def test_train_cli_one_card_flags_raise(flags, error, capsys):
    """Without a launcher: a --mesh of more ranks than the run has (a world
    of one) is refused, --mesh 1x1 trains on that world (4 ranks:
    test_torch_mesh_train); --execution sharded runs in a world of one (2
    ranks: test_torch_sharded_models); --residue without it is
    refused."""
    if error is None:
        assert train_cli.main(CLI + ["--steps", "1"] + flags) == 0
        assert "[mamba2-130m] loss" in capsys.readouterr().out
        return
    with pytest.raises(error[0], match=error[1]):
        train_cli.main(CLI + ["--steps", "1"] + flags)


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "mamba2-130m", "--steps", "1"])
