"""The layers above the sharded execution, run by 2 gloo ranks on the CPU
(`torch_ranks.RankPool`, one pool for the module): a model built under a
sharded `use_policy` serves the same tokens and logits as under the
kernel execution (the reference's `tests/test_sharded.py` model), and the
serve and train CLIs with ``--execution sharded --residue 2`` give the
tokens and every step's loss of ``--execution kernel``, rank 0 alone
printing.  Tolerance: none.
"""
import numpy as np
import pytest

import torch_ranks

SERVE = ["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--batch", "1", "--prompt-len", "8",
         "--new-tokens", "2", "--device", "cpu"]
TRAIN = ["--arch", "mamba2-130m", "--backend", "ozaki2_f32", "--steps", "3", "--batch", "2", "--seq", "16",
         "--device", "cpu"]
SHARDED = ["--execution", "sharded", "--residue", "2"]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = torch_ranks.RankPool(2, str(tmp_path_factory.mktemp("ranks") / "store"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def one_thread():
    """This process's side on one intra-op thread, as the ranks run."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sharded_model_generates_like_kernel(pool):
    """A `ModelConfig` built under a sharded `use_policy` pins it; the
    engine on each rank serves the kernel engine's tokens and logits."""
    want_tok, want_logits = torch_ranks.serve_tiny(None, "kernel")
    for tok, logits in pool.run(torch_ranks.serve_tiny, (1, 1, 2), "sharded"):
        np.testing.assert_array_equal(tok, want_tok)
        np.testing.assert_array_equal(logits, want_logits)


def test_serve_cli_sharded_like_kernel(pool):
    rc, out, want = torch_ranks.serve_cli(SERVE + ["--execution", "kernel"])
    assert rc == 0 and "[starcoder2-3b] (1, 2) in" in out
    got = pool.run(torch_ranks.serve_cli, SERVE + SHARDED)
    for rank, (rc, out, toks) in enumerate(got):
        assert rc == 0
        assert ("[starcoder2-3b] (1, 2) in" in out) == (rank == 0)  # rank 0 alone prints
        np.testing.assert_array_equal(toks[0], want[0])


def test_train_cli_sharded_like_kernel(pool):
    rc, out, want = torch_ranks.train_cli(TRAIN + ["--execution", "kernel"])
    assert rc == 0 and len(want) == 3
    for rank, (rc, out, hist) in enumerate(pool.run(torch_ranks.train_cli, TRAIN + SHARDED)):
        assert rc == 0
        assert hist == want  # every step's loss, bitwise
        assert ("[mamba2-130m] loss" in out) == (rank == 0)


def test_train_step_refuses_a_parameter_mesh(pool):
    """A policy pinned to a mesh whose data dim is 2 would mix the data
    ranks' batch rows in its products: the mesh step refuses it.  The same
    mesh with the policy unpinned trains (`tests/test_torch_mesh_train.py`)
    and returns the reference's three sharding trees."""
    assert pool.run(torch_ranks.train_step_mesh_refused) == [["batch", "opt", "params"]] * 2
