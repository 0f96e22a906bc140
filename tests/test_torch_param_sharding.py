"""The training mesh's parameter rules, gradient compression, elastic
restore and the GPipe pipeline of the port (`repro_torch.distributed`)
against the reference's.

* The rules: `pspec_for_axes`, `tree_pspecs` of every arch's published and
  reduced params, `optimizer_spec` of each leaf and `batch_pspec` equal the
  reference's, leaf by leaf, on eight mesh shapes (the reference on
  `jax.sharding.AbstractMesh`, the port on its `AbstractMesh`; neither
  needs devices or ranks), the size-aware drops and ZeRO-1's fall-through
  included.  No tolerance.
* The rest runs on gloo ranks (`torch_ranks.RankPool`, a pool of 4 for
  the module):
  - `error_feedback_psum` over 2 and 4 ranks is bitwise the reference's
    under `jax.vmap(..., axis_name="data")` over the stacked grads, op by
    op; and the reference's own two-round check holds;
  - params saved from a (2, 2) mesh and `elastic_restore`d onto (2, 1),
    and a checkpoint the reference wrote restored onto (2, 2): each rank's
    blocks are bitwise the saved arrays' blocks under the reference's specs;
  - `pipeline_loss` on pp = 2 and 4 (reduced qwen2.5-32b cut to 4 layers,
    float32, 4 microbatches, as `tests/test_pipeline.py`): the loss within
    1e-5 of the port's sequential `Model.loss` and the grads within
    max(1e-5, 1e-3 max|g|) (that test's bounds); the sequential loss
    within LOSS_RTOL of the reference's `model.loss`.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from conftest import SEED

import repro  # noqa: F401  (x64, as the reference runs)
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.distributed.compression import error_feedback_psum as j_error_feedback_psum
from repro.distributed.sharding import DEFAULT_RULES as J_RULES
from repro.distributed.sharding import batch_pspec as j_batch_pspec
from repro.distributed.sharding import optimizer_spec as j_optimizer_spec
from repro.distributed.sharding import pspec_for_axes as j_pspec_for_axes
from repro.distributed.sharding import pspec_for_meta as j_pspec_for_meta
from repro.distributed.sharding import tree_pspecs as j_tree_pspecs
from repro.models import Model as JModel
from repro.models.params import _map_like as j_map_like
import torch_ranks
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.distributed import (
    DEFAULT_RULES,
    AbstractMesh,
    batch_pspec,
    optimizer_spec,
    pspec_for_axes,
    tree_pspecs,
)
from repro_torch.distributed.sharding import pspec_for_meta
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.models import Model
from repro_torch.models.params import _map_like
from repro_torch.tree import tree_leaves
from test_torch_train import LOSS_RTOL

# (sizes, names): the unit meshes, a production pod, a residue split and two pods
MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((16, 8, 2), ("data", "model", "residue")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = torch_ranks.RankPool(4, str(tmp_path_factory.mktemp("ranks") / "store"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def one_thread():
    """This process's side on one intra-op thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(sizes, names):
    return JAbstractMesh(sizes, names), AbstractMesh(sizes, names)


def _spec(jspec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(jspec)


# ------------------------------------------------------------------ the rules


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_pspec_for_axes_and_batch_match_reference(sizes, names):
    """The reference's `test_pspec_resolution_rules` cases and the size-aware
    drops, on each mesh: every logical axis alone, at a size every mesh dim
    divides and at one none does; precedence inside one tensor."""
    jm, m = _meshes(sizes, names)
    cases = [(("vocab", "embed"), None), (("experts",), (40,)), (("experts", "embed", "ff"), None),
             (("experts", "embed", "ff"), (64, 128, 256)), (("layers", "ff", "embed"), (4, 12, 8)),
             (("batch", "seq"), (64, 32)), (("batch", "seq"), (6, 32)), (("kv_seq", "kv_heads"), (4096, 3))]
    cases += [((axis,), shape) for axis in J_RULES for shape in (None, (4096,), (7,))]
    for axes, shape in cases:
        want = _spec(j_pspec_for_axes(axes, J_RULES, jm, shape))
        assert pspec_for_axes(axes, DEFAULT_RULES, m, shape) == want, (axes, shape)
    assert batch_pspec(m) == _spec(j_batch_pspec(jm))
    assert DEFAULT_RULES == J_RULES


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
def test_tree_and_optimizer_specs_match_reference(sizes, names):
    """`tree_pspecs` and each leaf's ZeRO-1 `optimizer_spec` for the ten
    archs' published and reduced params, leaf by leaf."""
    jm, m = _meshes(sizes, names)
    for arch in ARCHS:
        for j_get, get in ((j_get_config, get_config), (j_get_reduced, get_reduced)):
            jabs, abstract = JModel(j_get(arch)).abstract_params(), Model(get(arch)).abstract_params()
            want = _flat_specs(j_map_like(jabs, lambda _, meta: (
                _spec(j_pspec_for_meta(meta, J_RULES, jm)),
                _spec(j_optimizer_spec(j_pspec_for_meta(meta, J_RULES, jm), meta.shape, jm)))))
            got = _flat_specs(_map_like(abstract, lambda _, meta: (
                pspec_for_meta(meta, DEFAULT_RULES, m),
                optimizer_spec(pspec_for_meta(meta, DEFAULT_RULES, m), meta.shape, m))))
            assert got == want, arch
            assert _flat_specs(tree_pspecs(abstract, DEFAULT_RULES, m)) == [w[0] for w in want]


def _flat_specs(tree):
    """The leaves of a tree of dicts and lists in leaf order (a spec, a
    tuple, is a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat_specs(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _flat_specs(v)]
    return [tree]


def test_optimizer_spec_zero1():
    """The reference's `test_optimizer_spec_zero1`, its 2-way data mesh
    re-built with jax 0.9's `AbstractMesh(axis_sizes, axis_names)` (its
    own case fails on the old signature): 'data' on the first free dim,
    falling through an indivisible dim to the next; a spec that uses
    'data' already, or no dim 'data' divides, stays."""
    for sizes in ((1, 1), (2, 1), (4, 2)):
        jm, m = _meshes(sizes, ("data", "model"))
        for spec, shape in (((None, "model"), (64, 128)), ((None, None), (3, 64)), ((None,), (3,)),
                            (("data", None), (64, 64)), ((), (8, 8)), (("model", None, None), (4, 6, 8))):
            want = _spec(j_optimizer_spec(jax.sharding.PartitionSpec(*spec), shape, jm))
            assert optimizer_spec(spec, shape, m) == want, (sizes, spec, shape)
    jm, m = _meshes((2, 1), ("data", "model"))
    assert optimizer_spec((None, None), (3, 64), m) == (None, "data") == _spec(
        j_optimizer_spec(jax.sharding.PartitionSpec(None, None), (3, 64), jm))
    assert optimizer_spec((None, "model"), (64, 128), AbstractMesh((1, 1), ("data", "model"))) == ("data", "model")
    assert optimizer_spec((None,), (4,), AbstractMesh((2,), ("model",))) == (None,)  # no data dim


def test_named_sharding_placements():
    """A spec's placements: Shard(d) on each mesh dim that splits dim d, the
    batch's ('pod', 'data') both on dim 0; mesh dims out of the mesh's
    order refused."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import NamedSharding

    m = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert NamedSharding(m, (("pod", "data"), None)).placements == (Shard(0), Shard(0), Replicate())
    assert NamedSharding(m, (None, "model", "data")).placements == (Replicate(), Shard(2), Shard(1))
    assert NamedSharding(m, ()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        NamedSharding(m, (("data", "pod"),)).placements


# --------------------------------------------------------------- compression


@pytest.mark.parametrize("ranks", [2, 4])
def test_error_feedback_psum_bitwise_vmapped_reference(pool, ranks):
    """Each rank's mean and new error bitwise the reference's under
    `jax.vmap(..., axis_name="data")` (op by op), from zero and from
    non-zero error buffers, a float32 and a bfloat16 grad."""
    rng = np.random.default_rng(SEED)
    for dtype in ("float32", "bfloat16"):
        g = (rng.standard_normal((ranks, 64)) * np.exp(rng.standard_normal((ranks, 1)))).astype(np.float32)
        for errs in (np.zeros((ranks, 64), np.float32), (rng.standard_normal((ranks, 64)) * 1e-2).astype(np.float32)):
            jg = jnp.asarray(g).astype(dtype)
            with jax.disable_jit():
                want_mean, want_err = jax.vmap(lambda x, e: j_error_feedback_psum(x, e, "data"),
                                               axis_name="data")(jg, jnp.asarray(errs))
            grads = params_from_numpy(np.asarray(jg), "cpu")
            out = _on_mesh(pool.run(torch_ranks.compressed_mean, (ranks,), ("data",), "data", grads, errs), ranks)
            for r, [(mean, err)] in enumerate(out):
                assert mean.dtype == grads.dtype
                _bitwise(mean, want_mean[r])
                _bitwise(err, want_err[r])


def test_error_feedback_two_rounds(pool):
    """The reference's `test_compressed_psum_subprocess` on 4 ranks: the
    mean within int8 accuracy of the true mean, and a second round with
    zero grads recovers the dropped mass."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    out = _on_mesh(pool.run(torch_ranks.compressed_mean, (4,), ("data",), "data", x, np.zeros_like(x), 2), 4)
    true = x.mean(0)
    for (m1, _), (m2, _) in out:
        q_err = float(np.abs(m1 - true).max())
        assert q_err < 0.05, q_err
        assert float(np.abs(m1 + m2 - true).max()) < q_err + 1e-6


# ------------------------------------------------------------------ elastic


ELASTIC_ARCH = "starcoder2-3b"


def _block(a, spec, sizes, names, coord):
    """Rank `coord`'s block of `a` under a reference spec (numpy)."""
    for d, entry in enumerate(spec):
        entry = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        size = math.prod(sizes[names.index(n)] for n in entry)
        if size > 1:
            index = 0
            for n in entry:
                index = index * sizes[names.index(n)] + coord[names.index(n)]
            step = a.shape[d] // size
            a = a[(slice(None),) * d + (slice(index * step, (index + 1) * step),)]
    return a


def _hold_blocks(results, arrays, jabstract, sizes, names):
    """Every rank's blocks bitwise `arrays`' blocks under the reference's
    specs on a mesh of `sizes`."""
    specs = jax.tree.leaves(j_tree_pspecs(jabstract, J_RULES, JAbstractMesh(sizes, names)),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for step, blocks, placements, coord in results:
        got = tree_leaves(blocks)
        assert len(got) == len(specs) == len(arrays)
        for b, a, spec in zip(got, arrays, specs):
            _bitwise(b, _block(a, tuple(spec), sizes, names, coord))
    return step


def test_elastic_restore_onto_a_smaller_mesh(pool, tmp_path):
    """Params placed on (2, 2), gathered and saved by rank 0, restored by
    `elastic_restore` onto (2, 1) (the reference's
    `test_elastic_reshard_subprocess`, 4 -> 2 ranks): each rank's blocks
    bitwise the saved arrays' blocks, the step the saved one."""
    from repro_torch.checkpoint import Checkpointer

    cfg = get_reduced(ELASTIC_ARCH, dtype="float32")
    assert all(r for r in pool.run(torch_ranks.save_params, (2, 2, 1), cfg, str(tmp_path), 42)[:4])
    model = Model(cfg)
    saved = tree_leaves(Checkpointer(str(tmp_path)).restore(42, model.param_shapes(), "cpu"))
    whole = tree_leaves(model.init(torch.Generator().manual_seed(1), device="cpu"))
    for a, b in zip(saved, whole):  # the gathered save is the one-process init
        _bitwise(a.numpy(), b.numpy())
    got = _on_mesh(pool.run(torch_ranks.elastic, (2, 1), cfg, str(tmp_path)), 2)
    jabstract = JModel(dataclasses.replace(j_get_reduced(ELASTIC_ARCH), dtype="float32")).abstract_params()
    assert _hold_blocks(got, [a.numpy() for a in saved], jabstract, (2, 1), ("data", "model")) == 42


def test_reference_checkpoint_restores_onto_a_mesh(pool, tmp_path):
    """A checkpoint the reference's `Checkpointer.save` wrote restores onto a
    port (2, 2) mesh, every rank's blocks bitwise the reference's arrays'."""
    jcfg = dataclasses.replace(j_get_reduced(ELASTIC_ARCH), dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    JCheckpointer(str(tmp_path)).save(7, jparams)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    got = _on_mesh(pool.run(torch_ranks.elastic, (2, 2), cfg, str(tmp_path)), 4)
    arrays = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    assert _hold_blocks(got, arrays, jmodel.abstract_params(), (2, 2), ("data", "model")) == 7


# ------------------------------------------------------------------ pipeline


PIPE_B, PIPE_S, PIPE_MICRO = 8, 32, 4


@pytest.fixture(scope="module")
def pipeline_case():
    """Reduced qwen2.5-32b, 4 layers, float32, the port's init: the weights,
    the tokens and the port's sequential loss and grads."""
    cfg = get_reduced("qwen2.5-32b", n_layers=4, dtype="float32", remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, (PIPE_B, PIPE_S)).astype(np.int32)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    from repro_torch.tree import unflatten

    with torch.enable_grad():
        loss, _ = model.loss(unflatten(params, leaves), {"tokens": torch.from_numpy(tokens)})
        grads = torch.autograd.grad(loss, leaves)
    return cfg, jax.tree.map(lambda t: t.numpy(), params), tokens, float(loss), [g.numpy() for g in grads]


def test_sequential_loss_matches_reference(pipeline_case):
    """The port's sequential loss from its weights against the reference's
    jitted `model.loss` from the same arrays, within LOSS_RTOL."""
    cfg, params, tokens, loss, _ = pipeline_case
    jmodel = JModel(dataclasses.replace(j_get_reduced("qwen2.5-32b"), n_layers=4, dtype="float32", remat=False))
    jparams = jax.tree.map(jnp.asarray, params)
    want = float(jax.jit(lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)})[0])(jparams))
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_matches_sequential(pool, pipeline_case, pp):
    """`pipeline_loss` over pp stages: every rank's loss within 1e-5 of the
    sequential one; the grads, each group leaf's stage block from its
    stage's rank and the other leaves from stage 0, within max(1e-5, 1e-3
    max|g|) (`tests/test_pipeline.py`'s bounds).  A rank's grads of the
    other stages' layer blocks are zeros."""
    cfg, params, tokens, loss, grads = pipeline_case
    out = _on_mesh(pool.run(torch_ranks.pipeline_grads, pp, cfg, params, tokens, PIPE_MICRO), pp)
    assert [o[1] for o in out] == list(range(pp))
    for got_loss, _, _ in out:
        assert abs(got_loss - loss) < 1e-5, (got_loss, loss)
    per = cfg.n_layers // pp
    names = [path for path, _ in _paths(params)]
    by_rank = [dict(_paths(o[2])) for o in out]
    for name, want in zip(names, grads):
        if name[0] == "groups":
            got = np.concatenate([by_rank[s][name][s * per:(s + 1) * per] for s in range(pp)])
            for s in range(pp):
                other = np.delete(by_rank[s][name], np.s_[s * per:(s + 1) * per], axis=0)
                assert not other.any(), name
        else:
            got = by_rank[0][name]
        d = float(np.abs(got - want).max())
        assert d <= max(1e-5, 1e-3 * float(np.abs(want).max())), (name, d)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, path + (i,))]
    return [(path, tree)]


# ------------------------------------------------------------------- helpers


def _on_mesh(results, size):
    assert all(r is None for r in results[size:])
    return results[:size]


def _bitwise(got, want):
    """Equal bits (a zero's sign counts): numpy arrays, JAX arrays (bfloat16
    through its bits) or torch tensors."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            x = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.int8}[x.element_size()]).numpy()
        x = np.asarray(x)
        return np.ascontiguousarray(x).view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])

    got, want = bits(got), bits(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
