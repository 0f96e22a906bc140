"""Parity of the port's sharded execution (`GemmPolicy(execution="sharded")`,
`repro_torch.distributed`) with the reference's kernel execution.

The reference's own sharded execution cannot run under the installed JAX
(`shard_map` no longer takes `check_rep`), and it asserts that it is
bitwise equal to its `kernel` execution on every mesh.  So the port's
sharded output, computed by gloo ranks on the CPU (`torch_ranks.RankPool`,
one pool of 8 for the module, each task's mesh over its first ranks), is
held bitwise against the reference's ``execution="kernel",
interpret=True`` in this process and against the port's own `kernel`:
the 4 dtypes on the reference's meshes, accurate mode, the complex
formulations, output-column blocks, indivisible dims, the f64 flavour,
the backward, `fused` under a mesh.  The collective log shows what
crosses ranks: f64 sums, int32 maxima, output blocks; never int8.
Tolerance: none.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro
from repro.core.policy import BACKEND_FOR_DTYPE
from repro.core.policy import GemmPolicy as JPolicy
from repro.distributed.sharding import resolve_gemm_axes as j_resolve
import torch_ranks
from repro_torch import GemmPolicy, linalg
from repro_torch.core import perfmodel
from repro_torch.core.policy import policy_matmul
from repro_torch.distributed import GemmShardAxes, resolve_gemm_axes
from repro_torch.distributed.sharding import residue_plane_specs
from repro_torch.launch.mesh import production_mesh_shape

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
N_MODULI = {"float32": 5, "float64": 6, "complex64": 5, "complex128": 6}
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2), (1, 1, 8)]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = torch_ranks.RankPool(8, str(tmp_path_factory.mktemp("ranks") / "store"))
    yield p
    p.close()


def _fields(dtype, **kw):
    name = np.dtype(dtype).name
    kw.setdefault("n_moduli", N_MODULI[name])
    return {"backend": BACKEND_FOR_DTYPE[name], **kw}


def _operands(rng, dtype, m=FAST_M, n=FAST_N):
    return phi_matrix(rng, (m, FAST_K), 0.5, dtype), phi_matrix(rng, (FAST_K, n), 0.5, dtype)


def _kernel(a, b, fields):
    """(reference kernel, port kernel) outputs of a @ b, as numpy."""
    want = np.asarray(repro.linalg.matmul(jnp.asarray(a), jnp.asarray(b),
                                          policy=JPolicy(**fields, execution="kernel", interpret=True)))
    got = linalg.matmul(a, b, policy=GemmPolicy(**fields, execution="kernel"), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    return want


def _on_mesh(results, shape):
    """The results of the mesh's ranks (the others returned None)."""
    size = int(np.prod(shape))
    assert all(r is None for r in results[size:])
    return results[:size]


def _sharded(pool, shape, a, b, fields):
    """Every mesh rank's sharded output, and rank 0's collective log."""
    out = _on_mesh(pool.run(torch_ranks.sharded_matmul, shape, a, b, {**fields, "execution": "sharded"}), shape)
    return [y for y, _ in out], out[0][1]


def _check_log(log, out_dtype, mode):
    """Only f64 sums, int32 maxima (accurate mode) and output-dtype
    broadcasts; no int8 array."""
    for op, dt, _, _ in log:
        assert dt != "torch.int8", log
        want = {"sum": "torch.float64", "max": "torch.int32", "broadcast": f"torch.{np.dtype(out_dtype).name}"}[op]
        assert dt == want, log
        assert op != "max" or mode == "accu", log


@pytest.mark.parametrize("meshdims", MESHES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_multi_mesh_bitwise(pool, rng, dtype, meshdims):
    """Every mesh reproduces the kernel output bit for bit: residue-split
    (N = 5/6 planes over 2 or 8 ranks: short and empty chunks), m/n-split,
    and both."""
    a, b = _operands(rng, dtype)
    want = _kernel(a, b, _fields(dtype))
    outs, log = _sharded(pool, meshdims, a, b, _fields(dtype))
    for y in outs:
        np.testing.assert_array_equal(y, want)
    _check_log(log, dtype, "fast")
    md, nd, r = meshdims
    assert [op for op, *_ in log] == ["sum"] * (r > 1) + ["broadcast"] * (nd * (nd > 1) + md * (md > 1))


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_sharded_accu_multi_mesh_bitwise(pool, rng, dtype):
    """Accurate mode on (2, 2, 2): the int32 MAX of the bound maxima gives
    the whole product's exponents."""
    a, b = _operands(rng, dtype)
    want = _kernel(a, b, _fields(dtype, mode="accu"))
    outs, log = _sharded(pool, (2, 2, 2), a, b, _fields(dtype, mode="accu"))
    for y in outs:
        np.testing.assert_array_equal(y, want)
    _check_log(log, dtype, "accu")
    assert [op for op, *_ in log].count("max") == 2  # row maxima over model, column maxima over data


@pytest.mark.parametrize("mode", ["fast", "accu"])
@pytest.mark.parametrize("formulation", ["karatsuba", "block_a", "block_b"])
def test_sharded_formulations_bitwise(pool, rng, formulation, mode):
    """The three complex strategies compose through the rank's chunk: the
    block embeddings from its residue products, Karatsuba from the fused
    kernel on its chunk's moduli."""
    a, b = _operands(rng, np.complex64)
    fields = _fields(np.complex64, formulation=formulation, mode=mode)
    want = _kernel(a, b, fields)
    for y in _sharded(pool, (1, 1, 2), a, b, fields)[0]:
        np.testing.assert_array_equal(y, want)


def test_sharded_n_block_bitwise(pool, rng):
    """Output-column blocks: every block's partials go into ONE all-reduce."""
    a, b = _operands(rng, np.float32)
    want = _kernel(a, b, _fields(np.float32, n_block=8))
    outs, log = _sharded(pool, (1, 1, 2), a, b, _fields(np.float32, n_block=8))
    for y in outs:
        np.testing.assert_array_equal(y, want)
    parts = perfmodel.crt_partial_parts(5)
    assert log == [("sum", "torch.float64", (parts * FAST_M * FAST_N,), "residue")]


def test_sharded_indivisible_dims_drop_to_replicated(pool, rng):
    a, b = _operands(rng, np.float32, m=FAST_M + 1, n=FAST_N + 1)  # 33, 25: odd
    want = _kernel(a, b, _fields(np.float32))
    outs, log = _sharded(pool, (2, 2, 2), a, b, _fields(np.float32))
    for y in outs:
        np.testing.assert_array_equal(y, want)
    assert [op for op, *_ in log] == ["sum"]  # no block to gather


def test_sharded_reference_inner_bitwise(pool, rng):
    """`ShardedBackend(REFERENCE, mesh)`: the f64 flavour, its products and
    Karatsuba with exact mods by the chunk's moduli, bitwise the
    reference's unsharded `run_plan(plan, x, w, REFERENCE)`."""
    from repro.core.executor import REFERENCE as J_REFERENCE
    from repro.core.executor import run_plan as j_run_plan
    from repro.core.plan import make_plan as j_make_plan

    for dtype in (np.float32, np.complex64):
        a, b = _operands(rng, dtype)
        kw = {"n_moduli": 5, "method": "garner",
              "formulation": "karatsuba" if np.issubdtype(dtype, np.complexfloating) else None}
        want = np.asarray(j_run_plan(j_make_plan(dtype, **kw), jnp.asarray(a), jnp.asarray(b), J_REFERENCE))
        for y in _on_mesh(pool.run(torch_ranks.reference_inner, (1, 1, 2), a, b, kw), (1, 1, 2)):
            np.testing.assert_array_equal(y, want)


def test_no_int8_crosses_the_mesh(pool, rng):
    """Fast and accurate mode on a residue mesh and on (2, 2, 2): the log
    holds the f64 partial sums (and int32 maxima, output broadcasts), no
    int8 array."""
    a, b = _operands(rng, np.complex64)
    for shape in ((1, 1, 2), (2, 2, 2)):
        for mode in ("fast", "accu"):
            _, log = _sharded(pool, shape, a, b, _fields(np.complex64, mode=mode))
            assert any(op == "sum" and dt == "torch.float64" for op, dt, *_ in log)
            _check_log(log, np.complex64, mode)


def test_collective_safety_certifies_every_rank(pool, rng):
    """The analysis's collective-safety pass over each rank's trace: no
    finding on (1, 1, 2) in fast mode or on (2, 1, 2) in accurate mode,
    with the f64 SUM of the partials (and in accurate mode the int32 MAX
    of the bound maxima) present; the same records with a hand-made int8
    collective added are flagged."""
    from repro_torch.analysis import Collective, CollectiveSafetyPass, Trace

    for dtype, mode, shape in ((np.float32, "fast", (1, 1, 2)), (np.complex128, "accu", (2, 1, 2))):
        a, b = _operands(rng, dtype)
        fields = {**_fields(dtype, mode=mode), "execution": "sharded"}
        for findings, colls in _on_mesh(pool.run(torch_ranks.traced_collectives, shape, a, b, fields), shape):
            assert findings == []
            assert ("sum", "torch.float64") in colls
            assert (mode == "accu") == (("max", "torch.int32") in colls)
        tr = Trace()
        tr.collectives = [Collective(op, getattr(torch, dt.removeprefix("torch.")), (1,), "residue")
                          for op, dt in colls + [("sum", "torch.int8")]]
        flagged = CollectiveSafetyPass().run(tr)
        assert len(flagged) == 1 and "int8 array crosses the mesh via `sum`" in flagged[0].message


def test_sharded_grad_matches_kernel(pool, rng):
    """The backward's products run sharded too (the scope's mesh pinned at
    the forward, `backward` called outside it): y, dX and dW bitwise the
    kernel execution's."""
    a, b = _operands(rng, np.float32)
    fields = _fields(np.float32)
    x, w = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y = linalg.matmul(x, w, policy=GemmPolicy(**fields, execution="kernel"), device="cpu")
    (y * y).sum().backward()
    want = (y.detach().numpy(), x.grad.numpy(), w.grad.numpy())
    for got in _on_mesh(pool.run(torch_ranks.sharded_grads, (1, 1, 2), a, b, {**fields, "execution": "sharded"}),
                        (1, 1, 2)):
        for g, k in zip(got, want):
            np.testing.assert_array_equal(g, k)


@pytest.mark.parametrize("meshdims", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_fused_multi_mesh_bitwise(pool, rng, dtype, meshdims):
    """`fused` under a mesh: on m/n-only meshes each rank runs the
    megakernel once on its block; a residue-split mesh takes the composed
    kernels with the two-phase all-reduce.  Both bitwise the kernel's."""
    a, b = _operands(rng, dtype)
    want = _kernel(a, b, _fields(dtype))
    out = _on_mesh(pool.run(torch_ranks.fused_calls, meshdims, a, b, {**_fields(dtype), "execution": "fused"}),
                   meshdims)
    for y, calls in out:
        np.testing.assert_array_equal(y, want)
        assert calls == (1 if meshdims[2] == 1 else 0)


def test_sharded_needs_a_mesh_and_scopes(pool, rng):
    """"needs a mesh" without one; `use_mesh` thread-local and nested;
    `use_policy(policy, mesh=...)`; prepared weights refused under
    `sharded` and under `fused` with a mesh."""
    a, b = _operands(rng, np.float32)
    with pytest.raises(ValueError, match="needs a mesh"):
        policy_matmul(torch.from_numpy(a), torch.from_numpy(b), GemmPolicy(**_fields(np.float32), execution="sharded"))
    want = _kernel(a, b, _fields(np.float32))
    for scoped, both in pool.run(torch_ranks.policy_surface, a, b)[:2]:
        np.testing.assert_array_equal(scoped, want)
        np.testing.assert_array_equal(both, want)


def _fake_meshes(shape, names):
    """The same dims as a reference mesh and as a port mesh, for the axis
    rules (which read only names and sizes)."""
    j = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    t = types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape))
    return j, t


@pytest.mark.parametrize("shape,names", [((1, 1, 1), ("data", "model", "residue")), ((1, 1), ("data", "model")),
                                         ((2, 2, 2), ("data", "model", "residue")), ((2, 4), ("data", "model")),
                                         ((2, 2, 2, 2), ("pod", "data", "model", "residue"))])
def test_resolve_gemm_axes_rules(shape, names):
    """`resolve_gemm_axes` as the reference's on the same dim names and
    sizes: the residue fallback to model, the size-aware drops, overrides."""
    jm, tm = _fake_meshes(shape, names)
    hints = [(None, None), (32, 24), (33, 24), (32, 25), (33, 25)]
    overrides = [None, (None, None, "model"), ("data", None, None), (None, "data", "model")]
    for (m, n), over in ((h, o) for h in hints for o in overrides):
        want = j_resolve(jm, m, n, over)
        assert dataclasses.astuple(resolve_gemm_axes(tm, m, n, over)) == (want.residue, want.m, want.n)
    with pytest.raises(ValueError, match="not on mesh"):
        resolve_gemm_axes(tm, overrides=("missing", None, None))
    with pytest.raises(ValueError, match="at most once"):
        resolve_gemm_axes(tm, overrides=("model", None, "model"))
    specs = residue_plane_specs(resolve_gemm_axes(tm))
    assert specs["a_residues"][0] == resolve_gemm_axes(tm).residue
    assert "residue" not in specs["partial"] + specs["out"]
    assert resolve_gemm_axes(tm) == GemmShardAxes(*(dataclasses.astuple(j_resolve(jm))))


def test_sharded_plan_prices_communication(pool):
    """`plan_for` prices each rank's block plus the all-reduce term, as the
    reference's plan_for does: the reference's `make_plan` at the shard
    shape with its `sharded_comm_time_s` picks the same plan."""
    from repro.core import perfmodel as j_perfmodel
    from repro.core.plan import make_plan as j_make_plan
    from repro.kernels.ops import KernelBackend as JKernelBackend

    m, k, n = 4096, 4096, 4096
    be = JKernelBackend(True)
    for shape, dtype, n_block in [((1, 1, 2), np.complex64, "auto"), ((2, 2, 2), np.complex128, "auto"),
                                  ((1, 1, 8), np.complex64, None)]:
        md, nd, r = shape
        fields = _fields(dtype, formulation="auto", n_block=n_block)
        want = j_make_plan(
            dtype, n_moduli=fields["n_moduli"], method="garner", formulation="auto", n_block=n_block,
            shape=(m // md, k, n // nd), fused_karatsuba=be.fused_karatsuba, modulus_batched=be.modulus_batched,
            comm_s=j_perfmodel.sharded_comm_time_s(m // md, n // nd, fields["n_moduli"], r, complex_=True))
        got = _on_mesh(pool.run(torch_ranks.plan_fields, shape, {**fields, "execution": "sharded"}, m, k, n),
                       shape)
        assert all(g == (want.formulation, want.n_block, want.ctx.n, want.mode) for g in got), (got, want)
    assert perfmodel.sharded_comm_time_s(256, 256, 8, 1) == 0.0
    assert perfmodel.sharded_comm_time_s(256, 256, 8, 8) > perfmodel.sharded_comm_time_s(256, 256, 8, 2)


def test_production_mesh_shapes():
    """The reference's production shapes and its refusal of a residue that
    does not divide 16; the mesh itself needs a world of its size."""
    from repro.launch.mesh import make_production_mesh as j_make_production_mesh

    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert production_mesh_shape(residue=4) == ((16, 4, 4), ("data", "model", "residue"))
    assert production_mesh_shape(multi_pod=True, residue=2) == ((2, 16, 8, 2), ("pod", "data", "model", "residue"))
    for kw in ({"residue": 3}, {"multi_pod": True, "residue": 5}):
        with pytest.raises(ValueError, match="must divide") as want:
            j_make_production_mesh(**kw)
        with pytest.raises(ValueError, match="must divide") as got:
            production_mesh_shape(**kw)
        assert str(got.value) == str(want.value)


def test_mesh_calls_on_ranks(pool):
    """In a group of 8: host meshes clamped to the world as the reference
    clamps them to its devices, the production mesh refused (256 ranks
    needed), the all-reduce calibration measured (positive bandwidth and
    latency)."""
    want = [((1, 1, 8), ("data", "model", "residue")), ((2, 4), ("data", "model")), ((8, 1), ("data", "model")),
            ((2, 2, 2), ("data", "model", "residue"))]
    assert pool.run(torch_ranks.mesh_builders) == [want] * 8
    for bw, t in pool.run(torch_ranks.measure_psum):
        assert bw > 0 and t > 0
