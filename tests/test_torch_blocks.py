"""The port's SSD, RG-LRU and MoE blocks (`repro_torch.models.blocks`)
against `repro.models.blocks`, function by function, on the CPU.

The same numpy inputs and weights, drawn from the suite's seed, go through
the reference's function and the port's.  Tolerances:

* bitwise: the causal conv (float32 and bfloat16: the same float32
  products summed in the same order) and the RG-LRU's linear scan against
  `jax.lax.associative_scan` (the port runs its recursion);
* float32: within 1e-5 x max|reference| (`F32_TOL`).  XLA and torch round
  `exp`, `cumsum`, `logaddexp`, the einsum sums and the means differently
  in the last ulps;
* bfloat16, against the reference's op-by-op run (`jax.disable_jit`; its
  compiled bfloat16 keeps float32 excess precision between fused ops):
  within 2^-7 x max|reference| (`BF16_TOL`), two bfloat16 roundings,
  since an ulp moved inside (a native bfloat16 product, a last-ulp `exp`)
  moves a rounded output by one bfloat16 ulp.

A routing comparison holds only where no token's k-th chosen and best
unchosen router logits lie within `ROUTE_MARGIN` of a tie, relative to
the bound |x| |router column| on how far a relative change of the input
moves them (`routing.RouteLog`; the inputs here agree to a few float32
ulps, 10x below it).  Nearer a tie, float32 rounding may pick other
experts and move that token's output by O(1).  Each MoE case asserts that
its data has no such token, or, for the tie case, builds exact ties that
both packages break to the lower index.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the reference runs)
from repro.configs import get_reduced as j_get_reduced
from repro.models import blocks as jb
from repro.models.params import ParamMeta as JParamMeta
from repro_torch.interop import model_config_from_fields, params_from_numpy
from repro_torch.models import blocks as tb
from repro_torch.models.routing import RouteLog

F32_TOL = 1e-5
BF16_TOL = 2.0**-7
ROUTE_MARGIN = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch, dtype="float32", **overrides):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=dtype, **overrides)
    return jcfg, model_config_from_fields(dataclasses.asdict(jcfg))


def _params(rng, abstract):
    """Random weights for a reference abstract tree: N(0, 1/fan-in) for a
    matrix, N(0, 0.5^2) for a vector, in each leaf's dtype; (jax, port)."""
    def draw(m):
        scale = m.shape[-2] ** -0.5 if len(m.shape) >= 2 else 0.5
        return jnp.asarray(rng.standard_normal(m.shape) * scale, m.dtype)

    jp = jax.tree.map(draw, abstract, is_leaf=lambda m: isinstance(m, JParamMeta))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x max|want| {scale:.3e}"


def _reference(fn, jcfg):
    """The reference's block function with its config bound: compiled in
    float32 (one compile instead of one per op), op by op in bfloat16,
    where the caller runs it under `jax.disable_jit`."""
    bound = functools.partial(fn, jcfg)
    return jax.jit(bound) if jcfg.dtype == "float32" else bound


def _x(rng, shape, dtype="float32"):
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(TDT[dtype])


# ------------------------------------------------------------ causal conv


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bitwise(rng, dtype, carry):
    jx, tx = _x(rng, (2, 9, 24), dtype)
    jw, tw = _x(rng, (4, 24), dtype)
    jbias, tbias = _x(rng, (24,), dtype)
    jc, tc = _x(rng, (2, 3, 24), dtype) if carry else (None, None)
    jy, jcarry = jb._causal_conv(jx, jw, jbias, jc)
    ty, tcarry = tb._causal_conv(tx, tw, tbias, tc)
    assert ty.dtype == TDT[dtype] and tcarry.dtype == TDT[dtype]
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tcarry), _np(jcarry))


# ------------------------------------------------------------ SSD


def test_segsum(rng):
    a = (rng.standard_normal((2, 3, 16)) * 0.3).astype(np.float32)
    want = np.asarray(jb._segsum(jnp.asarray(a)))
    got = tb._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want)) and np.isneginf(want).sum() == 2 * 3 * 120
    finite = np.isfinite(want)
    _close(got[finite], want[finite], F32_TOL, "segsum")


SCAN_CASES = [(16, 128, False), (32, 8, False), (32, 8, True)]  # (S, chunk, init_state)


@pytest.mark.parametrize("s,chunk,init", SCAN_CASES, ids=["chunk=s", "4chunks", "4chunks-init"])
def test_ssd_scan(rng, s, chunk, init):
    b, h, p, n = 2, 3, 8, 6
    xbar = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a_dt = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32)
    bmat, cmat = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    args = (xbar, a_dt, bmat, cmat, state)
    jy, jstate = jb.ssd_scan(*(None if a is None else jnp.asarray(a) for a in args), chunk)
    ty, tstate = tb.ssd_scan(*(None if a is None else torch.from_numpy(a) for a in args), chunk)
    _close(ty, jy, F32_TOL, "y")
    _close(tstate, jstate, F32_TOL, "final state")


def test_ssd_scan_refuses_a_partial_chunk():
    z = torch.zeros((1, 130, 1, 2))
    with pytest.raises(AssertionError, match="multiple"):
        tb.ssd_scan(z, z[..., 0], z[:, :, 0], z[:, :, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_prefill_then_decode(rng, dtype):
    """`ssd_apply`, then `ssd_prefill` and two `ssd_decode` steps, which
    write the given cache in place: outputs and caches against the
    reference's (float32: F32_TOL; bfloat16: BF16_TOL against its op-by-op
    run)."""
    jcfg, cfg = _cfgs("mamba2-130m", dtype)
    jp, tp = _params(rng, jb.ssd_abstract(jcfg))
    jx, tx = _x(rng, (2, 10, cfg.d_model), dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with jax.disable_jit(dtype == "bfloat16"):
        want = _reference(jb.ssd_apply, jcfg)(jp, jx[:, :8], None)
        jcache = jax.tree.map(lambda m: jnp.zeros(m.shape, m.dtype), jb.ssd_cache_abstract(jcfg, 2, 16),
                              is_leaf=lambda m: isinstance(m, JParamMeta))
        jy, jcache = _reference(jb.ssd_prefill, jcfg)(jp, jx[:, :8], None, jcache)
        jsteps = []
        decode = _reference(jb.ssd_decode, jcfg)
        for i in (8, 9):
            jd, jcache = decode(jp, jx[:, i: i + 1], jcache, i)
            jsteps.append(jd)
    _close(tb.ssd_apply(cfg, tp, tx[:, :8], None), want, tol, "apply")
    cache = {k: torch.zeros(v.shape, dtype=TDT[dtype] if k == "conv" else torch.float32)
             for k, v in jcache.items()}
    held = dict(cache)
    ty, out = tb.ssd_prefill(cfg, tp, tx[:, :8], None, cache)
    assert all(out[k] is held[k] for k in held)  # written in place
    _close(ty, jy, tol, "prefill")
    for i, jd in zip((8, 9), jsteps):
        td, out = tb.ssd_decode(cfg, tp, tx[:, i: i + 1], cache, i)
        assert all(out[k] is held[k] for k in held)
        _close(td, jd, tol, f"decode {i}")
    for k in held:
        _close(held[k], jcache[k], tol, f"cache {k}")


# ------------------------------------------------------------ RG-LRU


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_linear_scan_is_the_associative_scan_bitwise(rng, s):
    a = rng.random((2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    b[0, 0, 0] = -0.0  # the reference's interleave turns -0.0 into +0.0
    _, want = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
                                       (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = tb._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("s", [1, 7, 16], ids=["S=1", "S=7", "S=16"])
def test_rglru_apply_seq(rng, s):
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(rng, jb.rglru_abstract(jcfg))
    jx, tx = _x(rng, (2, s, cfg.lru_width))
    jh0, th0 = _x(rng, (2, cfg.lru_width))
    _close(tb._rglru_apply_seq(cfg, tp, tx), jb._rglru_apply_seq(jcfg, jp, jx), F32_TOL, "h")
    _close(tb._rglru_apply_seq(cfg, tp, tx, th0), jb._rglru_apply_seq(jcfg, jp, jx, jh0), F32_TOL, "h from h0")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_prefill_then_decode(rng, dtype):
    jcfg, cfg = _cfgs("recurrentgemma-2b", dtype)
    jp, tp = _params(rng, jb.rglru_abstract(jcfg))
    jx, tx = _x(rng, (2, 11, cfg.d_model), dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with jax.disable_jit(dtype == "bfloat16"):
        want = _reference(jb.rglru_apply, jcfg)(jp, jx[:, :9], None)
        jcache = jax.tree.map(lambda m: jnp.zeros(m.shape, m.dtype), jb.rglru_cache_abstract(jcfg, 2, 16),
                              is_leaf=lambda m: isinstance(m, JParamMeta))
        jy, jcache = _reference(jb.rglru_prefill, jcfg)(jp, jx[:, :9], None, jcache)
        jsteps = []
        decode = _reference(jb.rglru_decode, jcfg)
        for i in (9, 10):
            jd, jcache = decode(jp, jx[:, i: i + 1], jcache, i)
            jsteps.append(jd)
    _close(tb.rglru_apply(cfg, tp, tx[:, :9], None), want, tol, "apply")
    cache = {k: torch.zeros(v.shape, dtype=TDT[dtype] if k == "conv" else torch.float32)
             for k, v in jcache.items()}
    held = dict(cache)
    ty, out = tb.rglru_prefill(cfg, tp, tx[:, :9], None, cache)
    assert all(out[k] is held[k] for k in held)
    _close(ty, jy, tol, "prefill")
    for i, jd in zip((9, 10), jsteps):
        td, _ = tb.rglru_decode(cfg, tp, tx[:, i: i + 1], cache, i)
        _close(td, jd, tol, f"decode {i}")
    for k in held:
        _close(held[k], jcache[k], tol, f"cache {k}")


# ------------------------------------------------------------ MoE


def _no_near_ties(log: RouteLog):
    gaps = torch.cat([r.rel_gap for r in log.routes])
    near = int((gaps < ROUTE_MARGIN).sum())
    print(f"routing: {near} of {gaps.numel()} routed tokens within {ROUTE_MARGIN} x max|logit| of a tie")
    assert near == 0


def _drops(topi: torch.Tensor, cap: int, e: int) -> int:
    """Routed (token, k) pairs past their expert's capacity, counted in
    token order."""
    counts = torch.bincount(topi.flatten(), minlength=e)
    return int(torch.clamp_min(counts - cap, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_group_drops_at_capacity(rng, dtype):
    """A router biased so that expert 3 is every token's first choice: 16
    tokens, top-2 of 8, capacity 5, so 11 of expert 3's pairs drop (their
    one_hot rows all zero)."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", dtype)
    jp, tp = _params(rng, jb.moe_abstract(jcfg))
    router = np.asarray(jp["router"]).copy()
    router[:, 3] += 0.3  # with x > 0, logit 3 leads by ~0.3 sum|x|: no underflow to ties at 0
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    jx, tx = _x(rng, (16, cfg.d_model), dtype)
    tx = tx.abs()  # x . router[:, 3] > 0: expert 3 first
    jx = jnp.asarray(np.abs(np.asarray(jx.astype(jnp.float32))), JDT[dtype])
    with jax.disable_jit(dtype == "bfloat16"):
        jy, jaux = jb._moe_group(jcfg, jp, jx)
    with RouteLog() as log:
        ty, taux = tb._moe_group(cfg, tp, tx)
    _no_near_ties(log)
    topi = tb._route(cfg, tp["router"], tx)[3]
    cap = tb.moe_capacity(cfg, 16)
    assert cap == 5 and bool((topi[:, 0] == 3).all()) and log.routes[0].dropped
    assert int((topi == 3).sum()) == 16 and _drops(topi, cap, cfg.moe_experts) >= 11
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(ty, jy, tol, "out")
    _close(taux, jaux, F32_TOL, "aux")


def test_moe_group_exact_ties_go_to_the_lower_index(rng):
    """Experts 2, 5 and 6 share one router column, and experts 0 and 7
    another, so their probabilities tie bit for bit; both packages keep
    the lower index (`jax.lax.top_k`'s order)."""
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    jp, tp = _params(rng, jb.moe_abstract(jcfg))
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 6] = router[:, 2]
    router[:, 7] = router[:, 0]
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    jx, tx = _x(rng, (32, cfg.d_model))
    _, probs, _, topi = tb._route(cfg, tp["router"], tx)
    assert torch.equal(probs[:, 5], probs[:, 2]) and torch.equal(probs[:, 7], probs[:, 0])
    want_topi = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(tx.numpy()) @ jp["router"], axis=-1),
                                         cfg.moe_topk)[1])
    np.testing.assert_array_equal(topi.numpy(), want_topi)
    has = lambda e: (topi == e).any(-1)  # noqa: E731
    # a tied expert is taken only after every lower one it ties with
    assert not bool((has(5) & ~has(2)).any() or (has(6) & ~has(5)).any() or (has(7) & ~has(0)).any())
    assert bool((has(2) & ~has(5)).any() and (has(0) & ~has(7)).any())  # ties broken at the k-th place
    jy, jaux = jb._moe_group(jcfg, jp, jx)
    ty, taux = tb._moe_group(cfg, tp, tx)
    _close(ty, jy, F32_TOL, "out")
    _close(taux, jaux, F32_TOL, "aux")


# (arch, (B, S), group_size, groups): several groups, and t % g != 0, where
# the reference falls back to one group
MOE_APPLY_CASES = [
    ("granite-moe-3b-a800m", (2, 32), 16, 4),
    ("deepseek-moe-16b", (2, 32), 16, 4),
    ("deepseek-moe-16b", (3, 15), 20, 1),
]


@pytest.mark.parametrize("arch,shape,group_size,groups", MOE_APPLY_CASES,
                         ids=["granite-4groups", "deepseek-4groups", "deepseek-ragged-1group"])
def test_moe_apply(rng, arch, shape, group_size, groups):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(rng, jb.moe_abstract(jcfg))
    jx, tx = _x(rng, shape + (cfg.d_model,))
    jy, jaux = jb.moe_apply(jcfg, jp, jx, group_size)
    with RouteLog() as log:
        ty, taux = tb.moe_apply(cfg, tp, tx, group_size)
    assert len(log.routes) == groups
    assert all(r.experts.shape[0] == math.prod(shape) // groups for r in log.routes)
    _no_near_ties(log)
    _close(ty, jy, F32_TOL, "out")
    _close(taux, jaux, F32_TOL, "aux")
