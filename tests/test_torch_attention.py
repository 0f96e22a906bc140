"""Parity of the port's attention (`repro_torch.kernels.flash_attention`)
with the reference's Pallas kernel (interpret mode) and its naive oracle.

On the CPU the wrapper runs its plain PyTorch version; the same numpy
inputs (standard normal, from the `rng` fixture) go through
`repro.kernels.flash_attention` with `interpret=True`.  Stated tolerances:

* float32: max|d| <= 2e-5, the reference test's own; XLA and torch sum the
  f32 dot products in different orders.
* bfloat16: |d| <= 2^-7 |ref| + 2e-5 elementwise, one bf16 ulp: both sides
  compute in f32 and round once at the end.
* against `ref.flash_attention_ref`: 2e-5 for f32 and 2e-2 for bf16, as
  `tests/test_kernels.py::test_flash_attention_sweep`.

`chip_smoke.py` phase 2 holds the CUDA kernel against the plain version on
the card at these shapes and at Qwen2.5-32B's full 32k-prefill widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen2_5_32b import REDUCED as QWEN_REDUCED
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
import repro_torch.kernels as tk
from repro_torch.kernels import flash_attention as tfa

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, b, s, h, kv, d, dtype, sk=None):
    """The same q, k, v for both packages: standard normal f32, rounded once
    to the working type."""
    tdt, jdt = DTYPES[dtype]
    sk = s if sk is None else sk
    shapes = ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, d))
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt) for shape in shapes]
    js = [jnp.asarray(t.float().numpy(), jdt) for t in ts]
    return ts, js


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _assert_matches_pallas(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    if dtype == "f32":
        assert np.abs(got - want).max() <= 2e-5
    else:
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 2e-5)


def _assert_matches_ref(got, want, dtype):
    tol = 2e-5 if dtype == "f32" else 2e-2
    assert np.abs(_f32(got) - _f32(want)).max() <= tol


def _run(rng, b, s, h, kv, d, dtype, *, causal=True, sk=None, **blocks):
    (q, k, v), (jq, jk, jv) = _inputs(rng, b, s, h, kv, d, dtype, sk)
    got = tfa.flash_attention(q, k, v, causal=causal, **blocks)
    want = j_flash_attention(jq, jk, jv, causal=causal, interpret=True, **blocks)
    assert got.dtype == DTYPES[dtype][0]
    _assert_matches_pallas(got, want, dtype)
    return got, (jq, jk, jv)


SWEEP = [(2, 256, 4, 2, 64), (1, 512, 8, 1, 32), (2, 128, 4, 4, 64)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=["b2s256h4kv2d64", "b1s512h8kv1d32", "b2s128h4kv4d64"])
def test_matches_pallas_and_ref(rng, shape, dtype, causal):
    """The reference sweep's shapes, against the Pallas kernel and the
    naive softmax oracle."""
    got, (jq, jk, jv) = _run(rng, *shape, dtype, causal=causal)
    _assert_matches_ref(got, ref.flash_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_sequence(rng, dtype, causal):
    """s = 200: the blocks become 200, which the CUDA kernel's 64-row tiles
    do not divide."""
    got, (jq, jk, jv) = _run(rng, 1, 200, 4, 2, 32, dtype, causal=causal)
    _assert_matches_ref(got, ref.flash_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_more_keys_than_queries(rng, dtype, causal):
    """Sk = 256 != S = 128; the causal mask stays top-left aligned."""
    _run(rng, 1, 128, 4, 2, 64, dtype, causal=causal, sk=256)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [128, 256])
def test_wide_heads(rng, d, dtype):
    """D = 128 (Qwen2.5, Nemotron, StarCoder2) and 256 (RecurrentGemma)."""
    _run(rng, 1, 128, 4, 2, d, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qwen_reduced_widths(rng, dtype):
    """Qwen2.5-32B's reduced config: H = 4, KV = 2 (GQA group 2), D = 32."""
    cfg = QWEN_REDUCED
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (4, 2, 32)
    _run(rng, 2, 256, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", [64, 128])
def test_blocks_as_the_reference(rng, blocks, dtype):
    """bq = bk = 64 or 128 on both sides: more kv steps of the online softmax."""
    _run(rng, 1, 256, 4, 2, 64, dtype, bq=blocks, bk=blocks)


def test_indivisible_blocks_raise(rng):
    (q, k, v), (jq, jk, jv) = _inputs(rng, 1, 300, 2, 1, 32, "f32")
    with pytest.raises(ValueError, match="not divisible"):
        j_flash_attention(jq, jk, jv, interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q[:, :256], k, v, bq=256, bk=128)


def test_heads_not_a_multiple_of_kv_heads_raise(rng):
    (q, k, v), _ = _inputs(rng, 1, 64, 3, 2, 32, "f32")
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, v)


@pytest.fixture
def on_card(monkeypatch):
    """Treat CPU tensors as card tensors; the launch records its call and
    runs the plain version instead."""
    launched = []
    monkeypatch.setattr(tfa, "on_card", lambda *ts: True)
    monkeypatch.setattr(
        tfa, "_launch",
        lambda q, k, v, *, causal: launched.append(causal) or tfa.flash_attention_plain(q, k, v, causal=causal))
    return launched


def test_card_tensor_launches_the_kernel(rng, on_card):
    (q, k, v), _ = _inputs(rng, 1, 64, 4, 2, 32, "bf16")
    tfa.flash_attention(q, k, v, causal=False)
    assert on_card == [False]


@pytest.mark.parametrize("d", [16, 48, 96, 512])
def test_card_refuses_uncompiled_head_dim(rng, on_card, d):
    (q, k, v), _ = _inputs(rng, 1, 64, 2, 1, d, "f32")
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, k, v)
    assert on_card == []


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_card_refuses_other_types(rng, on_card, dtype):
    (q, k, v), _ = _inputs(rng, 1, 64, 2, 1, 32, "f32")
    with pytest.raises(TypeError, match="takes"):
        tfa.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
    with pytest.raises(TypeError, match="differ"):
        tfa.flash_attention(q, k.to(dtype), v)
    assert on_card == []


def test_card_refuses_strided_or_misaligned_inputs(rng, on_card):
    (q, k, v), _ = _inputs(rng, 1, 64, 2, 1, 32, "f32")
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # (B, S, H, D) view of a (B, H, S, D) tensor
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(qt, k, v)
    flat = torch.zeros(q.numel() + 1)
    qs = flat[1:].view(q.shape)  # contiguous, 4 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(qs, k, v)
    assert on_card == []


def test_cpu_runs_the_plain_version_and_counts_no_launch(rng):
    (q, k, v), _ = _inputs(rng, 1, 64, 4, 2, 32, "f32")
    tk.reset_launches()
    out = tfa.flash_attention(q, k, v)
    assert tk.launch_counts()["flash_attention"] == 0
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v))
    assert tk.WRAPPERS["flash_attention"] is tfa.flash_attention


def test_plain_rounds_p_only_when_asked(rng):
    """`p_dtype` rounds P for the PV product (the card check's control rounds
    it to e4m3): float32 keeps the plain version's bits, bf16 and e4m3 move
    them, e4m3 the more."""
    (q, k, v), _ = _inputs(rng, 1, 256, 4, 2, 64, "f32")
    base = tfa.flash_attention_plain(q, k, v, bk=64)
    assert torch.equal(tfa.flash_attention_plain(q, k, v, bk=64, p_dtype=torch.float32), base)
    bf16, e4m3 = (float((tfa.flash_attention_plain(q, k, v, bk=64, p_dtype=t) - base).abs().max())
                  for t in (torch.bfloat16, torch.float8_e4m3fn))
    assert 0 < bf16 < e4m3


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_tma_geometry_keeps_batches_apart(d):
    """The bf16 kernel's tensor maps are 4-D (D, heads, seq, B): a box that
    runs past a ragged seq reads zeros, never the next batch's rows (a 3-D
    map over B * seq rows would)."""
    q = torch.zeros(2, 200, 8, d, dtype=torch.bfloat16)
    k = torch.zeros(2, 333, 2, d, dtype=torch.bfloat16)
    assert tfa.tma_geometry(q) == (d, 8, 200, 2, 2 * d, 2 * 8 * d, 2 * 200 * 8 * d)
    assert tfa.tma_geometry(k) == (d, 2, 333, 2, 2 * d, 2 * 2 * d, 2 * 333 * 2 * d)
    # the byte strides are those of the tensor, each a multiple of 16 (TMA's rule)
    for t in (q, k):
        geom = tfa.tma_geometry(t)
        assert list(geom[4:]) == [s * t.element_size() for s in reversed(t.stride()[:3])]
        assert all(s % 16 == 0 for s in geom[4:])


def test_tma_geometry_refuses_what_tma_cannot_map():
    with pytest.raises(ValueError, match="TMA cannot map"):
        tfa.tma_geometry(torch.zeros(1, 8, 2, 4, dtype=torch.bfloat16))  # 8-byte rows
    with pytest.raises(ValueError, match="contiguous"):
        tfa.tma_geometry(torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16).transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.tma_geometry(torch.zeros(8, 32, dtype=torch.bfloat16))


@pytest.mark.parametrize("sk", [None, 200], ids=["sk=s", "sk200"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_launch_passes_the_tensor_maps(rng, monkeypatch, dtype, sk):
    """The C entry point gets the shapes, and for bf16 the geometry of q's
    and k's tensor maps (v shares k's); for f32 null pointers."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tfa, "_entry", lambda: entry)
    monkeypatch.setattr(tfa.torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    (q, k, v), _ = _inputs(rng, 2, 128, 8, 2, 128, dtype, sk)
    out = tfa._launch(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    (args,) = calls
    assert args[4:12] == (2, 128, k.shape[1], 8, 2, 128, 1, tfa.CARD_DTYPES[q.dtype])
    q_geom, kv_geom, stream = args[12:]
    assert stream == 7
    if dtype == "bf16":
        assert tuple(q_geom) == tfa.tma_geometry(q)
        assert tuple(kv_geom) == tfa.tma_geometry(k) == tfa.tma_geometry(v)
    else:
        assert q_geom is None and kv_geom is None
    assert tfa.flash_attention.launches == 1
