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
