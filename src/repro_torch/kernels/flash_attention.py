"""Causal (or full) GQA softmax attention with an online softmax.

Port of `repro.kernels.flash_attention`, the reference's prefill attention
kernel; no model calls it (the models have their own attention), so this
module is its own entry point.  q is (B, S, H, D), k and v (B, Sk, KV, D)
with H = KV * G: query head h reads kv head h // G.  The logits are
(q * 1/sqrt(D)) . k in float32, masked to -1e30 where q_pos < k_pos when
causal (top-left aligned, also for Sk != S), and the output, cast to q's
type, is acc / max(l, 1e-30) of the running (m, l, acc) in float32.

On CUDA tensors `flash_attention` launches `csrc/flash_attention.cu`
(float32 or bfloat16, D in `HEAD_DIMS`); on CPU tensors it runs
`flash_attention_plain`.  The bfloat16 kernel reads q, k and v by TMA
through 4-D tensor maps whose geometry `tma_geometry` computes here.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .common import on_card, traced_launch

#: the head dims the CUDA kernel compiles
HEAD_DIMS = (32, 64, 128, 256)
#: the input types the CUDA kernel takes, by the code its C entry point reads
CARD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK = -1e30


def _blocks(s: int, sk: int, bq: int, bk: int) -> tuple[int, int]:
    """The reference's blocks: (min(bq, s), min(bk, sk)), each dividing its
    sequence."""
    bq, bk = min(bq, s), min(bk, sk)
    if s % bq or sk % bk:
        raise ValueError(f"seq ({s},{sk}) not divisible by blocks ({bq},{bk})")
    return bq, bk


def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The group size G = H // KV; raises on inconsistent shapes."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,Sk,KV,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    return h // k.shape[2]


def flash_attention_plain(q, k, v, *, causal=True, bq=256, bk=256, p_dtype=None):
    """The reference kernel's blockwise online softmax in float32, one step
    per kv block of `bk` keys with the running (m, l, acc) carried across.
    Every q row is independent, so `bq` only has to divide S.  GQA by
    grouping the G query heads of a kv head into its rows, without
    repeating k and v.  `p_dtype`, when given, rounds P to that type for
    the PV product only (a deliberately coarser control for the card
    check's bf16 limit); None keeps it float32, as the reference does."""
    g = _heads(q, k, v)
    b, s, h, d = q.shape
    _, sk, kv, _ = k.shape
    _, bk = _blocks(s, sk, bq, bk)
    scale = 1.0 / math.sqrt(d)
    # (B, KV, G*S, D); row r of a kv head is query position r % S
    qf = q.float().reshape(b, s, kv, g, d).permute(0, 2, 3, 1, 4).reshape(b, kv, g * s, d) * scale
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = torch.arange(s, device=q.device).repeat(g)[:, None]
    m = torch.full((b, kv, g * s, 1), MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, sk, bk):
        logits = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            k_pos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
            logits = torch.where(q_pos >= k_pos, logits, MASK)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * corr + p @ vf[:, :, k0:k0 + bk]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _check_card_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes these inputs: one type of
    `CARD_DTYPES`, a head dim of `HEAD_DIMS`, contiguous (B, S, H, D) whose
    data starts on a 16-byte boundary (the f32 kernel's vector loads and the
    bf16 kernel's TMA base addresses)."""
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in CARD_DTYPES:
        raise TypeError(f"the attention kernel takes {sorted(map(str, CARD_DTYPES))}, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the attention kernel compiles head dims {HEAD_DIMS}, got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected data aligned to 16 bytes")
        if t.dtype == torch.bfloat16:
            tma_geometry(t)


def tma_geometry(t: torch.Tensor) -> tuple[int, ...]:
    """The TMA tensor map of a contiguous (B, seq, heads, D) tensor, as the
    bfloat16 kernel encodes it: the 4-D view (D, heads, seq, B), innermost
    first, then the byte strides of heads, seq and B.  Batch stays its own
    dimension, so a box that runs past `seq` reads zeros and never the next
    batch's rows.  Raises where TMA cannot take the tensor: a stride that is
    not a multiple of 16 bytes or one of 2^40 bytes or more, a dimension of
    2^32 or more."""
    if t.ndim != 4 or not t.is_contiguous():
        raise ValueError(f"expected a contiguous (B, seq, heads, D) tensor, got {tuple(t.shape)}")
    b, s, h, d = t.shape
    e = t.element_size()
    strides = (d * e, h * d * e, s * h * d * e)
    if any(x % 16 or x >= 2**40 for x in strides) or max(t.shape) >= 2**32:
        raise ValueError(f"TMA cannot map a {tuple(t.shape)} {t.dtype} tensor: byte strides {strides}")
    return (d, h, s, b, *strides)


@functools.cache
def _entry():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, *, causal):
    b, s, h, d = q.shape
    _, sk, kv, _ = k.shape
    out = torch.empty_like(q)
    geoms = [None, None]
    if q.dtype == torch.bfloat16:  # v has k's geometry
        geoms = [(ctypes.c_longlong * 7)(*tma_geometry(t)) for t in (q, k)]
    status = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, sk, h, kv, d, int(causal), CARD_DTYPES[q.dtype], *geoms,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch("flash_attention", status)
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bq: int = 256,
    bk: int = 256,
) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, KV, D); H = KV * G.  Returns (B, S, H,
    D) in q's type.  `bq`/`bk` are the reference's blocks: each must divide
    its sequence after `min(b, seq)`.  The CUDA kernel takes its own tiles
    and masks the ragged tail itself; on the CPU they are the plain
    version's kv steps."""
    _heads(q, k, v)
    _blocks(q.shape[1], k.shape[1], bq, bk)
    with traced_launch("flash_attention", (q, k, v)):
        if on_card(q, k, v):
            _check_card_inputs(q, k, v)
            return _launch(q, k, v, causal=causal)
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)


flash_attention.launches = 0
