"""Per-layer blocks: GQA attention, Mamba2 SSD, RG-LRU, MoE MLP.

The port's copy of `repro.models.blocks`.  Uniform interface per block
kind:
  abstract(cfg)                        -> ParamMeta tree
  apply(cfg, p, x, positions)          -> y                (full sequence)
  cache_abstract(cfg, b, cache_len)    -> ParamMeta tree   (decode cache)
  prefill(cfg, p, x, positions, cache) -> (y, cache)
  decode(cfg, p, x, cache, pos)        -> (y, cache)       (x: (B, 1, d))

The attention block runs.  Its prefill and decode write the layer's cache
tensors in place and return them (the reference returns a new cache and
its engine donates the old one).  The SSD, RG-LRU and MoE blocks build
their param and cache shapes, so every arch's trees and counts are the
reference's; running them raises `NotImplementedError` until ROADMAP
queue 1, item 9b ports them.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (
    AttnSpec,
    apply_linear,
    apply_rope,
    attention,
    linear_abstract,
    mlp_abstract,
)
from .params import ParamMeta

_NEG_POS = 2**30  # sentinel "future" position for empty cache slots


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 9b: the SSD, RG-LRU and MoE blocks)")


# =================================================================== attention


def attn_abstract(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    return {
        "q": linear_abstract(d, h * hd, ("embed", "qkv"), dt, cfg.qkv_bias),
        "k": linear_abstract(d, kv * hd, ("embed", "kv_qkv"), dt, cfg.qkv_bias),
        "v": linear_abstract(d, kv * hd, ("embed", "kv_qkv"), dt, cfg.qkv_bias),
        "o": linear_abstract(h * hd, d, ("qkv", "embed"), dt),
    }


def _qkv(cfg: ModelConfig, p, x, positions):
    b, s, _ = x.shape
    q = apply_linear(p["q"], x, cfg.gemm_policy).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = apply_linear(p["k"], x, cfg.gemm_policy).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = apply_linear(p["v"], x, cfg.gemm_policy).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    return q, k, v


def _spec(cfg: ModelConfig, kv_chunk=None) -> AttnSpec:
    return AttnSpec(
        causal=True,
        window=cfg.window,
        softcap=cfg.attn_logit_softcap,
        kv_chunk=kv_chunk if kv_chunk is not None else cfg.kv_chunk,
    )


def attn_apply(cfg: ModelConfig, p, x, positions):
    q, k, v = _qkv(cfg, p, x, positions)
    pos1 = positions[0] if positions.ndim > 1 else positions
    out = attention(q, k, v, _spec(cfg), pos1, pos1)
    b, s, _, _ = q.shape
    return apply_linear(p["o"], out.reshape(b, s, -1), cfg.gemm_policy)


def attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    # windowed layers only ever need `window` slots (ring buffer)
    return min(max_len, cfg.window) if cfg.window else max_len


def attn_cache_abstract(cfg: ModelConfig, b: int, cache_len: int) -> dict:
    c = attn_cache_len(cfg, cache_len)
    kvshape = (b, c, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {
        "k": ParamMeta(kvshape, axes, cfg.dtype, "zeros"),
        "v": ParamMeta(kvshape, axes, cfg.dtype, "zeros"),
        "pos": ParamMeta((c,), (None,), torch.int32, "future_pos"),
    }


def attn_prefill(cfg: ModelConfig, p, x, positions, cache):
    q, k, v = _qkv(cfg, p, x, positions)
    pos1 = positions[0] if positions.ndim > 1 else positions
    out = attention(q, k, v, _spec(cfg), pos1, pos1)
    b, s, _, _ = q.shape
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    c = ck.shape[1]
    if s >= c:  # keep the last c tokens, slot = pos % c (ring layout)
        ktail, vtail, ptail = k[:, -c:], v[:, -c:], pos1[-c:]
        slot = (ptail % c).long()
        ck.zero_()
        cv.zero_()
        cpos.fill_(_NEG_POS)
    else:
        ktail, vtail, ptail = k, v, pos1
        slot = (pos1 % c).long()
    ck[:, slot] = ktail.to(ck.dtype)
    cv[:, slot] = vtail.to(cv.dtype)
    cpos[slot] = ptail.to(cpos.dtype)
    y = apply_linear(p["o"], out.reshape(b, s, -1), cfg.gemm_policy)
    return y, cache


def attn_decode(cfg: ModelConfig, p, x, cache, pos: int):
    b = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    c = ck.shape[1]
    slot = pos % c
    ck[:, slot: slot + 1] = k.to(ck.dtype)
    cv[:, slot: slot + 1] = v.to(cv.dtype)
    cpos[slot] = pos
    out = attention(q, ck, cv, _spec(cfg, kv_chunk=c), positions, cpos, kv_valid=cpos <= pos)
    y = apply_linear(p["o"], out.reshape(b, 1, -1), cfg.gemm_policy)
    return y, cache


# =================================================================== mamba2 SSD


def ssd_abstract(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * gn
    dt = cfg.dtype
    return {
        "in_proj": linear_abstract(d, 2 * di + 2 * gn + h, ("embed", "ssm_inner"), dt),
        "conv_w": ParamMeta((cfg.conv_width, conv_ch), (None, "ssm_inner"), dt),
        "conv_b": ParamMeta((conv_ch,), ("ssm_inner",), dt, "zeros"),
        "dt_bias": ParamMeta((h,), (None,), torch.float32, "zeros"),
        "a_log": ParamMeta((h,), (None,), torch.float32, "zeros"),
        "d_skip": ParamMeta((h,), (None,), torch.float32, "ones"),
        "norm": ParamMeta((di,), ("ssm_inner",), dt, "ones"),
        "out_proj": linear_abstract(di, d, ("ssm_inner", "embed"), dt),
    }


def ssd_cache_abstract(cfg: ModelConfig, b: int, cache_len: int) -> dict:
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": ParamMeta(
            (b, cfg.conv_width - 1, di + 2 * gn), ("batch", None, "ssm_inner"), cfg.dtype, "zeros",
        ),
        "state": ParamMeta(
            (b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
            ("batch", None, None, None), torch.float32, "zeros",
        ),
    }


def ssd_apply(cfg: ModelConfig, p, x, positions):
    raise _not_ported("the Mamba2 SSD block")


def ssd_prefill(cfg: ModelConfig, p, x, positions, cache):
    raise _not_ported("the Mamba2 SSD block")


def ssd_decode(cfg: ModelConfig, p, x, cache, pos):
    raise _not_ported("the Mamba2 SSD block")


# =================================================================== rg-lru


def rglru_abstract(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.dtype
    return {
        "in_x": linear_abstract(d, w, ("embed", "ssm_inner"), dt),
        "in_gate": linear_abstract(d, w, ("embed", "ssm_inner"), dt),
        "conv_w": ParamMeta((cfg.conv_width, w), (None, "ssm_inner"), dt),
        "conv_b": ParamMeta((w,), ("ssm_inner",), dt, "zeros"),
        "w_a": linear_abstract(w, w, ("ssm_inner", None), dt),
        "w_x": linear_abstract(w, w, ("ssm_inner", None), dt),
        "lam": ParamMeta((w,), (None,), torch.float32, "ones"),
        "out": linear_abstract(w, d, ("ssm_inner", "embed"), dt),
    }


def rglru_cache_abstract(cfg: ModelConfig, b: int, cache_len: int) -> dict:
    w = cfg.lru_width
    return {
        "conv": ParamMeta((b, cfg.conv_width - 1, w), ("batch", None, "ssm_inner"), cfg.dtype, "zeros"),
        "h": ParamMeta((b, w), ("batch", "ssm_inner"), torch.float32, "zeros"),
    }


def rglru_apply(cfg: ModelConfig, p, x, positions):
    raise _not_ported("the RG-LRU block")


def rglru_prefill(cfg: ModelConfig, p, x, positions, cache):
    raise _not_ported("the RG-LRU block")


def rglru_decode(cfg: ModelConfig, p, x, cache, pos):
    raise _not_ported("the RG-LRU block")


# =================================================================== moe


def moe_abstract(cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    dt = cfg.dtype
    out = {
        "router": ParamMeta((d, e), ("embed", "experts"), torch.float32),
        "gate": ParamMeta((e, d, ff), ("experts", "embed", "ff"), dt),
        "up": ParamMeta((e, d, ff), ("experts", "embed", "ff"), dt),
        "down": ParamMeta((e, ff, d), ("experts", "ff", "embed"), dt),
    }
    if cfg.moe_shared:
        out["shared"] = mlp_abstract("swiglu", d, ff * cfg.moe_shared, dt)
    return out


def moe_apply(cfg: ModelConfig, p, x, group_size: int | None = None):
    raise _not_ported("the MoE MLP")


BLOCKS = {
    "attn": {
        "abstract": attn_abstract,
        "apply": attn_apply,
        "cache": attn_cache_abstract,
        "prefill": attn_prefill,
        "decode": attn_decode,
    },
    "ssd": {
        "abstract": ssd_abstract,
        "apply": ssd_apply,
        "cache": ssd_cache_abstract,
        "prefill": ssd_prefill,
        "decode": ssd_decode,
    },
    "rglru": {
        "abstract": rglru_abstract,
        "apply": rglru_apply,
        "cache": rglru_cache_abstract,
        "prefill": rglru_prefill,
        "decode": rglru_decode,
    },
}
