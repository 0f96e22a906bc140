"""Per-layer blocks: GQA attention, Mamba2 SSD, RG-LRU, MoE MLP.

The port's copy of `repro.models.blocks`.  Uniform interface per block
kind:
  abstract(cfg)                        -> ParamMeta tree
  apply(cfg, p, x, positions)          -> y                (full sequence)
  cache_abstract(cfg, b, cache_len)    -> ParamMeta tree   (decode cache)
  prefill(cfg, p, x, positions, cache) -> (y, cache)
  decode(cfg, p, x, cache, pos)        -> (y, cache)       (x: (B, 1, d))

Every block runs, op by op in the reference's order and dtypes.  Prefill
and decode write the layer's cache tensors in place and return them (the
reference returns a new cache and its engine donates the old one).  Where
the reference scans (`lax.scan` over SSD chunks and MoE token groups,
`lax.associative_scan` over the RG-LRU sequence) the port loops in Python
over the chunks and groups and runs the associative scan's own odd/even
recursion on strided slices.  The SSD scan, the RG-LRU scan and the MoE
dispatch are plain tensor ops, as in the reference (no Pallas kernel
there, so no hand-written kernel here); their linears go through
`apply_linear` under the config's policy, and the router and expert
products stay native, outside the policy, as in the reference.
"""
from __future__ import annotations

import functools
import math

import torch

from .config import ModelConfig
from .layers import (
    AttnSpec,
    apply_linear,
    apply_mlp,
    apply_rope,
    attention,
    gelu,
    linear_abstract,
    logistic,
    mlp_abstract,
    silu,
)
from .params import ParamMeta, torch_dtype

_F32 = torch.float32
_NEG_POS = 2**30  # sentinel "future" position for empty cache slots


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` on the operands' common type, as `jnp.einsum`
    promotes (a float32 activation against float64 weights computes in
    float64); operands of one type pass unchanged."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), with no linear branch above a
    threshold (`torch.nn.functional.softplus` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rms_gate(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(y * silu(z)) * scale, rounded once to
    `dtype`."""
    y = y * silu(z.to(_F32))
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return (y * scale.to(_F32)).to(dtype)


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


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): sum_{k=j+1..i} x_k for i >= j else -inf."""
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    q = x.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_scan(xbar, a_dt, bmat, cmat, init_state=None, chunk=128):
    """Chunked state-space-duality scan (Mamba-2, alg. 'SSD').

    xbar: (B,S,H,P) dt-weighted inputs; a_dt: (B,S,H) log-decays;
    bmat/cmat: (B,S,N) (single group).  Returns y (B,S,H,P), final_state
    (B,H,P,N).  All f32.  The reference's three-operand einsums run as two
    products, the first two operands first; its inter-chunk `lax.scan` is a
    loop over the chunks that keeps the state *before* each chunk.
    """
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, f"sequence {s} is not a multiple of the SSD chunk {chunk}"
    nc = s // chunk
    xc = xbar.reshape(b, nc, chunk, h, p)
    ac = a_dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    acs = torch.cumsum(ac, dim=2)  # (B,Nc,Q,H) inclusive
    # intra-chunk (diagonal blocks)
    l_mat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B,Nc,H,Q,Q)
    g_mat = _einsum("bcin,bcjn->bcij", cc, bc)
    y_diag = _einsum("bchij,bcjhp->bcihp", g_mat[:, :, None] * l_mat, xc)
    # per-chunk end states
    a_last = acs[:, :, -1:, :]  # (B,Nc,1,H)
    decay_states = torch.exp(a_last - acs)  # (B,Nc,Q,H)
    states = _einsum("bcjhn,bcjhp->bchpn", decay_states[..., None] * bc[:, :, :, None, :], xc)
    # inter-chunk recurrence
    chunk_decay = torch.exp(a_last[:, :, 0])  # (B,Nc,H)
    carry = torch.zeros((b, h, p, n), dtype=xbar.dtype, device=xbar.device) if init_state is None else init_state
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state *before* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,Nc,H,P,N)
    y_off = _einsum("bcin,bchpn->bcihp", cc, prev_states) * torch.exp(acs)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv along seq. x: (B,S,C); w: (W,C). carry:
    (B,W-1,C), cast to x's dtype.  The taps sum in float32 from the first,
    as the reference's `sum(...)`.  Returns (y in x's dtype, the new carry:
    the last W-1 inputs)."""
    width = w.shape[0]
    pad = (
        torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
        if carry is None
        else carry.to(x.dtype)
    )
    xp = torch.cat([pad, x], dim=1).to(_F32)
    out = sum(xp[:, i: i + x.shape[1]] * w[i].to(_F32) for i in range(width))
    new_carry = xp[:, -(width - 1):].to(x.dtype) if width > 1 else pad
    return (out + b.to(_F32)).to(x.dtype), new_carry


def _ssd_split(cfg: ModelConfig, p, x, conv_carry):
    """in_proj, the split and the conv: (z, xin, bmat, cmat, dt, a, new
    conv carry), the SiLU'd conv output and the rates in float32."""
    di, gn, h = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads
    zxbcdt = apply_linear(p["in_proj"], x, cfg.gemm_policy)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * gn, h], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_carry)
    xbc = silu(xbc.to(_F32))
    xin, bmat, cmat = torch.split(xbc, [di, gn, gn], dim=-1)
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,)
    return z, xin, bmat, cmat, dt, a, new_conv


def _ssd_inner(cfg: ModelConfig, p, x, conv_carry, state, chunk=128):
    b, s, _ = x.shape
    n = cfg.ssm_state
    z, xin, bmat, cmat, dt, a, new_conv = _ssd_split(cfg, p, x, conv_carry)
    xh = xin.reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    y, final_state = ssd_scan(xh * dt[..., None], dt * a, bmat[..., :n], cmat[..., :n], state, chunk)
    y = y + p["d_skip"][:, None] * xh
    y = _rms_gate(y.reshape(b, s, cfg.d_inner), z, p["norm"], x.dtype)
    return apply_linear(p["out_proj"], y, cfg.gemm_policy), new_conv, final_state


def ssd_apply(cfg: ModelConfig, p, x, positions):
    y, _, _ = _ssd_inner(cfg, p, x, None, None)
    return y


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


def ssd_prefill(cfg: ModelConfig, p, x, positions, cache):
    # the reference starts from the cache times 0, not from the cache
    y, conv, state = _ssd_inner(cfg, p, x, cache["conv"] * 0, cache["state"] * 0)
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    return y, cache


def ssd_decode(cfg: ModelConfig, p, x, cache, pos):
    b = x.shape[0]
    n = cfg.ssm_state
    z, xin, bmat, cmat, dt, a, new_conv = _ssd_split(cfg, p, x, cache["conv"])
    xin, bmat, cmat, dt = xin[:, 0], bmat[:, 0], cmat[:, 0], dt[:, 0]  # (B, C), (B, H)
    da = torch.exp(dt * a)  # (B,H)
    xh = xin.reshape(b, cfg.ssm_heads, cfg.ssm_headdim)
    state = cache["state"] * da[..., None, None] + _einsum("bhp,bn->bhpn", dt[..., None] * xh, bmat[..., :n])
    y = _einsum("bhpn,bn->bhp", state, cmat[..., :n])
    y = y + p["d_skip"][:, None] * xh
    y = _rms_gate(y.reshape(b, 1, cfg.d_inner), z, p["norm"], x.dtype)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(state)
    return apply_linear(p["out_proj"], y, cfg.gemm_policy), cache


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


_LRU_C = 8.0


def _rglru_gates(cfg, p, xc):
    r = logistic(apply_linear(p["w_a"], xc, cfg.gemm_policy).to(_F32))
    i = logistic(apply_linear(p["w_x"], xc, cfg.gemm_policy).to(_F32))
    # log a_t = -c * r_t * softplus(lam)  (a = sigmoid(lam)^(c r) in griffin)
    log_a = -_LRU_C * r * _softplus(p["lam"])
    a = torch.exp(log_a)
    gated_x = i * xc.to(_F32)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated_x
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0): the `h` of
    `jax.lax.associative_scan` with the combine (al ar, bl ar + br), by its
    own recursion, so the products pair up as the reference's do: combine
    adjacent pairs, scan the half, then fill in the even positions.  O(log
    S) steps of elementwise ops on strided slices.  The scan's cumulative
    `a` never enters `h`, so it is not formed."""
    s = a.shape[1]
    if s < 2:
        return b
    odd = _linear_scan(a[:, 0:-1:2] * a[:, 1::2], b[:, 0:-1:2] * a[:, 1::2] + b[:, 1::2])
    head = odd[:, :-1] if s % 2 == 0 else odd
    even = torch.cat([b[:, :1], head * a[:, 2::2] + b[:, 2::2]], dim=1)
    # the reference interleaves by zero padding and an add, so a -0.0
    # comes out +0.0: + 0.0 does the same
    out = b.new_empty(b.shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out + 0.0


def _rglru_apply_seq(cfg, p, xc, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t via associative scan."""
    a, b = _rglru_gates(cfg, p, xc)  # (B,S,W) each
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _linear_scan(a, b)  # (B,S,W) f32


def _rglru_in(cfg, p, x):
    gate = gelu(apply_linear(p["in_gate"], x, cfg.gemm_policy).to(_F32))
    xb = apply_linear(p["in_x"], x, cfg.gemm_policy)
    return gate, xb


def rglru_apply(cfg: ModelConfig, p, x, positions):
    gate, xb = _rglru_in(cfg, p, x)
    xc, _ = _causal_conv(xb, p["conv_w"], p["conv_b"])
    h = _rglru_apply_seq(cfg, p, xc)
    y = (h * gate).to(x.dtype)
    return apply_linear(p["out"], y, cfg.gemm_policy)


def rglru_cache_abstract(cfg: ModelConfig, b: int, cache_len: int) -> dict:
    w = cfg.lru_width
    return {
        "conv": ParamMeta((b, cfg.conv_width - 1, w), ("batch", None, "ssm_inner"), cfg.dtype, "zeros"),
        "h": ParamMeta((b, w), ("batch", "ssm_inner"), torch.float32, "zeros"),
    }


def rglru_prefill(cfg: ModelConfig, p, x, positions, cache):
    gate, xb = _rglru_in(cfg, p, x)
    xc, conv = _causal_conv(xb, p["conv_w"], p["conv_b"], cache["conv"] * 0)
    h = _rglru_apply_seq(cfg, p, xc)
    y = (h * gate).to(x.dtype)
    out = apply_linear(p["out"], y, cfg.gemm_policy)
    cache["conv"].copy_(conv)
    cache["h"].copy_(h[:, -1])
    return out, cache


def rglru_decode(cfg: ModelConfig, p, x, cache, pos):
    gate, xb = _rglru_in(cfg, p, x)
    xc, conv = _causal_conv(xb, p["conv_w"], p["conv_b"], cache["conv"])
    a, b = _rglru_gates(cfg, p, xc[:, 0])
    h = a * cache["h"] + b
    y = (h[:, None] * gate).to(x.dtype)
    out = apply_linear(p["out"], y, cfg.gemm_policy)
    cache["conv"].copy_(conv)
    cache["h"].copy_(h)
    return out, cache


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


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for a group of t tokens."""
    k = cfg.moe_topk
    return max(k, int(math.ceil(cfg.moe_capacity_factor * t * k / cfg.moe_experts)))


def _route(cfg: ModelConfig, router, xg):
    """One group's routing: the router's logits (a native float32
    product), their probabilities (T, E) (`jax.nn.softmax` op by op) and
    the top k of those (values, indices) from a stable descending sort, so
    that ties go to the lower index as in `jax.lax.top_k` (`torch.topk`
    leaves tie order open)."""
    rt = torch.promote_types(_F32, router.dtype)
    logits = (xg.to(_F32).to(rt) @ router.to(rt)).to(_F32)
    ex = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = ex / torch.sum(ex, dim=-1, keepdim=True)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_topk
    return logits, probs, top.values[:, :k], top.indices[:, :k]


def _moe_group(cfg: ModelConfig, p, xg):
    """GShard-style top-k dispatch for one token group. xg: (T, d)."""
    t = xg.shape[0]
    e = cfg.moe_experts
    dt = torch_dtype(cfg.dtype)
    cap = moe_capacity(cfg, t)
    _, probs, topv, topi = _route(cfg, p["router"], xg)
    topv = topv / torch.clamp_min(torch.sum(topv, dim=-1, keepdim=True), 1e-9)
    experts = torch.arange(e, device=xg.device)
    onehot = (topi[..., None] == experts).to(_F32)  # (T, K, E)
    # slot position of each (token, k) inside its expert queue
    pos_in_e = torch.cumsum(onehot.reshape(-1, e), dim=0).reshape(onehot.shape) - 1.0
    slot_idx = torch.sum(pos_in_e * onehot, dim=-1)  # (T, K)
    # a slot >= cap matches no column: an all-zero row, the capacity drop
    # (jax.nn.one_hot's behaviour; torch's one_hot would raise)
    slots = torch.arange(cap, dtype=torch.int32, device=xg.device)
    oh_slot = (slot_idx.to(torch.int32)[..., None] == slots).to(_F32)
    combine = _einsum("tke,tkc->tec", onehot * topv[..., None], oh_slot)
    dispatch = (combine > 0).to(dt)  # (T, E, C)
    xe = _einsum("td,tec->ecd", xg.to(dt), dispatch)  # (E, C, d)
    gate = silu(_einsum("ecd,edf->ecf", xe, p["gate"]).to(_F32))
    up = _einsum("ecd,edf->ecf", xe, p["up"]).to(_F32)
    ye = _einsum("ecf,efd->ecd", (gate * up).to(dt), p["down"])
    out = _einsum("ecd,tec->td", ye.to(_F32), combine)
    # load-balance aux loss (Switch): E * mean(frac_tokens * mean_prob)
    frac = torch.mean(onehot[:, 0, :], dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))
    return out.to(xg.dtype), aux


def moe_apply(cfg: ModelConfig, p, x, group_size: int | None = None):
    """The MoE MLP over groups of tokens, one group after another (the
    reference's `lax.scan`; its `vmap` branch for a mesh layout computes
    the same values), plus the shared SwiGLU expert under the policy."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    group_size = group_size or cfg.moe_group_size
    g = max(1, t // min(group_size, t))
    if t % g:
        g = 1
    ys, auxs = zip(*(_moe_group(cfg, p, xg) for xg in tokens.reshape(g, t // g, d)))
    y = torch.stack(ys).reshape(b, s, d)
    if cfg.moe_shared:
        y = y + apply_mlp("swiglu", p["shared"], x, cfg.gemm_policy)
    return y, torch.mean(torch.stack(auxs))


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
