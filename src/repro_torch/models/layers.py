"""Shared building blocks: norms, linears, RoPE, attention and MLPs.

The port's copy of `repro.models.layers`: plain functions on tensors and
dict params.  Every linear goes through `repro_torch.linalg.matmul` under
the config's `GemmPolicy`, so any layer runs on the emulated GEMM (the
reference execution or the card's kernels) as user code does.  The rest
is plain PyTorch in float32 where the reference computes in float32.

Attention is the reference's blockwise online softmax over KV chunks
(`repro.models.layers.attention`), in torch ops; no model calls the
attention kernel (`repro_torch.kernels.flash_attention`), as in the
reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import linalg
from ..core.policy import GemmPolicy
from .params import ParamMeta

_F32 = torch.float32
_NEG = -1e30  # the masked logit and the running max's start

# ---------------------------------------------------------------- norms


def norm_abstract(kind: str, d: int, dtype) -> dict:
    out = {"scale": ParamMeta((d,), ("embed",), dtype, "ones")}
    if kind == "layernorm":
        out["bias"] = ParamMeta((d,), ("embed",), dtype, "zeros")
    return out


def apply_norm(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p["scale"].to(_F32)).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * p["scale"].to(_F32) + p["bias"].to(_F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------- linear


def linear_abstract(d_in, d_out, axes, dtype, bias=False, scale=None) -> dict:
    out = {"w": ParamMeta((d_in, d_out), axes, dtype, "normal", scale)}
    if bias:
        out["b"] = ParamMeta((d_out,), (axes[1],), dtype, "zeros")
    return out


def apply_linear(p: dict, x: torch.Tensor, policy: GemmPolicy) -> torch.Tensor:
    """p["w"] may be a (k, n) tensor or a right-side `PreparedOperand`
    (weights residue-cast once by `core.policy.prepare_weights`: the
    weight-stationary serving path); `linalg.matmul` takes both.  Computes
    on x's device."""
    y = linalg.matmul(x, p["w"], policy=policy, device=x.device)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------- rope


def rope_frequencies(head_dim: int, pct: float, theta: float, device=None) -> torch.Tensor:
    rot = int(head_dim * pct) // 2 * 2
    return 1.0 / theta ** (torch.arange(0, rot, 2, dtype=_F32, device=device) / rot)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, pct: float, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int32.  Rotates the first
    int(D * pct) // 2 * 2 features (partial rotary when pct < 1)."""
    d = x.shape[-1]
    rot = int(d * pct) // 2 * 2
    freqs = rope_frequencies(d, pct, theta, device=x.device)  # (rot/2,)
    ang = positions[..., None].to(_F32) * freqs  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., : rot // 2].to(_F32)
    x2 = x[..., rot // 2: rot].to(_F32)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2], dim=-1).to(x.dtype)
    if rot < d:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=_F32, device=positions.device) / half)
    ang = positions[..., None].to(_F32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- attention


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int | None = None
    softcap: float | None = None
    kv_chunk: int = 1024


def _apply_logit_mods(logits, spec: AttnSpec, q_pos, kv_pos, kv_valid=None):
    if spec.softcap:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool, device=logits.device)
    if spec.causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if spec.window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < spec.window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    return logits.masked_fill(~mask, _NEG)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttnSpec,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blockwise (flash-semantics) GQA attention in torch ops.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H = KV * G.  An online
    softmax over KV chunks of `spec.kv_chunk` (one block when Skv is not a
    multiple of it), in float32, as the reference's scan.
    """
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, g, d).to(_F32) * scale

    chunk = min(spec.kv_chunk, skv)
    if skv % chunk:
        chunk = skv  # fall back to one block for ragged sizes
    m = torch.full((b, kv, g, sq), _NEG, dtype=_F32, device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=_F32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, d), dtype=_F32, device=q.device)
    for t0 in range(0, skv, chunk):
        sl = slice(t0, t0 + chunk)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, k[:, sl].to(_F32))
        logits = _apply_logit_mods(logits, spec, q_pos, kv_pos[sl],
                                   None if kv_valid is None else kv_valid[sl])
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v[:, sl].to(_F32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------- mlps


def mlp_abstract(cfg_mlp: str, d: int, ff: int, dtype) -> dict:
    if cfg_mlp in ("swiglu", "geglu"):
        return {
            "gate": linear_abstract(d, ff, ("embed", "ff"), dtype),
            "up": linear_abstract(d, ff, ("embed", "ff"), dtype),
            "down": linear_abstract(ff, d, ("ff", "embed"), dtype),
        }
    return {
        "up": linear_abstract(d, ff, ("embed", "ff"), dtype),
        "down": linear_abstract(ff, d, ("ff", "embed"), dtype),
    }


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as JAX rounds a weak-typed constant to
    the array's dtype (sqrt(2/pi) is 0.796875 in bfloat16)."""
    return float(torch.tensor(value, dtype=dtype))


class _Logistic(torch.autograd.Function):
    """`lax.logistic`: 1 / (1 + exp(-x)) op by op in x's dtype, with JAX's
    derivative, g * (s * (1 - s)).  Autograd through the quotient would
    multiply a zero by exp(-x) = inf where x is very negative, which is
    NaN; JAX's rule stays finite there."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def logistic(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` (`lax.logistic`), differentiable as JAX's."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * logistic(x), op by op in x's dtype."""
    return x * logistic(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` at its default, the tanh approximation, op by op in
    x's dtype with its constants rounded to that dtype, as JAX computes it
    (in bfloat16 the bits of the reference's CPU run; torch's own
    ``F.gelu(approximate="tanh")`` keeps float32 constants)."""
    c = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * x**3)))
    return x * cdf


def apply_mlp(cfg_mlp: str, p: dict, x: torch.Tensor, policy: GemmPolicy) -> torch.Tensor:
    if cfg_mlp in ("swiglu", "geglu"):
        act = silu if cfg_mlp == "swiglu" else gelu
        g = act(apply_linear(p["gate"], x, policy))
        u = apply_linear(p["up"], x, policy)
        return apply_linear(p["down"], g * u, policy)
    h = apply_linear(p["up"], x, policy)
    if cfg_mlp == "gelu":
        h = gelu(h)
    elif cfg_mlp == "sq_relu":  # nemotron squared-ReLU
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(f"unknown mlp {cfg_mlp!r}")
    return apply_linear(p["down"], h, policy)
