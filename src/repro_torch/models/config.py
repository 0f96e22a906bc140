"""Model configuration: one dataclass covers all 10 architectures.

The port's copy of `repro.models.config`, field for field.  Per-layer
block types come from `block_pattern` (cycled over layers):
  'attn'  — GQA attention block (optionally windowed)
  'ssd'   — Mamba2 state-space-duality block
  'rglru' — RecurrentGemma RG-LRU recurrent block
MLP variants: 'swiglu' | 'gelu' | 'sq_relu' | 'geglu' | 'moe'.

`dtype` stays a name ('bfloat16', 'float32'); `params.torch_dtype` gives
the torch dtype.  The fields that lay activations out over a mesh
(`act_pspec`, `embed_pspec`, `moe_dispatch_pspec`) and `scan_unroll` (the
reference's cost-analysis lowering) have no effect on one card; they stay
so that a reference config carries over field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.policy import GemmPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    window: int | None = None          # local attention window (tokens)
    attn_logit_softcap: float | None = None
    # position encoding: 'rope' | 'sinusoidal' | 'none'
    pos: str = "rope"
    rope_pct: float = 1.0
    rope_theta: float = 10000.0
    # mlp
    d_ff: int = 0
    mlp: str = "swiglu"
    norm: str = "rmsnorm"              # 'rmsnorm' | 'layernorm'
    block_pattern: Tuple[str, ...] = ("attn",)
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    # rg-lru (recurrentgemma)
    lru_width: int = 0
    # moe
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0                # always-on shared experts (deepseek)
    moe_capacity_factor: float = 1.25
    first_dense_ff: int = 0            # dense FFN in layer 0 (deepseek)
    # modality frontend stubs
    frontend: str | None = None        # 'vision' | 'audio' | None
    n_prefix_embeds: int = 0           # precomputed patch/conditioning embeds
    # misc
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Matmul policy for every linear in the model.  None (the default)
    # resolves to the ambient `repro_torch.use_policy` scope at config
    # construction, so `with use_policy(p): cfg = get_config(...)` pins p
    # into the (hashable) config; with no active scope it resolves to the
    # native policy.  An explicit GemmPolicy always wins.
    gemm_policy: GemmPolicy | None = None
    # recompute each layer in the backward (torch.utils.checkpoint)
    remat: bool = True
    # mesh layouts of the reference (no effect on one card)
    act_pspec: tuple | None = None
    embed_pspec: tuple | None = None
    # attention KV-chunk (online-softmax block) and MoE dispatch group sizes
    kv_chunk: int = 1024
    moe_group_size: int = 2048
    moe_dispatch_pspec: tuple | None = None  # no effect on one card
    # the reference's fully unrolled cost lowering (no effect here: the
    # port loops over layers in Python)
    scan_unroll: bool = False
    # chunked-vocab cross entropy: logits/logsumexp over vocab slabs of
    # this size, never the whole (B, S, vocab) f32 logits
    loss_vocab_chunk: int | None = None

    def __post_init__(self):
        if self.gemm_policy is None:
            from ..linalg import current_policy

            # frozen dataclass: resolve the ambient policy in place (runs
            # again on dataclasses.replace, so replace(cfg, gemm_policy=None)
            # re-reads the scope while plain replace keeps the pinned value)
            object.__setattr__(self, "gemm_policy", current_policy())

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def mlp_kind(self, layer: int) -> str:
        if self.mlp == "moe":
            return "dense_first" if (layer == 0 and self.first_dense_ff) else "moe"
        if self.d_ff == 0:
            return "none"
        return self.mlp

    @property
    def layer_groups(self) -> Tuple[Tuple[str, str, int], ...]:
        """Consecutive (block_kind, mlp_kind, count) runs, each with its
        params stacked along a leading layer axis."""
        kinds = [(self.block_kind(i), self.mlp_kind(i)) for i in range(self.n_layers)]
        groups: list[list] = []
        for bk, mk in kinds:
            if groups and groups[-1][0] == bk and groups[-1][1] == mk:
                groups[-1][2] += 1
            else:
                groups.append([bk, mk, 1])
        return tuple(tuple(g) for g in groups)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                total += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                total += self.n_heads * self.head_dim * d
            elif kind == "ssd":
                di, ng, ns = self.d_inner, self.ssm_ngroups, self.ssm_state
                total += d * (2 * di + 2 * ng * ns + self.ssm_heads) + di * d
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 3 * w * w // w  # proj + gates
            total += self._mlp_params(i)
        return total

    def _mlp_params(self, layer: int) -> int:
        d = self.d_model
        if self.mlp == "moe" and not (layer == 0 and self.first_dense_ff):
            e = self.moe_experts
            per = 3 * d * self.d_ff
            shared = 3 * d * self.d_ff * self.moe_shared
            return e * per + shared + d * e  # + router
        ff = self.first_dense_ff if (layer == 0 and self.first_dense_ff) else self.d_ff
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mult * d * ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.mlp != "moe":
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = (self.moe_experts - self.moe_topk) * 3 * d * self.d_ff
        n_moe_layers = self.n_layers - (1 if self.first_dense_ff else 0)
        return total - inactive * n_moe_layers
