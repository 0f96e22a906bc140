"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553; InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The InternViT vision frontend is a STUB: `input_specs()` supplies
precomputed patch embeddings (B, 256, d_model) prepended to the token
sequence (DESIGN.md S5)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    n_layers=48,
    d_model=6144,
    vocab=92553,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    mlp="swiglu",
    norm="rmsnorm",
    pos="rope",
    frontend="vision",
    n_prefix_embeds=256,
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    mlp="swiglu",
    norm="rmsnorm",
    pos="rope",
    frontend="vision",
    n_prefix_embeds=8,
)
