"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention 1:2 [arXiv:2402.19427; hf].

Griffin pattern: (rglru, rglru, attn) repeating; local window 2048; GeGLU
MLP (7680 = 3x expansion).  Sub-quadratic: runs the long_500k shape
(windowed KV ring buffer + constant-size LRU state)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    vocab=256000,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    mlp="geglu",
    norm="rmsnorm",
    pos="rope",
    window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    conv_width=4,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced",
    n_layers=3,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=384,
    mlp="geglu",
    norm="rmsnorm",
    pos="rope",
    window=32,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=128,
    conv_width=4,
    tie_embeddings=True,
)
