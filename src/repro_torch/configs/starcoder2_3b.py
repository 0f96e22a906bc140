"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA, RoPE, 4096 sliding window [arXiv:2402.19173; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    n_layers=30,
    d_model=3072,
    vocab=49152,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    qkv_bias=True,
    d_ff=12288,
    mlp="gelu",
    norm="layernorm",
    pos="rope",
    window=4096,
)

REDUCED = ModelConfig(
    name="starcoder2-3b-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    qkv_bias=True,
    d_ff=256,
    mlp="gelu",
    norm="layernorm",
    pos="rope",
    window=64,
)
