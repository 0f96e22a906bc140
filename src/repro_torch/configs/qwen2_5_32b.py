"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064; GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    vocab=152064,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    qkv_bias=True,
    d_ff=27648,
    mlp="swiglu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2.5-32b-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    qkv_bias=True,
    d_ff=256,
    mlp="swiglu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1e6,
)
