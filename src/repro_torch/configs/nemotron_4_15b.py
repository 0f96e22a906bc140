"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU MLP, partial RoPE [arXiv:2402.16819]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    vocab=256000,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    mlp="sq_relu",
    norm="layernorm",
    pos="rope",
    rope_pct=0.5,
)

REDUCED = ModelConfig(
    name="nemotron-4-15b-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    mlp="sq_relu",
    norm="layernorm",
    pos="rope",
    rope_pct=0.5,
)
