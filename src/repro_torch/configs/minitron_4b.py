"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000; pruned nemotron (squared-ReLU) [arXiv:2407.14679; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    vocab=256000,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    mlp="sq_relu",
    norm="layernorm",
    pos="rope",
    rope_pct=0.5,
)

REDUCED = ModelConfig(
    name="minitron-4b-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=192,
    mlp="sq_relu",
    norm="layernorm",
    pos="rope",
    rope_pct=0.5,
)
