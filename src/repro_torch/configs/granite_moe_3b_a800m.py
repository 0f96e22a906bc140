"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155; 40 experts top-8 [hf:ibm-granite family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    vocab=49155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    mlp="moe",
    moe_experts=40,
    moe_topk=8,
    norm="rmsnorm",
    pos="rope",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=64,
    mlp="moe",
    moe_experts=8,
    moe_topk=2,
    norm="rmsnorm",
    pos="rope",
    tie_embeddings=True,
)
