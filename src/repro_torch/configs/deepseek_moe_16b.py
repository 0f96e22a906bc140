"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400; 2 shared + 64 routed top-6, fine-grained; dense FFN
(ff=10944) in layer 0 [arXiv:2401.06066; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    vocab=102400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    mlp="moe",
    moe_experts=64,
    moe_topk=6,
    moe_shared=2,
    first_dense_ff=10944,
    norm="rmsnorm",
    pos="rope",
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-reduced",
    n_layers=3,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=64,
    mlp="moe",
    moe_experts=8,
    moe_topk=2,
    moe_shared=1,
    first_dense_ff=256,
    norm="rmsnorm",
    pos="rope",
)
