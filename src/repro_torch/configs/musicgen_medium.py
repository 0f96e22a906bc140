"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec/T5 frontends are STUBS: the backbone consumes discrete audio
tokens directly plus precomputed text-conditioning embeddings (B, 64, d)
as a prefix (prefix-LM approximation of MusicGen's cross-attention
conditioning; recorded in DESIGN.md S5)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    vocab=2048,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    mlp="gelu",
    norm="layernorm",
    pos="sinusoidal",
    frontend="audio",
    n_prefix_embeds=64,
)

REDUCED = ModelConfig(
    name="musicgen-medium-reduced",
    n_layers=2,
    d_model=128,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    mlp="gelu",
    norm="layernorm",
    pos="sinusoidal",
    frontend="audio",
    n_prefix_embeds=8,
)
