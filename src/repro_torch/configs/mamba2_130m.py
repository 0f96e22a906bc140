"""mamba2-130m [ssm] — 24L d_model=768 attn-free, ssm_state=128,
vocab=50280; SSD state-space duality [arXiv:2405.21060].

Pure Mamba2 blocks (no attention, no MLP: d_ff=0); d_inner = 2*768 = 1536,
headdim=64 -> 24 SSD heads.  Sub-quadratic: runs the long_500k shape."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    vocab=50280,
    d_ff=0,
    block_pattern=("ssd",),
    norm="rmsnorm",
    pos="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    n_layers=2,
    d_model=128,
    vocab=512,
    d_ff=0,
    block_pattern=("ssd",),
    norm="rmsnorm",
    pos="none",
    ssm_state=32,
    ssm_expand=2,
    ssm_headdim=32,
    conv_width=4,
    tie_embeddings=True,
)
