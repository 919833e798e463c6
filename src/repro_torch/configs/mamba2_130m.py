"""Mamba2-130M: SSD (state-space duality), attention-free
[arXiv:2405.21060]. Runs every shape including long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv=0,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    tie_embeddings=True,
    norm_eps=1e-5,
    subquadratic=True,
)
