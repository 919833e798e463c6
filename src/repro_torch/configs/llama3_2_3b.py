"""Llama-3.2-3B: small llama3, tied embeddings [hf:meta-llama/Llama-3.2]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
    norm_eps=1e-5,
    num_microbatches=2,
)
