"""Whisper-large-v3 backbone: 32-layer encoder + 32-layer decoder, MHA,
conv frontend STUB (precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    cross_attn=True,
    input_embeds=True,
    norm_eps=1e-5,
    tie_embeddings=True,
    num_microbatches=2,
)
