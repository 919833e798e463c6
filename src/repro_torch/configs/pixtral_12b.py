"""Pixtral-12B backbone: pixtral-ViT frontend (STUB: precomputed patch
embeddings) + Mistral-Nemo decoder [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    input_embeds=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    num_microbatches=4,
)
