"""Mistral-Nemo-12B: dense GQA, 128k ctx, head_dim 128 (explicit)
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    num_microbatches=4,
)
