"""Llama-4-Scout-17B-16E: MoE, 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    rope_theta=500_000.0,
    norm_eps=1e-5,
    num_microbatches=8,
)
