"""Kimi-K2: trillion-parameter MoE, 384 experts top-8, 1 shared expert
[arXiv:2501.kimi2 paper-table]. Adafactor (factored second moments, no fp32
master) keeps optimizer state within HBM at this scale."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    rope_theta=50_000.0,
    norm_eps=1e-6,
    optimizer="adafactor",
    num_microbatches=16,
)
