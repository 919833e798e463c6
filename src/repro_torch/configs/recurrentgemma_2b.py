"""RecurrentGemma-2B (Griffin): RG-LRU + local attention 1:2
[arXiv:2402.19427]. O(1) recurrent state -> runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    sliding_window=2048,
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    subquadratic=True,
    num_microbatches=2,
)
