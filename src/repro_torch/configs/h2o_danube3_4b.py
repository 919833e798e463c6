"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. SWA makes it sub-quadratic -> runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    subquadratic=True,
    num_microbatches=2,
)
