"""Model configuration dataclass covering the 10 assigned architectures
(port of ``repro/models/config.py``).

One frozen dataclass; every architecture in ``repro_torch/configs/`` fills
the fields it needs. ``reduced()`` derives the small same-family config
used by the CPU tests.

The fields and defaults are ``repro``'s, so one config means the same
model in both packages. Training reads ``remat`` and ``remat_policy``
(activation checkpointing of each layer while autograd records,
``models.common.remat``), ``num_microbatches`` (``train.train_step``) and
``optimizer`` (``train.optimizer.init_opt`` / ``apply_opt``); serving runs
under ``no_grad`` and none of them changes it. ``scan_layers`` and
``tp_attn_dim`` shape how ``repro`` traces and shards a step; the port
accepts them for parity and does not read them (as
``configs/dtw_search.py`` does with ``rows_per_step``). ``moe_impl="ep"``
runs ``mlp.moe_ep`` while ``hints.mesh_info()`` is set and the
sort-based ``mlp.moe`` otherwise, as in ``repro``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0         # 0 -> full attention
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden (0 -> d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dense"         # dense | ep (shard_map expert parallel)

    # hybrid (RG-LRU / Griffin)
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 0

    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4

    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    cross_attn: bool = False

    # modality frontend stub: model consumes precomputed embeddings
    input_embeds: bool = False

    # numerics / training
    dtype: str = "bfloat16"         # parameter/activation dtype
    remat: bool = True              # activation checkpointing per layer
    remat_policy: str = "full"      # full | dots
    scan_layers: bool = True        # scan-over-layers (repro only)
    optimizer: str = "adamw"        # adamw | adafactor
    num_microbatches: int = 1

    # which attention dim the "model" axis shards: "heads" | "head_dim"
    tp_attn_dim: str = "heads"

    # long-context capability (sub-quadratic): used to gate long_500k cells
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ModelConfig":
        """Same-family miniature for CPU smoke tests."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv else 0,
            head_dim=16,
            d_ff=128,
            vocab=256,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            lru_width=64 if self.lru_width else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 64,
            n_enc_layers=min(self.n_enc_layers, 2),
            dtype="float32",
            num_microbatches=1,
        )
        if self.block_pattern:
            changes["block_pattern"] = self.block_pattern
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
