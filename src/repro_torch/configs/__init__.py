"""Assigned architecture configs (``--arch <id>``), port of
``repro/configs``.

Each module defines ``CONFIG`` (the exact public configuration); the tests
use ``CONFIG.reduced()``. ``dtw_search`` is the paper's own workload
config. Importing this package pulls in no search module: ``dtw_search``
imports the search stages only inside its helpers.
"""
from __future__ import annotations

from repro_torch.configs import (
    dtw_search,
    h2o_danube3_4b,
    kimi_k2_1t_a32b,
    llama3_2_3b,
    llama4_scout_17b_a16e,
    mamba2_130m,
    mistral_nemo_12b,
    pixtral_12b,
    qwen2_72b,
    recurrentgemma_2b,
    whisper_large_v3,
)
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

ARCHS: dict[str, ModelConfig] = {
    "qwen2-72b": qwen2_72b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "pixtral-12b": pixtral_12b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
}

SEARCH_CONFIG = dtw_search.CONFIG

__all__ = ["ARCHS", "SHAPES", "SEARCH_CONFIG", "ModelConfig", "ShapeConfig"]
