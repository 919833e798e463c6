"""Shape-and-dtype stand-ins for every (architecture x shape) cell (port
of ``repro/launch/input_specs.py``).

Nothing here allocates: the dry-run (``launch.dryrun``) traces the train
step, prefill and decode against these records only, turning each into a
fake tensor. A ``Spec`` is ``repro``'s ``jax.ShapeDtypeStruct``: a shape
and a dtype (tokens and labels int32, embeddings bfloat16, ``pos`` a 0-d
int32). Modality frontends are stubs, as in ``repro``: ``[vlm]`` and
``[audio]`` cells feed precomputed patch or frame embeddings of the
cell's sequence length. ``cache_shapes`` gives the cache as meta tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


class Spec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict = {"labels": Spec((b, s), torch.int32)}
    if cfg.input_embeds:
        batch["embeds"] = Spec((b, s, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            batch["tokens"] = Spec((b, s), torch.int32)
    else:
        batch["tokens"] = Spec((b, s), torch.int32)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_embeds:
        return {"embeds": Spec((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": Spec((b, s), torch.int32)}


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {
        "tokens": Spec((b, 1), torch.int32),
        "pos": Spec((), torch.int32),
    }


def cache_shapes(model, shape: ShapeConfig):
    """The KV / state cache of a decode cell (``seq_len`` of context) as
    meta tensors."""
    return model.init_cache(shape.global_batch, shape.seq_len, "meta")


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (False, reason) if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention; long_500k requires sub-quadratic"
    return True, ""
