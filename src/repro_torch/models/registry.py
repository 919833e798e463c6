"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

``Model`` has ``repro``'s fields and call signatures, so a caller says
``model.forward(params, tokens=...)``, ``model.prefill(params, cache,
tokens=...)`` and ``model.decode_step(params, cache, tok, pos)`` to either
package. ``init(generator, device=None)`` takes a ``torch.Generator`` in
place of a JAX key (weights are drawn on the generator's device and moved
to ``device``), and ``init_cache(b, s, device=None)`` a device. Both are
entry points: with no device they put their tensors on the card, and
raise when there is none; pass ``device="cpu"`` for the CPU.
``init(None, "meta")`` and ``init_cache(b, s, "meta")`` draw and allocate
nothing: they give meta tensors of the real shapes and dtypes, which the
sharding rules read (``repro``'s ``jax.eval_shape``). As in
``repro``, the hybrid family has no ``prefill``, and whisper's ``prefill``
runs the encoder on ``embeds`` and returns only the cache.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.distributed import hints
from repro_torch.models import mamba2, rglru, transformer, whisper
from repro_torch.models.common import init_generator
from repro_torch.models.config import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss_fn: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    prefill: Callable[..., Any] | None = None


def _build(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        mod = transformer
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: mod.init_params(
                init_generator(gen, device), cfg, device),
            forward=lambda p, **kw: mod.forward(p, cfg, kw.get("tokens"), kw.get("embeds")),
            loss_fn=lambda p, batch: mod.loss_fn(p, cfg, batch),
            init_cache=lambda b, s, device=None: mod.init_cache(cfg, b, s, device),
            decode_step=lambda p, cache, tok, pos: mod.decode_step(p, cfg, cache, tok, pos),
            prefill=lambda p, cache, **kw: mod.prefill(
                p, cfg, kw.get("tokens"), kw.get("embeds"), cache
            ),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: rglru.init_params(
                init_generator(gen, device), cfg, device),
            forward=lambda p, **kw: rglru.forward(p, cfg, kw.get("tokens")),
            loss_fn=lambda p, batch: rglru.loss_fn(p, cfg, batch),
            init_cache=lambda b, s, device=None: rglru.init_cache(cfg, b, s, device),
            decode_step=lambda p, cache, tok, pos: rglru.decode_step(p, cfg, cache, tok, pos),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: mamba2.init_params(
                init_generator(gen, device), cfg, device),
            forward=lambda p, **kw: mamba2.forward(p, cfg, kw.get("tokens")),
            loss_fn=lambda p, batch: mamba2.loss_fn(p, cfg, batch),
            init_cache=lambda b, s, device=None: mamba2.init_cache(cfg, b, s, device),
            decode_step=lambda p, cache, tok, pos: mamba2.decode_step(p, cfg, cache, tok, pos),
            prefill=lambda p, cache, **kw: mamba2.prefill(p, cfg, cache, kw["tokens"]),
        )
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: whisper.init_params(
                init_generator(gen, device), cfg, device),
            forward=lambda p, **kw: whisper.forward(
                p, cfg, tokens=kw.get("tokens"), embeds=kw.get("embeds")
            ),
            loss_fn=lambda p, batch: whisper.loss_fn(p, cfg, batch),
            init_cache=lambda b, s, device=None: whisper.init_cache(
                cfg, b, s, device=device),
            decode_step=lambda p, cache, tok, pos: whisper.decode_step(p, cfg, cache, tok, pos),
            prefill=lambda p, cache, **kw: whisper.prefill_encoder(
                p, cfg, kw["embeds"], cache
            ),
        )
    raise ValueError(f"unknown family {cfg.family!r}")


def _spmd(fn):
    """``fn`` with plain tensors counted as replicated while sharding axes
    are set (``hints.replicated_plain``), so a forward over placed
    parameters and batch runs as one program on every rank."""
    if fn is None:
        return None

    def run(*args, **kwargs):
        with hints.replicated_plain():
            return fn(*args, **kwargs)

    return run


def build(cfg: ModelConfig) -> Model:
    m = _build(cfg)
    return m._replace(**{k: _spmd(getattr(m, k)) for k in (
        "forward", "loss_fn", "decode_step", "prefill")})
