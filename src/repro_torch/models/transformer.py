"""Generic decoder-only transformer LM (dense / GQA / SWA / MoE / embeds-in)
(port of ``repro/models/transformer.py``).

Covers qwen2-72b, mistral-nemo-12b, h2o-danube-3-4b, llama3.2-3b,
kimi-k2-1t-a32b, llama4-scout-17b-a16e and pixtral-12b (embeddings-in
stub).

``repro`` stacks layer parameters on a leading (L, ...) axis and applies
them with ``lax.scan``; here ``params["layers"]`` is an ``nn.ModuleList``
of per-layer trees and the scan is a loop. Caches keep ``repro``'s
stacked (L, B, T, K, hd) layout; ``decode_step`` writes them in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.attention import (
    _project_kv,
    attention,
    decode_attention,
    fill_cache,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.common import (
    ParamTree,
    cross_entropy_loss,
    embed_init,
    embed_lookup,
    pdtype,
    remat,
    rms_norm,
    rope,
    tied_unembed,
)
from repro_torch.models.mlp import init_mlp, init_moe, mlp, moe, moe_ep


def init_params(gen: torch.Generator, cfg, device=None) -> ParamTree:
    """Random weights drawn from ``gen`` on its own device, moved to
    ``device`` (default: the card; raises without one)."""
    dt = pdtype(cfg)
    zeros = dict(dtype=dt, device=gen.device)
    layers = []
    for _ in range(cfg.n_layers):
        p = {
            "ln1": torch.zeros((cfg.d_model,), **zeros),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "attn": init_attention(gen, cfg),
        }
        if cfg.is_moe:
            p["moe"] = init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
        layers.append(p)
    params = {
        "layers": layers,
        "final_norm": torch.zeros((cfg.d_model,), **zeros),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (cfg.d_model, cfg.vocab), dt)
    return ParamTree(params).to(resolve_device(device))


def _unembed(params, cfg):
    return (tied_unembed(params["embed"]) if cfg.tie_embeddings
            else params["unembed"])


def _ffn(cfg, lp, x):
    """The block's second half on ``x``: (output, aux). A MoE runs the
    expert-parallel ``moe_ep`` when ``cfg.moe_impl == "ep"`` and the mesh
    info is set (``hints.set_axes``), else the sort-based ``moe``, as
    ``repro``'s ``_moe_layer`` does."""
    h_in = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        info = hints.mesh_info() if cfg.moe_impl == "ep" else None
        if info is not None:
            mesh, ba, tp = info
            return moe_ep(lp["moe"], h_in, cfg, mesh, ba, tp)
        return moe(lp["moe"], h_in, cfg)
    return mlp(lp["mlp"], h_in), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def _embed_in(params, cfg, tokens, embeds):
    if cfg.input_embeds:
        x = embeds.to(pdtype(cfg))
    else:
        x = embed_lookup(params["embed"], tokens)
    return hints.constrain_acts(x)


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None].expand(b, s)


def forward(params, cfg, tokens, embeds=None):
    """Token (or embedding) sequence -> logits (B, S, V) and aux loss.
    Each layer runs under ``common.remat`` when ``cfg.remat``."""
    x = _embed_in(params, cfg, tokens, embeds)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(lp, x):
        h = attention(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                      positions, cfg)
        x = x + h
        h, a = _ffn(cfg, lp, x)
        return hints.constrain_acts(x + h), a

    block = remat(cfg, block)
    for lp in params["layers"]:
        x, a = block(lp, x)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = hints.constrain_logits(x @ _unembed(params, cfg))
    return logits, aux


def loss_fn(params, cfg, batch) -> torch.Tensor:
    logits, aux = forward(params, cfg, batch.get("tokens"), batch.get("embeds"))
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + 0.01 * aux


# ----------------------------- serving ------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """KV cache; sliding-window archs get a *rolling* cache of window
    length: O(window) state regardless of context. Slot = position %
    window; keys keep absolute RoPE. On ``device`` (default: the card;
    raises without one)."""
    length = max_len
    if cfg.sliding_window:
        length = min(max_len, cfg.sliding_window)
    one = init_kv_cache(batch, length, cfg, device=device)
    return {
        "k": one["k"].new_zeros((cfg.n_layers,) + one["k"].shape),
        "v": one["v"].new_zeros((cfg.n_layers,) + one["v"].shape),
    }


def prefill(params, cfg, tokens=None, embeds=None, cache=None):
    """Run the full prompt, filling the cache; returns (logits_last, cache).

    ``cache`` is written in place, as ``decode_step`` writes it: per layer
    the prompt's roped keys and values, zero-padded, or for a rolling
    cache shorter than the prompt its last ``max_len`` positions rolled to
    slot = position % max_len (``attention.fill_cache``; a placed cache
    in its placement). That is ``repro``'s new cache.
    """
    x = _embed_in(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = _positions(x)
    kc, vc = cache["k"], cache["v"]

    for i, lp in enumerate(params["layers"]):
        h_in = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k, v = _project_kv(lp["attn"], h_in, cfg)
        k = rope(k, positions, cfg.rope_theta)
        x = x + attention(lp["attn"], h_in, positions, cfg)
        h2, _ = _ffn(cfg, lp, x)
        fill_cache(kc[i], k)
        fill_cache(vc[i], v)
        x = hints.constrain_acts(x + h2)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1:] @ _unembed(params, cfg)
    return logits, {"k": kc, "v": vc}


def decode_step(params, cfg, cache, tokens, pos: int):
    """One decode step. tokens (B, 1); pos int. Returns (logits, cache),
    the cache written in place."""
    x = embed_lookup(params["embed"], tokens)
    cache_len = cache["k"].shape[2]
    use_roll = bool(cfg.sliding_window) and cache_len <= cfg.sliding_window
    for i, lp in enumerate(params["layers"]):
        h, _ = decode_attention(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), pos,
            {"k": cache["k"][i], "v": cache["v"][i]}, cfg,
            window=cfg.sliding_window,
            write_pos=pos % cache_len if use_roll else None,
        )
        x = x + h
        h2, _ = _ffn(cfg, lp, x)
        x = x + h2
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _unembed(params, cfg)
    return logits, {"k": cache["k"], "v": cache["v"]}
