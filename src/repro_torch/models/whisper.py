"""Whisper-large-v3 backbone: transformer encoder-decoder (port of
``repro/models/whisper.py``).

The conv frontend is a stub, as in ``repro``: precomputed frame embeddings
(B, S, D) go straight into the encoder. Encoder layers are bidirectional;
decoder layers are causal self-attention + cross-attention to the encoder
output. Sinusoidal positions, MHA (kv == q heads), pre-LN.

``enc_layers`` and ``dec_layers`` are per-layer lists (``repro`` stacks
them). ``decode_step`` writes the self-attention cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.attention import (
    _project_kv,
    attention,
    decode_attention,
    decode_cross_attention,
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
    sinusoidal_positions,
    tied_unembed,
)
from repro_torch.models.mlp import init_mlp, mlp


def init_params(gen: torch.Generator, cfg, device=None) -> ParamTree:
    dt = pdtype(cfg)

    def ln():
        return torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)

    enc_layers = [
        {"ln1": ln(), "ln2": ln(), "attn": init_attention(gen, cfg),
         "mlp": init_mlp(gen, cfg)}
        for _ in range(cfg.n_enc_layers or cfg.n_layers)
    ]
    dec_layers = [
        {"ln1": ln(), "ln2": ln(), "ln3": ln(),
         "self_attn": init_attention(gen, cfg),
         "cross_attn": init_attention(gen, cfg, cross=True),
         "mlp": init_mlp(gen, cfg)}
        for _ in range(cfg.n_layers)
    ]
    params = {
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "enc_norm": ln(),
        "dec_norm": ln(),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
    }
    return ParamTree(params).to(resolve_device(device))


def _positions(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_audio, D) stub embeddings -> encoder states."""
    b, s, _ = frames.shape
    x = frames.to(pdtype(cfg))
    x = x + sinusoidal_positions(s, cfg.d_model, x.device)[None].to(x.dtype)
    x = hints.constrain_acts(x)
    positions = _positions(b, s, x.device)

    def body(lp, x):
        h = attention(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions, cfg,
            causal=False, use_rope=False,
        )
        x = x + h
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        return hints.constrain_acts(x)

    body = remat(cfg, body)
    for lp in params["enc_layers"]:
        x = body(lp, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params, cfg, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder -> logits (B, S_dec, V)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device)[None].to(x.dtype)
    x = hints.constrain_acts(x)
    positions = _positions(b, s, x.device)

    def body(lp, x, enc_out):
        h = attention(
            lp["self_attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            cfg, use_rope=False,
        )
        x = x + h
        h = attention(
            lp["cross_attn"], rms_norm(x, lp["ln2"], cfg.norm_eps), positions,
            cfg, kv_x=enc_out, causal=False, use_rope=False,
        )
        x = x + h
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln3"], cfg.norm_eps))
        return hints.constrain_acts(x)

    body = remat(cfg, body)
    for lp in params["dec_layers"]:
        x = body(lp, x, enc_out)
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return hints.constrain_logits(x @ tied_unembed(params["embed"]))


def forward(params, cfg, tokens=None, embeds=None):
    enc_out = encode(params, cfg, embeds)
    logits = decode_train(params, cfg, enc_out, tokens)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, cfg, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, tokens=batch["tokens"], embeds=batch["embeds"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


# ----------------------------- serving ------------------------------------


def init_cache(cfg, batch: int, max_len: int, enc_len: int | None = None,
               device=None) -> dict:
    """Decoder self-attn KV cache + precomputed encoder cross K/V."""
    device = resolve_device(device)
    one = init_kv_cache(batch, max_len, cfg, device=device)
    el = enc_len or max_len
    enc = (cfg.n_layers, batch, el, cfg.n_kv, cfg.head_dim)
    return {
        "k": one["k"].new_zeros((cfg.n_layers,) + one["k"].shape),
        "v": one["v"].new_zeros((cfg.n_layers,) + one["v"].shape),
        "ek": torch.zeros(enc, dtype=pdtype(cfg), device=device),
        "ev": torch.zeros(enc, dtype=pdtype(cfg), device=device),
    }


def prefill_encoder(params, cfg, frames: torch.Tensor, cache: dict) -> dict:
    """Run the encoder and stash per-layer cross K/V into the cache (a
    placed cache in place, in its placement, its encoder length the
    frames')."""
    enc_out = encode(params, cfg, frames)
    kvs = [_project_kv(lp["cross_attn"], enc_out, cfg)
           for lp in params["dec_layers"]]
    if hasattr(cache["ek"], "device_mesh"):
        # a placed cache is written in place, shard by shard
        for i, (k, v) in enumerate(kvs):
            fill_cache(cache["ek"][i], k)
            fill_cache(cache["ev"][i], v)
        return {**cache}
    ek = torch.stack([k for k, _ in kvs])
    ev = torch.stack([v for _, v in kvs])
    return {**cache, "ek": ek, "ev": ev}


def decode_step(params, cfg, cache, tokens, pos: int):
    """One decode step. The position row is clamped into the table of the
    cache's length, as ``dynamic_slice`` clamps its start."""
    x = embed_lookup(params["embed"], tokens)
    t = cache["k"].shape[2]
    row = min(max(int(pos), 0), t - 1)
    table = sinusoidal_positions(t, cfg.d_model, x.device).to(x.dtype)
    x = x + table[row:row + 1][None]
    for i, lp in enumerate(params["dec_layers"]):
        h, _ = decode_attention(
            lp["self_attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), pos,
            {"k": cache["k"][i], "v": cache["v"][i]}, cfg, use_rope=False,
        )
        x = x + h
        h = decode_cross_attention(
            lp["cross_attn"], rms_norm(x, lp["ln2"], cfg.norm_eps),
            cache["ek"][i], cache["ev"][i], cfg,
        )
        x = x + h
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln3"], cfg.norm_eps))
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return x @ tied_unembed(params["embed"]), {**cache}
