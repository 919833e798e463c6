"""RecurrentGemma / Griffin: RG-LRU recurrent blocks + local attention (1:2)
(port of ``repro/models/rglru.py``).

Block pattern (cfg.block_pattern, default ("rec", "rec", "attn")): two
recurrent blocks per local-attention block. The RG-LRU recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = sigmoid(gate)^(c) with c = 8 softplus temperature (Griffin eq. 5)

is ``repro``'s ``associative_scan`` over the sequence, ``common.linear_scan``
here. Decode carries the (B, lru_width) recurrent state and a conv tail
instead of a KV cache. ``repro`` has no prefill for this family, and
neither has the port.

Parameters keep ``repro``'s split: ``groups``, a list of whole pattern
groups (each a list of ``len(pattern)`` blocks; ``repro`` stacks them on
a leading axis), and ``remainder``, the ``n_layers % len(pattern)`` blocks
left over. Caches keep ``repro``'s layout (``grouped`` stacked over
groups, ``rem`` per block) and ``decode_step`` writes them in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.attention import (
    attention,
    decode_attention,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.common import (
    ParamTree,
    cross_entropy_loss,
    dense_init,
    embed_init,
    embed_lookup,
    gelu,
    linear_scan,
    pdtype,
    remat,
    rms_norm,
    softplus,
    tied_unembed,
)
from repro_torch.models.mlp import init_mlp, mlp

C_TEMP = 8.0


def _pattern(cfg):
    return cfg.block_pattern or ("rec", "rec", "attn")


def init_rglru_block(gen, cfg) -> dict:
    dt = pdtype(cfg)
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    lin = torch.linspace(0.9, 0.999, w, device=gen.device)
    return {
        "w_x": dense_init(gen, (d, w), dt),       # input branch
        "w_gate_in": dense_init(gen, (d, w), dt),  # multiplicative gate branch
        "conv_w": dense_init(gen, (cfg.conv_width, w), dt) * 0.1,
        "a_gate": dense_init(gen, (w, w), dt),
        "i_gate": dense_init(gen, (w, w), dt),
        "a_param": torch.log(torch.expm1(lin)).to(dt),
        "w_out": dense_init(gen, (w, d), dt),
    }


def _rg_lru(p, x, h0=None):
    """x: (B, S, W). Returns (y, h_last)."""
    bsz, s, w = x.shape
    xf = x.float()
    gate_a = torch.sigmoid(xf @ p["a_gate"].float())
    gate_i = torch.sigmoid(xf @ p["i_gate"].float())
    log_a0 = -C_TEMP * softplus(p["a_param"].float())
    log_a = gate_a * log_a0[None, None, :]          # (B, S, W), <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    inp = mult * gate_i * xf

    if h0 is not None:
        # fold the initial state in as a virtual first element
        a = torch.cat([a.new_ones((bsz, 1, w)), a], dim=1)
        inp = torch.cat([h0[:, None, :].float(), inp], dim=1)

    _, h = linear_scan(a, inp, dim=1)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


_LRU_PARAMS = ("a_gate", "i_gate", "a_param")


def _rg_lru_per_shard(p, x, h0=None):
    """``_rg_lru`` on each rank's batch rows when ``x`` is a DTensor
    (``hints.on_batch_rows``; the recurrence whole over ``"model"``, as
    mamba2's mixer): through the gates' products and the scan DTensor
    splits the token rows over ``"model"`` in the backward, where a
    product on such rows has no sharding rule."""
    return hints.on_batch_rows(_rg_lru, {k: p[k] for k in _LRU_PARAMS},
                               x, h0)


def _lru(p, x, h0=None):
    lru = _rg_lru_per_shard if hasattr(x, "device_mesh") else _rg_lru
    return lru(p, x, h0)


def _conv1d(p, x, tail=None):
    """Causal depthwise conv, width cfg.conv_width. x (B,S,W)."""
    k = p["conv_w"].shape[0]
    if tail is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(
        xp[:, i: xp.shape[1] - (k - 1 - i)] * p["conv_w"][i][None, None, :]
        for i in range(k)
    )
    return out, xp[:, -(k - 1):]


def rglru_block(p, x, h0=None, conv_tail=None):
    """Full recurrent block: gated branch * (conv -> RG-LRU) -> out proj."""
    gate = gelu(x @ p["w_gate_in"])
    u = x @ p["w_x"]
    u, new_tail = _conv1d(p, u, conv_tail)
    y, h_last = _lru(p, u, h0)
    return hints.row_parallel((y * gate) @ p["w_out"]), h_last, new_tail


def _init_block(gen, cfg, kind) -> dict:
    dt = pdtype(cfg)
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if kind == "rec":
        p["rec"] = init_rglru_block(gen, cfg)
    else:
        p["attn"] = init_attention(gen, cfg)
    p["mlp"] = init_mlp(gen, cfg)
    return p


def init_params(gen: torch.Generator, cfg, device=None) -> ParamTree:
    pattern = _pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    rem = cfg.n_layers - n_groups * len(pattern)
    groups = [[_init_block(gen, cfg, kind) for kind in pattern]
              for _ in range(n_groups)]
    remainder = [_init_block(gen, cfg, pattern[i % len(pattern)])
                 for i in range(rem)]
    dt = pdtype(cfg)
    params = {
        "groups": groups,
        "remainder": remainder,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
    }
    return ParamTree(params).to(resolve_device(device))


def _apply_block(cfg, x, positions, p, kind):
    # attention blocks use the local window: the config sets
    # ``sliding_window == local_window`` so attention() masks correctly.
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h, _, _ = rglru_block(p["rec"], h_in)
    else:
        h = attention(p["attn"], h_in, positions, cfg)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x


def forward(params, cfg, tokens, embeds=None):
    x = hints.constrain_acts(embed_lookup(params["embed"], tokens))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    pattern = _pattern(cfg)

    def body(gp, x):  # one pattern group, under remat as repro's scan body
        for i, kind in enumerate(pattern):
            x = _apply_block(cfg, x, positions, gp[i], kind)
        return hints.constrain_acts(x)

    body = remat(cfg, body)
    for gp in params["groups"]:
        x = body(gp, x)
    for i, p in enumerate(params["remainder"]):
        x = _apply_block(cfg, x, positions, p, pattern[i % len(pattern)])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = hints.constrain_logits(x @ tied_unembed(params["embed"]))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


# ----------------------------- serving ------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Recurrent state + conv tails for rec blocks; *rolling* local-window
    KV for attention blocks: state is O(window), not O(max_len)."""
    pattern = _pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    rem = cfg.n_layers - n_groups * len(pattern)
    w = cfg.lru_width or cfg.d_model
    attn_len = min(max_len, cfg.local_window or max_len)
    dt = pdtype(cfg)
    device = resolve_device(device)

    def block(kind, i, lead):
        if kind == "rec":
            return {
                f"h{i}": torch.zeros(lead + (batch, w), dtype=torch.float32,
                                     device=device),
                f"tail{i}": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                        dtype=dt, device=device),
            }
        kv = init_kv_cache(batch, attn_len, cfg, device=device)
        return {f"k{i}": kv["k"].new_zeros(lead + kv["k"].shape),
                f"v{i}": kv["v"].new_zeros(lead + kv["v"].shape)}

    caches: dict = {"grouped": {}, "rem": {}}
    for i, kind in enumerate(pattern):
        caches["grouped"].update(block(kind, i, (n_groups,)))
    for i in range(rem):
        caches["rem"].update(block(pattern[i % len(pattern)], i, ()))
    return caches


def _decode_block(cfg, x, p, kind, cc, i, pos, attn_len):
    """One block of decode; returns (x, the new recurrent entries). An
    attention block writes its rolling KV cache in ``cc`` in place."""
    new_c = {}
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        gate = gelu(h_in @ p["rec"]["w_gate_in"])
        u = h_in @ p["rec"]["w_x"]
        u, new_tail = _conv1d(p["rec"], u, cc[f"tail{i}"])
        y, h_last = _lru(p["rec"], u, cc[f"h{i}"])
        h = hints.row_parallel((y * gate) @ p["rec"]["w_out"])
        new_c[f"h{i}"] = h_last
        new_c[f"tail{i}"] = new_tail
    else:
        h, _ = decode_attention(
            p["attn"], h_in, pos, {"k": cc[f"k{i}"], "v": cc[f"v{i}"]}, cfg,
            write_pos=pos % attn_len,
        )
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, new_c


def decode_step(params, cfg, cache, tokens, pos):
    """One-token decode; attention caches are rolling local windows. Every
    cache entry is written in place (a placed one in its placement,
    ``hints.write_into``)."""
    x = embed_lookup(params["embed"], tokens)
    pattern = _pattern(cfg)
    grouped = cache["grouped"]
    attn_len = next(
        (grouped[f"k{i}"].shape[2] for i, k in enumerate(pattern) if k == "attn"),
        cfg.local_window or 1,
    )
    for g, gp in enumerate(params["groups"]):
        cc = {key: val[g] for key, val in grouped.items()}
        for i, kind in enumerate(pattern):
            x, upd = _decode_block(cfg, x, gp[i], kind, cc, i, pos, attn_len)
            for key, val in upd.items():
                hints.write_into(grouped[key][g], val)
    rem = cache["rem"]
    for i, p in enumerate(params["remainder"]):
        x, upd = _decode_block(cfg, x, p, pattern[i % len(pattern)], rem, i,
                               pos, attn_len)
        for key, val in upd.items():
            hints.write_into(rem[key], val)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ tied_unembed(params["embed"]), {"grouped": grouped, "rem": rem}
