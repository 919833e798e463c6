"""Mamba-2 (SSD, state-space duality) language model (port of
``repro/models/mamba2.py``).

Chunked SSD (Dao & Gu 2024, minimal-SSD form): within a chunk the
recurrence is a masked quadratic form, across chunks a linear recurrence
carries (B, H, P, N) states: O(S) work, O(1)-state decode. ``repro``'s
``associative_scan`` over chunks is ``common.linear_scan`` here.

Layer = RMSNorm -> [in_proj -> conv1d -> SSD -> gate -> out_proj] + residual.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.common import (
    ParamTree,
    cross_entropy_loss,
    dense_init,
    embed_init,
    embed_lookup,
    linear_scan,
    pdtype,
    remat,
    rms_norm,
    softplus,
    tied_unembed,
)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def init_layer(gen, cfg) -> dict:
    dt = pdtype(cfg)
    d = cfg.d_model
    d_inner, h, n = _dims(cfg)
    conv_dim = d_inner + 2 * n  # x, B, C all pass the conv
    dev = gen.device
    return {
        "ln": torch.zeros((d,), dtype=dt, device=dev),
        # in_proj -> [z, x, B, C, dt]
        "w_in": dense_init(gen, (d, 2 * d_inner + 2 * n + h), dt),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_dim), dt) * 0.1,
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (d_inner, d), dt),
        "out_ln": torch.zeros((d_inner,), dtype=dt, device=dev),
    }


def _segsum(a):
    """Lower-triangular pairwise cumulative sums: out[..., i, j] = sum a[j+1..i]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, a_log, b, c, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); a_log: (H,) log-decay rates;
    b, c: (B, S, N) (single group). S is padded up to a multiple of
    ``chunk``; ``h0`` (B, H, P, N) is the state carried in. Returns
    (y, last_state (B, H, P, N)).
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))

    A = -torch.exp(a_log)  # (H,) negative
    xb = x.reshape(bs, nc, chunk, h, p)
    dtb = dt.reshape(bs, nc, chunk, h)
    bb = b.reshape(bs, nc, chunk, n)
    cb = c.reshape(bs, nc, chunk, n)
    da = dtb * A[None, None, None, :]          # (B, C, Q, H) log decay per step
    da_cum = torch.cumsum(da, dim=2)           # within-chunk cumulative

    # intra-chunk (quadratic, masked)
    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))       # (B, C, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", cb, bb)     # (B, C, Q, Q)
    m = scores[:, :, None] * L                           # (B, C, H, Q, Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", m, dtb[..., None] * xb)

    # chunk states: contribution of each chunk to the carried state
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)    # (B, C, Q, H)
    states = torch.einsum("bcqn,bcqhp->bchpn", bb,
                          (decay_states * dtb)[..., None] * xb)

    # inter-chunk recurrence: h_c = exp(sum da_c) h_{c-1} + states_c
    chunk_decay = torch.exp(da_cum[:, :, -1, :])               # (B, C, H)
    a_sc, h_sc = linear_scan(chunk_decay[..., None, None], states, dim=1)
    # state entering chunk c is h_sc[c-1] (plus h0 propagated)
    h_prev = torch.cat([torch.zeros_like(h_sc[:, :1]), h_sc[:, :-1]], dim=1)
    if h0 is not None:
        # propagate the initial state through each chunk's total decay
        total_decay = torch.cat([torch.ones_like(a_sc[:, :1]), a_sc[:, :-1]],
                                dim=1)
        h_prev = h_prev + total_decay * h0[:, None]

    y_off = (torch.einsum("bcqn,bchpn->bcqhp", cb, h_prev)
             * torch.exp(da_cum)[..., None])
    y = (y_diag + y_off).reshape(bs, nc * chunk, h, p)[:, :s]
    last = h_sc[:, -1]
    if h0 is not None:
        last = last + a_sc[:, -1] * h0
    return y, last


def _conv1d(w, x, tail=None):
    """Causal depthwise conv over S; ``tail`` holds the last k-1 inputs of
    the previous call. Returns (out, new tail)."""
    k = w.shape[0]
    if tail is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(
        xp[:, i: xp.shape[1] - (k - 1 - i)] * w[i][None, None, :] for i in range(k)
    )
    return out, xp[:, -(k - 1):]


def _split_proj(p, u, cfg):
    d_inner, h, n = _dims(cfg)
    z = u[..., :d_inner]
    xc = u[..., d_inner: 2 * d_inner + 2 * n]  # conv inputs: x, B, C
    dt = u[..., 2 * d_inner + 2 * n:]
    return z, xc, dt


def _mixer(p, u, cfg, state=None, conv_tail=None):
    """The layer between its two projections: the in-projection ``u`` ->
    (the gated, normed SSD output (B, S, d_inner), new state, new tail)."""
    bs, s, _ = u.shape
    d_inner, h, n = _dims(cfg)
    z, xc, dtr = _split_proj(p, u, cfg)
    xc, new_tail = _conv1d(p["conv_w"], xc, conv_tail)
    xc = F.silu(xc)
    xs = xc[..., :d_inner].reshape(bs, s, h, cfg.ssm_head_dim)
    b = xc[..., d_inner: d_inner + n]
    c = xc[..., d_inner + n:]
    dt = softplus(dtr.float() + p["dt_bias"])
    y, last = ssd_chunked(
        xs.float(), dt, p["a_log"], b.float(), c.float(), cfg.ssm_chunk,
        h0=state,
    )
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(bs, s, d_inner).to(u.dtype)
    y = rms_norm(y, p["out_ln"], cfg.norm_eps) * F.silu(z)
    return y, last, new_tail


_MIXER_PARAMS = ("conv_w", "dt_bias", "a_log", "d_skip", "out_ln")


def _mixer_per_shard(p, u, cfg, state, conv_tail):
    """``_mixer`` on each rank's batch rows when ``u`` is a DTensor
    (``hints.on_batch_rows``; the mixer's inputs whole over ``"model"``):
    its split of the in-projection, the scan's chunk reshapes and the
    segment sums have no DTensor sharding rule that keeps the batch
    sharded through them."""
    return hints.on_batch_rows(
        lambda lp, u, st, tl: _mixer(lp, u, cfg, st, tl),
        {k: p[k] for k in _MIXER_PARAMS}, u, state, conv_tail)


def layer_forward(p, x, cfg, state=None, conv_tail=None):
    """x: (B, S, D) -> (y, (new_state, new_tail))."""
    u = rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_in"]
    mixer = _mixer_per_shard if hasattr(u, "device_mesh") else _mixer
    y, last, new_tail = mixer(p, u, cfg, state, conv_tail)
    return hints.row_parallel(y @ p["w_out"]), (last, new_tail)


def init_params(gen: torch.Generator, cfg, device=None) -> ParamTree:
    layers = [init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    dt = pdtype(cfg)
    params = {
        "layers": layers,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
    }
    return ParamTree(params).to(resolve_device(device))


def forward(params, cfg, tokens, embeds=None):
    """Tokens -> logits; each layer under ``common.remat`` when
    ``cfg.remat``."""
    x = hints.constrain_acts(embed_lookup(params["embed"], tokens))

    def body(lp, x):
        y, _ = layer_forward(lp, x, cfg)
        return hints.constrain_acts(x + y)

    body = remat(cfg, body)
    for lp in params["layers"]:
        x = body(lp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = hints.constrain_logits(x @ tied_unembed(params["embed"]))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    d_inner, h, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    device = resolve_device(device)
    return {
        "state": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "tail": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
                            dtype=pdtype(cfg), device=device),
    }


def prefill(params, cfg, cache, tokens):
    """Run the full prompt, writing the final per-layer SSM states + conv
    tails into ``cache`` in place (as ``decode_step`` does; a placed cache
    in its placement, ``hints.write_into``); returns the last-token logits
    and the cache."""
    x = hints.constrain_acts(embed_lookup(params["embed"], tokens))
    for i, lp in enumerate(params["layers"]):
        y, (st, tail) = layer_forward(lp, x, cfg)
        x = hints.constrain_acts(x + y)
        hints.write_into(cache["state"][i], st)
        hints.write_into(cache["tail"][i], tail)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1:] @ tied_unembed(params["embed"])
    return logits, {"state": cache["state"], "tail": cache["tail"]}


def decode_step(params, cfg, cache, tokens, pos):
    """O(1)-state decode step (sequence length never appears). Writes the
    cache's states and tails in place."""
    x = embed_lookup(params["embed"], tokens)  # (B, 1, D)
    for i, lp in enumerate(params["layers"]):
        y, (st, tail) = layer_forward(lp, x, cfg, state=cache["state"][i],
                                      conv_tail=cache["tail"][i])
        x = x + y
        hints.write_into(cache["state"][i], st)
        hints.write_into(cache["tail"][i], tail)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ tied_unembed(params["embed"]), {"state": cache["state"], "tail": cache["tail"]}
