"""SwiGLU MLP and sort-based top-k MoE (dropping, capacity-bounded)
(port of ``repro/models/mlp.py``).

The MoE dispatch is ``repro``'s sort formulation: the (T*k) assignments
sorted by expert, a capacity-bounded scatter into an (E, C, D) buffer,
the experts' batched products, and a weighted gather-add back to tokens.
The order matters, so it is kept: the sort is stable (``jnp.argsort`` is),
which fixes the order of tokens inside an expert and so which tokens a
full expert drops; a dropped assignment's slot is masked rather than
written (``repro``'s ``mode="drop"``); the combine is ``index_add_``
(``.at[].add``), whose float order on CUDA is not fixed, so MoE logits
agree card against CPU to a tolerance, not bit for bit.

``repro``'s expert-parallel ``moe_ep`` (``shard_map``) waits for the
sharding slice; ``transformer`` falls back to ``moe`` while
``hints.mesh_info()`` is None, as ``repro`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, pdtype


def init_mlp(gen, cfg, d_ff: int | None = None) -> dict:
    dt = pdtype(cfg)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, ff), dt),
        "w_up": dense_init(gen, (d, ff), dt),
        "w_down": dense_init(gen, (ff, d), dt),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def init_moe(gen, cfg) -> dict:
    dt = pdtype(cfg)
    d = cfg.d_model
    e = cfg.n_experts
    ffe = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "w_gate": dense_init(gen, (e, d, ffe), dt),
        "w_up": dense_init(gen, (e, d, ffe), dt),
        "w_down": dense_init(gen, (e, ffe, d), dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=ffe * cfg.n_shared_experts)
    return p


def moe(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE layer. Returns (output, aux load-balancing loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    if s == 1:
        cap = t  # decode: buffer is tiny, never drop a token
    else:
        cap = min(int(t * k / e * cfg.capacity_factor) + 1, t * k)
    dev = x.device

    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)  # (T, E)
    top_w, top_i = torch.topk(gates, k, dim=-1)  # (T, k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True), 1e-9)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(gates, dim=0)
    ce = torch.bincount(top_i.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # sort assignments by expert id
    ids = top_i.reshape(-1)  # (T*k,)
    wts = top_w.reshape(-1)
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    tok_s = order // k
    wts_s = wts[order]
    counts = torch.bincount(ids_s, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts  # start of each expert's run
    pos = torch.arange(t * k, device=dev) - offsets[ids_s]
    keep = pos < cap
    slot = torch.where(keep, ids_s * cap + pos, e * cap)  # e*cap: dropped

    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=dev)
    buf[slot[keep]] = xf[tok_s[keep]]
    buf = buf.reshape(e, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(e * cap, d)

    gathered = y[torch.clamp_max(slot, e * cap - 1)]
    gathered = gathered * (wts_s * keep).to(x.dtype)[:, None]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, tok_s, gathered)

    if "shared" in p:
        out = out + mlp(p["shared"], xf)
    return out.reshape(b, s, d), aux
