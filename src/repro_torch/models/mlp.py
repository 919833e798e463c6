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

``moe_ep`` is ``repro``'s expert-parallel MoE (a ``shard_map``) over a
``DeviceMesh``: each model rank runs its resident experts on its local
tokens, and one ``all_reduce`` SUM over the model axis combines them.
``transformer`` calls it for ``moe_impl="ep"`` while ``hints.mesh_info()``
is set, and ``moe`` otherwise, as ``repro`` does.
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


def _dispatch(xf, router, wg, wu, wd, cfg, lo: int, e_loc: int, cap: int):
    """The sort-based dispatch on tokens ``xf`` (T, D): route each to its
    top-k experts, keep the assignments to experts ``lo .. lo + e_loc``
    (whose weights ``wg``, ``wu``, ``wd`` are given; the rest go to the
    drop bucket ``e_loc``), run them through a capacity-``cap`` buffer and
    add them back to their tokens. ``moe`` calls it with every expert
    (``lo = 0``, ``e_loc = E``), each rank of ``moe_ep`` with its resident
    ones. Returns ((T, D) output without the shared expert, aux loss)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    logits = xf.float() @ router
    gates = torch.softmax(logits, dim=-1)  # (T, E)
    top_w, top_i = torch.topk(gates, k, dim=-1)  # (T, k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True), 1e-9)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(gates, dim=0)
    ce = torch.bincount(top_i.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # keep the assignments to experts lo .. lo + e_loc, sorted by expert id
    ids = top_i.reshape(-1)  # (T*k,)
    wts = top_w.reshape(-1)
    mine = (ids >= lo) & (ids < lo + e_loc)
    ids_l = torch.where(mine, ids - lo, e_loc)  # e_loc = drop bucket
    order = torch.argsort(ids_l, stable=True)  # drops sort to the end
    ids_s = ids_l[order]
    tok_s = order // k
    wts_s = wts[order]
    counts = torch.bincount(ids_s, minlength=e_loc + 1)
    offsets = torch.cumsum(counts, 0) - counts  # start of each expert's run
    pos = torch.arange(t * k, device=dev) - offsets[ids_s]
    keep = (ids_s < e_loc) & (pos < cap)
    slot = torch.where(keep, ids_s * cap + pos, e_loc * cap)  # dropped

    buf = torch.zeros((e_loc * cap, d), dtype=xf.dtype, device=dev)
    buf[slot[keep]] = xf[tok_s[keep]]
    buf = buf.reshape(e_loc, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_loc * cap, d)

    gathered = y[torch.clamp_max(slot, e_loc * cap - 1)]
    gathered = gathered * (wts_s * keep).to(xf.dtype)[:, None]
    out = torch.zeros((t, d), dtype=xf.dtype, device=dev).index_add_(
        0, tok_s, gathered)
    return out, aux


def moe(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE layer. Returns (output, aux load-balancing loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    if s == 1:
        cap = t  # decode: buffer is tiny, never drop a token
    else:
        cap = min(int(t * k / e * cfg.capacity_factor) + 1, t * k)
    xf = x.reshape(t, d)
    out, aux = _dispatch(xf, p["router"], p["w_gate"], p["w_up"],
                         p["w_down"], cfg, 0, e, cap)
    if "shared" in p:
        out = out + mlp(p["shared"], xf)
    return out.reshape(b, s, d), aux


def moe_ep(p, x, cfg, mesh, batch_axes: tuple, tp_axis: str = "model"):
    """Expert-parallel MoE over ``mesh`` (``repro``'s ``shard_map`` port).

    ``repro``'s layout invariant: activations (DTensors) are replicated
    across the model axis while the experts are sharded over it
    (``sharding.spec_for_param``'s ``(E, D, FF)`` rule). Each model rank
    therefore holds every token of its batch shard: dispatch is a local
    select of the assignments routed to its ``E // n_tp`` resident
    experts (the rest go to a drop bucket), and the combine is one
    ``all_reduce`` SUM over the model axis's group (``repro``'s ``psum``;
    here the local outputs form a DTensor with a pending sum over that
    axis, and redistributing it to ``Replicate`` is that all-reduce). The
    shared expert is scaled by ``1/n_tp`` first, so the sum holds it once.
    The aux loss is averaged over the model axis (``repro``'s ``pmean``;
    every model rank computes the same value) and over the batch shards.
    Capacity is ``max(int(t*k/E*cf)+1, 4)`` on a shard's ``t`` tokens
    (``t`` at decode), so drops depend on the shard, as in ``repro``.
    """
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.distributed.hints import from_local, to_local

    if not isinstance(x, DTensor):
        raise RuntimeError(
            "moe_ep runs on placed tensors: place the parameters "
            "(distributed.sharding.make_param_specs) and the batch "
            "(make_batch_specs) on the mesh given to hints.set_axes")
    e, k = cfg.n_experts, cfg.top_k
    names = list(mesh.mesh_dim_names)
    n_tp = mesh.shape[names.index(tp_axis)]
    assert e % n_tp == 0, (e, n_tp)
    e_loc = e // n_tp
    ba = tuple(batch_axes)
    acts = (ba, None, None)

    # shard_map's inputs: each rank's gradient of them is a part (its
    # batch shard's, its experts' share), summed over the unmapped axes
    parts = tuple(names)
    xb = to_local(x, mesh, acts, sums=parts)  # (B_loc, S, D)
    router = to_local(p["router"], mesh, (None, None), sums=parts)
    wg, wu, wd = (to_local(p[n], mesh, (tp_axis, None, None), sums=parts)
                  for n in ("w_gate", "w_up", "w_down"))
    bl, s, d = xb.shape
    t = bl * s
    xf = xb.reshape(t, d)
    cap = max(int(t * k / e * cfg.capacity_factor) + 1, 4) if s > 1 else t
    lo = mesh.get_local_rank(tp_axis) * e_loc
    out, aux = _dispatch(xf, router, wg, wu, wd, cfg, lo, e_loc, cap)
    if "shared" in p:
        # shared expert: every rank holds the tokens; scale by 1/n_tp so
        # the combining sum reconstructs a single contribution
        shared = {n: to_local(p["shared"][n], mesh, (None, None), sums=parts)
                  for n in ("w_gate", "w_up", "w_down")}
        out = out + (mlp(shared, xf) / n_tp).to(out.dtype)

    out = from_local(out.reshape(bl, s, d), mesh, acts, x.shape,
                     sums=(tp_axis,))  # the combine: one all_reduce SUM
    aux = DTensor.from_local(aux, mesh, (Partial("avg"),) * len(names),
                             run_check=False)
    return out, aux
