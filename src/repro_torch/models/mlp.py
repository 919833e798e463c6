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
is set, and ``moe`` otherwise, as ``repro`` does. ``moe`` on placed
tensors keeps its global routing and capacity and splits its products
over the mesh (``_moe_placed``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints
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
    return hints.row_parallel(h @ p["w_down"])


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


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ``ids < n``, with a shape
    known before the values are (a fake tensor has none)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def _dispatch(xf, logits, wg, wu, wd, cfg, lo: int, e_loc: int, cap: int,
              rows: tuple = (0, 1)):
    """The sort-based dispatch on tokens ``xf`` (T, D) with router logits
    ``logits`` (T, E): route each to its top-k experts, keep the
    assignments to experts ``lo .. lo + e_loc`` (whose weights ``wg``,
    ``wu``, ``wd`` are given; the rest go to the drop bucket ``e_loc``),
    run them through a capacity-``cap`` buffer and add them back to their
    tokens. ``rows = (j, n)`` runs only capacity rows ``j, j + n, ...`` of
    each expert (the placed ``moe`` splits them over ranks); the other
    rows' assignments count as dropped here. ``moe`` calls it with every
    expert (``lo = 0``, ``e_loc = E``), each rank of ``moe_ep`` with its
    resident ones. Returns ((T, D) output without the shared expert, aux
    loss)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    gates = torch.softmax(logits, dim=-1)  # (T, E)
    top_w, top_i = torch.topk(gates, k, dim=-1)  # (T, k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True), 1e-9)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(gates, dim=0)
    ce = _counts(top_i.reshape(-1), e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # keep the assignments to experts lo .. lo + e_loc, sorted by expert id
    ids = top_i.reshape(-1)  # (T*k,)
    wts = top_w.reshape(-1)
    mine = (ids >= lo) & (ids < lo + e_loc)
    ids_l = torch.where(mine, ids - lo, e_loc)  # e_loc = drop bucket
    order = torch.argsort(ids_l, stable=True)  # drops sort to the end
    ids_s = ids_l[order]
    counts = _counts(ids_s, e_loc + 1)
    offsets = torch.cumsum(counts, 0) - counts  # start of each expert's run
    pos = torch.arange(t * k, device=dev) - offsets[ids_s]
    j, n = rows
    c_loc = -(-cap // n)  # this call's rows an expert
    keep = (ids_s < e_loc) & (pos < cap) & (pos % n == j)

    if e_loc * c_loc < t * k:
        # the kept assignments first, in their order, as many as the
        # buffer has rows (a count known before the routing is): the copy
        # and the combine move no more rows than the buffer holds
        first = torch.argsort((~keep).to(torch.int8), stable=True)[
            :e_loc * c_loc]
        keep, ids_s, pos = keep[first], ids_s[first], pos[first]
        order = order[first]
    tok_s = order // k
    wts_s = wts[order]
    slot = torch.where(keep, ids_s * c_loc + pos // n, e_loc * c_loc)

    # a dropped assignment lands in one spare row past the buffer
    buf = torch.zeros((e_loc * c_loc + 1, d), dtype=xf.dtype, device=dev)
    buf[slot] = xf[tok_s]
    buf = buf[:e_loc * c_loc].reshape(e_loc, c_loc, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_loc * c_loc, d)

    gathered = y[torch.clamp_max(slot, e_loc * c_loc - 1)]
    gathered = gathered * (wts_s * keep).to(xf.dtype)[:, None]
    out = torch.zeros((t, d), dtype=xf.dtype, device=dev).index_add_(
        0, tok_s, gathered)
    return out, aux


def _mean_over(aux, mesh):
    """``repro``'s ``pmean`` of a per-rank scalar over every axis of
    ``mesh``, as a DTensor with a pending sum of ``aux / n``: the mean's
    value, and each rank's gradient ``1/n`` of it. (``Partial("avg")``
    would hand every rank the whole gradient, so the sum over ranks of
    the router's gradient would hold the aux loss's ``n`` times.)"""
    from torch.distributed.tensor import DTensor, Partial

    return DTensor.from_local(aux / mesh.size(), mesh,
                              (Partial(),) * mesh.ndim, run_check=False)


def _moe_placed(p, x, cfg):
    """``moe`` on placed tensors. Its routing and capacity are global (a
    token's drop depends on every other token's choice), so every rank
    routes every token: the router runs on each rank's rows, and its
    logits and the tokens are gathered. The experts' work is split over
    the whole mesh: the experts over ``"model"`` where their number
    divides it (as ``sharding.spec_for_param`` places them), each
    expert's capacity rows over the other axes, so a rank runs ``1/n`` of
    the layer's products. Each rank's output is a part of every token's,
    summed into ``x``'s placement (a reduce-scatter over the batch axes,
    an all-reduce over the rest). The shared expert runs on the placed
    ``x`` as a dense MLP does."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    t = b * s
    ep = "model" if sizes.get("model", 0) and e % sizes["model"] == 0 else None
    e_loc = e // sizes[ep] if ep else e
    lo = mesh.get_local_rank(ep) * e_loc if ep else 0
    j, n = 0, 1  # this rank's capacity rows: j, j + n, ...
    for a in names:
        if a != ep:
            j, n = j * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    cap = t if s == 1 else min(int(t * k / e * cfg.capacity_factor) + 1, t * k)

    # each rank's gradient of these is a part: its experts' and its rows'
    whole = (None, None, None)
    xf = hints.to_local(x, mesh, whole, sums=names).reshape(t, d)
    logits = hints.to_local(x.float() @ p["router"], mesh, whole,
                            sums=names).reshape(t, e)
    wg, wu, wd = (hints.to_local(p[w], mesh, (ep, None, None), sums=names)
                  for w in ("w_gate", "w_up", "w_down"))
    out, aux = _dispatch(xf, logits, wg, wu, wd, cfg, lo, e_loc, cap, (j, n))
    out = DTensor.from_local(out.reshape(b, s, d), mesh,
                             (Partial(),) * mesh.ndim, run_check=False
                             ).redistribute(mesh, x.placements)
    if "shared" in p:
        out = out + mlp(p["shared"], x)
    return out, _mean_over(aux, mesh)


def moe(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE layer. Returns (output, aux load-balancing loss)."""
    if hasattr(x, "device_mesh"):
        return _moe_placed(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    if s == 1:
        cap = t  # decode: buffer is tiny, never drop a token
    else:
        cap = min(int(t * k / e * cfg.capacity_factor) + 1, t * k)
    xf = x.reshape(t, d)
    out, aux = _dispatch(xf, xf.float() @ p["router"], p["w_gate"],
                         p["w_up"], p["w_down"], cfg, 0, e, cap)
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
    from torch.distributed.tensor import DTensor

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
    out, aux = _dispatch(xf, xf.float() @ router, wg, wu, wd, cfg, lo,
                         e_loc, cap)
    if "shared" in p:
        # shared expert: every rank holds the tokens; scale by 1/n_tp so
        # the combining sum reconstructs a single contribution
        shared = {n: to_local(p["shared"][n], mesh, (None, None), sums=parts)
                  for n in ("w_gate", "w_up", "w_down")}
        out = out + (mlp(shared, xf) / n_tp).to(out.dtype)

    out = from_local(out.reshape(bl, s, d), mesh, acts, x.shape,
                     sums=(tp_axis,))  # the combine: one all_reduce SUM
    return out, _mean_over(aux, mesh)
