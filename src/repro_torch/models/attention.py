"""GQA attention with sliding-window, QKV-bias, cross-attention and KV cache
(port of ``repro/models/attention.py``).

Functional layers over parameter trees (``common.ParamTree`` or plain
dicts). Shapes, as in ``repro``:
  x: (B, S, D);  q: (B, S, H, hd);  k/v: (B, T, K, hd)  (K = KV heads)

Grouped attention reshapes q to (B, S, K, G, hd) with G = H // K so the
product contracts per KV head. Scores are float32 whatever the weights'
type: ``repro`` asks its matrix unit for float32 products
(``preferred_element_type``), and a bfloat16 ``torch.einsum`` would round
them to bfloat16, so ``_scores`` takes the score product on float32 copies
of q and k (exact bfloat16 values, float32 sums). Probabilities are cast to
v's type before the PV product, as in ``repro``. Plain PyTorch ops, no
library attention: ``repro`` reaches no Pallas kernel here.

The KV cache is updated in place by ``decode_attention`` (``repro``
returns a new array); the returned dict holds the same tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.common import dense_init, pdtype, rope

NEG = -1.0e30


def init_attention(gen, cfg, cross: bool = False) -> dict:
    dt = pdtype(cfg)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, (d, qd), dt),
        "wk": dense_init(gen, (d, kvd), dt),
        "wv": dense_init(gen, (d, kvd), dt),
        "wo": dense_init(gen, (qd, d), dt),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((qd,), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((kvd,), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((kvd,), dtype=dt, device=gen.device)
    return p


def _split_heads(t, heads: int, head_dim: int):
    """``t`` (..., heads * head_dim) as (..., heads, head_dim).

    A projection's last dimension is sharded over ``"model"`` whenever the
    mesh divides its width (``sharding.spec_for_param``), which need not
    divide its head count (8 KV heads on a 16-way axis). DTensor cannot
    split heads unevenly, so that dimension is first brought to
    ``Replicate``, as GSPMD reshards it. Where the heads divide, the
    reshape keeps the sharding and nothing moves."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor):
        ways = 1
        for pl, n in zip(t.placements, t.device_mesh.shape):
            if isinstance(pl, Shard) and pl.dim == t.ndim - 1:
                ways *= n
        if heads % ways:
            t = hints.replicate_dims(t, -1)
    return t.reshape(t.shape[:-1] + (heads, head_dim))


def _project_q(p, x, cfg):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return _split_heads(q, cfg.n_heads, cfg.head_dim)


def _project_kv(p, x, cfg):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return (_split_heads(k, cfg.n_kv, cfg.head_dim),
            _split_heads(v, cfg.n_kv, cfg.head_dim))


def _scores(q, k):
    """Unscaled scores of grouped q (B,S,K,G,hd) and k (B,T,K,hd):
    (B,K,G,S,T) float32, summed in float32 whatever the inputs' type."""
    return torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())


def _attend(q, k, v, mask, cfg):
    """q (B,S,H,hd), k/v (B,T,K,hd), mask (B|1, S, T) bool -> (B,S,H*hd)."""
    b, s, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    q = q.reshape(b, s, kheads, g, hd)
    scale = hd ** -0.5
    scores = _scores(q, k) * scale
    scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    if s == 1:  # decode: repro's explicit stable softmax
        scores = hints.constrain_decode_scores(scores)
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        probs = e / torch.sum(e, dim=-1, keepdim=True)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, h * hd)


def _attend_chunked(q, k, v, cfg, causal: bool, window: int,
                    kv_chunk: int = 1024):
    """Flash-style online-softmax attention over KV chunks of ``kv_chunk``.

    Never materializes the (S, T) score matrix: memory per step is
    O(S * kv_chunk). ``repro``'s ``lax.scan`` over chunks is a loop here.
    q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H*hd).
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, s, kheads, g, hd).float()  # once, not per chunk
    scale = hd ** -0.5
    n_chunks = -(-t // kv_chunk)
    t_pad = n_chunks * kv_chunk
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    dev = q.device
    rows = torch.arange(s, device=dev)[:, None]
    acc = torch.zeros((b, s, kheads, g, hd), dtype=torch.float32, device=dev)
    m_run = torch.full((b, kheads, g, s), NEG, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, kheads, g, s), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        c0 = c * kv_chunk
        kb = k[:, c0:c0 + kv_chunk]
        vb = v[:, c0:c0 + kv_chunk]
        scores = _scores(qg, kb) * scale
        cols = c0 + torch.arange(kv_chunk, device=dev)[None, :]
        mask = cols < t
        if causal:
            mask = torch.logical_and(mask, cols <= rows)
            if window:
                mask = torch.logical_and(mask, cols > rows - window)
        scores = torch.where(mask[None, None, None, :, :], scores, NEG)
        m_new = torch.maximum(m_run, torch.amax(scores, dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(vb.dtype), vb).float()
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m_run = m_new
    denom = torch.clamp_min(l_run, 1e-30).permute(0, 3, 1, 2)[..., None]
    out = (acc / denom).to(v.dtype)
    return out.reshape(b, s, h * hd)


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    """(1, S, S) causal (optionally sliding-window) bool mask."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window:
        m = torch.logical_and(m, j > i - window)
    return m[None]


CHUNKED_THRESHOLD = 8192  # sequences >= this use online-softmax attention


def _per_shard(core, q, k, v, *rest):
    """``core(q, k, v, *rest)``; on DTensors, run on each rank's shards
    (``shard_map`` of the attention core, as GSPMD partitions it): batch
    rows over the batch axes and heads over ``"model"`` where they divide
    (else that dimension is computed whole on each rank). ``rest`` are
    ``(B or 1, ...)`` tensors or None. DTensor's einsum cannot keep a
    sharded head dimension through the score product's reshapes, so the
    core stays out of its sharding rules."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return core(q, k, v, *rest)
    from repro_torch.distributed.hints import from_local, to_local
    from repro_torch.distributed.sharding import row_axes

    mesh = q.device_mesh
    b, s, h, hd = q.shape
    bax = row_axes(mesh, b)
    n_tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    tp = "model" if h % n_tp == 0 and k.shape[2] % n_tp == 0 else None
    heads = (bax, None, tp, None)

    def rows(a):
        if a is None:
            return None
        lead = bax if a.shape[0] == b else None
        return to_local(a, mesh, (lead,) + (None,) * (a.dim() - 1))

    out = core(to_local(q, mesh, heads), to_local(k, mesh, heads),
               to_local(v, mesh, heads), *(rows(a) for a in rest))
    return from_local(out, mesh, (bax, None, tp), (b, s, h * hd))


def attention(p, x, positions, cfg, mask=None, kv_x=None, kv_positions=None,
              use_rope: bool = True, causal: bool = True):
    """Full-sequence attention (training / prefill). Cross-attn if kv_x.

    For sequences >= ``CHUNKED_THRESHOLD`` (read at each call) the
    flash-style chunked path is used (its mask is derived from ``causal``
    and ``cfg.sliding_window``; an explicit ``mask`` forces the plain
    path).
    """
    src = x if kv_x is None else kv_x
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, src, cfg)
    kpos = positions if kv_positions is None else kv_positions
    s, t = x.shape[1], src.shape[1]
    window = cfg.sliding_window if kv_x is None else 0
    chunked = mask is None and max(s, t) >= CHUNKED_THRESHOLD
    if mask is None and not chunked:
        if causal and kv_x is None:
            mask = causal_mask(s, window, device=x.device)
        else:
            mask = torch.ones((1, s, t), dtype=torch.bool, device=x.device)

    def core(q, k, v, positions, kpos, mask):
        if use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, kpos, cfg.rope_theta)
        if chunked:
            return _attend_chunked(q, k, v, cfg,
                                   causal=causal and kv_x is None,
                                   window=window)
        return _attend(q, k, v, mask, cfg)

    out = _per_shard(core, q, k, v, positions if use_rope else None,
                     kpos if use_rope else None, mask)
    return hints.row_parallel(out @ p["wo"])


def init_kv_cache(batch: int, max_len: int, cfg, dtype=None,
                  device=None) -> dict:
    dt = dtype or pdtype(cfg)
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _placed(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _cache_shard(c):
    """One layer's placed cache tensor (B, T, K, hd): (this rank's shard,
    the first slot it holds, the mesh axis that splits T or None)."""
    from torch.distributed.tensor import Shard

    mesh = c.device_mesh
    local = c.to_local()
    axis = None
    for name, pl, n in zip(mesh.mesh_dim_names, c.placements, mesh.shape):
        if isinstance(pl, Shard) and pl.dim == 1 and n > 1:
            axis = name
    lo = mesh.get_local_rank(axis) * local.shape[1] if axis else 0
    return local, lo, axis


def _cache_rows(c):
    """The mesh axes that split a placed cache's batch rows (its dim 0),
    major to minor, or None: the cache's own layout
    (``sharding.spec_for_cache``), which may split fewer rows than the
    activations' (``sharding.row_axes``)."""
    from torch.distributed.tensor import Shard

    axes = tuple(name for name, pl in zip(c.device_mesh.mesh_dim_names,
                                          c.placements)
                 if isinstance(pl, Shard) and pl.dim == 0)
    return axes or None


def _rows(t, mesh, bax):
    """This rank's batch rows of ``t`` (B, ...), whole over the rest."""
    from repro_torch.distributed.hints import to_local

    return to_local(t, mesh, (bax,) + (None,) * (t.dim() - 1))


def fill_cache(c, k):
    """Write a prompt's keys (or values) ``k`` (B, S, K, hd) into one
    layer's cache ``c`` (B, T, K, hd) in place: zero-padded when T >= S,
    else the last T positions rolled to slot = position % T (``repro``'s
    new cache). A placed cache is written shard by shard: each rank
    writes the slots it holds for its batch rows, with ``k`` brought
    whole over ``"model"`` (its heads) first."""
    s = k.shape[1]
    if not _placed(c):
        t = c.shape[1]
        if t < s:
            c.copy_(torch.roll(k[:, s - t:], shifts=s % t, dims=1))
        else:
            c[:, :s] = k
            c[:, s:] = 0
        return
    local, lo, _ = _cache_shard(c)
    t, n = c.shape[1], local.shape[1]
    kl = _rows(k, c.device_mesh, _cache_rows(c))
    if t < s:
        local.copy_(torch.roll(kl[:, s - t:], shifts=s % t, dims=1)[:, lo:lo + n])
        return
    m = max(min(lo + n, s) - lo, 0)
    local[:, :m] = kl[:, lo:lo + m]
    local[:, m:] = 0


def _attend_decode_shards(q, k, v, mask, mesh, bax, axis, b):
    """Decode attention of this rank's rows on its cache shard, as GSPMD
    partitions it under ``constrain_decode_scores`` (flash-decode): q
    (B_loc, 1, H, hd) whole over ``"model"``, k/v (B_loc, T_loc, K, hd)
    the rank's slots, mask (B_loc, 1, T_loc). With the cache length split
    over ``axis``, the softmax's max and sum and the PV product are
    combined by an all-reduce over it; with ``axis`` None this is
    ``_attend``'s decode path, op for op."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.distributed.hints import from_local, to_local

    bl, s, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    scores = _scores(q.reshape(bl, s, kheads, g, hd), k) * hd ** -0.5
    scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    spec = (bax, None, None, None, axis)
    names = list(mesh.mesh_dim_names)
    ways = mesh.shape[names.index(axis)] if axis else 1
    scores = to_local(hints.constrain_decode_scores(from_local(
        scores, mesh, spec, (b, kheads, g, s, k.shape[1] * ways))), mesh, spec)
    group = (mesh, names.index(axis)) if axis else None
    m = torch.amax(scores, dim=-1, keepdim=True)
    if axis:
        m = funcol.all_reduce(m, "max", group)
    e = torch.exp(scores - m)
    den = torch.sum(e, dim=-1, keepdim=True)
    if axis:
        den = funcol.all_reduce(den, "sum", group)
    out = torch.einsum("bkgst,btkh->bskgh", (e / den).to(v.dtype), v)
    if axis:
        out = funcol.all_reduce(out, "sum", group)
    return out.reshape(bl, s, h * hd)


def _decode_placed(q, k_new, v_new, cache, slot, mask_of, pos, use_rope,
                   cfg):
    """``decode_attention`` on a placed cache (the cache length over
    ``"model"``, ``sharding.spec_for_cache``): the new key and value are
    written into the shard that holds ``slot``, in place, and each rank
    attends over its own slots (``_attend_decode_shards``). ``k_new`` /
    ``v_new`` None: cross-attention over a cache written at prefill."""
    from repro_torch.distributed.hints import from_local

    kc, lo, axis = _cache_shard(cache["k"])
    vc = cache["v"].to_local()
    mesh = cache["k"].device_mesh
    b = q.shape[0]
    bax = _cache_rows(cache["k"])
    ql = _rows(q, mesh, bax)
    dev = kc.device
    if use_rope:
        posv = torch.full((ql.shape[0], 1), pos, dtype=torch.int64, device=dev)
        ql = rope(ql, posv, cfg.rope_theta)
    if k_new is not None:
        kl, vl = _rows(k_new, mesh, bax), _rows(v_new, mesh, bax)
        if use_rope:
            kl = rope(kl, posv, cfg.rope_theta)
        if lo <= slot < lo + kc.shape[1]:
            kc[:, slot - lo] = kl[:, 0].to(kc.dtype)
            vc[:, slot - lo] = vl[:, 0].to(vc.dtype)
    j = lo + torch.arange(kc.shape[1], device=dev)[None, None, :]
    m = mask_of(j).expand(ql.shape[0], 1, kc.shape[1])
    out = _attend_decode_shards(ql, kc, vc, m, mesh, bax, axis, b)
    return from_local(out, mesh, (bax, None, None), (b, 1, out.shape[-1]))


def decode_attention(p, x, pos: int, cache: dict, cfg, window: int = 0,
                     use_rope: bool = True, write_pos: int | None = None):
    """One-token decode with KV cache. x: (B, 1, D); pos: absolute position.

    ``write_pos`` (defaults to ``pos``) is the cache slot: ``pos %
    cache_len`` for rolling local-window caches; K is always roped at the
    absolute position so relative rotations stay correct across wraps.
    The slot is clamped into the cache, as ``dynamic_update_slice`` clamps
    its start: a non-rolling decode at ``pos >= cache length`` writes the
    last slot. Writes the cache in place (a placed cache in its
    placement, ``_decode_placed``); returns (output (B, 1, D), cache).
    """
    b = x.shape[0]
    t = cache["k"].shape[1]
    wp = pos if write_pos is None else write_pos
    rolling = write_pos is not None
    q = _project_q(p, x, cfg)
    k_new, v_new = _project_kv(p, x, cfg)
    slot = min(max(int(wp), 0), t - 1)

    def mask_of(j):
        if rolling:
            # once warmed up, every slot holds one of the last ``t`` positions
            return torch.logical_or(
                j <= pos, torch.full_like(j, pos >= t, dtype=torch.bool))
        m = j <= pos
        if window:
            m = torch.logical_and(m, j > pos - window)
        return m

    if _placed(cache["k"]):
        out = _decode_placed(q, k_new, v_new, cache, slot, mask_of, pos,
                             use_rope, cfg)
        return hints.row_parallel(out @ p["wo"]), cache
    if use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    j = torch.arange(t, device=x.device)[None, None, :]
    out = _attend(q, k, v, mask_of(j).expand(b, 1, t), cfg)
    return hints.row_parallel(out @ p["wo"]), {"k": k, "v": v}


def decode_cross_attention(p, x, enc_k, enc_v, cfg):
    """Cross-attention during decode; encoder K/V precomputed at prefill
    (placed: each rank attends over its slots, ``_decode_placed``)."""
    b, t = enc_k.shape[0], enc_k.shape[1]
    q = _project_q(p, x, cfg)
    if _placed(enc_k):
        out = _decode_placed(q, None, None, {"k": enc_k, "v": enc_v}, 0,
                             lambda j: torch.ones_like(j, dtype=torch.bool),
                             0, False, cfg)
        return hints.row_parallel(out @ p["wo"])
    mask = torch.ones((b, 1, t), dtype=torch.bool, device=x.device)
    out = _attend(q, enc_k, enc_v, mask, cfg)
    return hints.row_parallel(out @ p["wo"])
