"""Partitioning rules: Megatron-style TP on "model", FSDP on "data", DP on
"pod" (port of ``repro/distributed/sharding.py``).

The rules are ``repro``'s, by leaf name and shape. A mesh axis applies
only to a dimension it divides exactly; otherwise that dimension stays
replicated. Axis roles:

  pod    — pure data parallelism across pods
  data   — batch sharding + ZeRO-3-style parameter/optimizer sharding
  model  — tensor parallelism: attention heads / ffn hidden / vocab / experts

A spec is a ``PartitionSpec``: one entry a tensor dimension, each an axis
name, a tuple of names (major to minor) or ``None``; ``tuple(spec)``
equals ``repro``'s ``P``. A mesh is a ``DeviceMesh`` whose dimension names
are the axis names (``launch.mesh``).

``repro`` stacks each layer's parameters on a leading ``(L, ...)`` axis and
its rules skip that axis (a leading ``None``). The port holds per-layer
lists (``train.layout.stacks``), so a layer's tensor gets ``repro``'s spec
without that ``None``: the rules see the layer's own shape, as ``repro``'s
do. Where a port tensor has no layer axis to drop (Adafactor's column
statistic of a stack of vectors runs over the layers, one for the stack),
it keeps ``repro``'s spec whole. Caches are stacked in both packages.

Shapes come from ``model.init(None, "meta")`` and
``model.init_cache(b, s, "meta")``: meta tensors, nothing drawn or
allocated (``repro``'s ``jax.eval_shape``).

``named(mesh, specs)`` turns each spec into DTensor placements, one a mesh
dimension: ``Shard(d)`` where tensor dimension ``d`` names that axis,
else ``Replicate()``; a dimension over ``("pod", "data")`` is ``Shard(d)``
on both, in the mesh's order, which DTensor splits major to minor as
GSPMD does. ``place(tree, mesh, specs)`` distributes a tree of tensors.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models.common import plain
from repro_torch.train.layout import get, stacks, tree_map

NORM_NAMES = {
    "ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "dec_norm", "out_ln",
    "a_param", "d_skip", "dt_bias", "a_log",
}
# (d_model, hidden)-shaped projections: FSDP on dim0, TP on dim1
IN_PROJ = {"wq", "w_gate", "w_up", "w_in", "w_x", "w_gate_in", "a_gate", "i_gate"}
# (hidden, d_model)-shaped projections: TP on dim0, FSDP on dim1
OUT_PROJ = {"wo", "w_down", "w_out"}
KV_PROJ = {"wk", "wv"}
BIASES = {"bq", "bk", "bv"}


class PartitionSpec:
    """``repro``'s ``PartitionSpec``: a tuple of per-dimension entries; an
    entry of one axis name given as a 1-tuple is that name, as ``jax``
    normalizes it.

    Not a ``tuple`` subclass, so that the port's tree walkers
    (``train.layout``) treat a spec as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(mesh) -> tuple[str | None, str, str]:
    pod = "pod" if "pod" in mesh.mesh_dim_names else None
    return pod, "data", "model"


def _name(path) -> str:
    return str(path[-1])


def spec_for_param(path, shape, mesh, fsdp_shard: bool = True) -> P:
    """Rule-based spec for one parameter tensor of the port's tree.

    ``path`` is the tensor's key path (its last key names it) and ``shape``
    its own shape, a layer's for a stacked leaf. ``fsdp_shard=False`` drops
    the "data"-axis parameter sharding (decode, where the TP-sharded
    weights fit outright)."""
    sizes = _sizes(mesh)
    pod, fsdp, tp = _axes(mesh)
    if not fsdp_shard:
        fsdp = None
    name = _name(path)
    dims = tuple(shape)

    def ax(a: str | None, size: int):
        if a is None:
            return None
        return a if size % sizes[a] == 0 else None

    nd = len(dims)
    if name in NORM_NAMES or nd == 0:
        spec: tuple = (None,) * nd
    elif name == "embed":
        spec = (ax(tp, dims[0]), ax(fsdp, dims[1]))
    elif name == "unembed":
        spec = (ax(fsdp, dims[0]), ax(tp, dims[1]))
    elif name == "router":
        spec = (ax(fsdp, dims[0]), None)
    elif name == "conv_w":
        spec = (None, ax(tp, dims[1]))
    elif name in BIASES:
        spec = (ax(tp, dims[0]),)
    elif name in IN_PROJ:
        if nd == 3:  # MoE expert weights (E, D, FF): experts on TP
            spec = (ax(tp, dims[0]), ax(fsdp, dims[1]), None)
        else:
            spec = (ax(fsdp, dims[0]), ax(tp, dims[1]))
    elif name in OUT_PROJ:
        if nd == 3:  # (E, FF, D)
            spec = (ax(tp, dims[0]), None, ax(fsdp, dims[2]))
        else:
            spec = (ax(tp, dims[0]), ax(fsdp, dims[1]))
    elif name in KV_PROJ:
        spec = (ax(fsdp, dims[0]), ax(tp, dims[1]))
    else:
        spec = (None,) * nd
    return P(*spec)


def param_shapes(model):
    """The port's parameter tree for ``model`` as meta tensors."""
    return plain(model.init(None, "meta"))


def make_param_specs(model, mesh, fsdp_shard: bool = True) -> Any:
    """Spec tree matching ``plain(model.init(...))`` (no allocation)."""
    shapes = param_shapes(model)
    return _map_with_path(
        lambda path, leaf: spec_for_param(path, leaf.shape, mesh, fsdp_shard),
        shapes)


def _drop_last(spec: P) -> P:
    return P(*tuple(spec)[:-1]) if len(tuple(spec)) else spec


def _factored_col(spec: P) -> P:
    t = tuple(spec)
    if len(t) >= 2:
        return P(*t[:-2], t[-1])
    return P()


def _per_layer(spec: P) -> P:
    """A stacked leaf's spec for one layer's slice: the leading entry (the
    layer axis, never sharded) dropped."""
    return P(*tuple(spec)[1:])


def make_state_specs(model, mesh, grad_compression: str | None = None):
    """Spec tree matching ``train_step.init_state(model, ...)``: the
    parameters, the optimizer state (AdamW's ``m`` / ``v`` as the
    parameters; Adafactor's ``vr`` as ``_drop_last`` and ``vc`` as
    ``_factored_col`` of ``repro``'s stacked spec, over the port's
    per-layer shapes), the steps replicated, and the error-feedback
    residual as the parameters when ``grad_compression`` is on."""
    from repro_torch.train.compression import ErrorFeedback
    from repro_torch.train.optimizer import AdafactorState, AdamWState
    from repro_torch.train.train_step import TrainState

    shapes = param_shapes(model)
    pspecs = make_param_specs(model, mesh)
    cfg = model.cfg
    if cfg.optimizer == "adafactor":
        vr, vc = {}, {}
        for stack in stacks(cfg, shapes):
            for path in stack.paths:
                spec = get(pspecs, path)
                whole = P(None, *spec) if stack.stacked else spec
                row, col = _drop_last(whole), _factored_col(whole)

                def own(s):  # a layer's slice of repro's stacked leaf
                    return _per_layer(s) if stack.stacked and len(s) else s

                vr[path] = own(row)
                # a stack of vectors has one column statistic, over the
                # layers, with no layer axis: each layer's entry holds it
                vector_stack = stack.stacked and get(shapes, path).dim() == 1
                vc[path] = col if vector_stack else own(col)
        opt = AdafactorState(
            vr=_map_with_path(lambda path, _: vr[path], shapes),
            vc=_map_with_path(lambda path, _: vc[path], shapes),
            step=P(),
        )
    else:
        opt = AdamWState(m=pspecs, v=pspecs, step=P())
    ef = ErrorFeedback(residual=pspecs) if grad_compression else None
    return TrainState(params=pspecs, opt=opt, step=P(), ef=ef)


def batch_axes(mesh) -> tuple:
    pod, fsdp, _ = _axes(mesh)
    return (pod, fsdp) if pod else (fsdp,)


def row_axes(mesh, rows: int):
    """The batch axes that split an activation's leading dimension of
    ``rows``: the innermost run of ``(pod, data)`` that divides it
    (``divisible_axes``, the activation anchors' rule), None (whole on
    every rank) when none does. A finer microbatch (fewer rows than
    ``pod * data``) stays split over ``"data"``, as the train step places
    it, so each rank computes its own rows and no more. Batch inputs
    (``make_batch_specs``) and caches (``spec_for_cache``) keep the
    all-or-nothing rule; code that writes a placed cache takes the rows
    of the cache's own placement (``attention._cache_rows``)."""
    return divisible_axes(mesh, batch_axes(mesh), rows)


def divisible_axes(mesh, axes, rows: int):
    """The innermost run of ``axes`` (a name or a tuple, major to minor)
    whose sizes' product divides ``rows``: ``axes`` itself when it does,
    ``("data",)`` without ``"pod"`` when only that divides, None when
    none does. DTensor splits no dimension unevenly here; GSPMD would
    pad."""
    sizes = _sizes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    for i in range(len(axes)):
        if rows % math.prod(sizes[a] for a in axes[i:]) == 0:
            return axes[i:]
    return None


def make_batch_specs(batch_shapes: dict, mesh) -> dict:
    """Batch leaves shard their leading (global batch) dim on (pod, data).

    When the batch doesn't divide the axes (long_500k has batch=1) the
    leading dim stays replicated. ``batch_shapes`` maps names to anything
    with a ``.shape`` (arrays, tensors)."""

    ba = batch_axes(mesh)
    total = math.prod(_sizes(mesh)[a] for a in ba)

    def spec(v):
        shape = tuple(v.shape)
        lead = ba if shape[0] % total == 0 else None
        return P(lead, *([None] * (len(shape) - 1)))

    return {k: spec(v) for k, v in batch_shapes.items()}


def spec_for_cache(path, shape, mesh) -> P:
    """KV caches: batch on (pod,data); cache length on "model" (the
    sequence-sharded layout); SSM/LRU states: batch on (pod,data),
    width/heads on model. The port's caches are ``repro``'s stacked
    ``(L, B, T, K, hd)`` dicts, so the rules apply as they are."""
    sizes = _sizes(mesh)
    pod, fsdp, tp = _axes(mesh)
    ba = (pod, fsdp) if pod else fsdp
    name = _name(path).rstrip("0123456789")
    nd = len(shape)

    def ax(a, size):
        if a is None:
            return None
        if isinstance(a, tuple):
            tot = 1
            for x in a:
                tot *= sizes[x]
            return a if size % tot == 0 else None
        return a if size % sizes[a] == 0 else None

    if name in ("k", "v", "ek", "ev"):
        if nd == 5:  # (L, B, T, K, hd)
            return P(None, ax(ba, shape[1]), ax(tp, shape[2]), None, None)
        if nd == 4:  # (B, T, K, hd)
            return P(ax(ba, shape[0]), ax(tp, shape[1]), None, None)
    if name == "state":  # (L, B, H, P, N)
        return P(None, ax(ba, shape[1]), ax(tp, shape[2]), None, None)
    if name == "tail":
        if nd == 4:  # (L, B, k-1, C)
            return P(None, ax(ba, shape[1]), None, ax(tp, shape[3]))
        return P(ax(ba, shape[0]), None, ax(tp, shape[2]))
    if name == "h":  # (G, B, W) rg-lru state
        if nd == 3:
            return P(None, ax(ba, shape[1]), ax(tp, shape[2]))
        return P(ax(ba, shape[0]), ax(tp, shape[1]))
    return P(*([None] * nd))


def make_cache_specs(model, mesh, batch: int, max_len: int) -> Any:
    shapes = model.init_cache(batch, max_len, "meta")
    return _map_with_path(
        lambda path, leaf: spec_for_cache(path, leaf.shape, mesh), shapes)


class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``), with its
    DTensor ``placements``."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements!r})"


def placements(mesh, spec: P) -> tuple:
    """One DTensor placement a mesh dimension for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dimension {d} of {spec!r} lists its axes out of the "
                f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def place(tree, mesh, specs):
    """``tree``'s tensors distributed over ``mesh`` by ``specs`` (a spec
    tree shaped like ``tree``): each becomes a DTensor whose local shard
    this rank holds. Every rank passes the same full tensors (from one
    seed, or a checkpoint); a leaf that is already a DTensor is gathered
    first. A leaf whose shard here is all of it (replicated, or sharded
    only over mesh dimensions of one rank) keeps its storage, so placing
    a state on a mesh of one copies nothing. ``requires_grad`` is kept."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    def one(t, spec):
        if t is None:
            return None
        req = t.requires_grad
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        pl = placements(mesh, spec)
        if all(not isinstance(p, Shard) or n == 1
               for p, n in zip(pl, mesh.shape)):
            out = DTensor.from_local(t, mesh, pl, run_check=False)
        else:
            out = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return out.requires_grad_(req) if req else out

    return tree_map(one, tree, specs)


def place_batch(batch: dict, mesh) -> dict:
    """``batch`` (names to arrays or tensors, the global batch on every
    rank) placed by ``make_batch_specs``: each rank keeps its own rows, with
    no communication. Each value becomes a tensor on this rank's device as
    the train step makes it (integers as int64); a value that is already
    a DTensor is kept."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import mesh_device
    from repro_torch.train.train_step import _batch_tensor

    dev = mesh_device(mesh)
    specs = make_batch_specs(batch, mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        out[k] = distribute_tensor(_batch_tensor(v, dev), mesh,
                                   placements(mesh, specs[k]),
                                   src_data_rank=None)
    return out


def _map_with_path(fn, tree, path=()):
    """``tree`` (nested dicts, lists, NamedTuples) with each leaf replaced
    by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


__all__ = [
    "P", "PartitionSpec", "NamedSharding", "spec_for_param",
    "make_param_specs", "make_state_specs", "batch_axes",
    "make_batch_specs", "row_axes", "divisible_axes", "spec_for_cache", "make_cache_specs", "named",
    "placements", "place", "place_batch", "param_shapes",
]
