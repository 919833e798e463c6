"""Activation-sharding anchors (port of ``repro/distributed/hints.py``).

Model code calls the ``constrain_*`` anchors after the embedding, after
each block, at the logits and on decode scores. Once ``set_axes`` names
the batch axes (and the mesh), each anchor redistributes its DTensor to
``repro``'s spec for that point: activations batch-sharded over
``(pod, data)`` and replicated over ``"model"`` (with sequence
parallelism the sequence dimension also over ``"model"``), logits with the
vocabulary over ``"model"``. That is what ``repro``'s
``with_sharding_constraint`` asks GSPMD for. With no axes set every anchor
is the identity, so single-device runs are untouched.

A plain tensor reaching an anchor while axes are set is an error: the
batch was not placed (``sharding.make_batch_specs``), and the step would
otherwise run unsharded without saying so.

``replicate_dims`` is the port's own: where DTensor has no sharding rule
for an op the models use, the model code brings that operand's named
dimensions to ``Replicate`` first, as GSPMD would reshard it.
``to_local`` / ``from_local`` are ``shard_map``'s two edges: a region
that DTensor's rules do not cover (the attention core, the
expert-parallel MoE) runs on each rank's shards as plain tensors.
"""
from __future__ import annotations

import contextlib

_BATCH_AXES: tuple | None = None
_TP_AXIS: str | None = None
_SEQ_PARALLEL: bool = False
_MESH = None


def set_axes(
    batch_axes: tuple | None,
    tp_axis: str | None = "model",
    seq_parallel: bool = False,
    mesh=None,
) -> None:
    global _BATCH_AXES, _TP_AXIS, _SEQ_PARALLEL, _MESH
    _BATCH_AXES = batch_axes
    _TP_AXIS = tp_axis
    _SEQ_PARALLEL = seq_parallel
    _MESH = mesh


def clear() -> None:
    set_axes(None, None)


def mesh_info():
    """(mesh, batch_axes, tp_axis) when set — used by ``mlp.moe_ep``."""
    if _MESH is None or _BATCH_AXES is None:
        return None
    return _MESH, _BATCH_AXES, _TP_AXIS


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _constrain(x, spec: tuple):
    """``x`` redistributed to ``spec`` on the set mesh (``x``'s own when
    none was given)."""
    from repro_torch.distributed.sharding import P, placements

    if not isinstance(x, _dtensor()):
        raise RuntimeError(
            f"a plain {tuple(x.shape)} tensor reached an activation anchor "
            "while sharding axes are set: place the batch with "
            "distributed.sharding.make_batch_specs (or hints.clear())")
    mesh = _MESH if _MESH is not None else x.device_mesh
    want = placements(mesh, P(*spec))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_acts(x):
    """(B, S, D) activations: batch on (pod, data); with sequence
    parallelism the sequence dim additionally shards on the TP axis at
    block boundaries."""
    if _BATCH_AXES is None:
        return x
    if _SEQ_PARALLEL and x.ndim >= 3:
        spec = (_BATCH_AXES, _TP_AXIS, *([None] * (x.ndim - 2)))
    else:
        spec = (_BATCH_AXES, *([None] * (x.ndim - 1)))
    return _constrain(x, spec)


def constrain_logits(x):
    """(B, S, V) logits: batch on (pod, data), vocab on the TP axis."""
    if _BATCH_AXES is None:
        return x
    return _constrain(x, (_BATCH_AXES, *([None] * (x.ndim - 2)), _TP_AXIS))


def constrain_decode_scores(scores):
    """Decode scores (B, K, G, 1, T): the cache length on the TP axis, so
    the softmax runs on local pieces (flash-decode sharding)."""
    if _BATCH_AXES is None:
        return scores
    return _constrain(scores, (_BATCH_AXES, None, None, None, _TP_AXIS))


def replicate_dims(x, *dims):
    """``x`` with dimensions ``dims`` replicated (a pending sum reduced)
    where ``x`` is a DTensor; any other tensor as it is. For the operands
    of ops DTensor has no sharding rule for."""
    if not isinstance(x, _dtensor()):
        return x
    from torch.distributed.tensor import Replicate, Shard

    own = {d % x.ndim for d in dims}
    want = tuple(
        Replicate() if p.is_partial()
        or (isinstance(p, Shard) and p.dim in own) else p
        for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


_PLAIN_DEPTH = 0


@contextlib.contextmanager
def replicated_plain(on: bool | None = None):
    """Inside, a plain tensor that meets a DTensor counts as replicated
    (DTensor's ``implicit_replication``): the positions, masks and
    constants a model or an optimizer builds from global shapes hold the
    same values on every rank. ``on`` None: on while axes are set. Nests."""
    global _PLAIN_DEPTH
    if on is None:
        on = _BATCH_AXES is not None or _MESH is not None
    if not on or _PLAIN_DEPTH:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _PLAIN_DEPTH += 1
    try:
        with implicit_replication():
            yield
    finally:
        _PLAIN_DEPTH -= 1


def to_local(t, mesh, spec: tuple, sums: tuple = ()):
    """``shard_map``'s input edge: ``t`` (a DTensor, or a plain tensor that
    holds the same values on every rank) redistributed to ``spec`` on
    ``mesh``, and this rank's shard of it as a plain tensor. Over a mesh
    axis that ``spec`` leaves unsharded, its gradient returns as a pending
    sum if the axis is named in ``sums`` (each rank's gradient is a part:
    its tokens, its experts), else replicated (each rank computed all of
    it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import P, placements

    want = placements(mesh, P(*spec))
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t.contiguous(), mesh,
                               (Replicate(),) * mesh.ndim, run_check=False)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    grad = tuple(Partial() if n in sums and not isinstance(p, Shard) else p
                 for n, p in zip(mesh.mesh_dim_names, want))
    return t.to_local(grad_placements=grad)


def from_local(t, mesh, spec: tuple, shape, sums: tuple = ()):
    """``shard_map``'s output edge: this rank's shard ``t`` as a DTensor of
    global ``shape`` placed by ``spec``, brought to ``spec`` where the
    region left a pending sum over the mesh axes in ``sums`` (one
    all-reduce SUM over each)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.distributed.sharding import P, placements

    want = placements(mesh, P(*spec))
    pending = tuple(Partial() if n in sums else p
                    for n, p in zip(mesh.mesh_dim_names, want))
    out = DTensor.from_local(t, mesh, pending, run_check=False,
                             shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    return out.redistribute(mesh, want) if sums else out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
