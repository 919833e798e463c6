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
``write_into`` writes a placed cache in place, shard by shard.
``to_local`` / ``from_local`` are ``shard_map``'s two edges: a region
that DTensor's rules do not cover (the attention core, the
expert-parallel MoE) runs on each rank's shards as plain tensors;
``on_batch_rows`` runs one on each rank's batch rows (mamba2's mixer,
the RG-LRU). ``row_parallel`` reduces an out-projection's pending sum.
"""
from __future__ import annotations

import contextlib

import torch

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
    none was given), its leading (batch) dimension over the innermost
    batch axes that divide it (``sharding.divisible_axes``)."""
    from repro_torch.distributed.sharding import P, divisible_axes, placements

    if not isinstance(x, _dtensor()):
        raise RuntimeError(
            f"a plain {tuple(x.shape)} tensor reached an activation anchor "
            "while sharding axes are set: place the batch with "
            "distributed.sharding.make_batch_specs (or hints.clear())")
    mesh = _MESH if _MESH is not None else x.device_mesh
    spec = (divisible_axes(mesh, spec[0], x.shape[0]),) + tuple(spec[1:])
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


def seq_whole(x):
    """Sequence parallelism's all-gather (Megatron's ``g``): a norm's
    (B, S, D) output, which feeds a block's products, with its sequence
    dimension whole where the anchors shard it over the TP axis. DTensor
    on torch 2.11 refuses to flatten a sequence-sharded (B, S) into a
    product's rows; GSPMD gathers it there. Any other tensor, or without
    sequence parallelism, as it is."""
    if not _SEQ_PARALLEL or x.ndim < 3:
        return x
    return replicate_dims(x, 1)


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


def row_parallel(y):
    """A row-parallel product's output (an attention's, an MLP's or a
    mixer's out-projection, its contraction split over ``"model"``) with
    the pending sum reduced, as Megatron's all-reduce does; GSPMD reduces
    it at the residual add. Left pending, DTensor resolves it at the next
    nonlinear op with a reduce-scatter that may split the token rows over
    ``"model"`` inside their batch split, and a product on such rows has
    no sharding rule on every torch. The gradient leaves reduced too
    (Megatron's identity on a replicated gradient): a pending sum there
    makes DTensor compute the products of the backward twice over
    ``"model"``. Any other tensor as it is."""
    if not isinstance(y, _dtensor()):
        return y
    return _RowParallel.apply(y)


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return replicate_dims(y)  # no dimension named: the sums reduced

    @staticmethod
    def backward(ctx, g):
        return replicate_dims(g)


def write_into(dst, src) -> None:
    """``dst.copy_(src)`` in ``dst``'s placement (a cache written in place
    by prefill or decode): a placed ``dst`` takes ``src`` brought to its
    placements (a plain ``src`` counts as replicated) and each rank
    copies into its own shard."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 (Replicate(),) * dst.device_mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


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


def on_batch_rows(fn, params: dict, *xs):
    """``fn(params, *xs)`` on each rank's batch rows (``shard_map`` over
    the batch axes of ``xs[0]``'s mesh, everything whole over the other
    axes): for a region whose reshapes and scans DTensor's rules do not
    keep batch-sharded. ``params`` (name -> DTensor) come whole to every
    rank, each batch shard's gradient of them a part; each of ``xs``
    ((B, ...) DTensors, or None) comes split by rows; each output of
    ``fn`` (a tuple of (B_local, ...) tensors) goes back split the same
    way."""
    from repro_torch.distributed.sharding import row_axes

    mesh = xs[0].device_mesh
    b = xs[0].shape[0]
    bax = row_axes(mesh, b)

    def rows(t):
        return None if t is None else to_local(
            t, mesh, (bax,) + (None,) * (t.dim() - 1))

    local = {k: to_local(v, mesh, (None,) * v.dim(), sums=bax or ())
             for k, v in params.items()}
    outs = fn(local, *(rows(t) for t in xs))
    return tuple(from_local(t, mesh, (bax,) + (None,) * (t.dim() - 1),
                            (b,) + tuple(t.shape[1:])) for t in outs)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
