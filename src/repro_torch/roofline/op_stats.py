"""Per-device statistics of one step, counted at dispatch: dot FLOPs,
memory traffic and collective bytes (the port's counterpart of
``repro/roofline/hlo_stats.py``, which walks XLA's post-SPMD HLO text;
the port has no HLO).

``OpCounter`` is a ``TorchDispatchMode``. Inside it every aten op that
runs on this rank's local tensors is counted once; an op on DTensors is
not counted itself but handed to DTensor, whose local ops (this rank's
products, its redistributions' collectives) come back through the mode
and are. So the numbers are per device, as ``analyze_hlo``'s are on the
partitioned module. DTensor's sharding propagation runs each new op once
more on fake global-shape tensors to learn its output's shape; the
counter pauses there (that work is bookkeeping, not the step's). It
works on real tensors and on fake ones (``FakeTensorMode``, the
dry-run), with the same counts for the same ops.

  * ``dot_flops``: ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` (an
    ``einsum`` or ``matmul`` reaches dispatch as these), 2 x the output's
    elements x the contraction, by ``torch.utils.flop_counter``'s
    formulas. The tensor-core work.
  * ``mem_bytes``: the eager port's first-order HBM model. Each local op
    reads its tensor operands and writes its results; a view costs
    nothing, an allocation (``empty``) nothing, and an operand the op
    writes in place counts as written, not read. Eager PyTorch fuses
    nothing, so this exceeds ``repro``'s post-fusion count for the same
    step; it is not tuned toward it.
  * collectives, by ``repro``'s names and ring conventions: the bytes of
    the result, an all-reduce twice (reduce-scatter + all-gather), a
    reduce-scatter times its group (it reads the whole operand). Both the
    functional collectives (DTensor's) and the ``torch.distributed``
    calls (the sharded search's ``all_reduce``) are counted. On a CPU
    mesh DTensor turns an all-to-all into an all-gather and a chunk;
    the counter counts that as one all-to-all of the bytes it would move
    (``cpu_alltoall_fallbacks`` says how many), never as an all-gather.
    ``collective_cross_node`` holds the bytes of the collectives whose
    group spans more than one node of ``H100_NODE_CARDS`` cards (global
    ranks ``8i .. 8i + 7`` a node), which a ring carries over the NIC
    rather than NVLink.
  * loops: eager execution runs every loop, so every trip is counted and
    ``dynamic_loops`` is empty.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_DOTS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm)
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "wait_tensor", "device", "layout",
         "is_contiguous", "is_strides_like_format", "size", "stride",
         "numel", "dim", "storage_offset", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_non_overlapping_and_dense",
         "sym_is_contiguous", "_local_scalar_dense", "record_stream"}
# (namespace, op name) -> repro's kind; the functional collectives
# (DTensor's) and the c10d ops behind torch.distributed's calls
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}


def _group(args, kwargs):
    """The process group a collective runs on: a c10d op's
    ``ProcessGroup`` argument (boxed), or a functional op's group name."""
    import torch.distributed as dist

    for a in (*args, *kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return a
        if (isinstance(a, torch.ScriptObject) and a._type().qualified_name()
                == "__torch__.torch.classes.c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    name = kwargs.get("group_name", args[-1] if args else None)
    if not isinstance(name, str):
        raise RuntimeError("a collective without a process group: "
                           f"{args!r} {kwargs!r}")
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _spans_nodes(group) -> bool:
    import torch.distributed as dist

    from repro_torch.launch.mesh import H100_NODE_CARDS

    return len({r // H100_NODE_CARDS
                for r in dist.get_process_group_ranks(group)}) > 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts one region's per-device work (module docstring); read it with
    ``stats()`` after the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.mem_bytes = 0.0
        self.coll = defaultdict(float)
        self.cross_node = 0.0
        self.counts = defaultdict(int)
        self.events: list[tuple[str, float]] = []  # (kind, bytes) in order
        self.cpu_alltoall_fallbacks = 0
        self._paused = 0

    # -- the mode --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor

        if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
            return NotImplemented  # DTensor runs the local ops, seen here
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVE_OPS.get((func.namespace, name))
        if kind is not None:
            self._collective(kind, func, args, kwargs, out)
        if func.overloadpacket in _DOTS:
            from torch.utils.flop_counter import flop_registry

            self.dot_flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if name in _FREE or _is_view(func):
            return
        written = _written(func, args, kwargs)
        reads = sum(_nbytes(t) for t in _tensors((args, kwargs))
                    if id(t) not in written)
        self.mem_bytes += reads + sum(_nbytes(t) for t in _tensors(out))

    def _collective(self, kind, func, args, kwargs, out) -> None:
        """Result bytes under ``repro``'s conventions. A c10d op is given
        its result buffers first (a reduce-scatter's input second); a
        functional one returns its result, and a reduce-scatter's
        ``(input, op, group_size, name)`` names its group's size."""
        if func.namespace == "c10d":
            moved = sum(_nbytes(t) for t in _tensors(
                args[1] if kind == "reduce-scatter" else args[0]))
        else:
            moved = sum(_nbytes(t) for t in _tensors(out))
            if kind == "reduce-scatter":
                moved *= int(args[2])
        if kind == "all-reduce":
            moved *= 2
        self._add(kind, moved, _group(args, kwargs))

    def _add(self, kind: str, moved: float, group) -> None:
        self.coll[kind] += moved
        self.counts[kind] += 1
        if _spans_nodes(group):
            self.cross_node += moved
        self.events.append((kind, float(moved)))

    # -- hooks: sharding propagation paused, CPU all-to-all recognized ---
    @contextlib.contextmanager
    def _hooks(self):
        from torch.distributed.tensor import _sharding_prop, placement_types

        prop = _sharding_prop.ShardingPropagator
        # the method that runs an op on fake global tensors (torch 2.5 on;
        # earlier ones cached it under the shorter name)
        meta_name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                     "_propagate_tensor_meta")
                         if hasattr(prop, n))
        meta = getattr(prop, meta_name)
        orig_a2a = placement_types.shard_dim_alltoall
        counter = self

        def paused_meta(self_, *a, **kw):
            counter._paused += 1
            try:
                return meta(self_, *a, **kw)
            finally:
                counter._paused -= 1

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu" or counter._paused:
                return orig_a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
            # DTensor's CPU fallback (all-gather + chunk): one all-to-all
            counter._paused += 1
            try:
                out = orig_a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                counter._paused -= 1
            counter.cpu_alltoall_fallbacks += 1
            counter._add("all-to-all", float(_nbytes(out)),
                         mesh.get_group(mesh_dim))
            counter.mem_bytes += _nbytes(input) + _nbytes(out)
            return out

        setattr(prop, meta_name, paused_meta)
        placement_types.shard_dim_alltoall = alltoall
        try:
            yield
        finally:
            setattr(prop, meta_name, meta)
            placement_types.shard_dim_alltoall = orig_a2a

    def __enter__(self):
        self._hook_cm = self._hooks()
        self._hook_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hook_cm.__exit__(None, None, None)

    def stats(self) -> dict:
        """``analyze_hlo``'s keys (``entry`` names the counted region)."""
        return {
            "entry": "torch_dispatch",
            "dot_flops": float(self.dot_flops),
            "mem_bytes": float(self.mem_bytes),
            "collective_bytes": {k: float(v) for k, v in self.coll.items()},
            "collective_total": float(sum(self.coll.values())),
            "collective_cross_node": float(self.cross_node),
            "collective_counts": dict(self.counts),
            "dynamic_loops": [],
            "cpu_alltoall_fallbacks": self.cpu_alltoall_fallbacks,
        }


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _written(func, args, kwargs) -> set:
    """ids of the tensor arguments ``func`` writes in place."""
    out = set()
    params = func._schema.arguments
    for i, p in enumerate(params):
        if p.alias_info is None or not p.alias_info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(p.name)
        out.update(id(t) for t in _tensors(val))
    return out


__all__ = ["OpCounter"]
