"""Atomic, async-capable checkpoints (port of ``repro/train/checkpoint.py``).

Layout, the same as ``repro``'s so that either package reads the other's
directories: ``<dir>/step_<N:08d>/`` holds one ``.npy`` per leaf, named by
its key path as ``jax.tree_util`` names it (dict keys sorted, sequence
items by index, a NamedTuple's fields as ``.<field>``, the parts joined
with ``.``: ``TrainState(params={"b": ...}, step=...)`` gives
``.params.b`` and ``.step``), and ``manifest.json`` (the step and the leaf
index). Commit protocol: write into ``step_<N>.tmp``, then ``rename``; a
half-written checkpoint is never visible.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
numpy arrays, tensors (any device) or scalars; ``None`` holds no leaf.
A bfloat16 tensor is written as ``repro`` writes a bfloat16 array: its raw
16-bit patterns as a ``|V2`` array (numpy has no bfloat16 type).
``restore`` returns numpy arrays in the template leaf's dtype, and for a
bfloat16 leaf that ``|V2`` array of bit patterns; ``load_into`` copies a
restored tree into a tree of tensors (the same bits for bfloat16).

A placed tree (DTensor leaves on one ``DeviceMesh``,
``distributed.sharding.place``) is saved whole: every rank of the mesh
gathers each leaf (a collective, so every rank calls ``save`` or
``submit`` at the same point), and the mesh's first rank writes the files;
the others write nothing. ``load_into`` puts each restored leaf back into
its DTensor with its placement (each rank keeps its shard of the full
array it read).

``AsyncCheckpointer`` writes on a worker thread. ``submit`` copies every
leaf on the caller's thread first (``repro`` takes its snapshot with
``jax.device_get``): ``.cpu()`` for a tensor on a card, a numpy copy for
the rest, since a CPU tensor's ``.numpy()`` shares its memory. The worker
touches numpy only, never CUDA.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.layout import full, mesh_of


def _map(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, ``name`` its
    key path as ``repro`` names it; dicts come back in sorted key order,
    as ``jax.tree_util`` rebuilds them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map(fn, getattr(tree, f), path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return items if isinstance(tree, list) else tuple(items)
    return fn("/".join(path).replace("/", "."), tree)


def _flatten(tree) -> list:
    """``[(name, leaf), ...]`` in ``repro``'s order and naming."""
    named = []
    _map(lambda name, leaf: named.append((name, leaf)), tree)
    return named


BF16_BITS = np.dtype("V2")  # how numpy stores a bfloat16 array's bits


def _writes(tree) -> bool:
    """Whether this process writes ``tree``'s files: always for a plain
    tree; for a placed tree only on its mesh's first rank."""
    mesh = mesh_of(tree)
    if mesh is None:
        return True
    import torch.distributed as dist

    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def _to_host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array (a bfloat16 tensor as its ``|V2`` bit
    patterns; a DTensor gathered whole first, a collective); ``copy``
    makes it independent of ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        leaf = full(leaf.detach())
        bf16 = leaf.dtype == torch.bfloat16
        if bf16:
            leaf = leaf.view(torch.int16)
        if leaf.device.type != "cpu":
            arr = leaf.cpu().numpy()  # the copy to the host is fresh memory
        else:
            arr = leaf.numpy().copy() if copy else leaf.numpy()
        return arr.view(BF16_BITS) if bf16 else arr
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16_BITS
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _as_dtype(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """``arr`` in ``dtype``; into ``|V2`` (bfloat16 bits) a float array is
    rounded to bfloat16 by torch, and ``|V2`` stays as it is."""
    if dtype == BF16_BITS and arr.dtype != BF16_BITS:
        t = torch.as_tensor(np.asarray(arr, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16_BITS)
    return np.asarray(arr, dtype=dtype)


def _host_tensor(arr, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if dtype == torch.bfloat16:
        bits = _as_dtype(arr, BF16_BITS).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.as_tensor(np.array(arr)).to(dtype)


@torch.no_grad()
def load_into(template, restored):
    """``restore``'s tree copied into ``template``'s tensors in place (each
    keeps its device, dtype and ``requires_grad``); returns ``template``
    with those tensors, and ``restored``'s leaf where ``template`` holds
    no tensor."""
    if template is None:
        return None
    if hasattr(template, "device_mesh"):  # a DTensor: keep its placement
        from torch.distributed.tensor import distribute_tensor

        whole = _host_tensor(restored, template.dtype).to(template.device)
        return template.copy_(distribute_tensor(
            whole, template.device_mesh, template.placements,
            src_data_rank=None))
    if isinstance(template, torch.Tensor):
        return template.copy_(_host_tensor(restored, template.dtype))
    if isinstance(template, dict):
        return {k: load_into(v, restored[k]) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(load_into(a, b)
                                for a, b in zip(template, restored)))
    if isinstance(template, (list, tuple)):
        return type(template)(load_into(a, b) for a, b in zip(template, restored))
    return restored


def save(ckpt_dir: str, tree, step: int) -> str:
    """Synchronous atomic checkpoint. Returns the committed directory (on
    a rank that gathers a placed tree without writing it, the directory
    its writer commits)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _writes(tree):
        _map(lambda _name, leaf: _to_host(leaf), tree)  # the gathers
        return final
    named = _flatten(tree)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in named:
        fname = f"{name}.npy"
        np.save(os.path.join(tmp, fname), _to_host(leaf))
        manifest["leaves"].append({"name": name, "file": fname})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def steps(ckpt_dir: str) -> list[int]:
    """All committed checkpoint steps under ``ckpt_dir``, ascending.

    Only fully renamed ``step_<N>`` directories appear, but a committed
    checkpoint can still be damaged after the fact (disk fault, partial
    copy): callers that must survive that walk this list newest-first and
    fall back on a failed restore (``serve.supervisor.SearchSupervisor``).
    """
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    )


def latest_step(ckpt_dir: str) -> int | None:
    all_steps = steps(ckpt_dir)
    return all_steps[-1] if all_steps else None


def restore(ckpt_dir: str, template, step: int | None = None):
    """Restore into the structure of ``template``; returns ``(tree, step)``
    with numpy leaves in the template leaves' dtypes (a bfloat16 leaf as
    its ``|V2`` bit patterns: ``load_into`` makes it a tensor again)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e["file"] for e in manifest["leaves"]}

    def load(name, leaf):
        return _as_dtype(np.load(os.path.join(d, by_name[name])),
                         _np_dtype(leaf))

    return _map(load, template), step


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    for s in steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Off-thread checkpoint writer with a bounded queue (backpressure).

    ``wait()`` is the write barrier: it blocks until every submitted
    checkpoint is committed (or has recorded its error). Supervisors call it
    before any restore or rollback, so replay never races an in-flight
    write.

    ``write_hook`` is a test injection point: when set, it is called with
    ``(tree, step)`` on the worker thread just before the atomic ``save``
    (a sleeping hook widens the in-flight window).
    """

    def __init__(self, ckpt_dir: str, keep: int = 3, write_hook=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._write_hook = write_hook
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tree, step = item
                try:
                    if self._write_hook is not None:
                        self._write_hook(tree, step)
                    save(self.ckpt_dir, tree, step)
                    prune_old(self.ckpt_dir, self.keep)
                except Exception as e:  # surfaced on next submit/wait/close
                    self._err = e
            finally:
                self._q.task_done()

    def submit(self, tree, step: int) -> None:
        if self._err:
            raise self._err
        # A consistent snapshot, copied (and gathered) on this thread.
        snapshot = _map(lambda _name, leaf: _to_host(leaf, copy=True), tree)
        if _writes(tree):
            self._q.put((snapshot, int(step)))

    def wait(self) -> None:
        """Barrier: block until every submitted checkpoint is on disk."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
        if self._err:
            raise self._err
