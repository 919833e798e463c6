"""Trees of tensors, and ``repro``'s stacked leaves over the port's
per-layer lists.

A tree is nested dicts, lists and tuples (NamedTuples too) of tensors,
``None`` holding none (the port's LM
parameters once ``train_step.trainable`` has unwrapped their
``ParamTree``). ``leaves`` walks one in ``repro``'s order (dict keys
sorted), and ``unflatten`` rebuilds its structure around other leaves.

``repro`` stacks each layer's parameters on a leading ``(L, ...)`` axis,
and its optimizer and gradient compression decide per stacked leaf: the
rank that gates weight decay and factoring, Adafactor's update-RMS clip
and the int8 scale all see the whole stack. The port keeps layers as
per-layer lists (``interop.lm_params_from_numpy``), so ``stacks`` names
the group of per-layer tensors that ``repro`` stacks into each of its
leaves; the optimizer then reduces over the group's tensors, never
building the stacked one.

A placed tree's leaves are DTensors (``distributed.sharding.place``);
``full`` reads one's whole value, and ``mesh_of`` finds a tree's mesh.
"""
from __future__ import annotations

from typing import NamedTuple

# Entries of each family's tree that ``repro`` stacks on a leading layer
# axis; rglru's ``groups`` is a list of pattern groups whose slots
# ``repro`` stacks over the groups, and its ``remainder`` is unstacked.
STACKED = {"dense": ("layers",), "moe": ("layers",), "vlm": ("layers",),
           "ssm": ("layers",), "audio": ("enc_layers", "dec_layers"),
           "hybrid": ()}


class Stack(NamedTuple):
    """One ``repro`` leaf: the paths of the port's tensors it stacks, in
    layer order, and whether it is a stack (a stack's rank is one more
    than a layer's)."""

    paths: list
    stacked: bool


def leaves(tree, path=()):
    """``[(path, leaf), ...]`` of ``tree``, dict keys sorted; ``None``
    holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def full(t):
    """A DTensor's whole value as a plain tensor on this rank (a pending
    reduction resolved, shards gathered: a collective over its mesh); any
    other value as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_of(tree):
    """The ``DeviceMesh`` of ``tree``'s first DTensor leaf, or None for a
    tree of plain tensors (placed state is placed whole)."""
    for _, leaf in leaves(tree):
        mesh = getattr(leaf, "device_mesh", None)
        if mesh is not None:
            return mesh
    return None


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def unflatten(like, values):
    """``like``'s structure around ``values``, given in ``leaves`` order.

    A module-level recursion: a nested function that calls itself is a
    reference cycle, which would keep ``values`` (a step's gradient
    accumulator) alive after the call until the garbage collector ran."""
    return _build(like, iter(values))


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(v, it) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    others = [[leaf for _, leaf in leaves(r)] for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, (_, leaf) in enumerate(leaves(tree))])


def stacks(cfg, tree) -> list[Stack]:
    """The ``Stack`` of every leaf of ``repro``'s tree for ``cfg`` over the
    port's ``tree``. ``cfg`` None: every leaf is its own, unstacked (a
    tree that is not an LM's parameters)."""
    if cfg is None:
        return [Stack([p], False) for p, _ in leaves(tree)]
    out = []
    for key in sorted(tree):
        sub = tree[key]
        if key in STACKED[cfg.family]:
            for rel, _ in leaves(sub[0]):
                out.append(Stack([(key, i) + rel for i in range(len(sub))],
                                 True))
        elif cfg.family == "hybrid" and key == "groups":
            for slot in range(len(sub[0]) if len(sub) else 0):
                for rel, _ in leaves(sub[0][slot]):
                    out.append(Stack(
                        [(key, g, slot) + rel for g in range(len(sub))], True))
        else:
            out.extend(Stack([(key,) + rel], False) for rel, _ in leaves(sub))
    return out


def rank(stack: Stack, tree) -> int:
    """The rank of ``repro``'s leaf for ``stack``."""
    return get(tree, stack.paths[0]).dim() + int(stack.stacked)

