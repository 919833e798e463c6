"""Carry state across from ``repro``.

The system has no weights; its state is the stage-1 products
(``PreparedRef``, ``PreparedQueries``) and the incumbents
(``IncumbentState``). ``from_numpy`` turns those fields, given as numpy
arrays (``np.asarray`` of ``repro``'s arrays), into the port's tuple of
the same name on a given device. A test can then feed both packages the
same ``mu``, ``sigma``, ``qn``, ``u``, ``low`` and ``ub``, and hold a
round of the port against ``repro`` apart from prefix-sum rounding.

A stream's state crosses over through the engines' snapshots: a dict that
``repro``'s ``StreamSearchEngine.save_state()`` returned (its keys, with
``best`` and the counters in int32) goes as it is into
``repro_torch.serve.StreamSearchEngine.restore_state``, which widens them
to int64 and carries on the stream on its own device.

A language model's weights cross over through ``lm_params_from_numpy``:
``repro``'s parameter tree with ``np.asarray`` leaves becomes the port's
``ParamTree``, with ``repro``'s stacked layers unstacked into lists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.search.incumbents import IncumbentState
from repro_torch.search.pipeline import PreparedQueries, PreparedRef


def _tensor(x, device):
    if x is None:
        return None
    a = np.array(x)  # a copy: the source may be read-only
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    else:
        dtype = torch.float32
    return torch.as_tensor(a, device=device).to(dtype)


def from_numpy(cls, device, **fields):
    """``cls(**fields)`` with every field a tensor on ``device``.

    ``cls`` is ``PreparedRef``, ``PreparedQueries`` or ``IncumbentState``;
    ``fields`` are its field names. Floating arrays become float32,
    integer arrays int64 and boolean arrays bool; ``None`` stays ``None``
    (``PreparedRef.valid`` when nothing is quarantined).
    """
    if cls not in (PreparedRef, PreparedQueries, IncumbentState):
        raise TypeError(f"no numpy form for {cls!r}")
    missing = set(cls._fields) - set(fields)
    extra = set(fields) - set(cls._fields)
    if missing or extra:
        raise TypeError(
            f"{cls.__name__} fields: missing {sorted(missing)}, unexpected "
            f"{sorted(extra)}"
        )
    dev = torch.device(device)
    return cls(**{k: _tensor(v, dev) for k, v in fields.items()})


# Entries of each family's tree that ``repro`` stacks on a leading layer
# axis (rglru's ``groups`` is a tuple of such stacks, one a pattern slot).
_STACKED = {"dense": ("layers",), "moe": ("layers",), "vlm": ("layers",),
            "ssm": ("layers",), "audio": ("enc_layers", "dec_layers")}


def _lm_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' type, which torch cannot read
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree, n: int) -> list:
    return [_tree_map(lambda a: a[i], tree) for i in range(n)]


def _leading(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return np.shape(tree)[0]


def lm_params_from_numpy(cfg, tree: dict, device):
    """The port's parameters for ``cfg`` from ``repro``'s tree.

    ``tree`` is what ``repro``'s ``build(cfg).init(key)`` returns, with
    every leaf an ``np.asarray`` array. Stacked layers become per-layer
    lists: the transformer's and mamba2's ``layers``, whisper's
    ``enc_layers`` and ``dec_layers``, and rglru's ``groups`` (a tuple of
    ``len(pattern)`` stacks, empty with no whole group) a list of groups,
    each a list of its blocks; rglru's ``remainder`` is a list already.
    Tied embeddings stay tied: such a tree has no ``unembed``, and the
    port's forward reads ``embed`` for both ends. Leaves keep their type
    (bfloat16 included).
    """
    from repro_torch.models.common import ParamTree

    out = dict(tree)
    if cfg.family == "hybrid":
        groups = tree["groups"]
        n = _leading(groups) if len(groups) else 0
        out["groups"] = [[_tree_map(lambda a: a[g], slot) for slot in groups]
                         for g in range(n)]
    else:
        for key in _STACKED[cfg.family]:
            out[key] = _unstack(tree[key], _leading(tree[key]))
    dev = torch.device(device)
    return ParamTree(_tree_map(lambda a: _lm_tensor(a, dev), out))
