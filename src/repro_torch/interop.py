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
``lm_tree_to_numpy`` goes back: a tree in the port's per-layer layout
(parameters, gradients, AdamW moments, Adafactor row statistics, error
feedback) as numpy arrays in ``repro``'s stacked layout. A whole train
state crosses with ``train_state_from_numpy`` (``repro``'s ``TrainState``
to the port's, trainable) and ``train_state_to_numpy`` (the port's as
numpy in ``repro``'s layout).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.search.incumbents import IncumbentState
from repro_torch.search.pipeline import PreparedQueries, PreparedRef
from repro_torch.train.layout import STACKED, tree_map


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


def _lm_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' type, which torch cannot read
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


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

    dev = torch.device(device)
    return ParamTree(tree_map(lambda a: _lm_tensor(a, dev),
                               _per_layer(cfg, tree, tree)))


def _per_layer(cfg, tree, params, take=lambda a, p, i: a[i]):
    """``tree`` (``repro``'s layout for ``cfg``) with each stacked subtree
    split into per-layer lists; ``params`` is ``repro``'s parameter tree
    (it gives the layer counts), and ``take(leaf, its parameter, i)`` is
    layer ``i``'s part of a stacked leaf."""
    out = dict(tree)
    if cfg.family == "hybrid":
        groups, pgroups = tree["groups"], params["groups"]
        n = _leading(pgroups) if len(pgroups) else 0
        out["groups"] = [
            [tree_map(lambda a, p: take(a, p, g), slot, pslot)
             for slot, pslot in zip(groups, pgroups)]
            for g in range(n)]
    else:
        for key in STACKED[cfg.family]:
            out[key] = [tree_map(lambda a, p: take(a, p, i), tree[key],
                                  params[key])
                        for i in range(_leading(params[key]))]
    return out


def _host(t) -> np.ndarray:
    """A tensor as a numpy array (bfloat16 as float32: the same values)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(xs, p):
    return np.stack(xs)


def _stacked(cfg, tree, params, put=_stack):
    """The inverse of ``_per_layer`` on the port's per-layer ``tree`` of
    numpy arrays: ``put(layers' leaves, layer 0's parameter)`` rebuilds a
    stacked leaf."""
    tree, params = dict(tree), dict(params)
    keys = ("groups",) if cfg.family == "hybrid" else STACKED[cfg.family]
    for key in keys:
        layers, players = tree[key], params[key]
        if cfg.family == "hybrid":  # a list of groups -> a tuple of slots
            tree[key] = tuple(
                tree_map(lambda p, *xs: put(xs, p), players[0][s],
                          *(grp[s] for grp in layers))
                for s in range(len(players[0]) if len(players) else 0))
        else:
            tree[key] = tree_map(lambda p, *xs: put(xs, p), players[0],
                                  *layers)
    return tree


def lm_tree_to_numpy(cfg, tree) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's per-layer
    ``tree`` for ``cfg`` (a ``ParamTree``, or nested dicts and lists of
    tensors shaped like it: gradients, AdamW's ``m`` / ``v``, Adafactor's
    ``vr``, error-feedback residuals) as numpy arrays in ``repro``'s
    layout, the per-layer lists stacked on a leading axis (rglru's
    ``groups`` a tuple of stacks, one a pattern slot). bfloat16 leaves
    come back as float32 arrays of the same values."""
    from repro_torch.models.common import plain

    tree = tree_map(_host, plain(tree))
    return _stacked(cfg, tree, tree)


def _vc_shared(p) -> bool:
    """Adafactor's column statistic of a stacked leaf whose layers are
    vectors or scalars runs over the layers: one for the whole stack."""
    return np.ndim(p) <= 2


def train_state_from_numpy(cfg, state, device):
    """``repro``'s ``TrainState`` (its leaves ``np.asarray`` arrays, or
    anything ``np.asarray`` takes) as the port's, on ``device``, with
    trainable parameters: the parameters, AdamW's ``m`` / ``v`` or
    Adafactor's ``vr`` / ``vc`` (the stack's one ``vc`` given to each of
    its layers where it has no layer axis), ``step`` and the
    error-feedback residual."""
    from repro_torch.train.compression import ErrorFeedback
    from repro_torch.train.optimizer import AdafactorState, AdamWState
    from repro_torch.train.train_step import TrainState, trainable

    dev = torch.device(device)
    rp = tree_map(np.asarray, state.params)

    def moved(tree, take=lambda a, p, i: a[i]):
        return tree_map(lambda a: _lm_tensor(a, dev),
                         _per_layer(cfg, tree_map(np.asarray, tree), rp, take))

    def step(x):
        return torch.as_tensor(np.array(x), device=dev).to(torch.int32)

    opt = state.opt
    if cfg.optimizer == "adafactor":
        shared = lambda a, p, i: a if _vc_shared(p) else a[i]
        new_opt = AdafactorState(vr=moved(opt.vr), vc=moved(opt.vc, shared),
                                 step=step(opt.step))
    else:
        new_opt = AdamWState(m=moved(opt.m), v=moved(opt.v), step=step(opt.step))
    ef = (None if state.ef is None
          else ErrorFeedback(residual=moved(state.ef.residual)))
    return TrainState(params=trainable(lm_params_from_numpy(cfg, rp, dev)),
                      opt=new_opt, step=step(state.step), ef=ef)


def train_state_to_numpy(cfg, state):
    """The port's ``TrainState`` as numpy arrays in ``repro``'s layout, in
    the port's ``TrainState`` / ``AdamWState`` / ``AdafactorState`` /
    ``ErrorFeedback`` (the field names of ``repro``'s). A stack's shared
    Adafactor ``vc`` is given once, as ``repro`` keeps it."""
    from repro_torch.train.compression import ErrorFeedback
    from repro_torch.train.optimizer import AdafactorState

    params = tree_map(_host, state.params)

    def back(tree, put=_stack):
        return _stacked(cfg, tree_map(_host, tree), params, put)

    opt = state.opt
    if isinstance(opt, AdafactorState):
        shared = lambda xs, p: xs[0] if np.ndim(p) <= 1 else np.stack(xs)
        new_opt = AdafactorState(vr=back(opt.vr), vc=back(opt.vc, shared),
                                 step=_host(opt.step))
    else:
        new_opt = type(opt)(m=back(opt.m), v=back(opt.v), step=_host(opt.step))
    ef = (None if state.ef is None
          else ErrorFeedback(residual=back(state.ef.residual)))
    return type(state)(params=back(state.params), opt=new_opt,
                       step=_host(state.step), ef=ef)
