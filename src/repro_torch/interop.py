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
