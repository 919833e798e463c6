"""Typed input guards for the search surface (port of ``repro/core/guards.py``).

Same exception taxonomy as ``repro``:

``SearchInputError``    — malformed arguments (shape/dtype/ndim/knobs);
                          subclasses ``ValueError``.
``NonFiniteInputError`` — a query-side array holds NaN/Inf. Reference-side
                          non-finites are quarantined, not rejected.
``StreamStateError``    — a streaming call is inconsistent with carried
                          state (chunk bigger than the fixed ingest shape,
                          tail overflow, a mismatched checkpoint); carries
                          ``n_seen`` / ``chunk_index``; subclasses
                          ``RuntimeError``.

PyTorch runs eagerly, so every check runs on concrete values (``repro``'s
tracer-skipping has no counterpart here). ``repro``'s ``checked_call``
(checkify) has none either; the streaming engine's ``debug_checks`` opt-in
(or ``$REPRO_DEBUG_CHECKS``, :func:`debug_checks_enabled`) checks after every
ingest that no NaN reached the carried incumbents.
"""
from __future__ import annotations

import os

import numpy as np
import torch

DEBUG_ENV_VAR = "REPRO_DEBUG_CHECKS"


class SearchInputError(ValueError):
    """Malformed search input: shape, dtype, ndim, or knob out of contract."""


class NonFiniteInputError(SearchInputError):
    """A query-side array contains NaN/Inf (reference non-finites are
    quarantined, not rejected)."""


class StreamStateError(RuntimeError):
    """A streaming call is inconsistent with the engine's carried state."""

    def __init__(self, message: str, n_seen=None, chunk_index=None):
        ctx = []
        if n_seen is not None:
            ctx.append(f"n_seen={int(n_seen)}")
        if chunk_index is not None:
            ctx.append(f"chunk_index={int(chunk_index)}")
        if ctx:
            message = f"{message} [{', '.join(ctx)}]"
        super().__init__(message)
        self.n_seen = None if n_seen is None else int(n_seen)
        self.chunk_index = None if chunk_index is None else int(chunk_index)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _is_floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.inexact)


def ensure_series(x, name: str, ndim: int = 1, min_len: int | None = None):
    """Static checks on one array argument: ndim, floating dtype, length."""
    shape = _shape(x)
    if len(shape) != ndim:
        raise SearchInputError(f"{name} must be {ndim}-D, got shape {shape}")
    if not _is_floating(x):
        dt = x.dtype if hasattr(x, "dtype") else type(x)
        raise SearchInputError(f"{name} must have a floating dtype, got {dt}")
    if min_len is not None and shape[-1] < min_len:
        raise SearchInputError(
            f"{name} last-axis length {shape[-1]} < required {min_len} "
            f"(shape {shape})"
        )
    return x


def ensure_finite(x, name: str):
    """Value check: reject NaN/Inf."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    ok = torch.isfinite(t)
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise NonFiniteInputError(
            f"{name} contains {bad} non-finite value(s); queries must be "
            "finite (reference-side non-finites are quarantined instead)"
        )
    return x


def ensure_knobs(
    length: int | None = None,
    window: int | None = None,
    batch: int | None = None,
    band_width: int | None = None,
    block_k: int | None = None,
    row_block: int | None = None,
    rows_per_step: int | None = None,
):
    """Knob sanity shared by every driver; raises ``SearchInputError``."""
    if length is not None and int(length) < 2:
        raise SearchInputError(f"length must be >= 2, got {length}")
    if window is not None and int(window) < 0:
        raise SearchInputError(f"window must be >= 0, got {window}")
    if length is not None and window is not None and int(window) >= int(length):
        raise SearchInputError(
            f"window {window} must be < length {length} (a Sakoe-Chiba band "
            "wider than the series is the full DP — pass length - 1 at most)"
        )
    for knob, val in (
        ("batch", batch), ("band_width", band_width), ("block_k", block_k),
        ("row_block", row_block), ("rows_per_step", rows_per_step),
    ):
        if val is not None and int(val) < 1:
            raise SearchInputError(f"{knob} must be >= 1, got {val}")


def debug_checks_enabled(flag: bool | None = None) -> bool:
    """Resolve the debug-checks opt-in: explicit flag, else env var."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(DEBUG_ENV_VAR, "").strip().lower() in (
        "1", "true", "yes", "on"
    )
