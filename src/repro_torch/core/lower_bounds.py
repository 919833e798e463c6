"""DTW lower bounds (LB_Kim, LB_Keogh), port of ``repro/core/lower_bounds.py``.

All bounds are valid for the squared-Euclidean cost used throughout:
``lb(Q, C) <= DTW(Q, C)`` for any warping window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def envelope(q: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keogh envelope: ``U[i] = max(q[i-w : i+w+1])``, ``L[i] = min(...)``.

    A sliding max/min (``max_pool1d`` over the series padded with
    ``-inf``/``+inf``); min and max are exact, so this equals ``repro``'s
    sparse-table form bit for bit. Batched over leading dims.
    """
    w = int(window)
    batch = q.shape[:-1]
    x = q.reshape(-1, 1, q.shape[-1])
    k = 2 * w + 1
    hi = F.max_pool1d(F.pad(x, (w, w), value=float("-inf")), k, stride=1)
    lo = -F.max_pool1d(F.pad(-x, (w, w), value=float("-inf")), k, stride=1)
    return hi.reshape(batch + (-1,)), lo.reshape(batch + (-1,))


def _lb_keogh_terms(
    c: torch.Tensor, u: torch.Tensor, low: torch.Tensor
) -> torch.Tensor:
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    over = torch.where(c > u, c - u, zero)
    under = torch.where(c < low, low - c, zero)
    return over * over + under * under


def lb_keogh(c: torch.Tensor, u: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """LB_Keogh of candidate(s) ``c`` (``(m,)`` or ``(B, m)``) against an
    envelope ``(u, low)``; the envelope broadcasts."""
    return torch.sum(_lb_keogh_terms(c, u, low), dim=-1)


def lb_kim_fl(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Simplified LB_Kim on z-normalized series (UCR suite form): first +
    last aligned point costs. Batched over leading dims of ``c``."""
    d0 = (c[..., 0] - q[..., 0]) ** 2
    d1 = (c[..., -1] - q[..., -1]) ** 2
    return d0 + d1


def cascade_keogh_cumulative(
    c: torch.Tensor, u: torch.Tensor, low: torch.Tensor
) -> torch.Tensor:
    """UCR ``cb`` array: ``cb[j] = sum_{i >= j} clamp_cost(i)`` (sequential
    reverse cumsum, as ``repro``'s jnp form)."""
    terms = _lb_keogh_terms(c, u, low)
    return torch.flip(torch.cumsum(torch.flip(terms, (-1,)), dim=-1), (-1,))
