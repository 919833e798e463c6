"""Lower-bound cascade over all candidate windows (port of
``repro/search/cascade.py``).

One pass computes ``max(LB_Kim_FL, LB_Keogh)`` for every window and every
query. On CUDA tensors it is one launch of kernel B
(``kernels.ops.lb_keogh_all_windows``) for all Q queries; on CPU tensors
the kernel's plain version runs, chunked so the materialized window tile
stays bounded.
"""
from __future__ import annotations

import torch

from repro_torch.core.lower_bounds import envelope
from repro_torch.kernels import ops


def cascade_lower_bounds(
    ref: torch.Tensor,
    query_n: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    length: int,
    window: int,
    use_kim: bool = True,
    use_keogh: bool = True,
    chunk: int = 4096,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Lower bound of every window start: ``(n_win,)`` for a ``(length,)``
    query, ``(Q, n_win)`` for ``(Q, length)`` queries.

    ``query_n`` is z-normalized already; ``sigma`` is raw. ``valid``
    optionally masks windows to ``+inf`` (the non-finite quarantine).
    """
    single = query_n.dim() == 1
    qn = query_n[None] if single else query_n
    u, low = envelope(qn, window)
    qends = torch.stack([qn[:, 0], qn[:, length - 1]], dim=1).contiguous()
    lbs = ops.lb_keogh_all_windows(
        ref, mu, sigma, u.contiguous(), low.contiguous(), qends, length,
        chunk=chunk, valid=valid, use_kim=use_kim, use_keogh=use_keogh,
    )
    return lbs[0] if single else lbs


def cascade(
    ref: torch.Tensor,
    query_n: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    length: int,
    window: int,
    use_kim: bool = True,
    use_keogh: bool = True,
    chunk: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-first ordering of window starts by lower bound.

    Returns ``(order, lb_sorted)``. The sort is stable, as ``jnp.argsort``
    is: windows whose bounds tie exactly (flat windows all normalize to
    zeros) keep start order.
    """
    lbs = cascade_lower_bounds(
        ref, query_n, mu, sigma, length, window, use_kim, use_keogh, chunk
    )
    lb_sorted, order = torch.sort(lbs, dim=-1, stable=True)
    return order, lb_sorted
