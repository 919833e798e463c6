"""The per-query incumbent store (port of ``repro/search/incumbents.py``).

Incumbent updates are *strict improvement only* (``d < ub``, never ``<=``):
the first achiever of a distance keeps its start. ``fold_min`` takes the
first lane at a round's minimum; ``torch.argmin`` returns the first index
among ties, as ``jnp.argmin`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.common import BIG, DEAD_LANE_UB  # noqa: F401  (re-export)


class IncumbentState(NamedTuple):
    """Carried per-query incumbents: ``(Q,)`` upper bounds + best starts."""
    ub: torch.Tensor    # (Q,) upper bound; == seed while unbeaten
    best: torch.Tensor  # (Q,) achieving window start; -1 while unbeaten


def initial_state(
    nq: int, dtype=torch.float32, ub_init=None, best_dtype=torch.int64,
    device=None,
) -> IncumbentState:
    """Fresh incumbents for Q queries; ``ub_init`` warm-seeds (scalar/(Q,))."""
    if ub_init is None:
        ub = torch.full((nq,), BIG, dtype=dtype, device=device)
    else:
        ub = torch.as_tensor(ub_init, dtype=dtype, device=device)
        ub = ub.expand(nq).clone()
    return IncumbentState(
        ub=ub, best=torch.full((nq,), -1, dtype=best_dtype, device=device)
    )


def fold_min(
    state: IncumbentState, starts: torch.Tensor, d: torch.Tensor, offset=0
) -> tuple[IncumbentState, torch.Tensor]:
    """Fold one ``(Q, K)`` round of distances into the incumbents.

    Dead/padding lanes carry ``+inf``. ``offset`` maps local starts into
    caller coordinates. Returns the new state and the per-query
    ``improved`` mask.
    """
    k = torch.argmin(d, dim=1)
    dmin = d.gather(1, k[:, None])[:, 0]
    improved = dmin < state.ub
    starts_k = starts.gather(1, k[:, None])[:, 0]
    return IncumbentState(
        ub=torch.where(improved, dmin, state.ub),
        best=torch.where(
            improved, offset + starts_k.to(state.best.dtype), state.best
        ),
    ), improved


def merge_states(a: IncumbentState, b: IncumbentState) -> IncumbentState:
    """Merge two incumbent snapshots under strict improvement: ``b`` wins
    only where its bound is strictly tighter, so merging a duplicate is a
    no-op and on a tie the first argument's achiever is kept."""
    take_b = b.ub < a.ub
    return IncumbentState(
        ub=torch.where(take_b, b.ub, a.ub),
        best=torch.where(take_b, b.best, a.best),
    )
