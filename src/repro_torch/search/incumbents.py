"""The per-query incumbent store and the quarantine ledger (port of
``repro/search/incumbents.py``).

Incumbent updates are *strict improvement only* (``d < ub``, never ``<=``):
the first achiever of a distance keeps its start. ``fold_min`` takes the
first lane at a round's minimum; ``torch.argmin`` returns the first index
among ties, as ``jnp.argmin`` does. ``fold_np`` is the same rule on the
host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def fold_np(ub: np.ndarray, best: np.ndarray, starts, dists):
    """Host-side fold of achieved ``(start, dist)`` pairs.

    Same strict-improvement rule as ``fold_min``; additionally requires a
    real achieving start (``>= 0``): a bare bound with no achieving window
    is never folded.
    """
    s = np.asarray(starts, np.int64)
    d = np.asarray(dists, np.float64)
    improved = np.logical_and(s >= 0, d < ub)
    return np.where(improved, d, ub), np.where(improved, s, best)


def merge_states(a: IncumbentState, b: IncumbentState) -> IncumbentState:
    """Merge two incumbent snapshots under strict improvement: ``b`` wins
    only where its bound is strictly tighter, so merging a duplicate is a
    no-op and on a tie the first argument's achiever is kept."""
    take_b = b.ub < a.ub
    return IncumbentState(
        ub=torch.where(take_b, b.ub, a.ub),
        best=torch.where(take_b, b.best, a.best),
    )


class QuarantineLedger:
    """One source of truth for the quarantine accounting (DESIGN.md §2.6).

    ``windows`` / ``samples`` add up lazily as int64 tensors on the device
    that counted them, so an ingest never syncs just to keep a counter;
    ``readmitted`` is a host int (the re-admission queue lives on the
    host). ``repro`` keeps the two counts in int32. The ``state_dict`` keys
    are ``repro``'s (``quarantined``, ``bad_samples``, ``readmitted``), and
    a snapshot without ``readmitted`` (older than re-admission) restores
    with 0.
    """

    def __init__(self, device=None):
        self.device = device
        self.windows = torch.zeros((), dtype=torch.int64, device=device)
        self.samples = torch.zeros((), dtype=torch.int64, device=device)
        self.readmitted = 0

    def _count(self, n) -> torch.Tensor:
        return torch.as_tensor(n, device=self.device).to(torch.int64)

    def note_windows(self, n) -> None:
        """Count newly quarantined windows (a device scalar is fine)."""
        self.windows = self.windows + self._count(n)

    def note_samples(self, n) -> None:
        """Count newly seen non-finite raw samples (a device scalar is
        fine)."""
        self.samples = self.samples + self._count(n)

    def correct_samples(self, k: int) -> None:
        """``k`` bad samples were patched with finite values."""
        self.samples = self.samples - int(k)

    def readmit(self, n: int) -> None:
        """``n`` previously quarantined windows were rescored back in."""
        n = int(n)
        self.windows = self.windows - n
        self.readmitted += n

    def state_dict(self) -> dict:
        return {
            "quarantined": np.asarray(int(self.windows), np.int64),
            "bad_samples": np.asarray(int(self.samples), np.int64),
            "readmitted": np.asarray(self.readmitted, np.int64),
        }

    def load_state_dict(self, state: dict) -> None:
        self.windows = self._count(int(np.asarray(state["quarantined"])))
        self.samples = self._count(int(np.asarray(state["bad_samples"])))
        # Older checkpoints predate re-admission.
        self.readmitted = int(state.get("readmitted", 0))
