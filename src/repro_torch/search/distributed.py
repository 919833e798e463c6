"""Distributed subsequence search: shard candidates, share the upper bound
(port of ``repro/search/distributed.py``).

The multi-device mapping of the paper's technique (DESIGN.md §2.4), on
``torch.distributed``, one rank a device:

  * candidate window starts are sharded contiguously across the ranks,
  * every rank is given the whole reference (replicated, not broadcast),
  * every rank runs its own LB cascade (kernel B on its range) and
    best-first rounds of EAPrunedDTW (kernel A, or D with a slab),
  * after every round the incumbent ``ub`` is shared with an
    ``all_reduce(MIN)``, the distributed analogue of the UCR suite's
    upper-bound tightening,
  * ranks iterate in lockstep until the ``all_reduce(MAX)`` continue flag
    clears.

This module is the scalar (single-query) frontend of the sharded program
owned by ``search.pipeline.make_sharded_search``, shared with
``multi.make_distributed_multi_search`` and ``ShardedExecutor``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.search.pipeline import make_plan, make_sharded_search


class DistSearchResult(NamedTuple):
    best_start: torch.Tensor
    best_dist: torch.Tensor
    rounds: torch.Tensor
    quarantined: torch.Tensor  # windows excluded by the non-finite quarantine


def make_distributed_search(
    mesh,
    axis_names: tuple[str, ...] | None,
    length: int,
    window: int,
    batch: int = 64,
    band_width: int | None = None,
    chunk: int = 2048,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    quarantine: bool = True,
    device=None,
):
    """Build a distributed search fn for a mesh config.

    Arguments as ``repro``'s (without ``backend``: the port dispatches by
    device), with ``mesh`` a process group (``None``: the default group)
    or a ``DeviceMesh`` whose ``axis_names`` dimensions shard the windows,
    and ``device`` the rank's device (the card by default). Every rank
    calls ``search_fn(ref, query) -> DistSearchResult`` with the same
    arguments and gets the same result: the Q = 1 case of
    ``pipeline.make_sharded_search``. ``quarantined`` sums the shards'
    counts of windows with a non-finite sample, so it equals the
    single-device ``subsequence_search(...).quarantined``.
    """
    plan = make_plan(
        length=length, window=window, variant="eapruned", batch=batch,
        band_width=band_width, chunk=chunk, rows_per_step=rows_per_step,
        block_k=block_k, row_block=row_block, quarantine=quarantine,
    )
    sharded = make_sharded_search(mesh, axis_names, plan, device=device)

    def search_fn(ref, query) -> DistSearchResult:
        query = torch.as_tensor(query)
        best_d, best_s, rounds, n_quar = sharded(ref, query[None])
        return DistSearchResult(
            best_start=best_s[0], best_dist=best_d[0], rounds=rounds,
            quarantined=n_quar,
        )

    return search_fn
