"""Batched EAPrunedDTW rounds (port of ``repro/core/batch.py``, fused form).

The unit of search work is a round of ``Q × K`` lanes evaluated in one
dispatch; each lane early-abandons against its own upper bound (DESIGN.md
§2.4). This slice ports the fused-gather primitive the main path runs:
the raw reference plus per-lane ``(start, mu, sigma)`` descriptors, with
slicing and z-normalization inside the round (DESIGN.md §2.10).

Dispatch is by the device of the tensors: ``kernels.ops.dtw_ea_multi_fused``
launches the CUDA round kernel for CUDA tensors and runs its plain version
for CPU tensors. ``repro``'s ``backend`` knob has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.common import clamp_sigma
from repro_torch.kernels import ops


def ea_pruned_dtw_multi_batch_fused(
    queries: torch.Tensor,
    ref: torch.Tensor,
    starts: torch.Tensor,
    ub,
    window: int,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    envelopes: tuple[torch.Tensor, torch.Tensor] | None = None,
    band_width: int | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
    ref_budget: int | None = None,
) -> torch.Tensor:
    """Fused-gather multi-query round: ``(Q, K)`` distances (``+inf`` where
    a lane abandoned).

    Args:
      queries: ``(Q, m)`` z-normalized queries.
      ref: ``(N,)`` raw (sanitized) reference series.
      starts: ``(Q, K)`` window start per lane; a lane whose start lies
        outside ``[0, N - m]`` returns NaN (checked on the device, without
        a host sync).
      ub: per-lane upper bounds, broadcast to ``(Q, K)``; negative entries
        are dead-lane sentinels.
      window: Sakoe-Chiba window.
      mu, sigma: full ``(N_win,)`` window stats tables, indexed by
        ``starts`` here; ``sigma`` is raw and clamped at this boundary.
      envelopes: optional ``(u, low)`` pair of ``(Q, m)`` query envelopes;
        enables UCR ``cb`` tightening.
      band_width: columns per row (``None`` = ``default_band_width``).
      rows_per_step, block_k, row_block, ref_budget: ``repro``'s tuning
        knobs; accepted, no effect on results.
      with_info: the ``EAInfo`` stats rounds are not ported yet (ROADMAP.md
        Queue 1 item 6); ``True`` raises ``NotImplementedError``.
    """
    del rows_per_step
    if with_info:
        raise NotImplementedError(
            "with_info stats rounds are not ported yet (ROADMAP.md Queue 1 "
            "item 6, 'Slab arms, counters, baselines')"
        )
    if queries.dim() != 2:
        raise guards.SearchInputError(
            "fused multi batch requires (Q, m) univariate queries"
        )
    length = int(queries.shape[1])
    # Clamped for the table gather only: the round flags the lane itself.
    idx = starts.long().clamp(0, mu.shape[0] - 1)
    mu_l = mu[idx].to(torch.float32).contiguous()
    sg_l = clamp_sigma(sigma[idx]).to(torch.float32).contiguous()
    ub_l = torch.as_tensor(ub, dtype=torch.float32, device=ref.device)
    ub_l = ub_l.expand(starts.shape).contiguous()
    u = low = None
    if envelopes is not None:
        u, low = (e.to(torch.float32).contiguous() for e in envelopes)
    return ops.dtw_ea_multi_fused(
        queries.to(torch.float32).contiguous(), ref.to(torch.float32).contiguous(),
        starts.to(torch.int32).contiguous(), mu_l, sg_l, ub_l, window, length,
        u=u, low=low, use_cb=envelopes is not None, band_width=band_width,
        block_k=block_k, row_block=row_block, ref_budget=ref_budget,
    )
