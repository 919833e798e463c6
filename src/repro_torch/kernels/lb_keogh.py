"""Kernel B: the LB cascade, max(LB_Kim_FL, LB_Keogh) of every window.

The CUDA kernel is ``csrc/lb_keogh.cu`` (it replaces
``repro/kernels/lb_keogh.py::_lb_kernel`` and, on the search path, the
plain-jnp ``repro/search/cascade.py::cascade_lower_bounds``; its source
says what bounds it on the card). This module holds its plain PyTorch
version, which the wrapper ``kernels.ops.lb_keogh_all_windows`` runs for
CPU tensors and ``chip_smoke.py`` holds the kernel against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import clamp_sigma
from repro_torch.core.lower_bounds import lb_keogh


def lb_all_windows_plain(
    ref: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    upper: torch.Tensor,
    lower: torch.Tensor,
    qends: torch.Tensor,
    length: int,
    valid: torch.Tensor | None = None,
    use_kim: bool = True,
    use_keogh: bool = True,
    chunk: int = 4096,
) -> torch.Tensor:
    """``(Q, n_win)`` lower bounds of every window against Q envelopes.

    Works on chunks of the ``ref.unfold(0, length, 1)`` view (no copy of
    the O(N·l) window matrix beyond one ``(chunk, length)`` tile), with the
    main path's op order: ``lb = max(0, kim)``, then ``max(lb, keogh)``.
    ``sigma`` is raw (clamped here); ``valid`` masks quarantined windows to
    ``+inf``.
    """
    n_win = ref.shape[0] - length + 1
    nq = upper.shape[0]
    out = torch.empty(nq, n_win, dtype=ref.dtype, device=ref.device)
    wins = ref.unfold(0, length, 1)
    sg = clamp_sigma(sigma)
    for c0 in range(0, n_win, chunk):
        c1 = min(n_win, c0 + chunk)
        v = (wins[c0:c1] - mu[c0:c1, None]) / sg[c0:c1, None]
        for q in range(nq):
            lb = torch.zeros(c1 - c0, dtype=ref.dtype, device=ref.device)
            if use_kim:
                kim = (v[:, 0] - qends[q, 0]) ** 2 + (v[:, -1] - qends[q, 1]) ** 2
                lb = torch.maximum(lb, kim)
            if use_keogh:
                lb = torch.maximum(lb, lb_keogh(v, upper[q], lower[q]))
            out[q, c0:c1] = lb
    if valid is not None:
        out = torch.where(valid[None, :], out,
                          torch.full_like(out, float("inf")))
    return out
