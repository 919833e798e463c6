"""Z-normalization of subsequence windows via prefix sums (port of
``repro/search/znorm.py``, offline forms and the slab gather).

``window_stats`` returns the *raw* standard deviation (zero on a constant
window); every normalization site divides through ``clamp_sigma``.

Precision: like ``repro``, the stats difference float32 prefix sums. At
N = 1e6 that loses about 1e-4 relative in ``mu``/``sigma`` on either
framework, and a GPU cumsum rounds in another order than XLA's CPU one. The
port keeps the same float32 algorithm (it does not move to float64), so it
is compared with ``repro`` end to end only at test sizes; on the card the
kernels and their plain versions share one stats tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import EPS, clamp_sigma, norm_window_slice

__all__ = [
    "EPS",
    "clamp_sigma",
    "gather_norm_windows",
    "norm_window_slice",
    "sanitize_series",
    "window_finite_mask",
    "window_stats",
    "znorm",
]


# Samples per row of the two-level prefix sum on CUDA.
_SCAN_ROW = 1024


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, the same bits on every run.

    PyTorch runs a 1-D CUDA ``cumsum`` as one single-pass device scan, in
    which a tile adds the sums of the tiles before it in an order set by
    timing; its float32 result can change from run to run (``chip_smoke.py``
    phase 3 shows it). On CUDA the sum therefore runs in two levels, each a
    scan that PyTorch performs in a fixed order: along rows of ``_SCAN_ROW``
    samples, then down the column of row totals. On the CPU ``cumsum`` is
    sequential and deterministic, and runs as it is.
    """
    if x.device.type != "cuda" or x.numel() <= _SCAN_ROW:
        return torch.cumsum(x, dim=0)
    return _cumsum_two_level(x)


def _cumsum_two_level(x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    rows = torch.nn.functional.pad(x, (0, -n % _SCAN_ROW)).view(-1, _SCAN_ROW)
    within = torch.cumsum(rows, dim=1)
    # Two equal columns keep this a scan down a column (a lone column would
    # be run as the 1-D scan again).
    totals = within[:, -1:].expand(-1, 2).contiguous()
    upto = torch.cumsum(totals, dim=0)[:-1, 0]
    before = torch.cat([upto.new_zeros(1), upto])
    return (within + before[:, None]).view(-1)[:n]


def _prefix(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      _cumsum(x)])


def window_stats(ref: torch.Tensor, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and raw std of every window ``ref[s : s+length]``.

    Returns ``(mu, sigma)``, each ``(N - length + 1,)``.
    """
    p = _prefix(ref)
    q = _prefix(ref * ref)
    s1 = p[length:] - p[: p.shape[0] - length]
    s2 = q[length:] - q[: q.shape[0] - length]
    mu = s1 / length
    var = torch.clamp_min(s2 / length - mu * mu, 0.0)
    return mu, torch.sqrt(var)


def window_finite_mask(ref: torch.Tensor, length: int) -> torch.Tensor:
    """``(N - length + 1,)`` bool: True where the window is NaN/Inf-free."""
    bad = (~torch.isfinite(ref)).to(torch.int64)
    p = _prefix(bad)
    return (p[length:] - p[: p.shape[0] - length]) == 0


def sanitize_series(ref: torch.Tensor) -> torch.Tensor:
    """Zero-fill non-finite samples so the shared prefix sums stay finite."""
    return torch.where(torch.isfinite(ref), ref, torch.zeros_like(ref))


def znorm(x: torch.Tensor) -> torch.Tensor:
    """Z-normalize along the last axis (whole series, for queries).

    ``repro`` uses ``jnp.std``, the population std; ``torch.std`` defaults
    to ``correction=1``, so ``correction=0`` is passed here.
    """
    mu = torch.mean(x, dim=-1, keepdim=True)
    sd = torch.std(x, dim=-1, keepdim=True, correction=0)
    return (x - mu) / clamp_sigma(sd)


def gather_norm_windows(
    ref: torch.Tensor,
    starts: torch.Tensor,
    length: int,
    mu: torch.Tensor,
    sigma: torch.Tensor,
) -> torch.Tensor:
    """Materialize z-normalized windows ``(..., length)`` for ``starts`` of
    any shape: the O(K·l) **slab** of the ``gather="slab"`` arms.

    ``mu``/``sigma`` are the full per-window stats tables indexed by start
    (``sigma`` raw, clamped here). The values are
    ``(x - mu) / clamp_sigma(sigma)``, the operations kernel A runs on each
    window, so a slab lane has kernel A's bits. The windows are indexed out
    of ``ref.unfold(0, length, 1)``, a view, rather than through an int64
    ``(..., length)`` index tensor (6.5 GB at N = 1e5, Q = 8, l = 1024);
    the normalization then runs in place on the gathered slab, so the slab
    is the only O(K·l) allocation.
    """
    starts = starts.long()
    win = ref.unfold(0, int(length), 1)[starts]
    win.sub_(mu[starts][..., None])
    return win.div_(clamp_sigma(sigma[starts])[..., None])
