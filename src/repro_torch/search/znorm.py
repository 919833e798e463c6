"""Z-normalization of subsequence windows via prefix sums (port of
``repro/search/znorm.py``: the offline forms, the streaming
``append_window_stats`` and the slab gather).

``window_stats`` returns the *raw* standard deviation (zero on a constant
window); every normalization site divides through ``clamp_sigma``.

Precision: ``repro`` differences prefix sums in the series' dtype. In
float32 the difference of two running sums keeps only about float32's
epsilon times the running sum, which grows along the series: at N = 1e6
windows of l = 1024 lose up to ~1.5e-4 relative in ``sigma``, and windows
of l = 128 (the UCR Suite's usual query) up to ~9e-3, and the distances
built on them follow. ``window_stats`` therefore sums,
differences and takes the variance in float64, as the UCR Suite does, and
returns the series' dtype: float32's rounding of the exact stats. The port
is compared with ``repro`` end to end at test sizes, where the two agree
to float32 rounding; on the card the kernels and their plain versions
share one stats tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import EPS, clamp_sigma, norm_window_slice

__all__ = [
    "EPS",
    "append_window_stats",
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
    timing; its floating-point result can change from run to run
    (``chip_smoke.py`` phase 3 shows it). On CUDA the sum therefore runs in
    two levels, each a
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
    """Mean and raw std of every window ``ref[s : s+length]``, worked out
    in float64 (module docstring).

    Returns ``(mu, sigma)``, each ``(N - length + 1,)``, in ``ref``'s dtype.
    """
    x = ref.to(torch.float64)
    p = _prefix(x)
    q = _prefix(x * x)
    s1 = p[length:] - p[: p.shape[0] - length]
    s2 = q[length:] - q[: q.shape[0] - length]
    mu = s1 / length
    var = torch.clamp_min(s2 / length - mu * mu, 0.0)
    return mu.to(ref.dtype), torch.sqrt(var).to(ref.dtype)


def append_window_stats(
    tail: torch.Tensor, chunk: torch.Tensor, length: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stats of the windows that become valid when ``chunk`` is appended.

    ``tail`` holds the last ``min(seen, length - 1)`` samples of the stream
    so far (empty at stream start). Returns ``(new_tail, mu_new,
    sigma_new)``: the stats cover window starts ``seen - len(tail)`` …
    ``seen + len(chunk) - length`` in stream coordinates (every window
    ending inside the new chunk, the ``length - 1`` windows straddling the
    tail/chunk boundary included), and ``new_tail`` is the context to carry
    into the next append. The cost is O(tail + chunk) however long the
    stream already is; the stats differ from the offline table's by
    float32 rounding. With fewer than
    ``length`` samples so far the stats are empty and ``new_tail`` is the
    whole stream.
    """
    ctx = torch.cat([tail, chunk.to(tail.dtype)])
    keep = min(ctx.shape[0], length - 1)
    new_tail = ctx[ctx.shape[0] - keep:]
    if ctx.shape[0] < length:
        empty = ctx.new_zeros((0,))
        return new_tail, empty, empty
    mu, sigma = window_stats(ctx, length)
    return new_tail, mu, sigma


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
