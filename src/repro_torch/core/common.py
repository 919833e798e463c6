"""Shared numerics for the DTW core (port of ``repro/core/common.py``).

"Pruned / not computed / border" cells hold the large finite sentinel
``BIG`` instead of ``+inf``: the closed-form row recurrence (``row_scan``)
takes ``d[k] - P[k]`` differences, and ``inf - inf = nan`` would poison
the scan.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1.0e30  # pruned-cell sentinel (finite stand-in for +inf)

# Per-lane ub sentinel for padding / LB-gated / finished-query lanes: any
# negative threshold kills the lane on row 0 (DTW costs are >= 0).
DEAD_LANE_UB = -1.0

# Sigma floor for z-normalization of flat (constant) windows.
EPS = 1e-8

# Band alignment of the default band: one warp's width. The CUDA DTW
# kernels hold the band in a warp's registers, padded to 32 * CPT columns
# (kernels/ops.py::cols_per_thread). Results do not depend on the band
# width while it is at least 2*window + 1.
BAND_ALIGN = 32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when no CUDA device is present
    rather than carrying on on the CPU. Pass ``device="cpu"`` to run on
    the CPU on purpose.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_float32(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array-like) as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def block_until_ready(tree):
    """Wait for the device work behind every CUDA tensor in ``tree``
    (tensors nested in tuples, lists and dicts); returns ``tree``.

    The port's ``jax.block_until_ready``: the host layer reads its clock
    after this, so an attempt's time includes the work it queued. One
    ``torch.cuda.synchronize`` per CUDA device found; nothing for CPU
    tensors or numpy arrays.
    """
    devices, stack = set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def clamp_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """The one sanctioned sigma clamp: flat windows normalize to zeros."""
    return torch.clamp_min(sigma, EPS)


def norm_window_slice(
    ref: torch.Tensor, starts: torch.Tensor, length: int, mu: torch.Tensor,
    sigma: torch.Tensor,
) -> torch.Tensor:
    """``(K, length)`` z-normalized windows ``ref[s : s + length]``.

    ``mu``/``sigma`` are the full per-window stats tables indexed by start;
    ``sigma`` is raw (clamped here). Same op order as ``repro``:
    ``(win - mu) / clamp_sigma(sigma)``.
    """
    starts = starts.long()
    idx = starts[:, None] + torch.arange(length, device=ref.device)[None, :]
    win = ref[idx]
    m = mu[starts][:, None]
    s = clamp_sigma(sigma[starts])[:, None]
    return (win - m) / s


def pad_lanes_to_blocks(block_k: int, lb, starts, candidates=None):
    """Pad the lane axis to a ``block_k`` multiple (``+inf`` bounds).

    Padding lanes get ``+inf`` lower bounds and zero starts/windows.
    ``lb``/``starts`` are ``(..., K)``; ``candidates`` optional
    ``(..., K, m)``.
    """
    k = lb.shape[-1]
    k_pad = -(-k // block_k) * block_k
    if k_pad == k:
        return lb, starts, candidates
    extra = k_pad - k
    lb = torch.cat(
        [lb, torch.full(lb.shape[:-1] + (extra,), float("inf"),
                        dtype=lb.dtype, device=lb.device)], dim=-1)
    starts = torch.cat(
        [starts, torch.zeros(starts.shape[:-1] + (extra,),
                             dtype=starts.dtype, device=starts.device)],
        dim=-1)
    if candidates is not None:
        pad = torch.zeros(candidates.shape[:-2] + (extra, candidates.shape[-1]),
                          dtype=candidates.dtype, device=candidates.device)
        candidates = torch.cat([candidates, pad], dim=-2)
    return lb, starts, candidates


def default_band_width(window: int, m: int) -> int:
    """Smallest warp-aligned band covering ``2*window + 1`` columns.

    ``repro`` aligns to the vector unit (128 lanes on a TPU, 8 elsewhere);
    the port aligns to ``BAND_ALIGN`` = 32 (one warp's width), never past
    ``m``. The CPU path uses the same default so both see the same band.
    """
    full = min(2 * int(window) + 1, int(m))
    return min(int(m), -(-full // BAND_ALIGN) * BAND_ALIGN)


def is_pruned(x: torch.Tensor) -> torch.Tensor:
    """Cells >= BIG/2 are considered pruned/infinite."""
    return x >= BIG / 2


def to_inf(x: torch.Tensor) -> torch.Tensor:
    """Map BIG sentinels back to +inf for user-facing results."""
    return torch.where(is_pruned(x), torch.full_like(x, float("inf")), x)


def cummin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative minimum along ``dim``."""
    return torch.cummin(x, dim=dim).values


def row_scan(d: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve the DTW row recurrence in closed form.

    ``curr[j] = min(d[j], c[j] + curr[j-1]) = P[j] + cummin_{k<=j}(d[k] - P[k])``
    with ``P`` the inclusive prefix sum of ``c`` (see ``repro``'s
    ``core/common.py::row_scan`` and DESIGN.md §2.1).
    """
    p = torch.cumsum(c, dim=-1)
    return p + cummin(d - p, dim=-1)
