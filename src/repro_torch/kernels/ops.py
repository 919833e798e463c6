"""Wrappers of the port's two CUDA kernels.

Each wrapper checks its tensors, then dispatches on their device: CPU
tensors run the kernel's plain PyTorch version; CUDA tensors launch the
kernel or raise. There is no fallback from the kernel to the plain version.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, incremented only where it launches its kernel.

  * ``dtw_ea_multi_fused`` — kernel A, one fused EAPrunedDTW round
    (``csrc/dtw_ea_fused.cu``; TPU kernel
    ``repro/kernels/dtw_band.py::_dtw_ea_fused_kernel``).
  * ``lb_keogh_all_windows`` — kernel B, the LB cascade
    (``csrc/lb_keogh.cu``; TPU kernel
    ``repro/kernels/lb_keogh.py::_lb_kernel``).

Signatures follow ``repro/kernels/ops.py``. The Pallas tiling knobs
(``block_k``, ``row_block``, ``ref_budget``, ``chunk``) are accepted and
change no result: the CUDA round kernel runs one thread block per lane
with the row loop inside it, and keeps the reference in device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.common import default_band_width
from repro_torch.kernels import _build
from repro_torch.kernels.dtw_band import dtw_ea_fused_plain
from repro_torch.kernels.lb_keogh import lb_all_windows_plain

# One thread per band column in the round kernel.
MAX_BAND_THREADS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str, fn: str, argtypes) -> tuple:
    lib = _build.load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    err = getattr(lib, f"{fn.removesuffix('_launch')}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return f, err


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(code: int, err_fn, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({err_fn(code).decode()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def resolve_band(window: int, length: int, n_rows: int,
                 band_width: int | None) -> int:
    """The band the round kernel runs, resolved and checked as ``repro``
    does: full rows when ``n_rows != length``."""
    m = int(length)
    if band_width is None:
        band_width = default_band_width(window, m) if n_rows == m else m
    bw = int(min(band_width, m))
    full = min(2 * window + 1, m)
    if bw < full:
        raise ValueError(f"band_width {bw} < 2*window+1 = {full}")
    if bw < m and n_rows != m:
        raise ValueError("banded dtw_ea requires equal lengths (n == m)")
    return bw


def dtw_ea_multi_fused(
    queries: torch.Tensor,
    ref: torch.Tensor,
    starts: torch.Tensor,
    mu: torch.Tensor,
    sg: torch.Tensor,
    ub: torch.Tensor,
    window: int,
    length: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    band_width: int | None = None,
    block_k: int = 8,
    row_block: int = 128,
    ref_budget: int | None = None,
) -> torch.Tensor:
    """One fused EAPrunedDTW round: ``(Q, K)`` distances, ``+inf`` where a
    lane abandoned.

    Args:
      queries: ``(Q, n)`` float32 z-normalized queries (rows of the DP).
      ref: ``(N,)`` float32 raw (sanitized) reference shared by all lanes.
      starts: ``(Q, K)`` int32 window start per lane, in ``[0, N - length]``;
        a lane whose start lies outside that range returns NaN. The range is
        checked per lane on the device, not by the wrapper, so a round costs
        no host sync.
      mu, sg: ``(Q, K)`` float32 window mean and **clamped** sigma per lane.
      ub: ``(Q, K)`` float32 per-lane upper bounds; a negative entry is the
        dead-lane sentinel (the lane dies on row 0).
      window: Sakoe-Chiba window; length: window length ``m``.
      u, low: ``(Q, m)`` float32 query envelopes, required when ``use_cb``.
      band_width: columns per row; ``None`` = ``default_band_width``.
      block_k, row_block, ref_budget: Pallas tiling knobs; no effect.
    """
    del block_k, row_block, ref_budget
    for name, t in (("queries", queries), ("ref", ref), ("starts", starts)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    dev = ref.device
    if queries.dim() != 2 or starts.dim() != 2:
        raise ValueError("queries must be (Q, n) and starts (Q, K)")
    nq, n = queries.shape
    k = starts.shape[1]
    m = int(length)
    window = int(min(window, m))
    bw = resolve_band(window, m, n, band_width)
    if use_cb and (u is None or low is None):
        raise ValueError("use_cb requires the query envelopes (u, low)")
    _check(queries, "queries", torch.float32, (nq, n), dev)
    _check(ref, "ref", torch.float32, (ref.shape[0],), dev)
    _check(starts, "starts", torch.int32, (nq, k), dev)
    for name, t in (("mu", mu), ("sg", sg), ("ub", ub)):
        _check(t, name, torch.float32, (nq, k), dev)
    if use_cb:
        _check(u, "u", torch.float32, (nq, m), dev)
        _check(low, "low", torch.float32, (nq, m), dev)
    if ref.shape[0] < m:
        raise ValueError(f"ref length {ref.shape[0]} < length {m}")

    if dev.type == "cpu":
        return dtw_ea_fused_plain(
            queries, ref, starts, mu, sg, ub, window, m, bw,
            u=u, low=low, use_cb=use_cb,
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if bw > MAX_BAND_THREADS:
        raise ValueError(
            f"band_width {bw} > {MAX_BAND_THREADS}: the round kernel runs one "
            "thread per band column in one block"
        )
    out = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq * k == 0:
        return out
    launch, err = _lib("dtw_ea_fused", "dtw_ea_fused_launch",
                       [_P] * 9 + [_I] * 8 + [_P])
    code = launch(
        queries.data_ptr(), ref.data_ptr(), starts.data_ptr(), mu.data_ptr(),
        sg.data_ptr(), ub.data_ptr(),
        u.data_ptr() if use_cb else None, low.data_ptr() if use_cb else None,
        out.data_ptr(), ref.shape[0], nq, k, n, m, window, bw, int(use_cb),
        _stream(dev),
    )
    _raise_on(code, err, "dtw_ea_fused")
    dtw_ea_multi_fused.launches += 1
    return out


dtw_ea_multi_fused.launches = 0


def lb_keogh_all_windows(
    ref: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    upper: torch.Tensor,
    lower: torch.Tensor,
    qends: torch.Tensor,
    length: int,
    chunk: int = 512,
    valid: torch.Tensor | None = None,
    use_kim: bool = True,
    use_keogh: bool = True,
) -> torch.Tensor:
    """LB_Kim + LB_Keogh for every z-normalized window of ``ref``.

    Args:
      ref: ``(N,)`` float32 reference series.
      mu, sigma: ``(n_win,)`` float32 window stats; ``sigma`` raw (the
        kernel clamps it).
      upper, lower: envelope ``(length,)`` of one query, or ``(Q, length)``
        for Q queries in one launch.
      qends: ``(2,)`` or ``(Q, 2)`` first/last values of the z-normalized
        queries (LB_Kim).
      chunk: windows per step of the plain version; no effect on results.
      valid: optional ``(n_win,)`` bool mask; ``+inf`` where False (the
        non-finite quarantine).
      use_kim, use_keogh: which bounds to take the max of.

    Returns ``(n_win,)`` for one query, ``(Q, n_win)`` for Q.
    """
    dev = ref.device
    single = upper.dim() == 1
    if single:
        upper, lower, qends = upper[None], lower[None], qends[None]
    nq = upper.shape[0]
    n_win = ref.shape[0] - length + 1
    if n_win < 1:
        raise ValueError(f"ref length {ref.shape[0]} < length {length}")
    _check(ref, "ref", torch.float32, (ref.shape[0],), dev)
    _check(mu, "mu", torch.float32, (n_win,), dev)
    _check(sigma, "sigma", torch.float32, (n_win,), dev)
    _check(upper, "upper", torch.float32, (nq, length), dev)
    _check(lower, "lower", torch.float32, (nq, length), dev)
    _check(qends, "qends", torch.float32, (nq, 2), dev)
    if valid is not None:
        _check(valid, "valid", torch.bool, (n_win,), dev)

    if dev.type == "cpu":
        out = lb_all_windows_plain(
            ref, mu, sigma, upper, lower, qends, length, valid=valid,
            use_kim=use_kim, use_keogh=use_keogh, chunk=max(int(chunk), 1),
        )
    elif dev.type == "cuda":
        out = torch.empty((nq, n_win), dtype=torch.float32, device=dev)
        launch, err = _lib("lb_keogh", "lb_cascade_launch",
                           [_P] * 8 + [_I] * 5 + [_P])
        code = launch(
            ref.data_ptr(), mu.data_ptr(), sigma.data_ptr(), upper.data_ptr(),
            lower.data_ptr(), qends.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            nq, n_win, int(length), int(use_kim), int(use_keogh), _stream(dev),
        )
        _raise_on(code, err, "lb_cascade")
        lb_keogh_all_windows.launches += 1
    else:
        raise ValueError(f"no kernel for device {dev}")
    return out[0] if single else out


lb_keogh_all_windows.launches = 0
