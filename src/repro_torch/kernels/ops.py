"""Wrappers of the port's CUDA kernels.

Each wrapper checks its tensors, then dispatches on their device: CPU
tensors run the kernel's plain PyTorch version; CUDA tensors launch the
kernel or raise. There is no fallback from the kernel to the plain version.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, incremented only where it launches its kernel. The
two persistent wrappers also keep ``<wrapper>.lanes_run``: after a launch
on the card, a ``(Q,)`` int32 tensor of the lanes of each query that passed
the gate and ran (``None`` before the first).

  * ``dtw_ea_multi_fused`` — kernel A, one fused EAPrunedDTW round
    (``csrc/dtw_ea_fused.cu``; TPU kernel
    ``repro/kernels/dtw_band.py::_dtw_ea_fused_kernel``).
  * ``lb_keogh_all_windows`` — kernel B, the LB cascade
    (``csrc/lb_keogh.cu``; TPU kernel
    ``repro/kernels/lb_keogh.py::_lb_kernel``).
  * ``dtw_ea_persistent_fused`` — kernel C, the persistent best-first sweep
    over the reference (``csrc/dtw_ea_persistent.cu``; TPU kernel
    ``_dtw_ea_persistent_kernel(fused=True)``).
  * ``dtw_ea_multi`` and ``dtw_ea`` (Q = 1) — kernel D, one round over a
    pre-gathered window slab (``csrc/dtw_ea_slab.cu``; TPU kernel
    ``repro/kernels/dtw_band.py::_dtw_ea_kernel``).
  * ``dtw_ea_persistent`` — kernel E, the persistent sweep over a window
    slab (``csrc/dtw_ea_persistent.cu``; TPU kernel
    ``_dtw_ea_persistent_kernel(fused=False)``).

Signatures follow ``repro/kernels/ops.py``. The Pallas tiling knobs
(``row_block``, ``ref_budget``, ``chunk``, and ``block_k`` of the round
kernels) are accepted and change no result: the DTW kernels run one warp
per lane with the band in its registers (``cols_per_thread`` columns a
thread) and the row loop inside the warp, and keep the reference in device
memory. In the persistent sweeps ``block_k`` sets the granularity of the
``blocks`` work metric.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import guards
from repro_torch.core.common import default_band_width
from repro_torch.kernels import _build
from repro_torch.kernels.dtw_band import (
    dtw_ea_fused_plain,
    dtw_ea_persistent_fused_plain,
    dtw_ea_persistent_plain,
    dtw_ea_plain,
)
from repro_torch.kernels.lb_keogh import lb_all_windows_plain

# The widest band the DTW kernels hold: one warp, at most 32 columns in
# each of its 32 threads' registers.
MAX_BAND_WIDTH = 1024

_COUNTERS = ("with_info counters are not ported yet (ROADMAP.md Queue 1 "
             "item 6, 'Slab arms, counters, baselines')")

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


def cols_per_thread(bw: int) -> int:
    """Band columns each of a warp's 32 threads holds for a band of ``bw``
    columns: the smallest of 1, 2, 4, 8, 16 and 32 that covers it (8 at the
    main path's ``bw = 224``). The DTW kernels are instantiated for these."""
    bw = int(bw)
    if bw > MAX_BAND_WIDTH:
        raise ValueError(
            f"band_width {bw} > {MAX_BAND_WIDTH}: the DTW kernels hold the "
            "band in one warp's registers, at most 32 columns a thread"
        )
    cpt = 1
    while 32 * cpt < bw:
        cpt *= 2
    return cpt


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
    cpt = cols_per_thread(bw)
    out = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq * k == 0:
        return out
    launch, err = _lib("dtw_ea_fused", "dtw_ea_fused_launch",
                       [_P] * 9 + [_I] * 9 + [_P])
    code = launch(
        queries.data_ptr(), ref.data_ptr(), starts.data_ptr(), mu.data_ptr(),
        sg.data_ptr(), ub.data_ptr(),
        u.data_ptr() if use_cb else None, low.data_ptr() if use_cb else None,
        out.data_ptr(), ref.shape[0], nq, k, n, m, window, bw, int(use_cb),
        cpt, _stream(dev),
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


def _as_lanes(ub, nq: int, k: int, dev) -> torch.Tensor:
    """Per-lane bounds: a scalar, ``(Q, 1)`` or ``(Q, K)`` as ``(Q, K)``."""
    ub = torch.as_tensor(ub, dtype=torch.float32, device=dev)
    return ub.expand(nq, k).contiguous()


def dtw_ea_multi(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    window: int,
    cb: torch.Tensor | None = None,
    band_width: int | None = None,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
) -> torch.Tensor:
    """One slab round of EAPrunedDTW: ``(Q, K)`` distances, ``+inf`` where
    a lane abandoned.

    Args:
      queries: ``(Q, n)`` float32 z-normalized queries (rows of the DP).
      candidates: ``(Q, K, m)`` float32 normalized windows.
      ub: per-lane upper bounds, a scalar, ``(Q, 1)`` or ``(Q, K)``; a
        negative entry is the dead-lane sentinel (the lane runs no row).
      window: Sakoe-Chiba window.
      cb: optional ``(Q, K, m)`` float32 cumulative LB_Keogh suffixes (UCR
        tightening); ``None`` turns it off.
      band_width: columns per row; ``None`` = ``default_band_width``, or the
        full row when ``n != m``.
      block_k, row_block: Pallas tiling knobs; no effect.
      with_info: the ``EAInfo`` counters are not ported yet (ROADMAP.md
        Queue 1 item 6); ``True`` raises ``NotImplementedError``.
    """
    del block_k, row_block
    if with_info:
        raise NotImplementedError(_COUNTERS)
    for name, t in (("queries", queries), ("candidates", candidates)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if queries.dim() != 2 or candidates.dim() != 3:
        raise ValueError("queries must be (Q, n) and candidates (Q, K, m)")
    dev = candidates.device
    nq, n = queries.shape
    k, m = candidates.shape[1], candidates.shape[2]
    window = int(min(window, m))
    bw = resolve_band(window, m, n, band_width)
    _check(queries, "queries", torch.float32, (nq, n), dev)
    _check(candidates, "candidates", torch.float32, (nq, k, m), dev)
    if cb is not None:
        _check(cb, "cb", torch.float32, (nq, k, m), dev)
    ub_l = _as_lanes(ub, nq, k, dev)

    if dev.type == "cpu":
        return dtw_ea_plain(queries, candidates, ub_l, window, bw, cb=cb)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    cpt = cols_per_thread(bw)
    out = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq * k == 0:
        return out
    launch, err = _lib("dtw_ea_slab", "dtw_ea_slab_launch",
                       [_P] * 5 + [_I] * 7 + [_P])
    code = launch(
        queries.data_ptr(), candidates.data_ptr(),
        None if cb is None else cb.data_ptr(), ub_l.data_ptr(),
        out.data_ptr(), nq, k, n, m, window, bw, cpt, _stream(dev),
    )
    _raise_on(code, err, "dtw_ea_slab")
    dtw_ea_multi.launches += 1
    return out


dtw_ea_multi.launches = 0


def dtw_ea(
    query: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    window: int,
    cb: torch.Tensor | None = None,
    band_width: int | None = None,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
) -> torch.Tensor:
    """Single-query slab round: ``dtw_ea_multi`` with ``Q = 1``.

    ``query`` is ``(n,)``, ``candidates`` and ``cb`` ``(K, m)``, ``ub`` a
    scalar or ``(K,)``. Returns ``(K,)`` distances.
    """
    ub = torch.as_tensor(ub, dtype=torch.float32, device=candidates.device)
    return dtw_ea_multi(
        query[None], candidates[None], ub[None] if ub.dim() == 1 else ub,
        window, cb=None if cb is None else cb[None], band_width=band_width,
        block_k=block_k, row_block=row_block, with_info=with_info,
    )[0]


def _persistent_outputs(nq: int, dev):
    return (torch.empty(nq, dtype=torch.float32, device=dev),
            torch.empty(nq, dtype=torch.int32, device=dev),
            torch.empty(nq, dtype=torch.int32, device=dev))


# Columns of the persistent kernels' per-query int32 state
# (csrc/dtw_ea_persistent.cu): next lane, done, largest lane run, lanes
# with a start out of range, lanes that passed the gate.
_STATE_INTS, _BAD, _RAN = 5, 3, 4


def _persistent_state(nq: int, dev):
    """The incumbent words and the state of one persistent launch; the
    kernels initialize both."""
    return (torch.empty(nq, dtype=torch.int64, device=dev),
            torch.empty((nq, _STATE_INTS), dtype=torch.int32, device=dev))


def _check_persistent(queries, lb, starts, ub_init, u, low, use_cb, m, dev):
    """Shared checks of the two persistent wrappers; returns
    ``(nq, n, k, ub_init)`` with ``ub_init`` as ``(Q,)`` float32."""
    if queries.dim() != 2 or lb.dim() != 2:
        raise ValueError("queries must be (Q, n) and lb (Q, K)")
    nq, n = queries.shape
    k = lb.shape[1]
    if use_cb and (u is None or low is None):
        raise ValueError("use_cb requires the query envelopes (u, low)")
    _check(queries, "queries", torch.float32, (nq, n), dev)
    _check(lb, "lb", torch.float32, (nq, k), dev)
    _check(starts, "starts", torch.int32, (nq, k), dev)
    if use_cb:
        _check(u, "u", torch.float32, (nq, m), dev)
        _check(low, "low", torch.float32, (nq, m), dev)
    ub_init = torch.as_tensor(ub_init, dtype=torch.float32, device=dev)
    return nq, n, k, ub_init.expand(nq).contiguous()


def dtw_ea_persistent(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    ub_init,
    window: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    band_width: int | None = None,
    block_k: int = 8,
    row_block: int = 128,
):
    """The whole best-first EAPrunedDTW search over a window slab in one
    launch (kernel E).

    Args:
      queries: ``(Q, n)`` float32 z-normalized queries.
      candidates: ``(Q, K, m)`` float32 normalized windows, best-first per
        query.
      lb: ``(Q, K)`` float32 ascending lower bounds (``+inf`` lanes never
        run: padding and quarantined windows).
      starts: ``(Q, K)`` int32 window start of each lane (reported back for
        the winner).
      ub_init: ``(Q,)`` or scalar seeds (``BIG`` cold); a seed no lane beats
        comes back with start -1.
      window: Sakoe-Chiba window.
      u, low: ``(Q, m)`` float32 query envelopes, required when ``use_cb``
        (the cb suffix is built in the kernel).
      band_width: as in ``dtw_ea_multi``.
      block_k: lanes per block of the ``blocks`` work metric; the lanes need
        no padding to it.
      row_block: Pallas tiling knob; no effect.

    Returns ``(best_dist, best_start, blocks)``, ``(Q,)`` each: float32
    distances, int32 starts (-1 while the seed is unbeaten) and int32
    blocks. ``best_dist`` and ``best_start`` are ``repro``'s; on CUDA the
    lanes run in parallel against a shared incumbent, so ``blocks`` (the
    highest block in which a lane ran, plus one) may differ from
    ``repro``'s and from run to run. On the CPU the plain version gives
    ``repro``'s sequential ``blocks``.
    """
    del row_block
    if not isinstance(candidates, torch.Tensor) or candidates.dim() != 3:
        raise ValueError("candidates must be a (Q, K, m) torch.Tensor")
    dev = candidates.device
    m = candidates.shape[2]
    nq, n, k, seeds = _check_persistent(queries, lb, starts, ub_init, u, low,
                                        use_cb, m, dev)
    _check(candidates, "candidates", torch.float32, (nq, k, m), dev)
    window = int(min(window, m))
    bw = resolve_band(window, m, n, band_width)
    block_k = int(block_k)

    if dev.type == "cpu":
        return dtw_ea_persistent_plain(
            queries, candidates, lb, starts, seeds, window, bw, block_k,
            u=u, low=low, use_cb=use_cb,
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    cpt = cols_per_thread(bw)
    dist, best, blocks = _persistent_outputs(nq, dev)
    if nq * k == 0:
        return seeds.clone(), best.fill_(-1), blocks.zero_()
    inc, state = _persistent_state(nq, dev)
    launch, err = _lib("dtw_ea_persistent", "dtw_ea_persistent_launch",
                       [_P] * 12 + [_I] * 9 + [_P])
    code = launch(
        queries.data_ptr(), candidates.data_ptr(), lb.data_ptr(),
        starts.data_ptr(), seeds.data_ptr(),
        u.data_ptr() if use_cb else None, low.data_ptr() if use_cb else None,
        dist.data_ptr(), best.data_ptr(), blocks.data_ptr(), inc.data_ptr(),
        state.data_ptr(), nq, k, n, m, window, bw, int(use_cb), block_k, cpt,
        _stream(dev),
    )
    _raise_on(code, err, "dtw_ea_persistent")
    dtw_ea_persistent.launches += 1
    dtw_ea_persistent.lanes_run = state[:, _RAN]
    return dist, best, blocks


dtw_ea_persistent.launches = 0
dtw_ea_persistent.lanes_run = None


def dtw_ea_persistent_fused(
    queries: torch.Tensor,
    ref: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    mu: torch.Tensor,
    sg: torch.Tensor,
    ub_init,
    window: int,
    length: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    band_width: int | None = None,
    block_k: int = 8,
    row_block: int = 128,
    ref_budget: int | None = None,
):
    """The whole best-first EAPrunedDTW search over the reference in one
    launch (kernel C): ``dtw_ea_persistent`` with each lane's window sliced
    from ``ref`` and normalized in the kernel, so nothing O(K·m) exists.

    Args (where they differ from ``dtw_ea_persistent``):
      ref: ``(N,)`` float32 raw (sanitized) reference.
      starts: ``(Q, K)`` int32 window starts. A lane whose start lies
        outside ``[0, N - length]`` is never read and never wins; the
        wrapper counts such lanes (one host sync) and raises
        ``SearchInputError`` when there are any.
      mu, sg: ``(Q, K)`` float32 window mean and **clamped** sigma per lane.
      length: window length ``m``.
      ref_budget: Pallas VMEM knob; no effect.

    Returns ``(best_dist, best_start, blocks)`` as ``dtw_ea_persistent``,
    with the same note on ``blocks``.
    """
    del row_block, ref_budget
    if not isinstance(ref, torch.Tensor) or ref.dim() != 1:
        raise ValueError("ref must be an (N,) torch.Tensor")
    dev = ref.device
    m = int(length)
    nq, n, k, seeds = _check_persistent(queries, lb, starts, ub_init, u, low,
                                        use_cb, m, dev)
    _check(ref, "ref", torch.float32, (ref.shape[0],), dev)
    _check(mu, "mu", torch.float32, (nq, k), dev)
    _check(sg, "sg", torch.float32, (nq, k), dev)
    if ref.shape[0] < m:
        raise ValueError(f"ref length {ref.shape[0]} < length {m}")
    window = int(min(window, m))
    bw = resolve_band(window, m, n, band_width)
    block_k = int(block_k)

    if dev.type == "cpu":
        dist, best, blocks, bad = dtw_ea_persistent_fused_plain(
            queries, ref, lb, starts, mu, sg, seeds, window, m, bw, block_k,
            u=u, low=low, use_cb=use_cb,
        )
    elif dev.type == "cuda":
        cpt = cols_per_thread(bw)
        dist, best, blocks = _persistent_outputs(nq, dev)
        if nq * k == 0:
            return seeds.clone(), best.fill_(-1), blocks.zero_()
        inc, state = _persistent_state(nq, dev)
        launch, err = _lib("dtw_ea_persistent",
                           "dtw_ea_persistent_fused_launch",
                           [_P] * 14 + [_I] * 10 + [_P])
        code = launch(
            queries.data_ptr(), ref.data_ptr(), lb.data_ptr(),
            starts.data_ptr(), mu.data_ptr(), sg.data_ptr(), seeds.data_ptr(),
            u.data_ptr() if use_cb else None,
            low.data_ptr() if use_cb else None,
            dist.data_ptr(), best.data_ptr(), blocks.data_ptr(),
            inc.data_ptr(), state.data_ptr(), ref.shape[0], nq, k, n, m,
            window, bw, int(use_cb), block_k, cpt, _stream(dev),
        )
        _raise_on(code, err, "dtw_ea_persistent_fused")
        dtw_ea_persistent_fused.launches += 1
        dtw_ea_persistent_fused.lanes_run = state[:, _RAN]
        bad = state[:, _BAD]
    else:
        raise ValueError(f"no kernel for device {dev}")
    n_bad = int(bad.sum())
    if n_bad:
        raise guards.SearchInputError(
            f"{n_bad} lane(s) have a window start outside [0, "
            f"{ref.shape[0] - m}]"
        )
    return dist, best, blocks


dtw_ea_persistent_fused.launches = 0
dtw_ea_persistent_fused.lanes_run = None


def persistent_grid(length: int, band_width: int, use_cb: bool,
                    fused: bool = True) -> int:
    """Lanes kernel C (``fused``) or E keeps in flight on the current CUDA
    card for windows of ``length`` and a resolved ``band_width``: one warp
    a lane, times the thread blocks the occupancy query keeps resident,
    which sizes each launch's grid (a launch takes fewer when it has fewer
    lanes). Launches nothing."""
    query, err = _lib("dtw_ea_persistent", "dtw_ea_persistent_grid",
                      [_I] * 4 + [_P])
    lanes = ctypes.c_longlong(0)
    _raise_on(query(int(fused), int(length), int(use_cb),
                    cols_per_thread(band_width), ctypes.addressof(lanes)),
              err, "dtw_ea_persistent_grid")
    return lanes.value
