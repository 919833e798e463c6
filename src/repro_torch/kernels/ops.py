"""Wrappers of the port's CUDA kernels.

Each wrapper checks its tensors, then dispatches on their device: CPU
tensors run the kernel's plain PyTorch version; CUDA tensors launch the
kernel or raise. There is no fallback from the kernel to the plain version.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, incremented where it launches its kernel (the
counter variants of kernels A and D, ``with_info=True``, count as launches
of their kernel); a call made while a CUDA graph is captured launches
nothing, and the capturer puts its count back and adds it again on each
replay (``search/pipeline.py::_RoundGraph``, through
:func:`counted_launches`), so a replayed launch counts as an eager one. The
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
thread) and the row loop inside the warp, up to ``MAX_BAND_WIDTH`` = 1024
columns, and past that a thread block of ``WIDE_WARPS`` warps per lane
with the previous DP row in shared memory (``band_layout``;
``csrc/dtw_band_wide.cuh``); they keep the reference in device memory.
In the persistent sweeps ``block_k`` sets the granularity of the
``blocks`` work metric.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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

# The widest band the one-warp DP row holds: at most 32 columns in each of
# its 32 threads' registers (csrc/dtw_band.cuh).
MAX_BAND_WIDTH = 1024

# The wide DP row (csrc/dtw_band_wide.cuh), for bands past MAX_BAND_WIDTH:
# a thread block of WIDE_WARPS warps per lane, WIDE_CPT columns a thread in
# registers for each segment of WIDE_SEGMENT columns a row walks, and the
# previous row (bw floats, rounded up to WIDE_CPT) in dynamic shared memory
# beside at most WIDE_STATIC_SMEM bytes of static shared memory (its
# WideShared), and, where the window is staged (BandLayout.window_staged),
# the lane's window of m floats plus one padding word every 32. A block may
# hold BLOCK_SMEM_MAX bytes of shared memory on an H100, so the wide row
# takes bands up to WIDE_MAX_BAND (58,048) columns, twice the longest query
# kernel B takes. An SM holds SM_SMEM bytes of shared memory, of which each
# resident block also takes BLOCK_RESERVED_SMEM, and SM_THREADS threads.
# chip_smoke.py's build phase prints the wide kernels' registers a thread
# (ptxas) and, for each band it runs, their blocks an SM and shared memory.
WIDE_WARPS = 8
WIDE_CPT = 8
WIDE_SEGMENT = 32 * WIDE_WARPS * WIDE_CPT
WIDE_STATIC_SMEM = 256
BLOCK_SMEM_MAX = 227 * 1024
WIDE_MAX_BAND = (BLOCK_SMEM_MAX - WIDE_STATIC_SMEM) // 4
SM_SMEM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
SM_THREADS = 2048

# Kernel B's tiling (csrc/lb_keogh.cu): a block holds LB_WINDOWS windows and
# one tile of q_tile queries, whose envelopes and reference span sit in
# shared memory. A block may take at most LB_SMEM_BUDGET bytes, so that two
# blocks are resident on an SM (228 KB of shared memory an SM, 1 KB of it
# reserved for each block). Long queries take a smaller tile. Where even one
# query's block does not fit, the tile is one query and the block holds
# only its envelope, in at most LB_SMEM_MAX bytes (the most one block may
# opt in to on an H100), and reads the span from global memory.
LB_WINDOWS = 256
LB_SMEM_BUDGET = (228 * 1024) // 2 - 1024
LB_SMEM_MAX = 227 * 1024
LB_QUERY_TILES = (8, 4, 2, 1)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


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


class BandLayout(NamedTuple):
    """How the DTW kernels hold one lane's band (``band_layout``)."""

    warps: int            # warps that run one lane
    cols_per_thread: int  # band columns a thread holds in registers at once
    segments: int         # passes a DP row makes over the band

    @property
    def tier(self) -> str:
        """Where the previous DP row lives: ``"registers"`` (one warp) or
        ``"shared"`` (the wide row)."""
        return "registers" if self.warps == 1 else "shared"

    def smem_bytes(self, bw: int, length: int, use_cb: bool,
                   staged: bool = False) -> int:
        """Shared memory of a thread block that runs one lane: the one-warp
        row's cb slice (``length`` floats, when ``use_cb``; its kernels put
        up to 4 lanes in a block where their slices fit); the wide row's
        previous row (``bw`` rounded up to ``WIDE_CPT``), its window where
        ``staged`` (``window_word``'s ``length + length // 32`` floats) and
        its static part (its cb lies in global memory).
        ``wide_smem_bytes`` in csrc/dtw_band_wide.cuh counts the same."""
        if self.tier == "registers":
            return 4 * int(length) if use_cb else 0
        length = int(length)
        row = -(-int(bw) // WIDE_CPT) * WIDE_CPT
        window = length + (length >> 5) if staged else 0
        return 4 * (row + window) + WIDE_STATIC_SMEM

    def blocks_by_smem(self, nbytes: int) -> int:
        """Thread blocks of this layout that an SM holds by their shared
        memory (``nbytes`` each) and threads alone."""
        return min(SM_THREADS // (32 * self.warps),
                   SM_SMEM // (int(nbytes) + BLOCK_RESERVED_SMEM))

    def window_staged(self, bw: int, length: int, reg_blocks: int) -> bool:
        """Whether the wide row stages a lane's window in shared memory: the
        one rule, where the staged block still leaves ``reg_blocks`` blocks
        on an SM, the most the kernel's registers allow (the occupancy
        query with no dynamic shared memory). At l = 2048 (bw = 2048) and
        l = 8192 (bw = 1664) it stages; at l = 16,384 (bw = 16,384) the
        row's 64 KB and the window's 66 KB would leave 1 block, not 2 or 3,
        and the window stays in global memory. Never on the one-warp row."""
        if self.tier == "registers":
            return False
        return self.blocks_by_smem(
            self.smem_bytes(bw, length, False, staged=True)) >= reg_blocks


def band_layout(bw: int, length: int | None = None,
                use_cb: bool = False) -> BandLayout:
    """The layout of a band of ``bw`` columns: up to ``MAX_BAND_WIDTH`` the
    one-warp row in registers, ``cols_per_thread(bw)`` columns a thread;
    past it the wide row, ``WIDE_WARPS`` warps a lane and the previous row
    in shared memory, walked in segments of ``WIDE_SEGMENT`` columns.
    Raises where no layout holds the lane: a band past ``WIDE_MAX_BAND``,
    or, with ``use_cb`` on windows of ``length``, a one-warp row's cb slice
    beyond ``BLOCK_SMEM_MAX``."""
    bw = int(bw)
    if bw < 1:
        raise ValueError(f"band_width {bw} < 1")
    if bw <= MAX_BAND_WIDTH:
        layout = BandLayout(1, cols_per_thread(bw), 1)
    elif bw <= WIDE_MAX_BAND:
        layout = BandLayout(WIDE_WARPS, WIDE_CPT, -(-bw // WIDE_SEGMENT))
    else:
        raise ValueError(
            f"band_width {bw} > {WIDE_MAX_BAND}: the wide DTW row holds a "
            f"lane's previous row in a block's {BLOCK_SMEM_MAX} bytes of "
            "shared memory"
        )
    if length is not None and layout.smem_bytes(bw, length, use_cb) > \
            BLOCK_SMEM_MAX:
        raise ValueError(
            f"length {length}: a lane's cb slice of {length} floats does not "
            f"fit a block's {BLOCK_SMEM_MAX} bytes of shared memory (the "
            f"one-warp row, band_width {bw} <= {MAX_BAND_WIDTH})"
        )
    return layout


def lb_smem_bytes(length: int, q_tile: int, span: bool = True) -> int:
    """Shared memory of one kernel-B block: ``q_tile`` interleaved envelope
    pairs of ``length`` floats and, with ``span``, the span of
    ``LB_WINDOWS`` windows. ``launch`` in csrc/lb_keogh.cu sizes the block
    the same way; the two must agree."""
    length = int(length)
    return 4 * (2 * q_tile * length + (LB_WINDOWS + length - 1 if span else 0))


# The longest query whose one-query block holds its windows' span (9,557),
# and the longest kernel B takes at all (29,056: one envelope in
# LB_SMEM_MAX).
LB_SPAN_MAX_LENGTH = (LB_SMEM_BUDGET // 4 - LB_WINDOWS + 1) // 3
LB_MAX_LENGTH = LB_SMEM_MAX // 8


def lb_span_in_smem(length: int) -> bool:
    """Whether kernel B's blocks hold their windows' span of the reference
    in shared memory at ``length`` (up to ``LB_SPAN_MAX_LENGTH``)."""
    return lb_smem_bytes(length, 1) <= LB_SMEM_BUDGET


def lb_query_tiles(n_queries: int, length: int) -> list[tuple[int, int]]:
    """Kernel B's launches for ``n_queries`` queries of ``length``: a list of
    ``(first query, q_tile)``, one launch each, covering every query once.

    The tile is the largest of ``LB_QUERY_TILES`` whose block fits
    ``LB_SMEM_BUDGET`` (8 at the main path's l = 1024); the tail of a
    ``n_queries`` that it does not divide takes smaller tiles. Past
    ``LB_SPAN_MAX_LENGTH`` every tile is one query (``lb_span_in_smem``).
    Raises past ``LB_MAX_LENGTH``, where one envelope does not fit.
    """
    length = int(length)
    if not 1 <= length <= LB_MAX_LENGTH:
        raise ValueError(
            f"length {length} outside [1, {LB_MAX_LENGTH}]: kernel B holds a "
            f"query's envelope in {LB_SMEM_MAX} bytes of shared memory"
        )
    fits = [t for t in LB_QUERY_TILES
            if lb_smem_bytes(length, t) <= LB_SMEM_BUDGET] or [1]
    tiles, q0 = [], 0
    while q0 < n_queries:
        t = next(t for t in fits if t <= n_queries - q0)
        tiles.append((q0, t))
        q0 += t
    return tiles


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
    with_info: bool = False,
):
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
      with_info: also return per-lane ``(rows, cells)`` int32 counters
        (``repro``'s ``EAInfo``: rows issued, the abandoning row included,
        and the cells that exist in them; a dead or out-of-range lane
        counts row 0). On the card this launches the counter variant of
        the kernel.

    Returns ``(Q, K)`` float32 distances; with ``with_info`` a ``(dists,
    rows, cells)`` tuple of ``(Q, K)`` tensors.
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
            u=u, low=low, use_cb=use_cb, count=with_info,
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    layout = band_layout(bw, m, use_cb)
    out, counts = _round_outputs(nq, k, dev, with_info)
    if nq * k == 0:
        return (out, *counts) if with_info else out
    scratch, blocks, staged = _wide_launch(
        layout, "dtw_ea_fused", int(with_info), bw, m, use_cb, nq * k, dev,
        window_scratch=True, cb_scratch=True)
    launch, err = _lib("dtw_ea_fused", "dtw_ea_fused_launch",
                       [_P] * 12 + [_LL] + [_I] * 11 + [_P])
    code = launch(
        queries.data_ptr(), ref.data_ptr(), starts.data_ptr(), mu.data_ptr(),
        sg.data_ptr(), ub.data_ptr(),
        u.data_ptr() if use_cb else None, low.data_ptr() if use_cb else None,
        out.data_ptr(), *_ptrs(counts),
        None if scratch is None else scratch.data_ptr(), blocks,
        ref.shape[0], nq, k, n, m, window, bw, int(use_cb), layout.warps,
        layout.cols_per_thread, int(staged), _stream(dev),
    )
    _raise_on(code, err, "dtw_ea_fused")
    dtw_ea_multi_fused.launches += 1
    return (out, *counts) if with_info else out


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

    Returns ``(n_win,)`` for one query, ``(Q, n_win)`` for Q. On the card
    the kernel runs once per query tile (``lb_query_tiles``: once at the
    main path's Q = 8, l = 1024) and raises for a ``length`` above
    ``LB_MAX_LENGTH``.
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
        tiles = lb_query_tiles(nq, length)
        span = int(lb_span_in_smem(length))
        out = torch.empty((nq, n_win), dtype=torch.float32, device=dev)
        launch, err = _lib("lb_keogh", "lb_cascade_launch",
                           [_P] * 8 + [_I] * 7 + [_P])
        for q0, q_tile in tiles:
            code = launch(
                ref.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
                upper.data_ptr(), lower.data_ptr(), qends.data_ptr(),
                None if valid is None else valid.data_ptr(), out.data_ptr(),
                q0, q_tile, span, n_win, int(length), int(use_kim),
                int(use_keogh), _stream(dev),
            )
            _raise_on(code, err, "lb_cascade")
            lb_keogh_all_windows.launches += 1
    else:
        raise ValueError(f"no kernel for device {dev}")
    return out[0] if single else out


lb_keogh_all_windows.launches = 0


def _round_outputs(nq: int, k: int, dev, with_info: bool):
    """A round kernel's ``(Q, K)`` distances and, with ``with_info``, its
    ``(rows, cells)`` int32 counters (else ``()``); the kernel writes every
    lane of each."""
    out = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if not with_info:
        return out, ()
    return out, tuple(torch.empty((nq, k), dtype=torch.int32, device=dev)
                      for _ in range(2))


def _ptrs(counts) -> tuple:
    """The counters' pointers for a round kernel: both null without."""
    return tuple(t.data_ptr() for t in counts) if counts else (None, None)


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
):
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
      with_info: also return per-lane ``(rows, cells)`` int32 counters, as
        ``dtw_ea_multi_fused`` does (the counter variant of kernel D on the
        card).

    Returns ``(Q, K)`` float32 distances; with ``with_info`` a ``(dists,
    rows, cells)`` tuple of ``(Q, K)`` tensors.
    """
    del block_k, row_block
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
        return dtw_ea_plain(queries, candidates, ub_l, window, bw, cb=cb,
                            count=with_info)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    layout = band_layout(bw, m, cb is not None)
    out, counts = _round_outputs(nq, k, dev, with_info)
    if nq * k == 0:
        return (out, *counts) if with_info else out
    _, blocks, staged = _wide_launch(layout, "dtw_ea_slab", int(with_info),
                                     bw, m, cb is not None, nq * k, dev)
    launch, err = _lib("dtw_ea_slab", "dtw_ea_slab_launch",
                       [_P] * 7 + [_LL] + [_I] * 9 + [_P])
    code = launch(
        queries.data_ptr(), candidates.data_ptr(),
        None if cb is None else cb.data_ptr(), ub_l.data_ptr(),
        out.data_ptr(), *_ptrs(counts), blocks, nq, k, n, m, window, bw,
        layout.warps, layout.cols_per_thread, int(staged), _stream(dev),
    )
    _raise_on(code, err, "dtw_ea_slab")
    dtw_ea_multi.launches += 1
    return (out, *counts) if with_info else out


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
):
    """Single-query slab round: ``dtw_ea_multi`` with ``Q = 1``.

    ``query`` is ``(n,)``, ``candidates`` and ``cb`` ``(K, m)``, ``ub`` a
    scalar or ``(K,)``. Returns ``(K,)`` distances; with ``with_info`` a
    ``(dists, rows, cells)`` tuple of ``(K,)`` tensors.
    """
    ub = torch.as_tensor(ub, dtype=torch.float32, device=candidates.device)
    out = dtw_ea_multi(
        query[None], candidates[None], ub[None] if ub.dim() == 1 else ub,
        window, cb=None if cb is None else cb[None], band_width=band_width,
        block_k=block_k, row_block=row_block, with_info=with_info,
    )
    return tuple(t[0] for t in out) if with_info else out[0]


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
    layout = band_layout(bw, m, use_cb)
    dist, best, blocks = _persistent_outputs(nq, dev)
    if nq * k == 0:
        return seeds.clone(), best.fill_(-1), blocks.zero_()
    inc, state = _persistent_state(nq, dev)
    scratch, grid, staged = _wide_launch(layout, "dtw_ea_persistent", 0, bw,
                                         m, use_cb, nq * k, dev,
                                         cb_scratch=True)
    launch, err = _lib("dtw_ea_persistent", "dtw_ea_persistent_launch",
                       [_P] * 13 + [_LL] + [_I] * 11 + [_P])
    code = launch(
        queries.data_ptr(), candidates.data_ptr(), lb.data_ptr(),
        starts.data_ptr(), seeds.data_ptr(),
        u.data_ptr() if use_cb else None, low.data_ptr() if use_cb else None,
        dist.data_ptr(), best.data_ptr(), blocks.data_ptr(), inc.data_ptr(),
        state.data_ptr(), None if scratch is None else scratch.data_ptr(),
        grid, nq, k, n, m, window, bw, int(use_cb), block_k, layout.warps,
        layout.cols_per_thread, int(staged), _stream(dev),
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
        layout = band_layout(bw, m, use_cb)
        dist, best, blocks = _persistent_outputs(nq, dev)
        if nq * k == 0:
            return seeds.clone(), best.fill_(-1), blocks.zero_()
        inc, state = _persistent_state(nq, dev)
        scratch, grid, staged = _wide_launch(
            layout, "dtw_ea_persistent", 1, bw, m, use_cb, nq * k, dev,
            window_scratch=True, cb_scratch=True)
        launch, err = _lib("dtw_ea_persistent",
                           "dtw_ea_persistent_fused_launch",
                           [_P] * 15 + [_LL] + [_I] * 12 + [_P])
        code = launch(
            queries.data_ptr(), ref.data_ptr(), lb.data_ptr(),
            starts.data_ptr(), mu.data_ptr(), sg.data_ptr(), seeds.data_ptr(),
            u.data_ptr() if use_cb else None,
            low.data_ptr() if use_cb else None,
            dist.data_ptr(), best.data_ptr(), blocks.data_ptr(),
            inc.data_ptr(), state.data_ptr(),
            None if scratch is None else scratch.data_ptr(), grid,
            ref.shape[0], nq, k, n, m, window, bw, int(use_cb), block_k,
            layout.warps, layout.cols_per_thread, int(staged), _stream(dev),
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


def counted_launches() -> dict:
    """Each wrapper of this module that counts its launches, with its
    count now."""
    return {f: f.launches for f in list(globals().values())
            if callable(f) and hasattr(f, "launches")}


def persistent_grid(length: int, band_width: int, use_cb: bool,
                    fused: bool = True) -> int:
    """Lanes kernel C (``fused``) or E keeps in flight on the current CUDA
    card for windows of ``length`` and a resolved ``band_width``: the
    thread blocks the occupancy query keeps resident, times the lanes a
    block runs (its warps on the one-warp row, one on the wide row), which
    sizes each launch's grid (a launch takes fewer when it has fewer
    lanes). Launches nothing."""
    layout = band_layout(band_width, length, use_cb)
    if layout.tier == "shared":
        return wide_plan(layout, "dtw_ea_persistent", int(fused), band_width,
                         length, use_cb).blocks
    return _resident("dtw_ea_persistent",
                     (int(fused), int(length), int(use_cb),
                      layout.cols_per_thread),
                     torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _resident(lib: str, args: tuple, device: int) -> int:
    """``lib``'s ``<lib>_grid(*args, &lanes)`` on card ``device``: the lanes
    its one-warp kernel keeps resident, from the occupancy query, asked
    once for each kernel, window length, cb setting and card."""
    query, err = _lib(lib, f"{lib}_grid", [_I] * len(args) + [_P])
    lanes = ctypes.c_longlong(0)
    _raise_on(query(*args, ctypes.addressof(lanes)), err, f"{lib}_grid")
    return lanes.value


@functools.lru_cache(maxsize=None)
def _wide_blocks(lib: str, variant: int, staged: bool, bw: int, m: int,
                 device: int) -> int:
    """``<lib>_wide_blocks``: the thread blocks of ``lib``'s wide kernel
    (``variant``: counters for A and D, fused for C/E; the window
    ``staged`` or not) resident on one SM of card ``device``, with the
    dynamic shared memory of a band of ``bw`` columns and windows of ``m``,
    or with none where ``bw`` is 0 (the blocks its registers allow). Asked
    once for each kernel, band and card."""
    query, err = _lib(lib, f"{lib}_wide_blocks", [_I] * 4 + [_P])
    per_sm = ctypes.c_int(0)
    _raise_on(query(int(variant), int(staged), int(bw), int(m),
                    ctypes.addressof(per_sm)), err, f"{lib}_wide_blocks")
    return per_sm.value


class WidePlan(NamedTuple):
    """How a wide kernel runs a band (``wide_plan``)."""

    staged: bool     # the lane's window in shared memory
    reg_blocks: int  # blocks an SM the registers of the form that runs allow
    smem: int        # shared memory of a block, bytes
    per_sm: int      # blocks resident on an SM (the occupancy query)
    blocks: int      # blocks resident on the card: a launch's grid


def wide_plan(layout: BandLayout, lib: str, variant: int, bw: int, m: int,
              use_cb: bool) -> WidePlan:
    """The wide launch of ``lib``'s kernel (``variant`` as ``_wide_blocks``)
    at a band of ``bw`` columns and windows of ``m`` on the current card:
    whether it stages the window (``BandLayout.window_staged`` on the
    blocks the registers of its staged form allow), the blocks an SM the
    registers of the form that runs allow, its shared memory, and its
    blocks resident an SM and on the card."""
    card = torch.cuda.current_device()
    regs = _wide_blocks(lib, variant, True, 0, 0, card)
    staged = layout.window_staged(bw, m, regs)
    if not staged:
        regs = _wide_blocks(lib, variant, False, 0, 0, card)
    per_sm = _wide_blocks(lib, variant, staged, bw, m, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return WidePlan(staged, regs, layout.smem_bytes(bw, m, use_cb, staged),
                    per_sm, max(per_sm, 1) * sms)


def _wide_launch(layout: BandLayout, lib: str, variant: int, bw: int, m: int,
                 use_cb: bool, lanes: int, dev, window_scratch: bool = False,
                 cb_scratch: bool = False):
    """A wide launch's ``(scratch, grid, staged)``, the one sizing step of
    kernels A, C, D and E: its grid of resident thread blocks
    (``wide_plan``), at most one a lane, and, from torch's caching
    allocator, m floats of scratch a block for each of the lane's cb suffix
    (``use_cb`` where the kernel builds it: A, C, E; ``cb_scratch``) and
    its normalized window where the kernel builds it (A, C;
    ``window_scratch``) and does not stage it. ``(None, 0, False)`` on the
    one-warp row, whose launches size their own grids."""
    if layout.warps == 1:
        return None, 0, False
    plan = wide_plan(layout, lib, variant, bw, m, use_cb)
    grid = min(plan.blocks, lanes)
    floats = m * (int(window_scratch and not plan.staged)
                  + int(cb_scratch and use_cb))
    buf = (torch.empty(grid * floats, dtype=torch.float32, device=dev)
           if floats else None)
    return buf, grid, plan.staged
