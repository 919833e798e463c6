"""The table of peaks and the least-time arithmetic, frozen.

Copied from ``chip_smoke.py`` (``PEAK_FP32``, ``PEAK_BYTES``,
``FLOPS_PER_CELL``, ``FLOPS_PER_LB_TERM``, ``dtw_bound_ms``, ``bound_by``
and kernel B's bound in ``phase_times``) so that a share of a roofline
never follows a change to the program.
"""
from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 and FP32 outside the
# tensor cores, at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# Flops per evaluated DTW cell: cost (sub, mul), d (min, add), prefix sum,
# d - P, prefix min, P + min, compare.
FLOPS_PER_CELL = 9
# Flops per (window, offset) pair of the LB cascade: sub, div, 2 compares,
# 2 subs, 2 multiply-adds counted as one each.
FLOPS_PER_LB_TERM = 8


def bound_by(cells: int, bound: float) -> str:
    """Which of the two times sets a DTW kernel's bound."""
    return ("operations" if FLOPS_PER_CELL * cells / PEAK_FP32 * 1e3 >= bound
            else "bytes")


def dtw_bound_ms(cells: int, nbytes: int) -> float:
    """The least time for a DTW kernel's work: ``FLOPS_PER_CELL`` per
    evaluated cell at the FP32 peak, or its bytes at the HBM peak."""
    return max(FLOPS_PER_CELL * cells / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def lb_bound_ms(n_ref: int, n_win: int, n_valid: int, nq: int,
                length: int) -> float:
    """The least time of one cascade launch (kernel B) over ``n_valid`` of
    ``n_win`` windows of a ``n_ref``-sample reference for ``nq`` queries:
    ``FLOPS_PER_LB_TERM`` a (query, window, offset) term at the FP32 peak,
    or its bytes at the HBM peak (the reference, the window stats, the
    envelopes, the query ends and the bounds written, each once, and the
    one-byte validity mask)."""
    ops = FLOPS_PER_LB_TERM * nq * n_valid * length
    nbytes = 4 * (n_ref + 2 * n_win + 2 * nq * length + 2 * nq
                  + nq * n_win) + n_win
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def least_work_bytes(searches: int, n_ref: int, nq: int, length: int,
                     live: float) -> float:
    """Bytes the least work of ``searches`` searches reads and writes, each
    once: a search's reference, its queries with their two envelopes and
    a distance and start a query, and four floats of each of the ``live``
    lanes (start, bound, mean, deviation)."""
    return 4 * (searches * (n_ref + 3 * nq * length + 2 * nq) + 4 * live)
