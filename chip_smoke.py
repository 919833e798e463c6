#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never ``repro``) on ``cuda:0``:

  1. the card: its name, and its power limit from ``nvidia-smi``;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, with
     ``nvcc``, in parallel;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (N = 1e6 ECG reference, 8 queries of l = 1024, w = 102):
     kernel B over every window; kernel A over the lane sets and ``ub``s of
     the first 3 host rounds, with ``use_cb`` on and off; kernel D on the
     slab of the same lanes (equal to A bit for bit with ``use_cb`` off);
     kernels C and E over each query's whole best-first order, at a cold
     and a warm seed, against plain sweeps run on the card (C equal to E bit
     for bit, and C run again giving the same ``(best_dist, best_start)``
     bits), and over its first 512 lanes with ``use_cb`` on and off and
     cold, warm and unbeaten seeds; then repeatability: ``window_stats``
     and kernels B and A run again on the same inputs must give the same
     bits (a 1-D ``torch.cumsum``, which ``window_stats`` does not use on
     the card, is shown beside them);
  4. the main path end to end: ``multi_query_search`` at the
     ``SearchConfig`` defaults (ECG, N = 1,000,000, l = 1024, w = 102,
     Q = 8, batch = 256, ``eapruned``), once with host rounds and once with
     ``rounds="persistent"``, each with every kernel's launch count set to 0
     just before and read just after; each winner's distance is recomputed
     with the DP oracle, and each search run once more must give the same
     bits; the persistent search must launch C once, B once and A never,
     and find the host rounds' ``best_start``; the host rounds run a third
     time with CUDA events around every launch of kernel A, to split their
     wall into kernel A and the host loop. Then the slab arms at the
     same N, each against its fused counterpart: host rounds with
     ``gather="slab"`` (kernel D) and the persistent sweep with
     ``gather="slab"`` (kernel E, over a 33 GB slab; its allocation peak is
     printed);
  5. the same search at N = 50,000, l = 256, w = 25, Q = 4 on the card and
     with ``device="cpu"``, for both drivers and both EA variants;
  6. per-kernel times with CUDA events beside the plain versions' times and
     the bounds (C and E: the whole cold sweep of phase 3), kernel A's time
     per DP row, each DTW kernel's share of its bound, the lanes C and E
     keep in flight and run per query, and the host-rounds wall per round
     less kernel A's time;
  7. a ``{"kernels": [...]}`` line; the last line is
     ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
It exits non-zero at once when ``torch.cuda.is_available()`` is false, and
fails on import when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Main-path sizes: repro_torch.configs.dtw_search.SearchConfig defaults.
DATASET = "ECG"
DEVICE = "cuda"
CROSS = dict(ref_len=50_000, query_len=256, window=25, n_queries=4)
KERNEL_A_ROUNDS = 3
# Phase 3 holds kernels C and E against their plain versions over the first
# CE_SHORT best-first lanes of each query (use_cb on and off, three seeds)
# and over each query's whole order (the main path's shapes); the plain
# sweeps on the card evaluate CE_CHUNK lanes a query at a time.
CE_SHORT = 512
CE_CHUNK = 32_768

# Tolerances, each with its reason.
# Kernel B: a window's LB_Keogh sums l = 1024 terms; the kernel adds them in
# order with FMAs, the plain version by torch's tree reduction: O(l) ulp at
# worst, so 1e-4 of the bound (or of 1, for bounds below 1).
TOL_B = 1e-4
# Kernel A: the closed-form row P + cummin(d - P) cancels. P, the row's
# running cost sum across the band, reaches ~1e3-1e4 at l = 1024, w = 102,
# where a distance is ~10, so one ulp of P is ~1e-4 of the distance. The
# kernel adds P in Sklansky order over the band; the plain version's
# torch.cumsum on the card does so only when it scans more than 2^17 rows
# at once, and in chunks of 32 columns (or more) in smaller batches, so the
# two round P differently on every row of a small batch: 1e-3 relative. A
# lane whose distance lies within that of its ub may abandon on one side.
TOL_A = 1e-3
# Kernels C and E against their plain version, and the persistent search
# against the host rounds: the same per-lane DP as kernel A, so a
# distance carries the same rounding of P (1e-3 relative); the winner's
# start must be equal.
# Card against CPU: each side computes its own float32 prefix-sum window
# stats, which round differently (about 1e-5 relative at N = 5e4): 1e-4
# relative on distances; best_start and quarantine counts exactly.
TOL_CROSS = 1e-4
# Oracle recheck of the winners: the per-lane-offset banded DP of
# core.ea_pruned_dtw against the round kernel, same stats; its band starts
# elsewhere, so P rounds differently as for TOL_A: 1e-3 relative.
TOL_ORACLE = 1e-3

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 and FP32 outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# Flops per evaluated DTW cell: cost (sub, mul), d (min, add), prefix sum,
# d - P, prefix min, P + min, compare.
FLOPS_PER_CELL = 9
# Flops per (window, offset) pair of the LB cascade: sub, div, 2 compares,
# 2 subs, 2 multiply-adds counted as one each.
FLOPS_PER_LB_TERM = 8

def say(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[1 card] torch.cuda.get_device_name: {name}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(smi)
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    say(f"[2 build] {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(secs) or 'nothing (cached)'}")
    for name, (s, log) in sorted(_build.build_log.items()):
        keep = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
        say(f"  {name}: {s:.2f} s; ptxas: {' | '.join(keep)}")


def main_path_inputs(torch, cfg, dev):
    from repro_torch.data.synthetic import make_dataset, make_queries

    ref = torch.as_tensor(make_dataset(DATASET, cfg.ref_len, seed=0),
                          dtype=torch.float32, device=dev)
    queries = torch.as_tensor(
        make_queries(DATASET, cfg.n_queries, cfg.query_len, seed=1),
        dtype=torch.float32, device=dev)
    return ref, queries


def rel_err(k, p) -> float:
    return float(((k - p).abs() / p.abs().clamp_min(1.0)).max())


def phase_kernel_b(torch, prep, pq, plan) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.lb_keogh import lb_all_windows_plain

    qends = torch.stack([pq.qn[:, 0], pq.qn[:, -1]], 1).contiguous()
    args = (prep.ref, prep.mu, prep.sigma, pq.u.contiguous(),
            pq.low.contiguous(), qends, plan.length)
    k = ops.lb_keogh_all_windows(*args, valid=prep.valid)
    p = lb_all_windows_plain(*args, valid=prep.valid, chunk=plan.chunk)
    torch.cuda.synchronize()
    fin = torch.isfinite(p)
    check(bool((torch.isfinite(k) == fin).all()), "kernel B +inf mask")
    kf, pf = k[fin], p[fin]
    abs_err = float((kf - pf).abs().max())
    rel = rel_err(kf, pf)
    say(f"[3 kernel B] {tuple(k.shape)} bounds: max abs err {abs_err:.3e}, "
        f"max rel err {rel:.3e} (tol {TOL_B})")
    check(rel <= TOL_B, f"kernel B rel err {rel} > {TOL_B}")
    return {"args": args, "valid": prep.valid, "max_abs_err": abs_err}


def round_inputs(torch, plan, state, order, lb_sorted, r):
    """The starts and per-lane ub of host round ``r`` (as
    ``pipeline.run_host_rounds`` builds them, every query active)."""
    from repro_torch.core.common import DEAD_LANE_UB

    cols = torch.arange(plan.batch, device=order.device) + r * plan.batch
    starts = order[:, cols]
    lbs = lb_sorted[:, cols]
    live = lbs < state.ub[:, None]
    ub = torch.where(live, state.ub[:, None].expand(live.shape), DEAD_LANE_UB)
    return starts, ub, lbs


def compare_lanes(torch, k, p, ub, label: str) -> float:
    """Hold a round kernel's ``(Q, K)`` distances ``k`` against the plain
    version's ``p``: equal abandon masks except for lanes within ``TOL_A``
    of their ``ub``, and ``TOL_A`` relative where both finish. Returns the
    largest absolute difference."""
    fk, fp = torch.isfinite(k), torch.isfinite(p)
    near_ub = torch.zeros_like(fk)
    for d, f in ((k, fk), (p, fp)):
        near_ub |= f & ((d - ub).abs() <= TOL_A * ub.abs().clamp_min(1.0))
    mismatched = (fk != fp) & ~near_ub
    both = fk & fp
    abs_err = float((k[both] - p[both]).abs().max()) if both.any() else 0.0
    rel = rel_err(k[both], p[both]) if both.any() else 0.0
    say(f"  {label}: {int(fk.sum())}/{fk.numel()} lanes finish "
        f"(plain {int(fp.sum())}), masks differ on "
        f"{int((fk != fp).sum())} lanes ({int(near_ub.sum())} near ub), "
        f"max abs err {abs_err:.3e}, max rel err {rel:.3e} (tol {TOL_A})")
    check(int(mismatched.sum()) == 0, f"{label}: abandon masks differ away "
          "from ub")
    check(rel <= TOL_A, f"{label}: rel err {rel} > {TOL_A}")
    return abs_err


def phase_kernel_a(torch, prep, pq, plan, order, lb_sorted) -> dict:
    from repro_torch.core.common import clamp_sigma
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain
    from repro_torch.search.incumbents import initial_state, fold_min

    state = initial_state(pq.qn.shape[0], device=order.device)
    bw = ops.resolve_band(plan.window, plan.length, plan.length, plan.band_width)
    rounds = []
    worst_abs = 0.0
    for r in range(KERNEL_A_ROUNDS):
        starts, ub, lbs = round_inputs(torch, plan, state, order, lb_sorted, r)
        s32 = starts.to(torch.int32).contiguous()
        mu = prep.mu[starts].contiguous()
        sg = clamp_sigma(prep.sigma)[starts].contiguous()
        ub = ub.contiguous()
        for use_cb in (True, False):
            env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
                       use_cb=use_cb)
            args = (pq.qn.contiguous(), prep.ref, s32, mu, sg, ub,
                    plan.window, plan.length)
            k = ops.dtw_ea_multi_fused(*args, **env)
            p, rows, cells = dtw_ea_fused_plain(*args, bw, count=True, **env)
            torch.cuda.synchronize()
            worst_abs = max(worst_abs, compare_lanes(
                torch, k, p, ub, f"[3 kernel A] round {r} use_cb={use_cb}"))
            say(f"    plain counts {int(rows.sum())} rows, "
                f"{int(cells.sum())} cells")
            if use_cb:
                rounds.append({"args": args, "env": env, "cells": int(cells.sum()),
                               "rows": int(rows.sum()), "lanes": k.numel(),
                               "bw": bw, "out": k})
                d_fold = torch.where(torch.isfinite(lbs), k, float("inf"))
            else:
                rounds[-1]["out_nocb"] = k
        state, _ = fold_min(state, starts, d_fold)
    return {"rounds": rounds, "max_abs_err": worst_abs}


def phase_kernel_d(torch, prep, pq, plan, ka) -> dict:
    """Kernel D on the slab of kernel A's three round lane sets: equal to
    A bit for bit with ``use_cb`` off; against its plain version and
    within ``TOL_A`` of A with the host-side cb slab."""
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_plain
    from repro_torch.search.znorm import gather_norm_windows

    rounds = []
    worst_abs = 0.0
    for i, r in enumerate(ka["rounds"]):
        qn, _, s32, _, _, ub, window, length = r["args"]
        slab = gather_norm_windows(prep.ref, s32, length, prep.mu,
                                   prep.sigma).contiguous()
        cbs = cascade_keogh_cumulative(slab, pq.u[:, None, :],
                                       pq.low[:, None, :]).contiguous()
        d_off = ops.dtw_ea_multi(qn, slab, ub, window)
        d_on = ops.dtw_ea_multi(qn, slab, ub, window, cb=cbs)
        p, rows, cells = dtw_ea_plain(qn, slab, ub, window, r["bw"], cb=cbs,
                                      count=True)
        torch.cuda.synchronize()
        same = torch.equal(d_off, r["out_nocb"])
        say(f"[3 kernel D] round {i}: use_cb=False equals kernel A bit for "
            f"bit: {same}")
        check(same, f"kernel D differs from kernel A (round {i}, no cb)")
        worst_abs = max(worst_abs, compare_lanes(
            torch, d_on, p, ub, f"[3 kernel D] round {i} host cb slab"))
        compare_lanes(torch, d_on, r["out"], ub,
                      f"[3 kernel D] round {i} host cb slab against kernel A")
        rounds.append({"args": (qn, slab, ub, window), "cb": cbs,
                       "cells": int(cells.sum()), "lanes": d_on.numel(),
                       "bw": r["bw"]})
    return {"rounds": rounds, "max_abs_err": worst_abs}


def _ce_check(torch, c, p, label: str, *, start_only: bool = False) -> float:
    """Hold a persistent kernel's ``(best_dist, best_start, blocks)`` ``c``
    against its plain version's ``p``: the same starts, distances within
    ``TOL_A`` relative; ``blocks`` is printed. Returns the largest absolute
    distance difference."""
    abs_err = float((c[0] - p[0]).abs().max())
    rel = rel_err(c[0], p[0])
    say(f"  {label}: best_start {c[1].tolist()} (plain {p[1].tolist()}), "
        f"best_dist max abs err {abs_err:.3e}, max rel err {rel:.3e} "
        f"(tol {TOL_A}); blocks {c[2].tolist()} (plain {p[2].tolist()})")
    check(c[1].tolist() == p[1].tolist(),
          f"{label}: best_start differs from the plain version")
    check(rel <= TOL_A, f"{label}: best_dist rel err {rel} > {TOL_A}")
    return abs_err


def phase_kernel_ce(torch, prep, pq, plan, order, lb_sorted) -> dict:
    """Kernels C and E against their plain versions, in two parts.

    Short: the first ``CE_SHORT`` best-first lanes of each query, with
    ``use_cb`` on and off and a cold seed, a warm one (1% above the cold
    answer) and an unbeaten one (1% below); C and E each against its own
    plain version, and C equal to E bit for bit.

    Whole: each query's whole best-first order at the main path's
    ``use_cb``, as the persistent search runs it: C against its plain
    version at the cold and the warm seed, E (on the full ``(Q, n_win, l)``
    slab) against its own at the cold seed, C equal to E bit for bit, and C
    run again giving the same ``(best_dist, best_start)`` bits (``blocks``
    may differ). The plain sweeps run on the card, ``CE_CHUNK`` lanes a
    query at a time, and their seconds are printed. C and E are timed here
    over the whole cold sweep, and the least work of any best-first sweep
    (every lane whose bound lies below the answer, run against the answer)
    is counted for their bound."""
    from repro_torch.core.common import BIG, DEAD_LANE_UB, clamp_sigma
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import (
        dtw_ea_persistent_fused_plain,
        dtw_ea_persistent_plain,
        dtw_ea_plain,
    )
    from repro_torch.search.znorm import gather_norm_windows

    nq = pq.qn.shape[0]
    w, m, bk = plan.window, plan.length, plan.block_k
    bw = ops.resolve_band(w, m, m, plan.band_width)
    cold = torch.full((nq,), BIG, dtype=torch.float32, device=order.device)

    def descriptors(k):
        """Kernel C's lane inputs for the first ``k`` best-first lanes."""
        starts = order[:, :k]
        return (pq.qn.contiguous(), prep.ref, lb_sorted[:, :k].contiguous(),
                starts.to(torch.int32).contiguous(),
                prep.mu[starts].contiguous(),
                clamp_sigma(prep.sigma[starts]).contiguous())

    worst_abs = 0.0
    fused = descriptors(CE_SHORT)
    slab = gather_norm_windows(prep.ref, order[:, :CE_SHORT], m, prep.mu,
                               prep.sigma)
    qn, _, lb, s32 = fused[:4]
    for use_cb in (True, False):
        env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
                   use_cb=use_cb)
        c_cold = ops.dtw_ea_persistent_fused(*fused, cold, w, m, **env)
        seeds = {"cold": cold, "warm": c_cold[0] * 1.01,
                 "unbeaten": c_cold[0] * 0.99}
        for name, seed in seeds.items():
            c = ops.dtw_ea_persistent_fused(*fused, seed, w, m, **env)
            e = ops.dtw_ea_persistent(qn, slab, lb, s32, seed, w, **env)
            pc = dtw_ea_persistent_fused_plain(*fused, seed, w, m, bw, bk,
                                               **env)
            pe = dtw_ea_persistent_plain(qn, slab, lb, s32, seed, w, bw, bk,
                                         **env)
            torch.cuda.synchronize()
            label = f"{CE_SHORT} lanes use_cb={use_cb} {name} seed"
            worst_abs = max(worst_abs,
                            _ce_check(torch, c, pc, f"[3 kernel C] {label}"),
                            _ce_check(torch, e, pe, f"[3 kernel E] {label}"))
            same_ce = torch.equal(c[0], e[0]) and torch.equal(c[1], e[1])
            say(f"  C equals E bit for bit: {same_ce}")
            check(same_ce, f"kernels C and E differ ({label})")
            if name == "unbeaten":
                check(c[1].tolist() == [-1] * nq, "an unbeaten seed was beaten")
    del fused, slab

    # The whole best-first order of every query.
    k = order.shape[1]
    use_cb = plan.use_cb
    env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(), use_cb=use_cb)
    fused = descriptors(k)
    qn, _, lb, s32 = fused[:4]
    in_flight = {"C": ops.persistent_grid(m, bw, use_cb, fused=True),
                 "E": ops.persistent_grid(m, bw, use_cb, fused=False)}
    say(f"[3 kernels C, E] whole best-first order: {k} lanes a query, "
        f"use_cb={use_cb}; lanes in flight: kernel C {in_flight['C']}, "
        f"kernel E {in_flight['E']} (one warp a lane)")

    def plain_c(seed):
        t0 = time.perf_counter()
        out = dtw_ea_persistent_fused_plain(*fused, seed, w, m, bw, bk,
                                            chunk=CE_CHUNK, **env)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    c_call = lambda seed: ops.dtw_ea_persistent_fused(*fused, seed, w, m,
                                                      block_k=bk, **env)
    c = {"cold": c_call(cold)}
    ran = {"C": ops.dtw_ea_persistent_fused.lanes_run.tolist()}
    c["warm"] = c_call(c["cold"][0] * 1.01)
    plain_s = {}
    for name in ("cold", "warm"):
        seed = cold if name == "cold" else c["cold"][0] * 1.01
        p, plain_s[name] = plain_c(seed)
        say(f"  plain sweep of C, {name} seed: {plain_s[name]:.2f} s on the "
            f"card, {CE_CHUNK} lanes a query at a time")
        worst_abs = max(worst_abs, _ce_check(
            torch, c[name], p, f"[3 kernel C] whole order, {name} seed"))
    runs = [c_call(cold) for _ in range(2)]
    torch.cuda.synchronize()
    first = c["cold"]
    same = all(torch.equal(r[0], first[0]) and torch.equal(r[1], first[1])
               for r in runs)
    say(f"[3 repeat] kernel C over the whole order run 3 times: (best_dist, "
        f"best_start) the same bits: {same}; blocks "
        f"{[r[2].tolist() for r in (first, *runs)]}")
    check(same, "kernel C is not repeatable")
    c_ms = cuda_ms(lambda: c_call(cold), 2)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slab = gather_norm_windows(prep.ref, order, m, prep.mu, prep.sigma)
    torch.cuda.synchronize()
    say(f"  the whole slab: {tuple(slab.shape)}, "
        f"{slab.numel() * 4 / 1e9:.2f} GB")
    e_call = lambda seed: ops.dtw_ea_persistent(qn, slab, lb, s32, seed, w,
                                                block_k=bk, **env)
    e = {}
    for name in ("cold", "warm"):
        seed = cold if name == "cold" else c["cold"][0] * 1.01
        e[name] = e_call(seed)
        torch.cuda.synchronize()
        if name == "cold":
            ran["E"] = ops.dtw_ea_persistent.lanes_run.tolist()
        same_ce = (torch.equal(c[name][0], e[name][0])
                   and torch.equal(c[name][1], e[name][1]))
        say(f"[3 kernel E] whole order, {name} seed: C equals E bit for bit: "
            f"{same_ce}; blocks E {e[name][2].tolist()}")
        check(same_ce, f"kernels C and E differ over the whole order ({name})")
    t0 = time.perf_counter()
    pe = dtw_ea_persistent_plain(qn, slab, lb, s32, cold, w, bw, bk,
                                 chunk=CE_CHUNK, **env)
    torch.cuda.synchronize()
    plain_s["E"] = time.perf_counter() - t0
    say(f"  plain sweep of E, cold seed: {plain_s['E']:.2f} s on the card")
    worst_abs = max(worst_abs, _ce_check(
        torch, e["cold"], pe, "[3 kernel E] whole order, cold seed"))
    e_ms = cuda_ms(lambda: e_call(cold), 2)

    # The least work of any best-first sweep: every lane whose bound lies
    # below the answer, run against the answer itself (a best-first prefix
    # of each query's order).
    best = first[0][:, None]
    live = lb < best
    n_live = int(live.sum(dim=1).max())
    cells = 0
    for lo in range(0, n_live, CE_CHUNK):
        hi = min(n_live, lo + CE_CHUNK)
        sl = slab[:, lo:hi]
        ub = torch.where(live[:, lo:hi], best, DEAD_LANE_UB).contiguous()
        cb = (cascade_keogh_cumulative(sl, pq.u[:, None, :], pq.low[:, None, :])
              if use_cb else None)
        _, _, cl = dtw_ea_plain(qn, sl, ub, w, bw, cb=cb, count=True)
        cells += int(cl.sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"  least work of the cold sweep: {int(live.sum())} lanes below the "
        f"answer, {cells} cells; peak {peak:.2f} GB allocated with the slab")
    del slab
    torch.cuda.empty_cache()
    return {"c_ms": c_ms, "e_ms": e_ms, "c_plain_ms": plain_s["cold"] * 1e3,
            "in_flight": in_flight, "ran": ran,
            "e_plain_ms": plain_s["E"] * 1e3, "cells": cells,
            "live": int(live.sum()), "length": m,
            "env_floats": qn.numel() + 2 * env["u"].numel() + 4 * nq,
            "max_abs_err": worst_abs}


def phase_repeat(torch, prep, plan, kb, ka, reps: int = 3) -> None:
    """Run-to-run repeatability on the card: ``window_stats`` and both
    kernels on the same inputs must give the same bits every time. A 1-D
    ``torch.cumsum`` of the reference is shown beside them, not checked:
    it is the scan ``window_stats`` avoids on the card."""
    from repro_torch.kernels import ops
    from repro_torch.search.znorm import window_stats

    def flat(out):
        parts = out if isinstance(out, tuple) else (out,)
        return torch.cat([t.reshape(-1) for t in parts])

    def differing(fn) -> int:
        first = flat(fn())
        outs = [flat(fn()) for _ in range(reps - 1)]
        torch.cuda.synchronize()
        return sum(not torch.equal(first, o) for o in outs)

    ref = prep.ref
    n_cumsum = differing(lambda: torch.cumsum(ref, dim=0))
    n_cumsum_sq = differing(lambda: torch.cumsum(ref * ref, dim=0))
    n_stats = differing(lambda: window_stats(ref, plan.length))
    n_b = differing(lambda: ops.lb_keogh_all_windows(*kb["args"],
                                                     valid=kb["valid"]))
    r0 = ka["rounds"][0]
    n_a = differing(lambda: ops.dtw_ea_multi_fused(*r0["args"], **r0["env"]))
    stats_ms = cuda_ms(lambda: window_stats(ref, plan.length), 5)
    say(f"[3 repeat] of {reps - 1} repeats, how many differ in any bit from "
        f"the first run: 1-D torch.cumsum(ref) {n_cumsum}, "
        f"torch.cumsum(ref*ref) {n_cumsum_sq} (shown, not checked); "
        f"window_stats {n_stats}, kernel B {n_b}, kernel A round 0 {n_a}; "
        f"window_stats {stats_ms:.3f} ms")
    check(n_stats == 0, "window_stats is not repeatable on the card")
    check(n_b == 0, "kernel B is not repeatable")
    check(n_a == 0, "kernel A is not repeatable")


KERNELS = ("dtw_ea_multi_fused", "lb_keogh_all_windows",
           "dtw_ea_persistent_fused", "dtw_ea_multi", "dtw_ea_persistent")


def counted_search(torch, ref, queries, cfg, **kw):
    """One ``multi_query_search`` on the card with every kernel's launch
    count set to 0 just before and read just after. Returns ``(result,
    wall seconds, launches)``."""
    from repro_torch.kernels import ops
    from repro_torch.search import multi_query_search

    for name in KERNELS:
        getattr(ops, name).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = multi_query_search(
        ref, queries, cfg.query_len, cfg.window, variant=cfg.variant,
        batch=cfg.batch, warm_start=cfg.warm_start, block_k=cfg.block_k,
        device=DEVICE, **kw,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {name: getattr(ops, name).launches for name in KERNELS}


def phase_end_to_end(torch, cfg, ref, queries, rounds: str,
                     host: dict | None = None) -> dict:
    """The main path end to end under one round driver: launch counts,
    winners in range and finite, the oracle recheck, the same bits when run
    again; the persistent sweep also launches C once, B once and A never,
    and must find the host rounds' ``best_start``."""
    from repro_torch.core.common import norm_window_slice
    from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw_banded
    from repro_torch.search.pipeline import prepare_queries, prepare_ref

    plan = cfg.make_plan(rounds=rounds)
    res, wall, launches = counted_search(torch, ref, queries, cfg,
                                         rounds=rounds)
    say(f"[4 end to end] multi_query_search N={cfg.ref_len} l={cfg.query_len} "
        f"w={cfg.window} Q={cfg.n_queries} batch={cfg.batch} {cfg.variant} "
        f"rounds={rounds}: {wall:.3f} s wall; launches {launches}")
    starts = res.best_start.tolist()
    say(f"  best_start {starts}")
    say(f"  best_dist {res.best_dist.tolist()}")
    say(f"  rounds {res.rounds.tolist()} lanes {res.lanes.tolist()} "
        f"quarantined {int(res.quarantined)}")
    if rounds == "host":
        check(launches["dtw_ea_multi_fused"] > 0
              and launches["lb_keogh_all_windows"] > 0,
              "a kernel was not launched")
    else:
        check(launches["dtw_ea_persistent_fused"] == 1
              and launches["lb_keogh_all_windows"] == 1
              and launches["dtw_ea_multi_fused"] == 0,
              "the persistent search must launch C once, B once and A never")
    n_win = cfg.ref_len - cfg.query_len + 1
    check(all(0 <= s < n_win for s in starts), "best_start out of range")
    check(bool(torch.isfinite(res.best_dist).all()), "non-finite best_dist")
    if host is not None:
        h = host["res"]
        rel = rel_err(res.best_dist, h.best_dist)
        bits = torch.equal(res.best_dist, h.best_dist)
        say(f"  against the host rounds: best_start equal "
            f"{starts == h.best_start.tolist()}, best_dist max rel err "
            f"{rel:.3e} (tol {TOL_A}), the same bits: {bits}")
        check(starts == h.best_start.tolist(),
              "the persistent search found another best_start")
        check(rel <= TOL_A, "persistent best_dist differs from host rounds")
    # Recompute each winner with the DP oracle on the same stats.
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    win = norm_window_slice(prep.ref, res.best_start, cfg.query_len, prep.mu,
                            prep.sigma)
    d = ea_pruned_dtw_banded(pq.qn, win, float("inf"), cfg.window)
    rel = rel_err(d, res.best_dist)
    say(f"  oracle recheck of the winners: max rel err {rel:.3e} "
        f"(tol {TOL_ORACLE})")
    check(rel <= TOL_ORACLE, "winner distance disagrees with the DP oracle")
    again, _, _ = counted_search(torch, ref, queries, cfg, rounds=rounds)
    same = (torch.equal(again.best_start, res.best_start)
            and torch.equal(again.best_dist, res.best_dist))
    say(f"  the search run again: same bits {same}; lanes "
        f"{again.lanes.tolist()}")
    check(same, "the search is not repeatable on the card")
    return {"wall_s": wall, "launches": launches, "res": res}


def host_loop_split(torch, cfg, ref, queries) -> dict:
    """The host-rounds search once more, with CUDA events around every
    launch of kernel A (``core.batch`` sees a stand-in for ``kernels.ops``
    that records them): kernel A's time summed over the search, and what
    the rest of the wall costs per round. Not a counted run."""
    from repro_torch.core import batch
    from repro_torch.kernels import ops

    events = []
    kernel_a = ops.dtw_ea_multi_fused

    class TimedOps:
        def __getattr__(self, name):
            return getattr(ops, name)

        @staticmethod
        def dtw_ea_multi_fused(*args, **kwargs):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = kernel_a(*args, **kwargs)
            ev[1].record()
            events.append(ev)
            return out

    batch.ops = TimedOps()
    try:
        _, wall, _ = counted_search(torch, ref, queries, cfg, rounds="host")
    finally:
        batch.ops = ops
    a_ms = sum(s.elapsed_time(e) for s, e in events)
    launches = len(events)
    loop_ms = wall * 1e3 - a_ms
    say(f"[4 host loop] host rounds with events around kernel A: "
        f"{wall:.3f} s wall, {launches} launches of A, A {a_ms:.1f} ms in all "
        f"({a_ms / launches:.4f} ms a launch); the rest {loop_ms:.1f} ms "
        f"({loop_ms / launches:.4f} ms a round, "
        f"{100 * loop_ms / (wall * 1e3):.1f}% of the wall)")
    return {"wall_s": wall, "a_ms": a_ms, "launches": launches,
            "loop_ms_per_round": loop_ms / launches}


def phase_slab_arms(torch, cfg, ref, queries, host: dict, sweep: dict) -> dict:
    """The slab arms end to end at the full N: host rounds with
    ``gather="slab"`` (kernel D, an (8, 256, 1024) slab a round) against
    phase 4's host rounds, and the persistent sweep with ``gather="slab"``
    (kernel E, the whole (8, n_win, 1024) slab) against phase 4's fused
    sweep, with its allocation peak."""
    res, wall, launches = counted_search(torch, ref, queries, cfg,
                                         gather="slab")
    say(f"[4 slab arms] host rounds gather=slab N={cfg.ref_len}: {wall:.3f} s "
        f"wall; launches {launches}; best_start equal to gather=fused "
        f"{res.best_start.tolist() == host['res'].best_start.tolist()}, "
        f"best_dist the same bits "
        f"{torch.equal(res.best_dist, host['res'].best_dist)}")
    check(launches["dtw_ea_multi"] > 0 and launches["dtw_ea_multi_fused"] == 0
          and launches["lb_keogh_all_windows"] == 1,
          "the slab host rounds must run kernel D and not kernel A")
    check(res.best_start.tolist() == host["res"].best_start.tolist(),
          "host rounds: gather=slab and gather=fused differ")
    out = {"dtw_ea_multi": launches["dtw_ea_multi"], "host_slab_wall_s": wall}
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slab, s_wall, s_launches = counted_search(torch, ref, queries, cfg,
                                              rounds="persistent",
                                              gather="slab")
    peak = torch.cuda.max_memory_allocated() / 1e9
    fused = sweep["res"]
    say(f"[4 slab arms] persistent gather=slab N={cfg.ref_len}: "
        f"{s_wall:.3f} s wall (gather=fused {sweep['wall_s']:.3f} s), peak "
        f"{peak:.2f} GB allocated, launches {s_launches}; best_start equal "
        f"{slab.best_start.tolist() == fused.best_start.tolist()}, best_dist "
        f"the same bits {torch.equal(slab.best_dist, fused.best_dist)}")
    check(s_launches["dtw_ea_persistent"] == 1
          and s_launches["lb_keogh_all_windows"] == 1
          and s_launches["dtw_ea_persistent_fused"] == 0,
          "the slab sweep must launch E once and C never")
    check(slab.best_start.tolist() == fused.best_start.tolist(),
          "persistent: gather=slab and gather=fused differ")
    torch.cuda.empty_cache()
    out.update(dtw_ea_persistent=s_launches["dtw_ea_persistent"],
               sweep_slab_wall_s=s_wall, sweep_slab_peak_gb=peak)
    return out


def phase_cross_check(torch) -> None:
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.search import multi_query_search

    c = CROSS
    ref = make_dataset(DATASET, c["ref_len"], seed=0).astype(np.float32)
    qs = make_queries(DATASET, c["n_queries"], c["query_len"], seed=1)
    qs = qs.astype(np.float32)
    for rounds in ("host", "persistent"):
        for variant in ("eapruned", "eapruned_nolb"):
            out = {}
            for dev in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                out[dev] = multi_query_search(
                    ref, qs, c["query_len"], c["window"], variant=variant,
                    batch=256, rounds=rounds, device=dev,
                )
                torch.cuda.synchronize()
                say(f"[5 cross-check] {rounds} {variant} {dev}: "
                    f"{time.perf_counter() - t0:.2f} s, best_start "
                    f"{out[dev].best_start.tolist()}")
            g, h = out[DEVICE], out["cpu"]
            label = f"{rounds} {variant}"
            check(g.best_start.cpu().tolist() == h.best_start.tolist(),
                  f"{label}: best_start differs between card and CPU")
            check(int(g.quarantined) == int(h.quarantined),
                  f"{label}: quarantine counts differ")
            rel = rel_err(g.best_dist.cpu(), h.best_dist)
            say(f"  {label}: best_dist max rel err {rel:.3e} "
                f"(tol {TOL_CROSS})")
            check(rel <= TOL_CROSS, f"{label}: distances differ")


def bound_by(cells: int, bound: float) -> str:
    """Which of the two times sets a DTW kernel's bound."""
    return ("operations" if FLOPS_PER_CELL * cells / PEAK_FP32 * 1e3 >= bound
            else "bytes")


def dtw_bound_ms(cells: int, nbytes: int) -> float:
    """The least time for a DTW kernel's work: ``FLOPS_PER_CELL`` per
    evaluated cell at the FP32 peak, or its bytes at the HBM peak."""
    return max(FLOPS_PER_CELL * cells / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def phase_times(torch, kb: dict, ka: dict, kd: dict, kce: dict,
                loop: dict) -> list[dict]:
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain, dtw_ea_plain
    from repro_torch.kernels.lb_keogh import lb_all_windows_plain

    args, valid = kb["args"], kb["valid"]
    ref, mu, sigma, upper, lower, qends, length = args
    nq, n_win = upper.shape[0], mu.shape[0]
    b_ms = cuda_ms(lambda: ops.lb_keogh_all_windows(*args, valid=valid), 5)
    b_plain = host_ms(lambda: lb_all_windows_plain(*args, valid=valid))
    b_ops = FLOPS_PER_LB_TERM * nq * int(valid.sum()) * length
    b_bytes = 4 * (ref.numel() + 2 * n_win + 2 * nq * length + 2 * nq
                   + nq * n_win) + n_win
    b_bound = max(b_ops / PEAK_FP32, b_bytes / PEAK_BYTES) * 1e3
    say(f"[6 times] kernel B: {b_ms:.3f} ms (plain {b_plain:.1f} ms), bound "
        f"{b_bound:.3f} ms by operations ({b_ops:.3e} flops)")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a_ms, a_plain, a_bound = [], [], []
    for i, r in enumerate(ka["rounds"]):
        a_ms.append(cuda_ms(lambda: ops.dtw_ea_multi_fused(*r["args"], **r["env"]), 5))
        a_plain.append(host_ms(lambda: dtw_ea_fused_plain(*r["args"], r["bw"], **r["env"])))
        m = r["args"][-1]
        nbytes = 4 * (r["lanes"] * (m + 5) + 3 * r["args"][0].numel())
        a_bound.append(dtw_bound_ms(r["cells"], nbytes))
        say(f"  kernel A round {i}: {a_ms[-1]:.3f} ms (plain {a_plain[-1]:.1f} ms), "
            f"bound {a_bound[-1]:.4f} ms ({r['cells']} cells); {r['rows']} DP "
            f"rows, {a_ms[-1] * 1e6 * sms / r['rows']:.1f} ns of one SM a row")

    # Kernel D: the three rounds' slabs with the host cb slab; each lane
    # reads its window and cb rows (2m floats) and its ub, writes one float.
    d_ms, d_plain, d_bound = [], [], []
    for i, r in enumerate(kd["rounds"]):
        args, cb = r["args"], r["cb"]
        d_ms.append(cuda_ms(lambda: ops.dtw_ea_multi(*args, cb=cb), 5))
        d_plain.append(host_ms(lambda: dtw_ea_plain(*args, r["bw"], cb=cb)))
        m = args[1].shape[-1]
        nbytes = 4 * (r["lanes"] * (2 * m + 2) + args[0].numel())
        d_bound.append(dtw_bound_ms(r["cells"], nbytes))
        say(f"  kernel D round {i}: {d_ms[-1]:.3f} ms (plain {d_plain[-1]:.1f} ms), "
            f"bound {d_bound[-1]:.4f} ms ({r['cells']} cells)")

    # Kernels C and E: the cold sweep of each query's whole order (phase 3).
    # The bound counts the least work of any best-first sweep, and each
    # lane of it reads its inputs once: C its window of the reference and
    # four descriptors, E its slab row and two.
    m, live = kce["length"], kce["live"]
    fixed = 4 * kce["env_floats"]
    c_ms, e_ms = kce["c_ms"], kce["e_ms"]
    c_plain, e_plain = kce["c_plain_ms"], kce["e_plain_ms"]
    c_bound = dtw_bound_ms(kce["cells"], fixed + 4 * live * (m + 4))
    e_bound = dtw_bound_ms(kce["cells"], fixed + 4 * live * (m + 2))
    say(f"  kernel C (whole order): {c_ms:.3f} ms (plain {c_plain:.1f} ms), "
        f"bound {c_bound:.4f} ms ({kce['cells']} cells)")
    say(f"  kernel E (whole order): {e_ms:.3f} ms (plain {e_plain:.1f} ms), "
        f"bound {e_bound:.4f} ms")
    mean = lambda xs: sum(xs) / len(xs)
    shares = {"A": mean(a_bound) / mean(a_ms), "D": mean(d_bound) / mean(d_ms),
              "C": c_bound / c_ms, "E": e_bound / e_ms}
    say("  share of the bound (bound ms / ms): " + ", ".join(
        f"kernel {k} {100 * v:.2f}%" for k, v in shares.items()))
    for k in ("C", "E"):
        say(f"  kernel {k}: {kce['in_flight'][k]} lanes in flight; lanes run "
            f"per query (cold whole-order sweep): {kce['ran'][k]}")
    say(f"  host rounds: {loop['launches']} rounds, wall per round less "
        f"kernel A {loop['loop_ms_per_round']:.4f} ms, kernel A "
        f"{loop['a_ms'] / loop['launches']:.4f} ms a round")
    return [
        {"name": "dtw_ea_multi_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_fused.cu",
         "replaces": "src/repro/kernels/dtw_band.py:411",
         "max_abs_err": ka["max_abs_err"], "ms": mean(a_ms),
         "plain_ms": mean(a_plain), "bound_ms": mean(a_bound),
         "bound_by": "operations", "library_ms": None},
        {"name": "lb_keogh_all_windows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lb_keogh.cu",
         "replaces": "src/repro/kernels/lb_keogh.py:19",
         "max_abs_err": kb["max_abs_err"], "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": b_bound, "bound_by": "operations", "library_ms": None},
        {"name": "dtw_ea_persistent_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_persistent.cu",
         "replaces": "src/repro/kernels/dtw_band.py:479",
         "max_abs_err": kce["max_abs_err"], "ms": c_ms, "plain_ms": c_plain,
         "bound_ms": c_bound, "bound_by": bound_by(kce["cells"], c_bound),
         "library_ms": None},
        {"name": "dtw_ea_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_slab.cu",
         "replaces": "src/repro/kernels/dtw_band.py:370",
         "max_abs_err": kd["max_abs_err"], "ms": mean(d_ms),
         "plain_ms": mean(d_plain), "bound_ms": mean(d_bound),
         "bound_by": "operations", "library_ms": None},
        {"name": "dtw_ea_persistent", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_persistent.cu",
         "replaces": "src/repro/kernels/dtw_band.py:479",
         "max_abs_err": kce["max_abs_err"], "ms": e_ms, "plain_ms": e_plain,
         "bound_ms": e_bound, "bound_by": bound_by(kce["cells"], e_bound),
         "library_ms": None},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say(f"  ({label}: {time.perf_counter() - t0:.2f} s)")
        return out

    card = timed("phase 1", phase_card, torch)
    timed("phase 2", phase_build)
    from repro_torch.configs.dtw_search import SearchConfig

    cfg = SearchConfig()
    ref, queries = main_path_inputs(torch, cfg, DEVICE)
    plan = cfg.make_plan()
    from repro_torch.search.pipeline import cascade, prepare_queries, prepare_ref

    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb_sorted = cascade(plan, prep, pq.qn)
    kb = timed("phase 3 kernel B", phase_kernel_b, torch, prep, pq, plan)
    ka = timed("phase 3 kernel A", phase_kernel_a, torch, prep, pq, plan,
               order, lb_sorted)
    kd = timed("phase 3 kernel D", phase_kernel_d, torch, prep, pq, plan, ka)
    kce = timed("phase 3 kernels C, E", phase_kernel_ce, torch, prep, pq,
                plan, order, lb_sorted)
    timed("phase 3 repeat", phase_repeat, torch, prep, plan, kb, ka)
    del order, lb_sorted
    host = timed("phase 4 host rounds", phase_end_to_end, torch, cfg, ref,
                 queries, "host")
    loop = timed("phase 4 host loop", host_loop_split, torch, cfg, ref,
                 queries)
    sweep = timed("phase 4 persistent", phase_end_to_end, torch, cfg, ref,
                  queries, "persistent", host)
    slab = timed("phase 4 slab arms", phase_slab_arms, torch, cfg, ref,
                 queries, host, sweep)
    timed("phase 5", phase_cross_check, torch)
    kernels = timed("phase 6", phase_times, torch, kb, ka, kd, kce, loop)
    # Launches on the path that runs each kernel: host rounds (A, B), the
    # persistent sweep (C), the slab arms (D, E).
    launches = dict(host["launches"])
    launches["dtw_ea_persistent_fused"] = sweep["launches"]["dtw_ea_persistent_fused"]
    launches["dtw_ea_multi"] = slab["dtw_ea_multi"]
    launches["dtw_ea_persistent"] = slab["dtw_ea_persistent"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(f"total {time.perf_counter() - t_all:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(card["smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
