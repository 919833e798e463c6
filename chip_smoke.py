#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never ``repro``) on ``cuda:0``:

  1. the card: its name, and its power limit from ``nvidia-smi``;
  2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, with
     ``nvcc``, in parallel;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes: kernel B over the full N = 1e6 ECG reference for 8
     queries of l = 1024, w = 102; kernel A over the lane sets and ``ub``s of
     the first 3 host rounds of that search, with ``use_cb`` on and off;
     then repeatability: ``window_stats`` and both kernels, run again on the
     same inputs, must give the same bits (a 1-D ``torch.cumsum``, which
     ``window_stats`` does not use on the card, is shown beside them);
  4. the main path end to end: ``multi_query_search`` at the ``SearchConfig``
     defaults (ECG, N = 1,000,000, l = 1024, w = 102, Q = 8, batch = 256,
     ``eapruned``, host rounds), with both kernels' launch counts set to 0
     just before and read just after; each winner's distance is recomputed
     with the DP oracle, and the search run once more must give the same
     bits;
  5. the same search at N = 50,000, l = 256, w = 25, Q = 4 on the card and
     with ``device="cpu"``, for ``eapruned`` and ``eapruned_nolb``;
  6. per-kernel times with CUDA events beside the plain versions' times;
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

# Tolerances, each with its reason.
# Kernel B: a window's LB_Keogh sums l = 1024 terms; the kernel adds them in
# order with FMAs, the plain version by torch's tree reduction: O(l) ulp at
# worst, so 1e-4 of the bound (or of 1, for bounds below 1).
TOL_B = 1e-4
# Kernel A: the closed-form row P + cummin(d - P) cancels. P, the row's
# running cost sum across the band, reaches ~1e3-1e4 at l = 1024, w = 102,
# where a distance is ~10, so one ulp of P is ~1e-4 of the distance, and
# the kernel (tree-order block scans, FMAs) and the plain version
# (sequential cumsum) round P differently on every row: 1e-3 relative. A
# lane whose distance lies within that of its ub may abandon on one side.
TOL_A = 1e-3
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


def phase_kernel_a(torch, prep, pq, plan) -> dict:
    from repro_torch.core.common import clamp_sigma
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain
    from repro_torch.search.incumbents import initial_state, fold_min
    from repro_torch.search.pipeline import cascade

    order, lb_sorted = cascade(plan, prep, pq.qn)
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
            fk, fp = torch.isfinite(k), torch.isfinite(p)
            near_ub = torch.zeros_like(fk)
            for d, f in ((k, fk), (p, fp)):
                near_ub |= f & ((d - ub).abs() <= TOL_A * ub.abs().clamp_min(1.0))
            mismatched = (fk != fp) & ~near_ub
            both = fk & fp
            abs_err = float((k[both] - p[both]).abs().max()) if both.any() else 0.0
            rel = rel_err(k[both], p[both]) if both.any() else 0.0
            worst_abs = max(worst_abs, abs_err)
            say(f"[3 kernel A] round {r} use_cb={use_cb}: "
                f"{int(fk.sum())}/{fk.numel()} lanes finish "
                f"(plain {int(fp.sum())}), masks differ on "
                f"{int((fk != fp).sum())} lanes ({int(near_ub.sum())} near ub), "
                f"max abs err {abs_err:.3e}, max rel err {rel:.3e} (tol {TOL_A}); "
                f"plain counts {int(rows.sum())} rows, {int(cells.sum())} cells")
            check(int(mismatched.sum()) == 0,
                  f"kernel A abandon masks differ away from ub (round {r})")
            check(rel <= TOL_A, f"kernel A rel err {rel} > {TOL_A}")
            if use_cb:
                rounds.append({"args": args, "env": env, "cells": int(cells.sum()),
                               "lanes": k.numel(), "bw": bw})
                d_fold = torch.where(torch.isfinite(lbs), k, float("inf"))
        state, _ = fold_min(state, starts, d_fold)
    return {"rounds": rounds, "max_abs_err": worst_abs}


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


def phase_end_to_end(torch, cfg, ref, queries) -> dict:
    from repro_torch.core.common import norm_window_slice
    from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw_banded
    from repro_torch.kernels import ops
    from repro_torch.search import multi_query_search
    from repro_torch.search.pipeline import prepare_queries, prepare_ref

    plan = cfg.make_plan()
    ops.lb_keogh_all_windows.launches = 0
    ops.dtw_ea_multi_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = multi_query_search(
        ref, queries, cfg.query_len, cfg.window, variant=cfg.variant,
        batch=cfg.batch, warm_start=cfg.warm_start, device=DEVICE,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lb_keogh_all_windows": ops.lb_keogh_all_windows.launches,
                "dtw_ea_multi_fused": ops.dtw_ea_multi_fused.launches}
    say(f"[4 end to end] multi_query_search N={cfg.ref_len} l={cfg.query_len} "
        f"w={cfg.window} Q={cfg.n_queries} batch={cfg.batch} {cfg.variant} "
        f"host rounds: {wall:.3f} s wall; launches {launches}")
    starts = res.best_start.tolist()
    dists = res.best_dist.tolist()
    say(f"  best_start {starts}")
    say(f"  best_dist {dists}")
    say(f"  rounds {res.rounds.tolist()} lanes {res.lanes.tolist()} "
        f"quarantined {int(res.quarantined)}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    n_win = cfg.ref_len - cfg.query_len + 1
    check(all(0 <= s < n_win for s in starts), "best_start out of range")
    check(bool(torch.isfinite(res.best_dist).all()), "non-finite best_dist")
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
    again = multi_query_search(
        ref, queries, cfg.query_len, cfg.window, variant=cfg.variant,
        batch=cfg.batch, warm_start=cfg.warm_start, device=DEVICE,
    )
    same = (torch.equal(again.best_start, res.best_start)
            and torch.equal(again.best_dist, res.best_dist))
    say(f"  the search run again: same bits {same}")
    check(same, "the search is not repeatable on the card")
    return {"wall_s": wall, "launches": launches}


def phase_cross_check(torch) -> None:
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.search import multi_query_search

    c = CROSS
    ref = make_dataset(DATASET, c["ref_len"], seed=0).astype(np.float32)
    qs = make_queries(DATASET, c["n_queries"], c["query_len"], seed=1)
    qs = qs.astype(np.float32)
    for variant in ("eapruned", "eapruned_nolb"):
        out = {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            out[dev] = multi_query_search(
                ref, qs, c["query_len"], c["window"], variant=variant,
                batch=256, device=dev,
            )
            torch.cuda.synchronize()
            say(f"[5 cross-check] {variant} {dev}: "
                f"{time.perf_counter() - t0:.2f} s, best_start "
                f"{out[dev].best_start.tolist()}")
        g, h = out[DEVICE], out["cpu"]
        check(g.best_start.cpu().tolist() == h.best_start.tolist(),
              f"{variant}: best_start differs between card and CPU")
        check(int(g.quarantined) == int(h.quarantined),
              f"{variant}: quarantine counts differ")
        rel = rel_err(g.best_dist.cpu(), h.best_dist)
        say(f"  {variant}: best_dist max rel err {rel:.3e} (tol {TOL_CROSS})")
        check(rel <= TOL_CROSS, f"{variant}: distances differ")


def phase_times(torch, kb: dict, ka: dict) -> list[dict]:
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain
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

    a_ms, a_plain, a_bound = [], [], []
    for i, r in enumerate(ka["rounds"]):
        a_ms.append(cuda_ms(lambda: ops.dtw_ea_multi_fused(*r["args"], **r["env"]), 5))
        a_plain.append(host_ms(lambda: dtw_ea_fused_plain(*r["args"], r["bw"], **r["env"])))
        m = r["args"][-1]
        nbytes = 4 * (r["lanes"] * (m + 5) + 3 * r["args"][0].numel())
        ops_a = FLOPS_PER_CELL * r["cells"]
        a_bound.append(max(ops_a / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3)
        say(f"  kernel A round {i}: {a_ms[-1]:.3f} ms (plain {a_plain[-1]:.1f} ms), "
            f"bound {a_bound[-1]:.4f} ms ({r['cells']} cells)")
    mean = lambda xs: sum(xs) / len(xs)
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
    from repro_torch.search.pipeline import prepare_queries, prepare_ref

    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    kb = timed("phase 3 kernel B", phase_kernel_b, torch, prep, pq, plan)
    ka = timed("phase 3 kernel A", phase_kernel_a, torch, prep, pq, plan)
    timed("phase 3 repeat", phase_repeat, torch, prep, plan, kb, ka)
    e2e = timed("phase 4", phase_end_to_end, torch, cfg, ref, queries)
    timed("phase 5", phase_cross_check, torch)
    kernels = timed("phase 6", phase_times, torch, kb, ka)
    for k in kernels:
        k["launches"] = e2e["launches"][k["name"]]
    say(f"total {time.perf_counter() - t_all:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(card["smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
