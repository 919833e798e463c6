"""Offline traffic: one batch user in a closed loop of multi-query searches.

The generator of every mix of kind ``"offline"``. Set-up makes the
reference series from the seed and the pool of ``query_sets`` sets of
``n_queries`` standing queries from the mix's ``pool_seed`` (the frozen
copies of ``make_dataset`` and ``make_queries``), copies them to the card
and runs one warm search. The window then sends one ``multi_query_search``
after another with the configuration's plan, through the pool in its
order and round again, and closes at the end of the first search that ends
``seconds`` or more after it opened: every search in it is whole, and the
rate is all the queries they answered over all of its time. Every seed
searches the same queries in the same order (as the UCR Suite's fixed
query files do); the seed draws the series they are searched in. Queries
drawn from the seed made the work differ from seed to seed by ~5%, ten
times what two runs of one seed differ by (``PERF.md``).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench.harness import trace as tracing
from bench.harness import checks
from bench.harness.checks import Answer
from bench.reference import bounds, series


def window_of(cfg: dict) -> int:
    return int(cfg["query_len"] * cfg["window_ratio"])


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed for a part of a run's inputs, drawn from ``seed``."""
    return int(np.random.SeedSequence([int(seed), *keys]).generate_state(1)[0])


def make_inputs(cfg: dict, traffic: dict, seed: int):
    """The reference series (float32) and the pool of raw query sets."""
    ref = series.make_dataset(cfg["dataset"], int(cfg["ref_len"]),
                              seed=sub_seed(seed, 0)).astype(np.float32)
    pool_seed = int(traffic["pool_seed"])
    pool = [series.make_queries(cfg["dataset"], int(cfg["n_queries"]),
                                int(cfg["query_len"]),
                                seed=sub_seed(pool_seed, 1, k)
                                ).astype(np.float32)
            for k in range(int(traffic["query_sets"]))]
    return ref, pool


def program(cfg: dict, traffic: dict, device: str):
    """The system under test: ``search(ref, queries)`` with the plan."""
    from repro_torch.search.multi import multi_query_search

    length, window = int(cfg["query_len"]), window_of(cfg)

    def search(ref, queries):
        return multi_query_search(
            ref, queries, length, window, variant=cfg["variant"],
            batch=int(cfg["batch"]), rounds=traffic["rounds"],
            gather=cfg["gather"], device=device)

    return search


class OfflineRun:
    """One run of an offline cell: set-up, the window, and what the
    comparison and the per-layer readers need afterwards."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, t0: float, wrap=None):
        self.cell, self.seed, self.trace = cell, int(seed), bool(trace)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = device
        self.t0 = t0
        self.wrap = wrap        # tests: break the timed path underneath
        self.seconds = float(seconds)

    def execute(self) -> None:
        import torch

        on_card = self.device == "cuda"
        ref_np, pool_np = make_inputs(self.cfg, self.traffic, self.seed)
        self.ref_np, self.pool_np = ref_np, pool_np
        ref = torch.as_tensor(ref_np, device=self.device)
        pool = [torch.as_tensor(q, device=self.device) for q in pool_np]
        search = program(self.cfg, self.traffic, self.device)
        if self.wrap is not None:
            search = self.wrap(search)
        search(ref, pool[0]).best_start.cpu()    # warm-up: every shape
        if on_card:
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t0

        spans = tracing.Spans()
        self.searches = []      # (set, best_start, best_dist, rounds)
        self.times = []         # when each search was read back
        prof = (tracing.profiler() if self.trace and on_card
                else contextlib.nullcontext())
        with prof:
            t0_ns, start = time.time_ns(), time.perf_counter()
            self.start = start
            i = 0
            while True:
                k = i % len(pool)
                with spans.span("multi_query_search"):
                    res = search(ref, pool[k])
                with spans.span("readback"):
                    bs = res.best_start.cpu().numpy()
                    bd = res.best_dist.cpu().numpy()
                    rounds = int(res.rounds.max())
                self.searches.append((k, bs, bd, rounds))
                self.times.append(time.perf_counter())
                i += 1
                if time.perf_counter() - start >= self.seconds:
                    break
            self.window_s = time.perf_counter() - start
            t1_ns = time.time_ns()
        self.device_trace = (tracing.reduce(prof, spans, t0_ns, t1_ns)
                             if self.trace and on_card else None)
        self.memory_peak = (int(torch.cuda.max_memory_allocated())
                            if on_card else 0)
        del res, ref, pool, search, prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # -- what the harness reports -------------------------------------------------
    @property
    def nq(self) -> int:
        return int(self.cfg["n_queries"])

    def attempted(self) -> int:
        return self.nq * len(self.searches)

    def end_to_end(self) -> dict:
        return {"setup_s": self.setup_s,
                "queries_per_s": self.attempted() / self.window_s}

    def answers(self) -> list[Answer]:
        out = []
        for k, bs, bd, _ in self.searches:
            for q in range(self.nq):
                out.append(Answer(k, q, int(bs[q]), float(bd[q])))
        return out

    def search_seconds(self) -> list[float]:
        """Each search's wall time in the window, read back included."""
        ends = [self.start, *self.times]
        return [b - a for a, b in zip(ends, ends[1:])]

    def queries(self, k: int):
        return self.pool_np[k]

    def summary(self) -> str:
        return (f"{self.attempted()} answers; seconds a search "
                f"{[round(x, 4) for x in self.search_seconds()]}")

    def compare(self, ref, check: dict, seed: int):
        return checks.compare(self, ref, check, seed)

    # -- per-layer context ----------------------------------------------------------
    def rounds(self) -> int:
        return sum(r for *_, r in self.searches)

    def n_searches(self) -> int:
        return len(self.searches)

    def lb_bound_ms(self) -> float:
        """Kernel B's least time for the window's searches (every window is
        valid: the series is finite)."""
        n_ref = int(self.cfg["ref_len"])
        l = int(self.cfg["query_len"])
        n_win = n_ref - l + 1
        return self.n_searches() * bounds.lb_bound_ms(n_ref, n_win, n_win,
                                                      self.nq, l)


Run = OfflineRun
