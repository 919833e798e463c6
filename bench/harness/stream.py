"""Streaming traffic: arrivals of a live series in an open loop.

The generator of every mix of kind ``"stream"``. Set-up makes the seeded
series, builds the configuration's ``StreamSearchEngine`` over one set of
``n_queries`` standing queries (drawn from the mix's ``pool_seed``, the
same for every seed) with the mix's ``stream_chunk``, and ingests
the first ``warm_samples`` samples: the warm incumbents a running
deployment already holds (this also runs every ingest shape). The window
then delivers the series' continuation in arrivals of 1 to
``max_arrival`` samples at Poisson times, ``rate`` samples a second on
average. Every seed gets the same arrival sizes and gaps (drawn once from
``schedule_seed``) in an order of its own, so a seed changes the data and
the order, not the offered load. Each arrival is timed from when it was due
to the host's read of the engine's answer; one thread delivers and serves,
so an arrival that comes due while another is served waits, and that wait
is its lateness. Every arrival due in the window is served, up to
``drain_seconds`` past its close.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench.harness import checks
from bench.harness import trace as tracing
from bench.harness.checks import Answer
from bench.harness.offline import sub_seed, window_of
from bench.reference import series


def schedule(traffic: dict, seconds: float, seed: int):
    """``(sizes, due)``: the window's arrival sizes and due times (seconds
    from its start). Sizes (``rate * seconds`` samples in all) and Poisson
    gaps are drawn once from ``schedule_seed``, the gaps scaled to span the
    window; each seed takes both in an order of its own."""
    rate = float(traffic["rate"])
    base = int(traffic["schedule_seed"])
    sizes = np.asarray(series.arrival_sizes(int(rate * seconds),
                                            int(traffic["max_arrival"]), base))
    gaps = np.random.default_rng([base, 1]).exponential(1.0, sizes.size)
    rng = np.random.default_rng(sub_seed(seed, 3))
    sizes = sizes[rng.permutation(sizes.size)]
    gaps = gaps[rng.permutation(gaps.size)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * seconds / gaps.sum()
    return sizes, due


class StreamRun:
    """One run of a streaming cell (tests and the control pass ``wrap``,
    called with the engine's ``ingest`` and the raw queries)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, t0: float, wrap=None):
        self.cell, self.seed, self.trace = cell, int(seed), bool(trace)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device, self.t0, self.wrap = device, t0, wrap
        self.seconds = float(seconds)

    def execute(self) -> None:
        import torch

        from repro_torch.serve.stream import StreamSearchEngine

        on_card = self.device == "cuda"
        cfg, tr = self.cfg, self.traffic
        sizes, due = schedule(tr, self.seconds, self.seed)
        warm = int(tr["warm_samples"])
        n = warm + int(sizes.sum())
        self.ref_np = series.make_dataset(cfg["dataset"], n,
                                          seed=sub_seed(self.seed, 0)
                                          ).astype(np.float32)
        self.queries_np = series.make_queries(
            cfg["dataset"], int(cfg["n_queries"]), int(cfg["query_len"]),
            seed=sub_seed(int(tr["pool_seed"]), 1, 0)).astype(np.float32)
        ref = torch.as_tensor(self.ref_np, device=self.device)
        eng = StreamSearchEngine(
            self.queries_np, int(cfg["query_len"]), window_of(cfg),
            variant=cfg["variant"], batch=int(cfg["batch"]),
            stream_chunk=int(tr["stream_chunk"]), gather=cfg["gather"],
            device=self.device)
        ingest = (eng.ingest if self.wrap is None
                  else self.wrap(eng.ingest, self.queries_np))
        bs, bd = ingest(ref[:warm])
        self.warm_answer = (bs.cpu().numpy(), bd.cpu().numpy())
        if on_card:
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t0

        spans = tracing.Spans()
        self.latency, self.lateness, self.after = [], [], []
        ends = np.concatenate([[warm], warm + np.cumsum(sizes)])
        prof = (tracing.profiler() if self.trace and on_card
                else contextlib.nullcontext())
        drain = float(tr["drain_seconds"])
        with prof:
            t0_ns, start = time.time_ns(), time.perf_counter()
            for i, (a, b) in enumerate(zip(ends[:-1], ends[1:])):
                now = time.perf_counter() - start
                if now < due[i]:
                    with spans.span("idle"):
                        time.sleep(due[i] - now)
                    now = time.perf_counter() - start
                if now > self.seconds + drain:
                    break
                self.lateness.append(now - due[i])
                with spans.span("ingest"):
                    bs, bd = ingest(ref[a:b])
                with spans.span("readback"):
                    self.after.append((int(b), bs.cpu().numpy(),
                                       bd.cpu().numpy()))
                self.latency.append(time.perf_counter() - start - due[i])
            self.window_s = time.perf_counter() - start
            t1_ns = time.time_ns()
        self.due = due
        self.device_trace = (tracing.reduce(prof, spans, t0_ns, t1_ns)
                             if self.trace and on_card else None)
        self.memory_peak = (int(torch.cuda.max_memory_allocated())
                            if on_card else 0)
        del ref, eng, ingest, prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # -- what the harness reports -------------------------------------------------
    def attempted(self) -> int:
        return int(self.due.size)

    def served(self) -> int:
        return len(self.latency)

    def summary(self) -> str:
        late = np.asarray(self.lateness) * 1e3
        return (f"{self.served()} of {self.attempted()} arrivals served; "
                f"generator late p50 {np.percentile(late, 50):.3f} ms, p95 "
                f"{np.percentile(late, 95):.3f} ms, max {late.max():.3f} ms")

    def end_to_end(self) -> dict:
        lat = np.asarray(self.latency) * 1e3
        return {"setup_s": self.setup_s,
                "arrival_p95_ms": float(np.percentile(lat, 95)),
                "arrival_p50_ms": float(np.percentile(lat, 50))}

    def answers(self) -> list[Answer]:
        """The incumbents after set-up and after each arrival, each distinct
        one once (set 0: the one query set)."""
        seen = set()
        for bs, bd in [self.warm_answer] + [(s, d) for _, s, d in self.after]:
            for q in range(bs.size):
                seen.add(Answer(0, q, int(bs[q]), float(bd[q])))
        return sorted(seen)

    def queries(self, k: int):
        return self.queries_np

    def compare(self, ref, check: dict, seed: int):
        """``no_answer`` (with every arrival left unserved) and ``dist_gap``
        over every distinct incumbent; ``best_gap`` over the warm
        incumbents of ``certify`` queries drawn from the seed, certified
        over the warm prefix, and over every query after
        ``certify_arrivals`` arrivals drawn from the seed, certified over
        the windows that arrival made valid: no window of them may lie
        nearer than the incumbent, and an incumbent that moved must lie
        among them, else it counts under ``no_answer``."""
        from bench.reference.search import Reference

        answers = self.answers()
        bad, scored = checks.score(ref, self, answers)
        bad += self.attempted() - self.served()
        l, w = int(self.cfg["query_len"]), ref.window
        rng = np.random.default_rng([int(seed), 7])
        warm = int(self.traffic["warm_samples"])

        def certify(lo, end, answer, qids):
            """``|d - D*| / D*`` of ``qids``' incumbents ``answer`` (starts,
            distances), ``D*`` the least of the named window's distance and
            every window of ``ref_np[lo:end]``."""
            sub = Reference(self.ref_np[lo:end], l, w, ref.device,
                            budget=ref.budget)
            sq = sub.queries(self.queries_np)
            lbs = sub.lower_bounds(sq)
            out = []
            for q in qids:
                thr = scored.get((0, q, int(answer[0][q])))
                if thr is not None:
                    best = min(sub.certify(sq, q, lbs[q], thr).dist, thr)
                    out.append(abs(float(answer[1][q]) - best) / best)
            return out

        nq = self.queries_np.shape[0]
        gaps = certify(0, warm, self.warm_answer,
                       sorted(rng.choice(nq, min(int(check["certify"]), nq),
                                         replace=False)))
        prev = [(warm, self.warm_answer[0])] + [(e, b) for e, b, _ in self.after]
        n_arr = min(int(check["certify_arrivals"]), len(self.after))
        for i in sorted(rng.choice(len(self.after), n_arr, replace=False)):
            end, best_start, best_dist = self.after[i]
            lo = max(0, prev[i][0] - l + 1)
            for q in range(nq):
                s = int(best_start[q])
                if s != int(prev[i][1][q]) and not lo <= s <= end - l:
                    bad += 1
            gaps += certify(lo, end, (best_start, best_dist), range(nq))
        return checks.judge(check, answers, bad, checks.dist_gap(answers, scored),
                            max(gaps, default=None), scored, {})


Run = StreamRun
