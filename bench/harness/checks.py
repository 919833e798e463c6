"""The comparison that decides ``correct``, and the least work of a window.

Every answer the window produced is held to the plain reference
(``bench/reference/search.py``), which works out the window statistics,
the normalized queries and the bounds again from the raw inputs, in
float64:

- ``no_answer``: answers with no window (a start outside the series) or a
  distance that is not finite; limit 0;
- ``dist_gap``: over every answer, ``|d - D| / D``, with ``d`` the
  distance the program reported and ``D`` the reference's DTW of the
  window it named;
- ``best_gap``: over a sample of answers drawn from the seed,
  ``|d - D*| / D*``, with ``D*`` the least DTW over the whole series, which
  the reference certifies: a window that is not the nearest, or a distance
  that is not its, shows here.

The least work is counted from the same inputs and the certified answers
only, never from a counter of the program, so it reads the same whichever
plan ran (``bench/tests/test_bench_faults.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Answer(NamedTuple):
    set: int        # which query set of the pool
    query: int      # which query of the set
    start: int      # the window the program named
    dist: float     # the distance it reported


class Checked(NamedTuple):
    numbers: dict           # name -> {"value": ..., "limit": ...}
    correct: bool
    failed: int             # answers with no window or no finite distance
    scored: dict            # (set, query, start) -> the reference's DTW
    certified: dict         # (set, query) -> the least DTW over the series


def score(ref, run, answers) -> tuple[int, dict]:
    """``(no_answer, scored)``: the answers with no window or no finite
    distance, and the reference's DTW of each other answer's window, keyed
    ``(set, query, start)``."""
    import torch

    bad = sum(1 for a in answers
              if not (0 <= a.start < ref.n_win and math.isfinite(a.dist)))
    by_set: dict[int, set] = {}
    for a in answers:
        if 0 <= a.start < ref.n_win and math.isfinite(a.dist):
            by_set.setdefault(a.set, set()).add((a.query, a.start))
    scored = {}
    for k, pairs in sorted(by_set.items()):
        pairs = sorted(pairs)
        qs = ref.queries(run.queries(k))
        rows = torch.tensor([q for q, _ in pairs], device=ref.device)
        starts = torch.tensor([[s] for _, s in pairs], device=ref.device)
        d = ref.dtw(qs.z[rows], starts)[:, 0].double().cpu().numpy()
        for (q, s), v in zip(pairs, d):
            scored[(k, q, s)] = float(v)
    return bad, scored


def dist_gap(answers, scored) -> float | None:
    """The largest ``|d - D| / D`` over the scored answers."""
    return max((abs(a.dist - scored[(a.set, a.query, a.start)])
                / scored[(a.set, a.query, a.start)] for a in answers
                if (a.set, a.query, a.start) in scored), default=None)


def judge(check: dict, answers, no_answer: int, gap: float | None,
          best: float | None, scored: dict, certified: dict) -> Checked:
    """The numbers beside their limits, and ``correct``: every number
    read, each at or under its limit."""
    limits = check["limits"]
    numbers = {
        "no_answer": {"value": no_answer, "limit": limits["no_answer"]},
        "dist_gap": {"value": gap, "limit": limits["dist_gap"]},
        "best_gap": {"value": best, "limit": limits["best_gap"]},
    }
    correct = bool(answers) and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in numbers.values())
    return Checked(numbers, correct, no_answer, scored, certified)


def compare(run, ref, check: dict, seed: int) -> Checked:
    """Hold every answer of an offline ``run`` to the reference ``ref``;
    certify ``check["certify"]`` of them."""
    answers = run.answers()
    bad, scored = score(ref, run, answers)
    # The sample to certify: distinct (set, query) pairs drawn from the seed.
    pairs = sorted({(k, q) for (k, q, _) in scored})
    rng = np.random.default_rng([int(seed), 7])
    n = min(int(check["certify"]), len(pairs))
    pick = [pairs[i] for i in sorted(rng.choice(len(pairs), n, replace=False))]
    certified, gaps = {}, []
    lbs = {}
    for k, q in pick:
        qs = ref.queries(run.queries(k))
        if k not in lbs:
            lbs[k] = ref.lower_bounds(qs)
        mine = [a for a in answers if (a.set, a.query) == (k, q)
                and (k, q, a.start) in scored]
        for s in sorted({a.start for a in mine}):
            thr = scored[(k, q, s)]
            c = ref.certify(qs, q, lbs[k][q], thr)
            best = min(c.dist, thr)
            certified[(k, q)] = min(certified.get((k, q), best), best)
        gaps += [abs(a.dist - certified[(k, q)]) / certified[(k, q)]
                 for a in mine]
    return judge(check, answers, bad, dist_gap(answers, scored),
                 max(gaps, default=None), scored, certified)


def least_work(run, ref, count_ref, checked: Checked, lanes: int,
               seed: int) -> dict:
    """The least work of the window's searches: for every query answered,
    the windows whose bound lies at or below its answer, run against the
    answer with the ``cb`` bound, counted with the frozen plain row in
    float32 (``count_ref``). Each query counts ``lanes`` of its live
    windows, drawn from the seed, scaled to all of them; each search adds
    what its queries count."""
    times: dict[tuple[int, int], int] = {}
    answer_of = {}
    for a in run.answers():
        key = (a.set, a.query)
        times[key] = times.get(key, 0) + 1
        if (a.set, a.query, a.start) in checked.scored:
            d = checked.scored[(a.set, a.query, a.start)]
            answer_of[key] = min(answer_of.get(key, d), d)
    for key, d in checked.certified.items():
        answer_of[key] = d
    cells = live = 0.0
    for k in sorted({k for k, _ in times}):
        qids = [q for (kk, q) in sorted(times) if kk == k and (k, q) in answer_of]
        if not qids:
            continue
        qs = ref.queries(run.queries(k))
        lbs = ref.lower_bounds(qs)
        cq = count_ref.queries(run.queries(k))
        sub = type(cq)(*(t[qids] for t in cq))
        counted = count_ref.count(sub, lbs[qids],
                                  [answer_of[(k, q)] for q in qids],
                                  sample=lanes, seed=seed * 1_000_003 + k)
        for q, c in zip(qids, counted):
            n = times[(k, q)]
            scale = c.live / c.ran if c.ran else 0.0
            cells += n * c.cells * scale
            live += n * c.live
    return {"cells": cells, "live": live}
