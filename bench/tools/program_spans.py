"""The program's own spans and counters, read against a device trace of an
offline cell's window, on the card.

    python3 bench/tools/program_spans.py --workload <cell> --seeds <n> [<n> ...] --seconds 51 --trace 1 --record 0 1

For each seed, and for each value of ``--record`` (in turns: the order
flips from one seed to the next), it runs the cell's set-up and window as
``bench/run.py`` does, without the comparison, and prints one JSON line:
``queries_per_s`` and, with ``--trace 1``, the window's device busy time.
With ``--record 1`` the port's recorder (``repro_torch.spans``) is on
around the window, outside the profiler, so reading its counters at the
end is not traced; with ``--trace 1`` as well the line carries what the
recording reads against the trace (``readings``: each round's issue, the
device's idle time and PyTorch's kernels inside rounds, the lanes launched
live, the windows the cascade pruned, the stages before the first DTW
kernel), the checks of the clock and of the spans (``checks``), the
idle time by the innermost span it fell in and the longest idle gaps so
named; and, from the device trace alone, the idle time before and after
each DTW launch between the host's sync copies. A checkout whose port has
no recorder records nothing and reads the trace alone. The benchmark's
own runs never run this tool.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.trace import COPY_PREFIXES, short_name  # noqa: E402

# The port's hand-written kernels, by name (as ``torch_ops.ms_per_search``
# lists them).
HAND_KERNELS = ("dtw_ea_fused_kernel", "dtw_ea_fused_wide_kernel",
                "dtw_ea_slab_kernel", "dtw_ea_slab_wide_kernel",
                "persistent_sweep", "persistent_init", "persistent_finish",
                "count_bad_starts", "lb_cascade_kernel")
# The DTW kernels A, C, D and E: every hand kernel but the cascade's.
DTW_KERNELS = HAND_KERNELS[:-1]
# The spans that must hold every DTW launch.
DTW_SPANS = ("round", "persistent_sweep")


def recorder():
    """The port's ``spans`` module, or ``None`` where it has none."""
    try:
        return importlib.import_module("repro_torch.spans")
    except ImportError:
        return None


# -- the device trace ---------------------------------------------------------

def device_ops(prof, t0_ns: int, t1_ns: int) -> tuple[list, int]:
    """Every device operation of ``prof`` within the window, clipped to it,
    as ``(start_ns, end_ns, short name)`` in order of start, and the count
    of those outside it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, outside = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a = max(int(e.start_ns()), t0_ns)
        b = min(int(e.start_ns()) + int(e.duration_ns()), t1_ns)
        if b <= a:
            outside += 1
            continue
        ops.append((a, b, short_name(e.name())))
    ops.sort()
    return ops, outside


class Timeline:
    """The union of device operations: busy time within any interval."""

    def __init__(self, ops):
        merged = []
        for a, b, *_ in sorted(ops):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self.starts = [a for a, _ in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def _before(self, t: int) -> int:
        k = bisect.bisect_right(self.starts, t)
        if k == 0:
            return 0
        return self.cum[k] - max(0, self.merged[k - 1][1] - t)

    def busy(self, a: int, b: int) -> int:
        return self._before(b) - self._before(a)

    def idle(self, a: int, b: int) -> int:
        return (b - a) - self.busy(a, b)


def overlap_ns(ivs, spans) -> int:
    """ns of the intervals ``ivs`` that lie within ``spans`` (sorted and
    disjoint)."""
    starts = [s for s, _ in spans]
    total = 0
    for a, b in ivs:
        k = bisect.bisect_left(starts, b) - 1
        while k >= 0 and spans[k][1] > a:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k -= 1
    return total


def outside(ivs, spans) -> int:
    """How many of the intervals ``ivs`` no one of ``spans`` (sorted,
    disjoint) holds."""
    starts = [s for s, _ in spans]
    n = 0
    for a, b in ivs:
        k = bisect.bisect_right(starts, a) - 1
        n += k < 0 or spans[k][1] < b
    return n


# -- what the recording reads ------------------------------------------------

def _ratio(counters: dict, num: str, den: str):
    d = sum(counters.get(den, ()))
    return None if d == 0 else 100.0 * sum(counters.get(num, ())) / d


def readings(spans, counters, ops) -> dict:
    """The six readings of a recording (``spans``, ``counters``) against
    the window's device operations ``ops``; a reading with nothing to read
    is ``None``. Device time goes to a span by overlap on the shared
    clock."""
    rounds = sorted((s, e) for name, s, e, *_ in spans if name == "round")
    n = len(rounds)
    issue = sum(e - s for name, s, e, *_ in spans if name == "round.issue")
    tl = Timeline(ops)
    torch_ops = [(a, b) for a, b, name in ops
                 if not name.startswith(COPY_PREFIXES)
                 and not any(k in name for k in HAND_KERNELS)]
    dtw_starts = [a for a, _, name in ops
                  if any(k in name for k in DTW_KERNELS)]
    stages = []
    for name, s, *_ in spans:
        if name == "search":
            k = bisect.bisect_left(dtw_starts, s)
            if k < len(dtw_starts):
                stages.append(dtw_starts[k] - s)
    per_round = (lambda ns: ns / 1e6 / n) if n else (lambda ns: None)
    return {
        "host_rounds.issue_ms_per_round": per_round(issue),
        "host_rounds.idle_ms_per_round": per_round(
            sum(tl.idle(s, e) for s, e in rounds)),
        "host_rounds.torch_ops_ms_per_round": per_round(
            overlap_ns(torch_ops, rounds)),
        "host_rounds.live_lane_pct": _ratio(
            counters, "host_rounds.live_lanes", "host_rounds.lanes_launched"),
        "cascade.pruned_pct": _ratio(counters, "cascade.pruned",
                                     "cascade.windows"),
        "stages.ms_per_search": (sum(stages) / len(stages) / 1e6
                                 if stages else None),
    }


def innermost(spans, t: int) -> str | None:
    """The innermost span the host was in at ``t`` (spans nest; the one
    that opened last among those that hold ``t``)."""
    best = None
    for name, s, e, *_ in spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]


def idle_by_span(spans, tl: Timeline) -> dict:
    """Idle device time by the innermost span it fell in: each span's idle
    time less its children's, summed by name, in ns."""
    idle = [tl.idle(s, e) for _, s, e, *_ in spans]
    own = list(idle)
    for i, (_, _, _, parent, _) in enumerate(spans):
        if parent >= 0:
            own[parent] -= idle[i]
    out: dict[str, int] = {}
    for (name, *_), v in zip(spans, own):
        out[name] = out.get(name, 0) + v
    return out


def idle_around_dtw(ops) -> dict:
    """The device's idle time about each DTW launch, on the device's clock
    alone: from the end of the last host-sync copy (``Memcpy DtoH``)
    before the launch to its start (the host's turn of the loop and the
    operations it issues ahead of the kernel; a search's first launch
    also waits out its stages), and from its end to the end of the next
    such copy (the operations issued after it, and the sync). No host
    stamp enters, so the clocks' skew cannot move time between the two.
    In ms a launch; ``None`` without a launch between two copies."""
    tl = Timeline(ops)
    syncs = sorted(b for _, b, name in ops if name.startswith("Memcpy DtoH"))
    before = after = n = 0
    for a, b, name in ops:
        if not any(k in name for k in DTW_KERNELS):
            continue
        i = bisect.bisect_right(syncs, a) - 1
        j = bisect.bisect_left(syncs, b)
        if i < 0 or j == len(syncs):
            continue
        before += tl.idle(syncs[i], a)
        after += tl.idle(b, syncs[j])
        n += 1
    return {"idle_before_dtw_ms": before / 1e6 / n if n else None,
            "idle_after_dtw_ms": after / 1e6 / n if n else None}


def checks(spans, ops, rounds_by_search, window, window_idle_ns) -> dict:
    """Of the clock and the spans: DTW launches outside every round or
    sweep span; each search's round spans against its ``rounds``; idle in
    rounds plus idle outside them (this tool's merge of the operations)
    against ``window_idle_ns``, the window's idle time as the harness's
    ``trace.reduce`` reads the same trace."""
    tl = Timeline(ops)
    t0, t1 = window
    rounds = sorted((s, e) for name, s, e, *_ in spans if name == "round")
    holders = sorted((s, e) for name, s, e, *_ in spans if name in DTW_SPANS)
    dtw = [(a, b) for a, b, name in ops
           if any(k in name for k in DTW_KERNELS)]
    per_search = {}
    for name, _, _, _, sid in spans:
        if name == "round":
            per_search[sid] = per_search.get(sid, 0) + 1
    counted = [per_search.get(i, 0) for i in range(len(rounds_by_search))]
    edges = [t0] + [x for se in rounds for x in se] + [t1]
    idle_out = sum(tl.idle(edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2))
    return {
        "spans": len(spans),
        "dtw_launches": len(dtw),
        "dtw_launches_outside_spans": outside(dtw, holders),
        "round_spans_match_rounds": counted == list(rounds_by_search),
        "idle_in_rounds_s": sum(tl.idle(s, e) for s, e in rounds) / 1e9,
        "idle_outside_rounds_s": idle_out / 1e9,
        "window_idle_s": window_idle_ns / 1e9,
    }


# -- one run -----------------------------------------------------------------

def run_window(cell, seed: int, seconds: float, trace: bool, record: bool,
               device: str = "cuda") -> dict:
    """The cell's set-up and window as ``bench/run.py`` runs them, with the
    profiler (``trace``) and the port's recorder (``record``) on."""
    import torch

    from bench.harness import offline
    from bench.harness import trace as tracing

    on_card = device == "cuda"
    ref_np, pool_np = offline.make_inputs(cell.config, cell.traffic, seed)
    ref = torch.as_tensor(ref_np, device=device)
    pool = [torch.as_tensor(q, device=device) for q in pool_np]
    search = offline.program(cell.config, cell.traffic, device)
    search(ref, pool[0]).best_start.cpu()
    if on_card:
        torch.cuda.synchronize()
    rec_mod = recorder() if record else None
    host = tracing.Spans()
    rounds = []
    prof = (tracing.profiler() if trace and on_card
            else contextlib.nullcontext())
    with (rec_mod.recording() if rec_mod else contextlib.nullcontext()) as rec:
        with prof:
            t0_ns, start = time.time_ns(), time.perf_counter()
            i = 0
            while True:
                with host.span("multi_query_search"):
                    res = search(ref, pool[i % len(pool)])
                with host.span("readback"):
                    res.best_start.cpu()
                    res.best_dist.cpu()
                    rounds.append(int(res.rounds.max()))
                i += 1
                if time.perf_counter() - start >= seconds:
                    break
            window_s = time.perf_counter() - start
            t1_ns = time.time_ns()
    nq = int(cell.config["n_queries"])
    out = {"workload": cell.name, "seed": seed, "trace": int(trace),
           "record": int(rec is not None), "searches": len(rounds),
           "rounds": sum(rounds),
           "window_s": window_s, "queries_per_s": nq * len(rounds) / window_s}
    if rec is not None:
        out["counters"] = {k: sum(v) for k, v in rec.counters.items()}
    if not (trace and on_card):
        return out
    ops, n_out = device_ops(prof, t0_ns, t1_ns)
    tl = Timeline(ops)
    dt = tracing.reduce(prof, host, t0_ns, t1_ns)
    out.update(busy_s=dt.busy_ns / 1e9, device_window_s=dt.window_ns / 1e9,
               device_ops=len(ops), ops_outside_window=n_out,
               **idle_around_dtw(ops))
    if rec is None:
        return out
    out["readings"] = readings(rec.spans, rec.counters, ops)
    out["checks"] = checks(rec.spans, ops, rounds, (t0_ns, t1_ns),
                           dt.window_ns - dt.busy_ns)
    out["idle_by_span_s"] = {k: v / 1e9 for k, v in
                             idle_by_span(rec.spans, tl).items()}
    gaps = [(b - a, a, b) for (_, a), (b, _) in
            zip(tl.merged, tl.merged[1:])]
    top = sorted(gaps, reverse=True)[:10]
    out["idle_gaps"] = [
        [innermost(rec.spans, (a + b) // 2)
         or host.at((a + b) // 2), ns / 1e9] for ns, a, b in top]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), nargs="+",
                   default=[1])
    args = p.parse_args(argv)

    import torch

    from bench.harness import manifest

    cell = manifest.resolve(ROOT, args.workload)
    card = torch.cuda.get_device_name(0)
    for k, seed in enumerate(args.seeds):
        arms = args.record if k % 2 == 0 else args.record[::-1]
        for record in arms:
            out = run_window(cell, seed, args.seconds, bool(args.trace),
                             bool(record))
            out["card"] = card
            print(json.dumps(out), flush=True)
            if "checks" in out:
                c = out["checks"]
                print(f"bench: program spans: {c['spans']} spans, "
                      f"{c['dtw_launches_outside_spans']} of "
                      f"{c['dtw_launches']} DTW launches (A, C) outside "
                      "every round or sweep span", file=sys.stderr,
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
