"""The control of a cell's comparison, on the card at the cell's own size.

    python3 bench/tools/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it runs the cell as ``bench/run.py`` does, with one search in
the window, but with the plain reference computed in bfloat16 (window
statistics in float32, the configuration's precision) in the program's
place, and prints one JSON line of the numbers the comparison read and
whether they came out correct. The control has to come out not correct;
its smallest readings are the upper ends the limits are set below
(``PERF.md``). The benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class Result:
    """What the harness reads of a search's result."""

    def __init__(self, best_start, best_dist, rounds):
        self.best_start, self.best_dist, self.rounds = (best_start, best_dist,
                                                        rounds)


def control(cfg: dict, device: str, dtype=None):
    """A wrap that puts the reference, in ``dtype`` (bfloat16), in the
    program's place; each query set is searched once."""
    import torch

    from bench.harness.offline import window_of
    from bench.reference.search import Reference

    dtype = dtype or torch.bfloat16
    done = {}

    def wrap(_search):
        def run(ref, queries):
            key = queries.data_ptr()
            if key not in done:
                r = Reference(ref.cpu().numpy(), int(cfg["query_len"]),
                              window_of(cfg), device, dtype=dtype,
                              stats_dtype=torch.float32,
                              budget=(16 << 30) if device == "cuda" else 64 << 20)
                starts, dists = r.search(queries.cpu().numpy())
                nq = queries.shape[0]
                done[key] = Result(torch.tensor(starts), torch.tensor(dists),
                                   torch.ones(nq, dtype=torch.int64))
            return done[key]
        return run
    return wrap


def stream_control(cfg: dict, device: str, dtype=None):
    """A wrap of ``StreamSearchEngine.ingest`` that puts the reference, in
    ``dtype`` (bfloat16), in the engine's place: each arrival's new windows
    (the carried ``l - 1`` samples and the arrival) are searched against
    the incumbents carried from earlier arrivals."""
    import numpy as np
    import torch

    from bench.harness.offline import window_of
    from bench.reference.search import Reference

    dtype = dtype or torch.bfloat16
    l, w = int(cfg["query_len"]), window_of(cfg)
    state = {"tail": np.zeros(0, np.float32), "seen": 0}

    def wrap(_ingest, queries):
        nq = queries.shape[0]
        state.setdefault("best", np.full(nq, -1))
        state.setdefault("dist", np.full(nq, np.inf))

        def run(chunk):
            ctx = np.concatenate([state["tail"], chunk.cpu().numpy()])
            offset = state["seen"] - state["tail"].size
            if ctx.size >= l:
                r = Reference(ctx, l, w, device, dtype=dtype,
                              stats_dtype=torch.float32,
                              budget=(16 << 30) if device == "cuda" else 64 << 20)
                qs = r.queries(queries)
                lbs = r.lower_bounds(qs)
                for q in range(nq):
                    thr = state["dist"][q]
                    if not np.isfinite(thr):
                        s0 = int(torch.argmin(lbs[q]))
                        thr = float(r.dtw(qs.z[q:q + 1], torch.tensor(
                            [[s0]], device=r.device))[0, 0])
                        state["best"][q], state["dist"][q] = offset + s0, thr
                    c = r.certify(qs, q, lbs[q], thr)
                    if c.dist < state["dist"][q]:
                        state["best"][q] = offset + c.start
                        state["dist"][q] = c.dist
            state["seen"] += int(chunk.shape[0])
            state["tail"] = ctx[-(l - 1):]
            return (torch.tensor(state["best"]),
                    torch.tensor(state["dist"], dtype=torch.float32))
        return run
    return wrap


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the window (offline: 0, one search)")
    args = p.parse_args(argv)

    from bench.harness import manifest, runner

    cell = manifest.resolve(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        make = (stream_control if cell.traffic["kind"] == "stream"
                else control)
        result, lines = runner.run_cell(
            ROOT, args.workload, seed, args.seconds, False, "cuda", t0,
            wrap=make(cell.config, "cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16",
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
