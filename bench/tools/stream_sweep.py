"""The rate sweep of a streaming cell: the highest arrival rate served
without a growing backlog, on the card.

    python3 bench/tools/stream_sweep.py --workload <cell> --seconds 30 --rates 150000 200000 ...

For each rate it runs the cell's set-up and window as ``bench/run.py``
does (no comparison) and prints one JSON line: the arrival latency's p50
and p95, the generator's lateness in the window's first and last quarter
(a backlog that grows shows as a later last quarter) and how many arrivals
were served. The cell's ``rate`` is set at about four fifths of the highest
rate whose backlog does not grow (``PERF.md``).
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 1)
    args = p.parse_args(argv)

    from bench.harness import manifest
    from bench.harness.stream import StreamRun

    cell = manifest.resolve(ROOT, args.workload)
    for rate in args.rates:
        c = dataclasses.replace(cell, traffic={**cell.traffic, "rate": rate})
        run = StreamRun(c, args.seed, args.seconds, False, "cuda",
                        time.perf_counter())
        run.execute()
        late = np.asarray(run.lateness) * 1e3
        q = max(1, late.size // 4)
        e2e = run.end_to_end()
        print(json.dumps({"rate": rate, "arrivals": run.attempted(),
                          "served": run.served(),
                          "p50_ms": e2e["arrival_p50_ms"],
                          "p95_ms": e2e["arrival_p95_ms"],
                          "late_first_quarter_ms": float(late[:q].mean()),
                          "late_last_quarter_ms": float(late[-q:].mean()),
                          "window_s": run.window_s,
                          "setup_s": run.setup_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
