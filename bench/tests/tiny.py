"""Tiny sizes at which the benchmark's cells run on the CPU in tests."""
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

OVERRIDES = {
    "config": {"ref_len": 5000, "query_len": 64},
    "traffic": {"query_sets": 2, "warm_samples": 3000, "rate": 20000,
                "max_arrival": 500, "stream_chunk": 256},
    "check": {"certify": 8, "certify_arrivals": 3, "least_work_lanes": 64},
}
SEED = 2**31 + 977


def run(name: str, wrap=None, trace: bool = False, seconds: float = 0.2,
        overrides=OVERRIDES, root=ROOT):
    """``runner.run_cell`` on the CPU; returns ``(result, lines)``."""
    from bench.harness import runner

    return runner.run_cell(root, name, SEED, seconds, trace, "cpu",
                           time.perf_counter(), overrides=overrides,
                           wrap=wrap)


def stream_root(tmp: Path) -> Path:
    """A copy of the benchmark's data under ``tmp`` whose manifest holds the
    streaming cell, which ``BENCHMARK.json`` leaves out (``PERF.md`` §7),
    with its two end-to-end and two per-layer metrics."""
    import json
    import shutil

    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, tmp / "bench" / sub)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "ecg-l1024-r0.1.stream"
    man["workloads"].append({"name": cell, "config": "ucr-ecg-l1024-r0.1",
                             "traffic": "stream-poisson", "chips": 1,
                             "why": "streaming arrivals"})
    for name in ("arrival_p95_ms", "arrival_p50_ms"):
        man["end_to_end"].append({"name": name, "unit": "ms",
                                  "better": "lower", "bound": 0.25,
                                  "source": "host_clock", "workloads": [cell]})
    for name in ("device_idle_pct.stream", "stream.device_ms_per_arrival"):
        man["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                 "source": "device_trace", "layer": "stream",
                                 "moves": "arrival_p95_ms",
                                 "workloads": [cell]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp
