"""One run of one cell: set-up, the window, the comparison, the readers.

``run_cell`` returns the result line and the comparison's lines; ``run.py``
checks for the card and prints them. Tests call it on the CPU at a tiny
size, with ``wrap`` breaking the timed path underneath.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from functools import cached_property
from pathlib import Path

from bench.harness import checks as checking
from bench.harness import manifest
from bench.reference import bounds

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def jax_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(JAX_NAMES))


def note(msg: str) -> None:
    """A line for the run's log (standard error), before the comparison's."""
    print(f"bench: {msg}", file=sys.stderr, flush=True)


class Context:
    """What a per-layer reader may read: the device trace, the run's own
    counts and the least work of its window (counted on first use)."""

    def __init__(self, run, checked, ref, check: dict, seed: int):
        self.run = run
        self.trace = run.device_trace
        self._checked, self._ref = checked, ref
        self._check, self._seed = check, seed

    @cached_property
    def least_work(self) -> dict:
        import torch

        from bench.reference.search import Reference

        ref = self._ref
        count_ref = Reference(self.run.ref_np, ref.length, ref.window,
                              ref.device, dtype=torch.float32,
                              stats_dtype=torch.float64, budget=ref.budget)
        lw = checking.least_work(self.run, ref, count_ref, self._checked,
                                 int(self._check["least_work_lanes"]),
                                 self._seed)
        cfg = self.run.cfg
        n_ref, l, nq = int(cfg["ref_len"]), int(cfg["query_len"]), self.run.nq
        nbytes = bounds.least_work_bytes(self.run.n_searches(), n_ref, nq, l,
                                         lw["live"])
        lw["bytes"] = nbytes
        lw["bound_ms"] = bounds.dtw_bound_ms(lw["cells"], nbytes)
        lw["bound_by"] = bounds.bound_by(lw["cells"], lw["bound_ms"])
        return lw


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, overrides: dict | None = None,
             wrap=None) -> tuple[dict, list[str]]:
    """Run cell ``name``; returns ``(result, check_lines)``.

    ``overrides`` (tests) replaces keys of the cell's ``config``,
    ``traffic`` and ``check``; ``wrap`` wraps the program's entry.
    """
    import torch

    from bench.reference.search import Reference

    cell = manifest.resolve(root, name)
    over = overrides or {}
    cell = dataclasses.replace(
        cell, **{k: {**getattr(cell, k), **over.get(k, {})}
                 for k in ("config", "traffic", "check")})
    kind = importlib.import_module(f"bench.harness.{cell.traffic['kind']}")
    run = kind.Run(cell, seed, seconds, trace, device, t0, wrap=wrap)
    run.execute()
    note(f"set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
         f"{run.summary()}")
    if run.device_trace is not None:
        dt = run.device_trace
        note(f"trace: busy {dt.busy_ns / 1e9:.3f} s of {dt.window_ns / 1e9:.3f} s, "
             f"{sum(dt.launches.values())} device operations, "
             f"{dt.outside} outside the window")

    t = time.perf_counter()
    ref = Reference(run.ref_np, int(cell.config["query_len"]),
                    kind.window_of(cell.config), device,
                    budget=(16 << 30) if device == "cuda" else (64 << 20))
    checked = run.compare(ref, cell.check, seed)
    note(f"reference: {len(checked.scored)} answers scored, "
         f"{len(checked.certified)} certified in {time.perf_counter() - t:.1f} s")
    metrics = {}
    if trace:
        t = time.perf_counter()
        ctx = Context(run, checked, ref, cell.check, seed)
        for m in cell.per_layer:
            value = manifest.reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if "least_work" in ctx.__dict__:
            lw = ctx.least_work
            note(f"least work: {lw['cells']:.6g} cells, {lw['live']:.6g} live "
                 f"lanes, bound {lw['bound_ms']:.6g} ms by {lw['bound_by']}")
        note(f"readers: {time.perf_counter() - t:.1f} s")
    else:
        values = run.end_to_end()
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips if device == "cuda" else 0,
           "memory_peak_bytes": run.memory_peak}
    result = {"correct": checked.correct, "attempted": run.attempted(),
              "failed": checked.failed, "metrics": metrics, "device": dev}
    t = run.device_trace
    if trace and t is not None:
        dev["busy_s"] = t.busy_ns / 1e9
        dev["window_s"] = t.window_ns / 1e9
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.top_gaps()}
    result["checks"] = checked.numbers
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checked.numbers.items()]
    return result, lines
