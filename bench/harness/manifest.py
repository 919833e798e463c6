"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
comparison or one per-layer metric sits in a file of its own, found by the
name in ``BENCHMARK.json``:

- a configuration: the manifest entry's ``file`` (``bench/configs/``);
- a traffic mix: ``bench/traffic/<traffic>.json``, read by the one
  generator of its ``kind`` (``bench/harness/<kind>.py``);
- a cell's comparison (how many answers the reference certifies, and the
  limit of each number compared): ``bench/checks/<cell>.json``;
- a per-layer metric: its reader ``bench/metrics/<metric>.py``.

A later change adds a cell, a mix or a metric by adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file's contents
    traffic: dict       # the traffic mix's parameters (``kind`` says which generator)
    check: dict         # the comparison's sample sizes and limits
    end_to_end: list    # the manifest's end-to-end entries this cell reports
    per_layer: list     # the manifest's per-layer entries this cell reports


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of the manifest under ``root``, with its files."""
    root = Path(root)
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    conf = configs[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads(
        (root / "bench" / "checks" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    # A per-layer metric without ``workloads`` is read in every cell that
    # reports the end-to-end metric it moves.
    per_layer = [m for m in man["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check, end_to_end=e2e,
                per_layer=per_layer)


def reader(root: Path, metric: str):
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
