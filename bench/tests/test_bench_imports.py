"""No module that the benchmark loads is JAX or the JAX package, compared
by whole top-level names (``repro_torch`` begins with ``repro`` and is the
program under test)."""
import json
import os
import subprocess
import sys

from bench.tests.tiny import ROOT

# Every module of the harness and the reference, every reader, the control
# and the sweep, and the program's entries that a run drives.
PROBE = r"""
import json, sys, importlib, pathlib
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
for mod in ("bench.harness.manifest", "bench.harness.runner",
            "bench.harness.offline", "bench.harness.stream",
            "bench.harness.trace", "bench.harness.checks",
            "bench.reference.search", "bench.reference.series",
            "bench.reference.bounds", "bench.reference.dtw_row",
            "bench.tools.control", "bench.tools.stream_sweep",
            "repro_torch.search.multi", "repro_torch.serve.stream",
            "repro_torch.kernels.ops"):
    importlib.import_module(mod)
from bench.harness import manifest
for m in manifest.load_manifest(root)["per_layer"]:
    manifest.reader(root, m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_the_benchmark_loads_is_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True, cwd=ROOT)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bench" in tops and "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_harness_sources_import_no_jax():
    import ast

    for path in (ROOT / "bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "repro", "benchmarks"), (path, n)


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    """``run.py`` refuses to print a result once JAX is in ``sys.modules``
    (here the test process's other files load it, or a stand-in does)."""
    import types

    import torch

    from bench import run as entry
    from bench.harness import manifest, runner

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setattr(runner, "run_cell",
                        lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setattr(manifest, "resolve",
                        lambda root, name: types.SimpleNamespace(chips=1))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "USE_FLAX"):
        monkeypatch.setenv(var, os.environ.get(var, ""))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    code = entry.main(["--workload", "x", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code == 3 and out.out == "" and "jax" in out.err
