"""The port's tooling: the two examples and the import lint.

* ``examples/quickstart_torch.py`` prints what ``examples/quickstart.py``
  prints, line for line, on the CPU;
* ``examples/similarity_search_torch.py`` runs its four suites and its
  stream on the CPU at a tiny size, and its own exactness checks pass;
* ``examples/feature_retrieval_torch.py`` encodes token windows with
  Mamba2 and retrieves the corrupted entry with EAPrunedDTW on the CPU;
* ``examples/train_lm_torch.py`` trains full-width Mamba2 at depth 1 for a
  few steps on the CPU, its loss going down;
* the examples default to the card (they raise without one);
* ``scripts/lint_port.py`` passes on the repository and catches a planted
  ``jax`` or ``repro`` import, a lazy one too.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def _run(*args, env=None):
    out = subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
        timeout=TIMEOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", **(env or {})},
    )
    return out


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_prints_the_quickstart():
    mine = _run("examples/quickstart_torch.py", "--device", "cpu")
    theirs = _run("examples/quickstart.py")
    assert mine.returncode == 0, mine.stderr[-3000:]
    assert theirs.returncode == 0, theirs.stderr[-3000:]
    assert mine.stdout.splitlines() == theirs.stdout.splitlines()
    assert "DTW(S, T) = 9.0" in mine.stdout


def test_similarity_search_torch_runs_on_the_cpu():
    out = _run("examples/similarity_search_torch.py", "--device", "cpu",
               "--ref-len", "3000", "--query-len", "64")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all four suites agree on the nearest neighbour" in out.stdout
    assert "final answers match offline multi_query_search" in out.stdout
    for variant in ("full", "pruned", "eapruned", "eapruned_nolb"):
        assert f"\n{variant} " in out.stdout


def test_feature_retrieval_torch_runs_on_the_cpu():
    out = _run("examples/feature_retrieval_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "retrieved entry 17" in out.stdout
    assert "early-abandoned" in out.stdout


def test_train_lm_torch_runs_on_the_cpu(tmp_path):
    out = _run("examples/train_lm_torch.py", "--device", "cpu", "--steps",
               "12", "--batch", "2", "--seq", "32", "--depth", "1", "--ckpt",
               str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training mamba2-130m depth=1: 42.4M params" in out.stdout
    assert "12 steps in" in out.stdout and "checkpoints in" in out.stdout


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "similarity_search_torch",
                                  "feature_retrieval_torch",
                                  "train_lm_torch"])
def test_examples_default_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


def test_lint_port_passes():
    out = _run("scripts/lint_port.py")
    assert out.returncode == 0, out.stdout
    assert "0 forbidden imports" in out.stdout


def test_lint_port_catches_planted_imports(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (tmp_path / "examples").mkdir()
    (pkg / "ok.py").write_text("import torch\nfrom repro_torch import x\n")
    (pkg / "lazy.py").write_text("def f():\n    import jax.numpy as jnp\n")
    (tmp_path / "chip_smoke.py").write_text("from repro.search import y\n")
    (tmp_path / "examples" / "demo_torch.py").write_text("import jaxlib\n")
    (tmp_path / "examples" / "demo.py").write_text("import jax\n")
    out = _run("scripts/lint_port.py", str(tmp_path))
    assert out.returncode == 1
    bad = [x for x in out.stdout.splitlines() if "imports" in x
           and not x.startswith("lint_port")]
    assert sorted(x.split(": imports ")[1] for x in bad) == [
        "jax.numpy", "jaxlib", "repro.search"]
