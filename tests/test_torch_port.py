"""Package-level rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor ``repro``
  (an AST scan of every module, so a lazy import inside a function counts).
* With no CUDA device and no ``device`` argument, an entry point raises
  rather than carrying on on the CPU.
"""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.dtw_search import CONFIG, SearchConfig
from repro_torch.core.common import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.search import main as cli_main
from repro_torch.search import multi_query_search, pipeline, subsequence_search

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_package():
    assert len(FILES) >= 20
    assert _forbidden("repro.search") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.search")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def must_not_run(*a, **k):
        raise AssertionError("the search ran without a device")

    monkeypatch.setattr(pipeline, "_offline_search_impl", must_not_run)


def test_entry_points_raise_without_cuda(no_cuda):
    ref = np.sin(np.arange(600) / 7.0).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_query_search(ref, ref[None, :32], 32, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        subsequence_search(ref, ref[:32], 32, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--ref-len", "600", "--query-len", "32"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build only with nvcc; without one the build raises (the
    wrappers never fall back to the plain versions on a CUDA tensor)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.library_path("lb_keogh") != _build.library_path("dtw_ea_fused")


def test_search_config_is_the_paper_protocol():
    assert (CONFIG.ref_len, CONFIG.query_len, CONFIG.window, CONFIG.n_queries,
            CONFIG.batch) == (1_000_000, 1024, 102, 8, 256)
    plan = SearchConfig(query_len=64).make_plan(variant="eapruned_nolb")
    assert (plan.length, plan.window, plan.variant) == (64, 6, "eapruned_nolb")
    assert not plan.use_lb and not plan.use_cb


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
