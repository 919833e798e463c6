"""The benchmark's own command on the card: one short run of each cell
must print a result line with ``correct`` true. Skips where no card is
present."""
import json
import subprocess
import sys

import pytest

from bench.harness import manifest
from bench.tests.tiny import ROOT

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_on_the_card_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483701", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
