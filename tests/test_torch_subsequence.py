"""Single-query search of the port against ``repro`` on the CPU.

``repro_torch.search.subsequence_search`` (``device="cpu"``) against
``repro.search.subsequence_search`` with ``backend="jax"``: the Q=1 case of
the multi-query core. Tolerances as in ``test_torch_search.py``:
``best_start`` and quarantine counts exactly, distances ``rtol=1e-4``
(each side computes its own float32 window stats; the ECG-like series
here has O(1) samples).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.search import subsequence_search as r_subsequence
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.launch.search import main as cli_main
from repro_torch.search import subsequence_search

torch.set_num_threads(1)

N, LENGTH, WINDOW, BATCH = 2400, 64, 8, 40  # 2337 windows: ragged


def _data(name, flat=False):
    ref = make_dataset(name, N, seed=4).astype(np.float32)
    if flat:
        ref[900:1100] = ref[900]  # a run of flat windows (sigma == 0)
    return ref, make_queries(name, 1, LENGTH, seed=5)[0].astype(np.float32)


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("name,flat", [("ECG", False), ("PPG", True)])
def test_subsequence_matches_repro(name, flat, variant):
    ref, query = _data(name, flat)
    want = r_subsequence(jnp.asarray(ref), jnp.asarray(query), LENGTH, WINDOW,
                         variant=variant, batch=BATCH, backend="jax")
    got = subsequence_search(ref, query, LENGTH, WINDOW, variant=variant,
                             batch=BATCH, device="cpu")
    assert got.best_start.dim() == 0
    assert int(got.best_start) == int(want.best_start)
    assert int(got.quarantined) == int(want.quarantined) == 0
    assert float(got.best_dist) == pytest.approx(float(want.best_dist), rel=1e-4)
    assert int(got.rows) == -1 and int(got.cells) == -1


def test_subsequence_nan_burst():
    ref, query = _data("ECG")
    ref[2000:2003] = np.nan
    want = r_subsequence(jnp.asarray(ref), jnp.asarray(query), LENGTH, WINDOW,
                         batch=BATCH, backend="jax")
    got = subsequence_search(ref, query, LENGTH, WINDOW, batch=BATCH,
                             device="cpu")
    assert int(got.best_start) == int(want.best_start)
    assert int(got.quarantined) == int(want.quarantined) == 2 + LENGTH


def test_subsequence_unported_paths_raise():
    """The baselines and the counters, once refused here, now run and find
    the EA search's winner (``tests/test_torch_baselines.py`` and
    ``tests/test_torch_counters.py`` hold them against ``repro``); a
    multivariate query still raises, naming ``repro``'s own failure."""
    ref, query = _data("ECG")
    ea = subsequence_search(ref, query, LENGTH, WINDOW, batch=BATCH,
                            device="cpu")
    for kw in (dict(variant="full"), dict(variant="pruned"),
               dict(with_info=True)):
        got = subsequence_search(ref, query, LENGTH, WINDOW, batch=BATCH,
                                 device="cpu", **kw)
        assert int(got.best_start) == int(ea.best_start)
        assert (int(got.rows) > 0) == ("with_info" in kw)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        subsequence_search(ref, np.stack([query, query], 1), LENGTH, WINDOW,
                           device="cpu")


def test_launch_cli_on_cpu(capsys):
    cli_main(["--ref-len", "1500", "--query-len", "32", "--batch", "32",
              "--variant", "all", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert "eapruned       q0: start=" in out and "eapruned_nolb  q0:" in out
