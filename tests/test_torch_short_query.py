"""The UCR Suite's short query (``bench/configs/ucr-ecg-l128-r0.1.json``:
l = 128, w = 12, a band of 25 columns that the one-warp DP row holds at one
column a thread) through ``chip_smoke.py``'s phase 3 short row: kernel B
over every window and kernel A, counter-free and with counters, over the
first host rounds of the N = 1e6 search, each against its plain version;
and a whole search at that geometry against the benchmark's plain
reference (``bench/reference``, plain PyTorch in float64).

On the CPU the phase runs at a small N, where each wrapper runs its plain
version, so it checks the phase's own steps. On the card (``card``
marker) it runs at full size against the kernels; this file imports no
JAX: run it there with ``PYTHONPATH=src python -m pytest --noconftest -m
card tests/test_torch_short_query.py``.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from bench.reference import series
from bench.reference.search import Reference
from repro_torch.search.multi import multi_query_search

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda")


def _assert_short_row(out):
    assert out["tag"] == "l=128 w=12 bw=32 CPT=1"
    rounds = out["ka"]["rounds"]
    assert len(rounds) == chip_smoke.KERNEL_A_ROUNDS
    assert all(r["bw"] == 32 and r["lanes"] == 8 * 256 for r in rounds)
    assert out["kb"]["args"][-1] == 128


def test_the_short_row_phase_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SHORT_ROW",
                        dict(chip_smoke.SHORT_ROW, ref_len=4000))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # The counters' plain reference on the round's lanes alone: the copies
    # only set the order a card's cumsum adds in.
    monkeypatch.setattr(chip_smoke, "COUNT_COPIES", 0)
    _assert_short_row(chip_smoke.phase_short_row(torch))


@pytest.mark.card
def test_kernels_b_and_a_at_the_short_query_are_their_plain_versions(card):
    # Any check of the phase that fails raises.
    _assert_short_row(chip_smoke.phase_short_row(torch))


def test_reference_agrees_with_the_port_at_the_short_query():
    l, w = 128, 12
    ref = series.make_dataset("ECG", 4000, 3).astype(np.float32)
    qs = series.make_queries("ECG", 4, l, seed=3).astype(np.float32)
    res = multi_query_search(ref, qs, l, w, batch=32, device="cpu")
    starts, dists = Reference(ref, l, w, "cpu", budget=8 << 20).search(qs)
    assert res.best_start.tolist() == starts
    # The port's DP row adds in float32, the reference's in float64.
    np.testing.assert_allclose(res.best_dist.double().numpy(), dists,
                               rtol=1e-3)
