"""The port's spans and counters (``repro_torch.spans``) on the CPU.

A recording must hold the search's stages and rounds as nested spans, one
search id a search; count the rounds the result reports, the lanes the
round loop launched live and the windows the cascade pruned; leave every
result bit for bit as it is without one; and record nothing when off. On
the card (``card`` marker), a search's replayed rounds keep their spans
and count the graph's capture and replays; this file imports no JAX: run
it there with ``PYTHONPATH=src python -m pytest --noconftest -m card
tests/test_torch_spans.py``.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.core.common import BIG
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import multi_query_search, pipeline, subsequence_search
from repro_torch.serve.stream import StreamSearchEngine

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda")

N, LENGTH, WINDOW, Q, BATCH = 3000, 48, 5, 3, 32  # 2953 windows: ragged


def _data():
    ref = make_dataset("ECG", N, seed=0).astype(np.float32)
    return ref, make_queries("ECG", Q, LENGTH, seed=1).astype(np.float32)


def _search(**kw):
    ref, queries = _data()
    return multi_query_search(ref, queries, LENGTH, WINDOW, batch=BATCH,
                              device="cpu", **kw)


def _named(rec, name):
    return [s for s in rec.spans if s[0] == name]


def test_spans_nest_and_carry_one_search_id_per_search():
    ref, queries = _data()
    with spans.recording() as rec:
        _search()
        _search(rounds="persistent")
        subsequence_search(ref, queries[0], LENGTH, WINDOW, batch=BATCH,
                           device="cpu")
    roots = [i for i, s in enumerate(rec.spans) if s[0] == spans.SEARCH]
    assert [rec.spans[i][4] for i in roots] == [0, 1, 2]
    assert rec.n_searches == 3
    for i, (name, start, end, parent, sid) in enumerate(rec.spans):
        assert start <= end
        if name == spans.SEARCH:
            assert parent == -1
            continue
        assert 0 <= parent < i
        p = rec.spans[parent]
        assert p[1] <= start and end <= p[2] and p[4] == sid
    parents = {}
    for name, _, _, parent, _ in rec.spans:
        if parent >= 0:
            parents.setdefault(name, set()).add(rec.spans[parent][0])
    assert parents == {
        "prepare_ref": {"search"}, "prepare_queries": {"search"},
        "cascade": {"search"}, "host_rounds": {"search"},
        "persistent_sweep": {"search"}, "round": {"host_rounds"},
        "round.issue": {"round"}}
    # Each search's stages, in order.
    for sid, driver in enumerate(("host_rounds", "persistent_sweep",
                                  "host_rounds")):
        top = [s[0] for s in rec.spans
               if s[4] == sid and s[3] >= 0
               and rec.spans[s[3]][0] == spans.SEARCH]
        assert top == ["prepare_ref", "prepare_queries", "cascade", driver]


def _assert_round_spans(rec, res) -> int:
    """One ``round`` and one ``round.issue`` span a round, the issue inside
    its round; returns the rounds."""
    rounds = int(res.rounds.max())
    assert rounds > 1
    assert len(_named(rec, "round")) == rounds
    assert len(_named(rec, "round.issue")) == rounds
    assert len(_named(rec, "host_rounds")) == 1
    assert rec.counters["host_rounds.lanes_launched"] == [Q * BATCH * rounds]
    assert len(rec.counters["host_rounds.live_lanes"]) == 1
    # A round's sync closes its issue: the issue ends before the round.
    for name, start, end, parent, _ in _named(rec, "round.issue"):
        assert rec.spans[parent][1] <= start and end <= rec.spans[parent][2]
    return rounds


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_round_spans_count_the_rounds_of_a_search(variant):
    with spans.recording() as rec:
        res = _search(variant=variant)
    _assert_round_spans(rec, res)
    # On the CPU every round runs eagerly: no graph, so no graph counters.
    assert "host_rounds.graph_rounds" not in rec.counters
    assert "host_rounds.graph_captures" not in rec.counters


@pytest.mark.card
@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_round_spans_and_graph_counters_on_the_card(card, variant):
    """On the card the first rounds run eagerly and every later one is a
    replay of the round captured once; the spans keep their contract."""
    ref, queries = _data()
    with spans.recording() as rec:
        res = multi_query_search(ref, queries, LENGTH, WINDOW, batch=BATCH,
                                 variant=variant, device=card)
    rounds = _assert_round_spans(rec, res)
    assert rounds > pipeline.GRAPH_AFTER_ROUNDS
    assert rec.counters["host_rounds.graph_captures"] == [1]
    assert rec.counters["host_rounds.graph_rounds"] == \
        [rounds - pipeline.GRAPH_AFTER_ROUNDS]


def test_the_persistent_sweep_is_recorded_instead_of_rounds():
    with spans.recording() as rec:
        res = _search(rounds="persistent")
    assert len(_named(rec, "persistent_sweep")) == 1
    assert not _named(rec, "round") and not _named(rec, "host_rounds")
    assert "host_rounds.live_lanes" not in rec.counters
    assert rec.counters["cascade.pruned"] == [int(res.lb_pruned.sum())]
    assert rec.counters["cascade.windows"] == [Q * (N - LENGTH + 1)]


def _recount_live_lanes():
    """The round loop's live lanes, replayed from the same order, bounds
    and incumbents: every window's distance comes from the same row with
    no bound (``ub = BIG``), and a round lowers a query's incumbent to the
    least distance of its live lanes."""
    ref, queries = _data()
    plan = pipeline.make_plan(length=LENGTH, window=WINDOW, batch=BATCH)
    prep = pipeline.prepare_ref(plan, torch.as_tensor(ref))
    pq = pipeline.prepare_queries(plan, torch.as_tensor(queries))
    order, lb_sorted = pipeline.cascade(plan, prep, pq.qn)
    d, _ = pipeline._dtw_round(plan, prep, pq, order,
                               torch.full(order.shape, BIG), use_cb=False)
    nq, n_win = order.shape
    n_rounds = -(-n_win // BATCH)
    pad = n_rounds * BATCH - n_win
    lb = np.pad(lb_sorted.numpy(), ((0, 0), (0, pad)),
                constant_values=np.inf)
    d = np.pad(d.numpy(), ((0, 0), (0, pad)), constant_values=np.inf)
    ub = np.full(nq, BIG, np.float32)
    r = np.zeros(nq, np.int64)
    active = lb[:, 0] < ub
    live_lanes = iterations = 0
    while active.any():
        iterations += 1
        for q in np.flatnonzero(active):
            cols = slice(r[q] * BATCH, (r[q] + 1) * BATCH)
            live = lb[q, cols] < ub[q]
            live_lanes += int(live.sum())
            if live.any():
                ub[q] = min(ub[q], d[q, cols][live].min())
            r[q] += 1
            active[q] = r[q] < n_rounds and lb[q, r[q] * BATCH] < ub[q]
    return live_lanes, iterations, ub


def test_live_lanes_equal_a_recount_from_the_same_order():
    with spans.recording() as rec:
        res = _search()
    live_lanes, iterations, ub = _recount_live_lanes()
    np.testing.assert_array_equal(res.best_dist.numpy(), ub)
    assert iterations == int(res.rounds.max())
    assert sum(rec.counters["host_rounds.live_lanes"]) == live_lanes
    launched = sum(rec.counters["host_rounds.lanes_launched"])
    assert launched == Q * BATCH * iterations
    assert 0 < live_lanes < launched


@pytest.mark.parametrize("rounds", ["host", "persistent"])
def test_cascade_pruned_is_the_sum_of_lb_pruned(rounds):
    with spans.recording() as rec:
        a = _search(rounds=rounds)
        b = _search(rounds=rounds, variant="eapruned_nolb")
    assert rec.counters["cascade.pruned"] == [int(a.lb_pruned.sum()),
                                              int(b.lb_pruned.sum())]
    assert rec.counters["cascade.pruned"][0] > 0
    assert rec.counters["cascade.windows"] == [Q * (N - LENGTH + 1)] * 2


@pytest.mark.parametrize("rounds", ["host", "persistent"])
def test_results_are_bit_equal_on_and_off_and_nothing_is_recorded_off(
        rounds):
    off = _search(rounds=rounds, warm_start=4)
    with spans.recording() as rec:
        on = _search(rounds=rounds, warm_start=4)
    n = len(rec.spans)
    again = _search(rounds=rounds, warm_start=4)
    assert spans._current is None
    assert len(rec.spans) == n and rec.n_searches == 1
    for a, b, c in zip(off, on, again):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    # Off: one shared context manager, whatever the name; counting is a no-op.
    assert spans.span("round") is spans.span("cascade")
    spans.count("cascade.pruned", 1)
    assert spans._current is None


class _Ops(TorchDispatchMode):
    """Counts every ATen operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_recording_adds_no_operation_to_a_search():
    """With a recording on, a search runs its own operations and, of its
    own, only the live-lane tally: one zeroed tensor a round loop and one
    add a round. The other counters keep the tensors the search made, and
    are read when the recording ends."""
    with _Ops() as off:
        res = _search()
    with spans.recording():
        with _Ops() as on:
            _search()
    rounds = int(res.rounds.max())
    assert rounds > 1
    assert on.ops - off.ops == Counter({"aten.zeros.default": 1,
                                        "aten.add_.Tensor": rounds})
    assert off.ops - on.ops == Counter()


def test_a_stream_ingest_runs_with_recording_on():
    ref, queries = _data()
    kw = dict(batch=BATCH, stream_chunk=400, device="cpu")
    plain = StreamSearchEngine(queries, LENGTH, WINDOW, **kw)
    traced = StreamSearchEngine(queries, LENGTH, WINDOW, **kw)
    with spans.recording() as rec:
        for i in range(0, N, 700):
            traced.ingest(ref[i:i + 700])
    for i in range(0, N, 700):
        plain.ingest(ref[i:i + 700])
    for a, b in zip(plain.best(), traced.best()):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert rec.n_searches == 0 and not _named(rec, spans.SEARCH)
    assert {s[0] for s in rec.spans} == {"round", "round.issue"}
    assert {s[4] for s in rec.spans} == {-1}
    # One value an ingest's round loop, its rounds' lanes in it.
    live = rec.counters["host_rounds.live_lanes"]
    launched = rec.counters["host_rounds.lanes_launched"]
    assert len(live) == len(launched) > 1
    assert sum(launched) == Q * BATCH * len(_named(rec, "round"))
    assert all(0 <= a <= b for a, b in zip(live, launched))
