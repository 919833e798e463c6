"""The host round loop's in-place round step, and its captured replay.

``pipeline.run_host_rounds`` runs one round step (``_round_step``) that
reads the loop's state from buffers and writes the next state back into
them, eagerly on the CPU and, on the card, replayed from one captured CUDA
graph a round once the call has run ``GRAPH_AFTER_ROUNDS`` rounds eagerly
(``_capture_now``). On the CPU the step, run to completion, is held bit
for bit to the loop it replaced (``_loop_before``, kept here as it was)
over both variants, both gather modes, with and without counters, cold and
from warm incumbents at a stream offset; and the loop's switch from eager
rounds to replays is held to the eager loop through a stand-in for the
graph that runs the step on each replay. On the card (``card`` marker;
this file imports no JAX: run it there with ``PYTHONPATH=src python -m
pytest --noconftest -m card tests/test_torch_round_graph.py``), the replay
is held bit for bit to the eager loop at both benchmark configurations'
shapes with the reference cut short, a host sync inside the step must
fail the capture, and kernel A counts one launch a replay.
"""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.kernels import ops
from repro_torch.search import multi_query_search, pipeline
from repro_torch.search.incumbents import IncumbentState, fold_min, initial_state

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda")

N, LENGTH, WINDOW, Q, BATCH = 3000, 48, 5, 3, 32  # 2953 windows: ragged


def _loop_before(plan, prep, pq, order, lb_sorted, state0, *,
                 with_info=False, offset=0):
    """``run_host_rounds`` as it was before the in-place step: a fresh
    state a round."""
    nq, n_win = order.shape
    batch = plan.batch
    dev = order.device
    state, pre, rows, cells = pipeline.warm_prepass(
        plan, prep, pq, order, lb_sorted, state0, with_info=with_info,
        offset=offset,
    )
    n_rounds = -(-n_win // batch)
    pad = n_rounds * batch - n_win
    order_p = torch.cat([order, order.new_zeros(nq, pad)], dim=1)
    lb_p = torch.cat([lb_sorted, lb_sorted.new_full((nq, pad), float("inf"))],
                     dim=1)
    active = torch.ones(nq, dtype=torch.bool, device=dev)
    if plan.use_lb:
        active = lb_p[:, 0] < state.ub
    r = torch.zeros(nq, dtype=torch.int64, device=dev)
    lanes = torch.where(active, 0, pre).to(torch.int64)
    cols = torch.arange(batch, device=dev)
    while bool(active.any()):
        idx = torch.clamp_max(r, n_rounds - 1)[:, None] * batch + cols
        starts = order_p.gather(1, idx)
        lbs_b = lb_p.gather(1, idx)
        live = active[:, None] & (lbs_b < state.ub[:, None])
        ub_lanes = pipeline._dead_or(live, state.ub)
        d, info = pipeline._dtw_round(plan, prep, pq, starts, ub_lanes,
                                      use_cb=plan.use_cb, with_info=with_info)
        if with_info:
            rows_q, cells_q = pipeline._query_totals(info, nq, dev)
            rows, cells = rows + rows_q, cells + cells_q
        d = torch.where(torch.isfinite(lbs_b) & active[:, None], d,
                        float("inf"))
        state, _ = fold_min(state, starts, d, offset=offset)
        r_new = r + active.to(r.dtype)
        more = r_new < n_rounds
        if plan.use_lb:
            nxt = lb_p.gather(
                1, torch.clamp_max(r_new, n_rounds - 1)[:, None]
                * batch)[:, 0]
            more = more & (nxt < state.ub)
        lanes = lanes + active.to(lanes.dtype) * batch
        active = active & more
        r = r_new
    if not with_info:
        rows = cells = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    return state, pipeline.SearchStats(
        rounds=r, lanes=lanes, lb_pruned=n_win - torch.clamp_max(lanes, n_win),
        rows=rows, cells=cells,
    )


def _stages(variant, gather, with_info, warm_start, dev="cpu", n=N,
            length=LENGTH, window=WINDOW, nq=Q, batch=BATCH):
    ref = make_dataset("ECG", n, seed=0).astype(np.float32)
    queries = make_queries("ECG", nq, length, seed=1).astype(np.float32)
    plan = pipeline.make_plan(
        length=length, window=window, variant=variant, batch=batch,
        gather=gather, warm_start=warm_start, with_info=with_info,
        allowed_variants=pipeline.MULTI_VARIANTS,
    )
    prep = pipeline.prepare_ref(plan, torch.as_tensor(ref, device=dev))
    pq = pipeline.prepare_queries(plan, torch.as_tensor(queries, device=dev))
    order, lb_sorted = pipeline.cascade(plan, prep, pq.qn)
    return plan, prep, pq, order, lb_sorted


def _assert_equal(want, got):
    (ws, wstats), (gs, gstats) = want, got
    for a, b in zip((*ws, *wstats), (*gs, *gstats)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("with_info", [False, True])
@pytest.mark.parametrize("gather", ["fused", "slab"])
@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_the_in_place_step_gives_the_loop_it_replaced(variant, gather,
                                                      with_info, start):
    warm = start == "warm"
    plan, prep, pq, order, lb_sorted = _stages(variant, gather, with_info,
                                               warm_start=4 if warm else 0)
    offset = -37 if warm else 0     # a stream's first context starts < 0
    state0 = initial_state(Q, torch.float32, best_dtype=order.dtype)
    if warm:
        cold, _ = _loop_before(plan, prep, pq, order, lb_sorted, state0)
        ub = cold.ub * 1.5
        ub[0] = 1e-3                # a seed no window beats: never active
        state0 = IncumbentState(ub=ub, best=torch.tensor([5, 6, 7]))
    keep = IncumbentState(ub=state0.ub.clone(), best=state0.best.clone())
    want = _loop_before(plan, prep, pq, order, lb_sorted, state0,
                        with_info=with_info, offset=offset)
    got = pipeline.run_host_rounds(plan, prep, pq, order, lb_sorted, state0,
                                   with_info=with_info, offset=offset)
    _assert_equal(want, got)
    assert int(got[1].rounds.max()) > 1
    # The step writes into buffers of its own, never into the caller's.
    assert torch.equal(state0.ub, keep.ub)
    assert torch.equal(state0.best, keep.best)


def test_the_loop_captures_only_on_the_card_after_enough_rounds():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    k = pipeline.GRAPH_AFTER_ROUNDS
    assert k >= 1
    assert pipeline._capture_now(cuda, k + 1, 2 * k)
    assert pipeline._capture_now(cuda, k + 1, 10 ** 6)
    # Not before the eager rounds are run, nor again after.
    assert not any(pipeline._capture_now(cuda, n, 10 ** 6)
                   for n in (*range(1, k + 1), k + 2, 10 ** 5))
    # Not where the call cannot run as many rounds again.
    assert not pipeline._capture_now(cuda, k + 1, 2 * k - 1)
    assert not pipeline._capture_now(cpu, k + 1, 10 ** 6)


class _StepReplay:
    """A stand-in for ``pipeline._RoundGraph`` on the CPU: each replay runs
    the step it was given."""

    def __init__(self, step, dev):
        self.step, self.replays = step, 0
        spans.count("host_rounds.graph_captures", 1)

    def replay(self):
        self.step()
        self.replays += 1


@pytest.mark.parametrize("batch", [BATCH, 1024])  # 93 rounds; 3, too few
@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_the_switch_to_replays_keeps_the_eager_loops_results(monkeypatch,
                                                             variant, batch):
    """The loop's rounds before and after the capture, through a stand-in
    that replays by running the step: the eager loop's bits, and the
    rounds past ``GRAPH_AFTER_ROUNDS`` counted as replays."""
    ref = make_dataset("ECG", N, seed=0).astype(np.float32)
    queries = make_queries("ECG", Q, LENGTH, seed=1).astype(np.float32)

    def search():
        with spans.recording() as rec:
            res = multi_query_search(ref, queries, LENGTH, WINDOW,
                                     batch=batch, variant=variant,
                                     device="cpu")
        return res, rec.counters

    eager, e_counters = search()
    capture_now = pipeline._capture_now
    monkeypatch.setattr(pipeline, "_capture_now", lambda dev, *a:
                        capture_now(torch.device("cuda"), *a))
    monkeypatch.setattr(pipeline, "_RoundGraph", _StepReplay)
    replayed, counters = search()
    for a, b in zip(eager, replayed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rounds, k = int(eager.rounds.max()), pipeline.GRAPH_AFTER_ROUNDS
    n_rounds = -(-(N - LENGTH + 1) // batch)
    if n_rounds >= 2 * k:
        assert rounds > k
        assert counters["host_rounds.graph_captures"] == [1]
        assert counters["host_rounds.graph_rounds"] == [rounds - k]
    else:
        assert "host_rounds.graph_captures" not in counters
    assert counters["host_rounds.live_lanes"] == \
        e_counters["host_rounds.live_lanes"]


def test_a_cpu_search_runs_every_round_eagerly(monkeypatch):
    """However many rounds a CPU search runs, nothing is captured."""
    monkeypatch.setattr(pipeline, "_RoundGraph", None)  # any use would raise
    with spans.recording() as rec:
        res = multi_query_search(
            make_dataset("ECG", N, seed=0).astype(np.float32),
            make_queries("ECG", Q, LENGTH, seed=1).astype(np.float32),
            LENGTH, WINDOW, batch=BATCH, device="cpu")
    assert int(res.rounds.max()) > pipeline.GRAPH_AFTER_ROUNDS
    assert not any(k.startswith("host_rounds.graph") for k in rec.counters)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# The benchmark's two configurations (bench/configs/): l = 1024 at window
# ratios 0.1 and 0.5, Q = 8, 256 candidates a query a round; the reference
# cut to 60,000 samples (a few hundred rounds) to keep the test short.
CARD_N, CARD_L, CARD_Q, CARD_B = 60_000, 1024, 8, 256


def _card_search(dev, window, **kw):
    before = {f.__name__: n for f, n in ops.counted_launches().items()}
    with spans.recording() as rec:
        res = multi_query_search(
            make_dataset("ECG", CARD_N, seed=0).astype(np.float32),
            make_queries("ECG", CARD_Q, CARD_L, seed=1).astype(np.float32),
            CARD_L, window, batch=CARD_B, device=dev, **kw)
        torch.cuda.synchronize()
    launched = {f.__name__: f.launches - before[f.__name__]
                for f in ops.counted_launches()}
    return res, launched, rec.counters


@pytest.mark.card
@pytest.mark.parametrize("form", [dict(), dict(gather="slab", with_info=True),
                                  dict(variant="eapruned_nolb")])
@pytest.mark.parametrize("window", [102, 512])
def test_the_replay_is_the_eager_loop_bit_for_bit(card, monkeypatch, window,
                                                  form):
    graph, g_launched, g_counters = _card_search(card, window, **form)
    monkeypatch.setattr(pipeline, "_capture_now", lambda *a: False)
    eager, e_launched, e_counters = _card_search(card, window, **form)
    for a, b in zip(eager, graph):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rounds = int(graph.rounds.max())
    kernel = "dtw_ea_multi" if form.get("gather") == "slab" else \
        "dtw_ea_multi_fused"
    # One launch a round, replayed or not; every other kernel as eager.
    assert g_launched[kernel] == e_launched[kernel] == rounds
    assert g_launched == e_launched
    assert g_counters["host_rounds.graph_captures"] == [1]
    assert g_counters["host_rounds.graph_rounds"] == \
        [rounds - pipeline.GRAPH_AFTER_ROUNDS]
    assert "host_rounds.graph_captures" not in e_counters
    assert g_counters["host_rounds.live_lanes"] == \
        e_counters["host_rounds.live_lanes"]


@pytest.mark.card
def test_a_host_sync_inside_the_round_fails_the_capture(card, monkeypatch):
    """``"global"`` capture: a ``.item()`` hidden in the step raises, and
    the next search runs as before."""
    want, _, _ = _card_search(card, 102)

    def leaky(state, *a, **k):
        state.ub.sum().item()
        return fold_min(state, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(pipeline, "fold_min", leaky)
        with pytest.raises(RuntimeError):
            _card_search(card, 102)
    again, _, counters = _card_search(card, 102)
    for a, b in zip(want, again):
        assert torch.equal(a, b)
    assert counters["host_rounds.graph_captures"] == [1]
    torch.cuda.empty_cache()    # the allocator holds no capture open
