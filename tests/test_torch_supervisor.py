"""The port's SearchSupervisor and checkpoint store against ``repro``'s on
the CPU.

``repro_torch.serve.SearchSupervisor`` around the port's
``StreamSearchEngine`` (``device="cpu"``) beside ``repro``'s around its
engine (``backend="jax"``), fed the same float32 arrivals of an ECG-like
series with two non-finite bursts, under ``tests/faults.py``'s
``FaultyEngine``: retry and rollback, giving up after ``max_retries``,
guard errors re-raised, kill and resume, the async write barrier, the
fallback past a damaged checkpoint and the breaker that sheds load in
time. Restarts, sleeps, resume indices and health snapshots (on a
``FakeClock``) equal ``repro``'s exactly; ``best_start`` too, distances
within ``rtol=1e-4``. Within the port, every supervised run gives the
uninterrupted engine's bits (incumbents, rounds, lanes, quarantine).

``repro_torch.train.checkpoint`` keeps ``repro``'s on-disk layout: a
directory written by either package's supervisor is resumed by the
other's, with the writer's incumbents bit for bit.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import SearchSupervisor as RSupervisor
from repro.serve import StreamSearchEngine as REngine
from repro.train import checkpoint as rckpt
from repro_torch.configs.dtw_search import SearchConfig
from repro_torch.core import guards
from repro_torch.serve import SearchSupervisor, StreamSearchEngine
from repro_torch.train import checkpoint as ckpt

from faults import FakeClock, FaultyEngine
from test_torch_resilient import RTOL, B, L, W, _data

torch.set_num_threads(1)

SN, ARRIVAL, SCHUNK = 2000, 200, 64  # 10 arrivals, 4 ingests each


def _stream():
    ref, queries = _data(dirty=True, n=SN)
    return [ref[p:p + ARRIVAL] for p in range(0, SN, ARRIVAL)], queries


def _engine(queries, **kw):
    return StreamSearchEngine(queries, L, W, batch=B, stream_chunk=SCHUNK,
                              device="cpu", **kw)


def _rengine(queries, **kw):
    return REngine(jnp.asarray(queries), length=L, window=W, batch=B,
                   stream_chunk=SCHUNK, backend="jax", **kw)


def _baseline(chunks, queries, **kw):
    eng = _engine(queries, **kw)
    for c in chunks:
        eng.ingest(c)
    return eng


def _assert_bits(eng, base):
    """The uninterrupted engine's bits: incumbents, counters, quarantine."""
    b, d = eng.best()
    bb, bd = base.best()
    assert torch.equal(b, bb) and torch.equal(d, bd)
    assert (eng.rounds, eng.lanes, eng.n_seen) == (base.rounds, base.lanes,
                                                   base.n_seen)
    assert eng.quarantined_windows == base.quarantined_windows > 0


def _assert_same_answer(eng, reng):
    assert np.array_equal(eng.best()[0].numpy(), np.asarray(reng.best()[0]))
    np.testing.assert_allclose(eng.best()[1].numpy(),
                               np.asarray(reng.best()[1]), rtol=RTOL)


# -- retry, rollback, give up ---------------------------------------------

@pytest.mark.parametrize("fail_at,ckpt_every", [({2, 5}, 2), ({3, 9}, 4)])
def test_retries_transient_faults(tmp_path, fail_at, ckpt_every):
    chunks, queries = _stream()
    base = _baseline(chunks, queries)
    runs = []
    for make, cls, sub in ((_engine, SearchSupervisor, "mine"),
                           (_rengine, RSupervisor, "theirs")):
        eng = make(queries)
        sleeps = []
        sup = cls(FaultyEngine(eng, fail_at=fail_at), str(tmp_path / sub),
                  ckpt_every=ckpt_every, backoff=0.01, sleep=sleeps.append,
                  clock=FakeClock())
        for c in chunks:
            sup.ingest(c if cls is SearchSupervisor else jnp.asarray(c))
        runs.append((eng, sup, sleeps))
    (eng, sup, sleeps), (reng, rsup, rsleeps) = runs
    _assert_bits(eng, base)
    _assert_same_answer(eng, reng)
    assert sup.restarts == rsup.restarts == len(fail_at)
    assert sleeps == rsleeps
    assert tuple(sup.health.snapshot()) == tuple(rsup.health.snapshot())
    assert sup.monitor.ewma == rsup.monitor.ewma == 0.0
    assert ckpt.steps(str(tmp_path / "mine")) == rckpt.steps(
        str(tmp_path / "theirs"))


def test_gives_up_after_max_retries_with_the_error_chained(tmp_path):
    _, queries = _stream()
    injected = RuntimeError("hard down")

    def always_fail(_i):
        raise injected

    for make, cls in ((_engine, SearchSupervisor), (_rengine, RSupervisor)):
        sup = cls(make(queries), str(tmp_path), max_retries=2, backoff=0.0,
                  sleep=lambda _t: None)
        with pytest.raises(RuntimeError, match="exceeded 2 retries") as ei:
            sup.ingest(np.ones(100, np.float32), fail_injector=always_fail)
        assert ei.value.__cause__ is injected
        assert sup.restarts == 3


def test_failure_while_replaying_counts_as_a_retry(tmp_path):
    """Every call failing from the third on (as after a sticky CUDA error):
    the rollback's replay fails too, which counts as one more retry, and
    the supervisor gives up after ``max_retries`` with the error chained
    rather than letting it escape from the handler (``repro`` does)."""
    chunks, queries = _stream()
    faulty = FaultyEngine(_engine(queries), fail_at=range(2, 100))
    sleeps = []
    sup = SearchSupervisor(faulty, str(tmp_path), ckpt_every=4,
                           max_retries=3, backoff=0.01, sleep=sleeps.append)
    sup.ingest(chunks[0])
    sup.ingest(chunks[1])
    with pytest.raises(RuntimeError, match="exceeded 3 retries") as ei:
        sup.ingest(chunks[2])
    assert str(ei.value.__cause__) == "injected fault"
    # the third failure in a row also opens the breaker: its cooldown
    assert sup.restarts == 4 and sleeps == [0.01, 0.02, 0.04, 1.0]


def test_reraises_caller_bugs(tmp_path):
    """StreamStateError is a bug, not a transient: no retry, no rollback."""
    chunks, queries = _stream()
    eng = _engine(queries)
    sup = SearchSupervisor(eng, str(tmp_path), max_retries=5,
                           sleep=lambda _t: None)
    eng._tail = torch.zeros(L + 3)  # corrupt the carried state
    with pytest.raises(guards.StreamStateError):
        sup.ingest(chunks[0])
    assert sup.restarts == 0


def test_breaker_sheds_load_in_time(tmp_path):
    """A tripped breaker waits out its cooldown (one extra recorded sleep)
    before the half-open probe, then closes on success; as ``repro``."""
    _, queries = _stream()
    got = []
    for make, cls in ((_engine, SearchSupervisor), (_rengine, RSupervisor)):
        sleeps = []
        sup = cls(FaultyEngine(make(queries), fail_at={0, 1}), str(tmp_path),
                  max_retries=5, backoff=0.01, breaker_threshold=2,
                  breaker_cooldown=7.0, sleep=sleeps.append, clock=FakeClock())
        sup.ingest(np.ones(100, np.float32))
        got.append((sleeps, sup.restarts, tuple(sup.health.snapshot())))
    assert got[0] == got[1]
    assert got[0][0] == [0.01, 0.02, 7.0]
    assert got[0][2][0] == "closed" and got[0][2][5] == 1  # state, trips


def test_jitter_opt_in(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SEED", "5")
    _, queries = _stream()
    got = []
    for make, cls in ((_engine, SearchSupervisor), (_rengine, RSupervisor)):
        sleeps = []
        sup = cls(FaultyEngine(make(queries), fail_at={0, 1}), str(tmp_path),
                  backoff=0.01, jitter=True, sleep=sleeps.append)
        sup.ingest(np.ones(100, np.float32))
        got.append(sleeps)
    assert got[0] == got[1] and len(got[0]) == 2
    assert 0.01 <= got[0][0] < 0.03


def test_tensor_arrivals(tmp_path):
    """Arrivals as tensors on the engine's device: the same bits as numpy
    arrivals, through a fault and its replay."""
    chunks, queries = _stream()
    base = _baseline(chunks, queries)
    eng = _engine(queries)
    sup = SearchSupervisor(FaultyEngine(eng, fail_at={3}), str(tmp_path),
                           ckpt_every=2, backoff=0.0, sleep=lambda _t: None)
    for c in chunks:
        sup.ingest(torch.as_tensor(c))
    assert sup.restarts == 1
    _assert_bits(eng, base)


# -- kill and resume --------------------------------------------------------

@pytest.mark.parametrize("async_ckpt", [False, True])
def test_kill_and_resume_bit_exact(tmp_path, async_ckpt):
    """Kill after arrival 5, rebuild everything, ``resume()``: the
    uninterrupted run's bits, and ``repro``'s resume index and answer."""
    chunks, queries = _stream()
    base = _baseline(chunks, queries, ring_capacity=32)
    ks, engines = [], []
    for make, cls, sub in ((_engine, SearchSupervisor, "mine"),
                           (_rengine, RSupervisor, "theirs")):
        d = str(tmp_path / sub)
        sup1 = cls(make(queries, ring_capacity=32), d, ckpt_every=2,
                   async_ckpt=async_ckpt)
        for c in chunks[:5]:
            sup1.ingest(c)
        sup1._barrier()  # in-flight writes land; then the process "dies"
        del sup1
        eng = make(queries, ring_capacity=32)
        sup2 = cls(eng, d, ckpt_every=2, async_ckpt=async_ckpt)
        k = sup2.resume()
        for c in chunks[k:]:
            sup2.ingest(c)
        sup2.close()
        ks.append(k)
        engines.append(eng)
    assert ks == [4, 4]
    _assert_bits(engines[0], base)
    _assert_same_answer(*engines)


def test_resume_falls_back_past_damaged_checkpoint(tmp_path):
    chunks, queries = _stream()
    base = _baseline(chunks, queries)
    sup1 = SearchSupervisor(_engine(queries), str(tmp_path), ckpt_every=2,
                            keep=5)
    for c in chunks[:7]:
        sup1.ingest(c)
    steps = ckpt.steps(str(tmp_path))
    assert steps == [2, 4, 6]
    # damage the newest checkpoint after commit (a disk fault)
    latest = os.path.join(str(tmp_path), f"step_{steps[-1]:08d}")
    victim = next(f for f in sorted(os.listdir(latest)) if f.endswith(".npy"))
    with open(os.path.join(latest, victim), "wb") as f:
        f.write(b"\x93corrupt")
    for cls, make in ((SearchSupervisor, _engine), (RSupervisor, _rengine)):
        assert cls(make(queries), str(tmp_path)).resume() == 4
    eng = _engine(queries)
    sup2 = SearchSupervisor(eng, str(tmp_path), ckpt_every=2, keep=5)
    k = sup2.resume()
    for c in chunks[k:]:
        sup2.ingest(c)
    _assert_bits(eng, base)


def test_resume_from_scratch_when_all_checkpoints_damaged(tmp_path):
    chunks, queries = _stream()
    sup1 = SearchSupervisor(_engine(queries), str(tmp_path), ckpt_every=1,
                            keep=2)
    sup1.ingest(chunks[0])
    sup1.ingest(chunks[1])
    for step in ckpt.steps(str(tmp_path)):
        os.remove(os.path.join(str(tmp_path), f"step_{step:08d}",
                               "manifest.json"))
    sup2 = SearchSupervisor(_engine(queries), str(tmp_path))
    assert sup2.resume() == 0  # nothing readable: start the stream over
    assert sup2.engine.n_seen == 0


def test_async_rollback_waits_for_inflight_write(tmp_path):
    """A transient failure right after an async checkpoint submit: the
    rollback barriers on the slow writer, the replay stays exact, and the
    committed checkpoint restores into a fresh engine."""
    chunks, queries = _stream()
    base = _baseline(chunks, queries)
    eng = _engine(queries)
    sup = SearchSupervisor(FaultyEngine(eng, fail_at={2}), str(tmp_path),
                           ckpt_every=2, backoff=0.0, sleep=lambda _t: None,
                           async_ckpt=True)
    sup._async.close()  # widen the in-flight window
    sup._async = ckpt.AsyncCheckpointer(
        str(tmp_path), keep=3,
        write_hook=lambda _tree, _step: time.sleep(0.05))
    for c in chunks:
        sup.ingest(c)
    sup.close()
    assert sup.restarts == 1
    _assert_bits(eng, base)
    state, step = ckpt.restore(str(tmp_path), eng.save_state())
    assert step == 10
    fresh = _engine(queries)
    fresh.restore_state(state)
    _assert_bits(fresh, base)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """One package's supervisor writes (killed after arrival 5), the
    other's resumes from its newest checkpoint (4) with the writer's
    incumbents bit for bit, then finishes the stream with the writer's
    answer."""
    chunks, queries = _stream()
    make_w, cls_w, make_r, cls_r = (
        (_rengine, RSupervisor, _engine, SearchSupervisor)
        if writer == "repro" else
        (_engine, SearchSupervisor, _rengine, RSupervisor))
    full = make_w(queries)
    sup_w = cls_w(full, str(tmp_path), ckpt_every=2, keep=10)
    for i, c in enumerate(chunks):
        if i == 4:
            at_ckpt = [np.asarray(x).copy() for x in full.best()]
            assert ckpt.latest_step(str(tmp_path)) == 4
            stop = ckpt.steps(str(tmp_path))
        sup_w.ingest(c)
    assert stop == [2, 4]
    # the writer ran on to the end; resume from its step-4 checkpoint
    for s in ckpt.steps(str(tmp_path)):
        if s > 4:
            os.rename(os.path.join(str(tmp_path), f"step_{s:08d}"),
                      os.path.join(str(tmp_path), f"later_{s:08d}"))
    eng = make_r(queries)
    sup_r = cls_r(eng, str(tmp_path), ckpt_every=2)
    assert sup_r.resume() == 4
    assert np.array_equal(np.asarray(eng.best()[0]), at_ckpt[0])
    assert np.array_equal(np.asarray(eng.best()[1]), at_ckpt[1])  # bitwise
    for c in chunks[4:]:
        sup_r.ingest(c)
    mine, theirs = (eng, full) if writer == "repro" else (full, eng)
    _assert_same_answer(mine, theirs)
    assert mine.quarantined_windows == theirs.quarantined_windows
    assert (mine.rounds, mine.lanes) == (theirs.rounds, theirs.lanes)


def test_config_hands_over_the_supervisor_knobs(tmp_path):
    _, queries = _stream()
    cfg = SearchConfig(async_ckpt=True, breaker_threshold=5,
                       breaker_cooldown=2.0)
    sup = cfg.make_supervisor(_engine(queries), str(tmp_path), ckpt_every=3)
    assert sup._async is not None and sup.ckpt_every == 3
    br = sup.health.breaker
    assert (br.threshold, br.cooldown) == (5, 2.0)
    sup.close()


# -- the checkpoint store ---------------------------------------------------

def _tree():
    return {
        "b": np.arange(6, dtype=np.int32).reshape(2, 3),
        "a": [torch.linspace(0, 1, 5), (np.float32(2.5), np.int64(7))],
        "z": {"y/x": np.ones(3), "k": None},
    }


def _jax_tree(tree):
    """The same tree with jax leaves, as ``repro``'s tests hold them."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return jnp.asarray(np.asarray(x))
    return conv(tree)


def test_checkpoint_layout_is_repros(tmp_path):
    tree = _tree()
    assert [n for n, _ in ckpt._flatten(tree)] == [
        n for n, _ in rckpt._flatten(_jax_tree(tree))[0]]
    ckpt.save(str(tmp_path / "mine"), tree, 3)
    rckpt.save(str(tmp_path / "theirs"), _jax_tree(tree), 3)
    dm = tmp_path / "mine" / "step_00000003"
    dt = tmp_path / "theirs" / "step_00000003"
    assert sorted(os.listdir(dm)) == sorted(os.listdir(dt))
    with open(dm / "manifest.json") as f, open(dt / "manifest.json") as g:
        assert f.read() == g.read()
    # each package restores the other's directory
    got, step = ckpt.restore(str(tmp_path / "theirs"), tree)
    assert step == 3
    want, _ = rckpt.restore(str(tmp_path / "mine"), _jax_tree(tree))
    for (n, x), (_, y), (_, z) in zip(ckpt._flatten(got),
                                      rckpt._flatten(want)[0],
                                      ckpt._flatten(tree)):
        assert isinstance(x, np.ndarray), n
        assert x.dtype == np.asarray(z).dtype, n
        assert np.array_equal(x, np.asarray(y)) and np.array_equal(
            x, np.asarray(z)), n
    assert got["z"]["k"] is None and isinstance(got["a"][1], tuple)


def test_checkpoint_steps_and_prune_match_repro(tmp_path):
    for s in (5, 1, 12, 3):
        ckpt.save(str(tmp_path / "mine"), {"x": np.zeros(2)}, s)
        rckpt.save(str(tmp_path / "theirs"), {"x": jnp.zeros(2)}, s)
    os.makedirs(tmp_path / "mine" / "step_00000099.tmp")
    os.makedirs(tmp_path / "theirs" / "step_00000099.tmp")
    assert ckpt.steps(str(tmp_path / "mine")) == rckpt.steps(
        str(tmp_path / "theirs")) == [1, 3, 5, 12]
    ckpt.prune_old(str(tmp_path / "mine"), keep=2)
    rckpt.prune_old(str(tmp_path / "theirs"), keep=2)
    assert ckpt.latest_step(str(tmp_path / "mine")) == 12
    assert ckpt.steps(str(tmp_path / "mine")) == rckpt.steps(
        str(tmp_path / "theirs")) == [5, 12]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"x": np.zeros(2)})


def test_async_checkpointer_snapshots_on_submit(tmp_path):
    """A CPU tensor (whose ``.numpy()`` shares its memory) and a numpy
    array changed in place after ``submit`` do not change the checkpoint."""
    x = torch.arange(8, dtype=torch.float32)
    y = np.arange(3.0)
    tree = {"x": x, "y": [y]}
    ck = ckpt.AsyncCheckpointer(
        str(tmp_path), write_hook=lambda _t, _s: time.sleep(0.2))
    ck.submit(tree, 1)
    x.add_(100.0)
    y[0] = -5.0
    ck.wait()
    got, _ = ckpt.restore(str(tmp_path), tree)
    assert np.array_equal(got["x"], np.arange(8, dtype=np.float32))
    assert np.array_equal(got["y"][0], np.arange(3.0))
    ck.close()


def test_async_checkpoint_wait_is_a_write_barrier(tmp_path):
    state = {"x": np.arange(8.0)}
    events = []

    def slow_write(tree, step):
        time.sleep(0.1)
        events.append(("written", step))

    ck = ckpt.AsyncCheckpointer(str(tmp_path), write_hook=slow_write)
    t0 = time.time()
    ck.submit(state, 1)
    ck.wait()
    assert time.time() - t0 >= 0.1  # wait really blocked on the write
    assert events == [("written", 1)]
    assert ckpt.latest_step(str(tmp_path)) == 1
    ck.close()

    def bad_write(tree, step):
        raise OSError("disk full")

    ck2 = ckpt.AsyncCheckpointer(str(tmp_path), write_hook=bad_write)
    ck2.submit(state, 2)
    with pytest.raises(OSError, match="disk full"):
        ck2.wait()
    with pytest.raises(OSError, match="disk full"):
        ck2.submit(state, 3)
