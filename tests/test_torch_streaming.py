"""The port's streaming search against ``repro``'s on the CPU.

``repro_torch.search.streaming.ingest_chunk`` and
``repro_torch.serve.StreamSearchEngine`` (``device="cpu"``: kernels A, B
and D run their plain versions) against ``repro``'s with
``backend="jax"``, fed the same float32 samples from ``data/synthetic.py``'s
ECG-like series (``tests/conftest.py`` turns on x64, so ``repro`` is fed
float32 explicitly).

Tolerances: ``best_start``, quarantine counts, rounds and lanes equal
exactly; distances ``rtol=1e-4``, as ``test_torch_search.py``: each side
computes its own float32 prefix-sum window stats over each ingest's
context (XLA and torch add in other orders) and the DTW sum rounds
differently too. A seed that is never beaten comes back unchanged on both
sides, exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.lower_bounds import envelope as r_envelope
from repro.search import fold_np as r_fold_np
from repro.search import ingest_chunk as r_ingest_chunk
from repro.search import initial_incumbents as r_initial_incumbents
from repro.search import QuarantineLedger as RLedger
from repro.search import rescore_windows as r_rescore_windows
from repro.search.znorm import append_window_stats as r_append_window_stats
from repro.search.znorm import znorm as r_znorm
from repro.serve import StreamSearchEngine as REngine
from repro_torch.core import guards
from repro_torch.core.lower_bounds import envelope
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import (
    IngestResult,
    QuarantineLedger,
    StreamIngestExecutor,
    append_window_stats,
    fold_np,
    ingest_chunk,
    initial_incumbents,
    multi_query_search,
    rescore_windows,
)
from repro_torch.search.znorm import window_stats, znorm
from repro_torch.serve import StreamSearchEngine

torch.set_num_threads(1)

N, L, W, Q, B = 900, 96, 9, 4, 64
RTOL = 1e-4
CHUNKINGS = [(300, 300, 300), (96, 1, 500, 303), (900,), (512, 388)]


def _data(n=N, nq=Q, bursts=()):
    ref = make_dataset("ECG", n, seed=0).astype(np.float32)
    for at, k in bursts:
        ref[at:at + k] = np.nan
    return ref, make_queries("ECG", nq, L, seed=1).astype(np.float32)


def _engines(queries, **kw):
    """The port's engine on the CPU and ``repro``'s, on the same knobs."""
    kw = dict(dict(length=L, window=W, batch=B), **kw)
    mine = StreamSearchEngine(queries, device="cpu", **kw)
    theirs = REngine(jnp.asarray(queries), backend="jax", **kw)
    return mine, theirs


def _feed(engines, ref, sizes):
    i = 0
    for c in sizes:
        for eng in engines:
            eng.ingest(ref[i:i + c] if isinstance(eng, StreamSearchEngine)
                       else jnp.asarray(ref[i:i + c]))
        i += c
    assert i == ref.shape[0], "the chunking must cover the stream exactly"


def _assert_engines_agree(mine, theirs):
    (pb, pd), (rb, rd) = mine.best(), theirs.best()
    assert pb.tolist() == np.asarray(rb).tolist()
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=RTOL)
    assert mine.rounds == theirs.rounds and mine.lanes == theirs.lanes
    assert mine.quarantined_windows == theirs.quarantined_windows
    assert mine.quarantined_samples == theirs.quarantined_samples
    assert mine.n_seen == theirs.n_seen and mine.n_windows == theirs.n_windows


# -- the functional ingest -------------------------------------------------

@pytest.mark.parametrize("sizes", CHUNKINGS)
@pytest.mark.parametrize("pad_to", [None, 1024])
def test_ingest_chunk_matches_repro(pad_to, sizes):
    """Per ingest: ``ub`` within tolerance, ``best`` and ``quarantined``
    equal, ``rounds`` and ``lanes`` exactly; a NaN burst in the stream."""
    ref, qs = _data(bursts=[(400, 3)])
    qn = znorm(torch.as_tensor(qs))
    u, low = envelope(qn, W)
    rqn = r_znorm(jnp.asarray(qs))
    ru, rlow = jax.vmap(r_envelope, in_axes=(0, None))(rqn, W)
    ub, best = initial_incumbents(Q, device="cpu")
    rub, rbest = r_initial_incumbents(Q, jnp.float32)
    tail = torch.zeros(0)
    rtail = jnp.zeros((0,), jnp.float32)
    seen = 0
    for c in sizes:
        chunk = ref[seen:seen + c]
        kw = dict(length=L, window=W, batch=B, pad_to=pad_to)
        offset = seen - int(tail.shape[0])
        tail, res = ingest_chunk(tail, torch.as_tensor(chunk), qn, u, low, ub,
                                 best, offset, device="cpu", **kw)
        rtail, rres = r_ingest_chunk(rtail, jnp.asarray(chunk), rqn, ru, rlow,
                                     rub, rbest, offset, backend="jax", **kw)
        assert isinstance(res, IngestResult)
        np.testing.assert_array_equal(tail.numpy(), np.asarray(rtail))
        assert res.best.tolist() == np.asarray(rres.best).tolist()
        np.testing.assert_allclose(res.ub.numpy(), np.asarray(rres.ub),
                                   rtol=RTOL)
        assert int(res.quarantined) == int(rres.quarantined)
        assert res.rounds.tolist() == np.asarray(rres.rounds).tolist()
        assert res.lanes.tolist() == np.asarray(rres.lanes).tolist()
        ub, best, rub, rbest = res.ub, res.best, rres.ub, rres.best
        seen += c
    assert res.best.dtype == torch.int64 and res.rounds.dtype == torch.int64


def test_zero_window_ingest_is_a_noop():
    _, qs = _data()
    qn = znorm(torch.as_tensor(qs))
    u, low = envelope(qn, W)
    ub, best = initial_incumbents(Q, device="cpu")
    new_tail, res = ingest_chunk(torch.ones(10), torch.ones(5), qn, u, low,
                                 ub, best, 0, length=L, window=W,
                                 device="cpu")
    assert new_tail.shape == (15,)
    assert torch.equal(res.ub, ub) and torch.equal(res.best, best)
    assert res.rounds.tolist() == [0] * Q and res.lanes.tolist() == [0] * Q
    assert int(res.quarantined) == 0


def test_stream_state_errors_match_repro():
    """The two ``StreamStateError``s carry the stream position and
    ``repro``'s message; a non-float chunk raises before any work."""
    _, qs = _data(nq=2)
    qn = znorm(torch.as_tensor(qs))
    u, low = envelope(qn, W)
    rqn = r_znorm(jnp.asarray(qs))
    ru, rlow = jax.vmap(r_envelope, in_axes=(0, None))(rqn, W)
    ub, best = initial_incumbents(2, device="cpu")
    rub, rbest = r_initial_incumbents(2, jnp.float32)
    cases = [  # (tail, chunk, offset, chunk_index)
        (np.zeros(0, np.float32), np.ones(200, np.float32), 0, 7),
        (np.ones(L + 3, np.float32), np.ones(40, np.float32), 90, None),
    ]
    for tail, chunk, offset, ci in cases:
        with pytest.raises(guards.StreamStateError) as mine:
            ingest_chunk(torch.as_tensor(tail), torch.as_tensor(chunk), qn,
                         u, low, ub, best, offset, length=L, window=W,
                         pad_to=128, chunk_index=ci, device="cpu")
        with pytest.raises(Exception) as theirs:
            r_ingest_chunk(jnp.asarray(tail), jnp.asarray(chunk), rqn, ru,
                           rlow, rub, rbest, offset, length=L, window=W,
                           pad_to=128, chunk_index=ci)
        assert str(mine.value) == str(theirs.value)
        assert mine.value.n_seen == theirs.value.n_seen
        assert mine.value.chunk_index == ci
    with pytest.raises(guards.SearchInputError):
        ingest_chunk(torch.zeros(0), torch.arange(100), qn, u, low, ub, best,
                     0, length=L, window=W, device="cpu")


def test_append_window_stats_matches_repro():
    """Appended stats rebuild the offline table, chunk by chunk, with the
    empty-ingest and boundary-straddle cases, and equal ``repro``'s."""
    ref = np.random.default_rng(23).normal(size=400).astype(np.float32)
    length = 64
    mu_off, sigma_off = window_stats(torch.as_tensor(ref), length)
    tail, rtail = torch.zeros(0), jnp.zeros((0,), jnp.float32)
    mus, sigmas, i = [], [], 0
    for c in (20, 30, 64, 1, 200, 85):
        tail, mu, sigma = append_window_stats(
            tail, torch.as_tensor(ref[i:i + c]), length)
        rtail, rmu, rsigma = r_append_window_stats(
            rtail, jnp.asarray(ref[i:i + c]), length)
        np.testing.assert_array_equal(tail.numpy(), np.asarray(rtail))
        np.testing.assert_allclose(mu.numpy(), np.asarray(rmu), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(rsigma),
                                   rtol=1e-5, atol=1e-6)
        mus.append(mu.numpy())
        sigmas.append(sigma.numpy())
        i += c
    np.testing.assert_allclose(np.concatenate(mus), mu_off.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(sigmas), sigma_off.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert tail.shape == (length - 1,)
    flat_tail, mu, sigma = append_window_stats(
        torch.zeros(0), torch.full((80,), 3.0), length)
    assert float(sigma.max()) == 0.0 and bool(torch.isfinite(mu).all())


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("gather", ["fused", "slab"])
@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("stream_chunk", [None, 256])
def test_engine_matches_repro(stream_chunk, variant, gather):
    ref, qs = _data()
    mine, theirs = _engines(qs, stream_chunk=stream_chunk, variant=variant,
                            gather=gather)
    _feed((mine, theirs), ref, (96, 1, 500, 303))
    _assert_engines_agree(mine, theirs)
    assert mine.best()[0].device.type == "cpu"


def test_engine_ub_init_seeds():
    """A hopeless seed is never beaten (best -1, the seed back exactly); a
    loose one leaves its query's answer intact."""
    ref, qs = _data()
    seeds = np.full(Q, 1e30, np.float32)
    seeds[1] = 1e-6
    mine, theirs = _engines(qs, stream_chunk=256,
                            ub_init=seeds)
    _feed((mine, theirs), ref, (450, 450))
    _assert_engines_agree(mine, theirs)
    assert int(mine.best()[0][1]) == -1
    assert float(mine.best()[1][1]) == float(np.float32(1e-6))


def test_engine_small_chunks_flat_chunk_and_nan_burst():
    """Chunks shorter than a window only extend the tail; a flat stretch
    mid-stream (sigma 0) and a NaN burst (quarantined) keep every
    incumbent finite and monotone, and end where ``repro`` ends."""
    ref, qs = _data(n=1200, bursts=[(700, 4)])
    ref[300:450] = ref[299]  # flat: sigma == 0 windows
    mine, theirs = _engines(qs, stream_chunk=128)
    for i in range(0, 90, 30):
        _feed((mine, theirs), ref[i:i + 30], (30,))
        assert mine.best()[0].tolist() == [-1] * Q
        assert mine.n_windows == 0 and mine.rounds == 0
    prev = None
    for i in range(90, 1200, 185):
        _feed((mine, theirs), ref[i:i + 185], (len(ref[i:i + 185]),))
        cur = mine.best()[1].numpy()
        assert np.isfinite(cur).all()
        if prev is not None:
            assert (cur <= prev).all()
        prev = cur
    _assert_engines_agree(mine, theirs)
    assert mine.quarantined_samples == 4
    assert mine.quarantined_windows == 4 + L - 1


@pytest.mark.parametrize("sizes", [(96, 1, 500, 303), (37,) * 24 + (12,),
                                   (900,), (512, 388)])
@pytest.mark.parametrize("stream_chunk", [None, 200])
def test_any_chunking_gives_the_offline_winner(stream_chunk, sizes):
    """Within the port: every chunking ends on offline
    ``multi_query_search``'s ``best_start``, with the same quarantine."""
    ref, qs = _data(bursts=[(610, 2)])
    off = multi_query_search(ref, qs, L, W, batch=B, device="cpu")
    eng = StreamSearchEngine(qs, L, W, batch=B, stream_chunk=stream_chunk,
                             device="cpu")
    _feed((eng,), ref, sizes)
    assert eng.best()[0].tolist() == off.best_start.tolist()
    np.testing.assert_allclose(eng.best()[1].numpy(), off.best_dist.numpy(),
                               rtol=RTOL)
    assert eng.quarantined_windows == int(off.quarantined)


def test_ring_eviction_and_recent():
    eng = StreamSearchEngine(np.random.default_rng(0).normal(size=64), 64, 6,
                             batch=32, ring_capacity=100, device="cpu")
    ref = np.arange(1000, dtype=np.float32)
    eng.ingest(ref[:40])
    np.testing.assert_array_equal(eng.recent(), np.arange(40.0))
    for i in range(40, 520, 60):
        eng.ingest(ref[i:i + 60])
    np.testing.assert_array_equal(eng.recent(), np.arange(420.0, 520.0))
    eng.ingest(ref[520:820])
    np.testing.assert_array_equal(eng.recent(), np.arange(720.0, 820.0))
    assert eng.n_seen == 820
    no_ring = StreamSearchEngine(np.ones(64) * np.arange(64), 64, 6,
                                 device="cpu")
    with pytest.raises(ValueError):
        no_ring.recent()


def test_debug_checks_and_env_var(monkeypatch):
    """The incumbent tripwire stays silent on a quarantined dirty stream,
    fires when a NaN reaches the incumbents, and follows the env var."""
    ref, qs = _data(bursts=[(200, 5)])
    eng = StreamSearchEngine(qs, L, W, batch=B, debug_checks=True,
                             stream_chunk=128, device="cpu")
    _feed((eng,), ref, (300, 600))
    assert eng.debug_checks and np.isfinite(eng.best()[1].numpy()).all()

    def poison(default):
        class Poisoned:
            def run_ingest(self, *args, **kwargs):
                tail, res = default.run_ingest(*args, **kwargs)
                return tail, res._replace(ub=torch.full_like(res.ub, np.nan))
        return Poisoned()

    bad = StreamSearchEngine(qs, L, W, batch=B, debug_checks=True,
                             executor=poison, device="cpu")
    with pytest.raises(guards.NonFiniteInputError, match="tripwire"):
        bad.ingest(ref[:200])
    monkeypatch.setenv(guards.DEBUG_ENV_VAR, "1")
    assert guards.debug_checks_enabled(None)
    assert StreamSearchEngine(qs, L, W, device="cpu").debug_checks
    monkeypatch.delenv(guards.DEBUG_ENV_VAR)
    assert not guards.debug_checks_enabled(None)
    assert not StreamSearchEngine(qs, L, W, device="cpu").debug_checks


def test_config_stream_engine_takes_the_stream_knobs(monkeypatch):
    """``SearchConfig.make_stream_engine`` hands the config's
    ``stream_chunk``, ``ring_capacity`` and ``debug_checks`` (and its search
    knobs) to the engine, which then finds what an engine built by hand
    finds."""
    from repro_torch.configs.dtw_search import SearchConfig

    monkeypatch.delenv(guards.DEBUG_ENV_VAR, raising=False)
    ref, qs = _data()
    cfg = SearchConfig(query_len=L, window_ratio=W / L, batch=B,
                       stream_chunk=256, ring_capacity=300, debug_checks=True)
    eng = cfg.make_stream_engine(qs, device="cpu")
    assert (eng.length, eng.window, eng.batch) == (L, W, B)
    assert eng.stream_chunk == 256 and eng.debug_checks
    assert eng.gather == cfg.gather and eng.variant == cfg.variant
    by_hand = StreamSearchEngine(qs, L, W, batch=B, stream_chunk=256,
                                 device="cpu")
    _feed((eng, by_hand), ref, (96, 1, 500, 303))
    assert eng.recent().shape == (300,)
    np.testing.assert_array_equal(eng.recent(), ref[-300:])
    assert eng.best()[0].tolist() == by_hand.best()[0].tolist()
    assert torch.equal(eng.best()[1], by_hand.best()[1])
    plain = SearchConfig(query_len=L, window_ratio=W / L)
    eng = plain.make_stream_engine(qs, device="cpu", stream_chunk=None)
    assert eng.stream_chunk is None and not eng.debug_checks
    with pytest.raises(ValueError, match="ring_capacity"):
        eng.recent()


# -- re-admission ----------------------------------------------------------------

def test_correct_readmits_like_repro():
    """Backfilled samples are rescored on the next ingest (kernel D's plain
    version) and end where ``repro`` ends and where a clean stream ends."""
    ref, qs = _data(n=1200)
    dirty = ref.copy()
    dirty[600:605] = np.nan
    mine, theirs = _engines(qs, ring_capacity=700)
    _feed((mine, theirs), dirty, (100,) * 12)
    assert mine.quarantined_windows == theirs.quarantined_windows > 0
    queued = mine.correct(600, ref[600:605])
    assert queued == theirs.correct(600, ref[600:605])
    assert queued == mine.quarantined_windows == mine.pending_rescore
    assert mine.quarantined_samples == 0
    for eng in (mine, theirs):
        eng.ingest(np.zeros(0, np.float32))  # flushes the rescore
    assert mine.pending_rescore == 0 and mine.quarantined_windows == 0
    assert mine.readmitted_windows == theirs.readmitted_windows == queued
    _assert_engines_agree(mine, theirs)
    clean = StreamSearchEngine(qs, L, W, batch=B, device="cpu")
    _feed((clean,), ref, (100,) * 12)
    assert mine.best()[0].tolist() == clean.best()[0].tolist()


def test_correct_without_ring_heals_straddling_windows_only():
    ref, qs = _data(n=1000)
    dirty = ref.copy()
    dirty[697:699] = np.inf  # inside the carried tail after 700 samples
    mine, theirs = _engines(qs)
    _feed((mine, theirs), dirty[:700], (700,))
    before = mine.quarantined_windows
    assert mine.correct(697, ref[697:699]) == theirs.correct(697,
                                                             ref[697:699]) == 0
    _feed((mine, theirs), dirty[700:], (300,))
    _assert_engines_agree(mine, theirs)
    assert mine.quarantined_windows == before and mine.readmitted_windows == 0


def test_correct_guards_match_repro():
    """Each refusal raises ``repro``'s exception type with its message."""
    ref, qs = _data(n=300)
    dirty = ref.copy()
    dirty[200:203] = np.nan
    mine, theirs = _engines(qs, ring_capacity=128)
    _feed((mine, theirs), dirty, (300,))
    bad_calls = [
        (299, np.zeros(5)),            # the future
        (210, np.zeros(2)),            # already finite history
        (200, [np.nan, 1.0, 2.0]),     # re-poisoning
        (10, np.zeros(1)),             # outside retained history
        (200, np.zeros(0)),            # empty patch
        (-1, np.zeros(1)),             # negative position
    ]
    for pos, vals in bad_calls:
        with pytest.raises(Exception) as want:
            theirs.correct(pos, vals)
        with pytest.raises(Exception) as got:
            mine.correct(pos, vals)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
    assert mine.correct(200, ref[200:203]) == theirs.correct(200,
                                                             ref[200:203]) > 0
    with pytest.raises(guards.StreamStateError):  # patched: finite now
        mine.correct(200, ref[200:203])
    no_q = StreamSearchEngine(qs, L, W, quarantine=False, device="cpu")
    no_q.ingest(ref)
    with pytest.raises(guards.StreamStateError, match="quarantine=False"):
        no_q.correct(100, np.zeros(1))


def test_rescore_windows_matches_repro():
    ref, qs = _data()
    starts = np.array([5, 77, 300, 301, 640], np.int64)
    wins = np.stack([ref[s:s + L] for s in starts])
    qn = znorm(torch.as_tensor(qs))
    u, low = envelope(qn, W)
    rqn = r_znorm(jnp.asarray(qs))
    ru, rlow = jax.vmap(r_envelope, in_axes=(0, None))(rqn, W)
    off = multi_query_search(ref, qs, L, W, batch=B, device="cpu")
    for variant in ("eapruned", "eapruned_nolb"):
        # seeds: cold, and the offline answer loosened so some beat it
        for ub0 in (np.full(Q, 1e30, np.float32),
                    off.best_dist.numpy() * np.float32(4.0)):
            best0 = np.full(Q, -1, np.int64)
            ub, best = rescore_windows(wins, starts, qn, u, low, ub0, best0,
                                       window=W, variant=variant,
                                       device="cpu")
            rub, rbest = r_rescore_windows(
                jnp.asarray(wins), jnp.asarray(starts, jnp.int32), rqn, ru,
                rlow, jnp.asarray(ub0), jnp.asarray(best0, jnp.int32),
                window=W, variant=variant, backend="jax")
            assert best.tolist() == np.asarray(rbest).tolist()
            np.testing.assert_allclose(ub.numpy(), np.asarray(rub), rtol=RTOL)
            assert (best >= 0).any()
    with pytest.raises(guards.SearchInputError):
        rescore_windows(wins, starts, qn, u, low, ub0, best0, window=W,
                        variant="full", device="cpu")


# -- checkpoints -------------------------------------------------------------------

def test_save_state_keys_and_values_match_repro():
    ref, qs = _data(bursts=[(350, 3)])
    mine, theirs = _engines(qs, stream_chunk=128, ring_capacity=150)
    _feed((mine, theirs), ref, (400, 333, 167))
    got, want = mine.save_state(), theirs.save_state()
    assert set(got) == set(want)
    for key in want:
        if key == "ub":
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
    for key in ("best", "rounds", "lanes", "quarantined", "bad_samples"):
        assert got[key].dtype == np.int64, key


def test_restore_repro_snapshot_then_continue():
    """A snapshot ``repro``'s engine saved (int32 ``best`` and counters)
    restores into the port, which then ends where ``repro`` ends."""
    ref, qs = _data(bursts=[(350, 3)])
    mine, theirs = _engines(qs, stream_chunk=128, ring_capacity=150)
    _feed((theirs,), ref[:500], (500,))
    snap = theirs.save_state()
    assert np.asarray(snap["best"]).dtype == np.int32
    mine.restore_state({k: np.asarray(v) for k, v in snap.items()})
    assert mine.n_seen == 500 and mine.rounds == theirs.rounds
    assert mine.best()[0].dtype == torch.int64
    _feed((mine, theirs), ref[500:], (250, 150))
    _assert_engines_agree(mine, theirs)
    np.testing.assert_array_equal(mine.recent(), theirs.recent())
    # a port snapshot round-trips bit for bit into a fresh port engine
    fresh = StreamSearchEngine(qs, L, W, batch=B, stream_chunk=128,
                               ring_capacity=150, device="cpu")
    fresh.restore_state(mine.save_state())
    assert torch.equal(fresh.best()[0], mine.best()[0])
    assert torch.equal(fresh.best()[1], mine.best()[1])
    legacy = {k: v for k, v in mine.save_state().items() if k != "readmitted"}
    fresh.restore_state(legacy)
    assert fresh.readmitted_windows == 0


def test_restore_rejects_mismatched_state():
    ref, qs = _data()
    eng = StreamSearchEngine(qs, L, W, device="cpu")
    eng.ingest(ref[:300])
    state = eng.save_state()
    with pytest.raises(guards.StreamStateError, match="wrong stream"):
        StreamSearchEngine(qs[:1], L, W, device="cpu").restore_state(state)
    with pytest.raises(guards.StreamStateError, match="overflows"):
        eng.restore_state(dict(state, tail=np.zeros(L + 5, np.float32)))
    with pytest.raises(guards.StreamStateError, match="missing"):
        eng.restore_state({k: v for k, v in state.items() if k != "ub"})
    with pytest.raises(guards.StreamStateError, match="ring_capacity"):
        StreamSearchEngine(qs, L, W, ring_capacity=16,
                           device="cpu").restore_state(state)


def test_correct_flushes_into_save_state():
    ref, qs = _data(n=1200)
    dirty = ref.copy()
    dirty[600:604] = np.nan
    mine, theirs = _engines(qs, ring_capacity=700)
    _feed((mine, theirs), dirty, (100,) * 12)
    queued = mine.correct(600, ref[600:604])
    assert queued == theirs.correct(600, ref[600:604]) > 0
    got, want = mine.save_state(), theirs.save_state()
    assert mine.pending_rescore == 0 and int(got["readmitted"]) == queued
    assert got["best"].tolist() == np.asarray(want["best"]).tolist()
    np.testing.assert_allclose(got["ub"], want["ub"], rtol=RTOL)


# -- the seam, host folds and the ledger -----------------------------------------

def test_executor_seam():
    """A factory gets the default executor and its wrapper is used; an
    object with ``run_ingest`` replaces it; anything else is refused."""
    ref, qs = _data()
    calls = []

    def factory(default):
        assert isinstance(default, StreamIngestExecutor)
        assert default.device == torch.device("cpu")

        class Counting:
            def run_ingest(self, *args, **kwargs):
                calls.append(kwargs["pad_to"])
                return default.run_ingest(*args, **kwargs)
        return Counting()

    eng = StreamSearchEngine(qs, L, W, batch=B, stream_chunk=256,
                             executor=factory, device="cpu")
    _feed((eng,), ref, (600, 300))
    assert calls == [256] * 5  # 600 = 256 + 256 + 88, 300 = 256 + 44
    plain = StreamSearchEngine(qs, L, W, batch=B, stream_chunk=256,
                               device="cpu")
    _feed((plain,), ref, (600, 300))
    assert torch.equal(eng.best()[0], plain.best()[0])
    direct = StreamIngestExecutor(eng.queries_n, eng.u, eng.low, length=L,
                                  window=W, batch=B, device="cpu")
    assert StreamSearchEngine(qs, L, W, executor=direct,
                              device="cpu")._executor is direct
    with pytest.raises(guards.SearchInputError, match="run_ingest"):
        StreamSearchEngine(qs, L, W, executor=object(), device="cpu")


def test_fold_np_matches_repro():
    ub = np.array([5.0, 5.0, 5.0, 5.0])
    best = np.array([1, 2, 3, 4])
    starts = [10, -1, 30, 40]
    dists = [4.0, 1.0, 5.0, 6.0]  # improve, no start, tie, worse
    got = fold_np(ub, best, starts, dists)
    want = r_fold_np(ub, best, starts, dists)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [10, 2, 3, 4]


def test_quarantine_ledger_matches_repro():
    mine, theirs = QuarantineLedger(device="cpu"), RLedger()
    for led in (mine, theirs):
        led.note_windows(7)
        led.note_samples(3)
        led.note_windows(torch.tensor(2) if led is mine else jnp.asarray(2))
        led.correct_samples(2)
        led.readmit(4)
    got, want = mine.state_dict(), theirs.state_dict()
    assert set(got) == set(want) == {"quarantined", "bad_samples",
                                     "readmitted"}
    for key in want:
        assert int(got[key]) == int(want[key])
    assert got["quarantined"].dtype == np.int64
    assert mine.windows.dtype == torch.int64
    # repro's int32 snapshot loads, and one older than re-admission too
    mine.load_state_dict(want)
    assert (int(mine.windows), int(mine.samples), mine.readmitted) == (5, 1, 4)
    mine.load_state_dict({k: v for k, v in want.items() if k != "readmitted"})
    assert mine.readmitted == 0


# -- the device rule ------------------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    """With no device given and no CUDA, the streaming entry points raise
    rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, qs = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamSearchEngine(qs, L, W)
    qn = znorm(torch.as_tensor(qs))
    u, low = envelope(qn, W)
    ub, best = torch.full((Q,), 1e30), torch.full((Q,), -1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest_chunk(torch.zeros(0), torch.as_tensor(ref), qn, u, low, ub,
                     best, 0, length=L, window=W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rescore_windows(np.stack([ref[:L]]), [0], qn, u, low, ub, best,
                        window=W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initial_incumbents(Q)
