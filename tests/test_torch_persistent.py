"""The persistent sweep of the port (kernels C and E, ``rounds="persistent"``)
against ``repro`` on the CPU.

On CPU tensors ``kernels.ops.dtw_ea_persistent_fused`` (C) and
``dtw_ea_persistent`` (E) run their plain versions, which sweep the
best-first lanes in chunks and replay the block gate and fold in order
(``kernels/dtw_band.py::_sweep``); the CUDA kernels run lanes in parallel
against a shared incumbent and are held against these plain versions on
the card by ``chip_smoke.py``. Here the plain versions meet ``repro``'s
Pallas kernels in interpret mode and its ``backend="jax"`` sweeps.

Tolerances: ``best_start`` and ``blocks`` exactly (the plain versions give
``repro``'s sequential sweep); ``best_dist`` ``rtol=1e-5`` where both sides
get the same float32 stats (what is left is the order of float32 sums in
the row scan). End to end, both sides compute their own window stats, so
distances take the tolerances of ``test_torch_search.py`` with the reasons
stated there: ``rtol=1e-4``, ``5e-3`` on REFIT.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.batch import ea_pruned_dtw_persistent as r_persistent
from repro.core.batch import ea_pruned_dtw_persistent_fused as r_persistent_fused
from repro.core.common import clamp_sigma as r_clamp_sigma
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.search import multi_query_search as r_multi
from repro.search import subsequence_search as r_subsequence
from repro.search.cascade import cascade_lower_bounds as r_cascade
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core import guards
from repro_torch.core.batch import (
    ea_pruned_dtw_persistent,
    ea_pruned_dtw_persistent_fused,
)
from repro_torch.core.common import BIG
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import (
    dtw_ea_persistent_fused_plain,
    dtw_ea_persistent_plain,
    dtw_ea_plain,
    gather_norm_lanes,
)
from repro_torch.search import multi_query_search, subsequence_search

torch.set_num_threads(1)

N_REF, LENGTH, WINDOW, Q, BLOCK_K = 700, 32, 3, 2, 8
K = 61  # best-first lanes per query: a ragged final block of 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed=5, n_inf=4):
    """Two queries, their K best-first windows by the real cascade, the
    last ``n_inf`` lanes quarantined (``+inf`` bounds)."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=N_REF)).astype(np.float32) * 0.1
    queries = np.cumsum(rng.normal(size=(Q, LENGTH)), axis=1).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)), np.float32)
    mu, sigma = (np.asarray(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), LENGTH))
    u, low = (np.asarray(a, np.float32)
              for a in r_envelope(jnp.asarray(qn), WINDOW))
    lbs = np.stack([np.asarray(r_cascade(
        jnp.asarray(ref), jnp.asarray(q), jnp.asarray(mu), jnp.asarray(sigma),
        LENGTH, WINDOW), np.float32) for q in qn])
    order = np.argsort(lbs, axis=1, kind="stable")[:, :K].astype(np.int32)
    lb = np.take_along_axis(lbs, order, axis=1)
    lb[:, K - n_inf:] = np.inf
    sg = np.asarray(r_clamp_sigma(jnp.asarray(sigma)), np.float32)
    return dict(ref=ref, qn=qn, mu=mu, sigma=sigma, u=u, low=low, lb=lb,
                starts=order, mu_l=mu[order], sg_l=sg[order])


def _slab(c):
    win = c["ref"][c["starts"][..., None] + np.arange(LENGTH)]
    return ((win - c["mu_l"][..., None]) / c["sg_l"][..., None]).astype(np.float32)


def _seeds(c, mode):
    """Cold, a warm seed no lane beats (start -1), a hopeless seed below
    every bound (0 blocks), and a seed between the two best distances."""
    if mode == "cold":
        return np.full(Q, BIG, np.float32)
    d, _, _ = ops.dtw_ea_persistent(
        _t(c["qn"]), _t(_slab(c)), _t(c["lb"]), _t(c["starts"]),
        _t(np.full(Q, BIG, np.float32)), WINDOW, block_k=BLOCK_K,
    )
    d = d.numpy()
    if mode == "unbeaten":
        return (d * 0.999).astype(np.float32)
    if mode == "hopeless":
        return (c["lb"][:, 0] * 0.5).astype(np.float32)
    return (d * 1.0001).astype(np.float32)


def _assert_sweep(got, want, mode):
    dist, best, blocks = (np.asarray(x) for x in want)
    assert got[1].tolist() == best.tolist()
    assert got[2].tolist() == blocks.tolist()
    np.testing.assert_allclose(got[0].numpy(), dist, rtol=1e-5)
    if mode == "unbeaten":
        assert best.tolist() == [-1] * Q and (blocks > 0).all()
    if mode == "hopeless":
        assert best.tolist() == [-1] * Q and blocks.tolist() == [0] * Q


MODES = ["cold", "unbeaten", "hopeless", "tight"]


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fused_sweep_plain_matches_pallas_interpret(use_cb, mode):
    """Kernel C's plain version against
    ``_dtw_ea_persistent_kernel(fused=True)`` in interpret mode."""
    c = _case()
    seeds = _seeds(c, mode)
    env = dict(u=c["u"], low=c["low"], use_cb=use_cb)
    want = r_ops.dtw_ea_persistent_fused(
        jnp.asarray(c["qn"]), jnp.asarray(c["ref"]), jnp.asarray(c["lb"]),
        jnp.asarray(c["starts"]), jnp.asarray(c["mu_l"]),
        jnp.asarray(c["sg_l"]), jnp.asarray(seeds), WINDOW, LENGTH,
        u=jnp.asarray(env["u"]), low=jnp.asarray(env["low"]), use_cb=use_cb,
        block_k=BLOCK_K, row_block=16, interpret=True,
    )
    got = ops.dtw_ea_persistent_fused(
        _t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(c["starts"]),
        _t(c["mu_l"]), _t(c["sg_l"]), _t(seeds), WINDOW, LENGTH,
        u=_t(c["u"]), low=_t(c["low"]), use_cb=use_cb, block_k=BLOCK_K,
    )
    _assert_sweep(got, want, mode)
    assert ops.dtw_ea_persistent_fused.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_slab_sweep_plain_matches_pallas_interpret(use_cb, mode):
    """Kernel E's plain version against
    ``_dtw_ea_persistent_kernel(fused=False)`` in interpret mode."""
    c = _case(seed=9)
    seeds = _seeds(c, mode)
    slab = _slab(c)
    want = r_ops.dtw_ea_persistent(
        jnp.asarray(c["qn"]), jnp.asarray(slab), jnp.asarray(c["lb"]),
        jnp.asarray(c["starts"]), jnp.asarray(seeds), WINDOW,
        u=jnp.asarray(c["u"]), low=jnp.asarray(c["low"]), use_cb=use_cb,
        block_k=BLOCK_K, row_block=16, interpret=True,
    )
    got = ops.dtw_ea_persistent(
        _t(c["qn"]), _t(slab), _t(c["lb"]), _t(c["starts"]), _t(seeds),
        WINDOW, u=_t(c["u"]), low=_t(c["low"]), use_cb=use_cb,
        block_k=BLOCK_K,
    )
    _assert_sweep(got, want, mode)
    assert ops.dtw_ea_persistent.launches == 0


@pytest.mark.parametrize("chunk", [BLOCK_K, 24, 4096])
@pytest.mark.parametrize("use_cb", [False, True])
def test_chunked_sweep_equals_repro_sequential_sweep(chunk, use_cb):
    """The plain sweeps evaluate ``chunk`` lanes at the chunk's incumbent,
    then replay gate and fold block by block; that must give ``repro``'s
    sequential ``block_sweep``, ``blocks`` included, at any chunk size
    (``chunk == block_k`` is the sequential sweep itself)."""
    c = _case(seed=13, n_inf=0)
    seeds = np.full(Q, BIG, np.float32)
    env = (jnp.asarray(c["u"]), jnp.asarray(c["low"])) if use_cb else None
    want = r_persistent(
        jnp.asarray(c["qn"]), jnp.asarray(_slab(c)), jnp.asarray(c["lb"]),
        jnp.asarray(c["starts"]), jnp.asarray(seeds), WINDOW,
        envelopes=env, backend="jax", block_k=BLOCK_K,
    )
    bw = ops.resolve_band(WINDOW, LENGTH, LENGTH, None)
    slab = dtw_ea_persistent_plain(
        _t(c["qn"]), _t(_slab(c)), _t(c["lb"]), _t(c["starts"]), _t(seeds),
        WINDOW, bw, BLOCK_K, u=_t(c["u"]), low=_t(c["low"]), use_cb=use_cb,
        chunk=chunk,
    )
    fused = dtw_ea_persistent_fused_plain(
        _t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(c["starts"]),
        _t(c["mu_l"]), _t(c["sg_l"]), _t(seeds), WINDOW, LENGTH, bw,
        BLOCK_K, u=_t(c["u"]), low=_t(c["low"]), use_cb=use_cb, chunk=chunk,
    )
    _assert_sweep(slab, want, "cold")
    assert fused[3].tolist() == [0] * Q
    for a, b in zip(slab, fused[:3]):
        assert torch.equal(a, b)  # C and E: the same bits


@pytest.mark.parametrize("use_cb", [False, True])
def test_finished_lane_bits_do_not_depend_on_ub(use_cb):
    """The assumption kernel C rests on: a lane that finishes gives the
    same bits under ``ub = BIG``, under ``ub`` equal to its own distance,
    and under the bounds between them that the incumbent re-read of
    kernels C and E can hand a lane."""
    c = _case(seed=21)
    win, _ = gather_norm_lanes(_t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
                               _t(c["sg_l"]), LENGTH)
    cb = None
    if use_cb:
        from repro_torch.core.lower_bounds import cascade_keogh_cumulative

        cb = cascade_keogh_cumulative(win, _t(c["u"])[:, None], _t(c["low"])[:, None])
    bw = ops.resolve_band(WINDOW, LENGTH, LENGTH, None)
    free = dtw_ea_plain(_t(c["qn"]), win, torch.full((Q, K), BIG), WINDOW, bw,
                        cb=cb)
    assert torch.isfinite(free).all()
    tight = dtw_ea_plain(_t(c["qn"]), win, free, WINDOW, bw, cb=cb)
    assert torch.equal(tight, free)
    for ub in (free * (1 + 1e-6), free * 1.5):
        assert torch.equal(dtw_ea_plain(_t(c["qn"]), win, ub, WINDOW, bw,
                                         cb=cb), free)
    below = dtw_ea_plain(_t(c["qn"]), win, torch.nextafter(free, torch.zeros(())),
                         WINDOW, bw, cb=cb)
    assert torch.isinf(below).all()  # one ulp lower and every lane abandons


@pytest.mark.parametrize("use_cb", [False, True])
def test_batch_persistent_primitives_match_repro_jax(use_cb):
    """``core.batch``'s two sweeps (lanes padded to ``block_k``, sigma
    clamped at the boundary) against ``repro``'s ``backend="jax"``."""
    c = _case(seed=3)
    seeds = np.array([BIG, 40.0], np.float32)
    env_r = (jnp.asarray(c["u"]), jnp.asarray(c["low"])) if use_cb else None
    env_t = (_t(c["u"]), _t(c["low"])) if use_cb else None
    want = r_persistent_fused(
        jnp.asarray(c["qn"]), jnp.asarray(c["ref"]), jnp.asarray(c["lb"]),
        jnp.asarray(c["starts"]), jnp.asarray(seeds), WINDOW,
        jnp.asarray(c["mu"]), jnp.asarray(c["sigma"]), envelopes=env_r,
        backend="jax", block_k=BLOCK_K,
    )
    got = ea_pruned_dtw_persistent_fused(
        _t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(c["starts"]), _t(seeds),
        WINDOW, _t(c["mu"]), _t(c["sigma"]), envelopes=env_t,
        block_k=BLOCK_K,
    )
    _assert_sweep(got, want, "cold")
    want_s = r_persistent(
        jnp.asarray(c["qn"]), jnp.asarray(_slab(c)), jnp.asarray(c["lb"]),
        jnp.asarray(c["starts"]), jnp.asarray(seeds), WINDOW,
        envelopes=env_r, backend="jax", block_k=BLOCK_K,
    )
    got_s = ea_pruned_dtw_persistent(
        _t(c["qn"]), _t(_slab(c)), _t(c["lb"]), _t(c["starts"]), _t(seeds),
        WINDOW, envelopes=env_t, block_k=BLOCK_K,
    )
    _assert_sweep(got_s, want_s, "cold")


def test_fused_sweep_out_of_range_start_raises():
    """A lane whose start lies outside ``[0, N - m]`` is counted, and the
    wrapper raises instead of reading it."""
    c = _case()
    starts = c["starts"].copy()
    starts[1, 40] = N_REF - LENGTH + 1
    with pytest.raises(guards.SearchInputError, match="1 lane"):
        ops.dtw_ea_persistent_fused(
            _t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(starts),
            _t(c["mu_l"]), _t(c["sg_l"]), BIG, WINDOW, LENGTH,
        )
    _, _, _, bad = dtw_ea_persistent_fused_plain(
        _t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(starts), _t(c["mu_l"]),
        _t(c["sg_l"]), torch.full((Q,), BIG), WINDOW, LENGTH, 32, BLOCK_K,
    )
    assert bad.tolist() == [0, 1]


def test_persistent_wrappers_check_inputs():
    c = _case()
    args = (_t(c["qn"]), _t(c["ref"]), _t(c["lb"]), _t(c["starts"]),
            _t(c["mu_l"]), _t(c["sg_l"]), BIG, WINDOW, LENGTH)
    with pytest.raises(ValueError, match="envelopes"):
        ops.dtw_ea_persistent_fused(*args, use_cb=True)
    with pytest.raises(TypeError):
        ops.dtw_ea_persistent_fused(args[0], args[1], args[2],
                                    args[3].long(), *args[4:])
    with pytest.raises(ValueError):
        ops.dtw_ea_persistent(_t(c["qn"]), _t(_slab(c))[:, :-1], _t(c["lb"]),
                              _t(c["starts"]), BIG, WINDOW)


# ---------------------------------------------------------------------------
# end to end: rounds x gather x variant against repro
# ---------------------------------------------------------------------------

N, SLEN, SWIN, SQ, BATCH = 3000, 48, 5, 3, 32
RTOL = {"ECG": 1e-4, "REFIT": 5e-3}
DRIVERS = [("host", "fused"), ("host", "slab"), ("persistent", "fused"),
           ("persistent", "slab")]


def _data(name="ECG", nan_burst=False):
    ref = make_dataset(name, N, seed=0).astype(np.float32)
    if nan_burst:
        ref[1200:1210] = np.nan
        ref[2500] = np.inf
    return ref, make_queries(name, SQ, SLEN, seed=1).astype(np.float32)


def _both(ref, queries, **kw):
    want = r_multi(jnp.asarray(ref), jnp.asarray(queries), SLEN, SWIN,
                   batch=BATCH, backend="jax", **kw)
    got = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                             device="cpu", **kw)
    return want, got


def _assert_same(want, got, name="ECG"):
    assert got.best_start.tolist() == np.asarray(want.best_start).tolist()
    assert int(got.quarantined) == int(want.quarantined)
    np.testing.assert_allclose(got.best_dist.numpy(),
                               np.asarray(want.best_dist), rtol=RTOL[name])
    assert got.rounds.tolist() == np.asarray(want.rounds).tolist()
    assert got.lanes.tolist() == np.asarray(want.lanes).tolist()
    assert got.lb_pruned.tolist() == np.asarray(want.lb_pruned).tolist()


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("rounds,gather", DRIVERS)
@pytest.mark.parametrize("name", ["ECG", "REFIT"])
def test_multi_query_drivers_match_repro(name, rounds, gather, variant):
    want, got = _both(*_data(name), variant=variant, rounds=rounds,
                      gather=gather)
    _assert_same(want, got, name)


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("rounds,gather", DRIVERS[1:])
def test_multi_query_drivers_nan_burst(rounds, gather, variant):
    want, got = _both(*_data(nan_burst=True), variant=variant, rounds=rounds,
                      gather=gather)
    _assert_same(want, got)
    assert int(got.quarantined) == (1209 - 1200 + SLEN) + SLEN


@pytest.mark.parametrize("rounds,gather", DRIVERS[1:])
def test_multi_query_drivers_ub_init_seeds(rounds, gather):
    """Per-query seeds: unbeatable (-1 and the seed back), tight but
    beatable, and loose."""
    ref, queries = _data()
    free = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                              device="cpu")
    d = free.best_dist.numpy()
    seeds = np.array([d[0] * 0.5, d[1] * 1.01, d[2] * 10.0], np.float32)
    want, got = _both(ref, queries, ub_init=seeds, rounds=rounds,
                      gather=gather)
    _assert_same(want, got)
    assert got.best_start[0].item() == -1
    assert got.best_dist[0].item() == seeds[0]
    assert got.best_start[1:].tolist() == free.best_start[1:].tolist()


@pytest.mark.parametrize("gather", ["fused", "slab"])
@pytest.mark.parametrize("warm_start", [4, 32])
def test_persistent_warm_start_folds_into_seed(gather, warm_start):
    """The prepass winner keeps its start when the sweep cannot beat the
    seed it gave (the sweep returns -1 then), and the prepass counts as a
    second dispatch (``tests/test_persistent.py``)."""
    ref, queries = _data()
    cold = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                              device="cpu")
    want, got = _both(ref, queries, rounds="persistent", gather=gather,
                      warm_start=warm_start)
    _assert_same(want, got)
    assert got.best_start.tolist() == cold.best_start.tolist()
    assert got.rounds.tolist() == [2] * SQ


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("rounds,gather", DRIVERS[1:])
def test_subsequence_drivers_match_repro(rounds, gather, variant):
    ref = make_dataset("ECG", 2400, seed=4).astype(np.float32)
    ref[900:1100] = ref[900]  # flat windows
    query = make_queries("ECG", 1, 64, seed=5)[0].astype(np.float32)
    want = r_subsequence(jnp.asarray(ref), jnp.asarray(query), 64, 8,
                         variant=variant, batch=40, backend="jax",
                         rounds=rounds, gather=gather)
    got = subsequence_search(ref, query, 64, 8, variant=variant, batch=40,
                             rounds=rounds, gather=gather, device="cpu")
    assert int(got.best_start) == int(want.best_start)
    assert int(got.lanes) == int(want.lanes)
    assert float(got.best_dist) == pytest.approx(float(want.best_dist),
                                                 rel=1e-4)


@pytest.mark.parametrize("rounds", ["host", "persistent"])
def test_slab_budget_raises_on_both_drivers(rounds):
    """A slab over ``slab_budget`` raises before it is built, with
    ``repro``'s error; the fused gather ignores the budget."""
    ref, queries = _data()
    budget = SQ * BATCH * SLEN * 4 - 1  # one host round's slab, less a byte
    kw = dict(rounds=rounds, gather="slab", slab_budget=budget)
    with pytest.raises(guards.SearchInputError, match="slab_budget") as mine:
        multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                           device="cpu", **kw)
    from repro.core import guards as r_guards

    with pytest.raises(r_guards.SearchInputError) as theirs:
        r_multi(jnp.asarray(ref), jnp.asarray(queries), SLEN, SWIN,
                batch=BATCH, backend="jax", **kw)
    assert str(mine.value) == str(theirs.value)
    fused = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                               device="cpu", rounds=rounds,
                               slab_budget=budget)
    assert (fused.best_start >= 0).all()


def test_search_config_forwards_driver_knobs():
    """``SearchConfig`` carries ``repro``'s ``rounds``, ``gather``,
    ``slab_budget`` and ``block_k`` into the plan, with its defaults."""
    from repro.configs.dtw_search import SearchConfig as RConfig
    from repro_torch.configs.dtw_search import SearchConfig

    mine, theirs = SearchConfig(), RConfig()
    for knob in ("rounds", "gather", "slab_budget", "block_k"):
        assert getattr(mine, knob) == getattr(theirs, knob)
    plan = SearchConfig(query_len=64, rounds="persistent", gather="slab",
                        slab_budget=1 << 20, block_k=4).make_plan()
    assert (plan.rounds, plan.gather, plan.slab_budget, plan.block_k) == (
        "persistent", "slab", 1 << 20, 4)
