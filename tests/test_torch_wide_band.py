"""Bands wider than one warp holds (``bw > 1024``), through what the CPU can
reach: the layout the wrappers route a band to, the plain rounds at such a
band against ``repro``'s Pallas kernels in interpret mode, and a search at
such a band against ``repro``'s.

On the card, bands up to ``ops.MAX_BAND_WIDTH`` run the one-warp row
(``csrc/dtw_band.cuh``) and wider ones the wide row
(``csrc/dtw_band_wide.cuh``: a thread block of ``WIDE_WARPS`` warps a
lane, the previous DP row in shared memory); ``chip_smoke.py`` holds both
against the plain versions there. Here the plain versions, which take any
band, meet ``repro`` at l = 1100, w = 550 (the band is the whole row,
1100 columns).

Tolerances: ``rtol=1e-4`` on a round's distances: both sides get the
same float32 stats and envelopes, and what is left is the order of float32
sums in the row scan (the Pallas row scan doubles, the plain one runs in
sequence). ``P``, the running cost sum, covers the whole band, so it
rounds more at 1100 columns than at 1024 (``test_torch_warp_row.py``,
``rtol=1e-5``): measured 1.4e-5 relative here. Abandon masks exactly:
each ``ub`` lies between two neighbouring exact distances. The search:
``best_start`` exactly, distances ``rtol=1e-3``: each side also computes
its own float32 window stats (``test_torch_search.py``), and at this
length the closed-form row carries P's rounding into a distance of ~15
(``chip_smoke.py``'s ``TOL_A`` reasoning): measured 4.1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.common import clamp_sigma as r_clamp_sigma
from repro.core.lower_bounds import cascade_keogh_cumulative as r_cb
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.search import multi_query_search as r_multi
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core.common import BIG
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import dtw_ea_plain, gather_norm_lanes
from repro_torch.search import multi_query_search

torch.set_num_threads(1)

LENGTH, WINDOW, K = 1100, 550, 4
BW = ops.resolve_band(WINDOW, LENGTH, LENGTH, None)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_band_layout_routes_every_band():
    """Up to 1024 columns the one-warp row, with ``cols_per_thread``'s
    columns a thread; past it the wide row, whose threads and shared
    memory fit an H100's block, at every band up to the longest query
    kernel B takes (the band is at most the window length), and with the
    cb slice on or off."""
    for bw in range(1, ops.LB_MAX_LENGTH + 1):
        lay = ops.band_layout(bw, ops.LB_MAX_LENGTH, use_cb=True)
        if bw <= ops.MAX_BAND_WIDTH:
            assert lay == (1, ops.cols_per_thread(bw), 1)
            assert lay.tier == "registers"
            continue
        assert lay.tier == "shared" and lay.warps > 1
        assert 32 * lay.warps <= 1024
        assert lay.segments * ops.WIDE_SEGMENT >= bw
        assert (lay.segments - 1) * ops.WIDE_SEGMENT < bw
        for use_cb in (False, True):
            assert lay.smem_bytes(bw, ops.LB_MAX_LENGTH, use_cb) \
                <= ops.BLOCK_SMEM_MAX
    assert ops.band_layout(224) == (1, 8, 1)
    assert ops.band_layout(2048).segments == 1
    assert ops.band_layout(ops.WIDE_MAX_BAND).smem_bytes(
        ops.WIDE_MAX_BAND, ops.WIDE_MAX_BAND, True) == ops.BLOCK_SMEM_MAX


def test_band_layout_names_the_limit_it_refuses():
    with pytest.raises(ValueError, match="shared memory"):
        ops.band_layout(ops.WIDE_MAX_BAND + 1)
    # the one-warp row's cb slice of m floats in shared memory
    big_m = ops.BLOCK_SMEM_MAX // 4 + 1
    with pytest.raises(ValueError, match="cb slice"):
        ops.band_layout(224, big_m, use_cb=True)
    assert ops.band_layout(224, big_m, use_cb=False).warps == 1
    with pytest.raises(ValueError, match="one warp's registers"):
        ops.cols_per_thread(ops.MAX_BAND_WIDTH + 1)


@pytest.fixture(scope="module")
def wide_case():
    """Two z-normalized queries of LENGTH samples and K windows each of a
    random-walk reference, float32 lane stats and envelopes, the lanes'
    exact distances and a ``ub`` a query between its first and second."""
    rng = np.random.default_rng(11)
    n_ref = 2500
    ref = np.cumsum(rng.normal(size=n_ref)).astype(np.float32) * 0.1
    queries = np.cumsum(rng.normal(size=(2, LENGTH)), axis=1).astype(
        np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)), np.float32)
    mu, sigma = (np.asarray(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), LENGTH))
    u, low = (np.asarray(a, np.float32)
              for a in r_envelope(jnp.asarray(qn), WINDOW))
    starts = rng.integers(0, n_ref - LENGTH + 1, (2, K)).astype(np.int32)
    sg = np.asarray(r_clamp_sigma(jnp.asarray(sigma)), np.float32)
    c = dict(ref=ref, qn=qn, u=u, low=low, starts=starts, mu_l=mu[starts],
             sg_l=sg[starts])
    free = ops.dtw_ea_multi_fused(
        _t(qn), _t(ref), _t(starts), _t(c["mu_l"]), _t(c["sg_l"]),
        torch.full((2, K), BIG), WINDOW, LENGTH).numpy()
    srt = np.sort(free, axis=1)
    ub = np.repeat(0.5 * (srt[:, :1] + srt[:, 1:2]), K, axis=1)
    ub[1, 0] = BIG  # one lane free of any bound
    return c, free, ub.astype(np.float32)


@pytest.mark.parametrize("use_cb", [False, True])
def test_fused_round_plain_matches_pallas_past_one_warp(wide_case, use_cb):
    """Kernel A's plain version against ``_dtw_ea_fused_kernel`` in
    interpret mode at a band of 1100 columns."""
    c, free, ub = wide_case
    assert BW > ops.MAX_BAND_WIDTH
    assert ops.band_layout(BW).tier == "shared"
    want = np.asarray(r_ops.dtw_ea_multi_fused(
        jnp.asarray(c["qn"]), jnp.asarray(c["ref"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["mu_l"]), jnp.asarray(c["sg_l"]), jnp.asarray(ub),
        WINDOW, LENGTH, u=jnp.asarray(c["u"]), low=jnp.asarray(c["low"]),
        use_cb=use_cb, band_width=BW, block_k=4, row_block=128,
        interpret=True,
    ))
    got = ops.dtw_ea_multi_fused(
        _t(c["qn"]), _t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
        _t(c["sg_l"]), _t(ub), WINDOW, LENGTH, u=_t(c["u"]),
        low=_t(c["low"]), use_cb=use_cb, band_width=BW).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, free <= ub)  # ub lies far from every distance
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
    np.testing.assert_allclose(got[fin], free[fin], rtol=1e-5)


@pytest.mark.parametrize("use_cb", [False, True])
def test_slab_round_plain_matches_pallas_past_one_warp(wide_case, use_cb):
    """Kernel D's plain version against ``_dtw_ea_kernel`` in interpret
    mode on the same lanes' window slab (and the host cb slab)."""
    c, free, ub = wide_case
    win, _ = gather_norm_lanes(_t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
                               _t(c["sg_l"]), LENGTH)
    win_np = win.numpy()
    cb_r = None
    cb = None
    if use_cb:
        cb_r = r_cb(jnp.asarray(win_np), jnp.asarray(c["u"])[:, None],
                    jnp.asarray(c["low"])[:, None])
        cb = _t(np.asarray(cb_r, np.float32))
    want = np.asarray(r_ops.dtw_ea_multi(
        jnp.asarray(c["qn"]), jnp.asarray(win_np), jnp.asarray(ub), WINDOW,
        cb=cb_r, band_width=BW, block_k=4, row_block=128, interpret=True))
    got = ops.dtw_ea_multi(_t(c["qn"]), win, _t(ub), WINDOW, cb=cb,
                           band_width=BW).numpy()
    plain = dtw_ea_plain(_t(c["qn"]), win, _t(ub), WINDOW, BW, cb=cb).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, free <= ub)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got, plain)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)


def test_search_past_one_warp_matches_repro():
    """``multi_query_search`` at l = 1100, w = 550 (the band is the whole
    row, past one warp) on a short ECG reference (101 windows, one round
    a query): ``repro``'s winners."""
    n, q, batch = 1200, 2, 128
    ref = make_dataset("ECG", n, seed=0).astype(np.float32)
    queries = make_queries("ECG", q, LENGTH, seed=1).astype(np.float32)
    want = r_multi(jnp.asarray(ref), jnp.asarray(queries), LENGTH, WINDOW,
                   batch=batch, backend="jax")
    got = multi_query_search(ref, queries, LENGTH, WINDOW, batch=batch,
                             device="cpu")
    assert got.best_start.tolist() == np.asarray(want.best_start).tolist()
    np.testing.assert_allclose(got.best_dist.numpy(),
                               np.asarray(want.best_dist), rtol=1e-3)
