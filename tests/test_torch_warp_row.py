"""The warp-per-lane DP row of the port's DTW kernels, through what the CPU
can reach: the choice of columns a thread, the plain round at band widths
that reach each instantiation of the row, and the property the persistent
sweep's incumbent re-read rests on.

Up to 1,024 columns the CUDA kernels hold a lane's band in one warp's
registers, ``CPT`` columns a thread (``kernels/ops.py::cols_per_thread``;
``csrc/dtw_band.cuh``); wider bands run the wide layout, a thread block of
8 warps a lane with the previous DP row in shared memory
(``kernels/ops.py::band_layout``; ``csrc/dtw_band_wide.cuh``;
``tests/test_torch_wide_band.py``). Both are held against the plain
versions on the card by ``chip_smoke.py``.
Here the plain round meets ``repro``'s ``_dtw_ea_fused_kernel`` in
interpret mode at l = 1024, fed the same float32 stats and envelopes.

Tolerances: ``rtol=1e-5`` on distances, as in ``test_torch_kernels.py``:
both packages get the same float32 stats, and what is left is the order of
float32 sums in the row scan (the Pallas row scan doubles, the plain one
runs in sequence). ``P``, the running cost sum, covers every band column,
existing or not, so a wider band rounds more; at bw = 1024 the two sides
differ by ~2e-6 relative here. Abandon masks exactly: each ``ub`` lies
between two neighbouring exact distances, far from both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.common import clamp_sigma as r_clamp_sigma
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core.common import BIG
from repro_torch.core.lower_bounds import cascade_keogh_cumulative
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import dtw_ea_plain, gather_norm_lanes

torch.set_num_threads(1)

LENGTH, K = 1024, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(window, seed=4, n_ref=3000):
    """Two z-normalized queries of LENGTH samples and K windows each of a
    random-walk reference, with float32 lane stats and envelopes."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=n_ref)).astype(np.float32) * 0.1
    queries = np.cumsum(rng.normal(size=(2, LENGTH)), axis=1).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)), np.float32)
    mu, sigma = (np.asarray(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), LENGTH))
    u, low = (np.asarray(a, np.float32)
              for a in r_envelope(jnp.asarray(qn), window))
    starts = rng.integers(0, n_ref - LENGTH + 1, (2, K)).astype(np.int32)
    sg = np.asarray(r_clamp_sigma(jnp.asarray(sigma)), np.float32)
    return dict(ref=ref, qn=qn, u=u, low=low, starts=starts,
                mu_l=mu[starts], sg_l=sg[starts])


@pytest.mark.parametrize("bw,cpt", [
    (1, 1), (31, 1), (32, 1), (33, 2), (224, 8), (256, 8), (257, 16),
    (1023, 32), (1024, 32),
])
def test_cols_per_thread(bw, cpt):
    """The smallest power of two that spreads the band over 32 threads."""
    assert ops.cols_per_thread(bw) == cpt
    assert 32 * cpt >= bw and (cpt == 1 or 16 * cpt < bw)


@pytest.mark.parametrize("bw", [1025, 2048])
def test_cols_per_thread_raises_above_one_warp(bw):
    with pytest.raises(ValueError, match="one warp's registers"):
        ops.cols_per_thread(bw)


WINDOW_NARROW = 15  # 2w + 1 = 31: every band width below is admissible


@pytest.fixture(scope="module")
def narrow():
    """The case at w = 15, its exact distances at the narrowest band, and a
    ``ub`` a query between its first and second smallest distance."""
    c = _case(WINDOW_NARROW)
    free = ops.dtw_ea_multi_fused(
        _t(c["qn"]), _t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
        _t(c["sg_l"]), torch.full((2, K), BIG), WINDOW_NARROW, LENGTH,
        band_width=32,
    ).numpy()
    srt = np.sort(free, axis=1)
    ub = np.repeat(0.5 * (srt[:, :1] + srt[:, 1:2]), K, axis=1)
    ub[1, 0] = BIG  # one lane free of any bound
    return c, free, ub.astype(np.float32)


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("bw", [32, 64, 224, 256, 1024])
def test_round_plain_matches_pallas_at_band_width(narrow, bw, use_cb):
    """Kernel A's plain version against ``_dtw_ea_fused_kernel`` in
    interpret mode at band widths that reach each columns-a-thread
    instantiation (1, 2, 8, 8, 32), and against itself at the narrowest
    band: the band never changes a result while it covers 2w + 1."""
    c, free, ub = narrow
    env_r = dict(u=jnp.asarray(c["u"]), low=jnp.asarray(c["low"]),
                 use_cb=use_cb)
    want = np.asarray(r_ops.dtw_ea_multi_fused(
        jnp.asarray(c["qn"]), jnp.asarray(c["ref"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["mu_l"]), jnp.asarray(c["sg_l"]), jnp.asarray(ub),
        WINDOW_NARROW, LENGTH, band_width=bw, block_k=4, row_block=128,
        interpret=True, **env_r,
    ))
    args = (_t(c["qn"]), _t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
            _t(c["sg_l"]), _t(ub), WINDOW_NARROW, LENGTH)
    env = dict(u=_t(c["u"]), low=_t(c["low"]), use_cb=use_cb)
    got = ops.dtw_ea_multi_fused(*args, band_width=bw, **env).numpy()
    base = ops.dtw_ea_multi_fused(*args, band_width=32, **env).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, free <= ub)  # ub lies far from every distance
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(np.isfinite(base), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    np.testing.assert_allclose(got[fin], base[fin], rtol=1e-5)
    np.testing.assert_allclose(got[fin], free[fin], rtol=1e-5)


WINDOW_MAIN = 102  # the main path's ratio, w = 0.1 * l


@pytest.mark.parametrize("use_cb", [False, True])
def test_finished_lane_bits_do_not_depend_on_ub_main_ratio(use_cb):
    """At the main path's shapes (l = 1024, w = 102, bw = 224, CPT = 8): a
    lane that finishes gives the same bits under ``ub = BIG``, its own
    distance, and the bounds between them that the persistent sweep's
    incumbent re-read can hand it; one ulp below its distance it abandons."""
    c = _case(WINDOW_MAIN, seed=9)
    win, _ = gather_norm_lanes(_t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
                               _t(c["sg_l"]), LENGTH)
    cb = None
    if use_cb:
        cb = cascade_keogh_cumulative(win, _t(c["u"])[:, None],
                                      _t(c["low"])[:, None])
    bw = ops.resolve_band(WINDOW_MAIN, LENGTH, LENGTH, None)
    assert ops.cols_per_thread(bw) == 8
    qn = _t(c["qn"])
    free = dtw_ea_plain(qn, win, torch.full((2, K), BIG), WINDOW_MAIN, bw,
                        cb=cb)
    assert torch.isfinite(free).all()
    for ub in (free, free * (1 + 1e-6), free * 1.5, free * 1e3):
        assert torch.equal(dtw_ea_plain(qn, win, ub, WINDOW_MAIN, bw, cb=cb),
                           free)
    below = dtw_ea_plain(qn, win, torch.nextafter(free, torch.zeros(())),
                         WINDOW_MAIN, bw, cb=cb)
    assert torch.isinf(below).all()
