"""Kernel B's tiling and its plain version at ragged shapes.

The CUDA kernel (``csrc/lb_keogh.cu``) gives one thread a window and a tile
of queries; ``kernels/ops.py::lb_query_tiles`` picks the tiles and sizes
the block's shared memory. Here that helper is pinned, and the kernel's
plain version, which the wrapper runs for CPU tensors and which
``chip_smoke.py`` holds the kernel against on the card, meets ``repro``'s
``_lb_kernel`` (interpret mode, query by query) and
``kernels/ref.py::lb_all_windows_ref`` at the shapes the kernel's tiling
makes ragged: Q that no tile divides, n_win that no 256-window block
divides, lengths up to the largest whose blocks hold the reference's span
and the largest the kernel takes, quarantined and flat windows, and LB_Kim
or LB_Keogh turned off.

Tolerance ``rtol=1e-5, atol=1e-6``, as in ``test_torch_kernels.py``: both
packages get the same float32 stats; the Pallas kernel multiplies by a
reciprocal where the plain version divides, and sums in another order.
Against the Pallas kernel the relative tolerance is also at least
``length * 2**-24``: it adds a window's ``length`` terms one after another
in float32, whose rounding error grows with the count of terms up to that
bound, while the plain version and ``lb_all_windows_ref`` add them as a
tree (at l = 1024 the two sides differ by up to ~1.6e-5 relative here).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.common import norm_window_slice as r_norm_window_slice
from repro.core.lower_bounds import envelope as r_envelope
from repro.core.lower_bounds import lb_keogh as r_lb_keogh
from repro.core.lower_bounds import lb_kim_fl as r_lb_kim_fl
from repro.kernels import ops as r_ops
from repro.kernels.ref import lb_all_windows_ref
from repro.search.znorm import sanitize_series as r_sanitize_series
from repro.search.znorm import window_finite_mask as r_window_finite_mask
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.kernels import ops

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the tiling helper ------------------------------------------------------

def test_lb_tile_is_the_largest_that_fits_for_every_length():
    """For every accepted length the tile's block fits the budget, and the
    next larger tile would not; the main path's l = 1024 takes 8. Past the
    longest length whose block holds its span, the tile is one query whose
    block holds only the envelope, within the most one block may take."""
    for length in range(1, ops.LB_MAX_LENGTH + 1):
        (q0, tile), *_ = ops.lb_query_tiles(max(ops.LB_QUERY_TILES), length)
        assert q0 == 0 and tile in ops.LB_QUERY_TILES
        span = ops.lb_span_in_smem(length)
        assert span == (length <= ops.LB_SPAN_MAX_LENGTH)
        if not span:
            assert tile == 1
            assert ops.lb_smem_bytes(length, 1, span=False) <= ops.LB_SMEM_MAX
            continue
        assert ops.lb_smem_bytes(length, tile) <= ops.LB_SMEM_BUDGET
        if tile < max(ops.LB_QUERY_TILES):
            assert ops.lb_smem_bytes(length, 2 * tile) > ops.LB_SMEM_BUDGET
    assert ops.lb_query_tiles(8, 1024) == [(0, 8)]
    # Two blocks, each with the SM's 1 KB reservation, fit in 228 KB.
    assert 2 * (ops.LB_SMEM_BUDGET + 1024) <= 228 * 1024
    # Every length whose two envelope rows fit one block is taken.
    assert ops.LB_MAX_LENGTH == ops.LB_SMEM_MAX // 8 == 29_056
    assert ops.LB_SPAN_MAX_LENGTH == 9_557


@pytest.mark.parametrize("n_queries", range(1, 17))
@pytest.mark.parametrize("length", [48, 1024, 2000, 4000, "span", "span+1",
                                    "max"])
def test_lb_tiles_cover_every_query_once(n_queries, length):
    length = {"span": ops.LB_SPAN_MAX_LENGTH,
              "span+1": ops.LB_SPAN_MAX_LENGTH + 1,
              "max": ops.LB_MAX_LENGTH}.get(length, length)
    tiles = ops.lb_query_tiles(n_queries, length)
    covered = [q for q0, t in tiles for q in range(q0, q0 + t)]
    assert covered == list(range(n_queries))
    largest = tiles[0][1]
    span = ops.lb_span_in_smem(length)
    budget = ops.LB_SMEM_BUDGET if span else ops.LB_SMEM_MAX
    for _, t in tiles:
        assert t in ops.LB_QUERY_TILES and t <= largest
        assert ops.lb_smem_bytes(length, t, span=span) <= budget
    # Full tiles first, then one smaller tile for each bit of the tail.
    assert sum(t == largest for _, t in tiles) == n_queries // largest


@pytest.mark.parametrize("length", [0, ops.LB_MAX_LENGTH + 1, 40_000])
def test_lb_tiles_raise_past_the_largest_length(length):
    with pytest.raises(ValueError, match="kernel B"):
        ops.lb_query_tiles(8, length)
    if length > ops.LB_MAX_LENGTH:
        assert ops.lb_smem_bytes(length, 1, span=False) > ops.LB_SMEM_MAX


# --- the plain version at ragged shapes ---------------------------------------

def _ragged(n_queries, length, n_win, nan=False, flat=False, seed=11):
    """A reference with ``n_win`` windows of ``length`` (optionally a NaN
    burst and a flat stretch longer than a window), ``n_queries``
    z-normalized queries, and both packages' float32 inputs."""
    rng = np.random.default_rng(seed)
    n = n_win + length - 1
    raw = (np.sin(np.arange(n) / 13.0) + 0.4 * rng.normal(size=n)).astype(np.float32)
    flat_wins = slice(0, 0)
    if flat:
        f0 = n_win // 3
        raw[f0:f0 + length + 40] = raw[f0]
        flat_wins = slice(f0, f0 + 41)
    if nan:
        raw[n_win // 2:n_win // 2 + 5] = np.nan
    ref = np.asarray(r_sanitize_series(jnp.asarray(raw)), np.float32)
    valid = np.asarray(r_window_finite_mask(jnp.asarray(raw), length))
    mu, sigma = (np.array(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), length))
    # Windows inside the flat stretch are constant: their exact sigma is 0
    # (float32 prefix sums leave a residue), which the kernel clamps to EPS.
    sigma[flat_wins] = 0.0
    window = max(1, length // 10)
    queries = np.cumsum(rng.normal(size=(n_queries, length)), axis=1)
    qn = np.asarray(r_znorm(jnp.asarray(queries.astype(np.float32))), np.float32)
    u, low = (np.asarray(a, np.float32)
              for a in r_envelope(jnp.asarray(qn), window))
    qends = np.stack([qn[:, 0], qn[:, -1]], axis=1).astype(np.float32)
    return dict(ref=ref, valid=valid, mu=mu, sigma=sigma, qn=qn, u=u,
                low=low, qends=qends, length=length, window=window)


def _port(c, **kw):
    return ops.lb_keogh_all_windows(
        _t(c["ref"]), _t(c["mu"]), _t(c["sigma"]), _t(c["u"]), _t(c["low"]),
        _t(c["qends"]), c["length"], valid=_t(c["valid"]), **kw,
    ).numpy()


@pytest.mark.parametrize("n_queries,length,n_win,nan,flat", [
    (1, 48, 333, False, False),
    (3, 1000, 301, True, False),
    (8, 1024, 257, False, True),
    (13, 48, 1000, True, True),
    (2, "span", 70, True, False),  # the longest whose blocks hold the span
    (2, "max", 40, True, False),  # the longest the kernel takes
])
def test_lb_plain_ragged_matches_pallas_interpret_and_ref(
        n_queries, length, n_win, nan, flat):
    length = {"span": ops.LB_SPAN_MAX_LENGTH,
              "max": ops.LB_MAX_LENGTH}.get(length, length)
    c = _ragged(n_queries, length, n_win, nan=nan, flat=flat)
    valid = c["valid"]
    assert valid.all() != nan
    if flat:
        assert (c["sigma"] < 1e-8).any()
    got = _port(c)
    assert got.shape == (n_queries, n_win)
    assert np.isinf(got[:, ~valid]).all() and np.isfinite(got[:, valid]).all()
    for q in range(n_queries):
        pallas = np.asarray(r_ops.lb_keogh_all_windows(
            jnp.asarray(c["ref"]), jnp.asarray(c["mu"]),
            jnp.asarray(c["sigma"]), jnp.asarray(c["u"][q]),
            jnp.asarray(c["low"][q]), jnp.asarray(c["qends"][q]), length,
            chunk=128, interpret=True,
        ))
        oracle = np.asarray(lb_all_windows_ref(
            jnp.asarray(c["ref"]), jnp.asarray(c["qn"][q]),
            jnp.asarray(c["mu"]), jnp.asarray(c["sigma"]), length,
            c["window"],
        ))
        np.testing.assert_allclose(got[q, valid], pallas[valid],
                                   rtol=max(RTOL, length * 2.0**-24),
                                   atol=ATOL)
        np.testing.assert_allclose(got[q, valid], oracle[valid],
                                   rtol=RTOL, atol=ATOL)
    assert ops.lb_keogh_all_windows.launches == 0


@pytest.mark.parametrize("use_kim,use_keogh", [(False, True), (True, False)])
@pytest.mark.parametrize("n_queries,length,n_win", [(3, 1000, 301),
                                                    (13, 48, 1000)])
def test_lb_plain_ragged_one_bound_off(use_kim, use_keogh, n_queries, length,
                                       n_win):
    """LB_Kim or LB_Keogh alone against ``repro``'s ``lb_kim_fl`` /
    ``lb_keogh`` of the same normalized windows."""
    c = _ragged(n_queries, length, n_win, nan=True, flat=True, seed=12)
    valid = c["valid"]
    got = _port(c, use_kim=use_kim, use_keogh=use_keogh)
    assert np.isinf(got[:, ~valid]).all()
    cand = r_norm_window_slice(
        jnp.asarray(c["ref"]), jnp.arange(n_win), length,
        jnp.asarray(c["mu"]), jnp.asarray(c["sigma"]))
    for q in range(n_queries):
        if use_kim:
            want = r_lb_kim_fl(jnp.asarray(c["qn"][q]), cand)
        else:
            want = r_lb_keogh(cand, jnp.asarray(c["u"][q]),
                              jnp.asarray(c["low"][q]))
        np.testing.assert_allclose(got[q, valid], np.asarray(want)[valid],
                                   rtol=RTOL, atol=ATOL)
