"""The port's two kernels, through their plain PyTorch versions, against
``repro``'s Pallas kernels run in interpret mode on the CPU.

On CPU tensors each wrapper of ``repro_torch.kernels.ops`` runs its kernel's
plain version; the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``. Both packages are fed the same
float32 stats here (``mu``, ``sigma``, envelopes), so the tolerance is
``rtol=1e-5``: what is left is the order of float32 sums (the Pallas row
scan doubles, the plain version's cumsum runs in sequence; the Pallas LB
kernel multiplies by a reciprocal where the plain version divides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.batch import ea_pruned_dtw_multi_batch_fused as r_round
from repro.core.common import clamp_sigma as r_clamp_sigma
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.kernels.ref import lb_all_windows_ref
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core.batch import ea_pruned_dtw_multi_batch_fused
from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw_banded
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import dtw_ea_fused_plain

torch.set_num_threads(1)

N_REF, LENGTH, WINDOW, K = 420, 48, 5, 11


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed=7):
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=N_REF)).astype(np.float32) * 0.1
    ref[100:170] = ref[100]  # sigma == 0 for a run of windows
    queries = np.cumsum(rng.normal(size=(2, LENGTH)), axis=1).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)))
    mu, sigma = (np.asarray(a) for a in r_window_stats(jnp.asarray(ref), LENGTH))
    u, low = (np.asarray(a) for a in r_envelope(jnp.asarray(qn), WINDOW))
    starts = np.stack([
        np.array([0, 17, 99, 105, 110, 120, 200, 250, 300, 330, N_REF - LENGTH]),
        rng.integers(0, N_REF - LENGTH + 1, K),
    ]).astype(np.int32)
    return ref, qn, mu, sigma, u, low, starts


def _lane_stats(mu, sigma, starts):
    sg = np.asarray(r_clamp_sigma(jnp.asarray(sigma)))
    return mu[starts].astype(np.float32), sg[starts].astype(np.float32)


def _exact(ref, qn, mu_l, sg_l, starts):
    """Unpruned distances of every lane (the port's DP oracle, ub=inf)."""
    win = (ref[starts[..., None] + np.arange(LENGTH)] - mu_l[..., None]) / sg_l[..., None]
    d = ea_pruned_dtw_banded(
        _t(np.repeat(qn, K, axis=0)), _t(win.reshape(-1, LENGTH)),
        float("inf"), WINDOW,
    )
    return d.numpy().reshape(2, K)


def _ub(mode, exact):
    ub = np.full((2, K), 1e30, np.float32)
    if mode == "dead":
        ub[:, [3, 7]] = -1.0  # the dead-lane sentinel
    elif mode == "tight":
        # Between two neighbouring exact distances, so no lane sits within
        # rounding of its ub: about three quarters of the lanes abandon.
        for q in range(2):
            srt = np.sort(exact[q])
            ub[q] = 0.5 * (srt[2] + srt[3])
    return ub


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("mode", ["dead", "tight"])
def test_round_plain_matches_pallas_interpret(use_cb, mode):
    """Kernel A's plain version against ``_dtw_ea_fused_kernel`` in
    interpret mode: K = 11 lanes against block_k = 4 (a ragged Pallas
    block), flat windows (starts 105-120), dead lanes, and a tight ub."""
    ref, qn, mu, sigma, u, low, starts = _case()
    mu_l, sg_l = _lane_stats(mu, sigma, starts)
    ub = _ub(mode, _exact(ref, qn, mu_l, sg_l, starts))
    want = np.asarray(r_ops.dtw_ea_multi_fused(
        jnp.asarray(qn), jnp.asarray(ref), jnp.asarray(starts),
        jnp.asarray(mu_l), jnp.asarray(sg_l), jnp.asarray(ub), WINDOW, LENGTH,
        u=jnp.asarray(u), low=jnp.asarray(low), use_cb=use_cb, block_k=4,
        row_block=16, interpret=True,
    ))
    got = ops.dtw_ea_multi_fused(
        _t(qn), _t(ref), _t(starts), _t(mu_l), _t(sg_l), _t(ub), WINDOW,
        LENGTH, u=_t(u), low=_t(low), use_cb=use_cb, block_k=4, row_block=16,
    ).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    if mode == "dead":
        assert np.all(np.isinf(got[:, [3, 7]])) and fin.sum() == 2 * K - 4
    else:
        assert fin.sum() == 6  # three lanes per query survive
    assert ops.dtw_ea_multi_fused.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("band_width", [None, 11, 48])
def test_round_plain_band_width_invariant(band_width):
    """Results do not depend on the band while it covers 2*w+1 columns."""
    ref, qn, mu, sigma, u, low, starts = _case(seed=3)
    mu_l, sg_l = _lane_stats(mu, sigma, starts)
    args = (_t(qn), _t(ref), _t(starts), _t(mu_l), _t(sg_l),
            _t(np.full((2, K), 1e30, np.float32)), WINDOW, LENGTH)
    base = ops.dtw_ea_multi_fused(*args)
    got = ops.dtw_ea_multi_fused(*args, band_width=band_width)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5)


def test_round_plain_counts_work():
    ref, qn, mu, sigma, u, low, starts = _case()
    mu_l, sg_l = _lane_stats(mu, sigma, starts)
    ub = np.full((2, K), 1e30, np.float32)
    ub[0, 0] = -1.0
    _, rows, cells = dtw_ea_fused_plain(
        _t(qn), _t(ref), _t(starts), _t(mu_l), _t(sg_l), _t(ub), WINDOW,
        LENGTH, 32, count=True,
    )
    assert rows[0, 0] == 1 and rows[0, 1] == LENGTH
    band = sum(min(LENGTH - 1, i + WINDOW) - max(0, i - WINDOW) + 1
               for i in range(LENGTH))
    assert cells[1, 4] == band


@pytest.mark.parametrize("use_cb", [False, True])
def test_batch_round_matches_repro_jax(use_cb):
    """``core.batch`` (stats tables indexed by start, sigma clamped at the
    boundary) against ``repro``'s jax fused round on the same tables."""
    ref, qn, mu, sigma, u, low, starts = _case(seed=11)
    ub = np.full((2, K), 1e30, np.float32)
    ub[1, 2] = -1.0
    env_r = (jnp.asarray(u), jnp.asarray(low)) if use_cb else None
    want = np.asarray(r_round(
        jnp.asarray(qn), jnp.asarray(ref), jnp.asarray(starts), jnp.asarray(ub),
        WINDOW, jnp.asarray(mu), jnp.asarray(sigma), envelopes=env_r,
        backend="jax",
    ))
    got = ea_pruned_dtw_multi_batch_fused(
        _t(qn), _t(ref), _t(starts), _t(ub), WINDOW, _t(mu), _t(sigma),
        envelopes=(_t(u), _t(low)) if use_cb else None,
    ).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_round_out_of_range_starts_are_nan():
    """A lane whose start lies outside ``[0, N - m]`` comes back NaN (the
    kernel checks the range per lane, with no host sync); the other lanes
    are untouched, through the wrapper and through ``core.batch``."""
    ref, qn, mu, sigma, u, low, starts = _case()
    mu_l, sg_l = _lane_stats(mu, sigma, starts)
    ub = np.full((2, K), 1e30, np.float32)
    base = ops.dtw_ea_multi_fused(
        _t(qn), _t(ref), _t(starts), _t(mu_l), _t(sg_l), _t(ub), WINDOW, LENGTH,
    ).numpy()
    bad = starts.copy()
    bad[0, 2], bad[1, 5] = -1, N_REF - LENGTH + 1
    got = ops.dtw_ea_multi_fused(
        _t(qn), _t(ref), _t(bad), _t(mu_l), _t(sg_l), _t(ub), WINDOW, LENGTH,
    ).numpy()
    flagged = np.zeros((2, K), bool)
    flagged[0, 2] = flagged[1, 5] = True
    assert np.isnan(got[flagged]).all() and not np.isnan(got[~flagged]).any()
    np.testing.assert_array_equal(got[~flagged], base[~flagged])
    via_batch = ea_pruned_dtw_multi_batch_fused(
        _t(qn), _t(ref), _t(bad), _t(ub), WINDOW, _t(mu), _t(sigma),
    ).numpy()
    assert np.array_equal(np.isnan(via_batch), flagged)


def test_batch_round_with_info_not_ported():
    """The counters were once refused here; the round now returns
    ``(distances, EAInfo)`` with the counter-free round's distances and the
    plain version's per-lane counters (``tests/test_torch_counters.py``
    holds them against ``repro``)."""
    ref, qn, mu, sigma, u, low, starts = _case()
    d, info = ea_pruned_dtw_multi_batch_fused(
        _t(qn), _t(ref), _t(starts), 1e30, WINDOW, _t(mu), _t(sigma),
        with_info=True,
    )
    free = ea_pruned_dtw_multi_batch_fused(
        _t(qn), _t(ref), _t(starts), 1e30, WINDOW, _t(mu), _t(sigma),
    )
    assert torch.equal(d, free)
    assert info.rows.dtype == torch.int32 and info.cells.dtype == torch.int32
    assert info.rows.tolist() == [[LENGTH] * K] * 2  # ub = BIG: every row
    assert (info.cells > LENGTH).all()


def _lb_inputs(n=1200, length=40, window=4, seed=5):
    rng = np.random.default_rng(seed)
    ref = (np.sin(np.arange(n) / 9.0) + 0.3 * rng.normal(size=n)).astype(np.float32)
    ref[500:560] = 1.25  # flat windows
    queries = rng.normal(size=(3, length)).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)))
    mu, sigma = (np.asarray(a) for a in r_window_stats(jnp.asarray(ref), length))
    u, low = (np.asarray(a) for a in r_envelope(jnp.asarray(qn), window))
    qends = np.stack([qn[:, 0], qn[:, -1]], axis=1).astype(np.float32)
    return ref, qn, mu, sigma, u, low, qends, length, window


def test_lb_plain_matches_pallas_interpret_and_ref():
    """Kernel B's plain version against ``_lb_kernel`` in interpret mode and
    against ``kernels/ref.py::lb_all_windows_ref``, query by query, and the
    batched Q-query form against both."""
    ref, qn, mu, sigma, u, low, qends, length, window = _lb_inputs()
    got = ops.lb_keogh_all_windows(
        _t(ref), _t(mu), _t(sigma), _t(u), _t(low), _t(qends), length,
        chunk=256,
    ).numpy()
    assert got.shape == (3, N_WIN := ref.shape[0] - length + 1)
    for q in range(3):
        pallas = np.asarray(r_ops.lb_keogh_all_windows(
            jnp.asarray(ref), jnp.asarray(mu), jnp.asarray(sigma),
            jnp.asarray(u[q]), jnp.asarray(low[q]), jnp.asarray(qends[q]),
            length, chunk=256, interpret=True,
        ))
        oracle = np.asarray(lb_all_windows_ref(
            jnp.asarray(ref), jnp.asarray(qn[q]), jnp.asarray(mu),
            jnp.asarray(sigma), length, window,
        ))
        single = ops.lb_keogh_all_windows(
            _t(ref), _t(mu), _t(sigma), _t(u[q]), _t(low[q]), _t(qends[q]),
            length,
        ).numpy()
        assert single.shape == (N_WIN,)
        np.testing.assert_array_equal(single, got[q])
        np.testing.assert_allclose(got[q], pallas, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[q], oracle, rtol=1e-5, atol=1e-6)
    assert ops.lb_keogh_all_windows.launches == 0


def test_lb_plain_mask_and_single_bounds():
    from repro_torch.core.common import norm_window_slice
    from repro_torch.core.lower_bounds import lb_keogh, lb_kim_fl

    ref, qn, mu, sigma, u, low, qends, length, window = _lb_inputs(seed=9)
    n_win = ref.shape[0] - length + 1
    valid = np.ones(n_win, bool)
    valid[[0, 77, n_win - 1]] = False
    args = (_t(ref), _t(mu), _t(sigma), _t(u), _t(low), _t(qends), length)
    got = ops.lb_keogh_all_windows(*args, valid=_t(valid)).numpy()
    assert np.all(np.isinf(got[:, ~valid])) and np.all(np.isfinite(got[:, valid]))
    win = norm_window_slice(_t(ref), torch.arange(n_win), length, _t(mu), _t(sigma))
    kim = ops.lb_keogh_all_windows(*args, use_keogh=False).numpy()
    keogh = ops.lb_keogh_all_windows(*args, use_kim=False).numpy()
    for q in range(3):
        np.testing.assert_allclose(kim[q], lb_kim_fl(_t(qn[q]), win).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            keogh[q], lb_keogh(win, _t(u[q]), _t(low[q])).numpy(), rtol=1e-5)


def _round_args():
    ref, qn, mu, sigma, u, low, starts = _case()
    mu_l, sg_l = _lane_stats(mu, sigma, starts)
    return dict(queries=_t(qn), ref=_t(ref), starts=_t(starts), mu=_t(mu_l),
                sg=_t(sg_l), ub=_t(np.full((2, K), 1e30, np.float32)),
                window=WINDOW, length=LENGTH)


@pytest.mark.parametrize("change,exc", [
    (dict(ref=lambda a: a["ref"].double()), TypeError),
    (dict(starts=lambda a: a["starts"].long()), TypeError),
    (dict(mu=lambda a: a["mu"][:, :5]), ValueError),
    (dict(ub=lambda a: a["ub"].t().contiguous().t()), ValueError),
    (dict(queries=lambda a: a["queries"].numpy()), TypeError),
    (dict(band_width=lambda a: 8), ValueError),
    (dict(use_cb=lambda a: True), ValueError),
    (dict(ref=lambda a: a["ref"].to("meta"), queries=lambda a: a["queries"].to("meta"),
          starts=lambda a: a["starts"].to("meta"), mu=lambda a: a["mu"].to("meta"),
          sg=lambda a: a["sg"].to("meta"), ub=lambda a: a["ub"].to("meta")),
     ValueError),
])
def test_round_wrapper_checks_inputs(change, exc):
    """The wrapper checks device, dtype, shape and contiguity, and has no
    kernel for a device other than the CPU's plain version or CUDA."""
    a = _round_args()
    a.update({k: f(a) for k, f in change.items()})
    with pytest.raises(exc):
        ops.dtw_ea_multi_fused(**a)


def test_lb_wrapper_checks_inputs():
    ref, qn, mu, sigma, u, low, qends, length, window = _lb_inputs()
    with pytest.raises(ValueError):
        ops.lb_keogh_all_windows(_t(ref), _t(mu[:-1]), _t(sigma), _t(u),
                                 _t(low), _t(qends), length)
    with pytest.raises(TypeError):
        ops.lb_keogh_all_windows(_t(ref).double(), _t(mu), _t(sigma), _t(u),
                                 _t(low), _t(qends), length)
    with pytest.raises(TypeError):
        ops.lb_keogh_all_windows(_t(ref), _t(mu), _t(sigma), _t(u), _t(low),
                                 _t(qends), length,
                                 valid=torch.ones(mu.shape[0]))
