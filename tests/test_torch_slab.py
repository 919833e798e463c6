"""The slab round of the port (kernel D, ``gather="slab"``) against
``repro`` on the CPU.

On CPU tensors ``kernels.ops.dtw_ea_multi`` / ``dtw_ea`` run kernel D's
plain version, ``kernels/dtw_band.py::dtw_ea_plain``, the one slab DP that
kernel A's plain version calls too; ``chip_smoke.py`` holds the CUDA kernel
against it on the card. Here it meets ``repro``'s ``_dtw_ea_kernel`` in
interpret mode and its ``backend="jax"`` batch primitives, fed the same
float32 windows: ``rtol=1e-5``, what is left being the order of float32
sums in the row scan. Against kernel A's plain version on the same lanes
it must agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.batch import ea_pruned_dtw_batch as r_batch
from repro.core.batch import ea_pruned_dtw_multi_batch as r_multi_batch
from repro.core.lower_bounds import cascade_keogh_cumulative as r_cb
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.search.znorm import gather_norm_windows as r_gather
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core import guards
from repro_torch.core.batch import ea_pruned_dtw_batch, ea_pruned_dtw_multi_batch
from repro_torch.core.common import BIG, clamp_sigma, norm_window_slice
from repro_torch.core.lower_bounds import cascade_keogh_cumulative
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import dtw_ea_fused_plain, dtw_ea_plain
from repro_torch.search.znorm import gather_norm_windows

torch.set_num_threads(1)

N_REF, LENGTH, WINDOW, Q, K = 500, 40, 4, 2, 13


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed=2, n=LENGTH):
    """Two queries of ``n`` samples, K windows of LENGTH each, their
    float32 slab and, when ``n == LENGTH``, the envelopes and the cb slab
    (``repro``'s gather and cumsum)."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=N_REF)).astype(np.float32) * 0.1
    ref[200:260] = ref[200]  # flat windows
    queries = np.cumsum(rng.normal(size=(Q, n)), axis=1).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)), np.float32)
    mu, sigma = (np.asarray(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), LENGTH))
    starts = np.stack([
        np.array([0, 7, 190, 205, 215, 230, 300, 333, 350, 400, 410, 420,
                  N_REF - LENGTH]),
        rng.integers(0, N_REF - LENGTH + 1, K),
    ]).astype(np.int32)
    slab = np.asarray(jax.vmap(
        lambda s: r_gather(jnp.asarray(ref), s, LENGTH, jnp.asarray(mu),
                           jnp.asarray(sigma))
    )(jnp.asarray(starts)), np.float32)
    u = low = cb = None
    if n == LENGTH:
        u, low = (np.asarray(a, np.float32)
                  for a in r_envelope(jnp.asarray(qn), WINDOW))
        cb = np.asarray(jax.vmap(r_cb)(jnp.asarray(slab), jnp.asarray(u),
                                       jnp.asarray(low)), np.float32)
    return dict(ref=ref, qn=qn, mu=mu, sigma=sigma, starts=starts, slab=slab,
                u=u, low=low, cb=cb)


def _ub(c, mode, n=LENGTH):
    ub = np.full((Q, K), BIG, np.float32)
    if mode == "dead":
        ub[:, [2, 9]] = -1.0  # the dead-lane sentinel
    elif mode == "tight":
        exact = ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), BIG, WINDOW).numpy()
        for q in range(Q):
            srt = np.sort(exact[q])
            ub[q] = 0.5 * (srt[3] + srt[4])  # four lanes per query finish
    return ub


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("mode", ["dead", "tight"])
def test_slab_plain_matches_pallas_interpret(use_cb, mode):
    """Kernel D's plain version against ``_dtw_ea_kernel`` in interpret
    mode: K = 13 lanes against block_k = 4 (a ragged Pallas block), flat
    windows, dead lanes and a tight ub, with and without the cb slab."""
    c = _case()
    ub = _ub(c, mode)
    cb = c["cb"] if use_cb else None
    want = np.asarray(r_ops.dtw_ea_multi(
        jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(ub), WINDOW,
        cb=None if cb is None else jnp.asarray(cb), block_k=4, row_block=16,
        interpret=True,
    ))
    got = ops.dtw_ea_multi(
        _t(c["qn"]), _t(c["slab"]), _t(ub), WINDOW,
        cb=None if cb is None else _t(cb), block_k=4, row_block=16,
    ).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    if mode == "dead":
        assert np.isinf(got[:, [2, 9]]).all() and fin.sum() == Q * K - 4
    else:
        assert fin.sum() == 8
    assert ops.dtw_ea_multi.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("n", [LENGTH - 9, LENGTH + 7])
def test_slab_plain_full_band_when_lengths_differ(n):
    """``n != m``: the band is the full row, as in ``repro``."""
    c = _case(seed=4, n=n)
    ub = np.full((Q, K), BIG, np.float32)
    ub[0, 5] = -1.0
    want = np.asarray(r_ops.dtw_ea_multi(
        jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(ub), WINDOW,
        block_k=4, row_block=16, interpret=True,
    ))
    got = ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), _t(ub), WINDOW).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin) and not fin[0, 5]
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    with pytest.raises(ValueError, match="equal lengths"):
        ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), _t(ub), WINDOW,
                         band_width=2 * WINDOW + 1)


@pytest.mark.parametrize("use_cb", [False, True])
def test_single_query_slab_matches_pallas_interpret(use_cb):
    """``dtw_ea``: the Q = 1 form, with a ``(K,)`` ub."""
    c = _case(seed=6)
    ub = _ub(c, "dead")[1]
    cb = c["cb"][1] if use_cb else None
    want = np.asarray(r_ops.dtw_ea(
        jnp.asarray(c["qn"][1]), jnp.asarray(c["slab"][1]), jnp.asarray(ub),
        WINDOW, cb=None if cb is None else jnp.asarray(cb), block_k=4,
        row_block=16, interpret=True,
    ))
    got = ops.dtw_ea(_t(c["qn"][1]), _t(c["slab"][1]), _t(ub), WINDOW,
                     cb=None if cb is None else _t(cb)).numpy()
    assert got.shape == (K,)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("mode", ["dead", "tight"])
def test_slab_plain_equals_fused_plain_bit_for_bit(mode):
    """Kernel D's plain version on the slab equals kernel A's on the same
    lanes, ``use_cb`` off: one DP, and the slab holds A's window bits."""
    c = _case(seed=8)
    ub = _t(_ub(c, mode))
    ref, starts, mu, sigma = (_t(c[k]) for k in ("ref", "starts", "mu", "sigma"))
    slab = gather_norm_windows(ref, starts, LENGTH, mu, sigma)
    sg = clamp_sigma(sigma[starts.long()])
    bw = ops.resolve_band(WINDOW, LENGTH, LENGTH, None)
    a = dtw_ea_fused_plain(_t(c["qn"]), ref, starts, mu[starts.long()], sg, ub,
                           WINDOW, LENGTH, bw)
    d = dtw_ea_plain(_t(c["qn"]), slab, ub, WINDOW, bw)
    assert torch.equal(a, d)
    assert torch.isfinite(d).any() and torch.isinf(d).any()


def test_gather_norm_windows_matches_repro_and_norm_window_slice():
    c = _case()
    ref, starts, mu, sigma = (_t(c[k]) for k in ("ref", "starts", "mu", "sigma"))
    got = gather_norm_windows(ref, starts, LENGTH, mu, sigma)
    assert got.shape == (Q, K, LENGTH)
    np.testing.assert_allclose(got.numpy(), c["slab"], rtol=1e-6, atol=1e-6)
    for q in range(Q):
        assert torch.equal(got[q], norm_window_slice(ref, starts[q], LENGTH,
                                                     mu, sigma))


@pytest.mark.parametrize("use_cb", [False, True])
def test_batch_slab_primitives_match_repro_jax(use_cb):
    """``core.batch``'s slab rounds against ``repro``'s ``backend="jax"``
    on the same windows and cb slab."""
    c = _case(seed=10)
    ub = _ub(c, "dead")
    cb = c["cb"] if use_cb else None
    want = np.asarray(r_multi_batch(
        jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(ub), WINDOW,
        cb=None if cb is None else jnp.asarray(cb), backend="jax",
    ))
    got = ea_pruned_dtw_multi_batch(
        _t(c["qn"]), _t(c["slab"]), _t(ub), WINDOW,
        cb=None if cb is None else _t(cb),
    ).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    want1 = np.asarray(r_batch(
        jnp.asarray(c["qn"][0]), jnp.asarray(c["slab"][0]), np.float32(30.0),
        WINDOW, cb=None if cb is None else jnp.asarray(cb[0]), backend="jax",
    ))
    got1 = ea_pruned_dtw_batch(
        _t(c["qn"][0]), _t(c["slab"][0]), 30.0, WINDOW,
        cb=None if cb is None else _t(cb[0]),
    ).numpy()
    fin1 = np.isfinite(want1)
    assert np.array_equal(np.isfinite(got1), fin1)
    np.testing.assert_allclose(got1[fin1], want1[fin1], rtol=1e-5)


def test_host_cb_slab_matches_repro():
    c = _case()
    got = cascade_keogh_cumulative(_t(c["slab"]), _t(c["u"])[:, None],
                                   _t(c["low"])[:, None])
    np.testing.assert_allclose(got.numpy(), c["cb"], rtol=1e-5, atol=1e-6)


def test_slab_unported_and_malformed_raise():
    c = _case()
    qn, slab = _t(c["qn"]), _t(c["slab"])
    # with_info, once refused here, returns the counters beside the same
    # distances (tests/test_torch_counters.py holds them against repro).
    for fn, args in ((ops.dtw_ea_multi, (qn, slab, BIG, WINDOW)),
                     (ea_pruned_dtw_multi_batch, (qn, slab, BIG, WINDOW)),
                     (ea_pruned_dtw_batch, (qn[0], slab[0], BIG, WINDOW))):
        out = fn(*args, with_info=True)
        d, rows = out[0], (out[1].rows if len(out) == 2 else out[1])
        assert torch.equal(d, fn(*args)) and rows.shape == d.shape
    # a multivariate query needs (K, m, dims) candidates, as in repro
    with pytest.raises(guards.SearchInputError, match="candidates must be"):
        ea_pruned_dtw_batch(torch.stack([qn[0], qn[0]], 1), slab[0], BIG,
                            WINDOW)
    with pytest.raises(guards.SearchInputError):
        ea_pruned_dtw_multi_batch(qn, slab[:, :, :-1], BIG, WINDOW)
    with pytest.raises(guards.SearchInputError):
        ea_pruned_dtw_multi_batch(qn[:1], slab, BIG, WINDOW)
    with pytest.raises(TypeError):
        ops.dtw_ea_multi(qn, slab.double(), BIG, WINDOW)
    with pytest.raises(ValueError):
        ops.dtw_ea_multi(qn, slab, BIG, WINDOW, cb=_t(c["cb"])[:, :-1])
