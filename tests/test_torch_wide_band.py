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


# The wide row's Hopper layout (csrc/dtw_band_wide.cuh), mirrored here from
# the header's constants (the same as ops'): the previous row striped in
# shared memory (wide_word), the staged window padded a word every 32
# columns (window_word), and the rule that stages the window
# (BandLayout.window_staged). A warp's access costs one shared-memory
# wavefront per distinct bank it hits most often: 32 banks of 4 bytes.
THREADS = 32 * ops.WIDE_WARPS
BANKS = 32


def _row_word(s: int, bw: int) -> int:
    """wide_word: slot g0 + 8t + k at word g0 + k * stride + t."""
    g0 = s - s % ops.WIDE_SEGMENT
    stride = min(THREADS, -(-(bw - g0) // ops.WIDE_CPT))
    r = s - g0
    return g0 + (r % ops.WIDE_CPT) * stride + r // ops.WIDE_CPT


def _window_word(j: int) -> int:
    """window_word of a staged window: a padding word every 32 columns."""
    return j + (j >> 5)


def _ways(words) -> int:
    """Wavefronts of one warp's shared-memory access: the most distinct
    words that fall on one bank (equal words are one broadcast)."""
    per_bank = {}
    for w in set(words):
        per_bank.setdefault(w % BANKS, set()).add(w)
    return max((len(v) for v in per_bank.values()), default=0)


def _smem_blocks(nbytes: int) -> int:
    """Blocks of 256 threads an H100 SM holds by shared memory alone: 228
    KB, 1 KB of it reserved for each block, and 2048 threads."""
    return min(2048 // THREADS, (228 * 1024) // (nbytes + 1024))


ROW_BANDS = (1025, 1031, 1664, 2047, 2048, 2049, 2055, 2500, 4095, 4096,
             6000, 16_384, 16_385, 29_056, ops.WIDE_MAX_BAND - 7,
             ops.WIDE_MAX_BAND)


@pytest.mark.parametrize("bw", ROW_BANDS)
def test_row_map_is_one_to_one_and_conflict_free(bw):
    """Every slot of the band has its own word below ``bw`` rounded up to
    ``WIDE_CPT`` (the row's shared memory); every warp's load and store of
    its threads' slot k, and its neighbour read (slot base + 8 after a
    shift, base - 1 otherwise; thread 0 of the block reads ``sh.edge``
    instead), hits each bank at most once: one wavefront. The kernel's own
    offsets (``seg[k * stride]``, ``g0 + tid + 1``, the next segment's
    first, ``seg[7 * stride - 1]``) are the map's words."""
    words = [_row_word(s, bw) for s in range(bw)]
    row_words = -(-bw // ops.WIDE_CPT) * ops.WIDE_CPT
    assert len(set(words)) == bw and max(words) < row_words
    assert _row_word(0, bw) == 0
    segs = -(-bw // ops.WIDE_SEGMENT)
    for g in range(segs):
        g0 = g * ops.WIDE_SEGMENT
        stride = min(THREADS, -(-(bw - g0) // ops.WIDE_CPT))
        for w in range(ops.WIDE_WARPS):
            tids = range(32 * w, 32 * w + 32)
            for k in range(ops.WIDE_CPT):
                acc = [(tid, g0 + tid * ops.WIDE_CPT + k) for tid in tids
                       if g0 + tid * ops.WIDE_CPT + k < bw]
                for tid, s in acc:
                    assert _row_word(s, bw) == g0 + k * stride + tid
                assert _ways(_row_word(s, bw) for _, s in acc) <= 1
            right = []  # after a shift: slot base + 8
            left = []   # otherwise: slot base - 1
            for tid in tids:
                base = g0 + tid * ops.WIDE_CPT
                if base + ops.WIDE_CPT < bw:
                    nxt = g0 + ops.WIDE_SEGMENT if tid == THREADS - 1 \
                        else g0 + tid + 1
                    assert _row_word(base + ops.WIDE_CPT, bw) == nxt
                    right.append(nxt)
                if tid > 0 and base - 1 < bw:
                    prev = g0 + (ops.WIDE_CPT - 1) * stride + tid - 1
                    assert _row_word(base - 1, bw) == prev
                    left.append(prev)
            assert _ways(right) <= 1 and _ways(left) <= 1


def test_window_map_is_at_most_two_way_conflicted():
    """A warp reads window columns lo + g0 + 8t + k (t its 32 threads):
    with the padding word every 32 columns at most 2 wavefronts for every
    lo mod 32 and k (the segment and warp offsets are multiples of 32 and
    shift every word alike), where the unpadded window takes 8. Staging
    writes columns j = tid + 256 i, one wavefront a warp."""
    worst, unpadded = 0, 0
    for lo in range(BANKS):
        for k in range(ops.WIDE_CPT):
            for base in (0, 32 * 8 * 3, ops.WIDE_SEGMENT):
                cols = [lo + base + ops.WIDE_CPT * t + k for t in range(32)]
                worst = max(worst, _ways(_window_word(c) for c in cols))
                unpadded = max(unpadded, _ways(cols))
    assert worst == 2 and unpadded == 8
    for m in (2048, 8192, 2049, 29_056):
        for j0 in range(0, m, 32):
            cols = range(j0, min(j0 + 32, m))
            assert _ways(_window_word(j) for j in cols) == 1
        assert max(_window_word(j) for j in range(m)) < m + (m >> 5)


@pytest.mark.parametrize("reg_blocks", [1, 2, 3, 4])
def test_window_staged_exactly_where_it_keeps_the_register_blocks(
        reg_blocks):
    """Over every band past one warp, and over the lengths a search can
    reach (a band is at most its length; up to ``LB_MAX_LENGTH``, and full
    rows past it): the window is staged exactly where the staged block
    still leaves ``reg_blocks`` blocks on an SM; a staged block fits
    ``BLOCK_SMEM_MAX`` and keeps at least as many blocks as the unstaged
    one with the same registers; ``smem_bytes`` counts the row (bw
    rounded up to 8), the padded window and the static part. The three
    bands of ``chip_smoke.py`` stage at l = 2048 and 8192 and not at
    16,384 where the registers allow 2 to 4 blocks."""
    lengths = range(1025, ops.LB_MAX_LENGTH + 1, 509)
    cases = [(bw, bw) for bw in range(1025, ops.WIDE_MAX_BAND + 1)]
    cases += [(bw, m) for bw in range(1025, ops.LB_MAX_LENGTH + 1, 61)
              for m in lengths if m >= bw]
    for bw, m in cases:
        lay = ops.band_layout(bw, m, use_cb=True)
        row = 4 * (-(-bw // 8) * 8) + ops.WIDE_STATIC_SMEM
        staged_bytes = row + 4 * (m + m // 32)
        assert lay.smem_bytes(bw, m, True) == row
        assert lay.smem_bytes(bw, m, True, staged=True) == staged_bytes
        assert lay.blocks_by_smem(staged_bytes) == _smem_blocks(staged_bytes)
        staged = lay.window_staged(bw, m, reg_blocks)
        assert staged == (_smem_blocks(staged_bytes) >= reg_blocks)
        assert row <= ops.BLOCK_SMEM_MAX
        if staged:
            assert staged_bytes <= ops.BLOCK_SMEM_MAX
            assert min(reg_blocks, _smem_blocks(staged_bytes)) >= \
                min(reg_blocks, _smem_blocks(row))
    if reg_blocks >= 2:
        for m, bw, want in ((2048, 2048, True), (8192, 1664, True),
                            (16_384, 16_384, False)):
            assert ops.band_layout(bw, m).window_staged(bw, m, reg_blocks) \
                == want
    assert not ops.band_layout(224).window_staged(224, 1024, 1)


@pytest.mark.parametrize("kernel", ["A", "C", "D", "E"])
def test_wide_launch_sizes_grid_and_scratch(monkeypatch, kernel):
    """``_wide_launch`` on a stand-in card (132 SMs, registers for 3
    blocks, the occupancy query answered by the shared-memory model): the
    grid is the resident blocks capped at the lanes; the scratch holds m
    floats a block for the cb suffix where the kernel builds it (A, C, E,
    with ``use_cb``) and m more for the window where the kernel builds it
    (A, C) and does not stage it; none at all where nothing is left."""
    lib, variant, window_scratch, cb_scratch = {
        "A": ("dtw_ea_fused", 0, True, True),
        "C": ("dtw_ea_persistent", 1, True, True),
        "D": ("dtw_ea_slab", 0, False, False),
        "E": ("dtw_ea_persistent", 0, False, True)}[kernel]
    regs, sms = 3, 132

    def blocks(lib_, variant_, staged, bw, m, device):
        assert (lib_, variant_, device) == (lib, variant, 0)
        if bw == 0:
            return regs
        lay = ops.band_layout(bw)
        return min(regs, lay.blocks_by_smem(lay.smem_bytes(bw, m, False,
                                                           staged)))

    monkeypatch.setattr(ops, "_wide_blocks", blocks)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda card: type("P", (), {
                            "multi_processor_count": sms}))
    for m, bw, lanes in ((2048, 2048, 512), (8192, 1664, 512),
                         (16_384, 16_384, 256), (16_384, 16_384, 8)):
        lay = ops.band_layout(bw, m)
        for use_cb in (False, True):
            buf, grid, staged = ops._wide_launch(
                lay, lib, variant, bw, m, use_cb, lanes, torch.device("cpu"),
                window_scratch=window_scratch, cb_scratch=cb_scratch)
            assert staged == (m != 16_384)
            # the row alone leaves 3 blocks an SM at l = 16,384
            assert grid == min(lanes, sms * regs)
            floats = m * (int(window_scratch and not staged)
                          + int(cb_scratch and use_cb))
            if floats == 0:
                assert buf is None
            else:
                assert buf.numel() == grid * floats
    assert ops._wide_launch(ops.band_layout(224), lib, variant, 224, 1024,
                            True, 64, torch.device("cpu")) == (None, 0, False)
