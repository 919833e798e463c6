"""The port's language models against ``repro``'s on the same weights.

For every arch at ``reduced()`` (float32), on weights carried over from
``repro`` (``interop.lm_params_from_numpy``) and the same seeded inputs:
forward logits, the aux loss and ``loss_fn``; ``decode_step`` from
``init_cache`` (whisper after ``prefill_encoder``); ``prefill`` then
decode (transformer family, mamba2), caches included. Then the paths that
only some shapes reach: the rolling SWA cache across three wraps and its
prefill hand-off, the chunked online-softmax attention, the MoE with and
without capacity drops, mamba2 with S not a multiple of ``ssm_chunk`` and
a carried state, recurrentgemma with whole pattern groups and a
remainder, and a decode past a non-rolling cache's end (clamped, as
``dynamic_update_slice`` clamps). Logits within ``lm_pairs.ATOL``
(1e-5; measured under 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as r_attention
from repro.configs import ARCHS as R_ARCHS
from repro.distributed import hints as r_hints
from repro.models import common as r_common
from repro.models import mamba2 as r_mamba2
from repro.models import mlp as r_mlp
from repro_torch.configs import ARCHS
from repro_torch.distributed import hints
from repro_torch.models import attention, common, mamba2, mlp
from repro_torch.models.registry import build

from lm_pairs import ATOL, close, close_tree, inputs, pair

B, S = 2, 12
ALL = sorted(R_ARCHS)
PREFILL = [n for n in ALL if ARCHS[n].family in ("dense", "moe", "vlm", "ssm")]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("name", ALL)
def test_forward_aux_and_loss_match_repro(name):
    pr = pair(name)
    rng = np.random.default_rng(1)
    kw_r, kw_t = inputs(pr.cfg, rng, B, S)
    lr, ar = pr.r_forward(pr.r_params, **kw_r)
    lt, at = pr.model.forward(pr.params, **kw_t)
    close(lr, lt)
    close(ar, at)
    labels = rng.integers(0, pr.cfg.vocab, (B, S))
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    for extra in ({}, {"mask": mask}):
        batch_r = dict(kw_r, labels=jnp.asarray(labels),
                       **{k: jnp.asarray(v) for k, v in extra.items()})
        batch_t = dict(kw_t, labels=torch.as_tensor(labels),
                       **{k: torch.as_tensor(v) for k, v in extra.items()})
        close(pr.r_model.loss_fn(pr.r_params, batch_r),
              pr.model.loss_fn(pr.params, batch_t))


@pytest.mark.parametrize("name", ALL)
def test_init_params_have_repros_layout(name):
    """The port's own init gives the tree that carrying repro's gives:
    the same names, shapes and types."""
    pr = pair(name)
    mine = pr.model.init(torch.Generator().manual_seed(0), "cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in pr.params.named_parameters()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in mine.named_parameters()}
    assert got == want
    assert all(not v.requires_grad for v in mine.parameters())
    assert ("unembed" in mine) == (not pr.cfg.tie_embeddings)


@pytest.mark.parametrize("name", ALL)
def test_decode_from_init_cache_matches_repro(name):
    pr = pair(name)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, pr.cfg.vocab, (B, S))
    cache_r = pr.r_model.init_cache(B, S)
    cache_t = pr.model.init_cache(B, S, device="cpu")
    close_tree(cache_r, cache_t)
    if pr.cfg.family == "audio":
        frames = rng.normal(size=(B, 7, pr.cfg.d_model)).astype(np.float32)
        cache_r = pr.r_model.prefill(pr.r_params, cache_r,
                                     embeds=jnp.asarray(frames))
        cache_t = pr.model.prefill(pr.params, cache_t,
                                   embeds=torch.as_tensor(frames))
        close_tree(cache_r, cache_t)
    for t in range(S):
        lr, cache_r = pr.r_decode(pr.r_params, cache_r,
                                  jnp.asarray(toks[:, t:t + 1]), t)
        lt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(lr, lt)
    close_tree(cache_r, cache_t)


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_then_decode_matches_repro(name):
    # capacity 100: no token is dropped, as test_models.py runs the MoE
    pr = pair(name, capacity_factor=100.0)
    rng = np.random.default_rng(3)
    t0, total = 7, S
    kw_r, kw_t = inputs(pr.cfg, rng, B, t0)
    toks = rng.integers(0, pr.cfg.vocab, (B, total))
    lr, cache_r = pr.r_model.prefill(pr.r_params, pr.r_model.init_cache(B, total),
                                     **kw_r)
    lt, cache_t = pr.model.prefill(
        pr.params, pr.model.init_cache(B, total, device="cpu"), **kw_t)
    close(lr, lt)
    close_tree(cache_r, cache_t)
    for t in range(t0, total):
        lr, cache_r = pr.r_decode(pr.r_params, cache_r,
                                  jnp.asarray(toks[:, t:t + 1]), t)
        lt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(lr, lt)
    close_tree(cache_r, cache_t)


def test_rolling_swa_cache_across_three_wraps():
    """Window-6 rolling cache over 20 steps: each step's logits equal
    repro's and the port's own forward's."""
    pr = pair("h2o-danube-3-4b", sliding_window=6)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, pr.cfg.vocab, (B, 20))
    full, _ = pr.model.forward(pr.params, tokens=torch.as_tensor(toks))
    close(pr.r_forward(pr.r_params, tokens=jnp.asarray(toks))[0], full)
    cache_r = pr.r_model.init_cache(B, 20)
    cache_t = pr.model.init_cache(B, 20, device="cpu")
    assert cache_t["k"].shape[2] == 6
    for t in range(20):
        lr, cache_r = pr.r_decode(pr.r_params, cache_r,
                                  jnp.asarray(toks[:, t:t + 1]), t)
        lt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(lr, lt)
        close(lr[:, 0], full[:, t], atol=1e-4)  # test_serve.py's bound
    close_tree(cache_r, cache_t)


def test_rolling_swa_prefill_handoff():
    """Prefill 13 tokens into the window-6 cache (rolled), decode on."""
    pr = pair("h2o-danube-3-4b", sliding_window=6)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, pr.cfg.vocab, (B, 20))
    full, _ = pr.model.forward(pr.params, tokens=torch.as_tensor(toks))
    lr, cache_r = pr.r_model.prefill(pr.r_params, pr.r_model.init_cache(B, 20),
                                     tokens=jnp.asarray(toks[:, :13]))
    lt, cache_t = pr.model.prefill(pr.params, pr.model.init_cache(B, 20, device="cpu"),
                                   tokens=torch.as_tensor(toks[:, :13]))
    close(lr, lt)
    close_tree(cache_r, cache_t)
    close(lr[:, 0], full[:, 12], atol=1e-4)
    for t in range(13, 20):
        lr, cache_r = pr.r_decode(pr.r_params, cache_r,
                                  jnp.asarray(toks[:, t:t + 1]), t)
        lt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(lr, lt)
        close(lr[:, 0], full[:, t], atol=1e-4)


@pytest.mark.parametrize("name,window", [("llama3.2-3b", 0),
                                         ("h2o-danube-3-4b", 5),
                                         ("whisper-large-v3", 0)])
def test_chunked_path_with_the_threshold_patched_low(monkeypatch, name, window):
    """CHUNKED_THRESHOLD at 8 on both packages: forward and prefill take
    the online-softmax path (one padded chunk of 1024) and agree with
    repro's, and with the port's plain path."""
    changes = {"sliding_window": window} if window else {}
    pr = pair(name, **changes)
    rng = np.random.default_rng(4)
    kw_r, kw_t = inputs(pr.cfg, rng, B, S)
    plain, _ = pr.model.forward(pr.params, **kw_t)
    monkeypatch.setattr(r_attention, "CHUNKED_THRESHOLD", 8)
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 8)
    calls = []
    chunked = attention._attend_chunked
    monkeypatch.setattr(attention, "_attend_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    lr, _ = pr.r_model.forward(pr.r_params, **kw_r)  # eager: reads the patch
    lt, _ = pr.model.forward(pr.params, **kw_t)
    assert calls
    close(lr, lt)
    close(plain, lt)
    if pr.cfg.family != "audio":
        r_pre, _ = pr.r_model.prefill(pr.r_params, pr.r_model.init_cache(B, S),
                                      **kw_r)
        t_pre, _ = pr.model.prefill(
            pr.params, pr.model.init_cache(B, S, device="cpu"), **kw_t)
        close(r_pre, t_pre)


@pytest.mark.parametrize("causal,window,t", [(True, 0, 23), (True, 6, 23),
                                              (False, 0, 17), (True, 0, 16)])
def test_attend_chunked_over_several_chunks(causal, window, t):
    """Chunks of 4 keys (the last one padded unless t % 4 == 0), both
    packages on the same q/k/v, and the port's plain ``_attend``."""
    cfg = ARCHS["llama3.2-3b"].reduced()
    rng = np.random.default_rng(5)
    s = t if causal else 9
    q = rng.normal(size=(B, s, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    k = rng.normal(size=(B, t, cfg.n_kv, cfg.head_dim)).astype(np.float32)
    v = rng.normal(size=(B, t, cfg.n_kv, cfg.head_dim)).astype(np.float32)
    want = r_attention._attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), cfg, causal, window,
                                       kv_chunk=4)
    got = attention._attend_chunked(_t(q), _t(k), _t(v), cfg, causal, window,
                                    kv_chunk=4)
    close(want, got)
    if causal:
        mask = attention.causal_mask(s, window)
    else:
        mask = torch.ones((1, s, t), dtype=torch.bool)
    close(np.asarray(want), attention._attend(_t(q), _t(k), _t(v), mask, cfg))


@pytest.mark.parametrize("capacity", [0.1, 100.0])
@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"])
def test_moe_layer_and_forward_at_capacity(name, capacity):
    """At capacity 0.1 the experts drop most assignments: the port drops
    the same ones (same outputs), and differs from the undropped layer."""
    pr = pair(name, capacity_factor=capacity)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 10, pr.cfg.d_model)).astype(np.float32)
    lp_r = jax.tree.map(lambda a: a[0], pr.r_params["layers"])["moe"]
    lp_t = pr.params["layers"][0]["moe"]
    yr, ar = r_mlp.moe(lp_r, jnp.asarray(x), pr.cfg)
    yt, at = mlp.moe(lp_t, _t(x), pr.cfg)
    # repro's dense_init takes fan_in from an expert stack's first axis
    # (E), so the experts' outputs reach |y| ~ 1e2 here: ATOL relative
    close(yr, yt, atol=ATOL * max(1.0, float(jnp.max(jnp.abs(yr)))))
    close(ar, at)
    wide, _ = mlp.moe(lp_t, _t(x), dataclasses.replace(pr.cfg, capacity_factor=100.0))
    dropped = bool((wide - yt).abs().max() > 1e-3)
    assert dropped == (capacity < 1)
    kw_r, kw_t = inputs(pr.cfg, rng, B, S)
    close(pr.r_forward(pr.r_params, **kw_r)[0],
          pr.model.forward(pr.params, **kw_t)[0])


@pytest.mark.parametrize("s", [13, 16, 1])
def test_ssd_chunked_padding_and_carried_state(s):
    """S not a multiple of ssm_chunk (8) is padded; an h0 is carried."""
    rng = np.random.default_rng(7)
    bs, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(bs, s, h, p)).astype(np.float32)
    dt = rng.random((bs, s, h)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = rng.normal(size=(bs, s, n)).astype(np.float32)
    c = rng.normal(size=(bs, s, n)).astype(np.float32)
    h0 = rng.normal(size=(bs, h, p, n)).astype(np.float32)
    for init in (None, h0):
        yr, lr = r_mamba2.ssd_chunked(
            *map(jnp.asarray, (x, dt, a_log, b, c)), 8,
            h0=None if init is None else jnp.asarray(init))
        yt, lt = mamba2.ssd_chunked(*map(_t, (x, dt, a_log, b, c)), 8,
                                    h0=None if init is None else _t(init))
        close(yr, yt)
        close(lr, lt)


def test_mamba2_forward_with_ragged_sequence():
    pr = pair("mamba2-130m")
    assert pr.cfg.ssm_chunk == 8
    rng = np.random.default_rng(8)
    kw_r, kw_t = inputs(pr.cfg, rng, B, 21)
    close(pr.r_forward(pr.r_params, **kw_r)[0],
          pr.model.forward(pr.params, **kw_t)[0])


@pytest.mark.parametrize("n_layers", [3, 4])
def test_recurrentgemma_groups_and_remainder(n_layers):
    """n_layers 3: one whole group; 4: one group and one remainder block
    (reduced has 2: no group, two remainder blocks)."""
    pr = pair("recurrentgemma-2b", n_layers=n_layers)
    assert len(pr.params["groups"]) == 1
    assert len(pr.params["remainder"]) == n_layers - 3
    rng = np.random.default_rng(9)
    toks = rng.integers(0, pr.cfg.vocab, (B, 20))
    lr, _ = pr.r_forward(pr.r_params, tokens=jnp.asarray(toks))
    lt, _ = pr.model.forward(pr.params, tokens=torch.as_tensor(toks))
    close(lr, lt)
    cache_r = pr.r_model.init_cache(B, 20)
    cache_t = pr.model.init_cache(B, 20, device="cpu")
    for t in range(20):  # the local window is 16: the attention cache rolls
        dr, cache_r = pr.r_decode(pr.r_params, cache_r,
                                  jnp.asarray(toks[:, t:t + 1]), t)
        dt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(dr, dt)
    close_tree(cache_r, cache_t)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "whisper-large-v3"])
def test_decode_past_the_cache_end_clamps(name):
    """A non-rolling cache of 6 decoded at positions 6 and 8: repro's
    ``dynamic_update_slice`` (and whisper's ``dynamic_slice`` of the
    position table) clamps to the last slot, and so does the port."""
    pr = pair(name)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, pr.cfg.vocab, (B, 9))
    cache_r = pr.r_model.init_cache(B, 6)
    cache_t = pr.model.init_cache(B, 6, device="cpu")
    if pr.cfg.family == "audio":
        frames = rng.normal(size=(B, 5, pr.cfg.d_model)).astype(np.float32)
        cache_r = pr.r_model.prefill(pr.r_params, cache_r, embeds=jnp.asarray(frames))
        cache_t = pr.model.prefill(pr.params, cache_t, embeds=torch.as_tensor(frames))
    for t in (0, 1, 2, 3, 4, 5, 6, 8):
        before = cache_t["k"][:, :, 5].clone()
        lr, cache_r = pr.r_model.decode_step(pr.r_params, cache_r,
                                             jnp.asarray(toks[:, t:t + 1]), t)
        lt, cache_t = pr.model.decode_step(pr.params, cache_t,
                                           torch.as_tensor(toks[:, t:t + 1]), t)
        close(lr, lt)
        close_tree(cache_r, cache_t)
        if t >= 5:  # the last slot is written again
            assert not torch.equal(before, cache_t["k"][:, :, 5])


@pytest.mark.parametrize("name", ["llama3.2-3b", "recurrentgemma-2b",
                                  "mamba2-130m", "whisper-large-v3"])
def test_runs_on_the_card_unless_told_otherwise(monkeypatch, name):
    """``init`` and ``init_cache`` with no device and no card raise rather
    than carry on on the CPU; with ``device="cpu"`` they run there."""
    model = build(ARCHS[name].reduced())
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(B, S)
    params = model.init(gen, device="cpu")
    assert all(p.device.type == "cpu" for p in params.parameters())
    cache = model.init_cache(B, S, device="cpu")
    leaves = torch.utils._pytree.tree_leaves(cache)
    assert leaves and all(c.device.type == "cpu" for c in leaves)


def test_common_primitives_match_repro():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    close(r_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
          common.rms_norm(_t(x), _t(scale), 1e-5))
    pos = np.broadcast_to(np.arange(5) * 37, (2, 5))
    close(r_common.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0),
          common.rope(_t(x), _t(pos), 500_000.0))
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    mask = (rng.random((2, 5)) < 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        close(r_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          None if m is None else jnp.asarray(m)),
              common.cross_entropy_loss(_t(logits), _t(labels),
                                        None if m is None else _t(m)))
    close(r_common.sinusoidal_positions(40, 32), common.sinusoidal_positions(40, 32))


def test_dense_init_is_truncated_at_two_std():
    g = torch.Generator().manual_seed(3)
    w = common.dense_init(g, (64, 4096), torch.float32)
    std = 64 ** -0.5
    assert float(w.abs().max()) <= 2 * std
    # the standard normal truncated at +-2 has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    e = common.embed_init(g, (256, 64), torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) < 1e-3


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_linear_scan_is_the_recurrence(n):
    rng = np.random.default_rng(12)
    a = torch.as_tensor(rng.random((2, n, 1)), dtype=torch.float64)
    b = torch.as_tensor(rng.normal(size=(2, n, 3)))
    prod, h = common.linear_scan(a, b, dim=1)
    want_h, want_a = [], []
    hh, aa = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 1, dtype=torch.float64)
    for t in range(n):
        hh = a[:, t] * hh + b[:, t]
        aa = aa * a[:, t]
        want_h.append(hh)
        want_a.append(aa)
    assert torch.allclose(h, torch.stack(want_h, 1), rtol=1e-12, atol=1e-12)
    assert torch.allclose(prod, torch.stack(want_a, 1), rtol=1e-12, atol=1e-12)


def test_hints_are_identities_and_refuse_axes():
    """With no axes set the anchors are identities; with axes set they
    refuse a plain tensor (an unplaced batch) rather than pass it on."""
    x = torch.ones(2, 3, 4)
    for fn in (hints.constrain_acts, hints.constrain_logits,
               hints.constrain_decode_scores):
        assert fn(x) is x
    hints.clear()
    assert hints.mesh_info() is None and r_hints.mesh_info() is None
    hints.set_axes(("data",))
    try:
        for fn in (hints.constrain_acts, hints.constrain_logits):
            with pytest.raises(RuntimeError, match="make_batch_specs"):
                fn(x)
    finally:
        hints.clear()
    assert hints.constrain_acts(x) is x


def test_configs_match_repros():
    from repro.configs import SHAPES as R_SHAPES
    from repro_torch.configs import SEARCH_CONFIG, SHAPES

    assert sorted(ARCHS) == sorted(R_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(R_ARCHS[name])
        assert (dataclasses.asdict(ARCHS[name].reduced())
                == dataclasses.asdict(R_ARCHS[name].reduced()))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    assert SEARCH_CONFIG.ref_len == 1_000_000
