"""The port's LM training held against ``repro`` on the same inputs.

* ``TokenStream`` gives ``repro``'s batches bit for bit;
* AdamW and Adafactor: one and three updates on carried parameters,
  gradients and state, for every family's reduced tree in ``repro``'s
  layout, within 1e-6 of each leaf's largest value. ``repro`` stacks each
  layer's parameters on a leading axis and decides per stacked leaf, so
  the ``(L, D)`` norm scales are decayed and factored: the trees carry
  non-zero norm scales so that the decay shows;
* ``compress_grads`` (one int8 scale per stacked leaf) and its residual;
* ``clip_by_global_norm`` and ``cosine_schedule``;
* the gradients of ``loss_fn`` on carried float32 weights against
  ``jax.grad``, one arch of each family, and the gradients bit for bit
  with remat off, ``"full"`` and ``"dots"``;
* three ``make_train_step`` steps from the same ``TrainState``;
* ``train_state_from_numpy`` / ``train_state_to_numpy`` round trip;
* the checkpoint store: bfloat16 leaves as ``repro``'s ``|V2`` records,
  and NamedTuple fields named ``.<field>`` as ``repro`` names them.

``tests/conftest.py`` turns on x64, so ``repro`` is fed float32 explicitly.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as R_ARCHS
from repro.data.lm import TokenStream as RTokenStream
from repro.models.registry import build as r_build
from repro.train import checkpoint as rckpt
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro.train.train_step import init_state as r_init_state
from repro.train.train_step import make_train_step as r_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.data.lm import TokenStream
from repro_torch.interop import (
    lm_params_from_numpy,
    lm_tree_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.models.common import plain
from repro_torch.models.registry import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.layout import leaves, unflatten
from repro_torch.train.train_step import TrainState, make_train_step, trainable

from lm_pairs import pair

# One arch of each family: dense, moe, vlm, hybrid, ssm, audio.
FAMILIES = ["llama3.2-3b", "kimi-k2-1t-a32b", "pixtral-12b",
            "recurrentgemma-2b", "mamba2-130m", "whisper-large-v3"]
# Optimizer updates on the same float32 inputs: the same float32 ops in
# the same order per element; reductions (Adafactor's means, the RMS
# clip, the int8 scale) add in another order. Measured under 2e-7.
RTOL_UPDATE = 1e-6
# Gradients of the same loss on the same weights: XLA's and PyTorch's
# float32 sums in other orders through every layer. Measured under 1.6e-6
# of each leaf's largest |gradient|.
RTOL_GRAD = 1e-5
# Losses over three train steps from the same state (measured under 2e-7).
RTOL_LOSS = 1e-5
# Parameters after three train steps: the gradients' float32 differences
# go through AdamW, measured under 9e-6 of each leaf's largest value. But
# AdamW's first steps are near a sign, g / |g|: an element whose gradient
# is float noise (qwen2's key bias: softmax ignores a shift of a row's
# scores, so its exact gradient is 0) moves by about lr a step whatever
# the noise's size, in a direction each framework's rounding draws. Such
# elements may be at most FLIP_SHARE of the parameters, each within the
# most two AdamW runs can part: 2 sum(lr) (1.01 + wd max|p|), since
# |m_hat / sqrt(v_hat)| <= 1.002 within 3 steps (Cauchy-Schwarz over the
# moments' weights). Measured: qwen2 26 such elements of 107,072, at most
# 1.9e-5 apart; int8 (a quantum flipped on a near-half) 10 of 90,432, 1.3e-4.
RTOL_PARAMS = 5e-5
FLIP_SHARE = 1e-3
LR = 1e-3


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a: repro's, b: the port's, as numpy)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(a))), 1e-30)


def _close_trees(a, b, rtol: float, what: str = "") -> float:
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb), (what, len(la), len(lb))
    worst = 0.0
    for (path, x), y in zip(la, lb):
        err = _rel(x, y)
        assert err <= rtol, (what, jax.tree_util.keystr(path), err)
        worst = max(worst, err)
    return worst


# reduced() gives recurrentgemma 2 layers, no whole pattern group: 4 layers
# are one stacked group of 3 and a remainder block.
DEPTH = {"recurrentgemma-2b": {"n_layers": 4}}


def _cfgs(name, **changes):
    changes = {**DEPTH.get(name, {}), **changes}
    return (dataclasses.replace(R_ARCHS[name].reduced(), **changes),
            dataclasses.replace(ARCHS[name].reduced(), **changes))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _tree(name, seed: int = 1):
    """``repro``'s reduced parameters for ``name``, each leaf moved by
    seeded noise (the norm scales start at 0, which no decay can move)."""
    r_cfg, _ = _cfgs(name)
    params = _np(r_build(r_cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        params)


def _like(tree, rng, fn):
    return jax.tree.map(lambda a: fn(rng, a.shape).astype(np.float32), tree)


def _normal(scale):
    return lambda rng, shape: scale * rng.normal(size=shape)


def _positive(rng, shape):
    return rng.uniform(1e-6, 1e-3, size=shape)


def _port_tree(cfg, tree):
    return plain(lm_params_from_numpy(cfg, tree, "cpu"))


# ------------------------------ TokenStream ---------------------------------


@pytest.mark.parametrize("seed,step,n_shards,shard",
                         [(0, 0, 1, 0), (3, 17, 1, 0), (1, 5, 4, 3),
                          (7, 1000, 2, 1)])
def test_token_stream_bit_equal(seed, step, n_shards, shard):
    for vocab in (256, 128_256):
        a = RTokenStream(vocab, 4, 32, seed, n_shards, shard).batch_at(step)
        b = TokenStream(vocab, 4, 32, seed, n_shards, shard).batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ------------------------------- optimizers ---------------------------------


def _carried(name, which):
    """(r_cfg, cfg, repro params, repro state) with a carried state: step
    5, random moments (AdamW) or positive row / column statistics
    (Adafactor)."""
    r_cfg, cfg = _cfgs(name, optimizer=which)
    params = _tree(name)
    rng = np.random.default_rng(2)
    step = np.asarray(5, np.int32)
    if which == "adamw":
        state = ropt.AdamWState(m=_like(params, rng, _normal(0.01)),
                                v=_like(params, rng, _positive), step=step)
    else:
        zero = ropt.adafactor_init(params)
        state = ropt.AdafactorState(vr=_like(zero.vr, rng, _positive),
                                    vc=_like(zero.vc, rng, _positive),
                                    step=step)
    return r_cfg, cfg, params, state


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", FAMILIES)
def test_optimizer_updates_match_repro(name, which, n_updates):
    r_cfg, cfg, params, state = _carried(name, which)
    port = train_state_from_numpy(
        cfg, TrainState(params, state, np.asarray(5, np.int32)), "cpu")
    p_params, p_opt = port.params, port.opt
    r_params, r_state = _jnp(params), _jnp(state)
    rng = np.random.default_rng(3)
    lr = np.float32(LR)
    for _ in range(n_updates):
        grads = _like(params, rng, _normal(0.1))
        r_params, r_state = ropt.apply_opt(r_cfg, r_params, _jnp(grads),
                                           r_state, jnp.asarray(lr))
        p_params, p_opt = opt.apply_opt(cfg, p_params, _port_tree(cfg, grads),
                                        p_opt, torch.tensor(lr))
    got = train_state_to_numpy(cfg, TrainState(p_params, p_opt, port.step))
    _close_trees(r_params, got.params, RTOL_UPDATE, "params")
    _close_trees(tuple(r_state)[:2], tuple(got.opt)[:2], RTOL_UPDATE, "state")
    assert int(got.opt.step) == int(r_state.step) == 5 + n_updates


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_stacked_norm_scales_are_decayed_and_factored(which):
    """``repro``'s ``(L, D)`` norm scales: AdamW decays them (rank 2) and
    Adafactor factors them, with one column statistic over the layers;
    the final norm, ``(D,)``, is neither. A per-layer reading would give
    other numbers, which the parity test above would see."""
    name = "llama3.2-3b"
    r_cfg, cfg, params, state = _carried(name, which)
    if which == "adamw":  # no momentum: the update is the decay alone
        state = state._replace(m=jax.tree.map(np.zeros_like, state.m))
    port = train_state_from_numpy(
        cfg, TrainState(params, state, np.asarray(5, np.int32)), "cpu")
    zero = jax.tree.map(np.zeros_like, params)
    _, p_opt = opt.apply_opt(cfg, port.params, _port_tree(cfg, zero),
                             port.opt, torch.tensor(np.float32(LR)))
    got = train_state_to_numpy(cfg, TrainState(port.params, p_opt, port.step))
    r_params, _ = ropt.apply_opt(r_cfg, _jnp(params), _jnp(zero), _jnp(state),
                                 jnp.asarray(np.float32(LR)))
    for key in ("ln1", "ln2"):
        _close_trees(r_params["layers"][key], got.params["layers"][key],
                     RTOL_UPDATE, key)
    if which == "adamw":
        moved = got.params["layers"]["ln1"] - params["layers"]["ln1"]
        assert np.all(np.sign(moved) == -np.sign(params["layers"]["ln1"]))
    else:
        d = cfg.d_model
        assert got.opt.vr["layers"]["ln1"].shape == (cfg.n_layers,)
        assert got.opt.vc["layers"]["ln1"].shape == (d,)
        assert got.opt.vc["final_norm"].shape == (1,)


@pytest.mark.parametrize("name", FAMILIES)
def test_compress_grads_matches_repro(name):
    _, cfg = _cfgs(name)
    params = _tree(name)
    rng = np.random.default_rng(4)
    grads = _like(params, rng, _normal(0.1))
    res = _like(params, rng, _normal(1e-3))
    r_deq, r_ef = rcomp.compress_grads(_jnp(grads), rcomp.ErrorFeedback(_jnp(res)))
    p_ef = comp.ErrorFeedback(_port_tree(cfg, res))
    p_deq, p_ef = comp.compress_grads(_port_tree(cfg, grads), p_ef, cfg)
    _close_trees(r_deq, lm_tree_to_numpy(cfg, p_deq), RTOL_UPDATE, "deq")
    _close_trees(r_ef.residual, lm_tree_to_numpy(cfg, p_ef.residual),
                 RTOL_UPDATE, "residual")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_repro(max_norm):
    name = "recurrentgemma-2b"
    _, cfg = _cfgs(name)
    grads = _like(_tree(name), np.random.default_rng(5), _normal(0.1))
    r_clip, r_norm = ropt.clip_by_global_norm(_jnp(grads), max_norm)
    p_clip, p_norm = opt.clip_by_global_norm(_port_tree(cfg, grads), max_norm)
    assert _rel(r_norm, p_norm.numpy()) <= RTOL_UPDATE
    _close_trees(r_clip, lm_tree_to_numpy(cfg, p_clip), RTOL_UPDATE)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 3), (0, 50)])
def test_cosine_schedule_matches_repro(warmup, total):
    for step in range(0, total + 5):
        r = ropt.cosine_schedule(jnp.asarray(step, jnp.int32), 3e-4, warmup, total)
        p = opt.cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-4,
                                warmup, total)
        assert p.dtype == torch.float32
        assert abs(float(r) - float(p)) <= RTOL_UPDATE * 3e-4, (step, r, p)


# -------------------------------- gradients ---------------------------------


def _batch(cfg, seed: int = 0, b: int = 2, s: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_embeds:
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch.pop("tokens")
    return batch


def _port_grads(model, params, batch):
    tb = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
          else torch.as_tensor(v) for k, v in batch.items()}
    flat = [t for _, t in leaves(params)]
    loss = model.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, unflatten(params, [torch.zeros_like(t) if g is None else g
                                    for t, g in zip(flat, grads)])


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax_grad(name):
    p = pair(name, **DEPTH.get(name, {}))
    batch = _batch(p.cfg)
    r_loss, r_grads = jax.jit(jax.value_and_grad(p.r_model.loss_fn))(
        p.r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(p.model, trainable(p.params), batch)
    loss = float(loss.detach())
    assert abs(float(r_loss) - loss) <= RTOL_LOSS * abs(float(r_loss))
    got = lm_tree_to_numpy(p.cfg, grads)
    _close_trees(r_grads, got, RTOL_GRAD, name)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(got))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_bit_equal(name):
    """Remat off, ``"full"`` and ``"dots"`` give the same gradient bits;
    ``"dots"`` keeps the weight products' outputs (its backward reruns no
    ``aten.mm`` that the un-rematted backward does not), ``"full"``
    recomputes them."""
    p = pair(name, **DEPTH.get(name, {}))
    batch = _batch(p.cfg)
    out, mm = {}, {}
    for policy in ("off", "full", "dots"):
        cfg = dataclasses.replace(p.cfg, remat=policy != "off",
                                  remat_policy="dots" if policy == "dots" else "full")
        params = trainable(p.params)
        tb = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
              else torch.as_tensor(v) for k, v in batch.items()}
        flat = [t for _, t in leaves(params)]
        loss = build(cfg).loss_fn(params, tb)
        with _CountOps() as count:
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        out[policy] = grads
        mm[policy] = count.ops[torch.ops.aten.mm.default]
    for policy in ("full", "dots"):
        for a, b in zip(out["off"], out[policy]):
            assert (a is None and b is None) or torch.equal(a, b), policy
    assert mm["dots"] == mm["off"] < mm["full"], mm


# ------------------------------- train steps --------------------------------


def _data(cfg, step: int, b: int = 4, s: int = 16) -> dict:
    batch = TokenStream(cfg.vocab, b, s, seed=0).batch_at(step)
    if cfg.input_embeds:
        batch["embeds"] = np.random.default_rng(step).normal(
            size=(b, s, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch.pop("tokens")
    return batch


def _params_apart(want, got, lrs) -> tuple[int, int]:
    """(elements beyond RTOL_PARAMS of their leaf's largest value, all
    elements); asserts the far ones lie within the sign effect's bound."""
    la, lb = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(la) == len(lb)
    pmax = max(float(np.max(np.abs(a))) for a in la)
    bound = 2 * sum(lrs) * (1.01 + 0.1 * pmax)
    far = n = 0
    for a, b in zip(la, lb):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.abs(a - b)
        beyond = d > RTOL_PARAMS * np.max(np.abs(a))
        far += int(beyond.sum())
        n += a.size
        assert not beyond.any() or d[beyond].max() <= bound
    return far, n


@pytest.mark.parametrize("name,compression", [(n, None) for n in FAMILIES]
                         + [("qwen2-72b", None), ("llama3.2-3b", "int8")])
def test_three_train_steps_match_repro(name, compression):
    r_cfg, cfg = _cfgs(name, num_microbatches=2)
    r_model, model = r_build(r_cfg), build(cfg)
    r_state = r_init_state(r_model, jax.random.PRNGKey(0), compression)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, r_state), "cpu")
    kw = dict(base_lr=LR, warmup=1, total_steps=10, grad_compression=compression)
    r_step = jax.jit(r_make_train_step(r_model, **kw))
    step = make_train_step(model, **kw)
    lrs = []
    for i in range(3):
        batch = _data(cfg, i)
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        lrs.append(float(m["lr"]))
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(r_m[k]) - float(m[k])) <= RTOL_LOSS * abs(float(r_m[k])), (i, k)
    assert int(state.step) == 3
    got = train_state_to_numpy(cfg, state)
    far, n = _params_apart(_np(r_state.params), got.params, lrs)
    # Adafactor's updates are no sign: none may part
    assert far <= (FLIP_SHARE * n if cfg.optimizer == "adamw" else 0), (far, n)


@pytest.mark.parametrize("name,compression", [("llama3.2-3b", "int8"),
                                              ("kimi-k2-1t-a32b", None),
                                              ("recurrentgemma-2b", None),
                                              ("whisper-large-v3", None)])
def test_train_state_round_trip(name, compression):
    r_cfg, cfg = _cfgs(name)
    r_state = jax.tree.map(np.asarray, r_init_state(
        r_build(r_cfg), jax.random.PRNGKey(0), compression))
    rng = np.random.default_rng(6)
    r_state = jax.tree.map(lambda a: (a + rng.uniform(0, 1, a.shape)).astype(a.dtype)
                           if a.dtype == np.float32 else a, r_state)
    state = train_state_from_numpy(cfg, r_state, "cpu")
    assert all(t.requires_grad for _, t in leaves(state.params))
    assert state.step.dtype == torch.int32
    back = train_state_to_numpy(cfg, state)
    ra, rb = jax.tree_util.tree_leaves(r_state), jax.tree_util.tree_leaves(back)
    assert len(ra) == len(rb)
    for a, b in zip(ra, rb):
        assert a.shape == b.shape and np.array_equal(a, b)
    # lm_tree_to_numpy inverts lm_params_from_numpy
    params = lm_params_from_numpy(cfg, r_state.params, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(r_state.params),
                    jax.tree_util.tree_leaves(lm_tree_to_numpy(cfg, params))):
        assert np.array_equal(a, b)
    assert not any(p.requires_grad for p in params.parameters())


# ------------------------------ checkpoints ---------------------------------


class TS(NamedTuple):
    params: dict
    step: object


def _bf16_values(n: int = 37) -> np.ndarray:
    return (np.random.default_rng(7).normal(size=n) * 3).astype(np.float32)


def test_port_reads_repro_bf16_leaf_bit_for_bit(tmp_path):
    vals = _bf16_values()
    rckpt.save(str(tmp_path), {"w": jnp.asarray(vals, jnp.bfloat16)}, 1)
    tmpl = {"w": torch.zeros(vals.shape, dtype=torch.bfloat16)}
    restored, step = ckpt.restore(str(tmp_path), tmpl)
    assert step == 1 and restored["w"].dtype == ckpt.BF16_BITS
    got = ckpt.load_into(tmpl, restored)["w"]
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16)).view(np.int16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want)


def test_port_bf16_leaf_is_repros_record(tmp_path):
    """The port writes a bfloat16 leaf as ``repro`` does: ``repro``'s
    loader (``np.load``, as its ``restore`` reads) gives the same ``|V2``
    records with the same bits from either file. (The headers differ by
    one byte: ``repro``'s array is ml_dtypes' bfloat16, whose descr is
    ``<V2``, the port's numpy's ``|V2``; ``np.load`` reads both as
    ``|V2``. ``repro``'s ``restore`` itself cannot cast a ``|V2`` record
    to bfloat16, for its own files and the port's alike.)"""
    vals = _bf16_values()
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "repro")
    ckpt.save(mine, {"w": torch.tensor(vals).bfloat16()}, 3)
    rckpt.save(theirs, {"w": jnp.asarray(vals, jnp.bfloat16)}, 3)
    a, b = (np.load(os.path.join(d, "step_00000003", "w.npy"))
            for d in (mine, theirs))
    assert a.dtype == b.dtype == np.dtype("V2")
    assert a.tobytes() == b.tobytes()
    assert np.array_equal(a.view(np.int16),
                          np.asarray(jnp.asarray(vals, jnp.bfloat16)).view(np.int16))


def test_async_checkpointer_keeps_bf16_bits(tmp_path):
    vals = torch.tensor(_bf16_values()).bfloat16()
    tree = TS(params={"w": vals, "f": torch.arange(3.0)},
              step=torch.tensor(4, dtype=torch.int32))
    acp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    acp.submit(tree, 4)
    acp.close()
    tmpl = TS(params={"w": torch.zeros_like(vals), "f": torch.zeros(3)},
              step=torch.tensor(0, dtype=torch.int32))
    restored, _ = ckpt.restore(str(tmp_path), tmpl)
    out = ckpt.load_into(tmpl, restored)
    assert out.params["w"] is tmpl.params["w"]
    assert torch.equal(out.params["w"].view(torch.int16), vals.view(torch.int16))
    assert torch.equal(out.params["f"], torch.arange(3.0)) and int(out.step) == 4


def _named_tree(lib):
    """A NamedTuple-of-dicts tree, nested, with a list and a None, in
    ``repro``'s (jnp) or the port's (torch) leaves."""
    to = (lambda a: jnp.asarray(a)) if lib == "repro" else torch.tensor
    inner = opt.AdamWState(m={"b": to(np.arange(3.0, dtype=np.float32))},
                           v={"b": to(np.ones(3, np.float32))},
                           step=to(np.asarray(2, np.int32)))
    return TrainState(params={"b": to(np.arange(4.0, dtype=np.float32)),
                              "layers": [{"w": to(np.full(2, 5.0, np.float32))}]},
                      opt=inner, step=to(np.asarray(7, np.int32)), ef=None)


def test_namedtuple_names_match_repro(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "repro")
    ckpt.save(mine, _named_tree("port"), 1)
    rckpt.save(theirs, _named_tree("repro"), 1)
    names = [[e["name"] for e in json.load(open(os.path.join(
        d, "step_00000001", "manifest.json")))["leaves"]] for d in (mine, theirs)]
    assert names[0] == names[1]
    assert ".params.b" in names[0] and ".step" in names[0]
    assert ".opt..m.b" in names[0] and ".params.layers.0.w" in names[0]
    # each package restores the other's directory
    got, _ = ckpt.restore(theirs, _named_tree("port"))
    assert np.array_equal(got.params["b"], np.arange(4.0)) and int(got.step) == 7
    assert np.array_equal(got.opt.m["b"], np.arange(3.0))
    r_got, _ = rckpt.restore(mine, _named_tree("repro"))
    assert np.array_equal(np.asarray(r_got.params["layers"][0]["w"]), np.full(2, 5.0))
    assert int(r_got.opt.step) == 2


def test_plain_tuples_keep_index_names(tmp_path):
    tree = {"g": (torch.zeros(1), [torch.ones(1)])}
    ckpt.save(str(tmp_path), tree, 1)
    names = [e["name"] for e in json.load(open(os.path.join(
        tmp_path, "step_00000001", "manifest.json")))["leaves"]]
    assert names == ["g.0", "g.1.0"]
