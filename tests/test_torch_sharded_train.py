"""The port's sharded LM training on spawned gloo worlds on the CPU.

``tests/sharded_train_cases.py`` runs each case on every rank of a world
of 2 (a ``(1, 2)`` ``("data", "model")`` mesh) and one of 4 (``(2, 2)``),
both started at once:

* the train step on placed state (mistral-nemo-12b ``reduced()``, 3 steps
  of 8 x 32 tokens from ``repro``'s numpy state): losses and gradient
  norms within 1e-5 relative of the port's one-device step from the same
  state, parameters within 1e-5 of each leaf's largest under AdamW's
  sign-effect rule (``test_torch_train_parity``), and that one-device
  step's losses within 1e-5 of ``repro``'s ``make_train_step``;
* multi-pod: mamba2-130m on ``(2, 1, 2)`` ``("pod", "data", "model")``
  against ``(2, 2)``, losses within 1e-4 (``repro``'s
  ``test_multipod_training_semantics``);
* ``elastic_reshard`` 4 -> 2: bit-identical values
  (``tests/test_elastic.py::test_elastic_reshard_preserves_values``);
* the expert-parallel MoE (kimi-k2 ``reduced()``, nothing dropped) against
  the dense ``moe`` on one device, logits within 1e-5 of their largest;
* the activation anchors' placements, and ``launch.train
  --model-parallel 2`` with a supervised restart;
* the head split where the heads do not divide ``"model"`` (mistral on
  ``(1, 4)`` in the world of 4): a train step, a prefill and decode steps
  within 1e-5 of one device;
* microbatches finer than a data shard's rows (world 4): the step
  within 1e-5 of one device;
* the MoE's gradients on placed state (kimi-k2 ``reduced()`` on
  ``(2, 2)``): the dense MoE and ``moe_impl="ep"``, loss and every
  parameter's gradient within 1e-5 of one device;
* serving on placed state (world 2): prefill and decode over placed
  parameters and caches for one arch of each family, logits within 1e-5
  of their largest against one device; in the world of 4 again on
  ``(2, 2, 1)`` ``("pod", "data", "model")`` with a batch of 2, which
  ``"data"`` divides and ``pod * data`` does not.
"""
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import sharded_train_cases as cases
from repro.configs import ARCHS as R_ARCHS
from repro.models.registry import build as r_build
from repro.train.train_step import init_state as r_init_state
from repro.train.train_step import make_train_step as r_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.models.registry import build
from repro_torch.train.train_step import init_state, make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
RTOL = 1e-5
FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def r_state():
    return r_init_state(r_build(R_ARCHS[cases.MISTRAL].reduced()),
                        jax.random.PRNGKey(0))


def _spawn(world, store, state, out):
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "sharded_train_cases.py"),
         store, state, out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
             "JAX_PLATFORMS": "cpu"})
        for r in range(world)]


def _result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"worker timed out: {err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, r_state):
    """``{2: [rank results], 4: [...]}`` from both worlds."""
    d = tmp_path_factory.mktemp("sharded_train")
    state = str(d / "state.pkl")
    with open(state, "wb") as f:
        pickle.dump(cases.state_arrays(r_state), f)
    procs = {w: _spawn(w, str(d / f"store_{w}"), state, str(d / f"out_{w}"))
             for w in (2, 4)}
    try:
        return {w: [_result(p) for p in ps] for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()


def _rel(a, b) -> float:
    return abs(a - b) / abs(a)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_one_device(spawned, world):
    res = spawned[world][0]["train"]
    for k in ("loss", "grad_norm"):
        for want, got in zip(res[f"ref_{k}"], res[k]):
            assert _rel(want, got) <= RTOL, (k, want, got)
    apart = res["params"]
    assert apart["far"] <= FLIP_SHARE * apart["n"], apart
    assert apart["worst"] <= apart["bound"], apart
    assert res["step"] == cases.STEPS
    # the state really is sharded: wq (D, H*hd) is split on both axes
    assert math.prod(res["wq_local"]) * world == math.prod(res["wq_global"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_same(spawned, world):
    first = spawned[world][0]
    for rank in spawned[world][1:]:
        assert rank["train"]["loss"] == first["train"]["loss"]
        assert rank["ep"] == first["ep"]


def test_one_device_step_matches_repro(spawned, r_state):
    """The chain's first link: the port's one-device step (run in the
    worker) against ``repro``'s on the same numpy state and batches."""
    r_model = r_build(R_ARCHS[cases.MISTRAL].reduced())
    step = jax.jit(r_make_train_step(r_model, **cases.STEP_KW))
    cfg = ARCHS[cases.MISTRAL].reduced()
    state, losses, norms = r_state, [], []
    for i in range(cases.STEPS):
        batch = {k: jnp.asarray(v) for k, v in cases.data(cfg, i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mine = spawned[2][0]["train"]
    for want, got in zip(losses + norms,
                         mine["ref_loss"] + mine["ref_grad_norm"]):
        assert _rel(want, got) <= RTOL, (want, got)


def test_multipod_matches_single_mesh(spawned):
    for rank in spawned[4]:
        res = rank["multipod"]
        assert math.isfinite(res["multi"])
        assert abs(res["multi"] - res["single"]) < 1e-4, res


def test_elastic_reshard_is_bit_identical(spawned):
    """4 -> 2: ranks 0-1 hold the new ``(1, 2)`` mesh's shards, with every
    leaf (``final_norm`` and ``wq`` named) bit-identical; ranks 2-3 hold
    nothing."""
    for r, rank in enumerate(spawned[4]):
        res = rank["elastic"]
        if r < 2:
            assert res["member"] and res["equal"]
            assert res["final_norm_equal"] and res["wq_equal"]
            assert res["wq_mesh"] == [0, 1]
        else:
            assert not res["member"] and res["wq_local_numel"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_ep_moe_matches_dense(spawned, world):
    assert spawned[world][0]["ep"]["rel"] < RTOL


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_ep_moe_on_a_mesh_of_one_is_the_dense_bits(world1):
    """On a mesh of one, each expert runs on the dense dispatch's tokens in
    the same order, and the combine adds nothing: bit-equal logits."""
    from repro_torch.launch.mesh import make_local_mesh

    res = cases.ep_case(make_local_mesh(1))
    assert res["equal"] and res["rel"] == 0.0


def test_anchors_give_repros_placements(spawned):
    """On (2, 2): activations batch-sharded and replicated over "model"
    (with sequence parallelism the sequence over "model"), logits' vocab
    and decode scores' cache length over "model"; ``mesh_info`` returns
    what ``set_axes`` stored; cleared, the anchors are identities."""
    res = spawned[4][0]["anchors"]
    assert res["mesh_info"] == [["data"], "model", True]
    assert res["acts_False"] == "(Shard(dim=0), Replicate())"
    assert res["acts_True"] == "(Shard(dim=0), Shard(dim=1))"
    for seq in (False, True):
        assert res[f"logits_{seq}"] == "(Shard(dim=0), Shard(dim=2))"
        assert res[f"scores_{seq}"] == "(Shard(dim=0), Shard(dim=4))"
    assert res["cleared"]


def test_launch_train_model_parallel(spawned):
    """``launch.train --model-parallel 2`` on 2 ranks: ``repro``'s mesh
    line, losses within 1e-5 of the one-rank run's, a supervised restart
    that replays bit for bit, and ``--production-mesh`` refused with the
    world size it needs."""
    cfg = ARCHS[cases.LLAMA].reduced()
    model = build(cfg)
    state = init_state(model, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(model, base_lr=3e-4, warmup=10, total_steps=3)
    from repro_torch.data.lm import TokenStream

    stream = TokenStream(cfg.vocab, 4, 16, seed=0)
    want = []
    for i in range(3):
        state, m = step(state, stream.batch_at(i))
        want.append(float(m["loss"]))
    for rank in spawned[2]:
        res = rank["cli"]
        assert res["plain"]["mesh_line"] == \
            "arch=llama3.2-3b mesh={'data': 1, 'model': 2}"
        got = res["plain"]["losses"]
        assert all(math.isfinite(x) for x in got)
        for w, g in zip(want, got):
            assert _rel(w, g) <= RTOL, (w, g)
        assert res["restart"]["restarts"]
        assert res["restart"]["losses"][-1] == got[-1]
        assert "needs a world size of 256 ranks, got 2" in res["production"]


def test_head_split_on_an_undivided_model_axis(spawned):
    """Heads that do not divide ``"model"`` (mistral ``reduced()``'s 2 KV
    heads on ``(1, 4)``): the projection is replicated before the head
    reshape, so one train step, a prefill and the decode steps run and
    stay within 1e-5 of one device."""
    for rank in spawned[4]:
        res = rank["heads"]
        for want, got in (res["loss"], res["grad_norm"]):
            assert _rel(want, got) <= RTOL, res
        assert res["params"]["far"] <= FLIP_SHARE * res["params"]["n"], res
        assert res["params"]["worst"] <= res["params"]["bound"], res
        assert res["steps"] == 1 + cases.SERVE_STEPS
        assert res["serve_rel"] <= RTOL, res


def test_microbatches_finer_than_a_data_shard(spawned):
    """8 microbatches of an 8-row batch on ``(2, 2)``: a data shard holds 4
    rows, so each microbatch is one row of the global batch; the step is
    the one-device step's within 1e-5."""
    for rank in spawned[4]:
        res = rank["micro"]
        for want, got in (res["loss"], res["grad_norm"]):
            assert _rel(want, got) <= RTOL, res
        assert res["params"]["far"] <= FLIP_SHARE * res["params"]["n"], res
        assert res["params"]["worst"] <= res["params"]["bound"], res


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_moe_gradients_on_placed_state(spawned, impl):
    """kimi-k2 ``reduced()`` on ``(2, 2)``: the dense MoE split over the
    mesh (global routing and capacity, tokens dropped) and ``moe_ep``
    (nothing dropped; its aux loss each batch shard's, averaged): the
    loss and every parameter's gradient within 1e-5 of the largest
    against one device. The router's gradient holds the aux loss's once
    (a mean over ranks hands each rank ``1/n`` of its gradient)."""
    for rank in spawned[4]:
        res = rank["moe_grads"][impl]
        assert _rel(*res["loss"]) <= RTOL, res
        assert res["same_leaves"] and res["leaves"] > 0, res
        assert res["worst"] <= RTOL, res
        assert res["router"] <= RTOL, res


@pytest.mark.parametrize("name", cases.SERVE_ARCHS)
def test_serving_on_placed_state(spawned, name):
    """Prefill (``forward`` for recurrentgemma, the encoder for whisper)
    and decode steps over parameters and caches placed on ``(1, 2)``:
    logits within 1e-5 of their largest against one device, the cache
    written in place in its placement and equal to one device's."""
    runs = {k: v for k, v in spawned[2][0]["serve"].items()
            if k.startswith(name + "/")}
    assert runs
    for key, res in runs.items():
        assert res["rel"] <= RTOL, (key, res)
        assert res["cache_rel"] <= RTOL, (key, res)
        assert res["in_place"], key
        assert res["steps"] >= cases.SERVE_STEPS


@pytest.mark.parametrize("name", cases.SERVE_ARCHS)
def test_serving_on_a_multipod_mesh(spawned, name):
    """As ``test_serving_on_placed_state`` on ``(2, 2, 1)`` ``("pod",
    "data", "model")`` with a batch of 2: the activations' rows split over
    ``"data"`` alone, the caches (``spec_for_cache``) whole over both
    batch axes, and each cache write and decode step takes the rows of
    the cache's own layout."""
    for rank in spawned[4]:
        runs = {k: v for k, v in rank["serve_pods"].items()
                if k.startswith(name + "/")}
        assert runs
        for key, res in runs.items():
            assert res["rel"] <= RTOL, (key, res)
            assert res["cache_rel"] <= RTOL, (key, res)
            assert res["in_place"], key
            assert res["steps"] >= cases.SERVE_STEPS
