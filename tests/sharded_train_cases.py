"""The sharded-training cases of ``tests/test_torch_sharded_train.py``, run
by each rank of a spawned gloo world on the CPU.

Worker mode (the test starts these)::

    RANK=r WORLD_SIZE=n python tests/sharded_train_cases.py STORE STATE OUT

A rank joins a gloo world through the file store ``STORE``; ``STATE`` is
a pickle of ``repro``'s mistral-nemo-12b ``reduced()`` train state as
numpy (``state_arrays``); ``OUT`` a directory for the CLI's checkpoints.
World 2 runs its cases on ``(1, 2)`` ``("data", "model")``, world 4 on
``(2, 2)``, plus the multi-pod, elastic and anchor cases, the head
split on ``(1, 4)``, microbatches finer than a data shard's rows, the
MoE's gradients on placed state and serving on ``(2, 2, 1)`` with a
batch that ``pod * data`` does not divide; world 2 also serves on
placed state. Each rank
prints one ``RESULT <json>`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle
import sys

import numpy as np

MISTRAL, MAMBA, KIMI, LLAMA = ("mistral-nemo-12b", "mamba2-130m",
                               "kimi-k2-1t-a32b", "llama3.2-3b")
STEPS, BATCH, SEQ = 3, 8, 32
STEP_KW = dict(base_lr=1e-3, warmup=1, total_steps=10)
RTOL_PARAMS = 1e-5   # of each leaf's largest value
EP_TOKENS = (8, 16)
CLI = ["--arch", LLAMA, "--reduced", "--steps", "3", "--batch", "4",
       "--seq", "16", "--device", "cpu", "--ckpt-every", "1"]


def state_arrays(r_state) -> dict:
    """``repro``'s AdamW ``TrainState`` as plain numpy (picklable without
    ``repro``)."""
    import jax

    np_tree = jax.tree.map(np.asarray, r_state)
    return {"params": np_tree.params, "m": np_tree.opt.m, "v": np_tree.opt.v,
            "opt_step": np_tree.opt.step, "step": np_tree.step}


def port_state(cfg, arrays):
    """The port's one-device state from ``state_arrays`` (float32, CPU)."""
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    return train_state_from_numpy(cfg, TrainState(
        params=arrays["params"],
        opt=AdamWState(m=arrays["m"], v=arrays["v"], step=arrays["opt_step"]),
        step=arrays["step"]), "cpu")


def data(cfg, step: int) -> dict:
    from repro_torch.data.lm import TokenStream

    return TokenStream(cfg.vocab, BATCH, SEQ, seed=0).batch_at(step)


def _copy(state):
    from repro_torch.train.layout import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(
        t.requires_grad), state)


def _params_apart(ref, placed, lrs) -> dict:
    """Each placed leaf gathered against the one-device leaf: elements
    beyond ``RTOL_PARAMS`` of the leaf's largest value, their largest gap,
    and AdamW's sign-effect bound for them (``test_torch_train_parity``)."""
    from repro_torch.train.layout import full, leaves

    pairs = [(a.detach().double().numpy(), full(b).detach().double().numpy())
             for (_, a), (_, b) in zip(leaves(ref), leaves(placed))]
    pmax = max(float(np.abs(a).max()) for a, _ in pairs)
    far = n = 0
    worst = 0.0
    for a, b in pairs:
        d = np.abs(a - b)
        beyond = d > RTOL_PARAMS * np.abs(a).max()
        far += int(beyond.sum())
        n += a.size
        if beyond.any():
            worst = max(worst, float(d[beyond].max()))
    return {"far": far, "n": n, "worst": worst,
            "bound": 2 * sum(lrs) * (1.01 + 0.1 * pmax)}


def train_case(mesh, arrays) -> dict:
    """mistral ``reduced()``: the one-device step and the placed step from
    the same numpy state, ``STEPS`` steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_state_specs,
        place,
    )
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import make_train_step

    cfg = ARCHS[MISTRAL].reduced()
    model = build(cfg)
    step = make_train_step(model, **STEP_KW)
    ref = port_state(cfg, arrays)
    placed = place(_copy(ref), mesh, make_state_specs(model, mesh))
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    out = {"loss": [], "grad_norm": [], "ref_loss": [], "ref_grad_norm": []}
    lrs = []
    try:
        for i in range(STEPS):
            placed, m = step(placed, data(cfg, i))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
    finally:
        hints.clear()
    for i in range(STEPS):
        ref, m = step(ref, data(cfg, i))
        out["ref_loss"].append(float(m["loss"]))
        out["ref_grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _params_apart(ref.params, placed.params, lrs)
    wq = placed.params["layers"][0]["attn"]["wq"]
    out["wq_local"] = list(wq.to_local().shape)
    out["wq_global"] = list(wq.shape)
    out["step"] = int(placed.step.full_tensor())
    return out


def multipod_case(rank) -> dict:
    """mamba2 ``reduced()``, 2 steps on ``(2, 1, 2)`` ``("pod", "data",
    "model")`` and on ``(2, 2)``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_state_specs,
        place,
    )
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = ARCHS[MAMBA].reduced()
    model = build(cfg)
    losses = {}
    for name, shape, axes in (("multi", (2, 1, 2), ("pod", "data", "model")),
                              ("single", (2, 2), ("data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        state = place(init_state(model, torch.Generator().manual_seed(0),
                                 device="cpu"),
                      mesh, make_state_specs(model, mesh))
        step = make_train_step(model)
        hints.set_axes(batch_axes(mesh), mesh=mesh)
        try:
            for i in range(2):
                state, m = step(state, data(cfg, i))
        finally:
            hints.clear()
        losses[name] = float(m["loss"])
    return losses


def elastic_case(mesh, arrays) -> dict:
    """mistral's state placed on ``(2, 2)``, moved to ``(1, 2)`` over ranks
    0-1: every leaf's values bit-identical."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import ARCHS
    from repro_torch.distributed.fault_tolerance import elastic_reshard
    from repro_torch.distributed.sharding import make_state_specs, place
    from repro_torch.models.registry import build
    from repro_torch.train.layout import full, leaves

    cfg = ARCHS[MISTRAL].reduced()
    model = build(cfg)
    state = place(port_state(cfg, arrays), mesh, make_state_specs(model, mesh))
    before = [full(t).clone() for _, t in leaves(state)]
    named = lambda st: (st.params["final_norm"],
                        st.params["layers"][0]["attn"]["wq"])
    fn_before, wq_before = (full(t).clone() for t in named(state))
    new_mesh = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                          mesh_dim_names=("data", "model"))
    moved = elastic_reshard(state, mesh, new_mesh,
                            lambda m: make_state_specs(model, m))
    mine = dist.get_rank() in (0, 1)
    out = {"member": mine}
    if mine:
        after = [full(t) for _, t in leaves(moved)]
        out["equal"] = all(torch.equal(a, b) for a, b in zip(before, after))
        fn_after, wq_after = (full(t) for t in named(moved))
        out["final_norm_equal"] = torch.equal(fn_before, fn_after)
        out["wq_equal"] = torch.equal(wq_before, wq_after)
        w = moved.params["layers"][0]["attn"]["wq"]
        out["wq_mesh"] = list(w.device_mesh.mesh.flatten().tolist())
        out["wq_local"] = list(w.to_local().shape)
    else:
        w = moved.params["layers"][0]["attn"]["wq"]
        out["wq_local_numel"] = int(w.to_local().numel())
    dist.barrier()
    return out


def ep_case(mesh) -> dict:
    """kimi-k2 ``reduced()`` with nothing dropped: ``moe_impl="ep"`` logits
    on the mesh against the dense ``moe`` on one device."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_param_specs,
        place,
        place_batch,
    )
    from repro_torch.models.common import plain
    from repro_torch.models.registry import build

    base = dataclasses.replace(ARCHS[KIMI].reduced(), capacity_factor=100.0)
    toks = np.random.default_rng(0).integers(0, base.vocab, EP_TOKENS)
    dense = build(base)
    params = dense.init(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        want = dense.forward(params, tokens=torch.as_tensor(toks))[0]
    ep = build(dataclasses.replace(base, moe_impl="ep"))
    placed = place(plain(params), mesh, make_param_specs(ep, mesh))
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        with torch.no_grad():
            got = ep.forward(placed, tokens=place_batch({"t": toks}, mesh)["t"])[0]
        got = got.full_tensor()
    finally:
        hints.clear()
    return {"rel": float((got - want).abs().max() / want.abs().max()),
            "equal": bool(torch.equal(got, want))}


def anchors_case(mesh) -> dict:
    """Each anchor's placement with the axes set, as strings."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import batch_axes

    x = distribute_tensor(torch.ones(4, 6, 8), mesh,
                          (Replicate(),) * mesh.ndim)
    scores = distribute_tensor(torch.ones(4, 2, 2, 1, 8), mesh,
                               (Replicate(),) * mesh.ndim)
    out = {}
    for seq in (False, True):
        hints.set_axes(batch_axes(mesh), seq_parallel=seq, mesh=mesh)
        try:
            out["mesh_info"] = [list(hints.mesh_info()[1]),
                                hints.mesh_info()[2],
                                hints.mesh_info()[0] is mesh]
            out[f"acts_{seq}"] = str(hints.constrain_acts(x).placements)
            out[f"logits_{seq}"] = str(hints.constrain_logits(x).placements)
            out[f"scores_{seq}"] = str(
                hints.constrain_decode_scores(scores).placements)
        finally:
            hints.clear()
    out["cleared"] = hints.mesh_info() is None and hints.constrain_acts(x) is x
    return out


def cli_case(out_dir, rank) -> dict:
    """``launch.train --model-parallel 2`` on this world, then the
    launcher's loop on the same mesh with a failure injected before step
    2 through the supervisor's ``fail_injector``."""
    import torch

    from repro_torch.launch import train
    from repro_torch.models.registry import build

    res = {}
    argv = CLI + ["--model-parallel", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = train.main(argv + ["--ckpt", os.path.join(out_dir, "ck_plain")])
    text = buf.getvalue()
    res["plain"] = {"losses": [m["loss"] for m in log],
                    "mesh_line": [ln for ln in text.splitlines()
                                  if ln.startswith("arch=")][0]}

    failed = []

    def fail_once(step: int) -> None:
        if step == 2 and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure before step {step}")

    args = train.parse_args(argv + ["--ckpt",
                                    os.path.join(out_dir, "ck_restart")])
    cfg = train.train_config(args)
    dev = torch.device("cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = train.run(args, cfg, build(cfg), train.launch_mesh(args, dev),
                        dev, fail_once)
    res["restart"] = {"losses": [m["loss"] for m in log],
                      "restarts": "restarts=1" in buf.getvalue()}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(CLI + ["--production-mesh", "--ckpt",
                              os.path.join(out_dir, "ck_prod")])
        res["production"] = None
    except SystemExit as e:
        res["production"] = str(e)
    return res


SERVE_ARCHS = (MISTRAL, KIMI, MAMBA, "recurrentgemma-2b", "whisper-large-v3")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 2, 8, 4


def _serve_configs(name) -> dict:
    """``{label: reduced config}``: a MoE both expert-parallel and dense,
    with nothing dropped, so the experts' split changes no token."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[name].reduced()
    if not cfg.is_moe:
        return {name: cfg}
    return {f"{name}/{impl}": dataclasses.replace(
        cfg, capacity_factor=100.0, moe_impl=impl) for impl in ("ep", "dense")}


def _serve(model, params, cache, inputs, mesh=None) -> list:
    """Prefill (``forward`` for an arch without one) and ``SERVE_STEPS``
    decode steps: the logits of each, as numpy. With ``mesh``, the
    inputs are placed and each logits tensor gathered."""
    import torch

    from repro_torch.distributed.sharding import place_batch
    from repro_torch.train.layout import full

    put = (lambda t: place_batch({"x": t}, mesh)["x"]) if mesh else (
        lambda t: torch.as_tensor(t))
    out = []
    with torch.no_grad():
        if model.prefill is None:
            logits = model.forward(params, tokens=put(inputs["tokens"]))[0]
        elif "embeds" in inputs:
            cache = model.prefill(params, cache, embeds=put(inputs["embeds"]))
            logits = None
        else:
            logits, cache = model.prefill(params, cache,
                                          tokens=put(inputs["tokens"]))
        if logits is not None:
            out.append(full(logits).numpy())
        for i, tok in enumerate(inputs["decode"]):
            logits, cache = model.decode_step(params, cache, put(tok),
                                              inputs["pos0"] + i)
            out.append(full(logits).numpy())
    return out, cache


def serve_case(mesh, fsdp_names=(MISTRAL,)) -> dict:
    """Prefill and decode over placed parameters and caches, for one arch
    of each family, against the one-device run from the same weights:
    each step's logits, the largest gap over the largest logit; and
    whether the placed cache kept its tensors and placements. Archs in
    ``fsdp_names`` also run with ``fsdp_shard=False``. On ``(2, 2, 1)``
    ``("pod", "data", "model")`` the batch of 2 divides ``"data"`` but
    not ``pod * data``: the activations' rows split over ``"data"``
    while the caches hold every row on each rank."""
    import torch

    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_cache_specs,
        make_param_specs,
        place,
    )
    from repro_torch.models.common import plain
    from repro_torch.models.registry import build
    from repro_torch.train.layout import full, leaves

    out = {}
    runs = [(label, cfg, name) for name in SERVE_ARCHS
            for label, cfg in _serve_configs(name).items()]
    for label, cfg, name in runs:
        model = build(cfg)
        rng = np.random.default_rng(1)
        b, s = SERVE_BATCH, SERVE_PROMPT
        inputs = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
                  "decode": [rng.integers(0, cfg.vocab, (b, 1))
                             for _ in range(SERVE_STEPS)],
                  "pos0": s}
        length = s + SERVE_STEPS
        if cfg.family == "audio":  # the encoder's frames fill the cache
            inputs = {"embeds": rng.standard_normal(
                (b, length, cfg.d_model)).astype(np.float32),
                "decode": inputs["decode"], "pos0": 0}
        elif model.prefill is None:  # decode from the empty cache
            inputs["pos0"] = 0
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        want, ref_cache = _serve(model, params,
                                 model.init_cache(b, length, "cpu"), inputs)
        for fsdp in (True, False) if name in fsdp_names else (True,):
            placed = place(plain(params), mesh,
                           make_param_specs(model, mesh, fsdp_shard=fsdp))
            cspecs = make_cache_specs(model, mesh, b, length)
            cache = place(model.init_cache(b, length, "cpu"), mesh, cspecs)
            before = [(id(t), tuple(t.placements)) for _, t in leaves(cache)]
            hints.set_axes(batch_axes(mesh), mesh=mesh)
            try:
                got, cache = _serve(model, placed, cache, inputs, mesh)
            finally:
                hints.clear()
            after = [(id(t), tuple(t.placements)) for _, t in leaves(cache)]
            top = max(float(np.abs(w).max()) for w in want)
            caches = [(full(a).double(), c.double())
                      for (_, a), (_, c) in zip(leaves(cache),
                                                leaves(ref_cache))]
            out[f"{label}/fsdp={fsdp}"] = {
                "rel": max(float(np.abs(g - w).max()) for g, w in
                           zip(got, want)) / top,
                "steps": len(got),
                "in_place": before == after,
                "cache_rel": max(float((a - c).abs().max()) /
                                 max(float(c.abs().max()), 1e-30)
                                 for a, c in caches if c.numel()),
            }
    return out


def heads_case(arrays) -> dict:
    """The head split on ``(1, 4)`` ``("data", "model")``: mistral
    ``reduced()`` has 4 heads and 2 KV heads, and 2 does not divide 4.
    One train step from ``repro``'s numpy state, then a prefill and
    ``SERVE_STEPS`` decode steps from the stepped weights, each against
    the one-device run."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_cache_specs,
        make_param_specs,
        make_state_specs,
        place,
    )
    from repro_torch.models.registry import build
    from repro_torch.train.layout import full, tree_map
    from repro_torch.train.train_step import make_train_step

    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    cfg = ARCHS[MISTRAL].reduced()
    model = build(cfg)
    step = make_train_step(model, **STEP_KW)
    ref = port_state(cfg, arrays)
    placed = place(_copy(ref), mesh, make_state_specs(model, mesh))
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        placed, m = step(placed, data(cfg, 0))
    finally:
        hints.clear()
    ref, m_ref = step(ref, data(cfg, 0))
    out = {"loss": [float(m_ref["loss"]), float(m["loss"])],
           "grad_norm": [float(m_ref["grad_norm"]), float(m["grad_norm"])],
           "params": _params_apart(ref.params, placed.params,
                                   [float(m["lr"])])}
    rng = np.random.default_rng(2)
    b, s = SERVE_BATCH, SERVE_PROMPT
    inputs = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
              "decode": [rng.integers(0, cfg.vocab, (b, 1))
                         for _ in range(SERVE_STEPS)], "pos0": s}
    frozen = lambda st: tree_map(lambda t: t.detach(), st.params)
    want, _ = _serve(model, frozen(ref), model.init_cache(b, s + SERVE_STEPS,
                                                          "cpu"), inputs)
    params = place(tree_map(lambda t: full(t).detach(), placed.params), mesh,
                   make_param_specs(model, mesh))
    cache = place(model.init_cache(b, s + SERVE_STEPS, "cpu"), mesh,
                  make_cache_specs(model, mesh, b, s + SERVE_STEPS))
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        got, _ = _serve(model, params, cache, inputs, mesh)
    finally:
        hints.clear()
    top = max(float(np.abs(w).max()) for w in want)
    out["serve_rel"] = max(float(np.abs(g - w).max())
                           for g, w in zip(got, want)) / top
    out["steps"] = len(got)
    return out


def micro_case(mesh, arrays) -> dict:
    """mistral ``reduced()`` with as many microbatches as the batch has
    rows (8): a data shard holds fewer rows than there are microbatches,
    so each microbatch is a run of the global batch's rows. One step
    against the one-device step from the same numpy state."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_state_specs,
        place,
    )
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(ARCHS[MISTRAL].reduced(), num_microbatches=BATCH)
    model = build(cfg)
    step = make_train_step(model, **STEP_KW)
    ref = port_state(cfg, arrays)
    placed = place(_copy(ref), mesh, make_state_specs(model, mesh))
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        placed, m = step(placed, data(cfg, 0))
    finally:
        hints.clear()
    ref, m_ref = step(ref, data(cfg, 0))
    return {"loss": [float(m_ref["loss"]), float(m["loss"])],
            "grad_norm": [float(m_ref["grad_norm"]), float(m["grad_norm"])],
            "params": _params_apart(ref.params, placed.params,
                                    [float(m["lr"])])}


def moe_grads_case(mesh) -> dict:
    """kimi-k2 ``reduced()`` (one microbatch) on ``(2, 2)``: the loss and
    each parameter's gradient of the dense MoE placed (its routing and
    capacity global, tokens dropped) and of ``moe_impl="ep"`` (nothing
    dropped), each against one device from the same state: the dense
    model's loss on the whole batch, and for ``ep`` the mean of its loss
    on each data shard's rows (``ep``'s aux loss is each batch shard's,
    averaged). Per leaf, the largest gap over the largest value."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_state_specs,
        place,
        place_batch,
    )
    from repro_torch.models.registry import build
    from repro_torch.train.layout import full, leaves
    from repro_torch.train.train_step import init_state

    def grads(model, params, batches, placed):
        flat = [t for _, t in leaves(params)]
        with hints.replicated_plain(on=placed), torch.enable_grad():
            loss = sum(model.loss_fn(params, b) for b in batches) / len(batches)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        names = [str(k) for k, _ in leaves(params)]
        return float(full(loss)), {n: full(g).double() for n, g in
                                   zip(names, gs) if g is not None}

    base = dataclasses.replace(ARCHS[KIMI].reduced(), num_microbatches=1)
    out = {}
    for impl, cf in (("dense", base.capacity_factor), ("ep", 100.0)):
        cfg = dataclasses.replace(base, moe_impl=impl, capacity_factor=cf)
        model = build(cfg)
        state = init_state(model, torch.Generator().manual_seed(3), device="cpu")
        batch = {k: torch.as_tensor(v).long() for k, v in
                 data(cfg, 0).items()}
        halves = ([batch] if impl == "dense" else
                  [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2]
                    for k, v in batch.items()} for i in range(2)])
        want_loss, want = grads(model, state.params, halves, False)
        placed = place(_copy(state), mesh, make_state_specs(model, mesh))
        hints.set_axes(batch_axes(mesh), mesh=mesh)
        try:
            got_loss, got = grads(model, placed.params,
                                  [place_batch(batch, mesh)], True)
        finally:
            hints.clear()
        rel = {n: float((got[n] - w).abs().max() / w.abs().max())
               for n, w in want.items() if float(w.abs().max()) > 0}
        out[impl] = {"loss": [want_loss, got_loss], "leaves": len(want),
                     "same_leaves": sorted(got) == sorted(want),
                     "worst": max(rel.values()),
                     "router": max(v for n, v in rel.items() if "router" in n)}
    return out


def main() -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    store, state_path, out_dir = sys.argv[1:4]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    with open(state_path, "rb") as f:
        arrays = pickle.load(f)
    mesh = make_local_mesh(2)
    out = {"train": train_case(mesh, arrays), "ep": ep_case(mesh)}
    if world == 4:
        out["heads"] = heads_case(arrays)
        out["micro"] = micro_case(mesh, arrays)
        out["moe_grads"] = moe_grads_case(mesh)
        out["anchors"] = anchors_case(mesh)
        out["multipod"] = multipod_case(rank)
        out["elastic"] = elastic_case(mesh, arrays)
        out["serve_pods"] = serve_case(init_device_mesh(
            "cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model")), ())
    else:
        out["serve"] = serve_case(mesh)
        out["cli"] = cli_case(out_dir, rank)
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "..", "src"))
    main()
