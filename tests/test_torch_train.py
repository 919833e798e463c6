"""The port's training substrate, test for test with ``tests/test_train.py``:
optimizers, schedules, loss going down, microbatching, checkpoints, the
supervisor's restart, int8 error feedback, and ``launch.train`` as a
process. All on the CPU (``device="cpu"``); the entry points default to
the card and raise without one.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.lm import TokenStream
from repro_torch.distributed.fault_tolerance import (
    StragglerMonitor,
    TrainingSupervisor,
)
from repro_torch.models.registry import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.layout import leaves
from repro_torch.train.optimizer import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.train.train_step import init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _state(model, grad_compression=None):
    return init_state(model, torch.Generator().manual_seed(0),
                      grad_compression=grad_compression, device="cpu")


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(params, grads, state, lr=0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_adafactor_minimizes_quadratic():
    params = {"w": torch.ones((4, 6)) * 3.0}
    state = adafactor_init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = adafactor_update(params, grads, state, lr=0.05)
    assert float(params["w"].abs().max()) < 0.1


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((128, 256)), "b": torch.zeros((7,))}
    st = adafactor_init(params)
    assert st.vr["w"].shape == (128,)
    assert st.vc["w"].shape == (256,)
    assert st.vr["b"].shape == (7,)
    # factored state is ~O(r+c), not O(r*c)
    n_state = sum(x.numel() for _, x in leaves((st.vr, st.vc)))
    assert n_state < params["w"].numel() // 50


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-6


def test_cosine_schedule_shape():
    warm = float(cosine_schedule(torch.tensor(5), 1e-3, 10, 100))
    peak = float(cosine_schedule(torch.tensor(10), 1e-3, 10, 100))
    end = float(cosine_schedule(torch.tensor(100), 1e-3, 10, 100))
    assert warm < peak
    assert abs(peak - 1e-3) < 1e-9
    assert end < 1e-5


def _losses(model, steps, state, **kw):
    stream = TokenStream(model.cfg.vocab, 8, 32, seed=0)
    step = make_train_step(model, base_lr=3e-3, warmup=5, total_steps=steps, **kw)
    losses = []
    for i in range(steps):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return losses


def test_loss_decreases_end_to_end():
    model = build(ARCHS["llama3.2-3b"].reduced())
    losses = _losses(model, 40, _state(model))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


def test_microbatching_matches_full_batch():
    cfg = ARCHS["mistral-nemo-12b"].reduced()
    model1 = build(dataclasses.replace(cfg, num_microbatches=1))
    model4 = build(dataclasses.replace(cfg, num_microbatches=4))
    stream = TokenStream(cfg.vocab, 8, 16, seed=0)
    batch = stream.batch_at(0)
    s1, s4 = _state(model1), _state(model4)
    _, m1 = make_train_step(model1)(s1, batch)
    _, m4 = make_train_step(model4)(s4, batch)
    # same params, same data: microbatched grads average to the same values
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    assert abs(float(m1["grad_norm"]) - float(m4["grad_norm"])) < 1e-4
    # the step is in place: both states moved, to the same parameters
    for (_, a), (_, b) in zip(leaves(s1.params), leaves(s4.params)):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)


def test_bf16_microbatches_accumulate_in_float32():
    """bfloat16 parameters: each microbatch's gradients come in bfloat16
    and are summed in float32, so two microbatches give the mean of the
    two halves' bfloat16 gradients without a bfloat16 rounding of the
    sum."""
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(), dtype="bfloat16")
    model2 = build(dataclasses.replace(cfg, num_microbatches=2))
    batch = TokenStream(cfg.vocab, 4, 16, seed=0).batch_at(0)
    state = _state(model2)
    flat = [p for _, p in leaves(state.params)]
    halves = []
    for i in range(2):
        mb = {k: torch.as_tensor(v[2 * i:2 * i + 2]).long() for k, v in batch.items()}
        loss = model2.loss_fn(state.params, mb)
        halves.append(torch.autograd.grad(loss, flat))
    want = [(a.float() + b.float()) / 2 for a, b in zip(*halves)]
    norm = torch.sqrt(sum(torch.sum(w * w) for w in want))
    _, m = make_train_step(model2, max_grad_norm=1e9)(state, batch)
    assert all(p.dtype == torch.bfloat16 for p in flat)
    assert float(m["grad_norm"]) == pytest.approx(float(norm), rel=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.tensor([1, 2], dtype=torch.int32)},
    }
    ckpt.save(str(tmp_path), tree, 7)
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7
    assert np.array_equal(restored["a"], tree["a"].numpy())
    assert np.array_equal(restored["nested"]["b"], tree["nested"]["b"].numpy())


def test_checkpoint_prune_and_latest(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), tree, s)
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_async_checkpointer(tmp_path):
    acp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"x": torch.arange(4.0)}
    acp.submit(tree, 5)
    acp.submit(tree, 10)
    acp.close()
    assert ckpt.latest_step(str(tmp_path)) == 10


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_supervisor_restart_determinism(tmp_path, async_ckpt):
    cfg = ARCHS["mistral-nemo-12b"].reduced()
    model = build(cfg)
    stream = TokenStream(cfg.vocab, 4, 16, seed=0)
    step_fn = make_train_step(model, warmup=2, total_steps=30)

    boom = {"armed": True}

    def injector(step):
        if step == 13 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected failure")

    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    sup = TrainingSupervisor(step_fn, stream.batch_at, d1, ckpt_every=5,
                             async_ckpt=async_ckpt)
    state, log = sup.run(_state(model), 18, fail_injector=injector)
    assert sup.restarts == 1
    assert len(log) == 18 + 3  # steps 10-12 replayed from the step-10 checkpoint

    sup2 = TrainingSupervisor(step_fn, stream.batch_at, d2, ckpt_every=5,
                              async_ckpt=async_ckpt)
    state2, log2 = sup2.run(_state(model), 18)
    assert abs(log[-1]["loss"] - log2[-1]["loss"]) < 1e-6
    # on the CPU the replay gives the same bits
    assert log[-1]["loss"] == log2[-1]["loss"]
    for (_, a), (_, b) in zip(leaves(state), leaves(state2)):
        assert torch.equal(a, b)


def test_supervisor_restores_into_the_state(tmp_path):
    """A restore copies the checkpoint into the state's own tensors: the
    same objects, dtypes (bfloat16 bits included) and ``requires_grad``."""
    cfg = dataclasses.replace(ARCHS["mamba2-130m"].reduced(), dtype="bfloat16")
    model = build(cfg)
    stream = TokenStream(cfg.vocab, 2, 16, seed=0)
    sup = TrainingSupervisor(make_train_step(model, warmup=1), stream.batch_at,
                             str(tmp_path), ckpt_every=2)
    state, _ = sup.run(_state(model), 2)
    saved = [t.clone() for _, t in leaves(state)]
    state, _ = make_train_step(model, warmup=1)(state, stream.batch_at(2))
    tensors = [t for _, t in leaves(state)]
    back, step = sup.resume_or(state)
    assert step == 2
    for t, b, s in zip(tensors, [t for _, t in leaves(back)], saved):
        assert b is t or b.data_ptr() == t.data_ptr()
        assert b.dtype == s.dtype and torch.equal(b, s)
    assert all(p.requires_grad for _, p in leaves(back.params))
    assert any(p.dtype == torch.bfloat16 for _, p in leaves(back.params))


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=3.0)
    for _ in range(10):
        mon.observe(0, 1.0)
    assert mon.observe(10, 10.0) is True
    assert not mon.observe(11, 1.1)
    assert len(mon.flagged) == 1


def test_token_stream_deterministic_and_sharded():
    s1 = TokenStream(1000, 4, 16, seed=0)
    s2 = TokenStream(1000, 4, 16, seed=0)
    b1, b2 = s1.batch_at(7), s2.batch_at(7)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    sh0 = TokenStream(1000, 4, 16, seed=0, n_shards=2, shard=0).batch_at(3)
    sh1 = TokenStream(1000, 4, 16, seed=0, n_shards=2, shard=1).batch_at(3)
    assert not np.array_equal(sh0["tokens"], sh1["tokens"])


def test_int8_grad_compression_error_feedback():
    """Compressed training still converges; error feedback recycles noise."""
    from repro_torch.train.compression import compress_grads, init_error_feedback

    # unit: quantize-dequantize + residual identity g = deq + res
    w = torch.tensor([[0.1, -2.3], [5.0, 0.003]])
    ef = init_error_feedback({"w": w})
    deq, ef2 = compress_grads({"w": w.clone()}, ef)
    assert float((deq["w"] + ef2.residual["w"] - w).abs().max()) < 1e-6
    # residual feeds back: compressing zero grads flushes the residual
    res = ef2.residual["w"].clone()
    deq2, ef3 = compress_grads({"w": torch.zeros((2, 2))}, ef2)
    assert float((deq2["w"] - res).abs().max()) < 1e-2

    # end-to-end: loss decreases with compression on
    model = build(ARCHS["llama3.2-3b"].reduced())
    losses = _losses(model, 40, _state(model, "int8"), grad_compression="int8")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(ARCHS["llama3.2-3b"].reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(model, torch.Generator().manual_seed(0))
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_frees_its_gradients(remat):
    """No float32 gradient accumulator outlives its step, even with the
    garbage collector off: remat's recomputation keeps the step's frame in
    a reference cycle, so the step drops them itself (else the next step
    allocated its own beside them: 12.85 GB more at Llama-3.2-3B's width)."""
    import gc
    import weakref

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(), remat=remat,
                              num_microbatches=2)
    model = build(cfg)
    state = _state(model)
    step = make_train_step(model)
    made = []
    zeros_like = torch.zeros_like

    def recording(t, **kw):
        out = zeros_like(t, **kw)
        if kw.get("dtype") == torch.float32:
            made.append(weakref.ref(out))
        return out

    gc.disable()
    try:
        torch.zeros_like = recording
        state, _ = step(state, TokenStream(cfg.vocab, 4, 16, seed=0).batch_at(0))
        torch.zeros_like = zeros_like
        assert len(made) == len(leaves(state.params))
        assert not any(r() is not None for r in made)
    finally:
        torch.zeros_like = zeros_like
        gc.enable()


def test_serving_parameters_stay_frozen():
    """``model.init`` still gives frozen parameters; ``init_state`` marks
    its own tensors trainable and leaves a serving tree untouched."""
    model = build(ARCHS["llama3.2-3b"].reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    state = _state(model)
    assert all(p.requires_grad for _, p in leaves(state.params))
    assert not any(p.requires_grad for p in params.parameters())


def test_launch_train_refuses_a_mesh():
    """On a group of one, the production mesh and a model axis of 2 name
    the world size they need."""
    from repro_torch.launch import train

    for flags in (["--production-mesh"], ["--model-parallel", "2"]):
        with pytest.raises(SystemExit, match="world size"):
            train.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                        *flags])


def test_launch_train_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--reduced", "--steps", "12", "--batch", "4", "--seq",
         "16", "--ckpt-every", "5", "--ckpt", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "arch=llama3.2-3b mesh={'data': 1, 'model': 1}"
    assert lines[1].startswith("steps=12 loss ") and "restarts=0" in lines[1]
    assert ckpt.latest_step(str(tmp_path)) == 12


def test_launch_train_one_rank_trains_unplaced(tmp_path):
    """On a group of one, ``launch.train`` trains the unplaced state (a
    mesh of one shards nothing): its losses are the unplaced step's bits."""
    from repro_torch.launch import train

    model = build(ARCHS["llama3.2-3b"].reduced())
    state = _state(model)
    step = make_train_step(model, base_lr=3e-4, warmup=10, total_steps=3)
    stream = TokenStream(model.cfg.vocab, 4, 16, seed=0)
    want = []
    for i in range(3):
        state, m = step(state, stream.batch_at(i))
        want.append(float(m["loss"]))
    log = train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "3",
                      "--batch", "4", "--seq", "16", "--device", "cpu",
                      "--ckpt", str(tmp_path)])
    assert [m["loss"] for m in log] == want


def test_mesh_takes_the_callers_device(monkeypatch):
    """A mesh's tensors live on the device its caller names; an NCCL group
    refuses a CPU mesh rather than moving the state off the card."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshes

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert meshes.make_local_mesh(1).device_type == "cpu"
        assert meshes.make_local_mesh(1, device_type="cpu").device_type == "cpu"
        monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "nccl")
        with pytest.raises(ValueError, match="NCCL"):
            meshes.make_local_mesh(1, device_type="cpu")
        with pytest.raises(ValueError, match="NCCL"):
            meshes.make_production_mesh(device_type="cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
