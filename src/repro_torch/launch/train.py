"""End-to-end training entry point of the port (the CLI of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 60 --batch 8 --seq 64 --ckpt /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch llama3.2-3b --reduced --steps 3 --model-parallel 2 --device cpu

``--reduced`` trains the same-family miniature; without it the full
config. The loop, microbatching, checkpointing and supervision are
those of a full run. ``--device`` defaults to the card (it raises
without one); ``--device cpu`` runs on the CPU.

On more than one rank the state is placed as ``repro`` places it: a
``DeviceMesh`` over the default process group (``launch.mesh``:
``--production-mesh`` needs 256 ranks, ``--model-parallel N`` gives
``(world // N, N)``), the state by ``sharding.make_state_specs``, each
batch by ``make_batch_specs``, and the activation anchors set
(``hints.set_axes``). A mesh of one shards nothing, so one rank trains
the unplaced state: DTensor's dispatch would only add host time (a
Llama-3.2-3B step took 1.7-2.5x as long placed on an H100). Under
``torchrun`` (or with a group already started) that group is used, each
rank on ``cuda:LOCAL_RANK`` with NCCL (gloo with ``--device cpu``);
otherwise a group of one starts from a ``HashStore``. Every rank builds
the full state from ``--seed`` and keeps its shards. Prints ``repro``'s
lines, then every step's loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.common import resolve_device
from repro_torch.data.lm import TokenStream
from repro_torch.distributed import hints
from repro_torch.distributed.fault_tolerance import TrainingSupervisor
from repro_torch.distributed.sharding import (
    batch_axes,
    make_state_specs,
    place,
    place_batch,
)
from repro_torch.launch.mesh import (
    axis_sizes,
    make_local_mesh,
    make_production_mesh,
)
from repro_torch.models.registry import build
from repro_torch.train.train_step import init_state, make_train_step


def join_group(dev: torch.device) -> bool:
    """Join the default process group: the environment's under
    ``torchrun``, else a group of one. Returns whether this call started
    it (and so destroys it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def parse_args(argv=None) -> argparse.Namespace:
    """``repro``'s options, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def rank_device(name: str | None) -> torch.device:
    """This rank's device: ``name`` (the card by default), on the card
    ``cuda:LOCAL_RANK`` under ``torchrun``."""
    dev = resolve_device(name)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def train_config(args):
    """The arch's config as ``repro``'s launcher sizes it: ``reduced()``
    with ``--reduced``, one microbatch where they do not divide the
    batch."""
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.batch % max(cfg.num_microbatches, 1):
        cfg = dataclasses.replace(cfg, num_microbatches=1)
    return cfg


def launch_mesh(args, dev: torch.device):
    """``repro``'s mesh for ``args`` over the default group, its tensors on
    ``dev``'s type; a world it does not fit exits with the size it
    needs."""
    try:
        if args.production_mesh:
            return make_production_mesh(device_type=dev.type)
        return make_local_mesh(args.model_parallel, device_type=dev.type)
    except ValueError as e:
        raise SystemExit(str(e)) from e


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = rank_device(args.device)
    cfg = train_config(args)
    model = build(cfg)
    started = join_group(dev)
    try:
        mesh = launch_mesh(args, dev)
        print(f"arch={cfg.name} mesh={axis_sizes(mesh)}")
        return run(args, cfg, model, mesh if mesh.size() > 1 else None, dev)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def placed_state(model, mesh, seed: int, dev):
    """The launcher's train state: ``init_state`` from ``seed`` on this
    rank's ``dev`` (every rank draws the same), placed on ``mesh`` by
    ``make_state_specs``."""
    state = init_state(model, torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
    return place(state, mesh, make_state_specs(model, mesh))


def run(args, cfg, model, mesh, dev, fail_injector=None) -> list:
    """The supervised loop of ``main``: the state from ``args.seed`` placed
    on ``mesh`` (with the anchors set) or, with ``mesh`` None, unplaced on
    ``dev``; ``fail_injector`` is ``TrainingSupervisor.run``'s. Prints the
    summary and every loss; returns the log."""
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)

    def data_at(step: int):
        batch = stream.batch_at(step)
        if cfg.input_embeds:
            rng = np.random.default_rng(step)
            batch["embeds"] = rng.normal(
                size=(args.batch, args.seq, cfg.d_model)
            ).astype(np.float32)
            if cfg.family == "vlm":
                batch.pop("tokens")
        return batch if mesh is None else place_batch(batch, mesh)

    if mesh is not None:
        hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        if mesh is None:
            state = init_state(model, torch.Generator(device=dev).manual_seed(
                args.seed), device=dev)
        else:
            state = placed_state(model, mesh, args.seed, dev)
        step_fn = make_train_step(model, base_lr=args.lr, warmup=10,
                                  total_steps=args.steps)
        sup = TrainingSupervisor(
            step_fn, data_at, args.ckpt, ckpt_every=args.ckpt_every
        )
        t0 = time.time()
        state, log = sup.run(state, args.steps, fail_injector)
        dt = time.time() - t0
    finally:
        if mesh is not None:
            hints.clear()
    first, last = log[0]["loss"], log[-1]["loss"]
    print(
        f"steps={len(log)} loss {first:.4f} -> {last:.4f} "
        f"({dt:.1f}s, {dt / max(len(log), 1):.3f}s/step, "
        f"stragglers={len(sup.monitor.flagged)}, restarts={sup.restarts})"
    )
    print(f"losses={[m['loss'] for m in log]}")
    assert np.isfinite(last), "training diverged"
    return log


if __name__ == "__main__":
    main()
