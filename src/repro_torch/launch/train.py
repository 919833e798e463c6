"""End-to-end training entry point of the port (the CLI of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 60 --batch 8 --seq 64 --ckpt /tmp/ckpt --device cpu

``--reduced`` trains the same-family miniature; without it the full
config. The loop, microbatching, checkpointing and supervision are
those of a full run. ``--device`` defaults to the card (it raises
without one); ``--device cpu`` runs on the CPU. One device only:
``--production-mesh`` and ``--model-parallel`` above 1 need the sharded
layout (``distributed/sharding.py``, ``launch/mesh.py``), which comes
with ROADMAP.md Queue 1 item 7c, and raise. Prints ``repro``'s lines.
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
from repro_torch.distributed.fault_tolerance import TrainingSupervisor
from repro_torch.models.registry import build
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)

    if args.production_mesh or args.model_parallel > 1:
        raise SystemExit(
            "--production-mesh and --model-parallel > 1 need the sharded "
            "layout (distributed/sharding.py, launch/mesh.py), which is not "
            "ported yet: ROADMAP.md Queue 1 item 7c")
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.batch % max(cfg.num_microbatches, 1):
        cfg = dataclasses.replace(cfg, num_microbatches=1)
    model = build(cfg)
    print(f"arch={cfg.name} mesh={{'data': 1, 'model': 1}}")

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
        return batch

    state = init_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)
    step_fn = make_train_step(model, base_lr=args.lr, warmup=10,
                              total_steps=args.steps)
    sup = TrainingSupervisor(
        step_fn, data_at, args.ckpt, ckpt_every=args.ckpt_every
    )
    t0 = time.time()
    state, log = sup.run(state, args.steps)
    dt = time.time() - t0
    first, last = log[0]["loss"], log[-1]["loss"]
    print(
        f"steps={len(log)} loss {first:.4f} -> {last:.4f} "
        f"({dt:.1f}s, {dt / max(len(log), 1):.3f}s/step, "
        f"stragglers={len(sup.monitor.flagged)}, restarts={sup.restarts})"
    )
    assert np.isfinite(last), "training diverged"


if __name__ == "__main__":
    main()
