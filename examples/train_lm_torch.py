"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch/CUDA
port (the counterpart of ``examples/train_lm.py``).

Uses the mamba2-130m architecture at FULL width but reduced depth, so it
is a real ~100M-parameter training run: microbatching, async checkpoints
and restart, under ``TrainingSupervisor``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

``--device`` defaults to the card (``cuda``).
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.common import resolve_device
from repro_torch.data.lm import TokenStream
from repro_torch.distributed.fault_tolerance import TrainingSupervisor
from repro_torch.models.registry import build
from repro_torch.train.layout import leaves
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # full-width mamba2 (d_model 768, vocab 50280), reduced depth: ~90M params
    cfg = dataclasses.replace(
        ARCHS["mamba2-130m"], n_layers=args.depth, dtype="float32",
        num_microbatches=1,
    )
    model = build(cfg)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(p.numel() for _, p in leaves(state.params))
    print(f"training {cfg.name} depth={args.depth}: {n_params/1e6:.1f}M params")

    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=0)
    step_fn = make_train_step(model, base_lr=1e-3, warmup=20,
                              total_steps=args.steps)
    sup = TrainingSupervisor(step_fn, stream.batch_at, args.ckpt, ckpt_every=100)
    t0 = time.time()
    state, log = sup.run(state, args.steps)
    dt = time.time() - t0
    losses = [m["loss"] for m in log]
    print(
        f"{len(log)} steps in {dt:.0f}s ({dt/len(log):.2f}s/step): "
        f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}"
    )
    assert np.mean(losses[-10:]) < losses[0], "loss must decrease"
    print("done; checkpoints in", args.ckpt)


if __name__ == "__main__":
    main()
