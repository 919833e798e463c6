#!/usr/bin/env python
"""Where a train step's memory peaks: Llama-3.2-3B at full width on the
card, as ``chip_smoke.py`` phase 8 (a) runs it, unplaced and placed on a
mesh of one (phase 9 (a)).

For each form it prints the allocation peak and the allocated bytes (GB)
after building the state, then, for each of two steps, after each
microbatch's forward, after its backward, and at the step's end (the
accumulation and the optimizer); the peak is reset at each mark. Needs
one CUDA card (~80 GB).

    python scripts/train_memory_stages.py
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GB = 1e9


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import batch_axes, place_batch
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    marks = []

    def mark(label):
        torch.cuda.synchronize()
        marks.append((label, round(torch.cuda.max_memory_allocated() / GB, 3),
                      round(torch.cuda.memory_allocated() / GB, 3)))
        torch.cuda.reset_peak_memory_stats()

    grad = torch.autograd.grad

    def traced_grad(*args, **kwargs):
        mark("forward")
        out = grad(*args, **kwargs)
        mark("backward")
        return out

    torch.autograd.grad = traced_grad
    cfg = ARCHS[cs.TRAIN_ARCH]
    model = build(cfg)
    dev = torch.device("cuda")
    started = launch.join_group(dev)
    try:
        for form in ("unplaced", "placed"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=dev).manual_seed(cs.TRAIN_SEED)
            if form == "unplaced":
                state = init_state(model, gen, device=dev)
                put = lambda b: b  # noqa: E731
            else:
                mesh = make_local_mesh(1)
                hints.set_axes(batch_axes(mesh), mesh=mesh)
                state = launch.placed_state(model, mesh, cs.TRAIN_SEED, dev)
                put = lambda b: place_batch(b, mesh)  # noqa: E731
            marks.clear()
            mark("state")
            print(form, marks, flush=True)
            step = make_train_step(model, base_lr=cs.TRAIN_LR,
                                   warmup=cs.TRAIN_WARMUP,
                                   total_steps=cs.TRAIN_TOTAL)
            for i in range(2):
                marks.clear()
                state, m = step(state, put(cs.train_data(
                    cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, i)))
                mark("step end")
                print(form, f"step {i} loss {float(m['loss'])!r}", marks,
                      flush=True)
            hints.clear()
            del state
    finally:
        torch.autograd.grad = grad
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(cs.phase_card(torch)["smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
