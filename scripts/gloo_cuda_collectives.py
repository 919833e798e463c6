#!/usr/bin/env python
"""Which DTensor collectives gloo carries on CUDA tensors.

Two gloo ranks share ``cuda:0`` (NCCL refuses two ranks on one card) on a
``make_local_mesh(2, "cuda")`` mesh, and run one redistribution each, each
collective in a fresh pair of processes so that a crash in one hides none
of the others:

  all_gather      ``Shard(0)`` -> ``Replicate()`` (an FSDP weight gather)
  reduce_scatter  ``Partial()`` -> ``Shard(0)`` (a gradient's return)
  all_reduce      ``Partial()`` -> ``Replicate()`` (a loss, a norm)

Prints one line a collective: the two ranks' exit codes (-11: killed by
SIGSEGV) and their values. Needs one CUDA card.

    python scripts/gloo_cuda_collectives.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OPS = ("all_gather", "reduce_scatter", "all_reduce")
TIMEOUT = 120


def worker(op: str, rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                            world_size=2)
    mesh = make_local_mesh(2, "cuda")
    x = torch.arange(8.0, device="cuda").reshape(4, 2)
    print(f"{op}: started", flush=True)
    if op == "all_gather":
        out = distribute_tensor(x, mesh, (Replicate(), Shard(0))).redistribute(
            mesh, (Replicate(), Replicate())).to_local()
    else:
        pending = DTensor.from_local(x, mesh, (Replicate(), Partial()),
                                     run_check=False)
        want = (Replicate(), Shard(0) if op == "reduce_scatter" else Replicate())
        out = pending.redistribute(mesh, want).to_local()
    torch.cuda.synchronize()
    print("VALUES " + json.dumps(out.cpu().tolist()), flush=True)
    dist.destroy_process_group()


def main() -> int:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for op in OPS:
        with tempfile.TemporaryDirectory() as d:
            store = os.path.join(d, "store")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--worker", op, str(r), store],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env) for r in range(2)]
            rcs, values = [], []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                rcs.append(p.returncode)
                values.append([ln[len("VALUES "):] for ln in out.splitlines()
                               if ln.startswith("VALUES ")])
            print(f"{op}: exit codes {rcs}, values {values}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
