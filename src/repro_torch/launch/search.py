"""Similarity-search driver of the port (the CLI of ``repro/launch/search.py``).

  PYTHONPATH=src python -m repro_torch.launch.search --dataset ECG \
      --ref-len 100000 --query-len 256 --window-ratio 0.1 --variant eapruned \
      --device cuda

``--variant all`` runs the paper's four suites (``full``, ``pruned``,
``eapruned``, ``eapruned_nolb``) and prints the paper-style comparison:
time and the pruning counters, which are -1 here as in ``repro``'s driver
(it runs the counter-free rounds). ``--device`` defaults to the card; pass
``--device cpu`` to run the plain versions of the kernels on the CPU.

``--distributed`` shards the candidates over the ranks of a
``torch.distributed`` group with shared-ub rounds
(``search.make_distributed_search``). Under ``torchrun`` every rank joins
the group from the environment and runs on ``cuda:LOCAL_RANK`` with NCCL
(gloo with ``--device cpu``); rank 0 prints the results::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.search \
      --distributed --ref-len 1000000 --query-len 1024

Started without a launcher, it searches on a group of one.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.core.common import resolve_device
from repro_torch.data.synthetic import DATASETS, make_dataset, make_queries
from repro_torch.search import make_distributed_search, subsequence_search
from repro_torch.search.pipeline import VARIANTS


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ECG", choices=DATASETS)
    ap.add_argument("--ref-len", type=int, default=100_000)
    ap.add_argument("--query-len", type=int, default=256)
    ap.add_argument("--window-ratio", type=float, default=0.1)
    ap.add_argument("--variant", default="eapruned",
                    choices=VARIANTS + ("all",))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-queries", type=int, default=1)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.distributed and dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    ref = make_dataset(args.dataset, args.ref_len, args.seed)
    queries = make_queries(args.dataset, args.n_queries, args.query_len, args.seed)
    window = max(int(args.query_len * args.window_ratio), 1)
    variants = list(VARIANTS) if args.variant == "all" else [args.variant]

    header = (f"dataset={args.dataset} N={args.ref_len} l={args.query_len} "
              f"w={window} batch={args.batch} device={dev}")
    if args.distributed:
        _distributed(args, dev, ref, queries, window, header)
        return
    print(header)
    for variant in variants:
        tot = 0.0
        for qi, q in enumerate(queries):
            t0 = time.perf_counter()
            res = subsequence_search(
                ref, q, length=args.query_len, window=window,
                variant=variant, batch=args.batch, device=dev,
            )
            _sync(dev)
            dt = time.perf_counter() - t0
            tot += dt
            print(
                f"  {variant:14s} q{qi}: start={int(res.best_start)} "
                f"dist={float(res.best_dist):.5f} lanes={int(res.lanes)} "
                f"rounds={int(res.rounds)} rows={int(res.rows)} "
                f"cells={int(res.cells)} ({dt:.2f}s)"
            )
        print(f"  {variant:14s} total {tot:.2f}s")


def _distributed(args, dev: torch.device, ref, queries, window: int,
                 header: str) -> None:
    """Every query through the sharded search; rank 0 prints the header
    and ``repro``'s line per query. Joins the launcher's group (``RANK`` and
    ``WORLD_SIZE`` set) or forms a group of one, and destroys it on the
    way out."""
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"{header} ranks={dist.get_world_size()}")
        search = make_distributed_search(
            None, None, length=args.query_len, window=window,
            batch=args.batch, device=dev,
        )
        for qi, q in enumerate(queries):
            t0 = time.perf_counter()
            res = search(ref, q)
            _sync(dev)
            if rank0:
                print(
                    f"  q{qi}: start={int(res.best_start)} "
                    f"dist={float(res.best_dist):.5f} "
                    f"rounds={int(res.rounds)} "
                    f"({time.perf_counter() - t0:.2f}s)"
                )
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
