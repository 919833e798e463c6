"""Similarity-search driver of the port (the CLI of ``repro/launch/search.py``
for the two EA variants).

  PYTHONPATH=src python -m repro_torch.launch.search --dataset ECG \
      --ref-len 100000 --query-len 256 --window-ratio 0.1 --variant eapruned \
      --device cuda

``--variant all`` runs both EA variants. ``--device`` defaults to the card;
pass ``--device cpu`` to run the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.common import resolve_device
from repro_torch.data.synthetic import DATASETS, make_dataset, make_queries
from repro_torch.search import subsequence_search
from repro_torch.search.pipeline import MULTI_VARIANTS


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
                    choices=MULTI_VARIANTS + ("all",))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-queries", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ref = make_dataset(args.dataset, args.ref_len, args.seed)
    queries = make_queries(args.dataset, args.n_queries, args.query_len, args.seed)
    window = max(int(args.query_len * args.window_ratio), 1)
    variants = list(MULTI_VARIANTS) if args.variant == "all" else [args.variant]

    print(
        f"dataset={args.dataset} N={args.ref_len} l={args.query_len} "
        f"w={window} batch={args.batch} device={dev}"
    )
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
                f"rounds={int(res.rounds)} ({dt:.2f}s)"
            )
        print(f"  {variant:14s} total {tot:.2f}s")


if __name__ == "__main__":
    main()
