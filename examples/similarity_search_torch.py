"""End-to-end similarity search over a paper-style dataset, all four
suites, on the PyTorch/CUDA port.

The counterpart of ``examples/similarity_search.py`` on ``repro_torch``:
a long ECG-like reference, a query, the four suite variants, an exactness
check, wall times and pruning counters. A second stage replays the same
reference as a live stream through ``StreamSearchEngine``: chunks arrive
one at a time, per-query incumbents carried across chunks tighten every
later ingest's early abandoning, and the final answers match the offline
search.

Run:  PYTHONPATH=src python examples/similarity_search_torch.py \\
          [--ref-len 50000] [--device cpu]

``--device`` defaults to the card (``cuda``); with ``--device cpu`` every
kernel's plain PyTorch version runs instead.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.core.common import resolve_device
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import multi_query_search, subsequence_search
from repro_torch.search.pipeline import VARIANTS
from repro_torch.serve import StreamSearchEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream_demo(ref, args, dev: torch.device) -> None:
    """Replay ``ref`` as a stream of chunks against Q standing queries."""
    w = max(int(args.query_len * args.window_ratio), 1)
    queries = make_queries(args.dataset, 4, args.query_len, seed=2)
    chunk = max(args.ref_len // 10, args.query_len)
    print(
        f"\nstreaming: {queries.shape[0]} standing queries, "
        f"{chunk}-sample chunks"
    )
    eng = StreamSearchEngine(
        queries, length=args.query_len, window=w, batch=128,
        ring_capacity=4 * args.query_len, device=dev,
    )
    t0 = time.time()
    for lo in range(0, args.ref_len, chunk):
        bs, bd = eng.ingest(ref[lo : lo + chunk])
        ub = ", ".join(f"{float(d):8.3f}" for d in bd)
        print(f"  t={eng.n_seen:7d}  incumbents=[{ub}]  lanes={eng.lanes:6d}")
    _sync(dev)
    dt = time.time() - t0
    off = multi_query_search(
        ref, queries, length=args.query_len, window=w, batch=128, device=dev
    )
    bs, bd = eng.best()
    assert bs.tolist() == off.best_start.tolist(), (bs, off.best_start)
    print(
        f"stream of {eng.n_windows} windows in {dt*1e3:.1f} ms "
        f"(ring keeps last {eng.recent().shape[0]} samples); "
        "final answers match offline multi_query_search."
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-len", type=int, default=50_000)
    ap.add_argument("--query-len", type=int, default=256)
    ap.add_argument("--window-ratio", type=float, default=0.1)
    ap.add_argument("--dataset", default="ECG")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ref = make_dataset(args.dataset, args.ref_len, seed=0)
    q = make_queries(args.dataset, 1, args.query_len, seed=1)[0]
    w = max(int(args.query_len * args.window_ratio), 1)
    n_win = args.ref_len - args.query_len + 1
    print(f"{args.dataset}: N={args.ref_len} ({n_win} windows), "
          f"l={args.query_len}, w={w}, device={dev}\n")

    answers = []
    for variant in VARIANTS:
        def search(**kw):
            return subsequence_search(
                ref, q, length=args.query_len, window=w, variant=variant,
                batch=128, device=dev, **kw,
            )

        search()  # warm-up: the first call builds the kernels on the card
        _sync(dev)
        t0 = time.time()
        res = search()
        _sync(dev)
        dt = time.time() - t0
        # counters come from an (untimed) stats search; the timed search
        # above runs the counter-free default
        stats = search(with_info=True)
        answers.append((int(res.best_start), float(res.best_dist)))
        print(
            f"{variant:14s} -> start={int(res.best_start):7d} "
            f"dist={float(res.best_dist):10.4f}  {dt*1e3:8.1f} ms  "
            f"lanes={int(res.lanes):6d}  dp_rows={int(stats.rows):9d}"
        )
    starts = {s for s, _ in answers}
    d0 = answers[0][1]
    assert starts == {answers[0][0]}, f"variants disagree: {answers}"
    # distances agree to float32 working precision (the prefix-scan DTW
    # reformulation rounds differently per variant)
    assert all(abs(d - d0) <= 1e-4 * max(d0, 1.0) for _, d in answers), answers
    print("\nall four suites agree on the nearest neighbour (exactness).")

    stream_demo(ref, args, dev)


if __name__ == "__main__":
    main()
