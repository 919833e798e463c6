"""Quickstart: EAPrunedDTW in five minutes, on the PyTorch/CUDA port.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to the card (``cuda``); with ``--device cpu`` every
kernel's plain PyTorch version runs instead.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import dtw, ea_pruned_dtw, ea_pruned_dtw_batch
from repro_torch.core.common import resolve_device
from repro_torch.search import subsequence_search


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ref-len", type=int, default=5000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. exact DTW (the paper's Fig. 2 example) -------------------------
    S = torch.tensor([3.0, 1, 4, 4, 1, 1], device=dev)
    T = torch.tensor([1.0, 3, 2, 1, 2, 2], device=dev)
    print(f"DTW(S, T) = {float(dtw(S, T))}")  # 9.0

    # --- 2. early abandoning: ub=6 proves the pair can't beat the incumbent
    print(f"EAPrunedDTW(S, T, ub=9) = {float(ea_pruned_dtw(S, T, 9.0))}")  # 9.0
    print(f"EAPrunedDTW(S, T, ub=6) = {float(ea_pruned_dtw(S, T, 6.0))}")  # inf

    # --- 3. batched search: one query vs many candidates, shared ub --------
    # (one launch of kernel D on the card)
    rng = np.random.default_rng(0)
    query = torch.tensor(np.cumsum(rng.normal(size=128)), dtype=torch.float32,
                         device=dev)
    cands = torch.tensor(np.cumsum(rng.normal(size=(64, 128)), axis=1),
                         dtype=torch.float32, device=dev)
    d = ea_pruned_dtw_batch(query, cands, ub=50.0, window=12)
    print(f"batch: {int(torch.isfinite(d).sum())}/64 candidates survived "
          "ub=50")

    # --- 4. full subsequence similarity search (the paper's application) ---
    # (kernel B once, then kernel A a round, on the card)
    ref = np.cumsum(rng.normal(size=args.ref_len)).astype(np.float32)
    res = subsequence_search(ref, query, length=128, window=12,
                             variant="eapruned", device=dev)
    print(
        f"nearest window: start={int(res.best_start)} "
        f"dist={float(res.best_dist):.4f} ({int(res.lanes)} of "
        f"{args.ref_len - 127} windows ran DTW; {int(res.cells)} DP cells "
        "issued)"
    )


if __name__ == "__main__":
    main()
