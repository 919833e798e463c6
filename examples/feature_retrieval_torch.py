"""DTW retrieval over model-encoded feature sequences, on the PyTorch/CUDA
port.

The counterpart of ``examples/feature_retrieval.py`` on ``repro_torch``: a
Mamba2 backbone (reduced, random weights from a seed) encodes token
windows into d-dimensional activation sequences; EAPrunedDTW, which takes
multivariate series, retrieves the stored sequence closest to a query
sequence under DTW. Forward passes only.

Run:  PYTHONPATH=src python examples/feature_retrieval_torch.py [--device cpu]

``--device`` defaults to the card (``cuda``).
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import dtw, ea_pruned_dtw
from repro_torch.core.common import resolve_device
from repro_torch.models.registry import build


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ARCHS["mamba2-130m"].reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)

    rng = np.random.default_rng(0)
    n_db, seq = 48, 32

    # database of token windows; the query is a noisy copy of entry 17
    db_tokens = rng.integers(0, cfg.vocab, (n_db, seq))
    q_tokens = db_tokens[17].copy()
    flips = rng.choice(seq, 4, replace=False)
    q_tokens[flips] = rng.integers(0, cfg.vocab, 4)

    @torch.no_grad()
    def encode(tokens):
        logits, _ = model.forward(params, tokens=torch.as_tensor(tokens, device=dev))
        # the (B, S, V) pre-softmax features' first 64 columns as the
        # sequence embedding: a cheap stand-in for a trained encoder head
        return logits[..., :64]

    db = encode(db_tokens)
    q = encode(q_tokens[None])[0]

    # sequential NN search with EAPrunedDTW and ub tightening, multivariate
    ub = float(dtw(q, db[0]))
    best = 0
    abandoned = 0
    for i in range(1, n_db):
        d = float(ea_pruned_dtw(q, db[i], ub))
        if np.isinf(d):
            abandoned += 1
        elif d < ub:
            ub, best = d, i
    print(f"query was a corrupted copy of entry 17 -> retrieved entry {best}")
    print(f"early-abandoned {abandoned}/{n_db - 1} comparisons (ub={ub:.4f})")
    if best != 17:
        raise SystemExit("retrieval failed")


if __name__ == "__main__":
    main()
