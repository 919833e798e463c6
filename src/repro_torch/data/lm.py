"""Deterministic synthetic LM token pipeline (port of ``repro/data/lm.py``;
numpy only, the port's own copy).

Produces a Zipf-distributed token stream with local n-gram structure (so the
loss actually decreases during the example training runs), packed into
(batch, seq) examples. Deterministic per (seed, step): a restarted job
resumes mid-epoch without coordination, which is the property a real sharded
loader must provide for fault-tolerant training (see
distributed/fault_tolerance.py). ``batch_at(step)`` gives ``repro``'s
arrays bit for bit.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenStream:
    """Stateless batch generator: ``batch(step)`` is a pure function."""

    def __init__(
        self,
        vocab: int,
        batch: int,
        seq_len: int,
        seed: int = 0,
        n_shards: int = 1,
        shard: int = 0,
    ):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        # a fixed random bigram table gives learnable local structure
        tr = np.random.default_rng(seed)
        self._successors = tr.integers(0, vocab, size=(min(vocab, 4096), 8))

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.n_shards + self.shard
        )
        b, s, v = self.batch, self.seq_len + 1, self.vocab
        # zipf marginals
        toks = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
        # inject bigram structure: with p=0.6 the next token is a fixed
        # successor of the current one
        follow = rng.random((b, s)) < 0.6
        idx = toks[:, :-1] % self._successors.shape[0]
        succ = self._successors[idx, rng.integers(0, 8, size=(b, s - 1))]
        toks[:, 1:] = np.where(follow[:, 1:], succ, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
