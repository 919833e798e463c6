"""Synthetic long time series shaped like the paper's six datasets (a copy of
``repro/data/synthetic.py``, so the port needs nothing from ``repro``).

The paper's experiments (§5) run over FoG, Soccer, PAMAP2, ECG, REFIT, PPG —
each one long reference series + 1024-sample queries. We generate spectrally
distinct analogues (deterministic per seed) so the benchmark suite exercises
the same regimes: quasi-periodic biosignals (ECG/PPG), random-walk-like load
measurements (REFIT), mixed activity (PAMAP2/FoG), and bursty motion
(Soccer). Queries are cut from a disjoint section of the generator stream,
matching the suite's query-vs-reference protocol.
"""
from __future__ import annotations

import zlib

import numpy as np

DATASETS = ("FoG", "Soccer", "PAMAP2", "ECG", "REFIT", "PPG")


def _ecg_like(rng: np.random.Generator, n: int, period: int = 180) -> np.ndarray:
    t = np.arange(n)
    phase = (t % period) / period
    qrs = np.exp(-((phase - 0.1) ** 2) / 0.0004) * 2.2
    pwave = np.exp(-((phase - 0.7) ** 2) / 0.004) * 0.4
    drift = 0.3 * np.sin(2 * np.pi * t / (37 * period))
    jitter = rng.normal(0, 0.05, n)
    return qrs + pwave + drift + jitter


def _ppg_like(rng, n, period=220):
    t = np.arange(n)
    base = np.sin(2 * np.pi * t / period) + 0.35 * np.sin(4 * np.pi * t / period + 0.8)
    resp = 0.25 * np.sin(2 * np.pi * t / (period * 4.7))
    return base + resp + rng.normal(0, 0.03, n)


def _walk(rng, n, scale=1.0):
    return np.cumsum(rng.normal(0, scale, n))


def _activity(rng, n, seg=2048):
    out = np.empty(n)
    i = 0
    while i < n:
        k = min(seg + int(rng.integers(-seg // 2, seg // 2)), n - i)
        freq = rng.uniform(0.01, 0.12)
        amp = rng.uniform(0.3, 2.0)
        t = np.arange(k)
        out[i : i + k] = amp * np.sin(2 * np.pi * freq * t + rng.uniform(0, 6.28))
        out[i : i + k] += rng.normal(0, 0.15, k)
        i += k
    return out + 0.05 * _walk(rng, n, 0.2)


def _bursty(rng, n):
    base = _walk(rng, n, 0.3)
    bursts = (rng.random(n) < 0.002).astype(float)
    kernel = np.exp(-np.arange(64) / 12.0)
    spikes = np.convolve(bursts * rng.normal(3, 1, n), kernel)[:n]
    return base + spikes


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    """Long reference series for a paper-analogue dataset.

    Deterministic *across processes*: the seed mixes ``zlib.crc32`` of the
    name, not Python's per-process-salted ``hash()`` — benchmark artifacts
    (BENCH_dtw.json) must be comparable between runs and PRs.
    """
    rng = np.random.default_rng((zlib.crc32(name.encode()) + 977 * seed) % (2**31))
    if name == "ECG":
        return _ecg_like(rng, n)
    if name == "PPG":
        return _ppg_like(rng, n)
    if name == "REFIT":
        return np.abs(_walk(rng, n, 0.5)) + _activity(rng, n, 4096) * 0.3
    if name == "PAMAP2":
        return _activity(rng, n, 3072)
    if name == "FoG":
        return _activity(rng, n, 1024) + 0.2 * _bursty(rng, n)
    if name == "Soccer":
        return _bursty(rng, n)
    raise ValueError(f"unknown dataset {name!r}")


def make_queries(
    name: str, n_queries: int, length: int = 1024, seed: int = 1
) -> np.ndarray:
    """Queries cut from a disjoint stretch of the same generator."""
    stream = make_dataset(name, (n_queries + 2) * length * 3, seed=seed + 1000)
    rng = np.random.default_rng(seed)
    starts = rng.choice(len(stream) - length, n_queries, replace=False)
    return np.stack([stream[s : s + length] for s in starts])
