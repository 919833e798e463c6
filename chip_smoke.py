#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never ``repro``) on ``cuda:0``:

  1. the card: its name, and its power limit from ``nvidia-smi``;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, with
     ``nvcc``, in parallel; ptxas's registers; and for each band of
     ``WIDE_BANDS`` each wide kernel's registers, shared memory a block,
     blocks an SM (the occupancy query, which must be the model the CPU
     tests pin) and whether its window is staged in shared memory;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (N = 1e6 ECG reference, 8 queries of l = 1024, w = 102):
     kernel B over every window; kernel A over the lane sets and ``ub``s of
     the first 3 host rounds, with ``use_cb`` on and off; kernel D on the
     slab of the same lanes (equal to A bit for bit with ``use_cb`` off);
     the counter variants of A and D (``with_info``) on the same rounds:
     their distances the counter-free kernel's bits, their per-lane rows
     and cells the plain version's except on lanes near a threshold (whose
     counters in the plain version move when ``ub`` moves by ``TOL_A``;
     those must lie between the plain version's at the moved bounds), and
     A's equal to D's without cb;
     kernels C and E over each query's whole best-first order, at a cold
     and a warm seed, against plain sweeps run on the card (C equal to E bit
     for bit, and C run again giving the same ``(best_dist, best_start)``
     bits), and over its first 512 lanes with ``use_cb`` on and off and
     cold, warm and unbeaten seeds; kernel B also at ragged shapes on an
     N = 100,003 reference (Q of 1, 3, 8 and 13, l of 48, 1000, 1024, the
     largest whose blocks hold their span of the reference and the largest
     the kernel takes, quarantined and flat windows, LB_Kim
     and LB_Keogh each off, a reference scaled by 1e15), where each Q must
     give the same bits as the same queries at Q = 13 (other query tiles);
     then repeatability: ``window_stats`` and kernels B and A run again on
     the same inputs must give the same bits (a 1-D ``torch.cumsum``, which
     ``window_stats`` does not use on the card, is shown beside them);
     then the wide row ("phase 3 wide", bands past 1024 columns:
     ``WIDE_BANDS``, l = 2048 at ratio 0.5, l = 8192 at 0.1 and l = 16,384
     at 0.5, over the first best-first lanes of each band's own cascade on
     an N = 200,000 ECG reference, 512 lanes at the first two and 256 at
     the third, whose first 16 are held to the plain versions): A and D (a
     round under each query's median ``ub``, with counters; D also on full
     rows, n != m = 2048), C and E (the cold sweep), ``use_cb`` on and
     off, against their plain versions within ``TOL_WIDE``, C's
     ``best_start`` the plain sweep's; and the one-warp row at its widest
     ("phase 3 long row", l = 4096, bw = 832, CPT = 32), A and C against
     their plain versions; and the short query ("phase 3 short row",
     ``SHORT_ROW``: l = 128, w = 12, CPT = 1, right after the
     repeatability checks), kernel B over every window and kernel A,
     counter-free and with counters, over the first 3 host rounds of its
     N = 1e6, Q = 8 search, as at l = 1024. Kernels C and E over the
     whole order, the wide row and the long row run after phase 4, beside
     phase 10's subprocess arms and phase 5's CPU halves, so their plain
     versions' times are taken there (the whole-order plain sweeps are
     bound on the card);
  4. the main path end to end: ``multi_query_search`` at the
     ``SearchConfig`` defaults (ECG, N = 1,000,000, l = 1024, w = 102,
     Q = 8, batch = 256, ``eapruned``), once with host rounds and once with
     ``rounds="persistent"``, each with every kernel's launch count set to 0
     just before and read just after; each winner's distance is recomputed
     with the DP oracle, and each search run once more must give the same
     bits; the persistent search must launch C once, B once and A never,
     and find the host rounds' ``best_start``; the host rounds run a third
     time, every round eager, with CUDA events around every launch of
     kernel A, to split their wall into kernel A and the host loop, and a
     fourth time with
     ``with_info=True`` (the counter variant of A), which must give the
     same ``best_start`` and ``best_dist`` bits, and prints each query's
     int64 rows and cells. Then the slab arms at the
     same N, each against its fused counterpart: host rounds with
     ``gather="slab"`` (kernel D) and the persistent sweep with
     ``gather="slab"`` (kernel E, over a 33 GB slab; its allocation peak is
     printed). Then streaming ("phase 4 stream"): ``StreamSearchEngine``
     over the same N = 1e6 reference and queries, fed in seeded ragged
     arrivals of 1 to 50,000 samples, each engine built by
     ``SearchConfig.make_stream_engine``, in five arms: (a) the default
     engine (``stream_chunk`` = 8192, ``gather="fused"``: kernels B and
     A), run again with every round eager and CUDA events around A and B,
     which must give the same bits and launches and split its wall; (b)
     the raw form
     (``stream_chunk=None``, 100,000-sample arrivals); (b2) the raw form on
     (a)'s arrivals, which times the fixed ingest shape; (c)
     ``gather="slab"`` (kernels B and D); (d) re-admission: a ring of
     65,536 samples and a 16-sample NaN burst mid-stream, ``correct``d
     after the arrival that completes its last window, ``save_state``
     (which rescores the 1,039 windows in one launch of kernel D: kernel D
     on that slab is held against its plain version under the carried
     incumbents and under ``ub = BIG``, and the flush's incumbents against
     ``rescore_windows`` on the CPU), and ``restore_state`` into a fresh
     engine that ingests the rest. Each
     arm's ``best_start`` must be the offline host rounds', or a near tie:
     both windows' DTW in float64 (float64 window stats) within ``TOL_A``;
     ``best_dist`` within ``TOL_A``; no quarantined window left; kernel
     A's (or D's) launches the sum of the ingests' rounds, kernel B's one
     a query tile per ingest that completes a window. Each arm prints its
     wall, ingests, rounds, lanes and the latency of an arrival at the
     median and the 99th percentile. Then the fault-tolerant host layer
     ("phase 4 resilient"), each arm with its launches counted from 0:
     (a) ``SearchConfig.resilient_search`` in ``RES_RANGES`` ranges over
     the config's 4 shards (the default runner, host rounds a range):
     coverage 1, one attempt a range, the offline winners or a proven near
     tie, kernel A's launches the ranges' rounds and B's one a query tile
     a range; (b) the same ranges on ``PersistentExecutor`` (C once a
     range, A never; (a)'s winners or a near tie); (c) fault recipes
     (``ShardFaults``, raised before the dispatch) on the reference cut to
     ``RES_CUT`` samples: a dead shard, a range that fails once, a shard
     that dies after two calls beside a dead one (coverage 1, the clean
     cut search's winners or a near tie) and the last range dead on every
     shard (coverage exactly ``1 - len/n_win``, that range uncovered, the
     winners of an offline search over the covered prefix); (d) a
     ``HedgedExecutor`` over two ``HostRoundsExecutor``s whose first
     straggles on ``RES_SLOW_RANGES`` on a fake clock: those hedges, won,
     and (a)'s bits (the same ranges unhedged); (e) ``SearchSupervisor``
     around the default engine on arm (a)'s arrivals, a checkpoint every
     ``RES_CKPT_EVERY``: transient faults at ``RES_FAULT_ARRIVALS``, a kill
     after ``RES_KILL_AFTER`` and ``resume()``, ``async_ckpt=True``, and
     the newest checkpoint truncated (``resume()`` falls back one), each
     arm (a)'s bits (``ub``, ``best``, rounds, lanes); (f) the default
     engine over a ``HedgedExecutor`` of two ingest executors, the first
     straggling on ``RES_SLOW_INGESTS``: arm (a)'s bits, A launched arm
     (a)'s rounds plus the backups'. Then sharded search ("phase 4
     sharded", on ``torch.distributed``): (a) a group of one on NCCL in
     this process, ``make_distributed_multi_search`` with
     ``gather="fused"`` (kernels B and A) and ``"slab"`` (B and D), each
     holding the host rounds' (fused or slab) ``best_start`` and
     ``best_dist`` bits and rounds, B launched once and A (or D) once a
     round; (b) a gloo group of ``SHARD_WORLD`` spawned ranks (this script
     with ``--shard``), all on the one card, fused: every rank the same
     answer and launches, the offline winners or a proven near tie (two
     processes share one card, so its wall says nothing of scaling); (c)
     ``resilient_search`` in ``RES_RANGES`` ranges over a
     ``ShardedExecutor`` of the group of one: coverage 1, one program for
     every range, B once a range, A the ranges' rounds, the offline
     winners or a near tie. Then the wide search ("phase 4 wide",
     ``WIDE_SEARCH``: N = 200,000, l = 2048, w = 1024, Q = 8) under host
     rounds and the persistent sweep, launches counted from 0: the same
     ``best_start``, A and B (host) and C and B (sweep) launched, each
     winner a nearest window in float64 up to ``TOL_A`` among the first
     ``WIDE_CANDIDATES`` windows of its best-first order;
  5. the same search at N = 50,000, l = 256, w = 25, Q = 4 on the card and
     with ``device="cpu"``, for both drivers and both EA variants; then a
     stream on the card against the CPU (N = 20,000, l = 1024, w = 102,
     ``STREAM_CROSS_Q`` queries, ``stream_chunk`` = 8192: the same
     ``best_start`` and quarantine counts, distances within
     ``TOL_CROSS``), and ``ea_search_round`` and the full-row
     ``ea_pruned_dtw`` (the paper's example among them) on the card
     against the CPU; then, once phase 10's subprocess arms have ended,
     the paper's four suites (``full``, ``pruned``, ``eapruned``,
     ``eapruned_nolb``) through ``subsequence_search`` under both drivers,
     the host rounds with counters, at l = 1024, w = 102 on a reference
     cut to N = 20,000 (the baselines are row loops of PyTorch ops, about a
     dozen launches a DP row): each run's winner a nearest window up to
     float32 rounding (against a float64 brute force over every window),
     the runs of one DP the same ``best_start``, rows and cells in the
     order ``eapruned <= pruned <= full``; and ``full`` and
     ``pruned`` on the card against the CPU at N = 20,000, l = 256, w = 25;
     and the wide search ("phase 5 wide cross-check", l = 2048, ratio 0.5,
     N = 2,200, 2 queries) under both drivers on the card against host
     rounds on the CPU: the same ``best_start``, distances within
     ``TOL_WIDE``. The CPU halves of the three card-against-CPU checks
     (the searches, the stream and the wide search) run in a subprocess
     (``cpu_ref_worker``, ``CPU_REF_THREADS`` threads) beside phase 10's
     arms; the card halves and the comparisons run once it has ended;
  6. per-kernel times with CUDA events beside the plain versions' times and
     the bounds (C and E: the whole cold sweep of phase 3), kernel B's share
     of its bound, time per term and registers, kernel A's time per DP
     row, the counter variants of A and D (``info_ms``), each DTW kernel's
     share of its bound, the lanes C and E keep in
     flight and run per query, and the host-rounds wall per round less
     kernel A's time; then A, D (a round), C and E (the cold sweep) on the
     wide row at the phase-3 bands ("phase 6 wide"), beside their plain
     versions' times and their bounds, with the share of the bound and
     cells a second; then B and A at the short query ("phase 6 short
     row"), beside their plain versions' times and their bounds;
  7. LM serving ("phase 7 lm serve"), which launches none of the five
     kernels (the launch counts are set to 0 before each arm and read
     after it): (a) Llama-3.2-3B at full width (28 layers, d 3072, 24 / 8
     heads, vocab 128,256, tied, bfloat16), random weights from a seeded
     generator on the card, 4 prompts of 512 tokens plus 64 greedy tokens
     through ``serve.generate``, run once for the logits and again, warm
     at the same shapes, for prefill ms and decode ms a token (p50, p99)
     by CUDA events, tokens a second and the allocation peak;
     ``torch.profiler``'s device time over one prefill and 8 decode
     steps; the decode logits held to a teacher-forced bfloat16 forward
     over the generated sequence (``TOL_LM_BF16``) and to a float32 copy
     of the weights on the card (within ``TOL_LM_F32``, and each greedy
     token's float32 logit within ``TOL_LM_TIE`` of its row's maximum);
     the score product held to float64 (``TOL_LM_SCORES``), and both it
     and the float32 gap read again with the product left in bfloat16,
     the control; (b) one 8,192-token prompt (past
     ``CHUNKED_THRESHOLD``) prefilled on the chunked online-softmax
     attention and on the plain one, last-token logits within
     ``TOL_LM_BF16`` and the argmaxes a near tie; (c) Mamba2-130M at full
     width (24 layers, d 768, bfloat16), the same generation and checks;
     (d) every arch at ``reduced()`` in float32, weights drawn on the CPU
     and carried to the card: forward logits, and greedy tokens (through
     ``generate`` where it runs, else by ``decode_step``: pixtral after an
     embeddings prefill, recurrentgemma from the empty cache, whisper after
     ``prefill_encoder``) with the logits each was chosen from, card
     against CPU within ``TOL_LM_CROSS``;
  8. LM training ("phase 8 lm train"), which launches none of the five
     kernels either (counted per arm): (a) Llama-3.2-3B at full width in
     bfloat16 (AdamW, ``num_microbatches`` 2, remat), random weights from a
     seeded generator on the card, 4 x 512 tokens a step from
     ``TokenStream``, through ``make_train_step``: one untimed step, 6
     timed by CUDA events (step ms p50 and max, tokens a second, host
     wall), one under ``torch.profiler`` (device busy share, time by kind
     of kernel), the allocation peak, each step's loss and gradient norm
     (finite), beside the step's bound (products at the bfloat16 peak,
     AdamW's and the accumulation's bytes); (b) one microbatch (2 x 512) of
     (a)'s weights under deterministic algorithms: the bfloat16 gradients
     with remat on and off (ms, peak, bit-equal) and against a float32 copy
     on the card, per leaf by relative L2 (``TOL_TRAIN_GRAD``) with the
     loss gap (``TOL_TRAIN_LOSS``), and the control, a float32 copy with
     one layer perturbed, which must miss the gradient limit; (c) Mamba2-130M at full
     width in bfloat16 under ``TrainingSupervisor`` and deterministic
     algorithms, 12 steps of 8 x 512 with async checkpoints every 4 and a
     failure injected at step 9: one restart, the uninterrupted run's last
     loss and every leaf bit for bit, and the last checkpoint restored
     into a zeroed state bit for bit (bfloat16 leaves included); (d) every
     arch at ``reduced()`` in float32 (kimi-k2 with Adafactor, Llama also
     with ``grad_compression="int8"``), 3 steps on the card and on the CPU
     from one state: losses and gradient norms within ``TOL_TRAIN_CROSS``,
     parameters within ``TOL_TRAIN_PARAMS`` (int8: quantization rounds
     near-halves either way, so its parameters are reported only);
  9. sharded LM training ("phase 9 lm sharded"), on a group of one on
     NCCL and a ``make_local_mesh(1)`` mesh, launching none of the five
     kernels (counted per arm): (a) phase 8 (a)'s Llama-3.2-3B run placed
     by ``launch.train.placed_state`` (``make_state_specs``: DTensors),
     each batch by ``make_batch_specs``, the activation anchors set:
     4 steps of phase 8 (a)'s batches, losses and gradient norms within
     ``TOL_TRAIN_CROSS`` of phase 8 (a)'s first 4 (bit-equality
     reported), step ms (p50) beside phase 8 (a)'s, the peak, the leaves
     by placement; (b) kimi-k2 ``reduced()`` in float32 with nothing
     dropped, ``moe_impl="ep"`` against ``"dense"``: forward logits within
     ``TOL_LM_CROSS``, one step within ``TOL_TRAIN_CROSS``; (c)
     ``launch.train`` on Llama's ``reduced()`` on the card under
     deterministic algorithms: its main (one rank: the unplaced state),
     then its loop on the mesh of one, 6 steps uninterrupted and with a
     failure injected at step 4 through the supervisor's
     ``fail_injector``: one restart, the uninterrupted run's last loss bit
     for bit, the main's within ``TOL_TRAIN_CROSS``;
 10. the dry-run ("phase 10 dryrun", ``launch.dryrun`` on torch's
     ``fake`` backend; its arms (a), (b) and (c)'s trace run as
     subprocesses, one thread each, since a fake world cannot share a
     process with phase 9's NCCL group, started after phase 4 beside
     phase 5's CPU halves and the phase-3 checks that time nothing but
     their plain versions, and the script waits for them before phase 5's
     comparisons): (a)
     Llama-3.2-3B's four shapes on the ``(16, 16)`` production mesh over
     a ``"cuda"`` mesh of the fake group, long_500k skipped, each cell's
     per-device FLOPs, bytes, collectives by kind and trace seconds
     printed; (b) kimi-k2 train_4k under ``--opt`` (the expert-parallel
     MoE), its all-to-all count beside the same cell's on a CPU mesh
     (where DTensor runs an all-to-all as an all-gather and the counter
     still counts an all-to-all); (c) phase 8 (a)'s
     step counted by ``roofline.op_stats`` on the card's tensors and
     traced on a fake group of one: equal dot FLOPs, the analytic state
     bytes the real state's, and ``perf_cell``'s three H100 terms beside
     phase 8 (a)'s step ms and bound; (d) the search cell at N = 1e6 on
     the ``(16, 16)`` fake group, rank 0's range on kernels B and A: its
     best start a one-device search's over that range, its distance
     within ``TOL_A``, its rounds and a round's collectives; (e)
     Llama-3.2-3B served over parameters and cache placed on an NCCL
     mesh of one: a 4 x 512 prefill and 8 decode steps of phase 7 (a)'s
     tokens, logits within ``TOL_LM_BF16`` of phase 7 (a)'s (bit-equality
     reported), prefill and decode ms beside phase 7 (a)'s;
 11. a ``{"stream": {...}}`` line of the streaming arms' numbers, a
     ``{"resilient": {...}}`` line of the host layer's arms, a
     ``{"sharded": {...}}`` line of the sharded arms, a
     ``{"lm_serve": {...}}`` line of phase 7's arms, a
     ``{"lm_train": {...}}`` line of phase 8's arms, a
     ``{"lm_sharded": {...}}`` line of phase 9's arms, a
     ``{"dryrun": {...}}`` line of phase 10's arms, a
     ``{"kernels": [...]}`` line (``launches`` on the offline path that runs
     each kernel, ``stream_launches`` in streaming arm (a) for A and B and
     arm (c) for D, ``resilient_launches`` in arm (a) of phase 4 resilient
     for A and B and arm (b) for C, ``sharded_launches`` in phase 4
     sharded's arm (a), fused for A and B and slab for D, ``lm_launches``
     in phase 7, ``train_launches`` in phase 8 and
     ``sharded_train_launches`` in phase 9, all 0, ``dryrun_launches``
     in phase 10's search cell, A and B; ``short_row``: A's and B's
     times at the short query), the card's name
     and power limit; the last line is ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
It exits non-zero at once when ``torch.cuda.is_available()`` is false, and
fails on import when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Main-path sizes: repro_torch.configs.dtw_search.SearchConfig defaults.
DATASET = "ECG"
DEVICE = "cuda"
CROSS = dict(ref_len=50_000, query_len=256, window=25, n_queries=4)
# The baselines phase: the four suites at the main path's l and w on a
# reference cut to BASELINE_N samples, and full/pruned on the card against
# the CPU at BASELINE_CROSS.
BASELINE_N = 20_000
BASELINE_CROSS = dict(ref_len=20_000, query_len=256, window=25)
KERNEL_A_ROUNDS = 3
# Streaming (phase 4 stream): arrivals of 1 to STREAM_MAX_ARRIVAL samples
# drawn from STREAM_SEED; the raw-form arm takes STREAM_RAW_CHUNK-sample
# arrivals; the re-admission arm keeps a ring of STREAM_RING samples and
# plants a STREAM_BURST-sample NaN burst mid-stream. The card-against-CPU
# stream (phase 5) runs on a reference cut to BASELINE_N with the first
# STREAM_CROSS_Q queries and arrivals of 1 to STREAM_CROSS_ARRIVAL: the
# CPU's plain kernel A takes about a second a round at l = 1024 (80 s for
# the 73 rounds of 4 queries on the H100's host), so it runs 2 queries.
STREAM_SEED = 16
STREAM_MAX_ARRIVAL = 50_000
STREAM_RAW_CHUNK = 100_000
STREAM_RING = 65_536
STREAM_BURST = 16
STREAM_CROSS_Q = 2
STREAM_CROSS_ARRIVAL = 8_000
# The fault-tolerant host layer (phase 4 resilient): RES_RANGES work ranges
# over the config's n_shards; the fault recipes on a reference cut to
# RES_CUT samples; a HedgedExecutor whose executor 0 straggles on ranges
# RES_SLOW_RANGES; supervised streams on stream arm (a)'s arrivals with a
# checkpoint every RES_CKPT_EVERY arrivals, transient faults at arrivals
# RES_FAULT_ARRIVALS and a kill after arrival RES_KILL_AFTER; a hedged
# stream whose executor 0 straggles on ingests RES_SLOW_INGESTS.
RES_RANGES = 8
RES_CUT = 200_000
RES_SLOW_RANGES = (2, 5)
RES_CKPT_EVERY = 8
RES_FAULT_ARRIVALS = (5, 20)
RES_KILL_AFTER = 30
RES_SLOW_INGESTS = (10, 60, 120)
# Sharded search (phase 4 sharded): arms (a) and (c) run a group of one on
# SHARD_BACKEND in this process; arm (b) runs SHARD_WORLD spawned ranks of a
# gloo group on the one card (NCCL refuses two ranks on one device), each
# warmed up on the first SHARD_WARM_N samples and given SHARD_TIMEOUT
# seconds; arm (a) also times SHARD_COLL_REPS of the round loop's
# collectives alone.
SHARD_BACKEND = "nccl"
SHARD_COLL_REPS = 1000
SHARD_WORLD = 2
SHARD_WARM_N = 100_000
SHARD_TIMEOUT = 300
# LM serving (phase 7): LM_ARCH at full width in bfloat16, random weights
# from LM_SEED on the card: LM_BATCH prompts of LM_PROMPT tokens plus LM_NEW
# greedy tokens through serve.generate; one prompt of LM_LONG tokens (past
# models.attention.CHUNKED_THRESHOLD) prefilled on the chunked and on the
# plain attention; LM_SSM_ARCH at full width, the same generation; every
# arch at reduced() card against CPU, LM_CROSS_B prompts of LM_CROSS_S
# tokens and LM_CROSS_NEW greedy tokens. The profiler watches
# LM_PROFILE_STEPS decode steps of each full-width arch.
LM_ARCH = "llama3.2-3b"
LM_SSM_ARCH = "mamba2-130m"
LM_SEED = 0
LM_BATCH = 4
LM_PROMPT = 512
LM_NEW = 64
LM_LONG = 8192
LM_CROSS_B = 2
LM_CROSS_S = 12
LM_CROSS_NEW = 8
LM_PROFILE_STEPS = 8
LM_TOP_OPS = 4  # the prefill's costliest kernels reported
LM_OP_NAME = 60  # characters of a kernel's name kept
# LM training (phase 8): TRAIN_ARCH at full width (bfloat16, AdamW,
# num_microbatches 2, remat) on TRAIN_BATCH x TRAIN_SEQ tokens a step from
# TokenStream(TRAIN_SEED): one untimed step, then TRAIN_STEPS timed ones and
# one under torch.profiler; the precision arm's gradients on one
# microbatch of its weights; TRAIN_SSM_ARCH at full width under
# TrainingSupervisor, SUP_STEPS steps of SUP_BATCH x TRAIN_SEQ, an async
# checkpoint every SUP_EVERY steps, a failure injected at step SUP_FAIL;
# every arch at reduced() CROSS_STEPS steps of CROSS_B x CROSS_S on the
# card and on the CPU from one state. The schedule: TRAIN_LR after
# TRAIN_WARMUP steps, cosine to TRAIN_TOTAL.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_SSM_ARCH = "mamba2-130m"
TRAIN_SEED = 0
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_STEPS = 6
TRAIN_LR = 3e-4
TRAIN_WARMUP = 10
TRAIN_TOTAL = 100
SUP_BATCH = 8
SUP_STEPS = 12
SUP_EVERY = 4
SUP_FAIL = 9
CROSS_STEPS = 3
CROSS_B = 4
CROSS_S = 16
# Sharded LM training (phase 9), on a group of one on NCCL and a
# make_local_mesh(1) mesh, every arm through the placed path: (a)
# TRAIN_ARCH as phase 8 (a) runs it (its seed, batches and schedule), placed
# by launch.train.placed_state, SHARDED_STEPS steps (all but the first
# timed by CUDA events); (b) EP_ARCH at reduced() in float32 with nothing
# dropped (capacity_factor EP_CF), moe_impl="ep" against "dense" on
# EP_BATCH x EP_SEQ tokens: forward logits and one step; (c)
# launch.train on TRAIN_ARCH's reduced(), SHARDED_SUP_STEPS steps of 4 x
# 16 with a checkpoint every SHARDED_SUP_EVERY: its main (unplaced on one
# rank), then its loop on the mesh of one uninterrupted and with a failure
# injected at SHARDED_SUP_FAIL.
SHARDED_STEPS = 4
EP_ARCH = "kimi-k2-1t-a32b"
EP_CF = 100.0
EP_BATCH = 8
EP_SEQ = 16
SHARDED_SUP_STEPS = 6
SHARDED_SUP_EVERY = 2
SHARDED_SUP_FAIL = 4
# Phase 3 holds the counter variants of kernels A and D against the plain
# version run on each round's lanes followed by COUNT_COPIES copies of them
# under ub = BIG (which never abandon): 65 x 2,048 = 133,120 rows, more
# than 2^17, which PyTorch's CUDA cumsum adds in the kernels' Sklansky
# order, so the round's lanes get the kernels' bits and the same abandon
# decisions (a round's 2,048 lanes alone round P otherwise, and the
# counters of some of them then move by a few cells or a row).
COUNT_COPIES = 64
# Phase 3 holds kernels C and E against their plain versions over the first
# CE_SHORT best-first lanes of each query (use_cb on and off, three seeds)
# and over each query's whole order (the main path's shapes); the plain
# sweeps on the card evaluate CE_CHUNK lanes a query at a time.
CE_SHORT = 512
CE_CHUNK = 32_768
# Phase 3 also holds kernel B against its plain version at ragged shapes:
# a reference of B_SWEEP_N samples (its n_win is no multiple of the kernel's
# 256-window block at any length below), with a NaN burst (quarantined
# windows) and a flat stretch longer than any window (sigma 0, clamped);
# the first Q of B_SWEEP_Q queries (tails that no query tile divides, and
# more than one tile); the lengths B_SWEEP_L, the largest whose blocks hold
# the span of the reference in shared memory and the largest the kernel
# takes (its blocks read the span from global memory); and, at l = 1024, LB_Kim and LB_Keogh each turned off, and the
# reference scaled by B_SWEEP_SCALE, beyond the range where the kernel
# divides by a reciprocal computed once a window (it then divides with `/`).
B_SWEEP_N = 100_003
B_SWEEP_Q = (1, 3, 8, 13)
B_SWEEP_L = (48, 1000, 1024)
B_SWEEP_SCALE = 1e15

# Bands past one warp (the wide row, csrc/dtw_band_wide.cuh) and long
# rows: phase 3 holds kernels A, C, D and E against their plain versions on
# the first K best-first lanes (the cascade of each band's search) of Q
# queries over an ECG reference of WIDE_REF_N samples, at each (l, window
# ratio, Q, K, Kc) of WIDE_BANDS: bw = 2048 (the paper's upper ratio), 1664
# (its default ratio at l = 8192) and 16,384 (8 segments of the wide row,
# 64 KB of shared memory a block), Q * K lanes (a block each) to fill the
# card's 132 SMs for a round, the first Kc of each query's held to the
# plain versions (a plain DP row at l = 16,384 is ~16k rows of PyTorch
# launches whatever the lanes); kernel D also on full rows, queries of
# WIDE_FULL_N samples against the first band's windows (n != m, bw = m).
# LONG_ROW is the one-warp row at CPT = 32 (l = 4096, bw = 832) for A and
# C. Phase 4 runs the search WIDE_SEARCH (N = WIDE_REF_N, cut from the
# main path's 1e6 for time) under both drivers and holds each winner, in
# float64, against the first WIDE_CANDIDATES windows of its query's
# best-first order; phase 5 runs it on the card and the CPU at
# WIDE_CROSS_N samples and WIDE_CROSS_Q queries; phase 6 times the
# kernels at the phase-3 shapes.
WIDE_REF_N = 200_000
WIDE_BANDS = ((2048, 0.5, 8, 64, 64), (8192, 0.1, 8, 64, 64),
              (16_384, 0.5, 2, 128, 8))
WIDE_FULL_N = 2000
LONG_ROW = (4096, 0.1, 8, 64)
WIDE_SEARCH = dict(ref_len=WIDE_REF_N, query_len=2048, window_ratio=0.5,
                   n_queries=8)
WIDE_CANDIDATES = 512
WIDE_CROSS_N = 2200
WIDE_CROSS_Q = 2
# The UCR Suite's short query (bench/configs/ucr-ecg-l128-r0.1.json):
# l = 128 at ratio 0.1, w = 12, a band of 25 columns that the one-warp row
# holds at 1 column a thread, on the main path's N = 1e6 reference and
# Q = 8. Phase 3 holds kernels B and A to their plain versions there as at
# l = 1024 (TOL_B, TOL_A: a shorter row sums fewer terms, and its P stays
# smaller, so each rounds less); phase 6 times them.
SHORT_ROW = dict(query_len=128, window_ratio=0.1)

# Tolerances, each with its reason.
# Kernel B: a window's LB_Keogh sums l = 1024 terms; the kernel adds them in
# order with FMAs, the plain version by torch's tree reduction: O(l) ulp at
# worst, so 1e-4 of the bound (or of 1, for bounds below 1).
TOL_B = 1e-4
# Kernel A: the closed-form row P + cummin(d - P) cancels. P, the row's
# running cost sum across the band, reaches ~1e3-1e4 at l = 1024, w = 102,
# where a distance is ~10, so one ulp of P is ~1e-4 of the distance. The
# kernel adds P in Sklansky order over the band; the plain version's
# torch.cumsum on the card does so only when it scans more than 2^17 rows
# at once, and in chunks of 32 columns (or more) in smaller batches, so the
# two round P differently on every row of a small batch: 1e-3 relative. A
# lane whose distance lies within that of its ub may abandon on one side.
TOL_A = 1e-3
# Kernels C and E against their plain version, and the persistent search
# against the host rounds: the same per-lane DP as kernel A, so a
# distance carries the same rounding of P (1e-3 relative); the winner's
# start must be equal.
# Card against CPU: each side works out its own window stats (float64
# prefix sums, in another order on each side, rounded to float32) and runs
# its own DP row: 1e-4 relative on distances; best_start and quarantine
# counts exactly.
TOL_CROSS = 1e-4
# Oracle recheck of the winners: the per-lane-offset banded DP of
# core.ea_pruned_dtw against the round kernel, same stats; its band starts
# elsewhere, so P rounds differently as for TOL_A: 1e-3 relative.
TOL_ORACLE = 1e-3
# Rows past the main path's (WIDE_BANDS, LONG_ROW): the kernels add P in
# Sklansky order over the padded band (the wide row: over each segment of
# 2048 columns, then the previous segment's last P), the plain version's
# torch.cumsum on the card in chained chunks whose width depends on how
# many rows it scans (1024 columns only past 2^20 rows), so the two round P
# differently on every row, and P grows with the band: measured 4.9e-4 at
# l = 2048 (bw = 2048), 2.0e-4 at l = 8192 (bw = 1664), 5.4e-4 at
# l = 16,384 (bw = 16,384), 3.6e-4 on full rows (m = 2048) and 1.2e-4 on
# the one-warp row at l = 4096 (an H100 80GB HBM3 at 700 W), the card
# against the CPU 1.5e-4 at l = 2048; the run prints its own. TOL_WIDE is
# ~3.7x the largest; TOL_A is not widened.
TOL_WIDE = 2e-3
# The counters of the wide row against the plain version: a cell within
# rounding of its row's threshold moves next_start, and with it the cells
# of later rows; where a lane's least cell hovers within rounding of the
# threshold for a few rows, its abandon moves by as many (measured at
# l = 2048: 14 of 512 lanes, by up to 4 rows, 3 rows in all; cells 1.2e-4
# relative where the rows agree; the H100 run above). The sums of rows and
# of cells within TOL_WIDE_CELLS relative, and each lane's cells where its
# rows agree (the run prints how many lanes' rows differ, and by how much).
TOL_WIDE_CELLS = 1e-2

# LM serving (phase 7). bfloat16 keeps 8 significant bits (a step of
# 2^-8 = 0.4% of a value). The decode, the teacher-forced forward and the
# two prefill attentions multiply through other cuBLAS kernels (M = 4
# against M = 2,300) and round each layer's outputs at other places, so
# their logits (up to ~5 at full width) part by several bfloat16 steps:
# measured 0.086 (Llama-3.2-3B) and 0.055 (Mamba2-130M) decode against
# forward, 0.074 chunked against plain (an H100 80GB HBM3 at 700 W).
# TOL_LM_BF16 is about 3x the largest. A greedy token may then be the float32 model's
# near second: the shortfall of its float32 logit under the row's
# maximum is at most twice the largest bfloat16 / float32 difference
# (measured 0.083 and 0.115; shortfalls 0.020 and 0.076), and must stay
# within TOL_LM_TIE; the chunked and plain prefills' argmaxes likewise.
TOL_LM_BF16 = 0.25
TOL_LM_TIE = 0.25
# bfloat16 decode against the float32 forward: measured 0.0835
# (Llama-3.2-3B) and 0.115 (Mamba2-130M); TOL_LM_F32 is ~1.7x the
# larger. It cannot see the score product's type: the control (scores
# left in bfloat16) measured 0.0838, since with random weights attention
# is near uniform over its 512-576 keys. TOL_LM_SCORES sees it.
TOL_LM_F32 = 0.2
# The score product (attention._scores) on bfloat16 q, k against float64:
# float32 sums of exact bfloat16 products part by float32 rounding
# (measured 1.3e-7 and 2.5e-7 of the largest score); a product left in
# bfloat16 rounds each score to 8 bits (measured 2.5e-3). TOL_LM_SCORES
# lies between, and the control must miss it.
TOL_LM_SCORES = 1e-4
# Card against CPU at reduced() in float32: the same ops, with cuBLAS's
# and the CPU's orders of float32 sums (and index_add_'s unfixed order in
# the MoE): measured under 7.2e-7 on logits under 1; 1e-5, the CPU tests'
# bound against repro.
TOL_LM_CROSS = 1e-5

# LM training (phase 8). (b) bfloat16 gradients against a float32 copy's
# on one microbatch of arm (a)'s weights, per leaf by relative L2: bfloat16
# keeps 8 bits, and the query and key weights' gradients come through the
# softmax's backward, where near-uniform attention (random weights) makes
# them small differences of large terms: the worst leaf measured 0.186
# (layers.22.attn.wk) and 0.106 (layers.23.attn.wq), the median 0.031 and
# 0.0071 (two runs on an H100 80GB HBM3 at 700 W). TOL_TRAIN_GRAD is about
# twice the worse; the control (one layer of 28 given noise of its own
# spread) measured 0.94 and 1.04, and must miss it.
TOL_TRAIN_GRAD = 0.4
# The loss gap measured 4.96e-4 and 1.43e-3 (loss ~10); TOL_TRAIN_LOSS is
# twice the larger. It is a guard only: the control moved the loss by
# 1.43e-3 and 7.55e-3, so the loss cannot tell a perturbed layer from
# bfloat16's rounding; the gradient check does.
TOL_TRAIN_LOSS = 3e-3
# (d) card against CPU at reduced() in float32: losses and gradient norms
# (the bound of the CPU tests against repro), and parameters after
# CROSS_STEPS steps within TOL_TRAIN_PARAMS of each leaf's largest value,
# but for AdamW's sign effect: an element whose gradient is float noise
# (qwen2's key bias: softmax ignores a shift of a row's scores, so its
# exact gradient is 0) moves by about lr a step whatever the noise's size,
# in a direction each side's rounding draws. Such elements may be at most
# TRAIN_FLIP_SHARE of the parameters, each within the most two AdamW runs
# can part in CROSS_STEPS steps: 2 sum(lr) (1.01 + wd max|p|), since
# |m_hat / sqrt(v_hat)| <= 1.002 within 3 steps (Cauchy-Schwarz over the
# moments' weights).
TOL_TRAIN_CROSS = 1e-5
TOL_TRAIN_PARAMS = 1e-4
TRAIN_FLIP_SHARE = 1e-3
# The H100 SXM's dense bfloat16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16 = 989e12

# Phase 10: the dry-run on torch's fake backend. Arms (a), (b) (on the
# card's mesh and on a CPU mesh) and the traced half of (c) run as
# subprocesses (a fake world cannot share a process with phase 9's NCCL
# group), one thread each, beside phase 5's two cross-checks, which time
# nothing; the script waits for them before the baselines, so no timed
# phase runs beside them. Arm (d) runs as one in phase 10.
DRY_ARCH = "llama3.2-3b"               # (a): its four shapes on (16, 16)
DRY_MOE = ("kimi-k2-1t-a32b", "train_4k")  # (b), under --opt
DRY_WAIT = 700                         # s from the arms' start, their deadline
CPU_REF_THREADS = 3                    # phase 5's CPU halves, beside the arms
DRY_PLACED_STEPS = 8                   # (e): decode steps over placed state
PERF_MD_TRAIN_BOUND_MS = 95.42         # PERF.md section 5: phase 8 (a)'s bound

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 and FP32 outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# Flops per evaluated DTW cell: cost (sub, mul), d (min, add), prefix sum,
# d - P, prefix min, P + min, compare.
FLOPS_PER_CELL = 9
# Flops per (window, offset) pair of the LB cascade: sub, div, 2 compares,
# 2 subs, 2 multiply-adds counted as one each.
FLOPS_PER_LB_TERM = 8

def say(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[1 card] torch.cuda.get_device_name: {name}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(smi)
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def registers(name: str, kernel: str, key,
              args: str = r"ILi(\d+)ELb([01])E") -> dict[str, int] | None:
    """Registers a thread of each instantiation of ``kernel`` in library
    ``name``, from ``ptxas -v``'s log, keyed by ``key`` of its template
    arguments as mangled (``args``: by default an int and a bool,
    ``kernel<A, B>``); ``None`` when this process did not build it."""
    from repro_torch.kernels import _build

    if name not in _build.build_log:
        return None
    regs, inst = {}, None
    for ln in _build.build_log[name][1].splitlines():
        m = re.search(rf"Compiling entry function '.*{kernel}{args}", ln)
        if m:
            inst = key(*m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and inst is not None:
            regs[inst] = int(m.group(1))
            inst = None
    return dict(sorted(regs.items()))


def lb_registers() -> dict[str, int] | None:
    """Kernel B's registers a thread for each query tile (and the one-query
    tile that reads its span from global memory)."""
    return registers("lb_keogh", "lb_cascade_kernel",
                     lambda qt, span: qt + ("" if span == "1" else
                                            ", span global"))


def round_registers(name: str, kernel: str) -> dict[str, int] | None:
    """A round kernel's registers a thread for each instantiation, as
    ``"CPT=<c>"`` (counter-free) or ``"CPT=<c> info"`` (counters)."""
    return registers(name, kernel,
                     lambda cpt, info: f"CPT={cpt}" +
                     (" info" if info == "1" else ""))


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    say(f"[2 build] {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(secs) or 'nothing (cached)'}")
    for name, (s, log) in sorted(_build.build_log.items()):
        keep = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
        say(f"  {name}: {s:.2f} s; ptxas: {' | '.join(keep)}")
    for label, name, kernel in (("A", "dtw_ea_fused", "dtw_ea_fused_kernel"),
                                ("D", "dtw_ea_slab", "dtw_ea_slab_kernel")):
        say(f"  kernel {label} registers a thread (ptxas), counter-free and "
            f"with counters: {round_registers(name, kernel)}")
    # the wide row's kernels have two bools: counters (A, D) or fused
    # (C/E), and the window staged in shared memory
    wide_regs = {}
    for name, kernel, names in (
            ("dtw_ea_fused", "dtw_ea_fused_wide_kernel", ("A", "A info")),
            ("dtw_ea_slab", "dtw_ea_slab_wide_kernel", ("D", "D info")),
            ("dtw_ea_persistent", "persistent_sweep_wide", ("E", "C"))):
        regs = registers(
            name, kernel,
            lambda b, st, n=names: n[b == "1"] + (" staged" if st == "1"
                                                  else ""),
            args=r"ILb([01])ELb([01])E")
        wide_regs.update(regs or {})
        say(f"  wide row registers a thread (ptxas): {regs}")
    wide_layouts(wide_regs)


# The wide kernels as ops.wide_plan sizes them: (letter, library, variant).
WIDE_KERNELS = (("A", "dtw_ea_fused", 0), ("A info", "dtw_ea_fused", 1),
                ("D", "dtw_ea_slab", 0), ("D info", "dtw_ea_slab", 1),
                ("C", "dtw_ea_persistent", 1), ("E", "dtw_ea_persistent", 0))


def wide_layouts(regs: dict) -> None:
    """For each band of ``WIDE_BANDS``, each wide kernel as its launches
    run it: the window staged or not (``BandLayout.window_staged`` on the
    blocks its registers allow), its registers (ptxas, ``regs``), shared
    memory a block, and blocks resident an SM from the occupancy query,
    which must be the model's (the least of the registers' blocks and
    ``BandLayout.blocks_by_smem``) that the CPU tests pin the rule with."""
    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.kernels import ops

    for length, ratio, nq, _, _ in WIDE_BANDS:
        plan = SearchConfig(ref_len=WIDE_REF_N, query_len=length,
                            window_ratio=ratio, n_queries=nq).make_plan()
        m = plan.length
        bw = ops.resolve_band(plan.window, m, m, plan.band_width)
        layout = ops.band_layout(bw, m, True)
        rows = []
        for name, lib, variant in WIDE_KERNELS:
            wp = ops.wide_plan(layout, lib, variant, bw, m, True)
            model = min(wp.reg_blocks, layout.blocks_by_smem(wp.smem))
            reg = regs.get(name + (" staged" if wp.staged else ""))
            rows.append(f"{name}: {reg} registers, staged {wp.staged}, "
                        f"{wp.smem} B a block, {wp.per_sm} blocks an SM "
                        f"(registers {wp.reg_blocks}, model {model})")
            check(wp.per_sm == model,
                  f"l={m} bw={bw} {name}: {wp.per_sm} blocks an SM, the "
                  f"model {model}")
        say(f"  wide row at l={m} bw={bw}: " + "; ".join(rows))


def main_path_inputs(torch, cfg, dev):
    from repro_torch.data.synthetic import make_dataset, make_queries

    ref = torch.as_tensor(make_dataset(DATASET, cfg.ref_len, seed=0),
                          dtype=torch.float32, device=dev)
    queries = torch.as_tensor(
        make_queries(DATASET, cfg.n_queries, cfg.query_len, seed=1),
        dtype=torch.float32, device=dev)
    return ref, queries


def rel_err(k, p) -> float:
    return float(((k - p).abs() / p.abs().clamp_min(1.0)).max())


def phase_kernel_b(torch, prep, pq, plan, tag: str = "[3 kernel B]") -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.lb_keogh import lb_all_windows_plain

    qends = torch.stack([pq.qn[:, 0], pq.qn[:, -1]], 1).contiguous()
    args = (prep.ref, prep.mu, prep.sigma, pq.u.contiguous(),
            pq.low.contiguous(), qends, plan.length)
    k = ops.lb_keogh_all_windows(*args, valid=prep.valid)
    p = lb_all_windows_plain(*args, valid=prep.valid, chunk=plan.chunk)
    torch.cuda.synchronize()
    fin = torch.isfinite(p)
    check(bool((torch.isfinite(k) == fin).all()), f"{tag} +inf mask")
    kf, pf = k[fin], p[fin]
    abs_err = float((kf - pf).abs().max())
    rel = rel_err(kf, pf)
    say(f"{tag} {tuple(k.shape)} bounds: max abs err {abs_err:.3e}, "
        f"max rel err {rel:.3e} (tol {TOL_B})")
    check(rel <= TOL_B, f"{tag} rel err {rel} > {TOL_B}")
    return {"args": args, "valid": prep.valid, "max_abs_err": abs_err}


def phase_kernel_b_sweep(torch) -> None:
    """Kernel B against its plain version on the card at ragged shapes
    (``B_SWEEP_*``): the ``+inf`` mask exact and ``TOL_B`` on the rest, for
    the first Q queries at every Q of ``B_SWEEP_Q``; each Q's bounds must
    also be the same bits as the same queries' bounds at the largest Q,
    which the kernel computes in other query tiles."""
    import numpy as np

    from repro_torch.core.common import EPS
    from repro_torch.core.lower_bounds import envelope
    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.kernels.lb_keogh import lb_all_windows_plain
    from repro_torch.search.znorm import (
        sanitize_series,
        window_finite_mask,
        window_stats,
        znorm,
    )

    raw = make_dataset(DATASET, B_SWEEP_N, seed=2).astype(np.float32)
    burst, flat = (5_000, 5_040), (20_000, 20_000 + ops.LB_MAX_LENGTH + 3_000)
    raw[burst[0]:burst[1]] = np.nan
    raw[flat[0]:flat[1]] = raw[flat[0]]
    raw = torch.as_tensor(raw, device=DEVICE)
    nq_max = max(B_SWEEP_Q)
    for length in (*B_SWEEP_L, ops.LB_SPAN_MAX_LENGTH, ops.LB_MAX_LENGTH):
        valid = window_finite_mask(raw, length)
        qn = znorm(torch.as_tensor(
            make_queries(DATASET, nq_max, length, seed=3),
            dtype=torch.float32, device=DEVICE))
        u, low = (t.contiguous() for t in envelope(qn, max(1, length // 10)))
        qends = torch.stack([qn[:, 0], qn[:, -1]], 1).contiguous()
        cases = [(True, True, 1.0)]
        if length == 1024:
            cases += [(False, True, 1.0), (True, False, 1.0),
                      (True, True, B_SWEEP_SCALE)]
        for use_kim, use_keogh, scale in cases:
            ref = sanitize_series(raw) * scale
            mu, sigma = window_stats(ref, length)
            # The windows inside the flat stretch are constant: their exact
            # sigma is 0 (differenced prefix sums leave a residue), clamped.
            sigma[flat[0]:flat[1] - length + 1] = 0.0
            n_win = mu.shape[0]
            kw = dict(valid=valid, use_kim=use_kim, use_keogh=use_keogh)
            p = lb_all_windows_plain(ref, mu, sigma, u, low, qends, length,
                                     **kw)
            outs = {nq: ops.lb_keogh_all_windows(
                ref, mu, sigma, u[:nq], low[:nq], qends[:nq], length, **kw)
                for nq in B_SWEEP_Q}
            torch.cuda.synchronize()
            rel, same = 0.0, True
            label = (f"l={length} use_kim={use_kim} use_keogh={use_keogh} "
                     f"reference x {scale:g}")
            for nq, k in outs.items():
                fin = torch.isfinite(p[:nq])
                check(bool((torch.isfinite(k) == fin).all()),
                      f"kernel B +inf mask ({label}, Q={nq})")
                rel = max(rel, rel_err(k[fin], p[:nq][fin]))
                same &= torch.equal(k, outs[nq_max][:nq])
            say(f"[3 kernel B sweep] {label}: n_win {n_win} ({n_win % 256} in "
                f"the last block), {int((~valid).sum())} quarantined, "
                f"{int((sigma < EPS).sum())} flat; Q {list(B_SWEEP_Q)}, tiles "
                f"{[ops.lb_query_tiles(nq, length) for nq in B_SWEEP_Q]}: "
                f"max rel err {rel:.3e} (tol {TOL_B}); each Q the same bits "
                f"as Q={nq_max}: {same}")
            check(rel <= TOL_B, f"kernel B rel err {rel} > {TOL_B} ({label})")
            check(same, f"kernel B's bits depend on the query tile ({label})")


def round_inputs(torch, plan, state, order, lb_sorted, r):
    """The starts and per-lane ub of host round ``r`` (as
    ``pipeline.run_host_rounds`` builds them, every query active)."""
    from repro_torch.core.common import DEAD_LANE_UB

    cols = torch.arange(plan.batch, device=order.device) + r * plan.batch
    starts = order[:, cols]
    lbs = lb_sorted[:, cols]
    live = lbs < state.ub[:, None]
    ub = torch.where(live, state.ub[:, None].expand(live.shape), DEAD_LANE_UB)
    return starts, ub, lbs


def compare_lanes(torch, k, p, ub, label: str, tol: float = TOL_A):
    """Hold a round kernel's ``(Q, K)`` distances ``k`` against the plain
    version's ``p``: equal abandon masks except for lanes within ``tol``
    of their ``ub``, and ``tol`` relative where both finish. Returns the
    largest absolute difference and the mask of those near-ub lanes."""
    fk, fp = torch.isfinite(k), torch.isfinite(p)
    near_ub = torch.zeros_like(fk)
    for d, f in ((k, fk), (p, fp)):
        near_ub |= f & ((d - ub).abs() <= tol * ub.abs().clamp_min(1.0))
    mismatched = (fk != fp) & ~near_ub
    both = fk & fp
    abs_err = float((k[both] - p[both]).abs().max()) if both.any() else 0.0
    rel = rel_err(k[both], p[both]) if both.any() else 0.0
    say(f"  {label}: {int(fk.sum())}/{fk.numel()} lanes finish "
        f"(plain {int(fp.sum())}), masks differ on "
        f"{int((fk != fp).sum())} lanes ({int(near_ub.sum())} near ub), "
        f"max abs err {abs_err:.3e}, max rel err {rel:.3e} (tol {tol})")
    check(int(mismatched.sum()) == 0, f"{label}: abandon masks differ away "
          "from ub")
    check(rel <= tol, f"{label}: rel err {rel} > {tol}")
    return abs_err, near_ub


def wide(t, pad):
    """``t`` ``(Q, K, ...)`` followed on its lane axis by ``COUNT_COPIES``
    copies of ``pad``: the lane set that makes the plain version scan more
    than 2^17 rows at once."""
    import torch

    return torch.cat([t] + [pad] * COUNT_COPIES, dim=1).contiguous()


def check_counts(torch, got, want, near_ub, label: str) -> None:
    """Hold a counter variant's per-lane ``(rows, cells)`` ``got`` against
    the plain version's ``want``: equal on every lane but those of
    ``near_ub`` (compare_lanes' near-ub exemption); prints how many lanes
    that exempts and how many of them differ."""
    same = (got[0] == want[0]) & (got[1] == want[1])
    total = lambda t: int(t.sum(dtype=torch.int64))
    say(f"  {label}: {total(got[0])} rows, {total(got[1])} cells (plain "
        f"{total(want[0])}, {total(want[1])}); {int(near_ub.sum())} lanes "
        f"near ub exempt, {int((near_ub & ~same).sum())} of them differ; "
        f"{int((~near_ub & ~same).sum())} differ elsewhere")
    check(bool((same | near_ub).all()), f"{label}: counters differ from "
          "the plain version's")


def phase_kernel_a(torch, prep, pq, plan, order, lb_sorted,
                   tag: str = "[3 kernel A]") -> dict:
    from repro_torch.core.common import BIG, clamp_sigma
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain
    from repro_torch.search.incumbents import initial_state, fold_min

    state = initial_state(pq.qn.shape[0], device=order.device)
    bw = ops.resolve_band(plan.window, plan.length, plan.length, plan.band_width)
    rounds = []
    worst_abs = 0.0
    for r in range(KERNEL_A_ROUNDS):
        starts, ub, lbs = round_inputs(torch, plan, state, order, lb_sorted, r)
        s32 = starts.to(torch.int32).contiguous()
        mu = prep.mu[starts].contiguous()
        sg = clamp_sigma(prep.sigma)[starts].contiguous()
        ub = ub.contiguous()
        for use_cb in (True, False):
            env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
                       use_cb=use_cb)
            args = (pq.qn.contiguous(), prep.ref, s32, mu, sg, ub,
                    plan.window, plan.length)
            k = ops.dtw_ea_multi_fused(*args, **env)
            p, rows, cells = dtw_ea_fused_plain(*args, bw, count=True, **env)
            torch.cuda.synchronize()
            label = f"{tag} round {r} use_cb={use_cb}"
            err, near_ub = compare_lanes(torch, k, p, ub, label)
            worst_abs = max(worst_abs, err)
            say(f"    plain counts {int(rows.sum())} rows, "
                f"{int(cells.sum())} cells")
            ki = ops.dtw_ea_multi_fused(*args, with_info=True, **env)
            torch.cuda.synchronize()
            same = torch.equal(ki[0], k)
            say(f"  {label} with counters: the counter-free distances bit "
                f"for bit: {same}")
            check(same, f"{label}: the counter variant's distances differ")
            # The counters' reference: the plain version on the round's
            # lanes and COUNT_COPIES copies of them under ub = BIG.
            big = torch.full_like(ub, BIG)
            counts = [t[:, :ub.shape[1]] for t in dtw_ea_fused_plain(
                args[0], args[1], wide(s32, s32), wide(mu, mu), wide(sg, sg),
                wide(ub, big), *args[6:], bw, count=True, **env)[1:]]
            check_counts(torch, ki[1:], counts, near_ub, f"{label} counters")
            if use_cb:
                rounds.append({"args": args, "env": env, "cells": int(cells.sum()),
                               "rows": int(rows.sum()), "lanes": k.numel(),
                               "bw": bw, "out": k, "counts_cb": counts})
                d_fold = torch.where(torch.isfinite(lbs), k, float("inf"))
            else:
                rounds[-1]["out_nocb"] = k
                rounds[-1]["info_nocb"] = ki[1:]
        state, _ = fold_min(state, starts, d_fold)
    return {"rounds": rounds, "max_abs_err": worst_abs}


def phase_kernel_d(torch, prep, pq, plan, ka) -> dict:
    """Kernel D on the slab of kernel A's three round lane sets: equal to
    A bit for bit with ``use_cb`` off; against its plain version and
    within ``TOL_A`` of A with the host-side cb slab."""
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_plain
    from repro_torch.search.znorm import gather_norm_windows

    rounds = []
    worst_abs = 0.0
    for i, r in enumerate(ka["rounds"]):
        qn, _, s32, _, _, ub, window, length = r["args"]
        slab = gather_norm_windows(prep.ref, s32, length, prep.mu,
                                   prep.sigma).contiguous()
        cbs = cascade_keogh_cumulative(slab, pq.u[:, None, :],
                                       pq.low[:, None, :]).contiguous()
        d_off = ops.dtw_ea_multi(qn, slab, ub, window)
        d_on = ops.dtw_ea_multi(qn, slab, ub, window, cb=cbs)
        p, rows, cells = dtw_ea_plain(qn, slab, ub, window, r["bw"], cb=cbs,
                                      count=True)
        torch.cuda.synchronize()
        same = torch.equal(d_off, r["out_nocb"])
        say(f"[3 kernel D] round {i}: use_cb=False equals kernel A bit for "
            f"bit: {same}")
        check(same, f"kernel D differs from kernel A (round {i}, no cb)")
        err, near_ub = compare_lanes(torch, d_on, p, ub,
                                     f"[3 kernel D] round {i} host cb slab")
        worst_abs = max(worst_abs, err)
        compare_lanes(torch, d_on, r["out"], ub,
                      f"[3 kernel D] round {i} host cb slab against kernel A")
        # The counter variant: D's bits, A's counters without cb, and with
        # the host cb slab the counters of kernel A's plain reference (the
        # same windows and cb slab).
        info_off = ops.dtw_ea_multi(qn, slab, ub, window, with_info=True)
        info_on = ops.dtw_ea_multi(qn, slab, ub, window, cb=cbs,
                                   with_info=True)
        torch.cuda.synchronize()
        same = (torch.equal(info_off[0], d_off)
                and torch.equal(info_on[0], d_on))
        same_a = all(torch.equal(x, y)
                     for x, y in zip(info_off[1:], r["info_nocb"]))
        say(f"  [3 kernel D] round {i} with counters: the counter-free "
            f"distances bit for bit: {same}; use_cb=False counters equal to "
            f"kernel A's: {same_a}")
        check(same, f"kernel D's counter variant changes distances (round {i})")
        check(same_a, f"kernels A and D count differently (round {i}, no cb)")
        check_counts(torch, info_on[1:], r["counts_cb"], near_ub,
                     f"[3 kernel D] round {i} host cb slab counters")
        rounds.append({"args": (qn, slab, ub, window), "cb": cbs,
                       "cells": int(cells.sum()), "lanes": d_on.numel(),
                       "bw": r["bw"]})
    return {"rounds": rounds, "max_abs_err": worst_abs}


def _ce_check(torch, c, p, label: str, tol: float = TOL_A) -> float:
    """Hold a persistent kernel's ``(best_dist, best_start, blocks)`` ``c``
    against its plain version's ``p``: the same starts, distances within
    ``tol`` relative; ``blocks`` is printed. Returns the largest absolute
    distance difference."""
    abs_err = float((c[0] - p[0]).abs().max())
    rel = rel_err(c[0], p[0])
    say(f"  {label}: best_start {c[1].tolist()} (plain {p[1].tolist()}), "
        f"best_dist max abs err {abs_err:.3e}, max rel err {rel:.3e} "
        f"(tol {tol}); blocks {c[2].tolist()} (plain {p[2].tolist()})")
    check(c[1].tolist() == p[1].tolist(),
          f"{label}: best_start differs from the plain version")
    check(rel <= tol, f"{label}: best_dist rel err {rel} > {tol}")
    return abs_err


def phase_kernel_ce(torch, prep, pq, plan, order, lb_sorted) -> dict:
    """Kernels C and E against their plain versions, in two parts.

    Short: the first ``CE_SHORT`` best-first lanes of each query, with
    ``use_cb`` on and off and a cold seed, a warm one (1% above the cold
    answer) and an unbeaten one (1% below); C and E each against its own
    plain version, and C equal to E bit for bit.

    Whole: each query's whole best-first order at the main path's
    ``use_cb``, as the persistent search runs it: C against its plain
    version at the cold and the warm seed, E (on the full ``(Q, n_win, l)``
    slab) against its own at the cold seed, C equal to E bit for bit, and C
    run again giving the same ``(best_dist, best_start)`` bits (``blocks``
    may differ). The plain sweeps run on the card, ``CE_CHUNK`` lanes a
    query at a time, and their seconds are printed. C and E are timed here
    over the whole cold sweep, and the least work of any best-first sweep
    (every lane whose bound lies below the answer, run against the answer)
    is counted for their bound."""
    from repro_torch.core.common import BIG, DEAD_LANE_UB, clamp_sigma
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import (
        dtw_ea_persistent_fused_plain,
        dtw_ea_persistent_plain,
        dtw_ea_plain,
    )
    from repro_torch.search.znorm import gather_norm_windows

    nq = pq.qn.shape[0]
    w, m, bk = plan.window, plan.length, plan.block_k
    bw = ops.resolve_band(w, m, m, plan.band_width)
    cold = torch.full((nq,), BIG, dtype=torch.float32, device=order.device)

    def descriptors(k):
        """Kernel C's lane inputs for the first ``k`` best-first lanes."""
        starts = order[:, :k]
        return (pq.qn.contiguous(), prep.ref, lb_sorted[:, :k].contiguous(),
                starts.to(torch.int32).contiguous(),
                prep.mu[starts].contiguous(),
                clamp_sigma(prep.sigma[starts]).contiguous())

    worst_abs = 0.0
    fused = descriptors(CE_SHORT)
    slab = gather_norm_windows(prep.ref, order[:, :CE_SHORT], m, prep.mu,
                               prep.sigma)
    qn, _, lb, s32 = fused[:4]
    for use_cb in (True, False):
        env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
                   use_cb=use_cb)
        c_cold = ops.dtw_ea_persistent_fused(*fused, cold, w, m, **env)
        seeds = {"cold": cold, "warm": c_cold[0] * 1.01,
                 "unbeaten": c_cold[0] * 0.99}
        for name, seed in seeds.items():
            c = ops.dtw_ea_persistent_fused(*fused, seed, w, m, **env)
            e = ops.dtw_ea_persistent(qn, slab, lb, s32, seed, w, **env)
            pc = dtw_ea_persistent_fused_plain(*fused, seed, w, m, bw, bk,
                                               **env)
            pe = dtw_ea_persistent_plain(qn, slab, lb, s32, seed, w, bw, bk,
                                         **env)
            torch.cuda.synchronize()
            label = f"{CE_SHORT} lanes use_cb={use_cb} {name} seed"
            worst_abs = max(worst_abs,
                            _ce_check(torch, c, pc, f"[3 kernel C] {label}"),
                            _ce_check(torch, e, pe, f"[3 kernel E] {label}"))
            same_ce = torch.equal(c[0], e[0]) and torch.equal(c[1], e[1])
            say(f"  C equals E bit for bit: {same_ce}")
            check(same_ce, f"kernels C and E differ ({label})")
            if name == "unbeaten":
                check(c[1].tolist() == [-1] * nq, "an unbeaten seed was beaten")
    del fused, slab

    # The whole best-first order of every query.
    k = order.shape[1]
    use_cb = plan.use_cb
    env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(), use_cb=use_cb)
    fused = descriptors(k)
    qn, _, lb, s32 = fused[:4]
    in_flight = {"C": ops.persistent_grid(m, bw, use_cb, fused=True),
                 "E": ops.persistent_grid(m, bw, use_cb, fused=False)}
    say(f"[3 kernels C, E] whole best-first order: {k} lanes a query, "
        f"use_cb={use_cb}; lanes in flight: kernel C {in_flight['C']}, "
        f"kernel E {in_flight['E']} (one warp a lane)")

    def plain_c(seed):
        t0 = time.perf_counter()
        out = dtw_ea_persistent_fused_plain(*fused, seed, w, m, bw, bk,
                                            chunk=CE_CHUNK, **env)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    c_call = lambda seed: ops.dtw_ea_persistent_fused(*fused, seed, w, m,
                                                      block_k=bk, **env)
    c = {"cold": c_call(cold)}
    ran = {"C": ops.dtw_ea_persistent_fused.lanes_run.tolist()}
    c["warm"] = c_call(c["cold"][0] * 1.01)
    plain_s = {}
    for name in ("cold", "warm"):
        seed = cold if name == "cold" else c["cold"][0] * 1.01
        p, plain_s[name] = plain_c(seed)
        say(f"  plain sweep of C, {name} seed: {plain_s[name]:.2f} s on the "
            f"card, {CE_CHUNK} lanes a query at a time")
        worst_abs = max(worst_abs, _ce_check(
            torch, c[name], p, f"[3 kernel C] whole order, {name} seed"))
    runs = [c_call(cold) for _ in range(2)]
    torch.cuda.synchronize()
    first = c["cold"]
    same = all(torch.equal(r[0], first[0]) and torch.equal(r[1], first[1])
               for r in runs)
    say(f"[3 repeat] kernel C over the whole order run 3 times: (best_dist, "
        f"best_start) the same bits: {same}; blocks "
        f"{[r[2].tolist() for r in (first, *runs)]}")
    check(same, "kernel C is not repeatable")
    c_ms = cuda_ms(lambda: c_call(cold), 2)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slab = gather_norm_windows(prep.ref, order, m, prep.mu, prep.sigma)
    torch.cuda.synchronize()
    say(f"  the whole slab: {tuple(slab.shape)}, "
        f"{slab.numel() * 4 / 1e9:.2f} GB")
    e_call = lambda seed: ops.dtw_ea_persistent(qn, slab, lb, s32, seed, w,
                                                block_k=bk, **env)
    e = {}
    for name in ("cold", "warm"):
        seed = cold if name == "cold" else c["cold"][0] * 1.01
        e[name] = e_call(seed)
        torch.cuda.synchronize()
        if name == "cold":
            ran["E"] = ops.dtw_ea_persistent.lanes_run.tolist()
        same_ce = (torch.equal(c[name][0], e[name][0])
                   and torch.equal(c[name][1], e[name][1]))
        say(f"[3 kernel E] whole order, {name} seed: C equals E bit for bit: "
            f"{same_ce}; blocks E {e[name][2].tolist()}")
        check(same_ce, f"kernels C and E differ over the whole order ({name})")
    t0 = time.perf_counter()
    pe = dtw_ea_persistent_plain(qn, slab, lb, s32, cold, w, bw, bk,
                                 chunk=CE_CHUNK, **env)
    torch.cuda.synchronize()
    plain_s["E"] = time.perf_counter() - t0
    say(f"  plain sweep of E, cold seed: {plain_s['E']:.2f} s on the card")
    worst_abs = max(worst_abs, _ce_check(
        torch, e["cold"], pe, "[3 kernel E] whole order, cold seed"))
    e_ms = cuda_ms(lambda: e_call(cold), 2)

    # The least work of any best-first sweep: every lane whose bound lies
    # below the answer, run against the answer itself (a best-first prefix
    # of each query's order).
    best = first[0][:, None]
    live = lb < best
    n_live = int(live.sum(dim=1).max())
    cells = 0
    for lo in range(0, n_live, CE_CHUNK):
        hi = min(n_live, lo + CE_CHUNK)
        sl = slab[:, lo:hi]
        ub = torch.where(live[:, lo:hi], best, DEAD_LANE_UB).contiguous()
        cb = (cascade_keogh_cumulative(sl, pq.u[:, None, :], pq.low[:, None, :])
              if use_cb else None)
        _, _, cl = dtw_ea_plain(qn, sl, ub, w, bw, cb=cb, count=True)
        cells += int(cl.sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"  least work of the cold sweep: {int(live.sum())} lanes below the "
        f"answer, {cells} cells; peak {peak:.2f} GB allocated with the slab")
    del slab
    torch.cuda.empty_cache()
    return {"c_ms": c_ms, "e_ms": e_ms, "c_plain_ms": plain_s["cold"] * 1e3,
            "in_flight": in_flight, "ran": ran,
            "e_plain_ms": plain_s["E"] * 1e3, "cells": cells,
            "live": int(live.sum()), "length": m,
            "env_floats": qn.numel() + 2 * env["u"].numel() + 4 * nq,
            "max_abs_err": worst_abs}


def phase_repeat(torch, prep, plan, kb, ka, reps: int = 3) -> None:
    """Run-to-run repeatability on the card: ``window_stats`` and both
    kernels on the same inputs must give the same bits every time. A 1-D
    ``torch.cumsum`` of the reference is shown beside them, not checked:
    it is the scan ``window_stats`` avoids on the card."""
    from repro_torch.kernels import ops
    from repro_torch.search.znorm import window_stats

    def flat(out):
        parts = out if isinstance(out, tuple) else (out,)
        return torch.cat([t.reshape(-1) for t in parts])

    def differing(fn) -> int:
        first = flat(fn())
        outs = [flat(fn()) for _ in range(reps - 1)]
        torch.cuda.synchronize()
        return sum(not torch.equal(first, o) for o in outs)

    ref = prep.ref
    n_cumsum = differing(lambda: torch.cumsum(ref, dim=0))
    n_cumsum_sq = differing(lambda: torch.cumsum(ref * ref, dim=0))
    n_stats = differing(lambda: window_stats(ref, plan.length))
    n_b = differing(lambda: ops.lb_keogh_all_windows(*kb["args"],
                                                     valid=kb["valid"]))
    r0 = ka["rounds"][0]
    n_a = differing(lambda: ops.dtw_ea_multi_fused(*r0["args"], **r0["env"]))
    stats_ms = cuda_ms(lambda: window_stats(ref, plan.length), 5)
    say(f"[3 repeat] of {reps - 1} repeats, how many differ in any bit from "
        f"the first run: 1-D torch.cumsum(ref) {n_cumsum}, "
        f"torch.cumsum(ref*ref) {n_cumsum_sq} (shown, not checked); "
        f"window_stats {n_stats}, kernel B {n_b}, kernel A round 0 {n_a}; "
        f"window_stats {stats_ms:.3f} ms")
    check(n_stats == 0, "window_stats is not repeatable on the card")
    check(n_b == 0, "kernel B is not repeatable")
    check(n_a == 0, "kernel A is not repeatable")


def wide_lanes(torch, ref, length: int, ratio: float, nq: int, k: int):
    """The first ``k`` best-first lanes of ``nq`` queries of ``length`` at
    window ``ratio`` over ``ref``, from the cascade of that search's plan:
    ``(plan, prepared queries, kernel C's lane inputs)``, the inputs being
    the queries, the sanitized reference, the sorted bounds, int32 starts,
    the lanes' means and clamped sigmas."""
    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.core.common import clamp_sigma
    from repro_torch.data.synthetic import make_queries
    from repro_torch.search.pipeline import (
        cascade,
        prepare_queries,
        prepare_ref,
    )

    plan = SearchConfig(ref_len=ref.shape[0], query_len=length,
                        window_ratio=ratio, n_queries=nq).make_plan()
    prep = prepare_ref(plan, ref)
    queries = torch.as_tensor(make_queries(DATASET, nq, length, seed=1),
                              dtype=torch.float32, device=DEVICE)
    pq = prepare_queries(plan, queries)
    order, lb = cascade(plan, prep, pq.qn)
    starts = order[:, :k]
    lanes = (pq.qn.contiguous(), prep.ref, lb[:, :k].contiguous(),
             starts.to(torch.int32).contiguous(), prep.mu[starts].contiguous(),
             clamp_sigma(prep.sigma[starts]).contiguous())
    return plan, pq, lanes


def median_ub(torch, free):
    """A per-lane bound from a round's free distances: each query's median
    (abandoned lanes as ``BIG``), so about half its lanes abandon."""
    from repro_torch.core.common import BIG

    d = torch.where(torch.isfinite(free), free, BIG)
    return d.median(dim=1, keepdim=True).values.expand_as(d).contiguous()


def check_counts_wide(torch, got, want, near_ub, label: str) -> float:
    """The wide row's counters ``got`` against the plain version's
    ``want``: their sums within ``TOL_WIDE_CELLS`` relative, and each
    lane's cells within it where the lane's rows agree (a row's least cell
    within rounding of its threshold can move the abandon by a few rows;
    how many lanes and rows is printed). Returns the largest relative
    difference."""
    rows_off = (got[0] - want[0]).abs()
    rows_same = rows_off == 0
    cells = (got[1] - want[1]).abs().double() / want[1].double().clamp_min(1)
    worst = float(cells[rows_same].max()) if rows_same.any() else 0.0
    total = lambda t: int(t.sum(dtype=torch.int64))
    sums = max(abs(total(g) / max(total(w), 1) - 1)
               for g, w in zip(got, want))
    say(f"  {label}: {total(got[0])} rows, {total(got[1])} cells (plain "
        f"{total(want[0])}, {total(want[1])}: {sums:.3e} apart); rows "
        f"differ on {int((~rows_same).sum())} lanes "
        f"({int((~rows_same & near_ub).sum())} near ub), by at most "
        f"{int(rows_off.max())}; cells equal on "
        f"{int((got[1] == want[1]).sum())} of {got[1].numel()}, max rel diff "
        f"where the rows agree {worst:.3e} (tol {TOL_WIDE_CELLS})")
    check(sums <= TOL_WIDE_CELLS, f"{label}: counters' sums differ by {sums}")
    check(worst <= TOL_WIDE_CELLS, f"{label}: cells differ by {worst}")
    return max(worst, sums)


def phase_kernels_wide(torch) -> dict:
    """Kernels A, C, D and E on the wide row against their plain versions
    on the card, at each band of ``WIDE_BANDS`` with ``use_cb`` on and off.

    A and D: one round over the band's first K best-first lanes, each
    query's ``ub`` the median of the lanes' free distances (kernel A's
    under ``ub = BIG``): abandon masks equal but within ``TOL_WIDE`` of
    ub, distances within ``TOL_WIDE``; their counter variants the
    counter-free bits, their counters the plain version's
    (``check_counts_wide``); D on the slab of the same windows (with the
    host cb slab), A's bits without cb. A's plain version gathers and
    normalizes the windows and builds the cb slab exactly as D's slab and
    cb slab are built, so the one plain run is both kernels' plain
    version; likewise the plain sweep is both C's and E's. C and E: the
    cold sweep of the same lanes, ``best_start`` the plain sweep's,
    ``best_dist`` within ``TOL_WIDE``, C equal to E bit for bit. Where a
    band holds only its first Kc lanes a query to the plain versions, the
    rounds' lanes are compared there, and C and E sweep those lanes too
    (held to the plain sweep) beside all K (C equal to E, its answer no
    worse than the shorter sweep's). D also on
    full rows: queries of ``WIDE_FULL_N`` samples against the first band's
    windows (n != m: bw = m), with counters."""
    from repro_torch.core.common import BIG, DEAD_LANE_UB
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import (
        dtw_ea_fused_plain,
        dtw_ea_persistent_fused_plain,
        dtw_ea_plain,
        gather_norm_lanes,
    )
    from repro_torch.search.znorm import znorm

    ref = torch.as_tensor(make_dataset(DATASET, WIDE_REF_N, seed=0),
                          dtype=torch.float32, device=DEVICE)
    worst = {"A": 0.0, "C": 0.0, "D": 0.0, "E": 0.0, "rel": 0.0, "cells": 0.0}
    bands = []
    for length, ratio, nq, k, kc in WIDE_BANDS:
        plan, pq, lanes = wide_lanes(torch, ref, length, ratio, nq, k)
        qn, sref, lb, s32, mu, sg = lanes
        w, m, bk = plan.window, plan.length, plan.block_k
        bw = ops.resolve_band(w, m, m, plan.band_width)
        layout = ops.band_layout(bw, m, True)
        check(layout.tier == "shared", f"bw {bw} is not on the wide row")
        tag = (f"l={m} w={w} bw={bw} ({layout.segments} segment(s) of "
               f"{ops.WIDE_SEGMENT}) Q={nq} K={k}")
        if kc < k:
            tag += f", held to the plain versions on the first {kc}"

        def head(t):  # the lanes held to the plain versions
            return t[:, :kc].contiguous()

        slab = gather_norm_lanes(sref, s32, mu, sg, m)[0].contiguous()
        sub = (qn, sref, head(lb), head(s32), head(mu), head(sg))
        cold = torch.full((nq,), BIG, dtype=torch.float32, device=DEVICE)
        band = {"length": m, "window": w, "bw": bw, "lanes": nq * k,
                "plain_lanes": nq * kc, "segments": layout.segments,
                "tag": tag}
        for use_cb in (True, False):
            env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
                       use_cb=use_cb)
            cbs = (cascade_keogh_cumulative(slab, pq.u[:, None, :],
                                            pq.low[:, None, :]).contiguous()
                   if use_cb else None)
            fargs = (qn, sref, s32, mu, sg)
            big = torch.full((nq, k), BIG, dtype=torch.float32, device=DEVICE)
            ub = median_ub(torch, ops.dtw_ea_multi_fused(*fargs, big, w, m,
                                                         **env))
            ka = ops.dtw_ea_multi_fused(*fargs, ub, w, m, **env)
            ki = ops.dtw_ea_multi_fused(*fargs, ub, w, m, with_info=True,
                                        **env)
            kd = ops.dtw_ea_multi(qn, slab, ub, w, cb=cbs)
            kdi = ops.dtw_ea_multi(qn, slab, ub, w, cb=cbs, with_info=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, prow, pcell = dtw_ea_fused_plain(
                qn, sref, sub[3], sub[4], sub[5], head(ub), w, m, bw,
                count=True, **env)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            label = f"[3 wide] {tag} use_cb={use_cb}"
            err, near = compare_lanes(torch, head(ka), p, head(ub),
                                      f"{label} kernel A", tol=TOL_WIDE)
            worst["A"] = max(worst["A"], err)
            fin = torch.isfinite(head(ka)) & torch.isfinite(p)
            worst["rel"] = max(worst["rel"], rel_err(head(ka)[fin], p[fin]))
            err, _ = compare_lanes(torch, head(kd), p, head(ub),
                                   f"{label} kernel D", tol=TOL_WIDE)
            worst["D"] = max(worst["D"], err)
            same = torch.equal(ki[0], ka) and torch.equal(kdi[0], kd)
            say(f"  {label}: the counter variants' distances the "
                f"counter-free bits (A, D): {same}; plain round "
                f"{plain_ms:.1f} ms")
            check(same, f"{label}: a counter variant changes distances")
            worst["cells"] = max(worst["cells"], check_counts_wide(
                torch, tuple(head(t) for t in ki[1:]), (prow, pcell), near,
                f"{label} A counters"))
            if not use_cb:
                same = (torch.equal(kd, ka)
                        and all(torch.equal(x, y)
                                for x, y in zip(kdi[1:], ki[1:])))
                say(f"  {label}: kernel D equals kernel A bit for bit, "
                    f"counters too: {same}")
                check(same, f"{label}: kernels A and D differ")
            # C and E: the cold sweep of the same best-first lanes, and of
            # the first kc of them against the plain sweep.
            c = ops.dtw_ea_persistent_fused(*lanes, cold, w, m, block_k=bk,
                                            **env)
            e = ops.dtw_ea_persistent(qn, slab, lb, s32, cold, w, block_k=bk,
                                      **env)
            same = torch.equal(c[0], e[0]) and torch.equal(c[1], e[1])
            if kc < k:
                cs = ops.dtw_ea_persistent_fused(*sub, cold, w, m,
                                                 block_k=bk, **env)
                es = ops.dtw_ea_persistent(qn, head(slab), sub[2], sub[3],
                                           cold, w, block_k=bk, **env)
                better = bool((c[0] <= cs[0] * (1 + TOL_WIDE)).all())
                say(f"  {label}: the sweep of all {k} lanes a query "
                    f"best_dist {c[0].tolist()}, of the first {kc} "
                    f"{cs[0].tolist()}; no worse (within {TOL_WIDE}): "
                    f"{better}")
                check(better, f"{label}: more lanes gave a worse answer")
            else:
                cs, es = c, e
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc = dtw_ea_persistent_fused_plain(*sub, cold, w, m, bw, bk,
                                               **env)[:3]
            torch.cuda.synchronize()
            sweep_plain_ms = (time.perf_counter() - t0) * 1e3
            worst["C"] = max(worst["C"], _ce_check(
                torch, cs, pc, f"{label} kernel C", tol=TOL_WIDE))
            worst["E"] = max(worst["E"], _ce_check(
                torch, es, pc, f"{label} kernel E", tol=TOL_WIDE))
            same = (same and torch.equal(cs[0], es[0])
                    and torch.equal(cs[1], es[1]))
            say(f"  {label}: C equals E bit for bit: {same}; plain sweep "
                f"{sweep_plain_ms:.1f} ms")
            check(same, f"{label}: kernels C and E differ")
            if use_cb:
                # phase 6's inputs and the plain versions' times; the
                # round's cells and the sweep's least work (the lanes whose
                # bound lies below the answer, run against it) from kernel
                # A's counters, which hold the plain version's above
                live = lb < c[0][:, None]
                ub_best = torch.where(live, c[0][:, None].expand_as(lb),
                                      DEAD_LANE_UB).contiguous()
                sweep_cells = int(ops.dtw_ea_multi_fused(
                    *fargs, ub_best, w, m, with_info=True,
                    **env)[2].sum(dtype=torch.int64))
                band.update(
                    fargs=fargs, ub=ub, env=env, slab=slab, cbs=cbs,
                    lanes_in=lanes, cold=cold, block_k=bk,
                    round_cells=int(ki[2].sum(dtype=torch.int64)),
                    sweep_cells=sweep_cells, sweep_lanes=int(live.sum()),
                    plain_ms=plain_ms, sweep_plain_ms=sweep_plain_ms)
        bands.append(band)
    # Kernel D on full rows: n != m, bw = m, on the first band's windows.
    b0 = bands[0]
    check(b0["plain_lanes"] == b0["lanes"], "the first band's lanes")
    m, w = b0["length"], b0["window"]
    nq = b0["fargs"][0].shape[0]
    qf = znorm(torch.as_tensor(make_queries(DATASET, nq, WIDE_FULL_N, seed=5),
                               dtype=torch.float32, device=DEVICE))
    slab = b0["slab"]
    big = torch.full(slab.shape[:2], BIG, dtype=torch.float32, device=DEVICE)
    ub = median_ub(torch, ops.dtw_ea_multi(qf, slab, big, w))
    kd = ops.dtw_ea_multi(qf, slab, ub, w)
    kdi = ops.dtw_ea_multi(qf, slab, ub, w, with_info=True)
    p, prow, pcell = dtw_ea_plain(qf, slab, ub, w, m, count=True)
    torch.cuda.synchronize()
    label = f"[3 wide] kernel D full rows n={WIDE_FULL_N} m={m} (bw = m)"
    err, near = compare_lanes(torch, kd, p, ub, label, tol=TOL_WIDE)
    worst["D"] = max(worst["D"], err)
    check(torch.equal(kdi[0], kd), f"{label}: the counter variant differs")
    worst["cells"] = max(worst["cells"], check_counts_wide(
        torch, kdi[1:], (prow, pcell), near, f"{label} counters"))
    return {"bands": bands, "max_abs_err": worst}


def phase_long_row(torch) -> dict:
    """The one-warp row at its widest columns a thread (``LONG_ROW``: l =
    4096, bw = 832, CPT = 32), kernels A and C against their plain versions
    on the card, ``use_cb`` as the main path: A over one round of the first
    K best-first lanes under each query's median ``ub``, C over the cold
    sweep of the same lanes; the tolerance the run measures is printed and
    held to ``TOL_WIDE``."""
    from repro_torch.core.common import BIG
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import (
        dtw_ea_fused_plain,
        dtw_ea_persistent_fused_plain,
    )

    length, ratio, nq, k = LONG_ROW
    ref = torch.as_tensor(make_dataset(DATASET, WIDE_REF_N, seed=0),
                          dtype=torch.float32, device=DEVICE)
    plan, pq, lanes = wide_lanes(torch, ref, length, ratio, nq, k)
    qn, sref, lb, s32, mu, sg = lanes
    w, m, bk = plan.window, plan.length, plan.block_k
    bw = ops.resolve_band(w, m, m, plan.band_width)
    layout = ops.band_layout(bw, m, plan.use_cb)
    check(layout == (1, 32, 1), f"l={m}: {layout}")
    env = dict(u=pq.u.contiguous(), low=pq.low.contiguous(),
               use_cb=plan.use_cb)
    fargs = (qn, sref, s32, mu, sg)
    big = torch.full((nq, k), BIG, dtype=torch.float32, device=DEVICE)
    ub = median_ub(torch, ops.dtw_ea_multi_fused(*fargs, big, w, m, **env))
    ka = ops.dtw_ea_multi_fused(*fargs, ub, w, m, **env)
    p = dtw_ea_fused_plain(*fargs, ub, w, m, bw, **env)
    cold = torch.full((nq,), BIG, dtype=torch.float32, device=DEVICE)
    c = ops.dtw_ea_persistent_fused(*lanes, cold, w, m, block_k=bk, **env)
    pc = dtw_ea_persistent_fused_plain(*lanes, cold, w, m, bw, bk, **env)[:3]
    torch.cuda.synchronize()
    label = (f"[3 long row] l={m} w={w} bw={bw} CPT=32 Q={nq} K={k} "
             f"use_cb={plan.use_cb}")
    a_err, _ = compare_lanes(torch, ka, p, ub, f"{label} kernel A",
                             tol=TOL_WIDE)
    c_err = _ce_check(torch, c, pc, f"{label} kernel C", tol=TOL_WIDE)
    fin = torch.isfinite(ka) & torch.isfinite(p)
    return {"A": a_err, "C": c_err, "rel_A": rel_err(ka[fin], p[fin]),
            "rel_C": rel_err(c[0], pc[0])}


def phase_short_row(torch) -> dict:
    """The one-warp row at one column a thread (``SHORT_ROW``: l = 128,
    w = 12, a band of 25 columns in a warp's 32) and kernel B at l = 128,
    on the main path's reference and Q, each against its plain version as
    phase 3 holds them at l = 1024: B over every window, A (counter-free
    and with counters) over the lanes and ``ub``s of the first
    ``KERNEL_A_ROUNDS`` host rounds of the search, ``use_cb`` on and off,
    within ``TOL_B`` and ``TOL_A``."""
    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.kernels import ops
    from repro_torch.search.pipeline import cascade, prepare_queries, prepare_ref

    cfg = SearchConfig(**SHORT_ROW)
    plan = cfg.make_plan()
    m = plan.length
    bw = ops.resolve_band(plan.window, m, m, plan.band_width)
    layout = ops.band_layout(bw, m, plan.use_cb)
    check(layout == (1, 1, 1), f"l={m} bw={bw}: {layout}")
    ref, queries = main_path_inputs(torch, cfg, DEVICE)
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb_sorted = cascade(plan, prep, pq.qn)
    tag = f"l={m} w={plan.window} bw={bw} CPT=1"
    kb = phase_kernel_b(torch, prep, pq, plan,
                        tag=f"[3 short row] kernel B {tag}")
    ka = phase_kernel_a(torch, prep, pq, plan, order, lb_sorted,
                        tag=f"[3 short row] kernel A {tag}")
    return {"kb": kb, "ka": ka, "tag": tag}


def phase_times_short(torch, short: dict) -> dict:
    """Kernels B and A at ``SHORT_ROW`` (phase 3 short row's inputs), by
    CUDA events, beside their plain versions and bounds."""
    tag = f"[6 times short row] {short['tag']}"
    b_ms, b_plain, b_bound = time_kernel_b(torch, short["kb"],
                                           f"{tag} kernel B")
    a_ms, a_info, a_plain, a_bound = time_kernel_a(torch, short["ka"],
                                                   f"{tag} kernel A")
    mean = lambda xs: sum(xs) / len(xs)
    return {
        "dtw_ea_multi_fused": {
            "length": SHORT_ROW["query_len"], "ms": mean(a_ms),
            "info_ms": mean(a_info), "plain_ms": mean(a_plain),
            "bound_ms": mean(a_bound),
            "max_abs_err": short["ka"]["max_abs_err"]},
        "lb_keogh_all_windows": {
            "length": SHORT_ROW["query_len"], "ms": b_ms, "info_ms": None,
            "plain_ms": b_plain, "bound_ms": b_bound,
            "max_abs_err": short["kb"]["max_abs_err"]},
    }


def phase_wide_search(torch) -> dict:
    """``multi_query_search`` at ``WIDE_SEARCH`` (l = 2048, ratio 0.5: the
    wide row) under host rounds and the persistent sweep, each with every
    kernel's launch count set to 0 just before and read just after: the
    same ``best_start``, distances within ``TOL_WIDE`` of each other, host
    rounds launching A and B, the sweep C once, B once and A never. Each
    winner is held in float64 (windows and query normalized in float64,
    ``core.dtw``) against the first ``WIDE_CANDIDATES`` windows of its
    query's best-first order, which hold every window whose bound lies
    below the winner when there are fewer: its DTW within ``TOL_A`` of
    their minimum, and its ``best_dist`` within ``TOL_A`` of its own."""
    import numpy as np

    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.core.common import EPS
    from repro_torch.core.dtw import dtw_batch
    from repro_torch.kernels import ops
    from repro_torch.search.pipeline import (
        cascade,
        prepare_queries,
        prepare_ref,
    )

    cfg = SearchConfig(**WIDE_SEARCH)
    ref, queries = main_path_inputs(torch, cfg, DEVICE)
    out = {}
    for rounds in ("host", "persistent"):
        res, wall, launches = counted_search(torch, ref, queries, cfg,
                                             rounds=rounds)
        say(f"[4 wide] multi_query_search N={cfg.ref_len} l={cfg.query_len} "
            f"w={cfg.window} Q={cfg.n_queries} batch={cfg.batch} "
            f"rounds={rounds}: {wall:.3f} s wall; rounds "
            f"{res.rounds.tolist()} lanes {res.lanes.tolist()}; launches "
            f"{launches}")
        say(f"  best_start {res.best_start.tolist()}")
        say(f"  best_dist {res.best_dist.tolist()}")
        out[rounds] = {"res": res, "wall_s": wall, "launches": launches}
    h, p = out["host"]["res"], out["persistent"]["res"]
    lh, lp = out["host"]["launches"], out["persistent"]["launches"]
    check(lh["dtw_ea_multi_fused"] > 0 and lh["lb_keogh_all_windows"] > 0,
          "wide host rounds: kernel A or B was not launched")
    tiles = len(ops.lb_query_tiles(cfg.n_queries, cfg.query_len))
    check(lp["dtw_ea_persistent_fused"] == 1
          and lp["lb_keogh_all_windows"] == tiles
          and lp["dtw_ea_multi_fused"] == 0,
          f"wide persistent search must launch C once, B once a query tile "
          f"({tiles}) and A never")
    rel = rel_err(p.best_dist, h.best_dist)
    say(f"  persistent against host rounds: best_start equal "
        f"{p.best_start.tolist() == h.best_start.tolist()}, best_dist max "
        f"rel err {rel:.3e} (tol {TOL_WIDE})")
    check(p.best_start.tolist() == h.best_start.tolist(),
          "wide search: the two drivers found other windows")
    check(rel <= TOL_WIDE, "wide search: the two drivers' distances differ")

    plan = cfg.make_plan()
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb = cascade(plan, prep, pq.qn)
    length = cfg.query_len
    r64 = ref.to(torch.float64)
    for qi in range(cfg.n_queries):
        s = int(h.best_start[qi])
        below = int((lb[qi] < h.best_dist[qi]).sum())
        cand = torch.cat([order[qi, :WIDE_CANDIDATES],
                          torch.tensor([s], device=DEVICE)])
        wins = r64.unfold(0, length, 1)[cand]
        wins = (wins - wins.mean(1, keepdim=True)) / wins.std(
            1, keepdim=True, correction=0).clamp_min(EPS)
        q = queries[qi].to(torch.float64)
        q = (q - q.mean()) / q.std(correction=0).clamp_min(EPS)
        d = dtw_batch(q.expand(wins.shape[0], -1), wins, window=cfg.window)
        dmin, dwin = float(d.min()), float(d[-1])
        gap = dwin / dmin - 1
        off = abs(float(h.best_dist[qi]) / dwin - 1)
        say(f"  query {qi}: window {s}, float64 DTW {dwin!r}, {gap:.3e} "
            f"above the least of {wins.shape[0] - 1} best-first candidates "
            f"({below} windows bound below it); best_dist {off:.3e} off "
            f"(tol {TOL_A} each)")
        check(gap <= TOL_A and off <= TOL_A,
              f"wide search query {qi}: not a nearest window")
    return {"host": out["host"], "persistent": out["persistent"],
            "cfg": cfg}


def wide_cross_run(dev: str, rounds: str) -> dict:
    """The wide search (``WIDE_SEARCH``'s l and ratio) over a reference cut
    to ``WIDE_CROSS_N`` samples with ``WIDE_CROSS_Q`` queries, on ``dev``
    under ``rounds``."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.search import multi_query_search

    length = WIDE_SEARCH["query_len"]
    window = int(length * WIDE_SEARCH["window_ratio"])
    ref = make_dataset(DATASET, WIDE_CROSS_N, seed=0).astype(np.float32)
    qs = make_queries(DATASET, WIDE_CROSS_Q, length, seed=1)
    qs = qs.astype(np.float32)
    t0 = time.perf_counter()
    return search_result(multi_query_search(ref, qs, length, window,
                                            rounds=rounds, device=dev), t0)


def phase_wide_cross(torch, cpu: dict) -> None:
    """``wide_cross_run`` on the card under both drivers against host
    rounds on the CPU (``cpu``, from ``cpu_ref_worker``): ``best_start``
    equal, distances within ``TOL_WIDE`` (each side its own float32 window
    stats, and P's order as for ``TOL_WIDE``)."""
    length = WIDE_SEARCH["query_len"]
    window = int(length * WIDE_SEARCH["window_ratio"])
    out = {(DEVICE, r): wide_cross_run(DEVICE, r)
           for r in ("host", "persistent")}
    out["cpu", "host"] = cpu
    for (dev, rounds), r in out.items():
        say(f"[5 wide cross-check] N={WIDE_CROSS_N} l={length} w={window} "
            f"Q={WIDE_CROSS_Q} {rounds} {dev}: {r['s']:.2f} s, best_start "
            f"{r['best_start']}, best_dist {r['best_dist']}")
    h = out["cpu", "host"]
    for rounds in ("host", "persistent"):
        g = out[DEVICE, rounds]
        rel = rel_err(torch.tensor(g["best_dist"]),
                      torch.tensor(h["best_dist"]))
        same = g["best_start"] == h["best_start"]
        say(f"  {rounds} card against host cpu: best_start equal {same}, "
            f"best_dist max rel err {rel:.3e} (tol {TOL_WIDE})")
        check(same, f"wide {rounds}: best_start differs between card and "
              "CPU")
        check(rel <= TOL_WIDE, f"wide {rounds}: distances differ")


def phase_times_wide(torch, kw: dict, wide: dict) -> dict:
    """Kernels A and D (a round) and C and E (the cold sweep) at each band
    of ``WIDE_BANDS``, with ``use_cb``, by CUDA events, beside the plain
    versions' times from phase 3 (over ``plain_lanes``, the lanes phase 3
    holds to them) and the bounds: ``FLOPS_PER_CELL`` a cell the round's
    data needs (the round's cells; the sweep's least work: kernel A's
    counters) at the FP32 peak, or the lanes' bytes at the HBM peak.
    Returns, per kernel, a list of one entry a band."""
    from repro_torch.kernels import ops

    out = {"A": [], "D": [], "C": [], "E": []}
    for b in kw["bands"]:
        fargs, ub, env = b["fargs"], b["ub"], b["env"]
        qn, slab, cbs, lanes = fargs[0], b["slab"], b["cbs"], b["lanes_in"]
        w, m, nl = b["window"], b["length"], b["lanes"]
        reps = 3 if m <= 8192 else 1
        ms = {
            "A": cuda_ms(lambda: ops.dtw_ea_multi_fused(
                *fargs, ub, w, m, **env), reps),
            "D": cuda_ms(lambda: ops.dtw_ea_multi(qn, slab, ub, w, cb=cbs),
                         reps),
            "C": cuda_ms(lambda: ops.dtw_ea_persistent_fused(
                *lanes, b["cold"], w, m, block_k=b["block_k"], **env), reps),
            "E": cuda_ms(lambda: ops.dtw_ea_persistent(
                qn, slab, lanes[2], lanes[3], b["cold"], w,
                block_k=b["block_k"], **env), reps),
        }
        env_floats = qn.numel() + 2 * env["u"].numel()
        nbytes = {"A": 4 * (nl * (m + 5) + env_floats),
                  "D": 4 * (nl * (2 * m + 2) + qn.numel()),
                  "C": 4 * (b["sweep_lanes"] * (m + 4) + env_floats),
                  "E": 4 * (b["sweep_lanes"] * (m + 2) + env_floats)}
        for name in ("A", "D", "C", "E"):
            rnd = name in ("A", "D")
            cells = b["round_cells" if rnd else "sweep_cells"]
            bound = dtw_bound_ms(cells, nbytes[name])
            plain = b["plain_ms" if rnd else "sweep_plain_ms"]
            out[name].append({
                "length": m, "bw": b["bw"], "lanes": nl, "ms": ms[name],
                "plain_ms": plain, "plain_lanes": b["plain_lanes"],
                "bound_ms": bound, "bound_by": bound_by(cells, bound),
                "cells": cells})
            out[name][-1]["cells_per_s"] = cells / ms[name] * 1e3
            say(f"[6 times wide] kernel {name} {b['tag']} use_cb=True: "
                f"{ms[name]:.3f} ms (plain {plain:.1f} ms over "
                f"{b['plain_lanes']} lanes), bound "
                f"{bound:.4f} ms ({cells} cells, {bound_by(cells, bound)}), "
                f"{100 * bound / ms[name]:.2f}% of the bound, "
                f"{cells / ms[name] * 1e3:.4g} cells a second")
    for rounds in ("host", "persistent"):
        r = wide[rounds]
        say(f"[6 times wide] search {rounds}: {r['wall_s']:.3f} s wall, "
            f"launches {r['launches']}")
    return out


# The kernel letter of each DTW wrapper (kernel B has no band).
WIDE_LETTERS = {"dtw_ea_multi_fused": "A", "dtw_ea_persistent_fused": "C",
                "dtw_ea_multi": "D", "dtw_ea_persistent": "E"}

KERNELS = ("dtw_ea_multi_fused", "lb_keogh_all_windows",
           "dtw_ea_persistent_fused", "dtw_ea_multi", "dtw_ea_persistent")


def launches_now() -> dict:
    from repro_torch.kernels import ops

    return {k: getattr(ops, k).launches for k in KERNELS}


def zero_launches() -> None:
    from repro_torch.kernels import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0


def counted_search(torch, ref, queries, cfg, **kw):
    """One ``multi_query_search`` on the card with every kernel's launch
    count set to 0 just before and read just after. Returns ``(result,
    wall seconds, launches)``."""
    from repro_torch.search import multi_query_search

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = multi_query_search(
        ref, queries, cfg.query_len, cfg.window, variant=cfg.variant,
        batch=cfg.batch, warm_start=cfg.warm_start, block_k=cfg.block_k,
        device=DEVICE, **kw,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, launches_now()


def phase_end_to_end(torch, cfg, ref, queries, rounds: str,
                     host: dict | None = None) -> dict:
    """The main path end to end under one round driver: launch counts,
    winners in range and finite, the oracle recheck, the same bits when run
    again; the persistent sweep also launches C once, B once and A never,
    and must find the host rounds' ``best_start``."""
    from repro_torch.core.common import norm_window_slice
    from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw_banded
    from repro_torch.search.pipeline import prepare_queries, prepare_ref

    plan = cfg.make_plan(rounds=rounds)
    res, wall, launches = counted_search(torch, ref, queries, cfg,
                                         rounds=rounds)
    say(f"[4 end to end] multi_query_search N={cfg.ref_len} l={cfg.query_len} "
        f"w={cfg.window} Q={cfg.n_queries} batch={cfg.batch} {cfg.variant} "
        f"rounds={rounds}: {wall:.3f} s wall; launches {launches}")
    starts = res.best_start.tolist()
    say(f"  best_start {starts}")
    say(f"  best_dist {res.best_dist.tolist()}")
    say(f"  rounds {res.rounds.tolist()} lanes {res.lanes.tolist()} "
        f"quarantined {int(res.quarantined)}")
    if rounds == "host":
        check(launches["dtw_ea_multi_fused"] > 0
              and launches["lb_keogh_all_windows"] > 0,
              "a kernel was not launched")
    else:
        check(launches["dtw_ea_persistent_fused"] == 1
              and launches["lb_keogh_all_windows"] == 1
              and launches["dtw_ea_multi_fused"] == 0,
              "the persistent search must launch C once, B once and A never")
    n_win = cfg.ref_len - cfg.query_len + 1
    check(all(0 <= s < n_win for s in starts), "best_start out of range")
    check(bool(torch.isfinite(res.best_dist).all()), "non-finite best_dist")
    if host is not None:
        h = host["res"]
        rel = rel_err(res.best_dist, h.best_dist)
        bits = torch.equal(res.best_dist, h.best_dist)
        say(f"  against the host rounds: best_start equal "
            f"{starts == h.best_start.tolist()}, best_dist max rel err "
            f"{rel:.3e} (tol {TOL_A}), the same bits: {bits}")
        check(starts == h.best_start.tolist(),
              "the persistent search found another best_start")
        check(rel <= TOL_A, "persistent best_dist differs from host rounds")
    # Recompute each winner with the DP oracle on the same stats.
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    win = norm_window_slice(prep.ref, res.best_start, cfg.query_len, prep.mu,
                            prep.sigma)
    d = ea_pruned_dtw_banded(pq.qn, win, float("inf"), cfg.window)
    rel = rel_err(d, res.best_dist)
    say(f"  oracle recheck of the winners: max rel err {rel:.3e} "
        f"(tol {TOL_ORACLE})")
    check(rel <= TOL_ORACLE, "winner distance disagrees with the DP oracle")
    again, _, _ = counted_search(torch, ref, queries, cfg, rounds=rounds)
    same = (torch.equal(again.best_start, res.best_start)
            and torch.equal(again.best_dist, res.best_dist))
    say(f"  the search run again: same bits {same}; lanes "
        f"{again.lanes.tolist()}")
    check(same, "the search is not repeatable on the card")
    return {"wall_s": wall, "launches": launches, "res": res}


@contextlib.contextmanager
def kernel_events(torch, names):
    """Within the block, ``core.batch`` (kernels A and D) and
    ``search.cascade`` (kernel B) see a stand-in for ``kernels.ops`` that
    records CUDA events around every launch of the wrappers in ``names``
    (the wrappers still count their launches). Yields ``{name: [(start,
    end), ...]}``; read it after a device sync. Where ``names`` is not
    empty, the host rounds run every round eagerly within the block (the
    events go round each launch, which a replayed round does not make);
    with no names, the block changes nothing."""
    from repro_torch.core import batch
    from repro_torch.kernels import ops
    from repro_torch.search import cascade, pipeline

    events = {name: [] for name in names}

    def timed(name):
        wrapper = getattr(ops, name)

        def launch(*args, **kwargs):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = wrapper(*args, **kwargs)
            ev[1].record()
            events[name].append(ev)
            return out
        return launch

    stand_in = types.SimpleNamespace(**{
        k: getattr(ops, k) for k in dir(ops) if not k.startswith("__")})
    for name in names:
        setattr(stand_in, name, timed(name))
    batch.ops = cascade.ops = stand_in
    capture_now = pipeline._capture_now
    if names:
        pipeline._capture_now = lambda *a: False
    try:
        yield events
    finally:
        batch.ops = cascade.ops = ops
        pipeline._capture_now = capture_now


def events_ms(evs) -> float:
    return sum(s.elapsed_time(e) for s, e in evs)


def host_loop_split(torch, cfg, ref, queries) -> dict:
    """The host-rounds search once more, with CUDA events around every
    launch of kernel A (``kernel_events``): kernel A's time summed over the
    search, and what the rest of the wall costs per round. Not a counted
    run."""
    with kernel_events(torch, ["dtw_ea_multi_fused"]) as ev:
        _, wall, _ = counted_search(torch, ref, queries, cfg, rounds="host")
    events = ev["dtw_ea_multi_fused"]
    a_ms = events_ms(events)
    launches = len(events)
    loop_ms = wall * 1e3 - a_ms
    say(f"[4 host loop] host rounds with events around kernel A: "
        f"{wall:.3f} s wall, {launches} launches of A, A {a_ms:.1f} ms in all "
        f"({a_ms / launches:.4f} ms a launch); the rest {loop_ms:.1f} ms "
        f"({loop_ms / launches:.4f} ms a round, "
        f"{100 * loop_ms / (wall * 1e3):.1f}% of the wall)")
    return {"wall_s": wall, "a_ms": a_ms, "launches": launches,
            "loop_ms_per_round": loop_ms / launches}


def phase_info_search(torch, cfg, ref, queries, host: dict) -> dict:
    """The host rounds once more with ``with_info=True``: every round runs
    kernel A's counter variant. The winners must be the counter-free
    search's bits; each query's int64 rows and cells are printed."""
    res, wall, launches = counted_search(torch, ref, queries, cfg,
                                         with_info=True)
    h = host["res"]
    same = (torch.equal(res.best_start, h.best_start)
            and torch.equal(res.best_dist, h.best_dist))
    say(f"[4 counters] host rounds with_info=True N={cfg.ref_len}: "
        f"{wall:.3f} s wall (counter-free {host['wall_s']:.3f} s); launches "
        f"{launches}; best_start and best_dist the counter-free bits: {same}")
    say(f"  rows per query (int64) {res.rows.tolist()}")
    say(f"  cells per query (int64) {res.cells.tolist()}")
    check(launches["dtw_ea_multi_fused"] > 0
          and launches["lb_keogh_all_windows"] == 1,
          "the counting host rounds must run kernels A and B")
    check(same, "the counters changed the search's winners")
    check(res.rows.dtype == torch.int64 and bool((res.rows > 0).all())
          and bool((res.cells > res.rows).all()), "counters missing")
    return {"wall_s": wall, "rows": res.rows.tolist(),
            "cells": res.cells.tolist()}


def phase_slab_arms(torch, cfg, ref, queries, host: dict, sweep: dict) -> dict:
    """The slab arms end to end at the full N: host rounds with
    ``gather="slab"`` (kernel D, an (8, 256, 1024) slab a round) against
    phase 4's host rounds, and the persistent sweep with ``gather="slab"``
    (kernel E, the whole (8, n_win, 1024) slab) against phase 4's fused
    sweep, with its allocation peak."""
    res, wall, launches = counted_search(torch, ref, queries, cfg,
                                         gather="slab")
    say(f"[4 slab arms] host rounds gather=slab N={cfg.ref_len}: {wall:.3f} s "
        f"wall; launches {launches}; best_start equal to gather=fused "
        f"{res.best_start.tolist() == host['res'].best_start.tolist()}, "
        f"best_dist the same bits "
        f"{torch.equal(res.best_dist, host['res'].best_dist)}")
    check(launches["dtw_ea_multi"] > 0 and launches["dtw_ea_multi_fused"] == 0
          and launches["lb_keogh_all_windows"] == 1,
          "the slab host rounds must run kernel D and not kernel A")
    check(res.best_start.tolist() == host["res"].best_start.tolist(),
          "host rounds: gather=slab and gather=fused differ")
    out = {"dtw_ea_multi": launches["dtw_ea_multi"], "host_slab_wall_s": wall,
           "host_slab": {"best_start": res.best_start,
                         "best_dist": res.best_dist, "rounds": res.rounds}}
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slab, s_wall, s_launches = counted_search(torch, ref, queries, cfg,
                                              rounds="persistent",
                                              gather="slab")
    peak = torch.cuda.max_memory_allocated() / 1e9
    fused = sweep["res"]
    say(f"[4 slab arms] persistent gather=slab N={cfg.ref_len}: "
        f"{s_wall:.3f} s wall (gather=fused {sweep['wall_s']:.3f} s), peak "
        f"{peak:.2f} GB allocated, launches {s_launches}; best_start equal "
        f"{slab.best_start.tolist() == fused.best_start.tolist()}, best_dist "
        f"the same bits {torch.equal(slab.best_dist, fused.best_dist)}")
    check(s_launches["dtw_ea_persistent"] == 1
          and s_launches["lb_keogh_all_windows"] == 1
          and s_launches["dtw_ea_persistent_fused"] == 0,
          "the slab sweep must launch E once and C never")
    check(slab.best_start.tolist() == fused.best_start.tolist(),
          "persistent: gather=slab and gather=fused differ")
    torch.cuda.empty_cache()
    out.update(dtw_ea_persistent=s_launches["dtw_ea_persistent"],
               sweep_slab_wall_s=s_wall, sweep_slab_peak_gb=peak)
    return out


def arrival_sizes(n: int, most: int, seed: int) -> list[int]:
    """Seeded ragged arrival sizes of 1 to ``most`` samples covering ``n``
    (the last one is the remainder)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes, total = [], 0
    while total < n:
        sizes.append(min(int(rng.integers(1, most + 1)), n - total))
        total += sizes[-1]
    return sizes


def recording(results: list):
    """An executor factory for ``StreamSearchEngine``: the default
    executor, with each ingest's ``IngestResult`` kept in ``results`` (no
    host sync)."""
    def factory(default):
        class Recorder:
            def run_ingest(self, *args, **kwargs):
                out = default.run_ingest(*args, **kwargs)
                results.append(out[1])
                return out
        return Recorder()
    return factory


def feed_stream(torch, eng, ref, sizes, start: int = 0,
                after=None) -> dict:
    """Feed ``ref[start:]`` to ``eng`` in ``sizes``; each arrival's latency
    is host time around ``ingest`` to a device sync. ``after(eng, n_seen)``
    runs after each arrival (outside the timing) and may stop the feed by
    returning True. Returns the wall, the latencies and where it stopped."""
    lat, i = [], start
    t0 = time.perf_counter()
    for c in sizes:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.ingest(ref[i:i + c])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        i += c
        if after is not None and after(eng, i):
            break
    return {"wall_s": time.perf_counter() - t0, "lat": lat, "stop": i}


def pct(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


def near_tie(torch, ref, query, a: int, b: int, length: int,
             window: int) -> tuple[float, float]:
    """The DTW of ``query`` to windows ``a`` and ``b`` of ``ref`` in
    float64, windows and query normalized in float64 (``core.dtw``)."""
    from repro_torch.core.common import EPS
    from repro_torch.core.dtw import dtw_batch

    r = ref.to(torch.float64)
    w = torch.stack([r[a:a + length], r[b:b + length]])
    w = (w - w.mean(1, keepdim=True)) / w.std(
        1, keepdim=True, correction=0).clamp_min(EPS)
    q = query.to(torch.float64)
    q = (q - q.mean()) / q.std(correction=0).clamp_min(EPS)
    d = dtw_batch(q.expand(2, -1), w, window=window).cpu()
    return float(d[0]), float(d[1])


def check_winners(torch, label, bs, bd, offline, ref, queries, cfg,
                  ties: dict, what: str = "offline") -> None:
    """Winners ``(bs, bd)`` against ``offline``'s ``(best_start,
    best_dist)``: each ``best_start`` equal, or a near tie proven in
    float64 (both windows' DTW within ``TOL_A``); ``best_dist`` within
    ``TOL_A``."""
    bs, bd = (torch.as_tensor(x) for x in (bs, bd))
    got, want = bs.tolist(), torch.as_tensor(offline.best_start).tolist()
    rel = rel_err(bd.cpu().to(torch.float64),
                  torch.as_tensor(offline.best_dist).cpu().to(torch.float64))
    say(f"  {label}: best_start {got}; equal to {what} "
        f"{got == want}; best_dist max rel err {rel:.3e} (tol {TOL_A})")
    check(rel <= TOL_A, f"{label}: best_dist differs from {what}")
    for qi, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        dg, dw = near_tie(torch, ref, queries[qi], g, w, cfg.query_len,
                          cfg.window)
        gap = abs(dg / dw - 1)
        say(f"  {label}: query {qi} window {g} ({what} {w}): float64 DTW "
            f"{dg!r} and {dw!r}, {gap:.3e} apart (tol {TOL_A})")
        check(gap <= TOL_A, f"{label}: query {qi} found {g}, {what} {w}, "
              "and they are no near tie")
        ties.setdefault(label, []).append(qi)


def check_rescore(torch, eng, ref, first: int, count: int, best0, ub0,
                  snap: dict) -> None:
    """Arm (d)'s flush against its plain version. The ``count`` windows
    from ``first`` (over the burst, clean) are the slab the flush
    rescored: kernel D on it (with the cb slab) against the plain version,
    under the carried incumbents ``ub0`` and under ``ub = BIG`` (every lane
    finishes, so each distance is compared); and the flush's
    ``(ub, best)`` in ``snap`` against ``rescore_windows`` on the CPU (the
    plain kernel D) from ``(ub0, best0)``: ``best`` equal, ``ub`` within
    ``TOL_A``. The launches here are comparisons and are not counted."""
    from repro_torch.core.common import BIG
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_plain
    from repro_torch.search.streaming import rescore_windows
    from repro_torch.search.znorm import znorm

    l, window, nq = eng.length, eng.window, eng.n_queries
    starts = torch.arange(first, first + count, device=ref.device)
    wins = ref[starts[:, None] + torch.arange(l, device=ref.device)]
    check(bool(torch.isfinite(wins).all()), "(d): a rescored window is "
          "not finite")
    cand = znorm(wins)[None].expand(nq, count, l).contiguous()
    cb = cascade_keogh_cumulative(cand, eng.u[:, None, :],
                                  eng.low[:, None, :]).contiguous()
    bw = ops.resolve_band(window, l, l, eng.band_width)
    for label, ub in (("carried ub", ub0[:, None].expand(nq, count)),
                      ("ub = BIG", torch.full((nq, count), BIG,
                                              device=ref.device))):
        ub = ub.contiguous()
        k = ops.dtw_ea_multi(eng.queries_n, cand, ub, window, cb=cb)
        p = dtw_ea_plain(eng.queries_n, cand, ub, window, bw, cb=cb)
        torch.cuda.synchronize()
        compare_lanes(torch, k, p, ub, f"(d) the flush's slab ({nq}, "
                      f"{count}, {l}) with cb, {label}")
        if label == "ub = BIG":
            check(bool(torch.isfinite(k).all()), "(d): a lane abandoned "
                  "under ub = BIG")
            say(f"  (d) nearest re-admitted window per query "
                f"{k.min(1).values.tolist()} (carried ub {ub0.tolist()})")
    ub_c, best_c = rescore_windows(
        wins.cpu(), starts.cpu(), eng.queries_n.cpu(), eng.u.cpu(),
        eng.low.cpu(), ub0.cpu(), best0.cpu(), window=window,
        variant=eng.variant, band_width=eng.band_width, device="cpu")
    got_b, got_ub = snap["best"].tolist(), torch.as_tensor(snap["ub"])
    rel = rel_err(got_ub, ub_c)
    say(f"  (d) the flush's best {got_b}, ub rel err {rel:.3e} against "
        f"rescore_windows on the CPU (best {best_c.tolist()}; tol {TOL_A})")
    check(got_b == best_c.tolist() and rel <= TOL_A,
          "(d): the flush's incumbents differ from the plain rescore's")


def phase_stream(torch, cfg, ref, queries, host: dict) -> dict:
    """Streaming at the main path's shapes: arms (a)-(d) of the module
    docstring, each against phase 4's offline host rounds."""
    from repro_torch.kernels import ops

    offline = host["res"]
    n, l = cfg.ref_len, cfg.query_len
    tiles = len(ops.lb_query_tiles(cfg.n_queries, l))
    sizes = arrival_sizes(n, STREAM_MAX_ARRIVAL, STREAM_SEED)
    split = sum(c > cfg.stream_chunk for c in sizes)
    padded = sum(c % cfg.stream_chunk != 0 for c in sizes)
    say(f"[4 stream] StreamSearchEngine N={n} l={l} w={cfg.window} "
        f"Q={cfg.n_queries} batch={cfg.batch}: {len(sizes)} arrivals of "
        f"{min(sizes)}-{max(sizes)} samples (seed {STREAM_SEED}; {split} "
        f"split into stream_chunk={cfg.stream_chunk} pieces, {padded} with a "
        f"padded piece, the last {sizes[-1]})")
    ties, arms, by_arm = {}, {}, {}

    def engine(results, **kw):
        return cfg.make_stream_engine(queries, device=DEVICE,
                                      executor=recording(results), **kw)

    def report(label, eng, fed, results, launches):
        rounds = sum(int(r.rounds.max()) for r in results)
        say(f"  {label}: {fed['wall_s']:.3f} s wall; {len(fed['lat'])} "
            f"arrivals, {len(results)} ingests; rounds {eng.rounds} "
            f"(summed over ingests {rounds}), lanes {eng.lanes}; an arrival "
            f"{pct(fed['lat'], 50):.2f} ms at the median, "
            f"{pct(fed['lat'], 99):.2f} ms at the 99th percentile; launches "
            f"{launches}; quarantined windows {eng.quarantined_windows}, "
            f"samples {eng.quarantined_samples}")
        arms[label] = {
            "wall_s": fed["wall_s"], "arrivals": len(fed["lat"]),
            "ingests": len(results), "rounds": eng.rounds, "lanes": eng.lanes,
            "p50_ms": pct(fed["lat"], 50), "p99_ms": pct(fed["lat"], 99),
            "launches": {k: v for k, v in launches.items() if v},
        }
        return rounds

    # (a), (b), (c): the default engine, the raw form, slab gather; and the
    # raw form on (a)'s arrivals, which times the fixed ingest shape
    # (stream_chunk) against ingesting each arrival as it comes. Each arm
    # runs the default round loop (replayed rounds where an ingest runs
    # long enough); arm (a) runs once more after them with CUDA events
    # around every launch of kernels A and B (kernel_events, every round
    # eager), which split its wall.
    timed_a = ["dtw_ea_multi_fused", "lb_keogh_all_windows"]
    for label, kw, arm_sizes, round_kernel in (
        ("(a) default", {}, sizes, "dtw_ea_multi_fused"),
        ("(b) raw", {"stream_chunk": None},
         [min(STREAM_RAW_CHUNK, n - i) for i in range(0, n, STREAM_RAW_CHUNK)],
         "dtw_ea_multi_fused"),
        ("(b2) raw, (a)'s arrivals", {"stream_chunk": None}, sizes,
         "dtw_ea_multi_fused"),
        ("(c) slab", {"gather": "slab"}, sizes, "dtw_ea_multi"),
    ):
        results = []
        eng = engine(results, **kw)
        zero_launches()
        fed = feed_stream(torch, eng, ref, arm_sizes)
        launches = launches_now()
        rounds = report(label, eng, fed, results, launches)
        by_arm[label] = launches
        check(launches[round_kernel] == rounds == eng.rounds > 0,
              f"{label}: launches of {round_kernel} are not the ingests' "
              "rounds")
        check(launches["lb_keogh_all_windows"] == tiles * len(results) > 0,
              f"{label}: kernel B's launches are not one a tile an ingest")
        check(all(v == 0 for k, v in launches.items()
                  if k not in (round_kernel, "lb_keogh_all_windows")),
              f"{label}: another DTW kernel was launched")
        check(eng.quarantined_windows == int(offline.quarantined) == 0
              and eng.quarantined_samples == 0,
              f"{label}: quarantine counts differ from offline's (0)")
        check_winners(torch, label, *eng.best(), offline, ref, queries, cfg,
                      ties)
        arms[label]["best_start"] = eng.best()[0].tolist()
        if label == "(a) default":  # the bits phase 4 resilient holds to
            a_state = {"best": eng.best()[0].clone(),
                       "ub": eng.best()[1].clone(), "rounds": eng.rounds,
                       "lanes": eng.lanes, "ingests": len(results),
                       "sizes": sizes}
        del eng, results
    pa, pr = arms["(a) default"], arms["(b2) raw, (a)'s arrivals"]
    say(f"  the same {len(sizes)} arrivals, padded to stream_chunk="
        f"{cfg.stream_chunk} against raw: {pa['wall_s']:.3f} s against "
        f"{pr['wall_s']:.3f} s wall ({pa['ingests']} against {pr['ingests']} "
        f"ingests, {pa['rounds']} against {pr['rounds']} rounds); an arrival "
        f"{pa['p50_ms']:.2f} against {pr['p50_ms']:.2f} ms at the median, "
        f"{pa['p99_ms']:.2f} against {pr['p99_ms']:.2f} ms at the 99th "
        "percentile")

    # Arm (a) again, every round eager, with events around A and B: the
    # same bits and launches, and the split of its wall.
    results = []
    eng = engine(results)
    zero_launches()
    with kernel_events(torch, timed_a) as ev:
        fed = feed_stream(torch, eng, ref, sizes)
    launches = launches_now()
    wall_ms = fed["wall_s"] * 1e3
    a_ms, b_ms = (events_ms(ev[k]) for k in timed_a)
    rest = wall_ms - a_ms - b_ms
    say(f"  (a) eager, with events around kernels A and B: "
        f"{fed['wall_s']:.3f} s wall (graphed {pa['wall_s']:.3f} s); A "
        f"{a_ms:.1f} ms in all ({100 * a_ms / wall_ms:.1f}% of the wall, "
        f"{a_ms / len(ev[timed_a[0]]):.4f} ms a launch), B {b_ms:.1f} ms "
        f"({100 * b_ms / wall_ms:.2f}%), the rest {rest:.1f} ms "
        f"({100 * rest / wall_ms:.1f}%, {rest / eng.rounds:.4f} ms a round)")
    pa.update(eager_wall_s=fed["wall_s"], a_ms=a_ms, b_ms=b_ms, rest_ms=rest)
    check(torch.equal(eng.best()[0], a_state["best"])
          and torch.equal(eng.best()[1], a_state["ub"])
          and (eng.rounds, eng.lanes) == (a_state["rounds"], a_state["lanes"]),
          "(a) eager: the bits differ from the default round loop's")
    check(launches == by_arm["(a) default"],
          "(a) eager: the launches differ from the default round loop's")
    del eng, results

    # (d): re-admission through correct, save_state and restore_state.
    pos = n // 2
    winners = set(arms["(a) default"]["best_start"])
    while any(pos - l < s < pos + STREAM_BURST for s in winners):
        pos += 5_000
    dirty = ref.clone()
    dirty[pos:pos + STREAM_BURST] = float("nan")
    clean = ref[pos:pos + STREAM_BURST].cpu().numpy()
    overlap = STREAM_BURST + l - 1
    results = []
    eng = engine(results, ring_capacity=STREAM_RING)
    zero_launches()
    state = {}

    def readmit(e, seen):
        if seen < pos + overlap:  # the burst's last window is not complete
            return False
        state["before"] = (e.quarantined_windows, e.quarantined_samples)
        state["queued"] = e.correct(pos, clean)
        state["samples"] = e.quarantined_samples
        return True

    fed = feed_stream(torch, eng, dirty, sizes, after=readmit)
    seen = fed["stop"]
    before = launches_now()
    best0, ub0 = (t.clone() for t in eng.best())
    zero_launches()
    snap = eng.save_state()  # flushes the rescore: one launch of kernel D
    flush = launches_now()
    check_rescore(torch, eng, ref, pos - l + 1, overlap, best0, ub0, snap)
    rest = sizes[len(fed["lat"]):]  # arm (a)'s pieces from here on
    fresh_results = []
    fresh = engine(fresh_results, ring_capacity=STREAM_RING)
    fresh.restore_state(snap)
    zero_launches()
    fed2 = feed_stream(torch, fresh, dirty, rest, start=seen)
    after = launches_now()
    say(f"  (d) re-admission: a {STREAM_BURST}-sample NaN burst at {pos}; "
        f"correct() after {seen} samples: quarantined windows, samples "
        f"before {state['before']}, {state['queued']} windows queued, "
        f"samples after {state['samples']}; save_state launches {flush}; "
        f"restored, then {len(rest)} more arrivals")
    fed_all = {"wall_s": fed["wall_s"] + fed2["wall_s"],
               "lat": fed["lat"] + fed2["lat"]}
    launches = {k: before[k] + flush[k] + after[k] for k in KERNELS}
    report("(d) re-admission", fresh, fed_all, results + fresh_results,
           launches)
    arms["(d) re-admission"].update(burst=pos, queued=state["queued"],
                                    flush_launches=flush["dtw_ea_multi"])
    check(state["before"] == (overlap, STREAM_BURST),
          "(d): the burst's windows and samples were not all quarantined")
    check(state["queued"] == overlap and state["samples"] == 0,
          "(d): correct() did not queue every window over the burst")
    check(flush["dtw_ea_multi"] == 1 and sum(flush.values()) == 1,
          "(d): save_state must rescore in exactly one launch of kernel D")
    check(fresh.quarantined_windows == 0 and fresh.quarantined_samples == 0
          and fresh.readmitted_windows == overlap,
          "(d): quarantine not cleared, or readmitted_windows is not the "
          "number of windows over the burst")
    check(before["dtw_ea_multi_fused"] + after["dtw_ea_multi_fused"]
          == fresh.rounds, "(d): launches of kernel A are not the rounds")
    check_winners(torch, "(d) re-admission", *fresh.best(), offline, ref,
                  queries, cfg, ties)
    # Against arm (a), fed the same pieces: the same best_start, or a near
    # tie (the burst's ingests difference zero-filled prefix sums).
    got, want = fresh.best()[0].tolist(), arms["(a) default"]["best_start"]
    say(f"  (d) against (a): best_start equal {got == want}")
    for qi, (g, w) in enumerate(zip(got, want)):
        if g != w:
            dg, dw = near_tie(torch, ref, queries[qi], g, w, l, cfg.window)
            check(abs(dg / dw - 1) <= TOL_A,
                  f"(d): query {qi} found {g}, arm (a) {w}: no near tie")
            ties.setdefault("(d) against (a)", []).append(qi)
    arms["near_ties"] = ties
    say(f"  queries that needed the near-tie rule: {ties or 'none'}")
    return {"arms": arms, "a": by_arm["(a) default"], "c": by_arm["(c) slab"],
            "a_state": a_state}


class FakeClock:
    """A clock the caller moves (``advance``): hedging decisions made on it
    are the recipe's, whatever the card's times."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class ShardFaults:
    """A ``resilient_search`` runner that raises before the dispatch on
    chosen calls: shards that always fail (``dead``), ranges that fail
    once (``flaky``, by ``lo``) or on every shard (``dead_ranges``), and
    shards that complete ``fail_after[shard]`` calls and then die. Each
    call is kept in ``calls`` as ``(shard, lo, hi, ok)``."""

    def __init__(self, runner, dead=(), flaky=(), dead_ranges=(),
                 fail_after=None):
        self.runner = runner
        self.dead, self.flaky = set(dead), set(flaky)
        self.dead_ranges = set(dead_ranges)
        self.fail_after = dict(fail_after or {})
        self.calls, self.n = [], {}

    def __call__(self, shard, lo, hi, ub):
        self.n[shard] = self.n.get(shard, 0) + 1
        fail = (shard in self.dead or lo in self.dead_ranges
                or self.n[shard] > self.fail_after.get(shard, self.n[shard]))
        if lo in self.flaky:
            self.flaky.discard(lo)
            fail = True
        self.calls.append((shard, lo, hi, not fail))
        if fail:
            raise RuntimeError(f"injected fault: shard {shard}, range {lo}")
        return self.runner(shard, lo, hi, ub)


def recorded(cls, records: list, tag=None):
    """``cls`` (an executor) whose ``run_range`` appends ``{tag, lo, hi,
    rounds, ms}`` to ``records``; reading the rounds waits for the range's
    device work, so ``ms`` includes it."""

    class Recorded(cls):
        def run_range(self, plan, state, lo, hi):
            t0 = time.perf_counter()
            rr = super().run_range(plan, state, lo, hi)
            records.append({"tag": tag, "lo": lo, "hi": hi,
                            "rounds": int(rr.stats.rounds.max()),
                            "ms": (time.perf_counter() - t0) * 1e3})
            return rr

    return Recorded


class Straggler:
    """An executor proxy on a ``FakeClock``: each call advances it by
    ``slow_dt`` when the call's index (from 0) is in ``slow_at``, else by
    1; with ``results``, each ``run_ingest`` result is kept there."""

    def __init__(self, executor, clock, slow_at=(), slow_dt=50.0,
                 results=None):
        self.executor, self.clock = executor, clock
        self.slow_at, self.slow_dt = set(slow_at), slow_dt
        self.results, self.calls = results, 0

    def _tick(self):
        self.clock.advance(self.slow_dt if self.calls in self.slow_at
                           else 1.0)
        self.calls += 1

    def run_range(self, *args):
        out = self.executor.run_range(*args)
        self._tick()
        return out

    def run_ingest(self, *args, **kwargs):
        out = self.executor.run_ingest(*args, **kwargs)
        if self.results is not None:
            self.results.append(out[1])
        self._tick()
        return out


def check_launches(label, launches, a=0, b=0, c=0) -> None:
    """Kernel A, B and C launched ``a``, ``b`` and ``c`` times, D and E
    never."""
    want = {"dtw_ea_multi_fused": a, "lb_keogh_all_windows": b,
            "dtw_ea_persistent_fused": c, "dtw_ea_multi": 0,
            "dtw_ea_persistent": 0}
    say(f"  {label}: launches {launches} (expected {want})")
    check(launches == want and a + c > 0 and b > 0,
          f"{label}: launches {launches}, expected {want}")


def phase_resilient(torch, cfg, ref, queries, host: dict, sweep: dict,
                    stream: dict, workdir: str) -> dict:
    """The fault-tolerant host layer at the main path's shapes, arms
    (a)-(f) of the module docstring; checkpoints under ``workdir``."""
    import copy
    import dataclasses
    import os
    import shutil

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.search import IncumbentState
    from repro_torch.search import resilient
    from repro_torch.search.pipeline import (
        HostRoundsExecutor,
        PersistentExecutor,
    )
    from repro_torch.search.resilient import executor_runner, partition_ranges

    offline, n, l = host["res"], cfg.ref_len, cfg.query_len
    nq = cfg.n_queries
    tiles = len(ops.lb_query_tiles(nq, l))
    n_win = n - l + 1
    ranges = partition_ranges(n_win, RES_RANGES)
    plan = cfg.make_plan()
    ties, arms = {}, {}
    say(f"[4 resilient] N={n} l={l} w={cfg.window} Q={nq} batch={cfg.batch}: "
        f"n_shards={cfg.n_shards}, {RES_RANGES} ranges of "
        f"{ranges[0][1] - ranges[0][0]} windows (the last "
        f"{ranges[-1][1] - ranges[-1][0]})")

    def arm(label, res, wall, launches, **extra):
        arms[label] = dict(
            wall_s=wall, attempts=res.attempts, coverage=res.coverage,
            reassignments=res.reassignments,
            failed_shards=list(res.failed_shards),
            hedges_launched=res.hedges_launched, hedges_won=res.hedges_won,
            launches={k: v for k, v in launches.items() if v}, **extra)

    def search(series, **kw):
        """``cfg.resilient_search`` on the card in RES_RANGES ranges, its
        launches counted from 0."""
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cfg.resilient_search(series, queries, device=DEVICE,
                                   n_ranges=RES_RANGES, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, launches_now()

    # (a) the clean search, the default runner (host rounds a range).
    recs = []
    resilient.HostRoundsExecutor = recorded(HostRoundsExecutor, recs)
    try:
        res_a, wall, launches = search(ref)
    finally:
        resilient.HostRoundsExecutor = HostRoundsExecutor
    rounds = sum(r["rounds"] for r in recs)
    say(f"  (a) clean: {wall:.3f} s wall (offline host rounds "
        f"{host['wall_s']:.3f} s); {res_a.attempts} attempts, coverage "
        f"{res_a.coverage}, uncovered {res_a.uncovered}; rounds "
        f"{rounds} (a range's: {[r['rounds'] for r in recs]}) against the "
        f"offline {int(offline.rounds.max())}; a range "
        f"{[round(r['ms'], 1) for r in recs]} ms; quarantined "
        f"{res_a.quarantined}")
    check(res_a.coverage == 1.0 and res_a.uncovered == ()
          and res_a.attempts == RES_RANGES == len(recs)
          and res_a.reassignments == 0 and res_a.failed_shards == (),
          "(a): the clean search did not cover every range in one attempt")
    check(res_a.quarantined == int(offline.quarantined),
          "(a): quarantine differs from offline")
    check_launches("(a)", launches, a=rounds, b=tiles * RES_RANGES)
    check_winners(torch, "(a)", res_a.best_start, res_a.best_dist, offline,
                  ref, queries, cfg, ties)
    arm("(a) clean", res_a, wall, launches, rounds=rounds,
        range_ms=[r["ms"] for r in recs])

    # (b) the same ranges, each one persistent sweep.
    recs = []
    ex = recorded(PersistentExecutor, recs)(ref, queries, device=DEVICE)
    res_b, wall, launches = search(ref, runner=executor_runner(ex, plan))
    say(f"  (b) PersistentExecutor: {wall:.3f} s wall (offline persistent "
        f"{sweep['wall_s']:.3f} s); a range "
        f"{[round(r['ms'], 1) for r in recs]} ms")
    check(res_b.coverage == 1.0 and res_b.attempts == RES_RANGES,
          "(b): the persistent ranges did not all complete")
    check_launches("(b)", launches, c=RES_RANGES, b=tiles * RES_RANGES)
    check_winners(torch, "(b)", res_b.best_start, res_b.best_dist, res_a,
                  ref, queries, cfg, ties, what="(a)")
    arm("(b) persistent", res_b, wall, launches,
        range_ms=[r["ms"] for r in recs])
    del ex

    # (c) fault recipes at a reference cut to RES_CUT samples.
    n_cut = RES_CUT - l + 1
    cut_ranges = partition_ranges(n_cut, RES_RANGES)
    cut = ref[:RES_CUT]
    res_c0, wall, launches = search(cut)
    off_cut, _, _ = counted_search(torch, cut, queries, cfg)
    say(f"  (c) the reference cut to its first {RES_CUT} samples: clean "
        f"{wall:.3f} s, launches {launches}")
    check(res_c0.coverage == 1.0, "(c): the clean cut search lost coverage")
    check_winners(torch, "(c) clean, cut", res_c0.best_start,
                  res_c0.best_dist, off_cut, ref, queries, cfg, ties)
    arm("(c) clean, cut", res_c0, wall, launches)
    last = cut_ranges[-1]
    recipes = [
        ("dead shard 1", dict(dead={1})),
        ("range 2 fails once", dict(flaky={cut_ranges[2][0]})),
        ("shard 0 dies after two calls, shard 1 dead",
         dict(fail_after={0: 2}, dead={1})),
        ("the last range dead on every shard",
         dict(dead_ranges={last[0]})),
    ]
    for label, recipe in recipes:
        recs, sleeps = [], []
        ex = recorded(HostRoundsExecutor, recs)(cut, queries, device=DEVICE)
        inj = ShardFaults(executor_runner(ex, plan), **recipe)
        res, wall, launches = search(cut, runner=inj, sleep=sleeps.append)
        label = f"(c) {label}"
        say(f"  {label}: {wall:.3f} s; {res.attempts} attempts, "
            f"{res.reassignments} reassignments, failed shards "
            f"{res.failed_shards}, coverage {res.coverage!r}, uncovered "
            f"{res.uncovered}; {len(sleeps)} backoff sleeps (recorded, not "
            f"slept) {[round(x, 4) for x in sleeps]}")
        check(res.attempts == len(inj.calls)
              and len(recs) == sum(ok for *_x, ok in inj.calls),
              f"{label}: attempts are not the runner's calls")
        check_launches(label, launches, a=sum(r["rounds"] for r in recs),
                       b=tiles * len(recs))
        if "dead on every shard" in label:
            check(res.coverage == (n_cut - (last[1] - last[0])) / n_cut
                  and res.uncovered == (last,),
                  f"{label}: coverage is not 1 - len(range)/n_win")
            prefix, _, _ = counted_search(torch, ref[:last[0] + l - 1],
                                          queries, cfg)
            check_winners(torch, label, res.best_start, res.best_dist,
                          prefix, ref, queries, cfg, ties,
                          what=f"offline over ref[:{last[0] + l - 1}]")
        else:
            check(res.coverage == 1.0 and res.uncovered == (),
                  f"{label}: coverage lost")
            check_winners(torch, label, res.best_start, res.best_dist,
                          res_c0, ref, queries, cfg, ties,
                          what="the clean cut search")
        if label.startswith("(c) dead shard"):
            check(res.failed_shards == (1,) and res.reassignments == 2,
                  f"{label}: shard 1's two ranges were not reassigned")
        if label.startswith("(c) shard 0"):
            check(res.failed_shards == (0, 1),
                  f"{label}: shards 0 and 1 should be marked failed")
        if label.startswith("(c) range 2"):
            check(res.attempts == RES_RANGES + 1 and len(sleeps) == 1,
                  f"{label}: one retry after one backoff expected")
        arm(label, res, wall, launches, sleeps=sleeps)
        del ex

    # (d) HedgedExecutor over two HostRoundsExecutors, the full reference:
    # executor 0 straggles (on the fake clock) on RES_SLOW_RANGES.
    recs = []
    clock = FakeClock()
    execs = [Straggler(recorded(HostRoundsExecutor, recs, i)(
                 ref, queries, device=DEVICE), clock,
                 slow_at=RES_SLOW_RANGES if i == 0 else ())
             for i in range(2)]
    hedged = cfg.make_hedged_executor(execs, clock=clock)
    state = IncumbentState(
        ub=torch.full((nq,), float("inf"), device=DEVICE),
        best=torch.full((nq,), -1, dtype=torch.int64, device=DEVICE))
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in ranges:
        state = hedged.run_range(plan, state, lo, hi).state
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    backups = [r for r in recs if r["tag"] == 1]
    same = (np.array_equal(state.best.cpu().numpy(), res_a.best_start)
            and np.array_equal(state.ub.cpu().numpy().astype(np.float64),
                               res_a.best_dist))
    say(f"  (d) HedgedExecutor: {wall:.3f} s wall; hedges launched "
        f"{hedged.hedges_launched}, won {hedged.hedges_won}; backups ran "
        f"ranges {[(r['lo'], r['hi']) for r in backups]}; last effective "
        f"dt {hedged.last_effective_dt}; best_start and best_dist the bits "
        f"of (a) (the same ranges unhedged): {same}")
    check(hedged.hedges_launched == hedged.hedges_won == len(RES_SLOW_RANGES)
          and [r["lo"] for r in backups]
          == [ranges[i][0] for i in RES_SLOW_RANGES],
          "(d): the hedges are not the recipe's")
    check(same, "(d): hedging changed the answer")
    check_launches("(d)", launches, a=sum(r["rounds"] for r in recs),
                   b=tiles * len(recs))
    arms["(d) hedged ranges"] = dict(
        wall_s=wall, attempts=len(recs), hedges_launched=hedged.hedges_launched,
        hedges_won=hedged.hedges_won,
        launches={k: v for k, v in launches.items() if v})
    del execs, hedged

    # (e) SearchSupervisor around the default engine, on stream arm (a)'s
    # arrivals; every run must give arm (a)'s bits.
    a_state = stream["a_state"]
    sizes = a_state["sizes"]
    starts = [sum(sizes[:i]) for i in range(len(sizes) + 1)]

    def same_as_a(label, eng):
        b, d = eng.best()
        ok = (torch.equal(b, a_state["best"]) and torch.equal(d, a_state["ub"])
              and eng.rounds == a_state["rounds"]
              and eng.lanes == a_state["lanes"])
        say(f"  {label}: ub, best, rounds {eng.rounds}, lanes {eng.lanes} "
            f"the bits of stream arm (a): {ok}")
        check(ok, f"{label}: not the uninterrupted stream's bits")

    def engine(results):
        return cfg.make_stream_engine(queries, device=DEVICE,
                                      executor=recording(results))

    def feed(sup, first, last, inject=None):
        for i in range(first, last):
            sup.ingest(ref[starts[i]:starts[i + 1]], fail_injector=inject)

    def supervised(label, runs):
        """``runs``: ``(first, last, resume, dir, async_ckpt, inject)``, a
        fresh engine and supervisor each (a process that starts, resumes
        when ``resume`` is set, and feeds arrivals ``[first, last)``), or
        a callable run between two of them."""
        results, sleeps, info = [], [], []
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for run in runs:
            if callable(run):
                run()
                continue
            first, last, resume, d, async_ckpt, inject = run
            eng = engine(results)
            sup = dataclasses.replace(cfg, async_ckpt=async_ckpt) \
                .make_supervisor(eng, d, ckpt_every=RES_CKPT_EVERY,
                                 sleep=sleeps.append)
            if resume is not None:
                k = sup.resume()
                info.append(f"resume() {k}")
                check(k == resume, f"{label}: resume() gave {k}, not "
                      f"{resume}")
            feed(sup, first, last, inject)
            sup.close()
            info.append(f"restarts {sup.restarts}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
        rounds = sum(int(r.rounds.max()) for r in results)
        say(f"  (e) {label}: {wall:.3f} s wall; {len(results)} ingests "
            f"(replays included); {', '.join(info)}; sleeps {sleeps}")
        check_launches(f"(e) {label}", launches, a=rounds,
                       b=tiles * len(results))
        same_as_a(f"(e) {label}", eng)
        arms[f"(e) {label}"] = dict(
            wall_s=wall, ingests=len(results), info=info,
            launches={k: v for k, v in launches.items() if v})
        return sup

    n_arr = len(sizes)
    pending = set(RES_FAULT_ARRIVALS)

    def inject(i):
        if i in pending:
            pending.discard(i)
            raise RuntimeError(f"injected fault at arrival {i}")

    d1 = os.path.join(workdir, "faults")
    sup = supervised(f"transient faults at arrivals {RES_FAULT_ARRIVALS}",
                     [(0, n_arr, None, d1, False, inject)])
    check(sup.restarts == len(RES_FAULT_ARRIVALS) and not pending,
          "(e): the faults were not each retried once")
    # Killed after arrival RES_KILL_AFTER (checkpoints at every
    # RES_CKPT_EVERY), resumed by a fresh engine and supervisor; a copy of
    # the killed run's directory with its newest checkpoint's leaf
    # truncated, where resume() falls back one checkpoint.
    d2, d4 = (os.path.join(workdir, x) for x in ("kill", "damaged"))
    k = RES_KILL_AFTER // RES_CKPT_EVERY * RES_CKPT_EVERY

    def damage():
        shutil.copytree(d2, d4)
        with open(os.path.join(d4, f"step_{k:08d}", "ub.npy"), "r+b") as f:
            f.truncate(16)

    supervised(f"killed after arrival {RES_KILL_AFTER}, resumed",
               [(0, RES_KILL_AFTER, None, d2, False, None), damage,
                (k, n_arr, k, d2, False, None)])
    supervised("async_ckpt=True",
               [(0, n_arr, None, os.path.join(workdir, "async"), True, None)])
    supervised(f"newest checkpoint (step {k}) truncated",
               [(k - RES_CKPT_EVERY, n_arr, k - RES_CKPT_EVERY, d4, False,
                 None)])
    shutil.rmtree(workdir, ignore_errors=True)

    # (f) a hedged stream: the default engine over a HedgedExecutor of two
    # ingest executors, executor 0 straggling on RES_SLOW_INGESTS.
    clock, backup_results = FakeClock(), []
    hedges = {}

    def hedged_factory(default):
        pair = [Straggler(default, clock, slow_at=RES_SLOW_INGESTS),
                Straggler(copy.copy(default), clock, results=backup_results)]
        hedges["executor"] = cfg.make_hedged_executor(pair, clock=clock)
        return hedges["executor"]

    eng = cfg.make_stream_engine(queries, device=DEVICE,
                                 executor=hedged_factory)
    zero_launches()
    fed = feed_stream(torch, eng, ref, sizes)
    launches = launches_now()
    h = hedges["executor"]
    extra = sum(int(r.rounds.max()) for r in backup_results)
    say(f"  (f) hedged stream: {fed['wall_s']:.3f} s wall; hedges launched "
        f"{h.hedges_launched}, won {h.hedges_won}; the backups' rounds "
        f"{extra}; an arrival {pct(fed['lat'], 50):.2f} ms at the median, "
        f"{pct(fed['lat'], 99):.2f} ms at the 99th percentile")
    check(h.hedges_launched == h.hedges_won == len(RES_SLOW_INGESTS)
          == len(backup_results), "(f): the hedges are not the recipe's")
    check_launches("(f)", launches, a=a_state["rounds"] + extra,
                   b=tiles * (a_state["ingests"] + len(backup_results)))
    same_as_a("(f)", eng)
    arms["(f) hedged stream"] = dict(
        wall_s=fed["wall_s"], hedges_launched=h.hedges_launched,
        hedges_won=h.hedges_won, p50_ms=pct(fed["lat"], 50),
        p99_ms=pct(fed["lat"], 99),
        launches={k: v for k, v in launches.items() if v})
    arms["near_ties"] = ties
    say(f"  queries that needed the near-tie rule: {ties or 'none'}")
    return {"arms": arms, "a": arms["(a) clean"]["launches"],
            "b": arms["(b) persistent"]["launches"]}


def phase_sharded(torch, cfg, ref, queries, host: dict, slab: dict) -> dict:
    """Sharded search at the main path's shapes, arms (a)-(c) of the module
    docstring."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.search import (
        ShardedExecutor,
        make_distributed_multi_search,
    )
    from repro_torch.search.resilient import executor_runner

    offline, l, nq = host["res"], cfg.query_len, cfg.n_queries
    tiles = len(ops.lb_query_tiles(nq, l))
    plan = cfg.make_plan()
    arms, ties = {}, {}
    say(f"[4 sharded] N={cfg.ref_len} l={l} w={cfg.window} Q={nq} "
        f"batch={cfg.batch}; (a), (c) on {SHARD_BACKEND}, (b) on gloo")

    # (a) a group of one, in this process: the host rounds' lockstep.
    dist.init_process_group(SHARD_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for gather, want, kernel in (
                ("fused", offline, "dtw_ea_multi_fused"),
                ("slab", types.SimpleNamespace(**slab["host_slab"]),
                 "dtw_ea_multi")):
            fn = make_distributed_multi_search(
                None, None, l, cfg.window, batch=cfg.batch,
                block_k=cfg.block_k, gather=gather, device=DEVICE)
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(ref, queries)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launches_now()
            rounds = int(res.rounds)
            bits = (torch.equal(res.best_start, want.best_start)
                    and torch.equal(res.best_dist, want.best_dist))
            label = f"(a) group of one, {gather}"
            say(f"  {label}: {wall:.3f} s wall (host rounds {gather} "
                f"{host['wall_s'] if gather == 'fused' else slab['host_slab_wall_s']:.3f} s); "
                f"rounds {rounds} (host rounds {int(want.rounds.max())}); "
                f"quarantined {int(res.quarantined)}; launches {launches}; "
                f"best_start {res.best_start.tolist()}; best_start and "
                f"best_dist the host rounds' bits: {bits}")
            want_launches = {k: 0 for k in KERNELS}
            want_launches.update({kernel: rounds,
                                  "lb_keogh_all_windows": tiles})
            check(launches == want_launches,
                  f"{label}: launches {launches}, expected {want_launches}")
            check(bits and rounds == int(want.rounds.max())
                  and int(res.quarantined) == int(offline.quarantined),
                  f"{label}: not the host rounds' bits and rounds")
            arms[label] = dict(wall_s=wall, rounds=rounds,
                               launches={k: v for k, v in launches.items()
                                         if v})

        # What the loop's collectives cost a round on the group of one: its
        # two all_reduces and its host read, alone, against the read alone.
        ub_t = torch.zeros(nq, device=DEVICE)
        flag = torch.zeros((), dtype=torch.int32, device=DEVICE)

        def rounds_of(collectives: bool):
            def run():
                for _ in range(SHARD_COLL_REPS):
                    if collectives:
                        dist.all_reduce(ub_t, op=dist.ReduceOp.MIN)
                        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    bool(flag)
            return host_ms(run) / SHARD_COLL_REPS

        coll_ms, read_ms = rounds_of(True), rounds_of(False)
        fused = arms["(a) group of one, fused"]
        fused.update(coll_ms_per_round=coll_ms, read_ms_per_round=read_ms)
        say(f"  (a) the loop's two all_reduces and host read, alone: "
            f"{coll_ms:.4f} ms a round (the host read alone {read_ms:.4f} "
            f"ms; mean of {SHARD_COLL_REPS}); fused wall less the host "
            f"rounds' {(fused['wall_s'] - host['wall_s']) * 1e3 / fused['rounds']:.4f}"
            f" ms a round")

        # (c) resilient_search over a ShardedExecutor of the group of one.
        recs = []
        ex = recorded(ShardedExecutor, recs)(None, None, ref, queries,
                                             device=DEVICE)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_c = cfg.resilient_search(ref, queries, device=DEVICE,
                                     n_ranges=RES_RANGES,
                                     runner=executor_runner(ex, plan))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
        rounds = sum(r["rounds"] for r in recs)
        say(f"  (c) resilient_search over a ShardedExecutor, {RES_RANGES} "
            f"ranges: {wall:.3f} s wall; {res_c.attempts} attempts, "
            f"coverage {res_c.coverage}; rounds {rounds} (a range's: "
            f"{[r['rounds'] for r in recs]}); a range "
            f"{[round(r['ms'], 1) for r in recs]} ms; quarantined "
            f"{res_c.quarantined}")
        check(res_c.coverage == 1.0 and res_c.attempts == RES_RANGES
              == len(recs) and len(ex._fns) == 1,
              "(c): the ranges were not each run once by one program")
        check(res_c.quarantined == int(offline.quarantined),
              "(c): quarantine differs from offline")
        check_launches("(c)", launches, a=rounds, b=tiles * RES_RANGES)
        check_winners(torch, "(c)", res_c.best_start, res_c.best_dist,
                      offline, ref, queries, cfg, ties)
        arms["(c) resilient over ShardedExecutor"] = dict(
            wall_s=wall, rounds=rounds, range_ms=[r["ms"] for r in recs],
            launches={k: v for k, v in launches.items() if v})
    finally:
        dist.destroy_process_group()

    # (b) a gloo group of SHARD_WORLD spawned ranks, all on this card.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--shard",
             json.dumps({"rank": r, "world": SHARD_WORLD,
                         "store": str(Path(d) / "store"), "device": DEVICE,
                         "cfg": dataclasses.asdict(cfg)})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(SHARD_WORLD)]
        outs = []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=SHARD_TIMEOUT)
                check(p.returncode == 0, f"(b): rank {r} failed "
                      f"(exit {p.returncode}): {err[-3000:]}")
                outs.append(json.loads(
                    [x for x in out.splitlines()
                     if x.startswith("SHARD ")][-1][len("SHARD "):]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_all = time.perf_counter() - t0
    label = f"(b) group of {SHARD_WORLD}, gloo, one card"
    for r, o in enumerate(outs):
        say(f"  {label}, rank {r}: {o['wall_s']:.3f} s wall; rounds "
            f"{o['rounds']}; launches {o['launches']}; shard "
            f"[{o['lo']}, {o['hi']}), quarantined {o['quarantined']}")
        check(o["launches"]["lb_keogh_all_windows"] == tiles
              and o["launches"]["dtw_ea_multi_fused"] >= o["rounds"] > 0,
              f"{label}, rank {r}: kernels A and B not launched as expected")
    check(all(o["best_start"] == outs[0]["best_start"]
              and o["best_dist"] == outs[0]["best_dist"]
              and o["rounds"] == outs[0]["rounds"]
              and o["launches"] == outs[0]["launches"] for o in outs),
          f"{label}: the ranks disagree (lockstep: the same launches too)")
    check(outs[0]["quarantined"] == int(offline.quarantined),
          f"{label}: quarantine differs from offline")
    bd = torch.tensor(outs[0]["best_dist"], dtype=torch.float32)
    say(f"  {label}: {wall_all:.3f} s from spawn to the last exit; "
        f"best_dist the host rounds' bits: "
        f"{torch.equal(bd, offline.best_dist.cpu())}")
    check_winners(torch, label, outs[0]["best_start"], bd, offline, ref,
                  queries, cfg, ties)
    arms[label] = dict(
        wall_s=max(o["wall_s"] for o in outs), wall_spawn_s=wall_all,
        rounds=outs[0]["rounds"],
        launches=[{k: v for k, v in o["launches"].items() if v}
                  for o in outs])
    arms["near_ties"] = ties
    say(f"  queries that needed the near-tie rule: {ties or 'none'}")
    return {"arms": arms,
            "a": arms["(a) group of one, fused"]["launches"],
            "a_slab": arms["(a) group of one, slab"]["launches"]}


def shard_worker(job: dict) -> int:
    """One rank of phase 4 sharded arm (b): ``job`` gives its ``rank`` of
    ``world``, the gloo group's file ``store``, the ``device`` and the
    parent's ``SearchConfig`` fields (``cfg``). It searches the main path's
    data (after a warm-up on its first ``SHARD_WARM_N`` samples) with its
    launches counted from 0, and prints one ``SHARD <json>`` line."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.search import make_distributed_multi_search

    rank, world, dev = job["rank"], job["world"], torch.device(job["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = SearchConfig(**job["cfg"])
    ref, queries = main_path_inputs(torch, cfg, dev)
    dist.init_process_group("gloo", init_method=f"file://{job['store']}",
                            rank=rank, world_size=world)
    try:
        fn = make_distributed_multi_search(
            None, None, cfg.query_len, cfg.window, batch=cfg.batch,
            block_k=cfg.block_k, device=dev)
        fn(ref[:SHARD_WARM_N], queries)
        zero_launches()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn(ref, queries)
        sync()
        wall = time.perf_counter() - t0
        n_win = cfg.ref_len - cfg.query_len + 1
        per = -(-n_win // world)
        print("SHARD " + json.dumps({
            "rank": rank, "wall_s": wall, "rounds": int(res.rounds),
            "best_start": res.best_start.tolist(),
            "best_dist": res.best_dist.tolist(),
            "quarantined": int(res.quarantined), "launches": launches_now(),
            "lo": rank * per, "hi": min((rank + 1) * per, n_win)}),
            flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def stream_inputs(cfg):
    """The stream cross-check's reference (``BASELINE_N`` samples), its
    ``STREAM_CROSS_Q`` queries and its arrival sizes."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries

    ref = make_dataset(DATASET, BASELINE_N, seed=0).astype(np.float32)
    qs = make_queries(DATASET, cfg.n_queries, cfg.query_len, seed=1)
    qs = qs[:STREAM_CROSS_Q].astype(np.float32)
    return ref, qs, arrival_sizes(BASELINE_N, STREAM_CROSS_ARRIVAL,
                                  STREAM_SEED)


def stream_run(cfg, dev: str) -> dict:
    """The stream cross-check's stream on ``dev``: ``StreamSearchEngine``
    fed ``stream_inputs``' arrivals; its answer, quarantine count, rounds
    and seconds."""
    from repro_torch.serve import StreamSearchEngine

    ref, qs, sizes = stream_inputs(cfg)
    t0 = time.perf_counter()
    eng = StreamSearchEngine(qs, cfg.query_len, cfg.window, batch=cfg.batch,
                             stream_chunk=cfg.stream_chunk, device=dev)
    i = 0
    for c in sizes:
        eng.ingest(ref[i:i + c])
        i += c
    bs, bd = eng.best()
    return {"best_start": bs.tolist(), "best_dist": bd.tolist(),
            "quarantined": int(eng.quarantined_windows),
            "rounds": int(eng.rounds), "s": time.perf_counter() - t0}


def phase_stream_cross(torch, cfg, cpu: dict) -> None:
    """A stream on the card against the same stream on the CPU (``cpu``,
    from ``cpu_ref_worker``), then ``ea_search_round`` and the full-row
    ``ea_pruned_dtw``."""
    from repro_torch.core import ea_pruned_dtw, ea_search_round
    from repro_torch.core.lower_bounds import (
        cascade_keogh_cumulative,
        envelope,
    )
    from repro_torch.search.znorm import znorm

    ref, qs, sizes = stream_inputs(cfg)
    g, h = stream_run(cfg, DEVICE), cpu
    rel = rel_err(torch.tensor(g["best_dist"]), torch.tensor(h["best_dist"]))
    say(f"[5 stream cross-check] N={BASELINE_N} l={cfg.query_len} "
        f"Q={STREAM_CROSS_Q} stream_chunk={cfg.stream_chunk}, {len(sizes)} "
        f"arrivals: card {g['s']:.2f} s, cpu {h['s']:.2f} s; best_start "
        f"{g['best_start']} (cpu {h['best_start']}); rounds {g['rounds']} "
        f"({h['rounds']}); best_dist max rel err {rel:.3e} "
        f"(tol {TOL_CROSS})")
    check(g["best_start"] == h["best_start"],
          "stream: best_start differs between card and CPU")
    check(g["quarantined"] == h["quarantined"],
          "stream: quarantine counts differ")
    check(rel <= TOL_CROSS, "stream: distances differ")

    # ea_search_round: one slab round (kernel D) and its fold, at l = 1024
    # on the reference's first 256 windows.
    l, w = cfg.query_len, cfg.window
    wins = torch.as_tensor(ref).unfold(0, l, 1)[:256].contiguous()
    cand = znorm(wins)
    q = znorm(torch.as_tensor(qs[0]))
    u, low = envelope(q, w)
    cb = cascade_keogh_cumulative(cand, u, low)
    idx = torch.arange(256)
    cold = ea_search_round(q, cand, 1e30, -1, idx, w, cb=cb)[0]
    res = {}
    for dev in (DEVICE, "cpu"):  # cold, and an ub that most lanes exceed
        res[dev] = [ea_search_round(q.to(dev), cand.to(dev), ub, -1,
                                    idx.to(dev), w, cb=cb.to(dev))
                    for ub in (1e30, float(cold) * 1.05)]
    for (gu, gb), (hu, hb) in zip(res[DEVICE], res["cpu"]):
        r = abs(float(gu) / float(hu) - 1)
        say(f"  ea_search_round: card ({float(gu)!r}, {int(gb)}), cpu "
            f"({float(hu)!r}, {int(hb)}), rel err {r:.3e} (tol {TOL_CROSS})")
        check(int(gb) == int(hb) and r <= TOL_CROSS,
              "ea_search_round differs between card and CPU")
    # The full-row ea_pruned_dtw: the paper's example, then two windows at
    # l = 1024 with and without the window, above and below their DTW.
    s_p = torch.tensor([3, 1, 4, 4, 1, 1], dtype=torch.float64)
    t_p = torch.tensor([1, 3, 2, 1, 2, 2], dtype=torch.float64)
    d9 = float(ea_pruned_dtw(s_p.to(DEVICE), t_p.to(DEVICE), 9.0))
    d6, info6 = ea_pruned_dtw(s_p.to(DEVICE), t_p.to(DEVICE), 6.0,
                              with_info=True)
    say(f"  ea_pruned_dtw, the paper's example on the card: ub 9 -> {d9}, "
        f"ub 6 -> {float(d6)} after {int(info6.rows)} rows")
    check(d9 == 9.0 and float(d6) == float("inf") and int(info6.rows) == 5,
          "ea_pruned_dtw: the paper's example")
    a, b = cand[0], cand[37]
    for win in (w, None):
        full = float(ea_pruned_dtw(a, b, 1e30, window=win))
        for ub in (full * 1.01, full * 0.99):
            gd, gi = ea_pruned_dtw(a.to(DEVICE), b.to(DEVICE), ub,
                                   window=win, with_info=True)
            hd, hi = ea_pruned_dtw(a, b, ub, window=win, with_info=True)
            same = (float(gd) == float(hd) == float("inf")
                    or abs(float(gd) / float(hd) - 1) <= TOL_CROSS)
            say(f"  ea_pruned_dtw l={l} window={win} ub={ub:.4f}: card "
                f"{float(gd)!r} ({int(gi.rows)} rows, {int(gi.cells)} cells)"
                f", cpu {float(hd)!r} ({int(hi.rows)}, {int(hi.cells)})")
            check(same, "ea_pruned_dtw differs between card and CPU")


def search_result(res, t0: float) -> dict:
    """A search's answer as plain numbers (a cross-check's half), with the
    seconds since ``t0``."""
    return {"best_start": res.best_start.tolist(),
            "best_dist": res.best_dist.tolist(),
            "quarantined": int(res.quarantined),
            "s": time.perf_counter() - t0}


def cross_runs(dev: str) -> dict:
    """Phase 5's cross-check searches on ``dev``: ``multi_query_search`` at
    ``CROSS`` for both drivers and both EA variants, by label."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.search import multi_query_search

    c = CROSS
    ref = make_dataset(DATASET, c["ref_len"], seed=0).astype(np.float32)
    qs = make_queries(DATASET, c["n_queries"], c["query_len"], seed=1)
    qs = qs.astype(np.float32)
    out = {}
    for rounds in ("host", "persistent"):
        for variant in ("eapruned", "eapruned_nolb"):
            t0 = time.perf_counter()
            out[f"{rounds} {variant}"] = search_result(multi_query_search(
                ref, qs, c["query_len"], c["window"], variant=variant,
                batch=256, rounds=rounds, device=dev), t0)
    return out


def phase_cross_check(torch, cpu: dict) -> None:
    """``cross_runs`` on the card against ``cpu``, the same runs on the CPU
    (``cpu_ref_worker``): ``best_start`` and quarantine counts equal,
    distances within ``TOL_CROSS``."""
    card = cross_runs(DEVICE)
    for label, g in card.items():
        h = cpu[label]
        for dev, r in ((DEVICE, g), ("cpu", h)):
            say(f"[5 cross-check] {label} {dev}: {r['s']:.2f} s, best_start "
                f"{r['best_start']}")
        check(g["best_start"] == h["best_start"],
              f"{label}: best_start differs between card and CPU")
        check(g["quarantined"] == h["quarantined"],
              f"{label}: quarantine counts differ")
        rel = rel_err(torch.tensor(g["best_dist"]), torch.tensor(h["best_dist"]))
        say(f"  {label}: best_dist max rel err {rel:.3e} "
            f"(tol {TOL_CROSS})")
        check(rel <= TOL_CROSS, f"{label}: distances differ")


def cpu_ref_worker(job: dict) -> int:
    """Phase 5's CPU halves (``cross_runs``, ``stream_run`` and
    ``wide_cross_run`` with ``device="cpu"``), on ``job["threads"]``
    threads; prints one ``RESULT <json>`` line. The script runs it beside
    the card's phases that time nothing, since it needs no card."""
    import torch

    from repro_torch.configs.dtw_search import SearchConfig

    torch.set_num_threads(job["threads"])
    res = {"cross": cross_runs("cpu"),
           "stream": stream_run(SearchConfig(), "cpu"),
           "wide": wide_cross_run("cpu", "host")}
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def exact_distances(torch, ref, query, window: int, chunk: int = 4096):
    """The DTW distance of ``query`` to every z-normalized window of ``ref``
    in float64 on the card: windows and query normalized in float64,
    ``core.dtw.dtw_batch`` on ``chunk`` windows at a time."""
    from repro_torch.core.common import EPS
    from repro_torch.core.dtw import dtw_batch

    length = len(query)
    wins = torch.as_tensor(ref, dtype=torch.float64, device=DEVICE)
    wins = wins.unfold(0, length, 1)
    q = torch.as_tensor(query, dtype=torch.float64, device=DEVICE)
    q = (q - q.mean()) / q.std(correction=0).clamp_min(EPS)
    out = []
    for lo in range(0, wins.shape[0], chunk):
        w = wins[lo:lo + chunk]
        w = (w - w.mean(1, keepdim=True)) / w.std(
            1, keepdim=True, correction=0).clamp_min(EPS)
        out.append(dtw_batch(q.expand(w.shape[0], -1), w, window=window))
    return torch.cat(out).cpu()


def phase_baselines(torch, cfg) -> None:
    """The paper's four suites through ``subsequence_search`` under both
    drivers, the host rounds with counters, at the main path's l and w on a
    reference cut to ``BASELINE_N``, with rows and cells in the order
    ``eapruned <= pruned <= full``; the baselines launch no DTW kernel.
    The DP differs between the suites: the EA suites run the kernels'
    banded row, ``full`` and ``pruned`` ``repro``'s full-row closed form,
    whose float32 prefix sum over 1024 columns carries ~3e-4 of a distance
    (two windows closer than that can change places). So the runs of each
    DP must agree on ``best_start``, and every run's winner must be a
    nearest window up to ``TOL_A``: its DTW in float64 within ``TOL_A`` of
    the float64 brute-force minimum, and its ``best_dist`` within ``TOL_A``
    of it. Then ``full`` and ``pruned`` on the card against the CPU at
    ``BASELINE_CROSS``."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.search import subsequence_search
    from repro_torch.search.pipeline import VARIANTS

    ref = make_dataset(DATASET, BASELINE_N, seed=0).astype(np.float32)
    query = make_queries(DATASET, 1, cfg.query_len, seed=1)[0]
    query = query.astype(np.float32)
    say(f"[5 baselines] the four suites, l={cfg.query_len} w={cfg.window} "
        f"batch={cfg.batch}, on a reference cut to N={BASELINE_N} from the "
        f"main path's {cfg.ref_len} (the baselines run a DP row as about a "
        f"dozen PyTorch launches)")
    out = {}
    for rounds in ("host", "persistent"):
        for variant in VARIANTS:
            for name in KERNELS:
                getattr(ops, name).launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = subsequence_search(
                ref, query, cfg.query_len, cfg.window, variant=variant,
                batch=cfg.batch, block_k=cfg.block_k, rounds=rounds,
                with_info=rounds == "host", device=DEVICE,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: getattr(ops, n).launches for n in KERNELS
                        if getattr(ops, n).launches}
            say(f"  {rounds} {variant}: {wall:.3f} s; best_start "
                f"{int(res.best_start)} best_dist {float(res.best_dist)!r} "
                f"rounds {int(res.rounds)} lanes {int(res.lanes)} rows "
                f"{int(res.rows)} cells {int(res.cells)}; launches {launches}")
            if variant in ("full", "pruned"):
                check(set(launches) <= {"lb_keogh_all_windows"},
                      f"{rounds} {variant} launched a DTW kernel")
            out[rounds, variant] = res
    # The nearest neighbour by brute force in float64: every window's DTW
    # (core.dtw on float64 windows normalized in float64).
    exact = exact_distances(torch, ref, query, cfg.window)
    nn = int(exact.argmin())
    ea = {int(out[k].best_start) for k in out if k[1].startswith("eapruned")}
    base = {int(out[k].best_start) for k in out if k[1] in ("full", "pruned")}
    say(f"  brute force in float64: nearest window {nn} at {float(exact[nn])!r};"
        f" best_start of the EA suites {ea}, of full and pruned {base}")
    check(len(ea) == 1 and len(base) == 1,
          "the runs of one DP (the kernels', or full/pruned's) disagree")
    for (rounds, variant), res in out.items():
        s = int(res.best_start)
        gap = float(exact[s] / exact[nn] - 1)
        rel = abs(float(res.best_dist) / float(exact[s]) - 1)
        say(f"  {rounds} {variant}: window {s} at {float(exact[s])!r} in "
            f"float64, {gap:.3e} above the nearest; best_dist {rel:.3e} off "
            f"its float64 distance (tol {TOL_A} each)")
        check(gap <= TOL_A and rel <= TOL_A,
              f"{rounds} {variant}: not a nearest window up to float32 "
              "rounding")
    for f in ("rows", "cells"):
        v = [int(getattr(out["host", k], f))
             for k in ("eapruned", "pruned", "full")]
        check(0 < v[0] <= v[1] <= v[2], f"{f} not in the order "
              f"eapruned <= pruned <= full: {v}")

    c = BASELINE_CROSS
    ref = make_dataset(DATASET, c["ref_len"], seed=0).astype(np.float32)
    query = make_queries(DATASET, 1, c["query_len"], seed=1)[0]
    query = query.astype(np.float32)
    for variant in ("full", "pruned"):
        for rounds in ("host", "persistent"):
            res = {}
            for dev in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                res[dev] = subsequence_search(
                    ref, query, c["query_len"], c["window"], variant=variant,
                    batch=cfg.batch, rounds=rounds,
                    with_info=rounds == "host", device=dev,
                )
                torch.cuda.synchronize()
                res[dev] = {k: float(v) for k, v in res[dev]._asdict().items()}
                res[dev]["s"] = time.perf_counter() - t0
            g, h = res[DEVICE], res["cpu"]
            rel = abs(g["best_dist"] - h["best_dist"]) / max(h["best_dist"], 1)
            say(f"[5 baselines cross-check] {variant} {rounds} "
                f"N={c['ref_len']} l={c['query_len']}: card {g['s']:.2f} s, "
                f"cpu {h['s']:.2f} s; best_start {g['best_start']:.0f} "
                f"(cpu {h['best_start']:.0f}), best_dist rel err {rel:.3e} "
                f"(tol {TOL_CROSS}); rounds {g['rounds']:.0f} "
                f"({h['rounds']:.0f}), rows {g['rows']:.0f} ({h['rows']:.0f}),"
                f" cells {g['cells']:.0f} ({h['cells']:.0f}), shown")
            check(g["best_start"] == h["best_start"],
                  f"{variant} {rounds}: best_start differs card and CPU")
            check(g["quarantined"] == h["quarantined"],
                  f"{variant} {rounds}: quarantine counts differ")
            check(rel <= TOL_CROSS, f"{variant} {rounds}: distances differ")


def bound_by(cells: int, bound: float) -> str:
    """Which of the two times sets a DTW kernel's bound."""
    return ("operations" if FLOPS_PER_CELL * cells / PEAK_FP32 * 1e3 >= bound
            else "bytes")


def dtw_bound_ms(cells: int, nbytes: int) -> float:
    """The least time for a DTW kernel's work: ``FLOPS_PER_CELL`` per
    evaluated cell at the FP32 peak, or its bytes at the HBM peak."""
    return max(FLOPS_PER_CELL * cells / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def time_kernel_b(torch, kb: dict, tag: str) -> tuple[float, float, float]:
    """Kernel B on phase 3's inputs ``kb``, by CUDA events, beside its plain
    version and its bound: ``(ms, plain ms, bound ms)``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lb_keogh import lb_all_windows_plain

    args, valid = kb["args"], kb["valid"]
    ref, mu, sigma, upper, lower, qends, length = args
    nq, n_win = upper.shape[0], mu.shape[0]
    b_ms = cuda_ms(lambda: ops.lb_keogh_all_windows(*args, valid=valid), 5)
    b_plain = host_ms(lambda: lb_all_windows_plain(*args, valid=valid))
    terms = nq * int(valid.sum()) * length
    b_ops = FLOPS_PER_LB_TERM * terms
    b_bytes = 4 * (ref.numel() + 2 * n_win + 2 * nq * length + 2 * nq
                   + nq * n_win) + n_win
    b_bound = max(b_ops / PEAK_FP32, b_bytes / PEAK_BYTES) * 1e3
    by = "operations" if b_ops / PEAK_FP32 >= b_bytes / PEAK_BYTES else "bytes"
    say(f"{tag}: {b_ms:.3f} ms (plain {b_plain:.1f} ms), bound "
        f"{b_bound:.3f} ms by {by} ({b_ops:.3e} flops), "
        f"{100 * b_bound / b_ms:.2f}% of the bound, "
        f"{b_ms * 1e6 / terms:.4g} ns a (query, window, offset) term; tiles "
        f"{ops.lb_query_tiles(nq, length)}; registers a thread by query tile "
        f"(ptxas) {lb_registers() or 'not built in this run'}")
    return b_ms, b_plain, b_bound


def time_kernel_a(torch, ka: dict, tag: str) -> tuple[list, list, list, list]:
    """Kernel A on phase 3's rounds ``ka``, counter-free and with counters,
    by CUDA events, beside its plain version and its bound: a list of one
    entry a round each of ms, ms with counters, plain ms and bound ms."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_fused_plain

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a_ms, a_info, a_plain, a_bound = [], [], [], []
    for i, r in enumerate(ka["rounds"]):
        a_ms.append(cuda_ms(lambda: ops.dtw_ea_multi_fused(*r["args"], **r["env"]), 5))
        a_info.append(cuda_ms(lambda: ops.dtw_ea_multi_fused(
            *r["args"], with_info=True, **r["env"]), 5))
        a_plain.append(host_ms(lambda: dtw_ea_fused_plain(*r["args"], r["bw"], **r["env"])))
        m = r["args"][-1]
        nbytes = 4 * (r["lanes"] * (m + 5) + 3 * r["args"][0].numel())
        a_bound.append(dtw_bound_ms(r["cells"], nbytes))
        say(f"{tag} round {i}: {a_ms[-1]:.3f} ms, with counters "
            f"{a_info[-1]:.3f} ms (plain {a_plain[-1]:.1f} ms), "
            f"bound {a_bound[-1]:.4f} ms ({r['cells']} cells, "
            f"{bound_by(r['cells'], a_bound[-1])}); {r['rows']} DP "
            f"rows, {a_ms[-1] * 1e6 * sms / r['rows']:.1f} ns of one SM a row")
    return a_ms, a_info, a_plain, a_bound


def phase_times(torch, kb: dict, ka: dict, kd: dict, kce: dict,
                loop: dict) -> list[dict]:
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import dtw_ea_plain

    b_ms, b_plain, b_bound = time_kernel_b(torch, kb, "[6 times] kernel B")
    a_ms, a_info, a_plain, a_bound = time_kernel_a(torch, ka, "  kernel A")

    # Kernel D: the three rounds' slabs with the host cb slab; each lane
    # reads its window and cb rows (2m floats) and its ub, writes one float.
    d_ms, d_info, d_plain, d_bound = [], [], [], []
    for i, r in enumerate(kd["rounds"]):
        args, cb = r["args"], r["cb"]
        d_ms.append(cuda_ms(lambda: ops.dtw_ea_multi(*args, cb=cb), 5))
        d_info.append(cuda_ms(lambda: ops.dtw_ea_multi(*args, cb=cb,
                                                       with_info=True), 5))
        d_plain.append(host_ms(lambda: dtw_ea_plain(*args, r["bw"], cb=cb)))
        m = args[1].shape[-1]
        nbytes = 4 * (r["lanes"] * (2 * m + 2) + args[0].numel())
        d_bound.append(dtw_bound_ms(r["cells"], nbytes))
        say(f"  kernel D round {i}: {d_ms[-1]:.3f} ms, with counters "
            f"{d_info[-1]:.3f} ms (plain {d_plain[-1]:.1f} ms), "
            f"bound {d_bound[-1]:.4f} ms ({r['cells']} cells)")

    # Kernels C and E: the cold sweep of each query's whole order (phase 3).
    # The bound counts the least work of any best-first sweep, and each
    # lane of it reads its inputs once: C its window of the reference and
    # four descriptors, E its slab row and two.
    m, live = kce["length"], kce["live"]
    fixed = 4 * kce["env_floats"]
    c_ms, e_ms = kce["c_ms"], kce["e_ms"]
    c_plain, e_plain = kce["c_plain_ms"], kce["e_plain_ms"]
    c_bound = dtw_bound_ms(kce["cells"], fixed + 4 * live * (m + 4))
    e_bound = dtw_bound_ms(kce["cells"], fixed + 4 * live * (m + 2))
    say(f"  kernel C (whole order): {c_ms:.3f} ms (plain {c_plain:.1f} ms), "
        f"bound {c_bound:.4f} ms ({kce['cells']} cells)")
    say(f"  kernel E (whole order): {e_ms:.3f} ms (plain {e_plain:.1f} ms), "
        f"bound {e_bound:.4f} ms")
    mean = lambda xs: sum(xs) / len(xs)
    say(f"  counter variants: A {mean(a_info):.4f} ms against "
        f"{mean(a_ms):.4f} ms ({100 * (mean(a_info) / mean(a_ms) - 1):+.2f}%)"
        f", D {mean(d_info):.4f} ms against {mean(d_ms):.4f} ms "
        f"({100 * (mean(d_info) / mean(d_ms) - 1):+.2f}%)")
    shares = {"A": mean(a_bound) / mean(a_ms), "D": mean(d_bound) / mean(d_ms),
              "C": c_bound / c_ms, "E": e_bound / e_ms}
    say("  share of the bound (bound ms / ms): " + ", ".join(
        f"kernel {k} {100 * v:.2f}%" for k, v in shares.items()))
    for k in ("C", "E"):
        say(f"  kernel {k}: {kce['in_flight'][k]} lanes in flight; lanes run "
            f"per query (cold whole-order sweep): {kce['ran'][k]}")
    say(f"  host rounds: {loop['launches']} rounds, wall per round less "
        f"kernel A {loop['loop_ms_per_round']:.4f} ms, kernel A "
        f"{loop['a_ms'] / loop['launches']:.4f} ms a round")
    return [
        {"name": "dtw_ea_multi_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_fused.cu",
         "replaces": "src/repro/kernels/dtw_band.py:411",
         "max_abs_err": ka["max_abs_err"], "ms": mean(a_ms),
         "plain_ms": mean(a_plain), "bound_ms": mean(a_bound),
         "bound_by": "operations", "library_ms": None,
         "info_ms": mean(a_info)},
        {"name": "lb_keogh_all_windows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lb_keogh.cu",
         "replaces": "src/repro/kernels/lb_keogh.py:19",
         "max_abs_err": kb["max_abs_err"], "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": b_bound, "bound_by": "operations", "library_ms": None,
         "info_ms": None},
        {"name": "dtw_ea_persistent_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_persistent.cu",
         "replaces": "src/repro/kernels/dtw_band.py:479",
         "max_abs_err": kce["max_abs_err"], "ms": c_ms, "plain_ms": c_plain,
         "bound_ms": c_bound, "bound_by": bound_by(kce["cells"], c_bound),
         "library_ms": None, "info_ms": None},
        {"name": "dtw_ea_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_slab.cu",
         "replaces": "src/repro/kernels/dtw_band.py:370",
         "max_abs_err": kd["max_abs_err"], "ms": mean(d_ms),
         "plain_ms": mean(d_plain), "bound_ms": mean(d_bound),
         "bound_by": "operations", "library_ms": None,
         "info_ms": mean(d_info)},
        {"name": "dtw_ea_persistent", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_ea_persistent.cu",
         "replaces": "src/repro/kernels/dtw_band.py:479",
         "max_abs_err": kce["max_abs_err"], "ms": e_ms, "plain_ms": e_plain,
         "bound_ms": e_bound, "bound_by": bound_by(kce["cells"], e_bound),
         "library_ms": None, "info_ms": None},
    ]


# ----------------------------- phase 7: LM serving --------------------------


def lm_recorder(torch, model, rec: dict, keep_logits: bool = True):
    """``model`` with ``prefill`` and ``decode_step`` wrapped: a pair of
    CUDA events around each call goes to ``rec["prefill"]`` or
    ``rec["decode"]`` and, with ``keep_logits``, its last-position logits
    to ``rec["logits"]`` (float32, (B, V)). Records only, never
    synchronizes."""
    rec.update(logits=[], prefill=[], decode=[])

    def wrap(fn, key):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = fn(*args, **kw)
            stop.record()
            rec[key].append((start, stop))
            if keep_logits:
                rec["logits"].append(logits[:, -1].float())
            return logits, cache
        return run

    return model._replace(prefill=wrap(model.prefill, "prefill"),
                          decode_step=wrap(model.decode_step, "decode"))


def lm_generate(torch, model, params, prompt, new: int) -> dict:
    """``new`` greedy tokens after ``prompt`` through ``generate``, twice
    at the same shapes. The first run keeps the logits each token was
    chosen from (B, new, V) and warms the allocator and cuBLAS; the
    second is timed, keeps no logits and says prefill ms and decode ms a
    token (CUDA events), the wall, and its allocation peak."""
    from repro_torch.serve.generate import generate

    rec: dict = {}
    out = generate(lm_recorder(torch, model, rec), params, prompt, new)
    logits = torch.stack(rec["logits"], 1)
    torch.cuda.synchronize()
    timed = lm_recorder(torch, model, rec, keep_logits=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    generate(timed, params, prompt, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode = [a.elapsed_time(b) / 1e3 for a, b in rec["decode"]]  # s
    b = prompt.shape[0]
    return {
        "tokens": out, "logits": logits,
        "prefill_ms": rec["prefill"][0][0].elapsed_time(rec["prefill"][0][1]),
        "decode_ms_p50": pct(decode, 50), "decode_ms_p99": pct(decode, 99),
        "decode_steps": len(decode), "wall_s": wall,
        "tokens_per_s": b * new / wall,
        "decode_tokens_per_s": b * 1e3 / pct(decode, 50),
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }


def lm_device_busy(torch, model, params, prompt) -> dict:
    """The device's side of one prefill of ``prompt`` and of the
    LM_PROFILE_STEPS decode steps after it, by ``torch.profiler``: the
    CUDA kernels' (and copies') summed time and number, a step for decode;
    for the prefill also that time by kind of kernel (``lm_op_kind``) and
    its LM_TOP_OPS costliest kernels; None where the profiler saw no
    device activity."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    def device_events(prof):
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    b, s = prompt.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        cache = model.init_cache(b, s + LM_PROFILE_STEPS, device=DEVICE)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            logits, cache = model.prefill(params, cache, tokens=prompt)
            torch.cuda.synchronize()
        pre = device_events(prof)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        with profile(activities=acts) as prof:
            for i in range(LM_PROFILE_STEPS):
                logits, cache = model.decode_step(params, cache, tok, s + i)
            torch.cuda.synchronize()
        dec = device_events(prof)
    out = {"device_ms_a_step": None, "device_ops_a_step": None,
           "prefill_device_ms": None, "prefill_device_ops": None,
           "prefill_kinds_ms": None, "prefill_top_ops_ms": None}
    if dec:
        busy_us = sum(e.time_range.elapsed_us() for e in dec)
        out.update(device_ms_a_step=busy_us / 1e3 / LM_PROFILE_STEPS,
                   device_ops_a_step=len(dec) / LM_PROFILE_STEPS)
    if pre:
        by_name: Counter = Counter()
        by_kind: Counter = Counter()
        for e in pre:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:LM_OP_NAME]] += ms
            by_kind[lm_op_kind(e.name)] += ms
        out.update(prefill_device_ms=sum(by_name.values()),
                   prefill_device_ops=len(pre),
                   prefill_kinds_ms=dict(by_kind.most_common()),
                   prefill_top_ops_ms=dict(by_name.most_common(LM_TOP_OPS)))
    return out


def lm_op_kind(name: str) -> str:
    """A CUDA kernel's kind, from its name: "matmul" (cuBLAS's and
    CUTLASS's), "softmax", "reduce", "copy", "elementwise" or "other"."""
    low = name.lower()
    for kind, marks in (("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                        ("softmax", ("softmax",)),
                        ("reduce", ("reduce",)),
                        ("copy", ("memcpy", "memset", "copy"))):
        if any(m in low for m in marks):
            return kind
    return "elementwise" if "elementwise" in low else "other"


def lm_bf16_scores(q, k):
    """The control for the float32 score product: ``attention._scores``
    with the product left in q's and k's bfloat16."""
    import torch

    return torch.einsum("bskgh,btkh->bkgst", q, k).float()


def lm_scores_check(torch, cfg, prompt_len: int, total: int) -> dict:
    """``attention._scores`` on seeded bfloat16 q and k at the shapes of
    arm (a)'s prefill (S = T = ``prompt_len``) and last decode step (S =
    1, T = ``total``) against the float64 product: the largest error over
    the largest |score| within TOL_LM_SCORES, and the control
    (``lm_bf16_scores``) beyond it."""
    from repro_torch.models import attention

    g = cfg.n_heads // cfg.n_kv
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    out = {}
    for label, s, t in (("prefill", prompt_len, prompt_len),
                        ("decode", 1, total)):
        q = torch.randn((LM_BATCH, s, cfg.n_kv, g, cfg.head_dim),
                        generator=gen, device=DEVICE).bfloat16()
        k = torch.randn((LM_BATCH, t, cfg.n_kv, cfg.head_dim),
                        generator=gen, device=DEVICE).bfloat16()
        ref = torch.einsum("bskgh,btkh->bkgst", q.double(), k.double())
        scale = float(ref.abs().max())
        for arm, fn in (("", attention._scores), ("control_", lm_bf16_scores)):
            err = float((fn(q, k).double() - ref).abs().max()) / scale
            out[f"{arm}{label}_rel_err"] = err
        del q, k, ref
    say(f"[7 lm serve] (a) score product against float64, largest error "
        f"over the largest |score|: prefill {out['prefill_rel_err']:.3g}, "
        f"decode {out['decode_rel_err']:.3g} (tol {TOL_LM_SCORES}); the "
        f"control in bfloat16 {out['control_prefill_rel_err']:.3g}, "
        f"{out['control_decode_rel_err']:.3g}")
    for label in ("prefill", "decode"):
        check(out[f"{label}_rel_err"] <= TOL_LM_SCORES,
              f"the {label} score product is not float32")
        check(out[f"control_{label}_rel_err"] > TOL_LM_SCORES,
              f"the {label} score check cannot tell bfloat16 from float32")
    return out


def lm_control(torch, model, params, prompt, new: int) -> dict:
    """Arm (a)'s generation again with the score product left in
    bfloat16 (``lm_bf16_scores`` in place of ``attention._scores``): the
    control for the float32 gap."""
    from repro_torch.models import attention
    from repro_torch.serve.generate import generate

    rec: dict = {}
    scores = attention._scores
    attention._scores = lm_bf16_scores
    try:
        out = generate(lm_recorder(torch, model, rec), params, prompt, new)
    finally:
        attention._scores = scores
    return {"tokens": out, "logits": torch.stack(rec["logits"], 1)}


def lm_hold(torch, label, model, cfg, params, gen: dict,
            control: dict | None = None) -> dict:
    """Hold a bfloat16 generation to teacher-forced forwards over the
    generated sequence: the decode logits against the bfloat16 forward
    (within TOL_LM_BF16) and against a float32 copy of the same weights
    (within TOL_LM_F32), and each greedy token's float32 logit within
    TOL_LM_TIE of its row's float32 maximum (the near-tie rule: bfloat16
    rounding may pick a token the float32 model ranks a near second).
    ``control``, a generation with the score product in bfloat16, is held
    to the float32 copy too, and its gap reported."""
    import copy
    import dataclasses

    from repro_torch.models.registry import build

    def rows(g):
        out, logits = g["tokens"], g["logits"]
        s = out.shape[1] - logits.shape[1]
        return out, logits, s, slice(s - 1, out.shape[1] - 1)

    out, logits, s, sel = rows(gen)
    with torch.no_grad():
        fwd, _ = model.forward(params, tokens=out[:, :-1])
        bf16_err = float((fwd[:, sel].float() - logits).abs().max())
        del fwd
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = build(cfg32)
        params32 = copy.deepcopy(params).float()
        f32, _ = model32.forward(params32, tokens=out[:, :-1])
        f32 = f32[:, sel].float()
        control_err = None
        if control is not None:
            c_out, c_logits, _, c_sel = rows(control)
            c32, _ = model32.forward(params32, tokens=c_out[:, :-1])
            control_err = float((c32[:, c_sel].float() - c_logits).abs().max())
            del c32
        del params32
    f32_err = float((f32 - logits).abs().max())
    chosen = torch.gather(f32, -1, out[:, s:, None])[..., 0]
    short = f32.amax(-1) - chosen
    worst = float(short.max())
    exact = int((short == 0).sum())
    n = short.numel()
    del f32
    torch.cuda.empty_cache()
    ctrl = ("" if control_err is None else
            f" (the control, scores in bfloat16: {control_err:.4g})")
    say(f"[7 lm serve] {label}: decode against the bfloat16 forward max abs "
        f"{bf16_err:.4g} (tol {TOL_LM_BF16}); against the float32 forward max "
        f"abs {f32_err:.4g} (tol {TOL_LM_F32}){ctrl}; greedy tokens the "
        f"float32 argmax {exact}/{n}, the rest within {worst:.4g} of it "
        f"(tol {TOL_LM_TIE})")
    check(bf16_err <= TOL_LM_BF16,
          f"{label}: bfloat16 decode differs from the bfloat16 forward")
    check(f32_err <= TOL_LM_F32,
          f"{label}: bfloat16 decode strays from the float32 forward")
    check(worst <= TOL_LM_TIE,
          f"{label}: a greedy token is no near tie of the float32 argmax")
    return {"decode_vs_bf16_forward_max_abs": bf16_err,
            "decode_vs_f32_forward_max_abs": f32_err,
            "control_bf16_scores_vs_f32_forward_max_abs": control_err,
            "greedy_f32_argmax": exact, "greedy_tokens": n,
            "greedy_f32_worst_shortfall": worst}


def lm_full(torch, arch: str):
    """Arms (a) and (c): ``arch`` at full width in bfloat16 from a seeded
    generator on the card, LM_BATCH x LM_PROMPT prompts plus LM_NEW greedy
    tokens through ``generate``, held by ``lm_hold``; for an attention
    arch, the score product checked and the control run."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build

    cfg = ARCHS[arch]
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED),
                        DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompt = torch.as_tensor(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=DEVICE)
    gen = lm_generate(torch, model, params, prompt, LM_NEW)
    say(f"[7 lm serve] {arch}: {n:,} parameters, {nbytes / 1e9:.3f} GB of "
        f"{cfg.dtype} weights, initialized in {init_s:.2f} s; "
        f"{LM_BATCH} x {LM_PROMPT} prompt tokens + {LM_NEW} new: prefill "
        f"{gen['prefill_ms']:.2f} ms, decode {gen['decode_ms_p50']:.3f} ms a "
        f"token (p50), {gen['decode_ms_p99']:.3f} ms (p99) over "
        f"{gen['decode_steps']} steps; generate {gen['wall_s']:.3f} s, "
        f"{gen['tokens_per_s']:.1f} tokens/s ({gen['decode_tokens_per_s']:.1f} "
        f"tokens/s in decode at p50); peak {gen['peak_bytes'] / 1e9:.3f} GB "
        f"(timed warm, logits kept by the untimed run before)")
    check(tuple(gen["tokens"].shape) == (LM_BATCH, LM_PROMPT + LM_NEW),
          f"{arch}: generate returned {tuple(gen['tokens'].shape)}")
    check(bool(torch.equal(gen["tokens"][:, :LM_PROMPT], prompt)),
          f"{arch}: generate changed the prompt")
    check(bool(torch.isfinite(gen["logits"]).all()), f"{arch}: non-finite logits")
    busy = lm_device_busy(torch, model, params, prompt)
    share = (None if busy["device_ms_a_step"] is None
             else busy["device_ms_a_step"] / gen["decode_ms_p50"])
    say(f"[7 lm serve] {arch}: torch.profiler over {LM_PROFILE_STEPS} decode "
        f"steps: device busy {busy['device_ms_a_step']} ms a step "
        f"({busy['device_ops_a_step']} kernels and copies a step), "
        f"{'not measured' if share is None else f'{100 * share:.1f}%'} of "
        f"the p50 step; over one prefill: device busy "
        f"{busy['prefill_device_ms']} ms in {busy['prefill_device_ops']} "
        f"kernels and copies, by kind {busy['prefill_kinds_ms']}, the "
        f"costliest {busy['prefill_top_ops_ms']}")
    arm = {"params": n, "weight_bytes": nbytes, "init_s": init_s}
    control = None
    if cfg.family in ("dense", "moe", "vlm"):
        arm["scores"] = lm_scores_check(torch, cfg, LM_PROMPT,
                                        LM_PROMPT + LM_NEW)
        control = lm_control(torch, model, params, prompt, LM_NEW)
    held = lm_hold(torch, arch, model, cfg, params, gen, control)
    arm.update({k: v for k, v in gen.items() if k not in ("tokens", "logits")},
               **busy, device_busy_share=share, **held)
    return arm, model, params, gen


def lm_chunked(torch, model, params) -> dict:
    """Arm (b): one LM_LONG-token prompt prefilled on the chunked
    attention (LM_LONG >= CHUNKED_THRESHOLD) and on the plain ``_attend``
    (the threshold raised past it): last-token logits within TOL_LM_BF16,
    and the chunked argmax a near tie (TOL_LM_TIE) of the plain one."""
    import numpy as np

    from repro_torch.models import attention

    cfg = model.cfg
    check(LM_LONG >= attention.CHUNKED_THRESHOLD,
          "the long prompt does not reach the chunked path")
    prompt = torch.as_tensor(np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab, (1, LM_LONG)), device=DEVICE)
    out = {}
    chunked = attention._attend_chunked
    threshold = attention.CHUNKED_THRESHOLD
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return chunked(*a, **k)

    for label in ("chunked", "plain"):
        attention._attend_chunked = counted
        if label == "plain":
            attention.CHUNKED_THRESHOLD = LM_LONG + 1
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                logits, _ = model.prefill(params, model.init_cache(
                    1, LM_LONG, device=DEVICE), tokens=prompt)
                stop.record()
            torch.cuda.synchronize()
        finally:
            attention.CHUNKED_THRESHOLD = threshold
            attention._attend_chunked = chunked
        out[label] = {"logits": logits[:, -1].float(),
                      "ms": start.elapsed_time(stop),
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "chunked_calls": len(calls)}
        calls.clear()
    c, pl = out["chunked"]["logits"], out["plain"]["logits"]
    err = float((c - pl).abs().max())
    scale = float(pl.abs().max())
    same = bool(torch.equal(c.argmax(-1), pl.argmax(-1)))
    # the plain logit of the chunked argmax, under the plain maximum
    short = float((pl.amax(-1)
                   - pl.gather(-1, c.argmax(-1, keepdim=True))[:, 0]).max())
    say(f"[7 lm serve] (b) {LM_LONG}-token prefill: chunked "
        f"{out['chunked']['ms']:.1f} ms (peak "
        f"{out['chunked']['peak_bytes'] / 1e9:.2f} GB, {out['chunked']['chunked_calls']} "
        f"chunked attention calls), plain {out['plain']['ms']:.1f} ms (peak "
        f"{out['plain']['peak_bytes'] / 1e9:.2f} GB); last-token logits max "
        f"abs diff {err:.4g} (|logit| up to {scale:.3g}; tol {TOL_LM_BF16}), "
        f"same argmax {same} (the chunked one {short:.4g} under the plain "
        f"maximum; tol {TOL_LM_TIE})")
    check(out["chunked"]["chunked_calls"] == cfg.n_layers,
          "the long prefill did not take the chunked path in every layer")
    check(out["plain"]["chunked_calls"] == 0, "the plain prefill chunked")
    check(err <= TOL_LM_BF16, "chunked and plain prefill disagree")
    check(short <= TOL_LM_TIE, "the chunked argmax is no near tie of the plain")
    return {"tokens": LM_LONG, "chunked_ms": out["chunked"]["ms"],
            "plain_ms": out["plain"]["ms"],
            "chunked_peak_bytes": out["chunked"]["peak_bytes"],
            "plain_peak_bytes": out["plain"]["peak_bytes"],
            "last_logits_max_abs": err, "same_argmax": same,
            "argmax_shortfall": short}


def lm_greedy_decode(torch, model, params, cache, logits, pos: int,
                     steps: int):
    """``steps`` greedy tokens by ``decode_step`` from ``logits`` (B, 1, V)
    of position ``pos - 1``: (tokens (B, steps), float32 logits each was
    chosen from (B, steps, V))."""
    toks, seen = [], []
    for i in range(steps):
        seen.append(logits[:, -1].float())
        toks.append(torch.argmax(logits[:, -1], -1))
        logits, cache = model.decode_step(params, cache, toks[-1][:, None],
                                          pos + i)
    return torch.stack(toks, 1), torch.stack(seen, 1)


def lm_cross_arch(torch, name: str) -> dict:
    """Arm (d) for one arch at ``reduced()`` (float32): weights drawn on
    the CPU and carried to the card; forward logits, and the greedy
    continuation with the logits each token was chosen from, on both."""
    import copy

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build
    from repro_torch.serve.generate import generate

    cfg = ARCHS[name].reduced()
    model = build(cfg)
    cpu = model.init(torch.Generator().manual_seed(LM_SEED), "cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(LM_SEED)
    b, s, new = LM_CROSS_B, LM_CROSS_S, LM_CROSS_NEW
    toks = rng.integers(0, cfg.vocab, (b, s))
    emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    res = {}
    for side, dev, params in (("cpu", "cpu", cpu), ("card", DEVICE, card)):
        t = torch.as_tensor(toks, device=dev)
        e = torch.as_tensor(emb, device=dev)
        with torch.no_grad():
            kw = {"tokens": t}
            if cfg.input_embeds:
                kw["embeds"] = e
                if cfg.family != "audio":
                    del kw["tokens"]
            fwd, _ = model.forward(params, **kw)
            if cfg.family in ("dense", "moe", "ssm"):
                rec: dict = {}
                out = generate(lm_recorder(torch, model, rec), params, t, new)
                greedy, seen = out[:, s:], torch.stack(rec["logits"], 1)
                how = "generate"
            else:
                cache = model.init_cache(b, s + new, device=dev)
                if cfg.family == "vlm":
                    logits, cache = model.prefill(params, cache, embeds=e)
                    pos = s
                else:
                    if cfg.family == "audio":
                        cache = model.prefill(params, cache, embeds=e)
                    for i in range(s):
                        logits, cache = model.decode_step(params, cache,
                                                          t[:, i:i + 1], i)
                    pos = s
                greedy, seen = lm_greedy_decode(torch, model, params, cache,
                                                logits, pos, new)
                how = "decode_step"
        res[side] = {"fwd": fwd.float().cpu(), "greedy": greedy.cpu(),
                     "seen": seen.float().cpu()}
    g, h = res["card"], res["cpu"]
    fwd_err = float((g["fwd"] - h["fwd"]).abs().max())
    equal = bool(torch.equal(g["greedy"], h["greedy"]))
    # up to the first step where a row's tokens part, the two saw the same
    # prefix: compare the logits there, and a parting must be a near tie
    steps = new
    for i in range(new):
        if not torch.equal(g["greedy"][:, i], h["greedy"][:, i]):
            steps = i + 1
            break
    seen_err = float((g["seen"][:, :steps] - h["seen"][:, :steps]).abs().max())
    tie = 0.0
    if not equal:
        i = steps - 1
        gap = (h["seen"][:, i].gather(-1, h["greedy"][:, i:i + 1])
               - h["seen"][:, i].gather(-1, g["greedy"][:, i:i + 1]))
        tie = float(gap.abs().max())
    say(f"[7 lm serve] (d) {name}: forward max abs {fwd_err:.3g}; greedy "
        f"({how}, {new} tokens) {'equal' if equal else f'part at step {steps - 1}, a tie within {tie:.3g}'}; "
        f"logits over {steps} steps max abs {seen_err:.3g} (tol {TOL_LM_CROSS})")
    check(fwd_err <= TOL_LM_CROSS, f"{name}: forward logits differ card/CPU")
    check(seen_err <= TOL_LM_CROSS, f"{name}: decode logits differ card/CPU")
    check(tie <= TOL_LM_CROSS, f"{name}: greedy tokens part on no near tie")
    return {"forward_max_abs": fwd_err, "decode_max_abs": seen_err,
            "greedy_equal": equal, "via": how}


def phase_lm(torch) -> dict:
    """Phase 7: LM serving on the card (see the module docstring). Each
    arm's launch counts are set to 0 just before it and read just after;
    the LM path launches none of the five kernels."""
    from repro_torch.configs import ARCHS

    launches = {}

    def counted(arm, fn, *args):
        zero_launches()
        out = fn(*args)
        launches[arm] = launches_now()
        check(sum(launches[arm].values()) == 0,
              f"LM arm ({arm}) launched a search kernel: {launches[arm]}")
        return out

    torch.cuda.empty_cache()
    a, model, params, gen = counted("a", lm_full, torch, LM_ARCH)
    # phase 10 (e) serves the same prompt over placed state: arm (a)'s
    # tokens and its first logits are kept for it
    placed_ref = {"tokens": gen["tokens"],
                  "logits": gen["logits"][:, :1 + DRY_PLACED_STEPS].clone(),
                  "prefill_ms": a["prefill_ms"],
                  "decode_ms_p50": a["decode_ms_p50"]}
    del gen
    b = counted("b", lm_chunked, torch, model, params)
    del model, params
    torch.cuda.empty_cache()
    c, model, params, _ = counted("c", lm_full, torch, LM_SSM_ARCH)
    del model, params
    torch.cuda.empty_cache()
    d = counted("d", lambda: {name: lm_cross_arch(torch, name)
                              for name in sorted(ARCHS)})
    return {"arms": {"a": {"arch": LM_ARCH, **a}, "b": b,
                     "c": {"arch": LM_SSM_ARCH, **c}, "d": d,
                     "launches": launches},
            "launches": launches, "placed_ref": placed_ref}


# ----------------------------- phase 8: LM training -------------------------


def train_data(cfg, batch: int, seq: int, step: int) -> dict:
    """``TokenStream(TRAIN_SEED)``'s batch at ``step`` (numpy), with the
    seeded float32 embeddings ``launch.train`` gives an embeddings-in arch."""
    import numpy as np

    from repro_torch.data.lm import TokenStream

    b = TokenStream(cfg.vocab, batch, seq, seed=TRAIN_SEED).batch_at(step)
    if cfg.input_embeds:
        b["embeds"] = np.random.default_rng(step).normal(
            size=(batch, seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b.pop("tokens")
    return b


def train_ms(ms) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(ms, 50)), "max": float(max(ms))}


def train_device_busy(torch, step, state, batch):
    """One more ``step`` under ``torch.profiler``: its CUDA kernels' (and
    copies') summed time and number, that time by kind (``lm_op_kind``)
    and the LM_TOP_OPS costliest; the step's wall by CUDA events. Returns
    (state, dict); the dict's device numbers are None where the profiler
    saw no device activity."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(stop)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"profiled_step_ms": wall, "device_ms": None, "device_ops": None,
           "kinds_ms": None, "top_ops_ms": None}
    if dev:
        by_name: Counter = Counter()
        by_kind: Counter = Counter()
        for e in dev:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:LM_OP_NAME]] += ms
            by_kind[lm_op_kind(e.name)] += ms
        busy = sum(by_name.values())
        out.update(device_ms=busy, device_ops=len(dev),
                   kinds_ms=dict(by_kind.most_common()),
                   top_ops_ms=dict(by_name.most_common(LM_TOP_OPS)))
    return state, out


def train_bound(n: int, tokens: int) -> dict:
    """The step's least time on the card, in three parts run one after
    another: the products, 6 N T flops plus the remat forward's 2 N T, at
    the bfloat16 dense peak; AdamW's bytes, 24 a parameter (read p in
    bfloat16, g, m, v in float32, write p, m, v); two microbatches'
    accumulation, 10 bytes a parameter each (read the bfloat16 gradient,
    read and write the float32 sum)."""
    flops_ms = 8 * n * tokens / PEAK_BF16 * 1e3
    adamw_ms = 24 * n / PEAK_BYTES * 1e3
    accum_ms = 2 * 10 * n / PEAK_BYTES * 1e3
    return {"flops_ms": flops_ms, "adamw_ms": adamw_ms, "accum_ms": accum_ms,
            "bound_ms": flops_ms + adamw_ms + accum_ms}


def train_full(torch):
    """Arm (a): TRAIN_ARCH at full width in bfloat16 (AdamW, two
    microbatches, remat), random weights from TRAIN_SEED on the card, one
    untimed step, TRAIN_STEPS timed by CUDA events, one profiled: step ms
    (p50, max), tokens a second, the allocation peak, each step's loss and
    gradient norm (finite)."""
    import math

    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build
    from repro_torch.train.layout import leaves
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = ARCHS[TRAIN_ARCH]
    check(cfg.dtype == "bfloat16" and cfg.optimizer == "adamw" and cfg.remat
          and cfg.num_microbatches == 2, f"{TRAIN_ARCH}'s config changed")
    model = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(model, torch.Generator(device=DEVICE).manual_seed(
        TRAIN_SEED), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for _, p in leaves(state.params))
    step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_TOTAL)
    batches = [train_data(cfg, TRAIN_BATCH, TRAIN_SEQ, i)
               for i in range(TRAIN_STEPS + 2)]
    state, m = step(state, batches[0])  # untimed: cuBLAS and the allocator warm
    metrics = [m]
    torch.cuda.synchronize()
    evs = []
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batches[i])
        stop.record()
        evs.append((start, stop))
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in evs]
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x["loss"]) for x in metrics]
    gnorms = [float(x["grad_norm"]) for x in metrics]
    lrs = [float(x["lr"]) for x in metrics]
    state, busy = train_device_busy(torch, step, state, batches[-1])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = train_bound(n, tokens)
    at = train_ms(ms)
    # the profiler slows the host: the busy time is put against the p50
    # of the unprofiled steps
    share = None if busy["device_ms"] is None else busy["device_ms"] / at["p50"]
    cap = torch.cuda.get_device_properties(0).total_memory
    say(f"[8 lm train] (a) {TRAIN_ARCH}: {n:,} parameters, state initialized "
        f"in {init_s:.2f} s; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{cfg.num_microbatches} microbatches: step {at['p50']:.2f} ms (p50), "
        f"{at['max']:.2f} ms (max) over {TRAIN_STEPS} steps ({ms}); "
        f"{tokens * 1e3 / at['p50']:.1f} tokens/s at p50, host wall "
        f"{wall:.3f} s; bound {bound['bound_ms']:.2f} ms (flops "
        f"{bound['flops_ms']:.2f}, AdamW {bound['adamw_ms']:.2f}, "
        f"accumulation {bound['accum_ms']:.2f}); peak {peak / 1e9:.3f} GB of "
        f"{cap / 1e9:.1f}; losses {losses}; grad norms {gnorms}")
    say(f"[8 lm train] (a) torch.profiler over one step "
        f"({busy['profiled_step_ms']:.2f} ms): device busy "
        f"{busy['device_ms']} ms in {busy['device_ops']} kernels and copies, "
        f"{'not measured' if share is None else f'{100 * share:.1f}%'} of the "
        f"p50 step; by kind {busy['kinds_ms']}; the "
        f"costliest {busy['top_ops_ms']}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{TRAIN_ARCH}: a non-finite loss or gradient norm")
    check(peak <= cap, f"{TRAIN_ARCH}: the peak exceeds the card")
    arm = {"arch": TRAIN_ARCH, "params": n, "init_s": init_s,
           "tokens_a_step": tokens, "step_ms": ms, "step_ms_p50": at["p50"],
           "step_ms_max": at["max"], "tokens_per_s": tokens * 1e3 / at["p50"],
           "wall_s": wall, "peak_bytes": peak, "losses": losses,
           "grad_norms": gnorms, "lrs": lrs, **bound, **busy,
           "device_busy_share": share}
    return arm, model, state


def train_grads(torch, model, params, batch):
    """(loss, gradients of every leaf, ms by CUDA events, allocation peak)
    of ``model.loss_fn`` on ``batch`` (tensors on the card)."""
    from repro_torch.train.layout import leaves

    flat = [p for _, p in leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, flat)
    stop.record()
    torch.cuda.synchronize()
    return (float(loss.detach()), list(grads), start.elapsed_time(stop),
            torch.cuda.max_memory_allocated())


def train_rel_l2(torch, grads, ref) -> list:
    """Each leaf's ||g - ref|| / ||ref|| in float64 sums."""
    return [float(torch.linalg.vector_norm((g.float() - r).double())
                  / torch.linalg.vector_norm(r.double()).clamp_min(1e-30))
            for g, r in zip(grads, ref)]


def train_precision(torch, model, params) -> dict:
    """Arm (b): one microbatch (TRAIN_BATCH / 2 x TRAIN_SEQ) of arm (a)'s
    weights under deterministic algorithms: the bfloat16 gradients with
    remat on and off (ms, peak; predicted bit-equal), and against a
    float32 copy's on the card, per leaf by relative L2 (TOL_TRAIN_GRAD)
    with the loss gap (TOL_TRAIN_LOSS); the control, a float32 copy with
    one layer perturbed, must miss the gradient limit."""
    import dataclasses

    from repro_torch.models.registry import build
    from repro_torch.train.layout import leaves, tree_map
    from repro_torch.train.train_step import _batch_tensor

    cfg = model.cfg
    half = TRAIN_BATCH // cfg.num_microbatches
    batch = {k: _batch_tensor(v[:half], DEVICE) for k, v in train_data(
        cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS + 2).items()}
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, c in (("remat", cfg),
                         ("no_remat", dataclasses.replace(cfg, remat=False))):
            out[label] = train_grads(torch, build(c), params, batch)
        equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                    for a, b in zip(out["remat"][1], out["no_remat"][1]))
        nr_ms, nr_peak = out.pop("no_remat")[2:]
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda p: p.detach().float().requires_grad_(True), params)
        loss32, g32, ms32, peak32 = train_grads(torch, build(cfg32), p32, batch)
        loss16, g16 = out["remat"][0], out["remat"][1]
        errs = train_rel_l2(torch, g16, g32)
        del g32
        # the control: noise of its own spread added to each matrix of one
        # layer of the float32 copy
        layer = cfg.n_layers // 2
        gen = torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED + 1)
        with torch.no_grad():
            for _, w in leaves(p32["layers"][layer]):
                if w.dim() >= 2:
                    w.add_(torch.randn(w.shape, generator=gen, device=DEVICE)
                           * w.std())
        lossc, gc, _, _ = train_grads(torch, build(cfg32), p32, batch)
        errs_c = train_rel_l2(torch, g16, gc)
        del gc, p32
    finally:
        torch.use_deterministic_algorithms(False)
    names = [".".join(map(str, path)) for path, _ in leaves(params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    gap, gap_c = abs(loss16 - loss32), abs(loss16 - lossc)
    say(f"[8 lm train] (b) one microbatch ({half} x {TRAIN_SEQ}): bf16 "
        f"gradients remat {out['remat'][2]:.2f} ms (peak "
        f"{out['remat'][3] / 1e9:.3f} GB), no remat {nr_ms:.2f} ms (peak "
        f"{nr_peak / 1e9:.3f} GB); remat on and off "
        f"bit-equal {equal}; against the float32 copy ({ms32:.2f} ms, peak "
        f"{peak32 / 1e9:.3f} GB): relative L2 per leaf at most "
        f"{errs[worst]:.4g} ({names[worst]}), median "
        f"{sorted(errs)[len(errs) // 2]:.4g} (tol {TOL_TRAIN_GRAD}); loss "
        f"{loss16:.6f} against {loss32:.6f}, gap {gap:.4g} (tol "
        f"{TOL_TRAIN_LOSS}); the control (layer {layer} perturbed): at most "
        f"{max(errs_c):.4g}, loss gap {gap_c:.4g}")
    check(equal, "remat on and off give other gradient bits")
    check(max(errs) <= TOL_TRAIN_GRAD, "bfloat16 gradients stray from float32")
    check(gap <= TOL_TRAIN_LOSS, "the bfloat16 loss strays from float32")
    check(max(errs_c) > TOL_TRAIN_GRAD,
          "the gradient check cannot see a perturbed layer")
    return {"tokens": half * TRAIN_SEQ, "remat_equal": equal,
            "remat_ms": out["remat"][2], "remat_peak_bytes": out["remat"][3],
            "no_remat_ms": nr_ms, "no_remat_peak_bytes": nr_peak,
            "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst_leaf": names[worst],
            "grad_rel_l2_median": sorted(errs)[len(errs) // 2],
            "loss_bf16": loss16, "loss_f32": loss32, "loss_gap": gap,
            "control_grad_rel_l2_max": max(errs_c), "control_loss_gap": gap_c,
            "f32_ms": ms32, "f32_peak_bytes": peak32}


def train_supervised(torch, workdir: str) -> dict:
    """Arm (c): TRAIN_SSM_ARCH at full width in bfloat16 under
    ``TrainingSupervisor`` and deterministic algorithms: SUP_STEPS steps of
    SUP_BATCH x TRAIN_SEQ, an async checkpoint every SUP_EVERY steps, a
    failure injected before step SUP_FAIL (one restart, replayed from the
    last checkpoint), against an uninterrupted run from the same weights:
    the last loss and every leaf bit for bit; the last checkpoint restored
    into a zeroed state gives every leaf's bits, bfloat16 included."""
    import os

    from repro_torch.configs import ARCHS
    from repro_torch.distributed.fault_tolerance import TrainingSupervisor
    from repro_torch.models.registry import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.layout import leaves, tree_map
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = ARCHS[TRAIN_SSM_ARCH]
    check(cfg.dtype == "bfloat16", f"{TRAIN_SSM_ARCH}'s config changed")
    model = build(cfg)
    batches = {}

    def data_at(i):
        if i not in batches:
            batches[i] = train_data(cfg, SUP_BATCH, TRAIN_SEQ, i)
        return batches[i]

    step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=SUP_STEPS)

    def run(label, fail_at):
        sup = TrainingSupervisor(step, data_at, os.path.join(workdir, label),
                                 ckpt_every=SUP_EVERY, async_ckpt=True)
        state = init_state(model, torch.Generator(device=DEVICE).manual_seed(
            TRAIN_SEED), device=DEVICE)
        armed = [fail_at is not None]

        def inject(i):
            if armed[0] and i == fail_at:
                armed[0] = False
                raise RuntimeError("injected failure")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, log = sup.run(state, SUP_STEPS, fail_injector=inject)
        torch.cuda.synchronize()
        return sup, state, log, time.perf_counter() - t0

    torch.use_deterministic_algorithms(True)
    try:
        sup, state, log, wall = run("faulty", SUP_FAIL)
        sup0, state0, log0, wall0 = run("clean", None)
    finally:
        torch.use_deterministic_algorithms(False)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    same = all(torch.equal(bits(a), bits(b))
               for (_, a), (_, b) in zip(leaves(state), leaves(state0)))
    template = tree_map(torch.zeros_like, state)
    restored, at = ckpt.restore(os.path.join(workdir, "faulty"), template)
    back = ckpt.load_into(template, restored)
    round_trip = all(torch.equal(bits(a), bits(b))
                     for (_, a), (_, b) in zip(leaves(back), leaves(state)))
    n_bf16 = sum(t.dtype == torch.bfloat16 for _, t in leaves(state))
    replayed = len(log) - SUP_STEPS
    losses = [x["loss"] for x in log]
    say(f"[8 lm train] (c) {TRAIN_SSM_ARCH} under TrainingSupervisor: "
        f"{SUP_STEPS} steps of {SUP_BATCH} x {TRAIN_SEQ}, async checkpoints "
        f"every {SUP_EVERY}, a failure at step {SUP_FAIL}: restarts "
        f"{sup.restarts}, {replayed} steps replayed, {wall:.2f} s "
        f"({wall / len(log) * 1e3:.1f} ms a step with checkpoints); "
        f"uninterrupted {wall0:.2f} s; last loss {log[-1]['loss']!r} against "
        f"{log0[-1]['loss']!r}; every leaf equal {same}; checkpoint of step "
        f"{at} restored into a zeroed state bit for bit {round_trip} "
        f"({n_bf16} bfloat16 leaves); losses {losses}")
    check(sup.restarts == 1 and sup0.restarts == 0, "restarts miscounted")
    check(replayed == SUP_FAIL - (SUP_FAIL // SUP_EVERY) * SUP_EVERY,
          "the replay did not start from the last checkpoint")
    check(log[-1]["loss"] == log0[-1]["loss"] and same,
          "the restarted run parts from the uninterrupted one")
    check(at == SUP_STEPS and round_trip and n_bf16 > 0,
          "a checkpoint did not round-trip bit for bit")
    return {"arch": TRAIN_SSM_ARCH, "restarts": sup.restarts,
            "replayed_steps": replayed, "wall_s": wall, "clean_wall_s": wall0,
            "last_loss": log[-1]["loss"], "clean_last_loss": log0[-1]["loss"],
            "bit_equal": same, "round_trip": round_trip,
            "bf16_leaves": n_bf16, "losses": losses}


def train_params_apart(torch, a_params, b_params, lrs, adamw: bool) -> dict:
    """How far two runs' parameters part: the largest difference over each
    leaf's largest value; the elements beyond TOL_TRAIN_PARAMS of it
    (``far``) and their largest absolute difference, against the most two
    AdamW runs can part (``flip_bound``; see TRAIN_FLIP_SHARE)."""
    from repro_torch.train.layout import leaves

    rel, far, n, far_abs, pmax = 0.0, 0, 0, 0.0, 0.0
    for (_, a), (_, b) in zip(leaves(a_params), leaves(b_params)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        d = (a - b).abs()
        top = float(a.abs().max().clamp_min(1e-30))
        rel = max(rel, float(d.max()) / top)
        beyond = d > TOL_TRAIN_PARAMS * top
        far += int(beyond.sum())
        n += a.numel()
        if bool(beyond.any()):
            far_abs = max(far_abs, float(d[beyond].max()))
        pmax = max(pmax, top)
    bound = 2 * sum(lrs) * (1.01 + 0.1 * pmax) if adamw else 0.0
    return {"params_rel_err": rel, "far": far, "far_share": far / n,
            "far_max_abs": far_abs, "flip_bound": bound}


def train_cross_arch(torch, name: str, compression=None) -> dict:
    """Arm (d) for one arch at ``reduced()`` (float32): one state drawn on
    the CPU and copied to the card, CROSS_STEPS steps on each: losses and
    gradient norms within TOL_TRAIN_CROSS; the parameters within
    TOL_TRAIN_PARAMS of each leaf's largest value but for AdamW's sign
    effect (TRAIN_FLIP_SHARE)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build
    from repro_torch.train.layout import tree_map
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = ARCHS[name].reduced()
    model = build(cfg)
    cpu = init_state(model, torch.Generator().manual_seed(TRAIN_SEED),
                     grad_compression=compression, device="cpu")
    card = tree_map(lambda t: t.detach().to(DEVICE, copy=True).requires_grad_(
        t.requires_grad), cpu)
    step = make_train_step(model, base_lr=1e-3, warmup=1, total_steps=10,
                           grad_compression=compression)
    worst, lrs = 0.0, []
    for i in range(CROSS_STEPS):
        batch = train_data(cfg, CROSS_B, CROSS_S, i)
        cpu, mc = step(cpu, batch)
        card, mg = step(card, batch)
        lrs.append(float(mc["lr"]))
        for k in ("loss", "grad_norm"):
            a, b = float(mc[k]), float(mg[k])
            worst = max(worst, abs(a - b) / abs(a))
    adamw = cfg.optimizer == "adamw"
    apart = train_params_apart(torch, cpu.params, card.params, lrs, adamw)
    label = name + (f" ({compression})" if compression else "")
    say(f"[8 lm train] (d) {label}: {CROSS_STEPS} steps ({cfg.optimizer}), "
        f"loss and grad norm card against CPU at most {worst:.3g} relative "
        f"(tol {TOL_TRAIN_CROSS}); parameters {apart['params_rel_err']:.3g} "
        f"of each leaf's largest; {apart['far']} elements beyond "
        f"{TOL_TRAIN_PARAMS} of it ({apart['far_share']:.3g} of all; tol "
        f"{TRAIN_FLIP_SHARE if adamw else 0}), at most "
        f"{apart['far_max_abs']:.3g} apart (the sign effect's bound "
        f"{apart['flip_bound']:.3g})")
    check(worst <= TOL_TRAIN_CROSS, f"{label}: losses differ card/CPU")
    check(apart["far_share"] <= (TRAIN_FLIP_SHARE if adamw else 0.0)
          and apart["far_max_abs"] <= apart["flip_bound"],
          f"{label}: parameters differ card/CPU")
    return {"optimizer": cfg.optimizer, "metrics_rel_err": worst, **apart}


def phase_train(torch) -> dict:
    """Phase 8: LM training on the card (see the module docstring). Each
    arm's launch counts are set to 0 just before it and read just after;
    the training path launches none of the five kernels."""
    import shutil

    from repro_torch.configs import ARCHS

    launches = {}

    def counted(arm, fn, *args):
        zero_launches()
        out = fn(*args)
        launches[arm] = launches_now()
        check(sum(launches[arm].values()) == 0,
              f"training arm ({arm}) launched a search kernel: {launches[arm]}")
        return out

    torch.cuda.empty_cache()
    a, model, state = counted("a", train_full, torch)
    params = state.params
    del state  # the optimizer's moments go; arm (b) needs the weights only
    torch.cuda.empty_cache()
    b = counted("b", train_precision, torch, model, params)
    del model, params
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        c = counted("c", train_supervised, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    def cross():
        out = {name: train_cross_arch(torch, name) for name in sorted(ARCHS)}
        out[f"{TRAIN_ARCH} int8"] = train_cross_arch(torch, TRAIN_ARCH, "int8")
        return out

    d = counted("d", cross)
    return {"arms": {"a": a, "b": b, "c": c, "d": d, "launches": launches},
            "launches": launches}


def sharded_full(torch, ref: dict) -> dict:
    """Arm (a): TRAIN_ARCH at full width as phase 8 (a) runs it, placed on a
    mesh of one by launch.train's code: SHARDED_STEPS steps of phase 8
    (a)'s batches, each placed by make_batch_specs, against phase 8 (a)'s
    first losses and gradient norms (``ref``: that arm's numbers, this
    call)."""
    import math
    from collections import Counter

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import batch_axes, place_batch
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import axis_sizes, make_local_mesh
    from repro_torch.models.registry import build
    from repro_torch.train.layout import leaves
    from repro_torch.train.train_step import make_train_step

    cfg = ARCHS[TRAIN_ARCH]
    model = build(cfg)
    mesh = make_local_mesh(1)
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = launch.placed_state(model, mesh, TRAIN_SEED,
                                    torch.device(DEVICE))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        placed = Counter(str(tuple(t.placements)) for _, t in leaves(state))
        step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_TOTAL)
        metrics, evs = [], []
        for i in range(SHARDED_STEPS):
            batch = place_batch(train_data(cfg, TRAIN_BATCH, TRAIN_SEQ, i),
                                mesh)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch)
            stop.record()
            metrics.append(m)
            if i:  # the first step warms cuBLAS, the allocator and DTensor
                evs.append((start, stop))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del state
    finally:
        hints.clear()
    ms = [a.elapsed_time(b) for a, b in evs]
    at = train_ms(ms)
    losses = [float(x["loss"]) for x in metrics]
    gnorms = [float(x["grad_norm"]) for x in metrics]
    want_l = ref["losses"][:SHARDED_STEPS]
    want_g = ref["grad_norms"][:SHARDED_STEPS]
    gap = max(abs(a - b) / abs(b) for a, b in
              zip(losses + gnorms, want_l + want_g))
    bit_equal = losses == want_l and gnorms == want_g
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"[9 lm sharded] (a) {TRAIN_ARCH} on mesh {axis_sizes(mesh)}: state "
        f"placed in {init_s:.2f} s, leaves by placement {dict(placed)}; step "
        f"{at['p50']:.2f} ms (p50), {at['max']:.2f} ms (max) over "
        f"{len(ms)} steps ({ms}) against phase 8 (a)'s "
        f"{ref['step_ms_p50']:.2f} ms; {tokens * 1e3 / at['p50']:.1f} "
        f"tokens/s; peak {peak / 1e9:.3f} GB (phase 8 (a): "
        f"{ref['peak_bytes'] / 1e9:.3f}); losses {losses} against "
        f"{want_l}; grad norms {gnorms} against {want_g}; largest relative "
        f"gap {gap:.3e}; bit-equal {bit_equal}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{TRAIN_ARCH} placed: a non-finite loss or gradient norm")
    check(gap <= TOL_TRAIN_CROSS,
          f"{TRAIN_ARCH} placed parts from phase 8 (a): {gap:.3e}")
    check(set(placed) == {"(Replicate(), Replicate())",
                          "(Shard(dim=0), Shard(dim=1))",
                          "(Shard(dim=1), Shard(dim=0))"},
          f"unexpected placements {dict(placed)}")
    return {"arch": TRAIN_ARCH, "mesh": axis_sizes(mesh), "init_s": init_s,
            "leaves_by_placement": dict(placed), "step_ms": ms,
            "step_ms_p50": at["p50"], "step_ms_max": at["max"],
            "phase8_step_ms_p50": ref["step_ms_p50"],
            "tokens_per_s": tokens * 1e3 / at["p50"], "peak_bytes": peak,
            "phase8_peak_bytes": ref["peak_bytes"], "losses": losses,
            "grad_norms": gnorms, "phase8_losses": want_l,
            "phase8_grad_norms": want_g, "max_rel_gap": gap,
            "bit_equal": bit_equal}


def sharded_ep(torch) -> dict:
    """Arm (b): EP_ARCH at reduced() in float32 with nothing dropped,
    ``moe_impl="ep"`` on the mesh of one against ``"dense"`` on the card
    (unplaced): forward logits, then one step of each from one seeded
    state."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_param_specs,
        place,
        place_batch,
    )
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import plain
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import init_state, make_train_step

    base = dataclasses.replace(ARCHS[EP_ARCH].reduced(), capacity_factor=EP_CF)
    dense = build(base)
    ep = build(dataclasses.replace(base, moe_impl="ep"))
    dev = torch.device(DEVICE)
    batch = train_data(base, EP_BATCH, EP_SEQ, 0)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    params = dense.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
    with torch.no_grad():
        want = dense.forward(params, tokens=tokens)[0]
    mesh = make_local_mesh(1)
    hints.set_axes(batch_axes(mesh), mesh=mesh)
    try:
        placed = place(plain(params), mesh, make_param_specs(ep, mesh))
        with torch.no_grad():
            got = ep.forward(placed, tokens=place_batch(
                {"t": tokens}, mesh)["t"])[0].full_tensor()
        kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
        state = launch.placed_state(ep, mesh, TRAIN_SEED, dev)
        state, m = make_train_step(ep, **kw)(state, place_batch(batch, mesh))
    finally:
        hints.clear()
    state0 = init_state(dense, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), device=dev)
    state0, m0 = make_train_step(dense, **kw)(state0, batch)
    rel = float((got - want).abs().max() / want.abs().max())
    step_gap = max(abs(float(m[k]) - float(m0[k])) / abs(float(m0[k]))
                   for k in ("loss", "grad_norm"))
    say(f"[9 lm sharded] (b) {EP_ARCH} reduced() float32, moe_impl=ep on the "
        f"mesh of one against dense: logits relative gap {rel:.3e}, "
        f"bit-equal {bool(torch.equal(got, want))}; one step: loss "
        f"{float(m['loss'])!r} against {float(m0['loss'])!r}, grad norm "
        f"{float(m['grad_norm'])!r} against {float(m0['grad_norm'])!r}")
    check(rel <= TOL_LM_CROSS, f"moe_ep parts from the dense moe: {rel:.3e}")
    check(step_gap <= TOL_TRAIN_CROSS,
          f"moe_ep's step parts from the dense one: {step_gap:.3e}")
    return {"arch": EP_ARCH, "logits_rel": rel,
            "logits_bit_equal": bool(torch.equal(got, want)),
            "loss": float(m["loss"]), "dense_loss": float(m0["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "dense_grad_norm": float(m0["grad_norm"]), "step_gap": step_gap}


def sharded_supervised(torch, workdir: str) -> dict:
    """Arm (c): ``launch.train`` on the card for TRAIN_ARCH's reduced(),
    under deterministic algorithms: its main on the group of one (which
    trains the unplaced state), then its loop (``launch.run``) on the
    mesh of one uninterrupted and with a failure injected at
    SHARDED_SUP_FAIL through the supervisor's ``fail_injector``: one
    restart, the last loss bit for bit."""
    import io
    import os

    from repro_torch.launch import train as launch
    from repro_torch.models.registry import build

    argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps",
            str(SHARDED_SUP_STEPS), "--batch", "4", "--seq", "16",
            "--ckpt-every", str(SHARDED_SUP_EVERY), "--device", DEVICE]
    failed = []

    def fail_once(step: int) -> None:
        if step == SHARDED_SUP_FAIL and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure before step {step}")

    def supervised(label, injector):
        args = launch.parse_args(argv + ["--ckpt", os.path.join(workdir,
                                                                label)])
        cfg = launch.train_config(args)
        dev = torch.device(DEVICE)
        return launch.run(args, cfg, build(cfg), launch.launch_mesh(args, dev),
                          dev, injector)

    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, fn in (
                ("main", lambda: launch.main(
                    argv + ["--ckpt", os.path.join(workdir, "main")])),
                ("faulty", lambda: supervised("faulty", fail_once)),
                ("clean", lambda: supervised("clean", None))):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                log = fn()
            runs[label] = {"log": log, "text": out.getvalue(),
                           "wall_s": time.perf_counter() - t0}
    finally:
        torch.use_deterministic_algorithms(False)
    main, faulty, clean = runs["main"], runs["faulty"], runs["clean"]
    mesh_line = main["text"].splitlines()[0]
    restarted = "restarts=1" in faulty["text"]
    last, last0 = faulty["log"][-1]["loss"], clean["log"][-1]["loss"]
    last_main = main["log"][-1]["loss"]
    gap = abs(last_main - last0) / abs(last0)
    say(f"[9 lm sharded] (c) launch.train --reduced on the card: main "
        f"printed {mesh_line!r}, {SHARDED_SUP_STEPS} steps unplaced in "
        f"{main['wall_s']:.2f} s, last loss {last_main!r}; its loop on the "
        f"mesh of one, a failure at step {SHARDED_SUP_FAIL}: restarted "
        f"{restarted}, {len(faulty['log'])} steps logged in "
        f"{faulty['wall_s']:.2f} s ({clean['wall_s']:.2f} s uninterrupted); "
        f"last loss {last!r} against the uninterrupted {last0!r}; main "
        f"against the placed loop {gap:.3e} relative, bit-equal "
        f"{last_main == last0}")
    check(mesh_line.endswith("mesh={'data': 1, 'model': 1}"),
          f"launch.train printed {mesh_line!r}")
    check(restarted and "restarts=0" in clean["text"],
          "the supervised run under the mesh did not restart once")
    check(last == last0, "the restarted run parts from the uninterrupted one")
    check(gap <= TOL_TRAIN_CROSS,
          f"launch.train's unplaced run parts from the placed one: {gap:.3e}")
    return {"mesh_line": mesh_line, "restarts": 1 if restarted else 0,
            "logged_steps": len(faulty["log"]), "last_loss": last,
            "clean_last_loss": last0, "main_last_loss": last_main,
            "main_rel_gap": gap, "main_bit_equal": last_main == last0,
            "wall_s": faulty["wall_s"], "clean_wall_s": clean["wall_s"],
            "main_wall_s": main["wall_s"],
            "losses": [x["loss"] for x in faulty["log"]]}


def phase_sharded_train(torch, train: dict) -> dict:
    """Phase 9: sharded LM training on the card's group of one (see the
    module docstring). Each arm's launch counts are set to 0 just before
    it and read just after; the path launches none of the five kernels."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train as launch

    launches = {}

    def counted(arm, fn, *args):
        zero_launches()
        out = fn(*args)
        launches[arm] = launches_now()
        check(sum(launches[arm].values()) == 0,
              f"sharded arm ({arm}) launched a search kernel: {launches[arm]}")
        return out

    torch.cuda.empty_cache()
    started = launch.join_group(torch.device(DEVICE))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        a = counted("a", sharded_full, torch, train["arms"]["a"])
        torch.cuda.empty_cache()
        b = counted("b", sharded_ep, torch)
        c = counted("c", sharded_supervised, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if started:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"arms": {"a": a, "b": b, "c": c, "launches": launches},
            "launches": launches}


# ----------------------------- phase 10: dry-run ----------------------------


def dry_env() -> dict:
    import os

    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1"}


def dry_cli(*args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
            *args]


def dry_start(workdir: str) -> dict:
    """Start arms (a), (b) and (c)'s fake trace in the background, and
    phase 5's CPU halves (``cpu_ref_worker``, arm ``cpu_ref``), each
    writing its output to a file of ``workdir``."""
    jobs = {
        "a": dry_cli("--arch", DRY_ARCH),
        "b": dry_cli("--arch", DRY_MOE[0], "--shape", DRY_MOE[1], "--opt"),
        "b_cpu": dry_cli("--arch", DRY_MOE[0], "--shape", DRY_MOE[1], "--opt",
                         "--mesh-device", "cpu"),
        "c": [sys.executable, str(ROOT / "chip_smoke.py"), "--dry-count",
              json.dumps({"device": DEVICE, "batch": TRAIN_BATCH,
                          "seq": TRAIN_SEQ})],
        "cpu_ref": [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-ref",
                    json.dumps({"threads": CPU_REF_THREADS})],
    }
    procs = {}
    for arm, cmd in jobs.items():
        out = open(Path(workdir) / f"dry_{arm}.log", "w")
        procs[arm] = (subprocess.Popen(cmd, stdout=out,
                                       stderr=subprocess.STDOUT,
                                       env=dry_env(), cwd=ROOT), out)
    return {"procs": procs, "dir": workdir, "t0": time.perf_counter()}


def dry_stop(started: dict) -> None:
    """Kill the arms still running and close their logs."""
    for proc, out in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def dry_join(started: dict) -> dict:
    """Wait for every arm (DRY_WAIT from their start; then all are
    killed), check each exit code (0) and keep each one's output in
    ``started["text"]``; returns ``started``."""
    deadline = started["t0"] + DRY_WAIT
    started["text"] = {}
    try:
        for arm, (proc, _) in started["procs"].items():
            try:
                rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            text = (Path(started["dir"]) / f"dry_{arm}.log").read_text()
            tail = "\n".join(text.splitlines()[-30:])
            check(rc == 0, f"dry-run arm ({arm}) exited {rc}:\n{tail}")
            started["text"][arm] = text
    finally:
        dry_stop(started)
    say(f"[10 dryrun] subprocess arms {sorted(started['procs'])} done in "
        f"{time.perf_counter() - started['t0']:.2f} s from their start")
    return started


def arm_result(started: dict, arm: str) -> dict:
    """The ``RESULT <json>`` line an ended arm printed last."""
    text = started["text"][arm]
    line = [x for x in text.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def dry_count_worker(job: dict) -> int:
    """Phase 10 (c)'s traced half: phase 8 (a)'s cell (TRAIN_ARCH at full
    width, TRAIN_BATCH x TRAIN_SEQ, its step's options) traced on a fake
    group of one under ``op_stats``; prints one ``RESULT <json>`` line."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import build

    cfg = ARCHS[TRAIN_ARCH]
    shape = ShapeConfig("phase8_a", "train", job["seq"], job["batch"])
    with dryrun.fake_world(1):
        mesh = make_local_mesh(1, job["device"])
        res = dryrun.trace_step(build(cfg), shape, mesh, step_kw=dict(
            base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL))
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def dry_cell_line(res: dict) -> str:
    if res.get("status") == "skipped":
        return f"{res['arch']} {res['shape']}: skipped ({res['reason']})"
    coll = res["collectives"]
    return (f"{res['arch']} {res['shape']} on {res['mesh']} "
            f"({res['device']} mesh): {res['cost_analysis']['flops']:.4e} dot "
            f"FLOPs, {res['cost_analysis']['bytes accessed']:.4e} bytes, "
            f"collectives {coll['total_bytes']:.4e} bytes by kind "
            f"{coll['per_op_bytes']} counts {coll['counts']}; param / state "
            f"/ cache bytes a device {res.get('param_bytes_per_device')} / "
            f"{res.get('state_bytes_per_device')} / "
            f"{res.get('cache_bytes_per_device')}, fits one card "
            f"{res.get('fits_one_card')}; traced in {res.get('trace_s')} s")


def dry_cells(torch) -> dict:
    """Arms (a) and (b): the subprocesses' cells."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    def cell(arch, shape, opt, device=None):
        with open(dryrun.cell_path(arch, shape, False, opt,
                                   device=device)) as f:
            return json.load(f)

    out = {}
    a = {}
    for shape in SHAPES:
        res = cell(DRY_ARCH, shape, False)
        say(f"[10 dryrun] (a) {dry_cell_line(res)}")
        want = "skipped" if shape == "long_500k" else "ok"
        check(res["status"] == want,
              f"dry-run cell {DRY_ARCH} {shape}: {res['status']} "
              f"{res.get('error')}")
        a[shape] = {k: res.get(k) for k in (
            "status", "mesh", "device", "trace_s", "param_bytes_per_device",
            "state_bytes_per_device", "cache_bytes_per_device",
            "fits_one_card", "cost_analysis", "collectives")}
        if want == "ok":
            check(res["cost_analysis"]["flops"] > 0
                  and res["collectives"]["total_bytes"] > 0,
                  f"dry-run cell {DRY_ARCH} {shape} counted nothing")
    out["a"] = a
    res = cell(*DRY_MOE, True)
    say(f"[10 dryrun] (b) {DRY_MOE[0]} {DRY_MOE[1]} --opt (the "
        f"expert-parallel MoE, 8 microbatches): {dry_cell_line(res)}")
    check(res["status"] == "ok",
          f"dry-run cell {DRY_MOE}: {res['status']} {res.get('error')}")
    a2a = res["collectives"]["counts"].get("all-to-all", 0)
    on_cpu = cell(*DRY_MOE, True, "cpu")
    check(on_cpu["status"] == "ok", f"dry-run cell {DRY_MOE} on a CPU mesh: "
          f"{on_cpu['status']} {on_cpu.get('error')}")
    cpu_a2a = on_cpu["collectives"]["counts"].get("all-to-all", 0)
    say(f"[10 dryrun] (b) all-to-alls on the {res['device']} mesh: {a2a}; on "
        f"a CPU mesh of this host, where DTensor runs them as all-gathers "
        f"and the counter counts all-to-alls "
        f"({on_cpu['hlo_stats'].get('cpu_alltoall_fallbacks')} fallbacks): "
        f"{cpu_a2a}, counts {on_cpu['collectives']['counts']}")
    out["b"] = {"arch": DRY_MOE[0], "shape": DRY_MOE[1], "status": res["status"],
                "device": res["device"], "trace_s": res["trace_s"],
                "cost_analysis": res["cost_analysis"],
                "collectives": res["collectives"], "all_to_all": a2a,
                "cpu_mesh_all_to_all": cpu_a2a,
                "cpu_mesh_collectives": on_cpu["collectives"],
                "fits_one_card": res["fits_one_card"]}
    return out


def dry_count(torch, started: dict, train_a: dict) -> dict:
    """Arm (c): phase 8 (a)'s step counted by ``op_stats`` on the card's
    real tensors (a fresh state from TRAIN_SEED, phase 8 (a)'s first batch)
    and traced on a fake group of one (the subprocess): equal dot FLOPs,
    and the traced cell's analytic state bytes the real state's bytes.
    Then ``perf_cell``'s three H100 terms beside phase 8 (a)'s step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import perf_cell
    from repro_torch.models.registry import build
    from repro_torch.roofline.op_stats import OpCounter
    from repro_torch.train.layout import leaves
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = ARCHS[TRAIN_ARCH]
    model = build(cfg)
    torch.cuda.empty_cache()
    state = init_state(model, torch.Generator(device=DEVICE).manual_seed(
        TRAIN_SEED), device=DEVICE)
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves(state))
    step = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_TOTAL)
    batch = train_data(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    t0 = time.perf_counter()
    with OpCounter() as counter:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    real = counter.stats()
    loss = float(m["loss"])
    del state, m
    torch.cuda.empty_cache()
    traced = arm_result(started, "c")
    st = traced["hlo_stats"]
    terms = perf_cell.terms(st)
    a_ms = train_a["step_ms_p50"]
    say(f"[10 dryrun] (c) {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{cfg.num_microbatches} microbatches, remat, AdamW: dot FLOPs on the "
        f"card's tensors {real['dot_flops']:.6e} (one step under the "
        f"counter, {counted_s:.2f} s, loss {loss:.4f}), traced on a fake "
        f"group of one {st['dot_flops']:.6e} (in {traced['trace_s']} s); "
        f"memory bytes {real['mem_bytes']:.4e} and {st['mem_bytes']:.4e}; "
        f"state bytes: real {nbytes}, analytic "
        f"{traced['state_bytes_per_device']}")
    say(f"[10 dryrun] (c) perf_cell's H100 terms: compute "
        f"{terms['compute_s'] * 1e3:.2f} ms, memory "
        f"{terms['memory_s'] * 1e3:.2f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms; phase 8 (a)'s step "
        f"{a_ms:.2f} ms (p50, this run), its bound "
        f"{train_a['bound_ms']:.2f} ms (PERF.md section 5: "
        f"{PERF_MD_TRAIN_BOUND_MS} ms)")
    check(real["dot_flops"] == st["dot_flops"],
          f"(c) dot FLOPs differ: {real['dot_flops']} real, "
          f"{st['dot_flops']} traced")
    check(nbytes == traced["state_bytes_per_device"],
          f"(c) state bytes differ: {nbytes} real, "
          f"{traced['state_bytes_per_device']} analytic")
    return {"dot_flops_real": real["dot_flops"], "dot_flops_traced":
            st["dot_flops"], "mem_bytes_real": real["mem_bytes"],
            "mem_bytes_traced": st["mem_bytes"], "state_bytes_real": nbytes,
            "state_bytes_analytic": traced["state_bytes_per_device"],
            "trace_s": traced["trace_s"], "counted_step_s": counted_s,
            **{f"h100_{k}": v for k, v in terms.items()},
            "phase8_step_ms_p50": a_ms, "phase8_bound_ms": train_a["bound_ms"]}


def dry_search(torch, workdir: str) -> dict:
    """Arm (d): the search cell (``--search``) on the ``(16, 16)`` fake
    group: rank 0's range runs kernels B and A on the card. Its best start
    must be a one-device search's over that range, its distance within
    TOL_A; the rounds and a round's collectives are printed."""
    from repro_torch.configs import SEARCH_CONFIG as SC
    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.launch import dryrun
    from repro_torch.search import multi_query_search

    log = Path(workdir) / "dry_d.log"
    with open(log, "w") as out:
        rc = subprocess.call(dry_cli("--search"), stdout=out,
                             stderr=subprocess.STDOUT, env=dry_env(), cwd=ROOT)
    check(rc == 0, f"dry-run search cell exited {rc}:\n"
          + "\n".join(log.read_text().splitlines()[-30:]))
    with open(Path(dryrun.RESULTS_DIR) / "dtw-search__pod.json") as f:
        res = json.load(f)
    per = res["windows_per_rank"]
    ref = make_dataset(dryrun.SEARCH_DATASET, SC.ref_len, seed=0).astype("float32")
    query = make_queries(dryrun.SEARCH_DATASET, 1, SC.query_len,
                         seed=1).astype("float32")
    one = multi_query_search(
        torch.as_tensor(ref[:per + SC.query_len - 1], device=DEVICE),
        torch.as_tensor(query, device=DEVICE), SC.query_len, SC.window,
        batch=SC.batch, device=DEVICE)
    torch.cuda.synchronize()
    want_s, want_d = int(one.best_start[0]), float(one.best_dist[0])
    rel = abs(res["best_dist"] - want_d) / max(abs(want_d), 1.0)
    say(f"[10 dryrun] (d) search N={SC.ref_len} l={SC.query_len} on "
        f"{res['mesh']} ({res['device']} mesh): rank 0's {per} windows in "
        f"{res['rounds']} rounds ({res['search_s']:.2f} s), best start "
        f"{res['best_start']} at {res['best_dist']:.6f}; a one-device search "
        f"over that range: {want_s} at {want_d:.6f} (rel {rel:.2e}, tol "
        f"{TOL_A}); a round's collectives {res['per_round']}, in all "
        f"{res['collectives']['counts']} ({res['collectives']['total_bytes']} "
        f"bytes); kernel launches {res['kernel_launches']}")
    check(res["best_start"] == want_s, "(d) rank 0's best start is not the "
          f"one-device search's: {res['best_start']} against {want_s}")
    check(rel <= TOL_A, f"(d) rank 0's distance parts by {rel}")
    return {"rounds": res["rounds"], "per_round": res["per_round"],
            "windows_per_rank": per, "best_start": res["best_start"],
            "best_dist": res["best_dist"], "one_device_best_start": want_s,
            "one_device_best_dist": want_d, "collectives": res["collectives"],
            "search_s": res["search_s"], "launches": res["kernel_launches"]}


def dry_placed_serve(torch, ref: dict) -> dict:
    """Arm (e): LM_ARCH at full width in bfloat16 from phase 7 (a)'s seed,
    its parameters (``make_param_specs``) and cache (``make_cache_specs``)
    placed on an NCCL mesh of one with the anchors set: a LM_BATCH x
    LM_PROMPT prefill and DRY_PLACED_STEPS decode steps of phase 7 (a)'s
    tokens, twice (the second timed). Logits within TOL_LM_BF16 of phase
    7 (a)'s (bit-equality reported); prefill ms and decode ms a token
    (p50) beside phase 7 (a)'s."""
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import hints
    from repro_torch.distributed.sharding import (
        batch_axes,
        make_cache_specs,
        make_param_specs,
        place,
        place_batch,
    )
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import plain
    from repro_torch.models.registry import build
    from repro_torch.train.layout import full

    cfg = ARCHS[LM_ARCH]
    model = build(cfg)
    tokens = ref["tokens"]
    total = tokens.shape[1]  # phase 7 (a)'s cache length
    started = launch.join_group(torch.device(DEVICE))
    try:
        mesh = make_local_mesh(1)
        params = model.init(torch.Generator(device=DEVICE).manual_seed(
            LM_SEED), DEVICE)
        placed = place(plain(params), mesh, make_param_specs(model, mesh))
        put = lambda t: place_batch({"x": t}, mesh)["x"]

        def run():
            cache = place(model.init_cache(LM_BATCH, total, DEVICE), mesh,
                          make_cache_specs(model, mesh, LM_BATCH, total))
            evs, logits = [], []
            hints.set_axes(batch_axes(mesh), mesh=mesh)
            try:
                with torch.no_grad():
                    for i in range(1 + DRY_PLACED_STEPS):
                        start = torch.cuda.Event(enable_timing=True)
                        stop = torch.cuda.Event(enable_timing=True)
                        start.record()
                        if i == 0:
                            lg, cache = model.prefill(
                                placed, cache, tokens=put(tokens[:, :LM_PROMPT]))
                        else:
                            pos = LM_PROMPT + i - 1
                            lg, cache = model.decode_step(
                                placed, cache, put(tokens[:, pos:pos + 1]), pos)
                        stop.record()
                        evs.append((start, stop))
                        logits.append(full(lg)[:, -1].float())
            finally:
                hints.clear()
            torch.cuda.synchronize()
            return torch.stack(logits, 1), [a.elapsed_time(b) for a, b in evs]

        logits, _ = run()
        _, ms = run()
    finally:
        if started:
            dist.destroy_process_group()
    want = ref["logits"]
    err = float((logits - want).abs().max())
    same = bool(torch.equal(logits, want))
    dec = pct([x / 1e3 for x in ms[1:]], 50)
    say(f"[10 dryrun] (e) {LM_ARCH} served over placed parameters and cache "
        f"(mesh of one, NCCL): {LM_BATCH} x {LM_PROMPT} prefill "
        f"{ms[0]:.2f} ms (phase 7 (a): {ref['prefill_ms']:.2f} ms), decode "
        f"{dec:.3f} ms a token (p50 of {DRY_PLACED_STEPS}; phase 7 (a): "
        f"{ref['decode_ms_p50']:.3f} ms); logits against phase 7 (a)'s max "
        f"abs {err:.4g} (tol {TOL_LM_BF16}), bit-equal {same}")
    check(bool(torch.isfinite(logits).all()), "(e) non-finite logits")
    check(err <= TOL_LM_BF16, f"(e) placed logits part from phase 7 (a)'s "
          f"by {err}")
    del params, placed
    torch.cuda.empty_cache()
    return {"prefill_ms": ms[0], "decode_ms_p50": dec, "decode_ms": ms[1:],
            "phase7_prefill_ms": ref["prefill_ms"],
            "phase7_decode_ms_p50": ref["decode_ms_p50"],
            "logits_max_abs": err, "bit_equal": same}


def phase_dryrun(torch, started: dict, lm: dict, train: dict) -> dict:
    """Phase 10 (see the module docstring). The main process's arms
    launch none of the five kernels (counted); arm (d)'s subprocess counts
    its own from 0. ``started`` holds the subprocess arms' outputs
    (``dry_join``)."""
    launches = {}

    def counted(arm, fn, *args):
        zero_launches()
        out = fn(*args)
        launches[arm] = launches_now()
        check(sum(launches[arm].values()) == 0,
              f"dry-run arm ({arm}) launched a search kernel: {launches[arm]}")
        return out

    d = dry_search(torch, started["dir"])
    launches["d"] = {k: d["launches"].get(k, 0) for k in KERNELS}
    check(launches["d"]["dtw_ea_multi_fused"] > 0
          and launches["d"]["lb_keogh_all_windows"] > 0,
          f"(d) the search cell launched {launches['d']}")
    e = counted("e", dry_placed_serve, torch, lm["placed_ref"])
    c = counted("c", dry_count, torch, started, train["arms"]["a"])
    cells = dry_cells(torch)
    return {"arms": {**cells, "c": c, "d": d, "e": e, "launches": launches},
            "launches": launches}


def main() -> int:
    import os

    # Phase 8 runs arms under torch.use_deterministic_algorithms, which
    # needs cuBLAS's workspace fixed before CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say(f"  ({label}: {time.perf_counter() - t0:.2f} s)")
        return out

    card = timed("phase 1", phase_card, torch)
    timed("phase 2", phase_build)
    from repro_torch.configs.dtw_search import SearchConfig

    cfg = SearchConfig()
    ref, queries = main_path_inputs(torch, cfg, DEVICE)
    plan = cfg.make_plan()
    from repro_torch.search.pipeline import cascade, prepare_queries, prepare_ref

    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb_sorted = cascade(plan, prep, pq.qn)
    kb = timed("phase 3 kernel B", phase_kernel_b, torch, prep, pq, plan)
    timed("phase 3 kernel B sweep", phase_kernel_b_sweep, torch)
    ka = timed("phase 3 kernel A", phase_kernel_a, torch, prep, pq, plan,
               order, lb_sorted)
    kd = timed("phase 3 kernel D", phase_kernel_d, torch, prep, pq, plan, ka)
    timed("phase 3 repeat", phase_repeat, torch, prep, plan, kb, ka)
    short = timed("phase 3 short row", phase_short_row, torch)
    host = timed("phase 4 host rounds", phase_end_to_end, torch, cfg, ref,
                 queries, "host")
    loop = timed("phase 4 host loop", host_loop_split, torch, cfg, ref,
                 queries)
    timed("phase 4 counters", phase_info_search, torch, cfg, ref, queries,
          host)
    sweep = timed("phase 4 persistent", phase_end_to_end, torch, cfg, ref,
                  queries, "persistent", host)
    slab = timed("phase 4 slab arms", phase_slab_arms, torch, cfg, ref,
                 queries, host, sweep)
    stream = timed("phase 4 stream", phase_stream, torch, cfg, ref, queries,
                   host)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    resil = timed("phase 4 resilient", phase_resilient, torch, cfg, ref,
                  queries, host, sweep, stream, workdir)
    shard = timed("phase 4 sharded", phase_sharded, torch, cfg, ref, queries,
                  host, slab)
    wide = timed("phase 4 wide", phase_wide_search, torch)
    # phase 10's subprocess arms and phase 5's CPU halves, on the host's
    # cores, beside the card's checks that time nothing but their plain
    # versions (the sweeps of C and E, their plain sweeps on the card
    # bound, and the wide row's)
    dry = dry_start(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        kce = timed("phase 3 kernels C, E", phase_kernel_ce, torch, prep, pq,
                    plan, order, lb_sorted)
        del order, lb_sorted
        kw = timed("phase 3 wide", phase_kernels_wide, torch)
        long_row = timed("phase 3 long row", phase_long_row, torch)
    except BaseException:
        dry_stop(dry)
        raise
    timed("phase 10 subprocess arms (the wait)", dry_join, dry)
    cpu = arm_result(dry, "cpu_ref")
    timed("phase 5", phase_cross_check, torch, cpu["cross"])
    timed("phase 5 stream cross-check", phase_stream_cross, torch, cfg,
          cpu["stream"])
    timed("phase 5 wide cross-check", phase_wide_cross, torch, cpu["wide"])
    timed("phase 5 baselines", phase_baselines, torch, cfg)
    kernels = timed("phase 6", phase_times, torch, kb, ka, kd, kce, loop)
    wide_ms = timed("phase 6 wide", phase_times_wide, torch, kw, wide)
    short_ms = timed("phase 6 short row", phase_times_short, torch, short)
    lm = timed("phase 7 lm serve", phase_lm, torch)
    train = timed("phase 8 lm train", phase_train, torch)
    sharded = timed("phase 9 lm sharded", phase_sharded_train, torch, train)
    dryrun = timed("phase 10 dryrun", phase_dryrun, torch, dry, lm, train)
    # Launches on the path that runs each kernel: host rounds (A, B), the
    # persistent sweep (C), the slab arms (D, E).
    launches = dict(host["launches"])
    launches["dtw_ea_persistent_fused"] = sweep["launches"]["dtw_ea_persistent_fused"]
    launches["dtw_ea_multi"] = slab["dtw_ea_multi"]
    launches["dtw_ea_persistent"] = slab["dtw_ea_persistent"]
    # Streaming launches: arm (a) for A and B, arm (c) for D.
    stream_launches = dict(stream["a"], dtw_ea_multi=stream["c"]["dtw_ea_multi"])
    # The host layer's: the clean resilient search (a) for A and B, its
    # persistent form (b) for C.
    resil_launches = dict(resil["a"])
    resil_launches["dtw_ea_persistent_fused"] = resil["b"].get(
        "dtw_ea_persistent_fused", 0)
    # The sharded path's: the group of one (a), fused for A and B, slab
    # for D.
    shard_launches = dict(shard["a"], dtw_ea_multi=shard["a_slab"].get(
        "dtw_ea_multi", 0))
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["stream_launches"] = stream_launches[k["name"]]
        k["resilient_launches"] = resil_launches.get(k["name"], 0)
        k["sharded_launches"] = shard_launches.get(k["name"], 0)
        k["lm_launches"] = {arm: n[k["name"]]
                            for arm, n in lm["launches"].items()}
        k["train_launches"] = {arm: n[k["name"]]
                               for arm, n in train["launches"].items()}
        k["sharded_train_launches"] = {
            arm: n[k["name"]] for arm, n in sharded["launches"].items()}
        # the search cell's (arm (d)); the other arms launch none
        k["dryrun_launches"] = dryrun["launches"]["d"][k["name"]]
        # the wide search's (phase 4 wide), each driver's; the wide row's
        # times at each band of phase 3 (kernel B has no band)
        k["wide_launches"] = {r: wide[r]["launches"][k["name"]]
                              for r in ("host", "persistent")}
        letter = WIDE_LETTERS.get(k["name"])
        k["wide"] = wide_ms[letter] if letter else None
        k["wide_max_abs_err"] = kw["max_abs_err"][letter] if letter else None
        # kernels A and B at the short query (phase 3 short row)
        k["short_row"] = short_ms.get(k["name"])
    say(f"[3 wide] largest relative error of the wide row against the plain "
        f"version {kw['max_abs_err']['rel']:.3e}, of its counters' cells "
        f"{kw['max_abs_err']['cells']:.3e}; long row (l = {LONG_ROW[0]}, "
        f"CPT = 32): A {long_row['rel_A']:.3e}, C {long_row['rel_C']:.3e} "
        f"(tol {TOL_WIDE})")
    say(f"total {time.perf_counter() - t_all:.2f} s")
    say(json.dumps({"stream": stream["arms"]}))
    say(json.dumps({"resilient": resil["arms"]}))
    say(json.dumps({"sharded": shard["arms"]}))
    say(json.dumps({"lm_serve": lm["arms"]}))
    say(json.dumps({"lm_train": train["arms"]}))
    say(json.dumps({"lm_sharded": sharded["arms"]}))
    say(json.dumps({"dryrun": dryrun["arms"]}))
    say(json.dumps({"kernels": kernels}))
    say(card["smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard"]:
        sys.exit(shard_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--dry-count"]:
        sys.exit(dry_count_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--cpu-ref"]:
        sys.exit(cpu_ref_worker(json.loads(sys.argv[2])))
    sys.exit(main())
