"""Times one checkout's Llama-3.2-3B prefill on the card at the shapes of
``chip_smoke.py``'s phase 7 (4 x 512 prompt tokens, random bf16 weights
from the phase's seed), so that two commits can be compared in one call.

    python3 scripts/prefill_ab.py CHECKOUT

``CHECKOUT`` is the root of a checkout (``.`` for this one; unpack another
commit with ``git archive <commit> | tar -x -C <git-ignored dir>``); its
own ``chip_smoke.py`` helpers and ``src/repro_torch`` are used. Run the
checkouts in turn, each in its own process (A, B, B, A), since host
timings drift. Prints one ``AB {...}`` JSON line: phase 7's prefill ms
(three ``lm_generate`` calls), twelve prefills timed by CUDA events with
the host's time to issue each, and one profiled prefill's device busy ms
and kernel count, by kind, and a decode step's."""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import numpy as np
import torch

import chip_smoke as cs

assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import ARCHS
from repro_torch.models.registry import build

cfg = ARCHS[cs.LM_ARCH]
model = build(cfg)
params = model.init(torch.Generator(device="cuda").manual_seed(cs.LM_SEED), "cuda")
prompt = torch.as_tensor(np.random.default_rng(cs.LM_SEED).integers(
    0, cfg.vocab, (cs.LM_BATCH, cs.LM_PROMPT)), device="cuda")
gens = [cs.lm_generate(torch, model, params, prompt, cs.LM_NEW) for _ in range(3)]
ms, host = [], []
with torch.no_grad():
    for i in range(12):
        cache = model.init_cache(cs.LM_BATCH, cs.LM_PROMPT + cs.LM_NEW, device="cuda")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        logits, cache = model.prefill(params, cache, tokens=prompt)
        b.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
busy = cs.lm_device_busy(torch, model, params, prompt)
print("AB " + json.dumps({
    "tree": sys.argv[1],
    "generate_prefill_ms": [g["prefill_ms"] for g in gens],
    "generate_decode_ms_p50": [g["decode_ms_p50"] for g in gens],
    "loop_prefill_ms": ms, "loop_prefill_host_issue_ms": host,
    "prefill_device_ms": busy["prefill_device_ms"],
    "prefill_device_ops": busy["prefill_device_ops"],
    "prefill_kinds_ms": busy["prefill_kinds_ms"],
    "decode_device_ms_a_step": busy["device_ms_a_step"],
    "decode_device_ops_a_step": busy["device_ops_a_step"]}), flush=True)
