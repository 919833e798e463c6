"""Batched serving entry point of the port: prefill + decode over any
registered arch (the CLI of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
      --reduced --batch 4 --prompt-len 16 --new-tokens 32 --device cpu

Weights are random, drawn from ``--seed``. ``--device`` defaults to the
card (it raises without one); ``--device cpu`` runs on the CPU. Prints
``repro``'s lines, then the prefill's milliseconds and the decode's
milliseconds a token (host clock, synchronized on the card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.common import block_until_ready, resolve_device
from repro_torch.models.registry import build
from repro_torch.serve.generate import generate


def _timed(fn, times: list):
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
        return out
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    if model.prefill is None:
        raise SystemExit(f"{cfg.name} (family {cfg.family}) has no prefill path")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    n = sum(x.numel() for x in params.parameters())
    print(f"serving {cfg.name}: {n/1e6:.1f}M params, batch={args.batch}")

    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), device=dev)
    prefill_s, decode_s = [], []
    timed = model._replace(prefill=_timed(model.prefill, prefill_s),
                           decode_step=_timed(model.decode_step, decode_s))
    t0 = time.time()
    out = generate(
        timed, params, prompt, args.new_tokens, temperature=args.temperature,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
    )
    block_until_ready(out)
    dt = time.time() - t0
    tput = args.batch * args.new_tokens / dt
    print(f"generated {args.new_tokens} tokens x {args.batch} seqs "
          f"in {dt:.2f}s ({tput:.1f} tok/s)")
    print("sample continuation ids:", out[0, args.prompt_len:].cpu().numpy()[:16])
    decode_ms = 1e3 * sum(decode_s) / max(len(decode_s), 1)
    print(f"prefill {1e3 * sum(prefill_s):.2f} ms, decode {decode_ms:.2f} ms "
          f"a token ({dev.type})")


if __name__ == "__main__":
    main()
