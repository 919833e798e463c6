"""Batched autoregressive generation: prefill + greedy/temperature decode
(port of ``repro/serve/generate.py``).

One prefill over the prompt (filling the KV, SSM or rolling-SWA cache),
then ``decode_step`` per token. Works for every registered architecture
that exposes a token ``prefill`` (the transformer family and mamba2).
Sampling draws from an explicit ``torch.Generator``; it cannot give
``jax.random``'s stream, so only greedy output is held to ``repro``.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def generate(
    model,
    params,
    prompt_tokens: torch.Tensor,
    max_new_tokens: int,
    max_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations for a (B, S) prompt batch.

    Greedy when ``temperature == 0``; otherwise softmax sampling from
    ``generator`` (default: one seeded with 0 on the prompt's device).
    Returns (B, S + max_new_tokens) tokens. As in ``repro``, the cache is
    built before the check for a prefill path.
    """
    b, s = prompt_tokens.shape
    dev = prompt_tokens.device
    total = max_len or (s + max_new_tokens)
    cache = model.init_cache(b, total, device=dev)
    if model.prefill is None:
        raise ValueError(f"{model.cfg.name} has no prefill path")
    logits, cache = model.prefill(params, cache, tokens=prompt_tokens)

    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(logits_1):
        if temperature == 0.0:
            return torch.argmax(logits_1, dim=-1).to(prompt_tokens.dtype)
        probs = torch.softmax(logits_1.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt_tokens.dtype)

    toks = [sample(logits[:, 0])]
    for i in range(max_new_tokens - 1):
        nxt = toks[-1][:, None]
        logits, cache = model.decode_step(params, cache, nxt, s + i)
        toks.append(sample(logits[:, 0]))
    return torch.cat([prompt_tokens] + [t[:, None] for t in toks], dim=1)
