"""Gradient compression with error feedback (1-bit-Adam / PowerSGD lineage)
(port of ``repro/train/compression.py``).

int8 quantization with one symmetric scale per ``repro`` leaf, and a
float32 error-feedback accumulator so quantization noise is *recycled*
into the next step instead of lost (Seide et al. 2014; Tang et al. 2021).
A stacked leaf (``train.layout``) takes one scale over all its layers, as
``repro``'s ``(L, ...)`` array does.

Used by ``make_train_step(grad_compression="int8")``: gradients are
quantized after microbatch accumulation, dequantized for the optimizer,
and the residual is carried.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.layout import full, get, leaves, stacks, tree_map, unflatten


class ErrorFeedback(NamedTuple):
    residual: Any  # fp32, same structure as grads


def init_error_feedback(params) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


@torch.no_grad()
def compress_grads(grads, ef: ErrorFeedback, cfg=None) -> tuple[Any, ErrorFeedback]:
    """Quantize every gradient to int8 (simulated wire format) with error
    feedback: ``x = g + residual`` is rounded to ``scale * q`` with ``q``
    in [-127, 127] and ``scale = max|x| / 127`` over the stack, and the
    residual becomes ``x - scale * q``. Returns (dequantized grads,
    updated feedback). A float32 gradient and the residual are
    overwritten in place (the train step's accumulator is donated)."""
    deq = {}
    for stack in stacks(cfg, grads):
        pairs = [(get(grads, q), get(ef.residual, q)) for q in stack.paths]
        # x is formed twice rather than kept for the whole stack
        amax = torch.stack([full(torch.max(torch.abs(g.float() + r)))
                            for g, r in pairs]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for q, (g, r) in zip(stack.paths, pairs):
            x = g.float() + r
            qi = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            out = qi.float() * scale
            r.copy_(x - out)
            deq[q] = g.copy_(out) if g.dtype == torch.float32 else out
    order = [path for path, _ in leaves(grads)]
    return unflatten(grads, [deq[q] for q in order]), ef
