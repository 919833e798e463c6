"""Train-step builder: microbatched gradient accumulation + optimizer apply
(port of ``repro/train/train_step.py``).

Gradients accumulate in float32 across ``cfg.num_microbatches``
sequential microbatches, which bounds peak activation memory: each
microbatch's gradients come from ``torch.autograd.grad`` in the
parameters' dtype (bfloat16 for the full-width configs, as ``repro``'s
``value_and_grad``) and are added into the float32 accumulator, so no
sum is ever rounded to bfloat16. Parameters and activations keep the
config's dtype; the optimizer keeps no float32 master copy.

The step works in place, as ``repro``'s jitted step with its state
donated: ``train_step(state, batch)`` overwrites ``state``'s parameters
and optimizer moments and returns a ``TrainState`` holding the same
tensors with ``step`` advanced. A caller that needs the state before a
step keeps a copy.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.common import resolve_device
from repro_torch.models.common import plain
from repro_torch.train.layout import leaves, tree_map, unflatten
from repro_torch.train.optimizer import (
    apply_opt,
    clip_by_global_norm,
    cosine_schedule,
    init_opt,
)


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor
    ef: Any = None  # ErrorFeedback residuals when grad compression is on


def trainable(params):
    """``params`` (a ``ParamTree`` or a tree of tensors) as a tree of
    tensors that require grad, sharing the parameters' storage."""
    return tree_map(lambda p: p.detach().requires_grad_(True), plain(params))


def init_state(model, generator: torch.Generator,
               grad_compression: str | None = None, device=None) -> TrainState:
    """A fresh state: ``model.init(generator, device)``'s weights, made
    trainable, and zeroed optimizer state, on ``device`` (default: the
    card; raises without one)."""
    from repro_torch.train.compression import init_error_feedback

    dev = resolve_device(device)
    params = trainable(model.init(generator, dev))
    return TrainState(
        params=params,
        opt=init_opt(model.cfg, params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        ef=init_error_feedback(params) if grad_compression else None,
    )


def _batch_tensor(x, device) -> torch.Tensor:
    """A batch entry (numpy or tensor) on ``device``; integer entries
    (tokens, labels) as int64 for indexing."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def make_train_step(
    model,
    base_lr: float = 3e-4,
    warmup: int = 2000,
    total_steps: int = 100_000,
    max_grad_norm: float = 1.0,
    grad_compression: str | None = None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` (numpy arrays or tensors) has leading dim ``global_batch``;
    it is moved to the parameters' device and split into
    ``cfg.num_microbatches`` microbatches run in sequence. ``metrics``
    holds ``loss``, ``grad_norm`` (before clipping) and ``lr`` as 0-d
    float32 tensors on the device; nothing is read back to the host.
    """
    cfg = model.cfg
    n_micro = max(cfg.num_microbatches, 1)

    def split_micro(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    def train_step(state: TrainState, batch: dict):
        params = state.params
        flat = [p for _, p in leaves(params)]
        dev = flat[0].device
        micro = {k: split_micro(_batch_tensor(v, dev)) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in flat]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            with torch.enable_grad():
                loss = model.loss_fn(params, {k: v[i] for k, v in micro.items()})
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:  # an unused parameter's gradient is zero
                    a.add_(g)      # g in the params' dtype, summed in float32
            lsum += loss.detach()
            del grads, loss
        for a in acc:
            a.div_(n_micro)
        grads = unflatten(params, acc)
        loss = lsum / n_micro

        new_ef = state.ef
        if grad_compression == "int8":
            # int8 wire format for the cross-pod reduce, with error feedback
            from repro_torch.train.compression import compress_grads

            grads, new_ef = compress_grads(grads, state.ef, cfg)

        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = cosine_schedule(state.step, base_lr, warmup, total_steps)
        new_params, new_opt = apply_opt(cfg, params, grads, state.opt, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt, state.step + 1, new_ef), metrics

    return train_step
