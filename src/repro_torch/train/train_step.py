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

On placed state (``distributed.sharding.place``: every tensor a DTensor on
one ``DeviceMesh``) the same step runs as one program on every rank. The
batch is placed by ``make_batch_specs`` (a batch that is already placed
is kept). Each microbatch's gradient is cast to float32 and brought to
its parameter's placement before it is accumulated: autograd returns
whatever placement its last op left (a pending sum over the data axis,
often), and a pending sum is reduced and scattered there, in float32.
Plain tensors built inside the step (positions, masks, the learning
rate) hold the same values on every rank and count as replicated
(``hints.replicated_plain``). Metrics are plain 0-d tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.common import resolve_device
from repro_torch.distributed import hints
from repro_torch.models.common import plain
from repro_torch.train.layout import full, leaves, mesh_of, tree_map, unflatten
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

    def microbatches(batch: dict, mesh, dev) -> list[dict]:
        """One dict a microbatch. One device: microbatch i is the i-th run
        of rows. Placed: microbatch i is each data shard's i-th run of its
        rows (no communication; the step's mean over the batch is the
        same, its rows are grouped otherwise when there are several
        microbatches). Where a data shard holds fewer rows than there are
        microbatches (kimi-k2's 16 on the multi-pod mesh's 8 rows a
        shard), microbatch i is the global batch's i-th run of rows,
        split over the inner batch axes whose size divides its rows
        (``"data"`` without ``"pod"``) and whole over the others."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.distributed.sharding import (
            P,
            batch_axes,
            divisible_axes,
            place_batch,
            placements,
        )

        if mesh is not None:
            placed = place_batch(batch, mesh)
            rows = next(iter(placed.values())).to_local().shape[0]
        if mesh is None or rows % n_micro:
            micro = {k: split_micro(_batch_tensor(full(v), dev))
                     for k, v in batch.items()}
            out = [{k: v[i] for k, v in micro.items()} for i in range(n_micro)]
            if mesh is None:
                return out
            rows = next(iter(out[0].values())).shape[0]
            axes = divisible_axes(mesh, batch_axes(mesh), rows)
            return [{k: distribute_tensor(v, mesh, placements(mesh, P(
                axes, *([None] * (v.dim() - 1)))), src_data_rank=None)
                for k, v in mb.items()} for mb in out]
        out = [{} for _ in range(n_micro)]
        for k, x in placed.items():
            parts = split_micro(x.to_local())
            for i in range(n_micro):
                out[i][k] = DTensor.from_local(parts[i], mesh, x.placements,
                                               run_check=False)
        return out

    def train_step(state: TrainState, batch: dict):
        params = state.params
        flat = [p for _, p in leaves(params)]
        mesh = mesh_of(params)
        dev = flat[0].device
        with hints.replicated_plain(on=mesh is not None):
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in microbatches(batch, mesh, dev):
                with torch.enable_grad():
                    loss = model.loss_fn(params, mb)
                    grads = torch.autograd.grad(loss, flat, allow_unused=True)
                for a, g, p in zip(acc, grads, flat):
                    if g is None:  # an unused parameter's gradient is zero
                        continue
                    if mesh is not None:  # to the parameter's placement
                        g = g.float().redistribute(p.device_mesh, p.placements)
                    a.add_(g)  # g in the params' dtype, summed in float32
                lsum += full(loss.detach())
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
            # This frame can outlive the call: remat's recomputation keeps
            # the forward's frames (whose caller this is) in a reference
            # cycle until the garbage collector runs. Drop the float32
            # gradients now, or the next step allocates its own beside them.
            del acc, grads, a, g
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": full(lr)}
            return (TrainState(new_params, new_opt, state.step + 1, new_ef),
                    metrics)

    return train_step
