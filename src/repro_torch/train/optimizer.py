"""Optimizers: AdamW and Adafactor (factored second moments) (port of
``repro/train/optimizer.py``).

Plain tensor code, float32 math; parameters are cast back to their own
dtype after each update and no float32 master copy is kept, as in
``repro``. Adafactor's factored row/column statistics cost O(rows + cols)
instead of O(rows * cols) (the Kimi-K2 config's optimizer).

Updates are in place: ``repro``'s jitted step donates its state, and here
the parameters and the moments are overwritten where they lie, so a step
holds no second copy of either. Each update returns ``(params, state)``
with the same tensors and the step counter advanced.

``repro`` decides per stacked leaf (``train.layout``): AdamW's decoupled
weight decay applies to a leaf of rank >= 2 and Adafactor factors one, so
a layer's norm scale, ``(L, D)`` stacked, is decayed and factored; its
factored column statistic then runs over the layers; its update-RMS clip
takes one RMS over the whole stack. The update functions take ``cfg``
(the model's config, which names the stacked lists) to do the same over
the port's per-layer lists; ``cfg`` None treats every leaf alone.

Adafactor's state has the parameters' per-layer structure. Where
``repro``'s column statistic has no layer axis (a stack of vectors or
scalars), every layer's entry holds that one statistic, the same values
in each (``interop.train_state_to_numpy`` keeps one).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.train.layout import (
    full,
    get,
    leaves,
    rank,
    stacks,
    tree_map,
    unflatten,
)


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


class AdafactorState(NamedTuple):
    vr: Any     # row statistics (or full v for <2D params)
    vc: Any     # col statistics (or None-like zeros)
    step: torch.Tensor


def _device(tree) -> torch.device:
    return leaves(tree)[0][1].device


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf, a plain 0-d tensor (each placed leaf's sum
    of squares is reduced over its mesh before the leaves are added, in
    the one-device order)."""
    return torch.sqrt(
        sum(full(torch.sum(torch.square(x.float()))) for _, x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns ``(grads, norm before clipping)``."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for _, g in leaves(grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


def cosine_schedule(step, base_lr: float, warmup: int, total: int) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0, in float32 on ``step``'s
    device."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def _step0(tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(tree))


# ------------------------------- AdamW -------------------------------------


def adamw_init(params) -> AdamWState:
    zeros = lambda p: _zeros(p.shape, p.device)
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=_step0(params))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    cfg=None,
):
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for stack in stacks(cfg, params):
        decay = rank(stack, params) >= 2  # decoupled weight decay on matrices
        for path in stack.paths:
            p, m, v = get(params, path), get(state.m, path), get(state.v, path)
            g32 = get(grads, path).float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            update = (m / c1) / (torch.sqrt(v / c2) + eps)
            if decay:
                update = update + weight_decay * p.float()
            p.copy_((p.float() - lr * update).to(p.dtype))
    return params, AdamWState(m=state.m, v=state.v, step=step)


# ------------------------------ Adafactor ----------------------------------


def adafactor_init(params, cfg=None) -> AdafactorState:
    shapes = {}  # a parameter's path -> (vr's shape, vc's shape)
    for stack in stacks(cfg, params):
        factored = rank(stack, params) >= 2
        for path in stack.paths:
            shp = get(params, path).shape
            if not factored:
                shapes[path] = (shp, (1,))
            elif len(shp) >= 2:
                shapes[path] = (shp[:-1], shp[:-2] + shp[-1:])
            else:  # a stack of vectors: vc runs over the layers
                shapes[path] = (shp[:-1], shp)
    dev = _device(params)
    order = [path for path, _ in leaves(params)]
    return AdafactorState(
        vr=unflatten(params, [_zeros(shapes[q][0], dev) for q in order]),
        vc=unflatten(params, [_zeros(shapes[q][1], dev) for q in order]),
        step=_step0(params),
    )


@torch.no_grad()
def adafactor_update(
    params,
    grads,
    state: AdafactorState,
    lr,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    cfg=None,
):
    step = state.step + 1
    t = step.float()
    beta = 1.0 - t ** -decay  # increasing decay schedule (Shazeer & Stern)
    for stack in stacks(cfg, params):
        n = len(stack.paths)
        ps = [get(params, q) for q in stack.paths]
        gs = [get(grads, q).float() for q in stack.paths]
        vrs = [get(state.vr, q) for q in stack.paths]
        vcs = [get(state.vc, q) for q in stack.paths]
        if rank(stack, params) < 2:
            for g, vr in zip(gs, vrs):
                vr.mul_(beta).add_((1 - beta) * (g * g + eps))

            def precond(i):
                return gs[i] / torch.sqrt(vrs[i])
        elif ps[0].dim() >= 2:
            for g, vr, vc in zip(gs, vrs, vcs):
                g2 = g * g + eps
                vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))

            def precond(i):
                vr = vrs[i]
                r = vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
                return gs[i] / (torch.sqrt(r)[..., None]
                                * torch.sqrt(vcs[i])[..., None, :])
        else:  # a stack of vectors, (L, D) in repro: rows are layers
            g2s = [g * g + eps for g in gs]
            for g2, vr in zip(g2s, vrs):
                vr.mul_(beta).add_((1 - beta) * torch.mean(g2))
            vc = beta * vcs[0] + (1 - beta) * (sum(g2s) / n)
            for each in vcs:
                each.copy_(vc)
            vr_mean = torch.clamp_min(sum(vrs) / n, eps)

            def precond(i):
                return gs[i] / (torch.sqrt(vrs[i] / vr_mean) * torch.sqrt(vc))
        # update clipping (RMS <= clip_threshold) over repro's whole leaf;
        # the preconditioned update is formed twice rather than kept
        size = sum(p.numel() for p in ps)
        sq = sum(full(torch.sum(torch.square(precond(i)))) for i in range(n))
        rms = torch.sqrt(sq / size + 1e-12)
        denom = torch.clamp_min(rms / clip_threshold, 1.0)
        for i, p in enumerate(ps):
            p.copy_((p.float() - lr * (precond(i) / denom)).to(p.dtype))
    return params, AdafactorState(vr=state.vr, vc=state.vc, step=step)


def init_opt(cfg, params):
    if cfg.optimizer == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params)


def apply_opt(cfg, params, grads, state, lr):
    if cfg.optimizer == "adafactor":
        return adafactor_update(params, grads, state, lr, cfg=cfg)
    return adamw_update(params, grads, state, lr, cfg=cfg)
