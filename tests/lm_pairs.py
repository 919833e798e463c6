"""One language model in both packages, on the same weights.

``pair(name, **changes)`` builds ``repro``'s model and the port's for the
reduced config of ``name`` (with ``changes`` applied to both), initializes
``repro``'s from a fixed key and carries the weights over
(``repro_torch.interop.lm_params_from_numpy``). ``inputs`` makes a seeded
batch for both. ``repro``'s calls go through ``jax.jit`` with the decode
position traced, so that a decode loop compiles once (``repro`` traces a
new scan at every eager call).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.models.registry import build as r_build
from repro_torch.configs import ARCHS
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.registry import build

# Float32 logits of the two packages on the same weights and inputs agree
# to under 1e-6 at the reduced sizes (|logit| < 1); 1e-5 leaves a margin
# for the other order of float32 sums (XLA against PyTorch's CPU kernels).
ATOL = 1e-5


class Pair(NamedTuple):
    cfg: object          # the port's config
    r_model: object
    r_params: object
    model: object
    params: object
    r_forward: object    # jitted repro forward(params, **kw)
    r_decode: object     # jitted repro decode_step(params, cache, tok, pos)


def pair(name: str, **changes) -> Pair:
    r_cfg = dataclasses.replace(R_ARCHS[name].reduced(), **changes)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    r_model, model = r_build(r_cfg), build(cfg)
    r_params = r_model.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, r_params),
                                  "cpu")
    return Pair(cfg, r_model, r_params, model, params,
                jax.jit(lambda p, **kw: r_model.forward(p, **kw)),
                jax.jit(r_model.decode_step))


def inputs(cfg, rng, b: int, s: int) -> tuple[dict, dict]:
    """Forward keyword arguments for (repro, port): tokens, and for the
    embeddings-in archs float32 embeddings (whisper takes both)."""
    toks = rng.integers(0, cfg.vocab, (b, s))
    kw = {"tokens": toks}
    if cfg.input_embeds:
        kw["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        if cfg.family != "audio":
            del kw["tokens"]
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.as_tensor(v) for k, v in kw.items()})


def close(a, b, atol: float = ATOL) -> float:
    """Max |a - b| of a repro array and a port tensor; asserts <= atol."""
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= atol, err
    return err


def close_tree(a, b, atol: float = ATOL) -> None:
    """``close`` over two caches of the same layout (dicts of arrays)."""
    assert isinstance(b, dict) and set(a) == set(b), (sorted(a), sorted(b))
    for key in a:
        if isinstance(a[key], dict):
            close_tree(a[key], b[key], atol)
        else:
            close(a[key], b[key], atol)
