"""Shared layer primitives: norms, rotary embeddings, initializers, loss
(port of ``repro/models/common.py``), and the port's parameter container.

Initializers draw from an explicit ``torch.Generator`` on the generator's
own device, in a fixed order; they cannot give ``jax.random``'s numbers,
so a test that holds the port to ``repro`` carries ``repro``'s weights
over (``repro_torch.interop.lm_params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints


def pdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamTree(nn.Module):
    """A nested parameter dict as a module, read as ``repro`` reads its
    pytree: ``p["wq"]``, ``"bq" in p``, ``p["layers"][i]``.

    A tensor entry becomes a parameter, a dict a ``ParamTree`` and a list
    or tuple an ``nn.ModuleList``. ``.to(device)`` moves the whole tree.
    The parameters are frozen (``requires_grad=False``), so serving
    records no graph: trainability belongs to the train state, whose
    ``train.train_step.init_state`` (or ``interop.train_state_from_numpy``)
    takes the same tensors out with ``plain`` and marks them.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(key, _node(value))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def plain(tree):
    """A ``ParamTree`` as nested dicts and lists of its tensors (the same
    storage); any other tree as it is."""
    if isinstance(tree, nn.ModuleList):
        return [plain(m) for m in tree]
    if isinstance(tree, nn.Module):
        out = dict(tree._parameters)
        out.update({k: plain(m) for k, m in tree._modules.items()})
        return out
    return tree


def remat(cfg, fn):
    """``fn`` under activation checkpointing as ``cfg.remat`` asks, while
    autograd records (``repro``'s ``jax.checkpoint`` of a layer's body):
    its activations are dropped after the forward and recomputed in the
    backward. ``remat_policy="dots"`` keeps the outputs of the products
    without batch dimensions (``aten.mm`` / ``addmm``, the weight
    products; ``dots_with_no_batch_dims_saveable``) and recomputes the
    rest, batched ``bmm`` included. Under ``no_grad`` (serving) ``fn`` runs
    as it is."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _save_dots} if cfg.remat_policy == "dots" else {}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _save_dots():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(
        [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _node(value) -> nn.Module:
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_node(v) for v in value])
    raise TypeError(f"no parameter-tree node for {type(value).__name__}")


class ShapeOnly:
    """Stands in for a ``torch.Generator`` on the meta device: the
    initializers given it draw nothing and return meta tensors of the
    weights' shapes and dtypes (``repro``'s ``jax.eval_shape`` of
    ``init``). ``build(cfg).init(None, "meta")`` uses it, so the sharding
    rules see a 1e12-parameter config's shapes with nothing allocated."""

    device = torch.device("meta")


def init_generator(gen, device):
    """What an ``init`` draws from: ``gen``, or ``ShapeOnly()`` when
    ``device`` is the meta device."""
    if device is not None and torch.device(device).type == "meta":
        return ShapeOnly()
    return gen


def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated at +-2,
    then scaled by ``fan_in ** -0.5`` (``trunc_normal_`` takes absolute
    bounds, so they are +-2 std)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return t.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.normal_(0.0, 0.02, generator=gen)
    return t.to(dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]`` (``repro``'s ``jnp.take``). On DTensors it runs
    per shard, as GSPMD partitions a gather from a vocab-sharded table:
    each model rank looks up the tokens of its vocabulary slice (zeros
    elsewhere) for its batch rows, and one all-reduce SUM over ``"model"``
    combines them (DTensor's own rule for the gather's backward fails on
    some torch versions). The rows are the same bits as one device's."""
    from torch.distributed.tensor import DTensor

    if not isinstance(embed, DTensor):
        return embed[tokens]
    from repro_torch.distributed.hints import from_local, to_local
    from repro_torch.distributed.sharding import row_axes

    mesh = embed.device_mesh
    names = tuple(mesh.mesh_dim_names)
    vocab, d = embed.shape
    bax = row_axes(mesh, tokens.shape[0])
    n_tp = dict(zip(names, mesh.shape)).get("model", 1)
    tp = "model" if vocab % n_tp == 0 else None
    # each rank's gradient of the table is a part over the axes that split
    # the tokens; over the others it computed the same rows
    table = to_local(embed, mesh, (tp, None), sums=tuple(bax or ()))
    tok = to_local(tokens, mesh, (bax,) + (None,) * (tokens.dim() - 1))
    lo = mesh.get_local_rank("model") * table.shape[0] if tp else 0
    own = (tok >= lo) & (tok < lo + table.shape[0])
    rows = table[torch.where(own, tok - lo, 0)] * own[..., None].to(table.dtype)
    return from_local(rows, mesh, (bax,) + (None,) * tokens.dim(),
                      tuple(tokens.shape) + (d,),
                      sums=("model",) if tp else ())


def tied_unembed(embed: torch.Tensor) -> torch.Tensor:
    """The tied table (V, D) as the unembedding (D, V). On a DTensor its
    D dimension comes whole first (FSDP's gather before use), so the
    product's gradient returns in the table's own placement, as
    ``embed_lookup``'s does, and autograd adds the two gradients without
    a plan that DTensor on torch 2.11 lacks (a sharded gradient made a
    pending sum, which a vocabulary that the model axis does not divide
    asks for)."""
    return hints.replicate_dims(embed, 1).T


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + scale``, in float32, cast back to x's type
    (with sequence parallelism on placed tensors, computed on sequence
    shards and then gathered: ``hints.seq_whole``)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return hints.seq_whole((x * (1.0 + scale.float())).to(dt))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, half-split (not interleaved).
    x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross entropy; logits (..., V) in any dtype, fp32 math."""
    from repro_torch.distributed.hints import replicate_dims

    # DTensor's gather along a vocab-sharded dim leaves a masked partial
    # that its later ops mishandle: the vocab is gathered first
    logits = replicate_dims(logits.float(), -1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.sum(mask).to(nll.dtype).clamp_min(1.0)
    return torch.mean(nll)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embedding table (length, dim)."""
    half = dim // 2
    scale = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=device)
        * (math.log(10000.0) / (half - 1)))
    pos = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
           * scale[None, :])
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along ``dim`` from
    ``h_{-1} = 0``; returns ``(prod_{s<=t} a_s, h_t)``.

    The port of ``jax.lax.associative_scan`` with the combine
    ``(al, bl), (ar, br) -> (al * ar, bl * ar + br)``: log2(n) doubling
    steps (Hillis-Steele), each a few whole-tensor ops. ``a`` may have
    size-1 dimensions where ``b`` is wider; it has ``b``'s length along
    ``dim``. The tree adds in another order than XLA's, so the two agree
    to float32 rounding, not bit for bit.
    """
    n = b.shape[dim]
    step = 1
    while step < n:
        a_prev, a_cur = a.narrow(dim, 0, n - step), a.narrow(dim, step, n - step)
        b_prev, b_cur = b.narrow(dim, 0, n - step), b.narrow(dim, step, n - step)
        b = torch.cat([b.narrow(dim, 0, step), b_prev * a_cur + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, step), a_prev * a_cur], dim)
        step *= 2
    return a, b
