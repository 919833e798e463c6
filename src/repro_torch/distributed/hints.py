"""Activation-sharding anchors (port of ``repro/distributed/hints.py``).

``repro``'s model code calls these at its anchor points (after the
embedding, after each block, at the logits, on decode scores); each is the
identity while no axes are set, which is the only state the port has: it
runs on one device. ``set_axes`` with axes raises, because the sharded
layout (FSDP / DTensor, and ``mlp.moe_ep``) comes with the sharding slice
(ROADMAP.md Queue 1 item 7c).
"""
from __future__ import annotations


def set_axes(batch_axes=None, tp_axis="model", seq_parallel: bool = False,
             mesh=None) -> None:
    """Accepts only the cleared state (``batch_axes`` and ``mesh`` None)."""
    if batch_axes is not None or mesh is not None:
        raise NotImplementedError(
            "activation sharding is not ported yet: it comes with the "
            "sharding slice (FSDP / DTensor, ROADMAP.md Queue 1 item 7c)"
        )


def clear() -> None:
    set_axes(None, None)


def mesh_info():
    """(mesh, batch_axes, tp_axis) when set; always None in the port."""
    return None


def constrain_acts(x):
    return x


def constrain_logits(x):
    return x


def constrain_decode_scores(scores):
    return scores
