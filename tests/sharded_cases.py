"""The sharded-search cases of ``tests/test_torch_sharded.py``, run by each
package on one mesh config.

Both the test process and its spawned workers import this module: a port
rank runs ``port_cases`` on its ``torch.distributed`` group, and a ``repro``
worker runs ``repro_cases`` on a ``jax`` mesh. Each returns the same dict of
plain lists, so the test compares them field by field.

Worker mode (the test starts these; ``JAX_PLATFORMS=cpu``)::

    RANK=r WORLD_SIZE=n python tests/sharded_cases.py port STORE [AXES]
    python tests/sharded_cases.py repro

A port rank joins a gloo group through the file store ``STORE``; with
``AXES`` (``data,model``) it builds a 2 x 2 ``DeviceMesh`` of those names
and shards over both, and also reports its ``(n_shards, shard)`` under
each order of the names and under the first alone. The ``repro`` worker
forces 4 host devices and runs the meshes ``(2,)`` and ``(2, 2)``. Each
prints one ``RESULT <json>`` line.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

N, L, W, Q, B = 1_200, 96, 9, 3, 32   # 1,105 windows: padded at 2 and 4 shards
LO, HI = 150, 900                     # the range of the run_range case
CARRY_UB = (5.0, float("inf"), 6.0)   # the state it carries in
CARRY_BEST = (3, -1, 1_000)
BURSTS = [(200, 5, np.nan), (700, 2, np.inf)]


def make_data():
    """The ECG-like reference with the planted non-finite runs, and the
    queries, both float32, from ``fault_seed``."""
    from faults import fault_seed, plant_nonfinite

    rng = np.random.default_rng(fault_seed())
    ref = np.cumsum(rng.normal(size=N))
    ref = plant_nonfinite(ref, BURSTS).astype(np.float32)
    qs = np.cumsum(rng.normal(size=(Q, L)), axis=1).astype(np.float32)
    return ref, qs


def _row(res) -> dict:
    return {k: np.asarray(getattr(res, k)).tolist()
            for k in ("best_start", "best_dist", "rounds", "quarantined")}


def _range_row(rr) -> dict:
    return {"best_start": np.asarray(rr.state.best).tolist(),
            "best_dist": np.asarray(rr.state.ub).tolist(),
            "rounds": np.asarray(rr.stats.rounds).tolist(),
            "lanes": np.asarray(rr.stats.lanes).tolist(),
            "quarantined": int(rr.quarantined)}


def port_cases(group, axis_names, ref, qs) -> dict:
    """Every case on the port's mesh config (``group``: a process group or
    a ``DeviceMesh``), on the CPU."""
    import torch

    from repro_torch.search import (
        IncumbentState,
        ShardedExecutor,
        get_executor,
        make_distributed_multi_search,
        make_distributed_search,
    )
    from repro_torch.search.pipeline import MULTI_VARIANTS, make_plan

    out = {"single": _row(make_distributed_search(
        group, axis_names, L, W, batch=B, device="cpu")(ref, qs[0]))}
    for gather in ("fused", "slab"):
        out[gather] = _row(make_distributed_multi_search(
            group, axis_names, L, W, batch=B, gather=gather,
            device="cpu")(ref, qs))
    plan = make_plan(length=L, window=W, batch=B,
                     allowed_variants=MULTI_VARIANTS)
    ex = get_executor(plan, ref, qs, mesh=group, axis_names=axis_names,
                      device="cpu")
    assert isinstance(ex, ShardedExecutor)
    state = IncumbentState(ub=torch.tensor(CARRY_UB),
                           best=torch.tensor(CARRY_BEST))
    out["range"] = _range_row(ex.run_range(plan, state, LO, HI))
    return out


def repro_cases(mesh, axis_names, ref, qs) -> dict:
    """Every case on ``repro``'s mesh, float32, ``backend="jax"``."""
    import jax.numpy as jnp

    from repro.search import (
        IncumbentState,
        ShardedExecutor,
        make_distributed_multi_search,
        make_distributed_search,
        make_plan,
    )
    from repro.search.pipeline import MULTI_VARIANTS

    ref_j = jnp.asarray(ref, jnp.float32)
    qs_j = jnp.asarray(qs, jnp.float32)
    out = {"single": _row(make_distributed_search(
        mesh, axis_names, L, W, batch=B, backend="jax")(ref_j, qs_j[0]))}
    for gather in ("fused", "slab"):
        out[gather] = _row(make_distributed_multi_search(
            mesh, axis_names, L, W, batch=B, gather=gather,
            backend="jax")(ref_j, qs_j))
    plan = make_plan(length=L, window=W, batch=B, backend="jax",
                     allowed_variants=MULTI_VARIANTS)
    state = IncumbentState(ub=jnp.asarray(CARRY_UB, jnp.float32),
                           best=jnp.asarray(CARRY_BEST, jnp.int32))
    ex = ShardedExecutor(mesh, axis_names, ref_j, qs_j)
    out["range"] = _range_row(ex.run_range(plan, state, LO, HI))
    return out


def _port_worker(store: str, axes: str) -> dict:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        group, names = dist.group.WORLD, None
        if axes:
            from torch.distributed.device_mesh import init_device_mesh

            from repro_torch.search.pipeline import _shard_layout

            names = tuple(axes.split(","))
            group = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
            layout = {",".join(a): _shard_layout(group, a)[1:]
                      for a in (names, names[::-1], names[:1])}
            return dict(port_cases(group, names, *make_data()),
                        layout=layout)
        return port_cases(group, names, *make_data())
    finally:
        dist.destroy_process_group()


def _repro_worker() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    devs = np.array(jax.devices())
    ref, qs = make_data()
    return {
        "2": repro_cases(jax.sharding.Mesh(devs[:2], ("d",)), ("d",), ref,
                         qs),
        "4": repro_cases(jax.sharding.Mesh(devs.reshape(2, 2),
                                           ("data", "model")),
                         ("data", "model"), ref, qs),
    }


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "..", "src")]
    if sys.argv[1] == "port":
        result = _port_worker(sys.argv[2],
                              sys.argv[3] if len(sys.argv) > 3 else "")
    else:
        result = _repro_worker()
    print("RESULT " + json.dumps(result), flush=True)
