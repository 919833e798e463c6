"""The port's roofline tooling against ``repro``'s, as data.

* ``roofline.analysis``: ``param_counts`` and ``model_flops`` equal
  ``repro``'s for every arch and shape; ``analyze_cell`` and
  ``render_markdown`` give the three terms on the H100's rates.
* ``launch.input_specs``: every stand-in has ``repro``'s shape and dtype.
* ``launch.dryrun``'s analytic bytes: parameters, train state and decode
  cache per device equal ``repro``'s ``_sharded_bytes`` (its formula, on
  its specs over ``tests/test_sharding.py``'s repeated-device mesh) for
  every arch on ``(16, 16)`` and ``(2, 16, 16)``.
* ``roofline.op_stats.OpCounter``: local FLOPs only, every loop trip,
  ``repro``'s collective conventions, and DTensor's CPU all-to-all
  counted as an all-to-all.

The port's meshes are ``DeviceMesh``es on torch's ``fake`` backend (a
world of 512 ranks in this process, destroyed when the module's tests
end). ``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` at
import.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.distributed import sharding as r_sharding
from repro.launch import input_specs as r_inputs
from repro.models.registry import build as r_build
from repro.roofline import analysis as r_analysis
from repro.train.train_step import init_state as r_init_state
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, input_specs
from repro_torch.launch.mesh import (
    H100_HBM_BW,
    H100_NIC_BW,
    H100_NVLINK_BW,
    H100_PEAK_BF16_FLOPS,
)
from repro_torch.models.registry import build
from repro_torch.roofline import analysis
from repro_torch.roofline.op_stats import OpCounter
from repro_torch.train.train_step import init_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module")
def meshes():
    """``{name: (port DeviceMesh, repro Mesh)}`` for both meshes."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        out = {}
        for name, (shape, axes) in MESHES.items():
            n = int(np.prod(shape))
            mine = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                              mesh_dim_names=axes)
            devs = np.array([jax.devices()[0]] * n).reshape(shape)
            out[name] = (mine, jax.sharding.Mesh(devs, axes))
        yield out
    finally:
        dist.destroy_process_group()


def r_sharded_bytes(shapes, specs, mesh) -> int:
    """``repro/launch/dryrun.py``'s ``_sharded_bytes``."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, RP))):
        shards = 1
        for entry in tuple(spec):
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                shards *= mesh.shape[a]
        total += leaf.size * jnp.dtype(leaf.dtype).itemsize // max(shards, 1)
    return total


# ----------------------------- analysis -----------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_counts_and_model_flops_are_repros(name):
    assert analysis.param_counts(ARCHS[name]) == \
        r_analysis.param_counts(R_ARCHS[name])
    for shape in SHAPES:
        assert analysis.model_flops(ARCHS[name], SHAPES[shape]) == \
            r_analysis.model_flops(R_ARCHS[name], R_SHAPES[shape])


def test_analyze_cell_and_render_on_the_h100():
    cell = {"arch": "llama3.2-3b", "shape": "train_4k", "multi_pod": False,
            "status": "ok", "mesh": {"data": 16, "model": 16},
            "hlo_stats": {"dot_flops": 9.89e14, "mem_bytes": 6.7e12,
                          "collective_total": 1.95e11,
                          "collective_cross_node": 1.5e11,
                          "collective_bytes": {"all-gather": 1.95e11}}}
    row = analysis.analyze_cell(cell)
    assert row["compute_s"] == pytest.approx(9.89e14 / H100_PEAK_BF16_FLOPS)
    assert row["memory_s"] == pytest.approx(6.7e12 / H100_HBM_BW)
    # within a node over a card's NVLink, across nodes over its NIC
    assert row["collective_s"] == pytest.approx(
        4.5e10 / H100_NVLINK_BW + 1.5e11 / H100_NIC_BW)
    assert row["compute_s"] == pytest.approx(1.0)
    assert row["memory_s"] == pytest.approx(2.0)
    assert row["collective_s"] == pytest.approx(3.1)
    assert row["dominant"] == "collective"
    assert row["chips"] == 256
    mf = analysis.model_flops(ARCHS["llama3.2-3b"], SHAPES["train_4k"])
    assert row["roofline_fraction"] == pytest.approx(
        mf / 256 / H100_PEAK_BF16_FLOPS / row["collective_s"])
    skipped = {"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "16x16",
               "skipped": "full quadratic attention"}
    text = analysis.render_markdown([row, skipped], "16x16")
    lines = text.splitlines()
    assert len(lines) == 4
    assert "| llama3.2-3b | train_4k | 1.00s | 2.00s | 3.10s | **collective** |" \
        in lines[2]
    assert "skip" in lines[3]
    assert "MXU" not in text and "NVLink" in analysis.FIX_NOTES["collective"]
    assert analysis.render_markdown([row], "2x16x16").count("\n") == 1
    assert analysis.fmt_s(2.5) == "2.50s" and analysis.fmt_s(2.5e-3) == "2.50ms"
    assert analysis.fmt_s(2.5e-6) == "2.5us"


# ----------------------------- input specs --------------------------------

def _same(mine: dict, theirs: dict):
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert tuple(mine[k].shape) == tuple(theirs[k].shape), k
        assert mine[k].dtype == DTYPES[theirs[k].dtype.type], k


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_are_repros(name):
    model, r_model = build(ARCHS[name]), r_build(R_ARCHS[name])
    for s in SHAPES:
        cfg, shape = ARCHS[name], SHAPES[s]
        r_cfg, r_shape = R_ARCHS[name], R_SHAPES[s]
        assert input_specs.applicable(cfg, shape) == \
            r_inputs.applicable(r_cfg, r_shape)
        _same(input_specs.train_batch_specs(cfg, shape),
              r_inputs.train_batch_specs(r_cfg, r_shape))
        _same(input_specs.prefill_inputs(cfg, shape),
              r_inputs.prefill_inputs(r_cfg, r_shape))
        _same(input_specs.decode_inputs(cfg, shape),
              r_inputs.decode_inputs(r_cfg, r_shape))
    shape = SHAPES["decode_32k"]
    mine = input_specs.cache_shapes(model, shape)
    theirs = r_inputs.cache_shapes(r_model, R_SHAPES["decode_32k"])
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    from repro_torch.train.layout import leaves

    got = leaves(mine)
    assert len(got) == len(flat)
    for (_, t), (_, r) in zip(got, flat):
        assert t.device.type == "meta"
        assert tuple(t.shape) == r.shape
        assert str(t.dtype).split(".")[-1] == str(r.dtype)


# ----------------------------- bytes --------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bytes_per_device_are_repros(meshes, name, mesh_name):
    mine, theirs = meshes[mesh_name]
    model, r_model = build(ARCHS[name]), r_build(R_ARCHS[name])
    key = jax.random.PRNGKey(0)
    r_params = jax.eval_shape(r_model.init, key)
    assert dryrun._sharded_bytes(
        sharding.param_shapes(model), sharding.make_param_specs(model, mine),
        mine) == r_sharded_bytes(
            r_params, r_sharding.make_param_specs(r_model, theirs), theirs)

    r_state = jax.eval_shape(lambda k: r_init_state(r_model, k), key)
    assert dryrun._state_bytes(
        model, init_state(model, None, device="meta"),
        sharding.make_state_specs(model, mine), mine) == r_sharded_bytes(
            r_state, r_sharding.make_state_specs(r_model, theirs), theirs)

    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    r_cache = jax.eval_shape(lambda: r_model.init_cache(b, s))
    assert dryrun._sharded_bytes(
        model.init_cache(b, s, "meta"),
        sharding.make_cache_specs(model, mine, b, s), mine) == r_sharded_bytes(
            r_cache, r_sharding.make_cache_specs(r_model, theirs, b, s), theirs)


# ----------------------------- counter pins -------------------------------

def _placed(mesh, shape, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype), mesh,
                             placements, src_data_rank=None)


def test_dtensor_product_counts_local_flops_only(meshes):
    """(512, 4096) @ (4096, 8192) in bf16, rows over "data" x columns over
    both axes: rank 0's product only (2*512*256*512), not the global one
    that DTensor's sharding propagation also runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshes["16x16"][0]
    with FakeTensorMode():
        a = _placed(mesh, (512, 4096), (Shard(0), Replicate()), torch.bfloat16)
        b = _placed(mesh, (4096, 8192), (Shard(0), Shard(1)), torch.bfloat16)
        for _ in range(2):  # a propagation cache miss, then a hit
            with OpCounter() as c:
                a @ b
            assert c.stats()["dot_flops"] == 134_217_728


def test_loop_trips_all_count():
    a, b = torch.randn(8, 64), torch.randn(64, 64)
    with OpCounter() as c:
        for _ in range(5):
            a @ b
    st = c.stats()
    assert st["dot_flops"] == 2 * 8 * 64 * 64 * 5
    assert st["dynamic_loops"] == []
    assert st["mem_bytes"] == 5 * 4 * (8 * 64 + 64 * 64 + 8 * 64)


def test_collectives_follow_repros_conventions(meshes):
    """An all-reduce counts twice its bytes, a reduce-scatter its result
    times the group (its whole input), an all-gather its result; a
    ``torch.distributed`` call is counted as a functional one is. A
    group that spans nodes of 8 cards ("model": ranks 0-15) counts in
    ``collective_cross_node``, one within a node does not."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = meshes["16x16"][0]
    nbytes = 256 * 64 * 4
    with FakeTensorMode():
        x = torch.empty(256, 64)
        with OpCounter() as c:
            funcol.all_reduce(x, "sum", (mesh, 1))
            funcol.reduce_scatter_tensor(x, "sum", 0, (mesh, 1))
            funcol.all_gather_tensor(x, 0, (mesh, 1))
    st = c.stats()
    assert st["collective_bytes"] == {"all-reduce": 2 * nbytes,
                                      "reduce-scatter": nbytes,
                                      "all-gather": 16 * nbytes}
    assert st["collective_counts"] == {"all-reduce": 1, "reduce-scatter": 1,
                                       "all-gather": 1}
    assert st["collective_total"] == 19 * nbytes
    assert st["collective_cross_node"] == 19 * nbytes
    t = torch.ones(3)
    node = dist.new_group(list(range(8)))
    with OpCounter() as c:
        dist.all_reduce(t, group=mesh.get_group("model"))
        dist.all_reduce(t, group=node)
    assert c.stats()["collective_bytes"] == {"all-reduce": 48.0}
    assert c.stats()["collective_cross_node"] == 24.0


def test_cpu_all_to_all_is_counted_as_one(meshes):
    """DTensor runs ``Shard(0) -> Shard(1)`` as an all-gather and a chunk
    on a CPU mesh; the counter calls it an all-to-all of the bytes one
    would move (the local shard), never an all-gather."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshes["16x16"][0]
    with FakeTensorMode():
        x = _placed(mesh, (256, 64), (Shard(0), Replicate()))
        with OpCounter() as c:
            y = x.redistribute(mesh, (Shard(1), Replicate()))
    assert tuple(y.placements) == (Shard(1), Replicate())
    st = c.stats()
    assert st["collective_counts"] == {"all-to-all": 1}
    assert st["collective_bytes"] == {"all-to-all": 256 * 4 * 4}
    assert st["cpu_alltoall_fallbacks"] == 1
