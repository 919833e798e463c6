"""The port's partitioning rules (``repro_torch.distributed.sharding``)
against ``repro``'s, as data: no collective runs.

``repro``'s side uses ``tests/test_sharding.py``'s mesh of one repeated
device; the port's is a ``DeviceMesh`` on torch's ``fake`` backend (a
world of 512 ranks in this process, destroyed when the module's tests
end). Both at the full configs, on ``(16, 16)`` ``("data", "model")`` and
``(2, 16, 16)`` ``("pod", "data", "model")``.

``repro`` stacks each layer's parameters on a leading axis; the port holds
per-layer lists. A port tensor that is one layer's slice of a ``repro``
leaf (one rank fewer) must carry ``repro``'s spec without its leading
``None``; any other port tensor (unstacked, or Adafactor's one column
statistic of a stack of vectors) ``repro``'s spec whole. Caches are
stacked in both.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

from repro.configs import ARCHS as R_ARCHS
from repro.distributed import sharding as r_sharding
from repro.models.registry import build as r_build
from repro.train.train_step import init_state as r_init_state
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding
from repro_torch.models.registry import build
from repro_torch.train.layout import STACKED, leaves
from repro_torch.train.train_step import init_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


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


def _repro_leaves(tree) -> dict:
    """``{path tuple: leaf}`` of a ``repro`` tree (specs or shapes)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RP))[0]
    out = {}
    for path, leaf in flat:
        key = []
        for p in path:
            for attr in ("key", "idx", "name"):
                if hasattr(p, attr):
                    key.append(getattr(p, attr))
                    break
        out[tuple(key)] = leaf
    return out


def _repro_path(cfg, path) -> tuple:
    """The ``repro`` leaf a port tensor belongs to: the layer index of a
    stacked list dropped (rglru's group index; its slot stays)."""
    if cfg.family == "hybrid" and path and path[0] == "groups":
        return (path[0],) + path[2:]
    if path and path[0] in STACKED[cfg.family]:
        return (path[0],) + path[2:]
    return path


def _assert_same(cfg, port_specs, port_shapes, repro_specs, repro_shapes,
                 prefix=()):
    """Every port tensor's spec is ``repro``'s through the stack mapping,
    and every ``repro`` leaf is covered."""
    theirs = _repro_leaves(repro_specs)
    their_shapes = _repro_leaves(repro_shapes)
    shapes = dict(leaves(port_shapes))
    seen = set()
    for path, spec in leaves(port_specs):
        rpath = prefix + _repro_path(cfg, path[len(prefix):])
        want = tuple(theirs[rpath])
        ours = shapes[path].dim()
        if ours == len(their_shapes[rpath].shape) - 1:
            assert want[:1] in ((), (None,)), (rpath, want)
            want = want[1:]
        else:
            assert ours == len(their_shapes[rpath].shape), (path, rpath)
        assert tuple(spec) == want, (path, tuple(spec), want)
        assert len(tuple(spec)) <= ours
        seen.add(rpath)
    assert seen == set(theirs), sorted(set(theirs) - seen)[:5]


def _divides(specs, shapes, mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    sh = dict(leaves(shapes))
    for path, spec in leaves(specs):
        for dim, entry in zip(sh[path].shape, tuple(spec)):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_repro(meshes, name, mesh_name):
    mine, theirs = meshes[mesh_name]
    model, r_model = build(ARCHS[name]), r_build(R_ARCHS[name])
    specs = sharding.make_param_specs(model, mine)
    shapes = sharding.param_shapes(model)
    r_shapes = jax.eval_shape(r_model.init, jax.random.PRNGKey(0))
    _assert_same(model.cfg, specs, shapes,
                 r_sharding.make_param_specs(r_model, theirs), r_shapes)
    _divides(specs, shapes, mine)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "llama3.2-3b"])
def test_state_specs_match_repro(meshes, name, mesh_name):
    """Adafactor (kimi-k2: ``vr`` / ``vc`` over the port's shapes, the
    stacks of vectors' one ``vc`` included) and AdamW (``m`` / ``v``)."""
    mine, theirs = meshes[mesh_name]
    model, r_model = build(ARCHS[name]), r_build(R_ARCHS[name])
    specs = sharding.make_state_specs(model, mine)
    shapes = init_state(model, None, device="meta")
    r_specs = r_sharding.make_state_specs(r_model, theirs)
    r_shapes = jax.eval_shape(lambda k: r_init_state(r_model, k),
                              jax.random.PRNGKey(0))
    for field in ("m", "v") if model.cfg.optimizer == "adamw" else ("vr", "vc"):
        _assert_same(model.cfg, getattr(specs.opt, field),
                     getattr(shapes.opt, field), getattr(r_specs.opt, field),
                     getattr(r_shapes.opt, field))
    _assert_same(model.cfg, specs.params, shapes.params, r_specs.params,
                 r_shapes.params)
    assert tuple(specs.step) == tuple(r_specs.step) == ()
    assert tuple(specs.opt.step) == tuple(r_specs.opt.step) == ()
    assert specs.ef is None


def test_state_specs_cover_error_feedback(meshes):
    mine, _ = meshes["16x16"]
    model = build(ARCHS["llama3.2-3b"])
    specs = sharding.make_state_specs(model, mine, grad_compression="int8")
    assert [tuple(s) for _, s in leaves(specs.ef.residual)] == \
        [tuple(s) for _, s in leaves(specs.params)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_cache_specs_match_repro(meshes, name, mesh_name):
    """kimi-k2 at batch 128 and length 1024 (``repro``'s test), an SSM and
    a hybrid: the port's caches are stacked as ``repro``'s."""
    mine, theirs = meshes[mesh_name]
    model, r_model = build(ARCHS[name]), r_build(R_ARCHS[name])
    specs = sharding.make_cache_specs(model, mine, 128, 1024)
    r_specs = r_sharding.make_cache_specs(r_model, theirs, 128, 1024)
    assert {k: tuple(v) for k, v in _repro_leaves(r_specs).items()} == \
        {p: tuple(s) for p, s in leaves(specs)}
    _divides(specs, model.init_cache(128, 1024, "meta"), mine)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_match_repro(meshes, mesh_name):
    """A batch that divides the batch axes shards its rows over them; the
    uneven batch of 1 stays replicated."""
    mine, theirs = meshes[mesh_name]
    batch = {"tokens": np.zeros((256, 64), np.int32),
             "labels": np.zeros((256, 64), np.int32),
             "embeds": np.zeros((256, 64, 8), np.float32),
             "one": np.zeros((1, 128), np.int32)}
    specs = sharding.make_batch_specs(batch, mine)
    r_specs = r_sharding.make_batch_specs(
        {k: jax.ShapeDtypeStruct(v.shape, jnp.dtype(v.dtype))
         for k, v in batch.items()}, theirs)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in r_specs.items()}
    assert tuple(specs["one"])[0] is None
    assert sharding.batch_axes(mine) == r_sharding.batch_axes(theirs)


def test_kimi_specs_allocate_nothing(meshes):
    """kimi-k2 at its full config (~1e12 parameters): its specs come from
    meta tensors, in seconds."""
    mine, _ = meshes["2x16x16"]
    model = build(ARCHS["kimi-k2-1t-a32b"])
    t0 = time.perf_counter()
    sharding.make_state_specs(model, mine)
    assert time.perf_counter() - t0 < 30
    shapes = sharding.param_shapes(model)
    assert all(t.is_meta for _, t in leaves(shapes))
    assert sum(t.numel() for _, t in leaves(shapes)) > 1e12


def test_named_gives_dtensor_placements(meshes):
    """A dimension over ("pod", "data") is ``Shard(d)`` on both mesh
    dimensions, major to minor; an axis the spec leaves out is
    ``Replicate``; axes out of the mesh's order are refused."""
    from torch.distributed.tensor import Replicate, Shard

    mine, _ = meshes["2x16x16"]
    P = sharding.P
    got = sharding.named(mine, {"x": P(("pod", "data"), None, "model"),
                                "y": P(None, "data")})
    assert got["x"].placements == (Shard(0), Shard(0), Shard(2))
    assert got["y"].placements == (Replicate(), Shard(1), Replicate())
    assert tuple(P("data", None)) == tuple(RP("data", None))
    with pytest.raises(ValueError, match="order"):
        sharding.placements(mine, P(("data", "pod")))
