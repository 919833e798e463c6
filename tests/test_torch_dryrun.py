"""The port's dry-run (``repro_torch.launch.dryrun``) on torch's ``fake``
backend, on the CPU.

* Cells of the ``reduced()`` configs on a small fake mesh (``(2, 2)``,
  and ``(2, 1, 2)`` for one arch): train, prefill and decode of
  mistral-nemo-12b, and one cell each of mamba2, recurrentgemma (through
  ``forward``), whisper and kimi-k2 (``--opt``: the expert-parallel MoE;
  without it the dense MoE split over the mesh), and llama3.2-3b's
  prefill under ``--opt`` (sequence parallelism) reach ``status: ok``
  with FLOPs and collectives counted.
* Placements: with sequence parallelism a norm's output has its sequence
  whole (the products' rows); a tied table used as the unembedding has
  its D dimension whole.
* FLOPs: on a mesh of one the reduced mistral train step's dot FLOPs are
  ``repro``'s ``analyze_hlo`` count of the same step lowered by
  ``jax.jit``; on ``(2, 2)``, where every dimension divides, each rank
  does a quarter of them. The reduced llama with 4 microbatches on
  ``(2, 2, 2)`` (fewer rows a data shard than microbatches: the train
  step's finer path, rows split over ``"data"`` and whole over
  ``"pod"``) counts the per-rank FLOPs of ``(2, 2)``.
* One full-config cell on the production mesh: llama3.2-3b decode_32k
  (24 heads on a 16-way model axis), with ``repro``'s cache bytes.
* The search cell on a fake group of 4: rank 0's rounds, its collectives
  a round, and its best equal to a one-device search over its range.
* The CLI writes each cell's JSON, exits 1 on a failed cell, and a
  running default group is refused.

Each fake world is built and destroyed by the call that needs it.
``repro.launch.dryrun`` is not imported (it sets ``XLA_FLAGS``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

from repro_torch.configs import ARCHS, SEARCH_CONFIG
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build

SMALL = [  # (arch, shape, mesh, --opt)
    ("mistral-nemo-12b", "train_4k", (2, 2), False),
    ("mistral-nemo-12b", "prefill_32k", (2, 2), False),
    ("mistral-nemo-12b", "decode_32k", (2, 2), False),
    ("mistral-nemo-12b", "train_4k", (2, 1, 2), False),
    ("mamba2-130m", "train_4k", (2, 2), False),
    ("recurrentgemma-2b", "prefill_32k", (2, 2), False),
    ("whisper-large-v3", "decode_32k", (2, 2), False),
    ("kimi-k2-1t-a32b", "train_4k", (2, 2), True),
    ("kimi-k2-1t-a32b", "train_4k", (2, 2), False),
    ("llama3.2-3b", "prefill_32k", (2, 2), True),
]
TRAIN = ShapeConfig("train_8x32", "train", 32, 8)


@pytest.mark.parametrize("arch,shape,mesh,opt", SMALL)
def test_small_mesh_cells(arch, shape, mesh, opt):
    res = dryrun.lower_cell(arch, shape, len(mesh) == 3, opt, mesh_shape=mesh,
                            reduced=True)
    assert res["status"] == "ok", res
    assert res["mesh"] == dict(zip(("pod", "data", "model")[-len(mesh):], mesh))
    assert res["hlo_stats"]["dot_flops"] > 0
    assert res["cost_analysis"]["flops"] == res["hlo_stats"]["dot_flops"]
    assert res["cost_analysis"]["bytes accessed"] > 0
    assert res["collectives"]["total_bytes"] > 0
    assert sum(res["collectives"]["counts"].values()) > 0
    assert res["hlo_stats"]["dynamic_loops"] == []
    assert res["fits_one_card"] is True
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0
    key = "state_bytes_per_device" if res["kind"] == "train" else \
        "cache_bytes_per_device"
    assert res[key] > 0 and res["param_count"] > 0
    # kimi-k2 under --opt: OPT_OVERRIDES' expert-parallel MoE
    assert res["optimized"] is opt


def _port_flops(world: int, shape: tuple) -> float:
    from torch.distributed.device_mesh import init_device_mesh

    with dryrun.fake_world(world):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        res = dryrun.trace_step(build(ARCHS["mistral-nemo-12b"].reduced()),
                                TRAIN, mesh)
    return res["hlo_stats"]["dot_flops"]


def test_finer_microbatches_on_the_pod_axis_split_their_rows():
    """Each microbatch of 2 rows lies split over ``"data"`` and whole over
    ``"pod"``; the embedding lookup and the attention core must take each
    rank's own row (``sharding.row_axes``), not the whole microbatch, so
    a rank does the work of one ``(2, 2)`` rank (the pod axis holds the
    same rows twice)."""
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                              num_microbatches=4)
    flops = {}
    for mesh_shape in ((2, 2, 2), (2, 2)):
        with dryrun.world_mesh(len(mesh_shape) == 3, mesh_shape,
                               "cpu") as mesh:
            res = dryrun.trace_step(build(cfg), TRAIN, mesh)
        flops[mesh_shape] = res["hlo_stats"]["dot_flops"]
    assert flops[(2, 2, 2)] == flops[(2, 2)] > 0


def test_sequence_gather_and_tied_table_placements():
    """``rms_norm``'s output under sequence parallelism keeps its batch
    split and gathers its sequence (``hints.seq_whole``), and without it
    keeps its placement; ``tied_unembed`` gathers the table's D
    dimension, so its gradient returns in the table's own placement."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import hints
    from repro_torch.models.common import rms_norm, tied_unembed

    with dryrun.world_mesh(False, (2, 2), "cpu") as mesh, FakeTensorMode():
        x = distribute_tensor(torch.empty(4, 8, 16), mesh,
                              (Shard(0), Shard(1)), src_data_rank=None)
        scale = distribute_tensor(torch.empty(16), mesh,
                                  (Replicate(), Replicate()),
                                  src_data_rank=None)
        assert tuple(rms_norm(x, scale, 1e-6).placements) == (
            Shard(0), Shard(1))
        hints.set_axes(("data",), mesh=mesh, seq_parallel=True)
        try:
            assert tuple(rms_norm(x, scale, 1e-6).placements) == (
                Shard(0), Replicate())
        finally:
            hints.clear()
        table = distribute_tensor(torch.empty(10, 16), mesh,
                                  (Shard(1), Replicate()), src_data_rank=None)
        un = tied_unembed(table)
        assert tuple(un.shape) == (16, 10)
        assert tuple(un.placements) == (Replicate(), Replicate())


def test_train_flops_are_repros_and_split_evenly():
    from repro.configs import ARCHS as R_ARCHS
    from repro.models.registry import build as r_build
    from repro.roofline.hlo_stats import analyze_hlo
    from repro.train.train_step import init_state as r_init_state
    from repro.train.train_step import make_train_step as r_make_train_step

    r_model = r_build(R_ARCHS["mistral-nemo-12b"].reduced())
    state = jax.eval_shape(lambda k: r_init_state(r_model, k),
                           jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct((TRAIN.global_batch, TRAIN.seq_len),
                                     jnp.int32) for k in ("tokens", "labels")}
    hlo = jax.jit(r_make_train_step(r_model)).lower(state, batch).compile()
    want = analyze_hlo(hlo.as_text())["dot_flops"]
    one = _port_flops(1, (1, 1))
    assert one == want
    assert _port_flops(4, (2, 2)) * 4 == one


def test_full_config_decode_cell_on_the_production_mesh():
    """llama3.2-3b has 24 heads and 8 KV heads, neither divisible by the
    16-way model axis: the head split replicates the projections."""
    from repro.configs import ARCHS as R_ARCHS
    from repro.distributed.sharding import make_cache_specs
    from repro.models.registry import build as r_build

    res = dryrun.lower_cell("llama3.2-3b", "decode_32k", False)
    assert res["status"] == "ok"
    assert res["mesh"] == {"data": 16, "model": 16}
    assert res["hlo_stats"]["dot_flops"] > 0
    assert res["collectives"]["total_bytes"] > 0
    r_model = r_build(R_ARCHS["llama3.2-3b"])
    devs = np.array([jax.devices()[0]] * 256).reshape(16, 16)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    b, s = 128, 32_768
    shapes = jax.eval_shape(lambda: r_model.init_cache(b, s))
    specs = make_cache_specs(r_model, mesh, b, s)
    want = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, RP))):
        shards = int(np.prod([mesh.shape[a] for a in tuple(spec) if a]))
        want += leaf.size * jnp.dtype(leaf.dtype).itemsize // shards
    assert res["cache_bytes_per_device"] == want


def test_search_cell_on_a_fake_group_of_four():
    """Rank 0 searches its quarter of the windows; the fake group's
    all-reduces return its own values, so its rounds and best are a
    one-device search's over that range, and each round makes two
    all-reduces over each of the mesh's two axes."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.search.subsequence import subsequence_search

    sc = dataclasses.replace(SEARCH_CONFIG, ref_len=6000, query_len=64,
                             batch=32)
    ref = make_dataset("ECG", sc.ref_len, seed=0).astype(np.float32)
    query = make_queries("ECG", 1, sc.query_len, seed=1)[0].astype(np.float32)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = dryrun.search_trace(mesh, sc, ref, query, "cpu")
    n_win = sc.ref_len - sc.query_len + 1
    per = -(-n_win // 4)
    one = subsequence_search(ref[:per + sc.query_len - 1], query, sc.query_len,
                             window=sc.window, batch=sc.batch, device="cpu")
    assert res["best_start"] == int(one.best_start)
    assert res["best_dist"] == pytest.approx(float(one.best_dist), rel=1e-4)
    assert res["rounds"] >= 1
    assert res["per_round"] == {"all-reduce": {"count": 4, "bytes": 2 * (4 + 4) * 2}}
    assert res["collectives"]["counts"] == {"all-reduce": 4 * res["rounds"] + 8}
    assert res["hlo_stats"]["dot_flops"] == 0


def test_cli_writes_cells_and_fails_on_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dry"))
    argv = ["--arch", "mistral-nemo-12b", "--shape", "decode_32k",
            "--mesh", "2x2", "--reduced"]
    dryrun.main(argv)
    path = dryrun.cell_path("mistral-nemo-12b", "decode_32k", False,
                            mesh_shape=(2, 2), reduced=True)
    with open(path) as f:
        assert json.load(f)["status"] == "ok"
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out

    def broken(*args, **kwargs):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(dryrun, "lower_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--force"])
    assert e.value.code == 1
    with open(path) as f:
        res = json.load(f)
    assert res["status"] == "error" and "no sharding rule" in res["error"]
    assert "ERR" in capsys.readouterr().out


def test_a_running_group_is_refused():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            with dryrun.fake_world(4):
                pass
    finally:
        dist.destroy_process_group()
