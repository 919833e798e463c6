"""The port's sharded search against ``repro``'s on the CPU.

``repro_torch``'s ``make_distributed_search``,
``make_distributed_multi_search`` (``gather="fused"`` and ``"slab"``) and
``ShardedExecutor.run_range`` (a cut range with a carried state), run on
gloo groups (``device="cpu"``: the plain versions of kernels B, A and D),
beside ``repro``'s on ``jax`` meshes of the same shard counts, on the same
float32 reference with planted non-finite runs (``tests/sharded_cases.py``):

* one shard in-process: a gloo group of one from a ``HashStore`` against
  ``repro``'s 1-device mesh;
* 2 and 4 shards in spawned workers: a gloo group of 2 (the default group)
  and one of 4 through a 2 x 2 ``DeviceMesh`` sharded over both of its
  dimensions, against ``repro`` on 4 forced host devices, meshes ``(2,)``
  and ``(2, 2)``.

The parity contract: ``best_start``, ``quarantined`` and ``rounds`` equal
exactly (both packages run the same lockstep rounds and gate on the same
bounds up to float32 rounding, and no case here has a lane within that
rounding of its incumbent), ``best_dist`` within ``rtol=1e-4`` (each
package computes its own float32 window stats and bounds). The sharded
winners are also held to the port's single-process ``multi_query_search``
(``best_start``). Each spawned world finishes in a few seconds.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import guards
from repro_torch.launch.search import main as cli_main
from repro_torch.search import (
    IncumbentState,
    ShardedExecutor,
    get_executor,
    make_distributed_multi_search,
    multi_query_search,
    resilient_search,
    subsequence_search,
)
from repro_torch.search.pipeline import MULTI_VARIANTS, make_plan
from repro_torch.search.resilient import executor_runner

import sharded_cases as sc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
CASES = ("single", "fused", "slab", "range")
TIMEOUT = 120


def _assert_parity(mine: dict, theirs: dict) -> None:
    assert mine["best_start"] == theirs["best_start"]
    assert mine["quarantined"] == theirs["quarantined"]
    assert mine["rounds"] == theirs["rounds"]
    np.testing.assert_allclose(mine["best_dist"], theirs["best_dist"],
                               rtol=RTOL)


@pytest.fixture(scope="module")
def data():
    return sc.make_data()


@pytest.fixture
def world1():
    """A gloo group of one, the default group for the test's duration."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_shard(data):
    """The cases on a gloo group of one and on ``repro``'s 1-device mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mine = sc.port_cases(dist.group.WORLD, None, *data)
    finally:
        dist.destroy_process_group()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    return mine, sc.repro_cases(mesh, ("d",), *data)


def _spawn(args, env, cwd):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "sharded_cases.py"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=cwd,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **env},
    )


def _result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"worker timed out: {err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Port worlds of 2 and 4 ranks and the ``repro`` worker, all started
    at once. Returns ``{"2": [rank results], "4": [...], "repro": {...}}``."""
    d = tmp_path_factory.mktemp("sharded")
    procs = {"repro": _spawn(["repro"], {}, d)}
    for world, axes in (("2", []), ("4", ["data,model"])):
        store = str(d / f"store_{world}")
        procs[world] = [
            _spawn(["port", store, *axes],
                   {"RANK": str(r), "WORLD_SIZE": world}, d)
            for r in range(int(world))
        ]
    try:
        return {k: ([_result(p) for p in v] if isinstance(v, list)
                    else _result(v)) for k, v in procs.items()}
    finally:
        for v in procs.values():
            for p in (v if isinstance(v, list) else [v]):
                if p.poll() is None:
                    p.kill()


@pytest.mark.parametrize("case", CASES)
def test_one_shard_matches_repro(one_shard, case):
    mine, theirs = one_shard
    _assert_parity(mine[case], theirs[case])


@pytest.mark.parametrize("world", ["2", "4"])
@pytest.mark.parametrize("case", CASES)
def test_shards_match_repro(spawned, world, case):
    _assert_parity(spawned[world][0][case], spawned["repro"][world][case])


@pytest.mark.parametrize("world", ["2", "4"])
def test_every_rank_returns_the_same(spawned, world):
    first = {k: spawned[world][0][k] for k in CASES}
    for rank in spawned[world][1:]:
        assert {k: rank[k] for k in CASES} == first


@pytest.mark.parametrize("world", ["1", "2", "4"])
def test_sharded_winners_are_the_offline_ones(data, one_shard, spawned,
                                              world):
    res = one_shard[0] if world == "1" else spawned[world][0]
    ref, qs = data
    off = multi_query_search(ref, qs, sc.L, sc.W, batch=sc.B, device="cpu")
    want = off.best_start.tolist()
    assert res["fused"]["best_start"] == want
    assert res["slab"]["best_start"] == want
    assert res["single"]["best_start"] == want[0]
    assert res["fused"]["quarantined"] == int(off.quarantined) > 0


def test_mesh_shard_is_the_row_major_coordinate(spawned):
    """Rank r of the 2 x 2 mesh sits at (r // 2, r % 2): its shard over
    ("data", "model") is r, over ("model", "data") the transposed index,
    and over ("data",) alone r // 2 of 2 (as ``P(axis_names)`` orders
    shards)."""
    for r, rank in enumerate(spawned["4"]):
        assert rank["layout"] == {
            "data,model": [4, r],
            "model,data": [4, (r % 2) * 2 + r // 2],
            "data": [2, r // 2],
        }


def test_one_shard_is_the_host_rounds(data, world1):
    """A group of one runs the host rounds' lockstep with ``warm_start=0``:
    the same bits, and as many rounds as its busiest query."""
    ref, qs = data
    off = multi_query_search(ref, qs, sc.L, sc.W, batch=sc.B, device="cpu")
    res = make_distributed_multi_search(world1, None, sc.L, sc.W,
                                        batch=sc.B, device="cpu")(ref, qs)
    assert torch.equal(res.best_start, off.best_start)
    assert torch.equal(res.best_dist, off.best_dist)
    assert int(res.rounds) == int(off.rounds.max())
    assert torch.equal(res.quarantined, off.quarantined)


def test_resilient_search_schedules_sharded_ranges(data, world1):
    """``resilient_search`` over a ``ShardedExecutor`` runner covers every
    range once and finds the offline winners."""
    ref, qs = data
    plan = make_plan(length=sc.L, window=sc.W, batch=sc.B,
                     allowed_variants=MULTI_VARIANTS)
    ex = get_executor(plan, ref, qs, mesh=world1, device="cpu")
    res = resilient_search(ref, qs, sc.L, sc.W, n_shards=2, n_ranges=4,
                           batch=sc.B, runner=executor_runner(ex, plan),
                           device="cpu")
    off = multi_query_search(ref, qs, sc.L, sc.W, batch=sc.B, device="cpu")
    assert res.coverage == 1.0 and res.attempts == 4
    assert res.best_start.tolist() == off.best_start.tolist()
    assert res.quarantined == int(off.quarantined)
    np.testing.assert_allclose(res.best_dist, off.best_dist.numpy(),
                               rtol=RTOL)
    assert len(ex._fns) == 1  # one program per plan, for every range


def test_run_range_keeps_a_tighter_carried_state(data, world1):
    ref, qs = data
    plan = make_plan(length=sc.L, window=sc.W, batch=sc.B,
                     allowed_variants=MULTI_VARIANTS)
    ex = ShardedExecutor(world1, None, ref, qs, device="cpu")
    cold = ex.run_range(plan, IncumbentState(
        ub=torch.full((sc.Q,), float("inf")),
        best=torch.full((sc.Q,), -1)), sc.LO, sc.HI)
    assert bool((cold.state.best >= sc.LO).all())
    assert bool((cold.state.best < sc.HI).all())
    tight = IncumbentState(ub=cold.state.ub / 2,
                           best=torch.arange(sc.Q) + 5_000)
    kept = ex.run_range(plan, tight, sc.LO, sc.HI)
    assert torch.equal(kept.state.best, tight.best)
    assert torch.equal(kept.state.ub, tight.ub)
    # The bounds seed nothing: the program runs the cold range's rounds.
    assert torch.equal(kept.stats.rounds, cold.stats.rounds)
    assert kept.stats.lanes.tolist() == [-1] * sc.Q


def test_slab_budget_is_checked(data, world1):
    ref, qs = data
    fn = make_distributed_multi_search(world1, None, sc.L, sc.W, batch=sc.B,
                                       gather="slab", slab_budget=1024,
                                       device="cpu")
    with pytest.raises(guards.SearchInputError, match="slab_budget"):
        fn(ref, qs)


def test_sharded_search_needs_a_process_group(data):
    assert not dist.is_initialized()
    with pytest.raises(guards.SearchInputError, match="init_process_group"):
        make_distributed_multi_search(None, None, sc.L, sc.W, device="cpu")


def test_cli_distributed_forms_a_group_of_one(capsys):
    """``launch.search --distributed`` without a launcher searches on a
    group of one and prints ``repro``'s line per query; the group is gone
    afterwards."""
    args = ["--distributed", "--device", "cpu", "--ref-len", "3000",
            "--query-len", "64", "--n-queries", "2", "--batch", "32"]
    cli_main(args)
    assert not dist.is_initialized()
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("  q")]
    assert len(lines) == 2
    from repro_torch.data.synthetic import make_dataset, make_queries

    ref = make_dataset("ECG", 3000, 0)
    qs = make_queries("ECG", 2, 64, 0)
    for line, q in zip(lines, qs):
        want = subsequence_search(ref, q, 64, 6, batch=32, device="cpu")
        assert f"start={int(want.best_start)} " in line
        assert "rounds=" in line and line.rstrip().endswith("s)")


def test_cli_distributed_joins_a_launchers_group(tmp_path):
    """Under a launcher (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in the environment, as ``torchrun`` sets them) each
    rank joins the group; only rank 0 prints, and its winners are a
    single-process search's."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--distributed", "--device", "cpu", "--ref-len", "3000",
            "--query-len", "64", "--n-queries", "2", "--batch", "32"]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.search", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err[-3000:]
        outs.append([x for x in out.splitlines() if x.startswith("  q")])
    assert outs[1] == [] and len(outs[0]) == 2
    from repro_torch.data.synthetic import make_dataset, make_queries

    ref = make_dataset("ECG", 3000, 0)
    for line, q in zip(outs[0], make_queries("ECG", 2, 64, 0)):
        want = subsequence_search(ref, q, 64, 6, batch=32, device="cpu")
        assert f"start={int(want.best_start)} " in line


def test_run_range_without_a_searchable_window(data, world1):
    """A range whose every window is quarantined keeps the carried state,
    also an unbeaten one (``+inf``, start -1). ``repro``'s executor takes
    its program's ``BIG`` there with the start ``lo - 1`` (pinned here: a
    reference finding, ROADMAP.md Queue 3)."""
    import jax.numpy as jnp
    from repro.search import IncumbentState as RIncumbentState
    from repro.search import ShardedExecutor as RShardedExecutor
    from repro.search import make_plan as r_make_plan
    from repro.search.pipeline import MULTI_VARIANTS as R_MULTI_VARIANTS

    ref, qs = data
    ref = ref.copy()
    ref[300:520] = np.nan
    lo, hi = 320, 400                   # every window meets the burst
    plan = make_plan(length=sc.L, window=sc.W, batch=sc.B,
                     allowed_variants=MULTI_VARIANTS)
    ex = ShardedExecutor(world1, None, ref, qs, device="cpu")
    rr = ex.run_range(plan, IncumbentState(
        ub=torch.full((sc.Q,), float("inf")),
        best=torch.full((sc.Q,), -1)), lo, hi)
    assert rr.state.best.tolist() == [-1] * sc.Q
    assert bool(torch.isinf(rr.state.ub).all())
    assert int(rr.quarantined) == hi - lo

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    rex = RShardedExecutor(mesh, ("d",), jnp.asarray(ref, jnp.float32),
                           jnp.asarray(qs, jnp.float32))
    rplan = r_make_plan(length=sc.L, window=sc.W, batch=sc.B, backend="jax",
                        allowed_variants=R_MULTI_VARIANTS)
    theirs = rex.run_range(rplan, RIncumbentState(
        ub=jnp.full((sc.Q,), jnp.inf, jnp.float32),
        best=jnp.full((sc.Q,), -1, jnp.int32)), lo, hi)
    assert np.asarray(theirs.state.best).tolist() == [lo - 1] * sc.Q
    assert int(theirs.quarantined) == hi - lo
