"""A whole run on the CPU at a tiny size, sound and with the timed path
broken underneath: ``correct`` must come out true for the program and false
for each fault a search cell can have, and for the control (the reference
in bfloat16 put in the program's place). The least work must read the same
whichever plan ran."""
import pytest
import torch

from bench.harness import runner
from bench.reference.search import Reference
from bench.tests import tiny
from bench.tools.control import Result, control, stream_control

CELL = "ecg-l1024-r0.1.host"
# The streaming cell is not in BENCHMARK.json (PERF.md §7); its tests run it
# from a copy of the data whose manifest holds it.
STREAM = "ecg-l1024-r0.1.stream"


def unchanged(search):
    """A step that returns its state unchanged: the cold incumbents."""
    def run(ref, queries):
        nq = queries.shape[0]
        return Result(torch.full((nq,), -1), torch.full((nq,), 1e30),
                      torch.ones(nq, dtype=torch.int64))
    return run


def half_left_out(search):
    """Half of the windows left out: the search sees half the series."""
    return lambda ref, queries: search(ref[: ref.shape[0] // 2], queries)


def answer_altered(search):
    """An answer altered where it is produced: the window one sample on."""
    def run(ref, queries):
        res = search(ref, queries)
        return res._replace(best_start=res.best_start + 1)
    return run


def test_a_sound_run_is_correct():
    result, lines = tiny.run(CELL)
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"queries_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    result, lines = tiny.run(CELL, wrap=fault)
    assert result["correct"] is False, lines


@pytest.fixture(scope="module")
def stream_root(tmp_path_factory):
    return tiny.stream_root(tmp_path_factory.mktemp("stream"))


def test_a_sound_stream_is_correct(stream_root):
    result, lines = tiny.run(STREAM, seconds=0.5, root=stream_root)
    assert result["correct"] is True, lines
    assert result["attempted"] > 10 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "arrival_p95_ms",
                                      "arrival_p50_ms"}


def stream_unchanged(ingest, _queries):
    """An ingest that returns its state unchanged: it never scans."""
    def run(chunk):
        best, ub = ingest(chunk[:0])
        return best, ub
    return run


def stream_half_left_out(ingest, _queries):
    """Half of each arrival left out."""
    return lambda chunk: ingest(chunk[: (chunk.shape[0] + 1) // 2])


def stream_answer_altered(ingest, _queries):
    """An answer altered where it is produced: the window one sample on."""
    def run(chunk):
        best, ub = ingest(chunk)
        return best + 1, ub
    return run


@pytest.mark.parametrize("fault", [stream_unchanged, stream_half_left_out,
                                   stream_answer_altered])
def test_a_broken_stream_is_not_correct(fault, stream_root):
    result, lines = tiny.run(STREAM, wrap=fault, seconds=0.5,
                             root=stream_root)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", ["ecg-l1024-r0.1.host", "ecg-l1024-r0.5.host"])
def test_the_control_is_not_correct(cell):
    """``bench/tools/control.py`` at a size a test run holds: the
    reference in bfloat16 in the program's place fails the comparison."""
    cfg = {**runner.manifest.resolve(tiny.ROOT, cell).config,
           **tiny.OVERRIDES["config"]}
    result, lines = tiny.run(cell, wrap=control(cfg, "cpu"))
    assert result["correct"] is False, lines
    assert result["checks"]["dist_gap"]["value"] > result["checks"][
        "dist_gap"]["limit"], lines


def test_least_work_is_the_same_whichever_plan_ran():
    counts = []
    for cell in ("ecg-l1024-r0.1.host", "ecg-l1024-r0.1.sweep"):
        run, ctx = least_work_of(cell)
        counts.append((sorted((a.set, a.query, a.start) for a in run.answers()),
                       ctx.least_work["cells"], ctx.least_work["live"]))
    host, sweep = counts
    assert host[0] == sweep[0], "both plans answer alike"
    assert host[1] > 0 and host[2] > 0
    assert host[1:] == sweep[1:]


def least_work_of(cell):
    """The run object and the readers' context of a tiny run of ``cell``
    whose window holds one search, of the first query set."""
    import dataclasses
    import importlib
    import time

    over = tiny.OVERRIDES
    c = runner.manifest.resolve(tiny.ROOT, cell)
    c = dataclasses.replace(
        c, config={**c.config, **over["config"]},
        traffic={**c.traffic, **over["traffic"], "query_sets": 1},
        check={**c.check, **over["check"]})
    kind = importlib.import_module(f"bench.harness.{c.traffic['kind']}")
    run = kind.Run(c, tiny.SEED, 0.0, False, "cpu", time.perf_counter())
    run.execute()
    run.searches = run.searches[:1]
    l, w = int(c.config["query_len"]), kind.window_of(c.config)
    ref = Reference(run.ref_np, l, w, "cpu", budget=8 << 20)
    checked = run.compare(ref, c.check, tiny.SEED)
    return run, runner.Context(run, checked, ref, c.check, tiny.SEED)


def test_the_stream_control_is_not_correct(stream_root):
    cfg = {**runner.manifest.resolve(stream_root, STREAM).config,
           **tiny.OVERRIDES["config"]}
    result, lines = tiny.run(STREAM, wrap=stream_control(cfg, "cpu"),
                             seconds=0.5, root=stream_root)
    assert result["correct"] is False, lines
