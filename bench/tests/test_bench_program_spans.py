"""``bench/tools/program_spans.py``: what the port's recording reads against
a device trace, on a hand-built trace, and a run on the CPU with and
without a recorder in the port."""
import dataclasses
import sys

import pytest

from bench.harness import manifest
from bench.tests.tiny import OVERRIDES, ROOT, SEED
from bench.tools import program_spans as ps

US = 1000  # the hand-built trace is in microseconds


def _span(name, s, e, parent, sid=0):
    return (name, s * US, e * US, parent, sid)


# search [0, 1000]: stage 1 and the cascade, then two rounds in host_rounds.
SPANS = [
    _span("search", 0, 1000, -1),
    _span("prepare_ref", 10, 20, 0),
    _span("cascade", 20, 40, 0),
    _span("host_rounds", 40, 900, 0),
    _span("round", 100, 300, 3),
    _span("round.issue", 100, 250, 4),
    _span("round", 300, 600, 3),
    _span("round.issue", 300, 500, 6),
]
OPS = [(a * US, b * US, name) for a, b, name in [
    (50, 90, "lb_cascade_kernel<8, true>"),
    (110, 130, "at::native::elementwise_kernel"),
    (140, 280, "dtw_ea_fused_kernel<8, false>"),
    (310, 320, "at::native::reduce_kernel"),
    (330, 590, "dtw_ea_fused_kernel<8, false>"),
    (700, 710, "Memcpy_DtoH (Device -> Pageable)"),
]]
COUNTERS = {"host_rounds.live_lanes": [30, 10],
            "host_rounds.lanes_launched": [64, 64],
            "cascade.pruned": [5], "cascade.windows": [20]}


def test_readings_of_a_hand_built_trace():
    got = ps.readings(SPANS, COUNTERS, OPS)
    assert got == pytest.approx({
        # (150 + 200) us of issue over two rounds
        "host_rounds.issue_ms_per_round": 0.175,
        # idle 40 us in the first round, 30 in the second
        "host_rounds.idle_ms_per_round": 0.035,
        # PyTorch's kernels: 20 + 10 us, the copy and the hand kernels not
        "host_rounds.torch_ops_ms_per_round": 0.015,
        "host_rounds.live_lane_pct": 100 * 40 / 128,
        "cascade.pruned_pct": 25.0,
        # the search opened at 0, kernel A first ran at 140 us
        "stages.ms_per_search": 0.14,
    })


def test_readings_with_nothing_to_read_are_none():
    got = ps.readings([], {}, OPS)
    assert set(got) == set(ps.readings(SPANS, COUNTERS, OPS))
    assert all(v is None for v in got.values())
    sweep = [_span("search", 0, 1000, -1),
             _span("persistent_sweep", 40, 900, 0)]
    got = ps.readings(sweep, {"cascade.pruned": [3], "cascade.windows": [4]},
                      OPS)
    assert got["host_rounds.issue_ms_per_round"] is None
    assert got["cascade.pruned_pct"] == 75.0
    assert got["stages.ms_per_search"] == pytest.approx(0.14)


def test_checks_of_the_clock_and_the_spans():
    late = OPS + [(905 * US, 950 * US, "dtw_ea_fused_kernel<8, false>")]
    # busy 40 + 160 + 270 + 10 + 45 us of the 1000: idle 475 us
    c = ps.checks(SPANS, late, [2], (0, 1000 * US), 475 * US)
    assert c["spans"] == len(SPANS)
    assert c["dtw_launches"] == 3
    assert c["dtw_launches_outside_spans"] == 1
    assert c["round_spans_match_rounds"] is True
    assert not ps.checks(SPANS, OPS, [3], (0, 1000 * US), 0)[
        "round_spans_match_rounds"]
    assert c["window_idle_s"] == pytest.approx(475e-6)
    # 40 us idle in the first round, 30 in the second; 405 outside them
    assert c["idle_in_rounds_s"] == pytest.approx(70e-6)
    assert c["idle_outside_rounds_s"] == pytest.approx(405e-6)


def test_idle_around_each_dtw_launch_between_sync_copies():
    sync = "Memcpy DtoH (Device -> Pageable)"
    ops = [(a * US, b * US, name) for a, b, name in [
        (0, 5, sync),
        (20, 30, "at::native::elementwise_kernel"),
        (50, 150, "dtw_ea_fused_kernel<8, false>"),
        (160, 170, "at::native::reduce_kernel"),
        (180, 185, sync),
        (200, 300, "dtw_ea_fused_kernel<8, false>"),
        (310, 315, sync),
        (400, 500, "dtw_ea_fused_kernel<8, false>"),   # no copy after it
    ]]
    got = ps.idle_around_dtw(ops)
    # before: 35 us idle, then 15; after: 20, then 10 (in ms a launch)
    assert got == pytest.approx({"idle_before_dtw_ms": 0.025,
                                 "idle_after_dtw_ms": 0.015})
    assert ps.idle_around_dtw(OPS) == {"idle_before_dtw_ms": None,
                                       "idle_after_dtw_ms": None}


def test_idle_goes_to_the_innermost_span():
    tl = ps.Timeline(OPS)
    by = ps.idle_by_span(SPANS, tl)
    # idle 20 us in each issue; the rounds' 40 + 30 less those
    assert by["round.issue"] == 40 * US
    assert by["round"] == 30 * US
    assert sum(by.values()) == tl.idle(0, 1000 * US)
    assert ps.innermost(SPANS, 200 * US) == "round.issue"
    assert ps.innermost(SPANS, 550 * US) == "round"
    assert ps.innermost(SPANS, 800 * US) == "host_rounds"
    assert ps.innermost(SPANS, 2000 * US) is None


def _tiny(name):
    cell = manifest.resolve(ROOT, name)
    return dataclasses.replace(
        cell, **{k: {**getattr(cell, k), **OVERRIDES.get(k, {})}
                 for k in ("config", "traffic")})


@pytest.mark.parametrize("name", ["ecg-l1024-r0.1.host",
                                  "ecg-l1024-r0.1.sweep"])
def test_a_cpu_window_counts_what_the_searches_report(name):
    cell = _tiny(name)
    out = ps.run_window(cell, SEED, 0.05, False, True, device="cpu")
    assert out["record"] == 1 and out["searches"] >= 1
    c = out["counters"]
    nq, n_win = int(cell.config["n_queries"]), 5000 - 64 + 1
    assert c["cascade.windows"] == nq * n_win * out["searches"]
    assert 0 < c["cascade.pruned"] < c["cascade.windows"]
    if cell.traffic["rounds"] == "host":
        launched = c["host_rounds.lanes_launched"]
        assert launched == nq * int(cell.config["batch"]) * out["rounds"]
        assert 0 < c["host_rounds.live_lanes"] <= launched
    else:
        assert "host_rounds.live_lanes" not in c


def test_a_port_without_a_recorder_records_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert ps.recorder() is None
    out = ps.run_window(_tiny("ecg-l1024-r0.1.host"), SEED, 0.05, False,
                        True, device="cpu")
    assert out["record"] == 0 and "counters" not in out
    assert out["queries_per_s"] > 0
