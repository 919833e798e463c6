"""BENCHMARK.json against its contract, and the harness finding every
cell's files by name."""
import json
import re
import shutil

import pytest

from bench.harness import manifest
from bench.tests.tiny import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= MAN["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert ((2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                    assert "\t" not in e[key]
    for group in ("configs", "workloads"):
        got = [e["name"] for e in MAN[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for g in ("end_to_end", "per_layer") for e in MAN[g]]
    assert len(metrics) == len(set(metrics))
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_config_files_state_their_cuts():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert "assumed" in conf and conf["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_readers(cell):
    c = manifest.resolve(ROOT, cell)
    assert c.traffic["kind"] in ("offline", "stream")
    assert (ROOT / "bench" / "harness" / f"{c.traffic['kind']}.py").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.reader(ROOT, m["name"]))
    assert set(c.check["limits"]) == {"no_answer", "dist_gap", "best_gap"}


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


def test_an_added_configuration_is_found_without_an_edit(tmp_path):
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub)
    extra = json.loads(
        (ROOT / "bench/configs/ucr-ecg-l1024-r0.1.json").read_text())
    extra.update(name="ucr-ppg-l512-r0.2", dataset="PPG", query_len=512,
                 window_ratio=0.2)
    (tmp_path / "bench/configs/ucr-ppg-l512-r0.2.json").write_text(
        json.dumps(extra))
    (tmp_path / "bench/checks/ppg-l512-r0.2.host.json").write_text(
        (ROOT / "bench/checks/ecg-l1024-r0.1.host.json").read_text())
    man = json.loads(json.dumps(MAN))
    man["configs"].append(dict(MAN["configs"][0], name="ucr-ppg-l512-r0.2",
                               file="bench/configs/ucr-ppg-l512-r0.2.json"))
    man["workloads"].append(dict(MAN["workloads"][0], name="ppg-l512-r0.2.host",
                                 config="ucr-ppg-l512-r0.2"))
    for m in man["end_to_end"] + man["per_layer"]:
        if CELLS[0] in m.get("workloads", ()):
            m["workloads"].append("ppg-l512-r0.2.host")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.resolve(tmp_path, "ppg-l512-r0.2.host")
    assert c.config["dataset"] == "PPG" and c.config["query_len"] == 512
    assert c.traffic["rounds"] == "host"
    first = manifest.resolve(ROOT, CELLS[0])
    assert [m["name"] for m in c.end_to_end] == [
        m["name"] for m in first.end_to_end]
    assert [m["name"] for m in c.per_layer] == [
        m["name"] for m in first.per_layer]
