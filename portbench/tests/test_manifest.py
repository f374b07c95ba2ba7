"""BENCHMARK.json against the benchmark's contract, and the files its cells
name; a metric, a mix or a cell added as files is found with no edit."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return common.load_manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == KEYS["top"]
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(common.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]


def test_workloads(manifest):
    names = [w["name"] for w in manifest["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in manifest["workloads"]}
    assert len(pairs) == len(names)
    for w in manifest["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers: dict = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        moved = next(e for e in manifest["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in manifest["workloads"]:
        reported = [m for m in manifest["end_to_end"]
                    if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in manifest["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      common.load_manifest()["workloads"]])
def test_cell_resolves(workload):
    """Each cell finds its configuration, its mix, its loop and the reader of
    each of its per-layer metrics by name."""
    cell = common.resolve(workload)
    assert cell.config["name"] == cell.entry["config"]
    assert common.loop_module(cell.traffic).run
    for m in cell.per_layer:
        assert callable(common.metric_reader(m["name"]))


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(common.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), root)
    return str(root)


def test_added_files_are_found(tmp_path):
    """A metric, a mix and a cell added to a copy as files and entries are
    picked up, and no file already there is edited."""
    root = _copy(tmp_path)
    before = {p: open(os.path.join(root, "portbench", p), "rb").read()
              for p in ("common.py", "run.py", "loops/train.py")}
    with open(os.path.join(root, "portbench", "metrics",
                           "steps_seen.probe.py"), "w") as f:
        f.write("def read(run):\n    return run.steps or None\n")
    with open(os.path.join(root, "portbench", "traffic",
                           "train_probe.json"), "w") as f:
        json.dump({"loop": "train", "first_steps": 3}, f)
    man = common.load_manifest(root)
    man["workloads"].append({"name": "dgcnn_k40.train_probe",
                             "config": "dgcnn_k40", "traffic": "train_probe",
                             "chips": 1, "why": "a probe"})
    man["per_layer"].append({"name": "steps_seen.probe", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "probe", "moves": "train_clouds_per_s",
                             "workloads": ["dgcnn_k40.train_probe"]})
    for m in man["end_to_end"]:
        if "workloads" in m and "dgcnn_k40.train" in m["workloads"]:
            m["workloads"].append("dgcnn_k40.train_probe")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cell = common.resolve("dgcnn_k40.train_probe", root)
    assert cell.traffic["first_steps"] == 3
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.probe"]
    run = common.Run(cell.config, cell.traffic, 1.0, steps=7)
    assert common.per_layer_values(cell, run, root) == {
        "steps_seen.probe": {"value": 7.0, "unit": "steps"}}
    for p, body in before.items():
        assert open(os.path.join(root, "portbench", p), "rb").read() == body


def test_reader_that_finds_nothing_is_left_out():
    cell = common.resolve("mobilenet_aspp.serve_stream")
    run = common.Run(cell.config, cell.traffic, 1.0, cases=0)
    assert common.per_layer_values(cell, run) == {}
