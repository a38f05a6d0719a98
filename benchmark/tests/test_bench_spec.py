"""``BENCHMARK.json`` keeps to its contract, every cell's files are found
by name, and a new cell and a new metric are added by files and entries
alone."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n]{1,200}\Z")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_keys_names_and_units():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["benchmark"] and b["command"][1:] == [
        "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    cells = b["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    bounds = {m["name"]: m["bound"] for m in b["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert TEXT.match(m["layer"]) and m["layer"] in layers
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = spec.load(cell)
    assert [m.name for m in c.end_to_end] == ["plan_s", "setup_s"]
    assert {"rollout_roofline", "idle_share", "mfu"} <= {
        m.name for m in c.per_layer}
    assert set(c.limits) >= {"first_step_gap", "second_step_gap",
                             "step_gap", "final_reward_gap",
                             "final_flag_miss", "selection_miss"}
    assert os.path.exists(os.path.join(
        BENCH, "reference", "models", c.config["env"] + ".py"))


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark")
    b = _bench()
    b["workloads"].append(dict(
        name="hopper", config="hopper", traffic="plan", chips=1,
        why="one hopper seed a plan"))
    b["per_layer"].append(dict(
        name="walls_spread", unit="ratio", better="lower",
        source="host_clock", layer="whole plan", moves="plan_s",
        workloads=["hopper"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "benchmark" / "workloads" / "hopper.json").write_text(
        json.dumps(dict(config="hopper", traffic="plan", chips=1,
                        limits=spec.load("humanoidrun").limits)))
    (root / "benchmark" / "metrics" / "walls_spread.py").write_text(
        "def read(record):\n"
        "    w = record['walls']\n"
        "    return (max(w) - min(w)) / min(w)\n")
    cell = spec.load("hopper", root=str(root), bench=b)
    assert cell.config["env"] == "hopper" and cell.seeds == 1
    metric = [m for m in cell.per_layer if m.name == "walls_spread"]
    assert metric and metric[0].read(dict(walls=[2.0, 2.5])) == \
        pytest.approx(0.25)
