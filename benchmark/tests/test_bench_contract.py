"""``BENCHMARK.json`` keeps to its contract, every name in it finds its
files, and each configuration's file holds the shipped configs unchanged."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

BENCH = harness.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_and_metrics(cell):
    w = CELLS[cell]
    loaded = harness.load_cell(cell)
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert (harness.HERE / "traffic" / f"{loaded['mix']['kind']}.py").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").is_file()


def test_layers_named_alike_and_shares_in_percent():
    for m in BENCH["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_shipped_config(config):
    body = json.loads((harness.ROOT / config["file"]).read_text())
    exp_file, model_file = body["shipped"]
    assert body["experiment"] == json.loads((harness.ROOT / exp_file).read_text())
    assert body["model"] == json.loads((harness.ROOT / model_file).read_text())
    assert body["reduced"] == config["reduced"]
