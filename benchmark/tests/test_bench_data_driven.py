"""A cell and a per-layer metric are added as files only: a copy of the
benchmark gains a traffic mix, a cell's limits, a reader and their entries
in ``BENCHMARK.json``, and the harness runs the new cell and reports the
new metric without an edit to any file it had."""

from __future__ import annotations

import json
import shutil

from benchmark import harness
from benchmark.tests.test_bench_rehearsal import tiny


def test_new_cell_and_metric_are_files_only(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here)
    bench = harness.benchmark_json()
    bench["workloads"].append({"name": "esc50_cpl.train_short", "config": "esc50_cpl", "traffic": "train_short",
                               "chips": 1, "why": "a dummy cell"})
    bench["end_to_end"][0]["workloads"].append("esc50_cpl.train_short")
    bench["per_layer"].append({"name": "dummy.units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "train_episodes_per_s", "workloads": ["esc50_cpl.train_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((here / "traffic" / "train_e1.json").read_text())
    (here / "traffic" / "train_short.json").write_text(json.dumps({**mix, "warm_units": 2}))
    shutil.copy(here / "workloads" / "esc50_cpl.train_e1.json", here / "workloads" / "esc50_cpl.train_short.json")
    (here / "layer_metrics" / "dummy.units.py").write_text(
        'def read(record):\n    return record["trace"]["units"]\n')
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    overrides = tiny("esc50_cpl.train_e1")
    line = harness.run_cell("esc50_cpl.train_short", 5, 0.3, False, device="cpu", overrides=overrides)
    assert line["correct"] and set(line["metrics"]) == {"train_episodes_per_s", "setup_s"}
    traced = harness.run_cell("esc50_cpl.train_short", 5, 0.3, True, device="cpu", overrides=overrides)
    assert traced["metrics"]["dummy.units"] == {"value": overrides["mix"]["trace_units"], "unit": "units"}
