"""The control of each cell's check, at a size a CPU holds: the reference
put in the program's place one precision below the configuration's (and,
for training, with half of the queries left out) fails at least one of the
cell's limits, so a run of it would read ``correct`` false. The chip
readings at each cell's own size are in ``PERF.md``."""

from __future__ import annotations

import pytest

from benchmark import control, harness
from benchmark.tests.test_bench_rehearsal import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    run = harness.Run(name, 2**31 + 29, 0.0, False, "cpu", tiny(name))
    kind = run.mix["kind"]
    out = control.train_controls(run) if kind == "train" else control.eval_controls(run, kind)
    limits = run.limits["limits"]
    for case, numbers in out.items():
        assert any(numbers[k] > v for k, v in limits.items() if k in numbers), (case, numbers, limits)
