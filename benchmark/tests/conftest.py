"""Which cells the shared rehearsal files take.

``test_bench_rehearsal.py``, and the files that take its ``CELLS`` and
``tiny`` (``test_bench_control.py``, ``test_bench_data_driven.py``,
``test_bench_spans.py``), size, fault and control the ``train``, ``test``
and ``predict`` kinds at their tiny Hybrid size. A cell of another kind is
rehearsed by its kind's own file, which runs the same cases at a size of its
model: ``train_ast`` by ``test_bench_ast.py``. The rehearsal module is loaded
here, before any test file imports it, with the cells of the kinds it sizes;
``test_bench_ast.py::test_every_cell_is_rehearsed`` holds every cell of
``BENCHMARK.json`` to one of the two files.
"""

from __future__ import annotations

from benchmark import harness

REHEARSED_KINDS = ("train", "test", "predict")
OWN_FILE_KINDS = {"train_ast": "test_bench_ast.py"}


def _rehearsed(bench: dict) -> dict:
    """``bench`` with the cells of ``REHEARSED_KINDS`` alone."""
    kinds = {w["name"]: harness.load_cell(w["name"], bench)["mix"]["kind"] for w in bench["workloads"]}
    return {**bench, "workloads": [w for w in bench["workloads"] if kinds[w["name"]] in REHEARSED_KINDS]}


_benchmark_json = harness.benchmark_json
harness.benchmark_json = lambda: _rehearsed(_benchmark_json())
try:
    from benchmark.tests import test_bench_rehearsal  # noqa: E402,F401  (its CELLS, FAULT_CASES, SAMPLED_CELLS)
finally:
    harness.benchmark_json = _benchmark_json
