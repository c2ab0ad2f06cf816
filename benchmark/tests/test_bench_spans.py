"""The readers of the program's own spans, step marks and counters
(``benchmark/spans.py``, ``layer_metrics/{train,predict}.*issue*``,
``*.device_step_ms_p50``, ``predict.{wait,h2d}_ms_p50``,
``eval_batch.free_gb``): on a synthetic recorder, against a program without
a recorder, and in a traced run of every cell on the CPU."""

from __future__ import annotations

import pytest

from audio_few_shot_learning_tpu_torch.utils import profiling

from benchmark import harness
from benchmark.tests.test_bench_rehearsal import run_tiny

MS = 1_000_000  # ns
T0 = 100.0  # the window's start on time.perf_counter, s
NEW = ["train.issue_ms", "train.feed_issue_ms", "train.backward_issue_ms", "train.optimizer_issue_ms",
       "train.device_step_ms_p50", "eval_batch.free_gb", "predict.issue_ms_p50",
       "predict.wait_ms_p50", "predict.h2d_ms_p50"]


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


@pytest.fixture
def rec(monkeypatch):
    fresh = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", fresh)
    return fresh


def at(ms: float) -> int:
    """ns on the clock, ``ms`` after the window's start."""
    return int(T0 * 1e9) + int(ms * MS)


def put(rec, name, start_ms, dur_ms, parent=None, root=None, traced=False):
    start = at(start_ms)
    rec.records.append((name, start, start + int(dur_ms * MS), parent, start if root is None else root, traced))
    return start


def record(units, seconds=1.0):
    return {"window": {"t0": T0, "seconds": seconds, "units": units}}


def train_unit(rec, t, traced=False):
    """sample 1 ms, draws 2 + 0.5 ms, then a 20-ms step: optimizer 0.5 + 1,
    views 1 (with draws 0.25 inside), forward 3, loss 1, backward 4."""
    put(rec, "afsl.sample", t, 1, traced=traced)
    put(rec, "afsl.draws", t + 1, 2, traced=traced)
    put(rec, "afsl.draws", t + 3, 0.5, traced=traced)
    step = put(rec, "afsl.train_step", t + 4, 20, traced=traced)
    for name, s, d in (("afsl.optimizer", 4.1, 0.5), ("afsl.forward", 6, 3), ("afsl.loss", 9, 1),
                       ("afsl.backward", 10, 4), ("afsl.optimizer", 15, 1)):
        put(rec, name, t + s, d, step, step, traced)
    views = put(rec, "afsl.views", t + 5, 1, step, step, traced)
    put(rec, "afsl.draws", t + 5.1, 0.25, views, step, traced)
    rec.marks.append((len(rec.marks), "afsl.train_step", step, None, False, traced))


def test_train_readers_on_a_synthetic_window(rec):
    put(rec, "afsl.train_step", -5, 1)  # before the window: left out
    train_unit(rec, 0)
    train_unit(rec, 30)
    train_unit(rec, 60, traced=True)  # the traced stretch: left out
    put(rec, "afsl.sample", 2000, 1)  # after the window
    r = record(units=2)
    got = {n: reader(n).read(r) for n in NEW if n.startswith("train.")}
    assert got["train.issue_ms"] == pytest.approx(1 + 2 + 0.5 + 20)
    assert got["train.feed_issue_ms"] == pytest.approx(1 + 2 + 0.5 + 0.25)  # the draws inside the views too
    assert got["train.backward_issue_ms"] == pytest.approx(4)
    assert got["train.optimizer_issue_ms"] == pytest.approx(1.5)
    assert got["train.device_step_ms_p50"] == pytest.approx(30)  # step 0 -> step 1; step 1 -> the traced step
    assert (got["train.feed_issue_ms"] + got["train.backward_issue_ms"] + got["train.optimizer_issue_ms"]
            <= got["train.issue_ms"])


def test_predict_readers_group_each_request(rec):
    # requests of 1 + 1 ms of draws, then a call of 6, 8, 7 ms holding a 0.5 ms copy up and a wait of 2, 3, 1 ms
    for k, (call_ms, wait_ms) in enumerate(((6, 2), (8, 3), (7, 1))):
        t = 20 * k
        put(rec, "afsl.draws", t, 1)
        put(rec, "afsl.draws", t + 1, 1)
        call = put(rec, "afsl.predict", t + 2, call_ms)
        put(rec, "afsl.h2d", t + 2.1, 0.5 + 0.1 * k, call, call)
        put(rec, "afsl.readback", t + 2 + call_ms - wait_ms, wait_ms, call, call)
    r = record(units=3)
    assert reader("predict.issue_ms_p50").read(r) == pytest.approx(2 + 8 - 3)  # 6, 7, 8 for the three
    assert reader("predict.wait_ms_p50").read(r) == pytest.approx(2)
    assert reader("predict.h2d_ms_p50").read(r) == pytest.approx(0.6)


def test_free_gb_reads_the_rule_counter(rec):
    assert reader("eval_batch.free_gb").read(record(units=1)) is None
    profiling.set_counter("eval.rule_free_bytes", 72_500_000_000)
    assert reader("eval_batch.free_gb").read(record(units=1)) == pytest.approx(72.5)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_from_an_empty_window(rec, name):
    put(rec, "afsl.train_step", -10, 1)
    assert reader(name).read(record(units=3)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_from_a_program_without_a_recorder(monkeypatch, name):
    """An earlier program's ``utils/profiling.py`` has no recorder: the
    readers return None and raise nothing."""
    for attr in ("read_spans", "mark_intervals", "read_counter"):
        monkeypatch.delattr(profiling, attr)
    assert reader(name).read(record(units=3)) is None


def _traced_metrics(name):
    out = run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    return {k: v["value"] for k, v in out["metrics"].items()}


def test_traced_train_run_reads_its_span_metrics():
    m = _traced_metrics("esc50_cpl.train_e1")
    new = {k: m[k] for k in NEW if k.startswith("train.")}
    assert len(new) == 5 and all(v > 0 for v in new.values())
    assert m["train.feed_issue_ms"] + m["train.backward_issue_ms"] + m["train.optimizer_issue_ms"] <= m[
        "train.issue_ms"]


@pytest.mark.parametrize("name", ["esc50_cpl.test", "birdclef_cpl.test_mseg36"])
def test_traced_test_run_stays_correct_with_spans(name):
    m = _traced_metrics(name)
    assert "eval_batch.free_gb" not in m  # the CPU reports no free memory


def test_traced_predict_run_reads_its_span_metrics():
    m = _traced_metrics("esc50_cpl.predict")
    assert all(m[k] > 0 for k in ("predict.issue_ms_p50", "predict.wait_ms_p50", "predict.h2d_ms_p50"))
    assert m["predict.issue_ms_p50"] + m["predict.wait_ms_p50"] <= m["predict.ms_p50"]
