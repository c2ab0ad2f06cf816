"""The port's span and counter recorder (``utils/profiling.py``) and the spans
the engine opens at its layer boundaries, on the CPU.

* the recorder: nesting, parent and root ids, the bounded ring, the clock
  (``time.perf_counter``'s), counters, step marks;
* with no profiler recording no ``record_function`` is entered; under a CPU
  ``torch.profiler`` the spans are user annotations and their records are
  flagged;
* a train step, a multi-segment eval batch, a prediction, the host-fed feed
  and the sampler and draws emit the span names and nesting the
  benchmark's readers rely on;
* spans change nothing a seeded step computes; ``last_step_ms`` holds one
  interval a step, and warns where an epoch outgrows the marks' ring;
  ``last_eval_batch`` is set on every eval path, and the eval batch rule's
  free-memory reading goes to its counter.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port_helpers import GEOMETRIES, exp_dict
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode, sample_wav_episode
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
from audio_few_shot_learning_tpu_torch.losses.cpl import draw_cpl_gumbel
from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
from audio_few_shot_learning_tpu_torch.ops.waveaugment import WaveAugment
from audio_few_shot_learning_tpu_torch.train.engine import STEP_SPAN, Trainer, TrainDraws
from audio_few_shot_learning_tpu_torch.utils import profiling

N_WAY, K_SHOT, K_QUERY = 3, 2, 2
GEOMETRY = "fprime"


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in place of the process's."""
    fresh = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", fresh)
    return fresh


def _train_dict(**over):
    d = exp_dict(n_way_train=N_WAY, n_shot_train=K_SHOT, n_query_train=K_QUERY, n_way_validation=N_WAY,
                 n_shot_validation=K_SHOT, n_query_validation=K_QUERY, n_training_tasks=4, lr=1e-3,
                 loss={"l_param": 1.5, "cpl": {"use": True, "m_param": K_QUERY, "t_param": 2.0}},
                 train_query_augmentations=True, validation_query_augmentations=True, n_testing_tasks=3)
    d["tpu"].update(episode_batch=2)
    d.update(over)
    return d


def _items(seed=0, n=20, s_max=1):
    rng = np.random.default_rng(seed)
    shape = GEOMETRIES[GEOMETRY][0]
    if s_max == 1:
        return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    return [rng.standard_normal((int(rng.integers(1, s_max + 1)),) + shape).astype(np.float32) for _ in range(n)]


def _store(s_max=1, host=False):
    items, labels = _items(s_max=s_max), np.repeat(np.arange(5), 4)
    return HostStore.pack(items, labels) if host else PackedStore.pack(items, labels, device="cpu")


def _trainer(store, seed=3, **over):
    return Trainer(tcfg.ExperimentConfig.from_dict(_train_dict(**over)),
                   tcfg.ModelConfig.from_dict(GEOMETRIES[GEOMETRY][1]), store, val_store=store, test_store=store,
                   seed=seed)


def _names(rec):
    return [r["name"] for r in rec.spans()]


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_spans_nest_with_parent_and_root_ids(rec):
    with profiling.span("afsl.a"):
        with profiling.span("afsl.b"):
            with profiling.span("afsl.c"):
                pass
        with profiling.span("afsl.b"):
            pass
    with profiling.span("afsl.d"):
        pass
    c, b1, b2, a, d = rec.spans()  # in the order they closed
    assert [x["name"] for x in (a, b1, c, b2, d)] == ["afsl.a", "afsl.b", "afsl.c", "afsl.b", "afsl.d"]
    assert a["parent"] is None and a["root"] == a["id"]
    assert b1["parent"] == a["id"] and b2["parent"] == a["id"] and c["parent"] == b1["id"]
    assert {x["root"] for x in (a, b1, c, b2)} == {a["id"]}
    assert d["parent"] is None and d["root"] == d["id"] != a["id"]
    assert len({x["id"] for x in (a, b1, c, b2, d)}) == 5
    for x in (a, b1, c, b2, d):
        assert x["start_ns"] <= x["end_ns"] and not x["traced"]
    assert a["start_ns"] <= b1["start_ns"] <= c["start_ns"] <= c["end_ns"] <= b1["end_ns"] <= b2["start_ns"]
    assert b2["end_ns"] <= a["end_ns"] <= d["start_ns"]
    assert rec.open == []


def test_a_raising_block_still_closes_its_span(rec):
    with pytest.raises(ValueError):
        with profiling.span("afsl.outer"):
            with profiling.span("afsl.inner"):
                raise ValueError("boom")
    assert _names(rec) == ["afsl.inner", "afsl.outer"] and rec.open == []


def test_decorated_function_runs_in_its_span(rec):
    @profiling.spanned("afsl.f")
    def f(x, y=1):
        """doc"""
        with profiling.span("afsl.g"):
            return x + y

    assert f(2, y=3) == 5 and f.__doc__ == "doc" and f.__name__ == "f"
    g, outer = rec.spans()
    assert outer["name"] == "afsl.f" and g["parent"] == outer["id"]


@pytest.mark.parametrize("capacity,n", [(4, 10), (8, 8), (3, 1)])
def test_ring_is_bounded_and_keeps_the_newest_spans(monkeypatch, capacity, n):
    fresh = profiling.Recorder(capacity=capacity)
    monkeypatch.setattr(profiling, "RECORDER", fresh)
    starts = []
    for _ in range(n):
        with profiling.span("afsl.x"):
            starts.append(fresh.open[-1][0])
    kept = fresh.spans()
    assert len(kept) == min(capacity, n)
    assert [r["id"] for r in kept] == starts[-capacity:]
    assert [r["id"] for r in kept] == sorted(r["id"] for r in kept)  # the newest kept


def test_records_lie_on_the_perf_counter_clock(rec):
    t0 = time.perf_counter()
    with profiling.span("afsl.in"):
        time.sleep(0.002)
    t1 = time.perf_counter()
    (r,) = rec.spans()
    assert t0 * 1e9 <= r["start_ns"] < r["end_ns"] <= t1 * 1e9
    assert r["end_ns"] - r["start_ns"] >= 2e6
    # a window [t0, t1] on time.perf_counter selects exactly the spans started in it
    with profiling.span("afsl.after"):
        pass
    inside = [x["name"] for x in rec.spans() if t0 * 1e9 <= x["start_ns"] <= t1 * 1e9]
    assert inside == ["afsl.in"]


def test_counters_set_and_read(rec):
    assert profiling.read_counter("eval.x") is None
    profiling.set_counter("eval.x", 3)
    profiling.set_counter("eval.y", None)
    assert profiling.read_counter("eval.x") == 3 and profiling.read_counter("eval.y") is None
    profiling.set_counter("eval.x", 5)
    assert profiling.read_counter("eval.x") == 5 and profiling.read_counter("eval.never") is None


def test_step_marks_by_label_and_end(rec):
    t0 = time.perf_counter_ns()
    for _ in range(3):
        profiling.mark("cpu", "afsl.step")
        time.sleep(0.001)
    profiling.mark("cpu", "afsl.step", end=True)
    first = profiling.marks_made()
    profiling.mark("cpu", "other")
    profiling.mark("cpu", "afsl.step")
    profiling.mark("cpu", "other", end=True)
    profiling.mark("cpu", "afsl.step", end=True)
    steps = profiling.mark_intervals("afsl.step")
    assert [m["seq"] for m in steps] == [0, 1, 2, 5]  # the end marks open no interval
    assert all(m["ms"] >= 1.0 for m in steps[:3]) and not any(m["traced"] for m in steps)
    starts = [m["start_ns"] for m in steps]
    assert t0 <= starts[0] and starts == sorted(starts)  # on time.perf_counter_ns's clock
    assert [m["seq"] for m in profiling.mark_intervals("afsl.step", first)] == [5]
    assert [m["seq"] for m in profiling.mark_intervals("other")] == [4]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


def test_no_record_function_without_a_profiler(rec):
    """Spans, and a whole train step, enter no ``record_function`` while no
    profiler records."""
    tr = _trainer(_store())
    with mock.patch.object(torch.profiler, "record_function", side_effect=AssertionError("entered")) as rf:
        with profiling.span("afsl.x"):
            pass
        tr.train_step(sample_episode(tr.gen, tr.train_store, N_WAY, K_SHOT, K_QUERY, 2))
    assert rf.call_count == 0
    assert "afsl.train_step" in _names(rec)


def test_spans_are_user_annotations_under_the_profiler(rec):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("afsl.outer"):
            with profiling.span("afsl.inner"):
                torch.ones(4).sum()
    with profiling.span("afsl.after"):
        pass
    events = {e.name: e for e in prof.events() if e.name.startswith("afsl.")}
    assert {"afsl.outer", "afsl.inner"} <= set(events) and "afsl.after" not in events
    assert all(getattr(events[n], "is_user_annotation", True) for n in ("afsl.outer", "afsl.inner"))
    flags = {r["name"]: r["traced"] for r in rec.spans()}
    assert flags == {"afsl.inner": True, "afsl.outer": True, "afsl.after": False}


# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------


def test_train_step_spans_and_nesting(rec):
    tr = _trainer(_store())
    ep = sample_episode(tr.gen, tr.train_store, N_WAY, K_SHOT, K_QUERY, 2)
    rec.records.clear()
    tr.train_step(ep)
    spans = rec.spans()
    (step,) = [s for s in spans if s["name"] == STEP_SPAN]
    assert step["parent"] is None and all(s["root"] == step["id"] for s in spans)
    assert Counter(_children(spans, step)) == Counter(
        {"afsl.optimizer": 2, "afsl.views": 2, "afsl.draws": 1, "afsl.forward": 1, "afsl.loss": 1,
         "afsl.backward": 1})
    by_parent = {s["name"]: s for s in spans if s["parent"] == step["id"]}
    assert _children(spans, by_parent["afsl.loss"]) == ["afsl.draws"]  # CPL's Gumbel noise
    views = [s for s in spans if s["name"] == "afsl.views"]
    assert [_children(spans, v) for v in views] == [["afsl.draws"], ["afsl.draws"]]
    assert "afsl.allreduce" not in _names(rec)  # one rank: no collective


def test_train_step_with_draws_given_draws_nothing_inside(rec):
    tr = _trainer(_store())
    gen = torch.Generator().manual_seed(5)
    ep = sample_episode(gen, tr.train_store, N_WAY, K_SHOT, K_QUERY, 2)
    f, t = tr.feat_shape
    params = tr.exp.specaug_params
    draws = TrainDraws(support=draw_views_params(gen, params, 2, N_WAY * K_SHOT, f, t, "cpu"),
                       query=draw_views_params(gen, params, 2, N_WAY * K_QUERY, f, t, "cpu"),
                       perms=torch.rand((2, 3), generator=gen).argsort(dim=-1) + 1,
                       cpl_gumbel=draw_cpl_gumbel(gen, 2, N_WAY * K_QUERY, N_WAY, "cpu"))
    feed = rec.spans()
    assert [s["name"] for s in feed] == ["afsl.sample"] + ["afsl.draws"] * 3  # roots, as the feed's
    assert all(s["parent"] is None and s["root"] == s["id"] for s in feed)
    rec.records.clear()
    tr.train_step(ep, draws)
    assert "afsl.draws" not in _names(rec)


def test_train_epoch_spans_and_last_step_ms(rec):
    tr = _trainer(_store())
    t0 = time.perf_counter()
    out = tr.train_epoch()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    assert tr.steps_per_epoch == 2 and len(tr.last_step_ms) == 2
    assert all(ms > 0 for ms in tr.last_step_ms) and sum(tr.last_step_ms) <= wall_ms
    spans = rec.spans()
    (epoch,) = [s for s in spans if s["name"] == "afsl.train_epoch"]
    assert Counter(_children(spans, epoch)) == Counter({STEP_SPAN: 2, "afsl.sample": 2})
    steps = [s for s in spans if s["name"] == STEP_SPAN]
    marks = profiling.mark_intervals(STEP_SPAN)
    # each step's mark opens its span; its interval runs to the next step's mark, the last to the epoch's end mark
    assert [m["ms"] for m in marks] == tr.last_step_ms
    assert all(s["start_ns"] <= m["start_ns"] <= s["end_ns"] for s, m in zip(steps, marks))
    assert tr.last_step_ms[0] == pytest.approx((marks[1]["start_ns"] - marks[0]["start_ns"]) / 1e6)
    assert tr.last_step_ms[1] >= (steps[1]["end_ns"] - marks[1]["start_ns"]) / 1e6
    assert np.isfinite(out["loss"])
    tr.train_epoch()  # a second epoch holds only its own steps
    assert len(tr.last_step_ms) == 2


def test_train_epoch_warns_when_its_steps_outgrow_the_mark_ring(rec, monkeypatch):
    """An epoch of more steps than the ring of step marks holds keeps the
    last intervals, and says so."""
    import audio_few_shot_learning_tpu_torch.train.engine as engine

    tr = _trainer(_store(), n_training_tasks=8)
    assert tr.steps_per_epoch == 4
    monkeypatch.setattr(engine, "MARK_RING", 3)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(marks=3))
    with pytest.warns(UserWarning, match="the last 2 of the epoch's 4 steps"):
        tr.train_epoch()
    assert len(tr.last_step_ms) == 2
    monkeypatch.setattr(engine, "MARK_RING", 5)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(marks=5))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.train_epoch()  # four steps and the end mark fill the ring exactly
    assert len(tr.last_step_ms) == 4


def test_host_fed_feed_spans_sample_then_staging(rec):
    tr = _trainer(_store(host=True))
    assert tr.host_mode
    tr.train_epoch()
    spans = rec.spans()
    (epoch,) = [s for s in spans if s["name"] == "afsl.train_epoch"]
    assert Counter(_children(spans, epoch)) == Counter({STEP_SPAN: 2, "afsl.sample": 2, "afsl.staging": 2})


def test_multisegment_eval_batch_spans_and_counters(rec):
    store = _store(s_max=3)
    assert store.multi_segm and store.s_max > 1
    tr = _trainer(store, multi_segm=True)
    tr.model.eval()
    profiling.set_counter("eval.rule_free_bytes", 1)
    tr.eval_batch_size(store, 5, N_WAY, K_SHOT, K_QUERY, True, True)
    assert profiling.read_counter("eval.rule_free_bytes") is None  # the CPU reports no memory
    ep = sample_episode(tr.gen, store, N_WAY, K_SHOT, K_QUERY, 2, is_test=True)
    rec.records.clear()
    with torch.inference_mode():
        acc = tr._eval_episodes(ep, N_WAY, True, store=store, multisegment=True, s_max=store.s_max)
    assert acc.shape == (2,)
    assert tr.last_eval_batch == 2
    spans = rec.spans()
    (batch,) = [s for s in spans if s["name"] == "afsl.eval_batch"]
    assert batch["parent"] is None
    assert Counter(_children(spans, batch)) == Counter({"afsl.views": 2, "afsl.forward": 1, "afsl.vote": 1})


@pytest.mark.parametrize("multisegment", [False, True])
def test_eval_accuracies_spans_and_last_eval_batch(rec, multisegment):
    store = _store(s_max=3 if multisegment else 1)
    tr = _trainer(store, multi_segm=multisegment)
    seen = []
    run = tr._eval_episodes
    tr._eval_episodes = lambda ep, *a, **k: (run(ep, *a, **k), seen.append(tr.last_eval_batch))[0]
    tr.eval_accuracies(store, 3, N_WAY, K_SHOT, K_QUERY, True, multisegment)
    assert seen == [2, 1]  # each batch's E as it ran: the last batch took what remained
    assert tr.last_eval_batch == 2  # eval_episode_batch 2: the per-batch E, not the last batch's 1
    spans = rec.spans()
    (call,) = [s for s in spans if s["name"] == "afsl.eval_accuracies"]
    assert Counter(_children(spans, call)) == Counter({"afsl.sample": 2, "afsl.eval_batch": 2})
    votes = [s for s in spans if s["name"] == "afsl.vote"]
    assert len(votes) == (2 if multisegment else 0)


def test_predict_spans_and_nesting(rec):
    store = _store()
    tr = _trainer(store)
    rng = np.random.default_rng(1)
    f, t = tr.feat_shape
    sup = rng.standard_normal((N_WAY * K_SHOT, f, t)).astype(np.float32)
    qry = rng.standard_normal((4, f, t)).astype(np.float32)
    pred, scores = tr.predict_episode(sup, np.repeat(np.arange(N_WAY), K_SHOT), qry)
    assert pred.shape == (4,) and scores.shape == (4, N_WAY)
    spans = rec.spans()
    (call,) = [s for s in spans if s["name"] == "afsl.predict"]
    assert call["parent"] is None and all(s["root"] == call["id"] for s in spans)
    assert Counter(_children(spans, call)) == Counter(
        {"afsl.h2d": 1, "afsl.views": 2, "afsl.forward": 1, "afsl.readback": 1})
    names = [s["name"] for s in spans]
    assert names.index("afsl.h2d") < names.index("afsl.forward") < names.index("afsl.readback")


def test_wav_sampler_and_chain_draws_span_once(rec):
    rng = np.random.default_rng(2)
    clips = [(0.3 * rng.standard_normal(int(rng.integers(3000, 12000)))).astype(np.float32) for _ in range(20)]
    store = WavHostStore.pack(clips, np.repeat(np.arange(5), 4), segment_seconds=1, sr=4000)
    sample_wav_episode(np.random.default_rng(0), store, N_WAY, K_SHOT, K_QUERY, False, 2)
    aug = WaveAugment(tcfg.WaveAugParams.from_dict({"use": True, "aug_num": 2}))
    aug.draw(torch.Generator().manual_seed(0), (2, 3), 4000, "cpu")
    spans = rec.spans()
    assert [s["name"] for s in spans if s["parent"] is None] == ["afsl.sample", "afsl.draws"]
    assert [s["name"] for s in spans] == ["afsl.sample", "afsl.draws"]


# ---------------------------------------------------------------------------
# spans change nothing
# ---------------------------------------------------------------------------


def _seeded_step(tr_seed=3, feed_seed=11):
    tr = _trainer(_store(), seed=tr_seed)
    gen = torch.Generator().manual_seed(feed_seed)
    ep = sample_episode(gen, tr.train_store, N_WAY, K_SHOT, K_QUERY, 2)
    metrics = tr.train_step(ep)
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    return metrics, grads, params, tr.gen.get_state()


def _assert_same(a, b):
    (m1, g1, p1, s1), (m2, g2, p2, s2) = a, b
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    assert g1.keys() == g2.keys() and all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_spans_leave_a_seeded_step_bit_identical(rec, monkeypatch):
    with_spans = _seeded_step()
    assert STEP_SPAN in _names(rec)
    with monkeypatch.context() as m:  # every span a no-op
        m.setattr(profiling._Span, "__enter__", lambda self: self)
        m.setattr(profiling._Span, "__exit__", lambda self, *exc: False)
        rec.records.clear()
        without = _seeded_step()
        assert rec.spans() == []
    _assert_same(with_spans, without)


def test_the_profiler_leaves_a_seeded_step_bit_identical(rec):
    from torch.profiler import ProfilerActivity, profile

    plain = _seeded_step()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _seeded_step()
    _assert_same(plain, traced)
    assert any(r["traced"] for r in rec.spans()) and not all(r["traced"] for r in rec.spans())
