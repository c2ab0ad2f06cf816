"""Every cell's run on the CPU at a tiny size: the harness's control flow,
the contract's last line and the check against the reference (the program
runs its plain versions there), and the check's faults.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness

TINY_MODEL = {
    "Hybrid": {"hidden_channels": 8, "out_dim": 8},
    "Attention": {"embed_dim": 8, "ffn_dim": 16},
    "Projection": {"input_dim": 32, "hidden_dim": 16, "output_dim": 32},
}
TINY_DATA = {"classes": 6, "items_per_class": 10, "feat_shape": [81, 84]}
TINY_MIX = {"pool_units": 6, "warm_units": 1, "trace_units": 2}
CELLS = [w["name"] for w in harness.benchmark_json()["workloads"]]


def tiny(name: str) -> dict:
    cfg = harness.load_cell(name)["config"]
    data = dict(TINY_DATA)
    if "durations_s" in cfg["dataset"]:  # recordings of 1-4 segments
        data["durations_s"] = {**cfg["dataset"]["durations_s"], "median": 6.0, "max": 20.0}
    # float32: the CPU's bf16 at 8 channels is no measure of the card's error at 64
    return {"config": {"model": TINY_MODEL, "dataset": data,
                       "experiment": {"tpu": {"compute_dtype": "float32"}}}, "mix": TINY_MIX}


def run_tiny(name: str, trace: bool = False, fault=None, seed: int = 2**31 + 11) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(name, seed, 0.5, trace, device="cpu", overrides=tiny(name), fault=fault)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(name, trace):
    out = run_tiny(name, trace)
    record = out.pop("_record")
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = harness.benchmark_json()
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    names = {m["name"] for m in wanted if name in m.get("workloads", [name])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert record["window"]["units"] > 0


# ---------------------------------------------------------------------------
# the check's faults: the timed path broken underneath, ``correct`` false
# ---------------------------------------------------------------------------


def _unchanged_state(stage, trainer):
    trainer.optimizer.step = lambda *a, **k: None


def _half_train_batch(stage, trainer):
    """Every other query left out of each step; the losses' means over the rest."""
    inner = trainer._loss_and_metrics

    def half(ep, draws=None):
        idx = torch.arange(0, ep.query.shape[1], 2)
        ep = type(ep)(support=ep.support, support_labels=ep.support_labels, query=ep.query[:, idx],
                      query_labels=ep.query_labels[:, idx])
        ys, tmask, fmask = draws.query
        draws = type(draws)(support=draws.support, query=(ys[:, idx].contiguous(), tmask, fmask),
                            perms=draws.perms, cpl_gumbel=draws.cpl_gumbel[:, idx][..., idx])
        return inner(ep, draws)

    trainer._loss_and_metrics = half


def _altered_answer(stage, trainer):
    """One episode's accuracy changed as it is produced."""
    inner = trainer._eval_episodes

    def altered(*args, **kwargs):
        acc = inner(*args, **kwargs).clone()
        acc[0] = 1.0 - acc[0] if acc[0] != 0.5 else 0.0
        return acc

    trainer._eval_episodes = altered


def _altered_token(stage, trainer):
    """One query row's scores shifted by a class: its top class changes."""
    inner = trainer._episode_scores

    def altered(*args, **kwargs):
        scores = inner(*args, **kwargs).clone()
        scores[:, 0] = scores[:, 0].roll(1, dims=-1)
        return scores

    trainer._episode_scores = altered


def _half_eval_batch(stage, trainer):
    """Each episode's accuracy taken over its first half of the query items."""
    inner = trainer._eval_episodes

    def half(ep, n_way, augment_query, draws=None, store=None, multisegment=False, tie_strategy="", s_max=1):
        keep = ep.query.shape[1] // s_max // 2 * s_max
        ep = type(ep)(support=ep.support, support_labels=ep.support_labels, query=ep.query[:, :keep],
                      query_labels=ep.query_labels[:, :keep],
                      audio_ids=None if ep.audio_ids is None else ep.audio_ids[:, :keep],
                      query_mask=None if ep.query_mask is None else ep.query_mask[:, :keep])
        draws = (draws[0], (draws[1][0][:, :keep].contiguous(), draws[1][1], draws[1][2]))
        return inner(ep, n_way, augment_query, draws, store, multisegment, tie_strategy, s_max)

    trainer._eval_episodes = half


FAULTS = {"train": [_unchanged_state, _half_train_batch],
          "test": [_altered_answer, _altered_token, _half_eval_batch],
          "predict": [_altered_token]}
FAULT_CASES = [(name, f) for name in CELLS for f in FAULTS[harness.load_cell(name)["mix"]["kind"]]]


@pytest.mark.parametrize("name,fault", FAULT_CASES, ids=[f"{n}-{f.__name__}" for n, f in FAULT_CASES])
def test_fault_is_not_correct(name, fault):
    out = run_tiny(name, fault=fault)
    assert out["correct"] is False, out["checks"]


def _mislabelled_episode(sample_episode):
    """The sampler's episodes with two support rows of different classes
    swapped: each label then names two classes."""

    def sampled(*args, **kwargs):
        ep = sample_episode(*args, **kwargs)
        sup = ep.support.clone()
        sup[:, [0, -1]] = sup[:, [-1, 0]]
        return type(ep)(**{**vars(ep), "support": sup})

    return sampled


SAMPLED_CELLS = [n for n in CELLS if harness.load_cell(n)["mix"]["kind"] in ("train", "test")]


@pytest.mark.parametrize("name", SAMPLED_CELLS)
def test_sampler_fault_is_not_correct(name, monkeypatch):
    from audio_few_shot_learning_tpu_torch.data import episodes

    monkeypatch.setattr(episodes, "sample_episode", _mislabelled_episode(episodes.sample_episode))
    out = run_tiny(name)
    assert out["correct"] is False and out["checks"]["episode_faults"]["value"] > 0, out["checks"]
