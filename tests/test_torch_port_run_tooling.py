"""PyTorch port: the run tooling against the JAX package's.

``cli/aggregate_results.py`` and ``cli/run_sweep.py`` give the JAX
package's dicts and tables on the same artifacts (written here by the
port's own ``run_experiment``, a real CPU sweep); ``run_sweep`` with
``run_experiment`` stubbed on both sides writes the same folders and swept values;
``cli/make_synthetic_dataset.py`` writes the JAX CLI's files; and
``utils/profiling.py`` with ``Trainer.profile_epoch`` writes a trace, where
it raises on a log directory it cannot make (the JAX package's swallows
that).
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from _torch_port_helpers import GEOMETRIES, exp_dict
from audio_few_shot_learning_tpu.cli import aggregate_results as jagg
from audio_few_shot_learning_tpu.cli import make_synthetic_dataset as jsynth
from audio_few_shot_learning_tpu.cli import run_sweep as jsweep
from audio_few_shot_learning_tpu.utils.profiling import profile_trace as jax_profile_trace
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.cli import aggregate_results as tagg
from audio_few_shot_learning_tpu_torch.cli import make_synthetic_dataset as tsynth
from audio_few_shot_learning_tpu_torch.cli import run_sweep as tsweep
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.train.engine import Trainer
from audio_few_shot_learning_tpu_torch.utils.profiling import profile_trace

N_WAY, K_SHOT, K_QUERY = 3, 2, 2
EPISODE = {f"n_{kind}_{split}": n for split in ("train", "validation", "test")
           for kind, n in (("way", N_WAY), ("shot", K_SHOT), ("query", K_QUERY))}
APL = {"l_param": 1.7235, "cpl": {"use": False},
       "angular": {"use": True, "angle": 15, "prototypes_as_anchors": True}}


def _train_dict(**over):
    d = exp_dict(**EPISODE, loss=APL, lr=1e-3, num_epochs=1, n_training_tasks=2, n_testing_tasks=2,
                 patience=5, train_query_augmentations=True, validation_query_augmentations=True,
                 experiment_folder="apl", dataset_name="synth")
    d.update(over)
    return d


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """A real two-value angle sweep of the port on the CPU (2 runs a value,
    1 epoch of 2 tasks, 2 test tasks) on a synthetic set."""
    tmp = tmp_path_factory.mktemp("sweep")
    f, t = GEOMETRIES["small"][0]
    _quiet(tsynth.main, ["--root", str(tmp / "synth"), "--n-classes", "9", "--items-per-class", "4",
                         "--n-mels", str(f), "--n-frames", str(t), "--splits", "3", "3", "3"])
    (tmp / "exp.json").write_text(json.dumps(_train_dict(data_root="/nowhere")))
    (tmp / "mdl.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    root = tmp / "experiments"
    sw, printed = _quiet(tsweep.main, [
        "-e", str(tmp / "exp.json"), "-m", str(tmp / "mdl.json"), "--key", "angle", "--values", "0", "30",
        "--experiments-root", str(root), "--runs", "2", "--data-root", str(tmp)])
    return root, sw, printed


def test_real_sweep_writes_what_aggregate_reads(swept):
    root, sw, printed = swept
    assert sorted(p.name for p in root.iterdir()) == ["apl_angle=0", "apl_angle=30"]
    for name in ("apl_angle=0", "apl_angle=30"):
        files = sorted(p.name for p in (root / name).iterdir())
        for i in range(2):
            assert f"result_run{i}.json" in files and f"metrics_run{i}.jsonl" in files
        assert "config.json" in files and "model.ckpt" in files
    assert sw["key"] == "loss.angular.angle" and sorted(sw["groups"]) == ["0.0", "30.0"]  # the config holds a float
    summary = tagg.collect(str(root))
    for name, s in summary.items():
        runs = [json.loads((root / name / f"result_run{i}.json").read_text()) for i in range(2)]
        assert s["run_accuracies"] == [r["mean_accuracy"] for r in runs]
        assert s["config"]["experiment"]["loss"]["angular"]["angle"] == float(name.split("=")[1])
    for value, g in sw["groups"].items():
        assert g["runs"] == 2 and g["experiments"] == [f"apl_angle={int(float(value))}"]
    assert "sweep over loss.angular.angle" in printed


def test_aggregate_matches_jax_on_the_port_artifacts(swept):
    root = str(swept[0])
    assert tagg.collect(root) == jagg.collect(root)
    for key in ("angle", "loss.l_param", "lr", "no.such.key"):
        assert tagg.sweep(tagg.collect(root), key) == jagg.sweep(jagg.collect(root), key)
    for argv in ([root], [root, "--json"], [root, "--sweep", "angle"], [root, "--sweep", "angle", "--json"],
                 [str(swept[0] / "missing")]):
        got, got_text = _quiet(tagg.main, argv)
        want, want_text = _quiet(jagg.main, argv)
        assert got == want and got_text == want_text, argv


@pytest.mark.parametrize("dotted,value", [("loss.angular.angle", 15), ("tpu.episode_batch", 4), ("lr", 0.5),
                                          ("a.b.c.d", "x")])
def test_set_dotted_matches_jax(dotted, value):
    base = {"loss": {"angular": {"angle": 0}}, "lr": 1.0}
    mine, theirs = json.loads(json.dumps(base)), json.loads(json.dumps(base))
    tsweep.set_dotted(mine, dotted, value)
    jsweep.set_dotted(theirs, dotted, value)
    assert mine == theirs
    with pytest.raises(ValueError, match="is not an object"):
        tsweep.set_dotted({"lr": 1.0}, "lr.x", 1)


@pytest.mark.parametrize("raw", ["15", "0.5", "-3", "true", "null", "[1, 2]", "min_label", "1e-3", "{\"a\": 1}"])
def test_parse_value_matches_jax(raw):
    assert tsweep._parse_value(raw) == jsweep._parse_value(raw)
    assert type(tsweep._parse_value(raw)) is type(jsweep._parse_value(raw))


def test_stubbed_sweep_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "exp.json").write_text(json.dumps({"experiment_folder": "esc",
                                                   "loss": {"angular": {"use": True, "angle": 0.0}}}))
    (tmp_path / "mdl.json").write_text("{}")

    def stub(launched, root):
        def run_experiment(exp, mdl, experiments_root, num_runs=None):
            launched.append((exp.experiment_folder, exp.loss.angular.angle, exp.data_root, num_runs))
            d = root / exp.experiment_folder
            d.mkdir(parents=True)
            (d / "result_run0.json").write_text(json.dumps({"mean_accuracy": 0.5 + exp.loss.angular.angle / 100}))
            (d / "config.json").write_text(json.dumps({"experiment": dataclasses.asdict(exp), "model": {}}))
        return run_experiment

    results = {}
    for name, module, target in (("port", tsweep, "audio_few_shot_learning_tpu_torch.train.experiment"),
                                 ("jax", jsweep, "audio_few_shot_learning_tpu.train.experiment")):
        launched, root = [], tmp_path / name
        monkeypatch.setattr(f"{target}.run_experiment", stub(launched, root))
        sw, text = _quiet(module.main, ["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
                                        "--key", "angle", "--values", "0", "15.5", "30",
                                        "--experiments-root", str(root), "--runs", "3", "--data-root", "/d"])
        configs = {p.name: json.loads((p / "config.json").read_text())["experiment"]
                   for p in sorted(root.iterdir())}
        results[name] = (launched, sw, text[text.index("sweep over"):], configs)
    (pl, psw, ptext, pcfg), (jl, jsw, jtext, jcfg_) = results["port"], results["jax"]
    assert pl == jl and [x[0] for x in pl] == ["esc_angle=0", "esc_angle=15.5", "esc_angle=30"]
    assert psw == jsw and ptext == jtext
    assert sorted(pcfg) == sorted(jcfg_)
    for folder in pcfg:
        assert pcfg[folder]["loss"]["angular"] == jcfg_[folder]["loss"]["angular"]
        assert pcfg[folder]["experiment_folder"] == jcfg_[folder]["experiment_folder"] == folder
        assert pcfg[folder]["data_root"] == jcfg_[folder]["data_root"] == "/d"


@pytest.mark.parametrize("extra", [[], ["--multi-segm", "--max-segments", "3"]], ids=["single", "multi_segm"])
def test_make_synthetic_dataset_cli_matches_jax(tmp_path, extra):
    args = ["--n-classes", "6", "--items-per-class", "3", "--n-mels", "8", "--n-frames", "10",
            "--splits", "2", "2", "2", "--seed", "3", *extra]
    _quiet(tsynth.main, ["--root", str(tmp_path / "port"), *args])
    _quiet(jsynth.main, ["--root", str(tmp_path / "jax"), *args])
    port = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy"))
    theirs = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert port == theirs and len(port) == 6 * 3 + 2
    for rel in port:
        a = np.load(tmp_path / "port" / rel, allow_pickle=True)
        b = np.load(tmp_path / "jax" / rel, allow_pickle=True)
        if a.dtype == object:
            assert [list(x) for x in a] == [list(x) for x in b]
        else:
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def _trace_events(log_dir):
    traces = list(log_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    return json.loads(traces[0].read_text())["traceEvents"]


def test_profile_epoch_writes_a_trace_and_returns_the_metrics(tmp_path):
    f, t = GEOMETRIES["small"][0]
    rng = np.random.default_rng(0)
    items = [rng.standard_normal((f, t)).astype(np.float32) for _ in range(5 * 4)]
    store = PackedStore.pack(items, np.repeat(np.arange(5), 4), device="cpu")
    exp = tcfg.ExperimentConfig.from_dict(_train_dict())
    trainer = Trainer(exp, tcfg.ModelConfig.from_dict(GEOMETRIES["small"][1]), store, store, store)
    metrics = trainer.profile_epoch(str(tmp_path / "prof"))
    assert set(metrics) == {"loss", "fsl_loss", "cpl_loss", "episodes_per_sec"}
    assert all(np.isfinite(v) for v in metrics.values()) and trainer.step == 2
    names = {e.get("name") for e in _trace_events(tmp_path / "prof")}
    assert any("convolution" in str(n) for n in names)  # the encoder's ops are in it

    with profile_trace(str(tmp_path / "block")) as prof:
        torch.ones(3).sum()
    assert prof is not None and _trace_events(tmp_path / "block")
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_profile_trace_raises_where_the_jax_package_swallows(tmp_path):
    (tmp_path / "a_file").write_text("")
    bad = str(tmp_path / "a_file" / "log")  # under a regular file: cannot be made
    ran = []
    with jax_profile_trace(bad):
        ran.append("jax")
    assert ran == ["jax"]
    with pytest.raises(OSError):
        with profile_trace(bad):
            ran.append("port")
    assert ran == ["jax"]
