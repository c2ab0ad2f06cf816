"""PyTorch port: the three accuracy A/B drivers, ``scripts/torch_port_ab_
vs_reference.py``, ``torch_port_ab_calibrate.py`` and ``torch_port_ab_
deviations.py``, against the JAX repo's ``scripts/ab_vs_reference.py``,
``ab_calibrate.py`` and ``ab_deviations.py`` (loaded with ``importlib``), on
the CPU (~15 s in one process).

* The configs: the A/B's experiment and model dicts equal the JAX script's
  for both loss families with and without multi-segment, and its "ours"
  arm's config is the JAX arm's but for the device; the deviations' dicts
  equal those of the JAX ``build_*_exp`` functions for every experiment,
  arm and scale (but for the JAX functions' ``data_root``), and the two arms of each deviation
  differ in exactly their knob.
* The data: ``make_dataset`` writes the JAX script's files and
  ``splits.npy`` bit for bit at band gain 0.45, 1.2 and 1.2 multi-segment,
  under the JAX script's directory names.
* The report: on the recorded rows, the port's table rows and verdict lines
  are the JAX report's (``_arm_table``) for each cell and tie strategy, with
  ``ours_jax`` relabelled ``ours_torch``; with three arms each cell has one
  table and a verdict for each pair; the section is written between its
  markers and the deviations' section survives it.
* Pairing: the two arms of each deviation start from bit-equal parameters,
  draw the same first episode, and after one train step their generators
  are in the same state (the same draws); for the wav deviations the
  WaveAugment draws of both arms are equal.
* Each driver end to end with ``--device cpu`` at the helpers' small
  geometry (the model config monkeypatched): rows with the JAX rows' keys
  and the plain versions' launches (0 0 0), the calibration sweep, the
  deviations' summary and its resume cache; with no card and no ``--device
  cpu`` each driver raises.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from _torch_port_helpers import GEOMETRIES

REPO = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port_ab = _load("torch_port_ab_vs_reference", REPO / "scripts" / "torch_port_ab_vs_reference.py")
port_cal = _load("torch_port_ab_calibrate", REPO / "scripts" / "torch_port_ab_calibrate.py")
port_dev = _load("torch_port_ab_deviations", REPO / "scripts" / "torch_port_ab_deviations.py")
jax_ab = _load("jax_ab_vs_reference", REPO / "scripts" / "ab_vs_reference.py")
jax_dev = _load("jax_ab_deviations", REPO / "scripts" / "ab_deviations.py")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["cpl", "plain"])
@pytest.mark.parametrize("multiseg", [False, True], ids=["single", "mseg"])
def test_ab_experiment_dict_is_the_jax_scripts(monkeypatch, loss, multiseg):
    monkeypatch.setattr(jax_ab, "MULTISEG", multiseg)
    assert port_ab.experiment_dict(10, 16, 150, loss, multiseg) == jax_ab.experiment_dict(10, 16, 150, loss)
    assert port_ab.model_dict() == jax_ab.model_dict()


@pytest.mark.parametrize("loss", ["cpl", "plain"])
def test_ours_arm_config_is_the_jax_arms(monkeypatch, loss):
    """The JAX arm's dict, captured where its ``run_ours_arm`` builds the
    config, against the port's: equal but for the device."""
    import audio_few_shot_learning_tpu.config as jax_config

    seen = []

    def capture(d):
        seen.append(d)
        raise KeyboardInterrupt  # stop before the JAX arm trains

    monkeypatch.setattr(jax_config.ExperimentConfig, "from_dict", staticmethod(capture))
    with pytest.raises(KeyboardInterrupt):
        jax_ab.run_ours_arm(Path("unused"), 3, 10, 16, 150, loss=loss)
    monkeypatch.undo()
    want = seen[0]
    got = port_ab.ours_dict(10, 16, 150, loss, False, 3, torch.device("cuda:0"))
    assert {k: v for k, v in got.items() if k != "device"} == {k: v for k, v in want.items() if k != "device"}
    assert (got["device"], want["device"]) == ("cuda", "tpu")
    assert port_ab.ours_dict(10, 16, 150, loss, False, 3, CPU)["device"] == "cpu"


@pytest.fixture
def jax_dev_raw(monkeypatch):
    """The JAX script's ``build_*_exp`` functions returning their raw dicts."""
    import audio_few_shot_learning_tpu.config as jax_config

    monkeypatch.setattr(jax_config.ExperimentConfig, "from_dict", staticmethod(lambda d: d))
    monkeypatch.setattr(jax_config.ModelConfig, "from_dict", staticmethod(lambda d: d))
    return {"bn": jax_dev.build_spec_exp, "pitch": jax_dev.build_wav_exp, "lowpass": jax_dev.build_lowpass_exp}


@pytest.mark.parametrize("experiment", ["bn", "pitch", "lowpass"])
@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
def test_deviation_dicts_are_the_jax_scripts(jax_dev_raw, experiment, light):
    make_dicts = port_dev.EXPERIMENTS[experiment][0]
    for seed in (0, 4):
        for knob in (False, True):
            exp, mdl = make_dicts(seed, knob, 10, light)
            want_exp, want_mdl = jax_dev_raw[experiment](seed, knob, 10, light)
            assert want_exp.pop("data_root") == "/tmp" and "data_root" not in exp  # the port's data go to a temp dir
            assert (exp, mdl) == (want_exp, want_mdl)


def _diff(a, b, prefix=""):
    """The leaf paths where two nested dicts differ."""
    out = set()
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            out |= _diff(x, y, f"{prefix}{k}.")
        elif x != y:
            out.add(prefix + k)
    return out


@pytest.mark.parametrize("experiment,knob", [("bn", "tpu.bn_per_view_group"), ("pitch", "waveaug_params.pitchshift_mode"),
                                             ("lowpass", "waveaug_params.fuse_lowpass")])
def test_deviation_arms_differ_in_their_knob_alone(experiment, knob):
    make_dicts = port_dev.EXPERIMENTS[experiment][0]
    for light in (False, True):
        (a, ma), (b, mb) = make_dicts(2, False, 10, light), make_dicts(2, True, 10, light)
        assert _diff(a, b) == {knob} and ma == mb
        ca, cb = (port_dev.arm_configs(experiment, 2, k, 10, light, CPU) for k in (False, True))
        fields = lambda c: json.loads(json.dumps(dataclasses.asdict(c)))  # noqa: E731
        got = _diff(fields(ca[0]), fields(cb[0]))  # a WaveAugment knob is read from its raw dict
        assert got and got <= {knob, knob.replace("waveaug_params.", "waveaug_params.raw.")}, got


# ---------------------------------------------------------------------------
# the A/B's dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gain,multiseg", [(0.45, False), (1.2, False), (1.2, True)], ids=["g0.45", "g1.2", "g1.2_mseg"])
def test_ab_dataset_is_the_jax_scripts(tmp_path, monkeypatch, gain, multiseg):
    import audio_few_shot_learning_tpu.data.datasets as jax_datasets

    real = jax_datasets.make_synthetic_dataset
    seen = []

    def redirected(root, **kw):  # the JAX script writes under /tmp
        seen.append(Path(root).name)
        return real(tmp_path / "jax" / Path(root).name, **kw)

    monkeypatch.setattr(jax_datasets, "make_synthetic_dataset", redirected)
    monkeypatch.setattr(jax_ab, "BAND_GAIN", gain)
    monkeypatch.setattr(jax_ab, "MULTISEG", multiseg)
    jax_root = jax_ab.make_dataset()
    root = port_ab.make_dataset(tmp_path / "port", gain, multiseg)
    assert root.name == seen[0] == Path(jax_root).name
    files = sorted(p.relative_to(jax_root) for p in Path(jax_root).rglob("*.npy"))
    assert files == sorted(p.relative_to(root) for p in root.rglob("*.npy")) and len(files) == 16 * 12 + 2
    for rel in files:  # bit for bit, splits.npy included
        assert (root / rel).read_bytes() == (Path(jax_root) / rel).read_bytes(), rel


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def _recorded_cells():
    rows = port_ab.read_rows(port_ab.RECORDED)
    cells = {}
    for r in rows:
        mseg = bool(r.get("multiseg", False))
        keys = [f"test_acc_{t or 'first'}" for t in port_ab.TIE_STRATEGIES] if mseg else ["test_acc"]
        for key in keys:
            frows = [x for x in rows if bool(x.get("multiseg", False)) == mseg
                     and x.get("band_gain") == r.get("band_gain") and x.get("loss", "cpl") == r.get("loss", "cpl")
                     and key in x]
            cells[(mseg, r.get("band_gain"), r.get("loss", "cpl"), key)] = frows
    return cells


RECORDED_CELLS = _recorded_cells()


@pytest.mark.parametrize("cell", sorted(RECORDED_CELLS, key=str), ids=lambda c: "-".join(map(str, c)))
def test_report_statistics_are_the_jax_reports(cell):
    frows = RECORDED_CELLS[cell]
    acc_key = cell[3]
    assert {r["arm"] for r in frows} == {"ours_jax", "reference_torch"}
    want = []
    jax_ab._arm_table(want, frows, acc_key=acc_key)
    relabelled = [{**r, "arm": "ours_torch" if r["arm"] == "ours_jax" else r["arm"]} for r in frows]
    got = []
    verdicts = port_ab.arm_table(got, relabelled, acc_key)
    want_rows = sorted(line.replace("| ours_jax |", "| ours_torch |") for line in want if line.startswith("| ") and
                       not line.startswith("| arm"))
    assert sorted(line for line in got if line.startswith("| ") and not line.startswith("| arm")) == want_rows
    (verdict_line,) = [line for line in want if line.startswith("Arm delta")]
    (got_line,) = [line for line in got if line.startswith("`ours_torch` vs `reference_torch`: ")]
    assert got_line.split(": ", 1)[1] == "a" + verdict_line[1:]
    assert list(verdicts) == ["ours_torch vs reference_torch"]


def test_report_has_three_arms_a_cell(tmp_path):
    rows = port_ab.read_rows(port_ab.RECORDED)
    port_rows = [{**r, "arm": "ours_torch", "card": "NVIDIA H100 80GB HBM3, 700.00 W"} for r in rows
                 if r["arm"] == "ours_jax"]
    text, verdicts = port_ab.report(port_rows + rows)
    assert len({c.rsplit(" ", 1)[0] if c.startswith("mseg") else c for c in verdicts}) == 5  # the five cells
    assert len(verdicts) == 4 + 3  # one table a single-segment cell, one a tie strategy of the multi-segment one
    for v in verdicts.values():
        assert set(v) == {"ours_torch vs reference_torch", "ours_jax vs reference_torch", "ours_torch vs ours_jax"}
        assert v["ours_torch vs ours_jax"]["delta"] == 0.0 and v["ours_torch vs ours_jax"]["within"]
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text and "ADVICE.md" in text
    out = tmp_path / "P.md"
    port_ab.write_section(out, "ab_deviations", "deviations, first")
    port_ab.write_section(out, port_ab.SECTION, text)
    port_ab.write_section(out, port_ab.SECTION, port_ab.report(rows)[0])  # rewritten in place
    body = out.read_text()
    assert body.count("<!-- ab_vs_reference: begin -->") == 1 and "deviations, first" in body
    assert body.index("<!-- ab_deviations: begin -->") < body.index("<!-- ab_vs_reference: begin -->")


# ---------------------------------------------------------------------------
# pairing of the deviation arms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def light_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dev_data")
    return {name: port_dev.make_dataset(name, root, light=True) for name in ("bn", "pitch", "lowpass")}


@pytest.mark.parametrize("experiment", ["bn", "pitch", "lowpass"])
def test_deviation_arms_are_paired(light_data, experiment):
    trainers, draws = [], []
    for knob in (False, True):
        exp, mdl = port_dev.arm_configs(experiment, 1, knob, 1, True, CPU, tasks=2, test_tasks=2)
        trainers.append(port_dev.make_trainer(exp, mdl, light_data[experiment], CPU))
        if exp.input_type == "wav":
            tr = trainers[-1]
            draws.append(tr.waveaugment.draw(torch.Generator().manual_seed(5), (2, 6), tr.train_store.seg_len, CPU))
    a, b = trainers
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    exp = a.exp
    eps = [tr._batches(tr.train_store, exp.n_way_train, exp.n_shot_train, exp.n_query_train)(1) for tr in trainers]
    for f in dataclasses.fields(eps[0]):
        x, y = getattr(eps[0], f.name), getattr(eps[1], f.name)
        assert (x is None and y is None) or torch.equal(x, y), f.name
    for tr, ep in zip(trainers, eps):
        tr.train_step(ep)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())  # the step drew the same numbers
    if draws:
        assert set(draws[0]) == set(draws[1])
        for name in draws[0]:
            for leaf in draws[0][name]:
                assert torch.equal(draws[0][name][leaf], draws[1][name][leaf]), (name, leaf)


# ---------------------------------------------------------------------------
# the drivers end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def small_ab(tmp_path, monkeypatch):
    (f, t), mdl = GEOMETRIES["small"]
    (tmp_path / "mdl.json").write_text(json.dumps(mdl))
    for module in (port_ab, port_cal.ab, port_dev.ab):
        monkeypatch.setattr(module, "MODEL_CONFIG", tmp_path / "mdl.json")
        monkeypatch.setattr(module, "N_MELS", f)
        monkeypatch.setattr(module, "N_FRAMES", t)
    return tmp_path


DEPTH = ["--epochs", "1", "--tasks", "2", "--test-tasks", "4", "--device", "cpu"]
JAX_ROW_KEYS = {"arm", "loss", "seed", "best_val_acc", "backend", "test_acc", "test_acc_task_std", "seconds", "epochs",
                "tasks", "test_tasks", "band_gain", "multiseg", "dataset_seed"}


@pytest.mark.parametrize("multiseg", [False, True], ids=["single", "mseg"])
def test_ab_driver_runs_on_the_cpu(small_ab, multiseg):
    results = small_ab / "results.jsonl"
    rows = port_ab.main(["--seeds", "0", "1", "--band-gain", "1.2", "--results", str(results), *DEPTH]
                        + (["--multiseg"] if multiseg else []))
    assert [json.loads(line) for line in results.read_text().splitlines()] == rows and len(rows) == 2
    for r in rows:
        assert JAX_ROW_KEYS <= set(r) and r["arm"] == "ours_torch" and r["backend"] == "cpu" and r["card"] is None
        assert (r["band_gain"], r["multiseg"], r["dataset_seed"], r["test_tasks"]) == (1.2, multiseg, 77, 4)
        assert r["launches_per_train_step"] == {"0 0 0": 2} and set(r["launches_per_eval_batch"]) == {"0 0 0"}
        assert 0.0 <= r["test_acc"] <= 1.0 and 0.0 <= r["best_val_acc"] <= 1.0
        if multiseg:
            assert {f"test_acc_{t}" for t in ("first", "min_label", "max_posterior")} <= set(r)
            assert r["test_acc"] == r["test_acc_max_posterior"]
    out = small_ab / "P.md"
    port_ab.main(["--report", "--results", str(results), "--out", str(out)])
    assert "| ours_torch |" in out.read_text() and "| reference_torch |" in out.read_text()


def test_calibrate_driver_runs_on_the_cpu(small_ab):
    out = port_cal.main(["--gains", "0.8", "2.0", "--json", str(small_ab / "sweep.json"), "--out",
                         str(small_ab / "P.md"), *DEPTH])
    assert [g for g, _ in out["sweep"]] == [0.8, 2.0] and all(0.0 <= a <= 1.0 for _, a in out["sweep"])
    assert json.loads((small_ab / "sweep.json").read_text())["sweep"] == [list(x) for x in out["sweep"]]
    assert dict(out["jax_sweep"]) == {0.45: 0.28, 1.2: 0.68, 1.6: 0.73, 2.0: 0.84}
    text = (small_ab / "P.md").read_text()
    assert "<!-- ab_calibrate: begin -->" in text and "| 0.8 | " in text and "| 1.6 | not run | 0.73 |" in text


def test_deviations_driver_runs_on_the_cpu(tmp_path):
    argv = ["--seeds", "2", "--light", "--experiment", "lowpass", "--cache", str(tmp_path / "cache.jsonl"),
            "--out", str(tmp_path / "P.md"), "--json", str(tmp_path / "dev.json"), *DEPTH]
    out = port_dev.main(argv)
    summary = out["summary"]["lowpass"]
    assert set(summary) == {"paired_delta_mean", "paired_delta_std", "min_detectable_effect", "n_seeds", "verdict"}
    assert summary["n_seeds"] == 2 and json.loads((tmp_path / "dev.json").read_text())["summary"] == out["summary"]
    runs = out["runs"]["lowpass"]
    assert set(runs) == {"lp_reference_order", "lp_fused"}
    for arm in runs.values():
        assert all(r["launches_per_train_step"] == {"0 0 0": 2} for r in arm)
    assert "<!-- ab_deviations: begin -->" in (tmp_path / "P.md").read_text()
    again = port_dev.main(argv)  # every run from the cache
    assert all(r["cached"] for arm in again["runs"]["lowpass"].values() for r in arm)
    assert again["summary"] == out["summary"]


def test_ab_drivers_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ab.main(["--seeds", "0", "--results", str(tmp_path / "r.jsonl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cal.main(["--gains", "1.2", "--out", str(tmp_path / "P.md")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dev.main(["--seeds", "1", "--cache", str(tmp_path / "c.jsonl"), "--out", str(tmp_path / "P.md")])
    assert not list(tmp_path.iterdir())  # raised before writing anything
