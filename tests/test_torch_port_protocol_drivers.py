"""PyTorch port: the two protocol drivers, ``scripts/torch_port_full_protocol.py``
and ``scripts/torch_port_parity_runbook.py``, against the JAX package's
``scripts/full_protocol.py`` and ``scripts/parity_runbook.py``, on the CPU
(~40 s in one process).

* The configs: the full protocol's ``experiment_json`` and each of the 15
  cells' configs, as shipped and shrunk for ``--dry-run``, loaded through
  each package's ``load_configs``, field for field; the port's differ only
  in ``data_root`` and ``experiment_folder`` (its own folders, never a JAX
  one) and in ``tpu.compute_dtype`` where it is set.
* The fabricated datasets: the JAX scripts' files, bit-equal (each JAX
  script's dataset maker redirected into the test's directory).
* One single-segment and one multi-segment runbook cell, and the full
  protocol at ``--epochs 2 --tasks 4 --test-tasks 8``, run with
  ``"device": "cpu"`` at the helpers' small geometry (96x99, 8 channels)
  and write their result files, table rows and ``summary.json`` (with the
  JAX summary's keys, ``experiments/full_protocol/summary.json``, and the
  port's) under the test's directory.
* With no card and a shipped config (``"device": "tpu"``) both raise: the
  runbook records the cell's error and exits 1; nothing runs on the CPU.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import GEOMETRIES
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parents[1]
CELLS = [(d, loss) for d in ("esc50", "fsd2018", "nsynth", "birdclef", "voxceleb") for loss in ("plain", "cpl", "apl")]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port_fp = _load("torch_port_full_protocol", REPO / "scripts" / "torch_port_full_protocol.py")
port_rb = _load("torch_port_parity_runbook", REPO / "scripts" / "torch_port_parity_runbook.py")
jax_fp = _load("jax_full_protocol", REPO / "scripts" / "full_protocol.py")
jax_rb = _load("jax_parity_runbook", REPO / "scripts" / "parity_runbook.py")


def _fields(exp, mdl) -> dict:
    d = {"experiment": dataclasses.asdict(exp), "model": dataclasses.asdict(mdl)}
    d["model"].pop("ast", None)  # the port's AST group: the JAX package has no AST encoder
    return json.loads(json.dumps(d))  # tuples as lists, as both packages' configs hold them


def _loaded(pkg_cfg, exp_dict: dict, tmp_path: Path, name: str) -> dict:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(exp_dict))
    return _fields(*pkg_cfg.load_configs(str(path), str(REPO / "configs" / "model_config_esc50.json")))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mseg", [False, True], ids=["single", "mseg"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_full_protocol_config_is_the_jax_scripts(tmp_path, mseg, compute_dtype):
    want = _loaded(jcfg, jax_fp.experiment_json(1.2, 5, mseg), tmp_path, "jax")
    got = _loaded(tcfg, port_fp.experiment_json(1.2, 5, mseg, compute_dtype, str(tmp_path / "data")), tmp_path,
                  "port")
    folder = got["experiment"]["experiment_folder"]
    assert folder == f"torch_full_protocol{'_mseg' if mseg else ''}_{port_fp.DTYPE_TAG[compute_dtype]}"
    assert folder != want["experiment"]["experiment_folder"]
    assert got["experiment"]["tpu"]["compute_dtype"] == compute_dtype
    for exp in (got["experiment"], want["experiment"]):
        del exp["data_root"], exp["experiment_folder"], exp["tpu"]["compute_dtype"]
    assert got == want
    assert (got["experiment"]["num_epochs"], got["experiment"]["n_training_tasks"],
            got["experiment"]["n_testing_tasks"], got["experiment"]["patience"]) == (200, 100, 2000, 70)


@pytest.mark.parametrize("dataset,loss", CELLS)
def test_runbook_cell_configs_are_the_jax_scripts(dataset, loss):
    want_exp, want_mdl = jax_rb.load_cell_configs(dataset, loss)
    got_exp, got_mdl = port_rb.load_cell_configs(dataset, loss)
    assert _fields(got_exp, got_mdl) == _fields(want_exp, want_mdl)
    assert _fields(port_rb.shrink_for_dry_run(got_exp), got_mdl) == \
        _fields(jax_rb.shrink_for_dry_run(want_exp), want_mdl)


# ---------------------------------------------------------------------------
# fabricated data
# ---------------------------------------------------------------------------


def _same_tree(a: Path, b: Path) -> int:
    files = sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    assert files == sorted(p.relative_to(b) for p in b.rglob("*.npy")) and files
    for rel in files:
        x, y = np.load(a / rel, allow_pickle=True), np.load(b / rel, allow_pickle=True)
        if rel.name == "splits.npy":
            assert [list(s) for s in x] == [list(s) for s in y]
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            np.testing.assert_array_equal(x, y, err_msg=str(rel))
    return len(files)


@pytest.fixture
def jax_maker_into(monkeypatch, tmp_path):
    """The JAX package's ``make_synthetic_dataset`` with its root moved
    under ``tmp_path / "jax"`` (the JAX full-protocol script writes /tmp)."""
    import audio_few_shot_learning_tpu.data.datasets as jax_datasets

    real = jax_datasets.make_synthetic_dataset

    def redirected(root, **kw):
        return real(tmp_path / "jax" / Path(root).name, **kw)

    monkeypatch.setattr(jax_datasets, "make_synthetic_dataset", redirected)
    return tmp_path / "jax"


@pytest.mark.parametrize("mseg", [False, True], ids=["single", "mseg"])
def test_full_protocol_data_is_the_jax_scripts(tmp_path, jax_maker_into, mseg):
    jax_fp.make_data(1.2, mseg)
    root = Path(port_fp.make_data(1.2, mseg, str(tmp_path / "port")))
    assert _same_tree(root, jax_maker_into / root.name) == 20 * 15 + 2


@pytest.mark.parametrize("dataset,loss", [("esc50", "cpl"), ("birdclef", "cpl")], ids=["single", "mseg"])
def test_runbook_dry_run_data_is_the_jax_scripts(tmp_path, dataset, loss):
    exp, _ = port_rb.load_cell_configs(dataset, loss)
    jexp, _ = jax_rb.load_cell_configs(dataset, loss)
    port_rb.make_dry_run_data(exp, str(tmp_path / "port"))
    jax_rb.make_dry_run_data(jexp, str(tmp_path / "jax"))
    assert _same_tree(tmp_path / "port" / exp.dataset_name, tmp_path / "jax" / jexp.dataset_name) == 20 * 14 + 2


# ---------------------------------------------------------------------------
# runs on the CPU at the small geometry
# ---------------------------------------------------------------------------


def _cpu_configs(tmp_path: Path, cells) -> Path:
    """The shipped cells' configs with ``"device": "cpu"`` and the helpers'
    small model, in a config directory of the test's."""
    d = tmp_path / "configs"
    d.mkdir(exist_ok=True)
    for dataset, loss in cells:
        cfg = json.loads((REPO / "configs" / f"{dataset}_{loss}.json").read_text())
        cfg["device"] = "cpu"
        (d / f"{dataset}_{loss}.json").write_text(json.dumps(cfg))
        (d / f"model_config_{dataset}.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    return d


@pytest.mark.parametrize("dataset,loss", [("esc50", "cpl"), ("birdclef", "cpl")], ids=["single", "mseg"])
def test_runbook_cell_runs_on_the_cpu(tmp_path, monkeypatch, dataset, loss):
    monkeypatch.setattr(port_rb, "CONFIG_DIR", str(_cpu_configs(tmp_path, [(dataset, loss)])))
    monkeypatch.setattr(port_rb, "DRY_RUN_SHAPE", GEOMETRIES["small"][0])
    out = tmp_path / "table.md"
    rc = port_rb.main(["--dry-run", "--quiet", "--datasets", dataset, "--losses", loss, "--data-root",
                       str(tmp_path / "data"), "--experiments-root", str(tmp_path / "exps"), "--out", str(out)])
    assert rc == 0
    folder = tmp_path / "exps" / f"torch_parity_{dataset}_{loss}"
    assert {"config.json", "result_run0.json", "metrics_run0.jsonl", "model.ckpt"} <= {p.name for p in
                                                                                      folder.iterdir()}
    (cell,) = json.loads((tmp_path / "table.json").read_text())
    assert 0.0 <= cell["mean_accuracy"] <= 1.0 and cell["runs"] == 1 and cell["multi_segm"] == (dataset == "birdclef")
    assert cell["train_steps"] == 2 * 4 and cell["launches_per_train_step"] == {"0 0 0": 8}  # plain versions
    assert cell["eval_batches"] == 2 + 1  # two 4-task validations, one 8-task test
    assert cell["step_ms_last_epoch"] > 0 and cell["peak_memory_gb"] is None and "eval_peak_factor" not in cell
    row = [line for line in out.read_text().splitlines() if line.startswith(f"| {dataset} | {loss} |")]
    assert len(row) == 1 and "ERROR" not in row[0]
    # the defaults are the port's own paths, never the JAX runbook's
    assert os.path.basename(port_rb.EXPERIMENTS_ROOT) == "torch_parity"
    assert not any(p.startswith("parity_") for p in os.listdir(tmp_path / "exps"))


def test_full_protocol_runs_on_the_cpu(tmp_path, monkeypatch):
    cfg = json.loads((REPO / "configs" / "esc50_cpl.json").read_text())
    cfg["device"] = "cpu"
    (tmp_path / "exp.json").write_text(json.dumps(cfg))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    monkeypatch.setattr(port_fp, "EXPERIMENT_CONFIG", tmp_path / "exp.json")
    monkeypatch.setattr(port_fp, "MODEL_CONFIG", tmp_path / "mdl.json")
    monkeypatch.setattr(port_fp, "N_MELS", GEOMETRIES["small"][0][0])
    monkeypatch.setattr(port_fp, "N_FRAMES", GEOMETRIES["small"][0][1])
    root = tmp_path / "exps"
    port_fp.main(["--runs", "1", "--mseg-runs", "1", "--epochs", "2", "--tasks", "4", "--test-tasks", "8",
                  "--experiments-root", str(root)])
    summary = json.loads((root / "torch_full_protocol_bf16" / "summary.json").read_text())
    jax_summary = json.loads((REPO / "experiments" / "full_protocol" / "summary.json").read_text())
    assert set(jax_summary) <= set(summary)
    for key in ("single_segment", "multi_segment"):
        got, want = summary[key], jax_summary[key]
        assert set(want) <= set(got)
        assert set(want["per_run"][0]) <= set(got["per_run"][0])
        assert got["device"] == "cpu" and got["epochs_ran_per_run"] == [2] and got["train_steps"] == 8
        assert got["launches_per_train_step"] == {"0 0 0": 8} and got["eval_batches"] == 3
        run = got["per_run"][0]
        assert run["epochs_ran"] == 2 and run["best_val_epoch"] in (1, 2) and len(run["val_curve"]) == 2
        assert run["step_ms_first_epochs_median"] > 0 and run["step_ms_last_epochs_median"] > 0
        assert run["test_ran_on_model_ckpt"] is True and 0.0 <= run["test_acc"] <= 1.0
    assert summary["card"] is None and summary["compute_dtype"] == "bfloat16"
    for folder in ("torch_full_protocol_bf16", "torch_full_protocol_mseg_bf16"):
        assert (root / folder / "result_run0.json").exists()
    assert sorted(p.name for p in root.iterdir()) == ["torch_full_protocol_bf16", "torch_full_protocol_mseg_bf16"]


def test_drivers_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fp.main(["--runs", "1", "--mseg-runs", "0", "--epochs", "1", "--experiments-root", str(tmp_path)])
    rc = port_rb.main(["--dry-run", "--quiet", "--datasets", "esc50", "--losses", "plain", "--data-root",
                       str(tmp_path / "data"), "--experiments-root", str(tmp_path / "exps"),
                       "--out", str(tmp_path / "t.md")])
    (cell,) = json.loads((tmp_path / "t.json").read_text())
    assert rc == 1 and "no CUDA device" in cell["error"]
    assert not (tmp_path / "data").exists() and not (tmp_path / "exps").exists()  # nothing ran
