"""The reference's full experiment protocol, end to end, in the PyTorch/CUDA
port: the port's counterpart of ``scripts/full_protocol.py``.

Per run 200 epochs x 100 train tasks at one optimizer step per episode
(``episode_batch`` 1), each epoch followed by a 100-task validation, early
stopping with patience 70, the best model reloaded, then a 2000-task test
(reference src/train_test.py:103, README.md:74-124), through the port's
``cli.train_test`` at the flagship's geometry (``configs/esc50_cpl.json``
+ ``configs/model_config_esc50.json``: Hybrid, SpecAugment 4 views,
attention, CPL, 5-way 5-shot 5-query, 128x157) on a learnable synthetic
dataset (20 classes x 15 items, split 10 / 5 / 5, seed 31, band gain 1.2:
the JAX script's). A second pass runs the multi-segment variant (1-6
segments an item, the majority vote with ``max_posterior`` ties).

    python scripts/torch_port_full_protocol.py [--runs 5] [--mseg-runs 2] [--band-gain 1.2]
        [--compute-dtype bfloat16|float32]

The data goes to a temporary directory; each pass's run folders to
``experiments/torch_full_protocol{,_mseg}_{bf16,f32}/`` (``_seed{s}`` added
for a ``--seed`` other than 0) and the summary to ``summary.json`` in the
single-segment folder, rewritten after each pass. ``--compute-dtype`` writes ``tpu.compute_dtype`` and ``--seed``
``tpu.seed`` (the shipped 0); runs of the same ``tpu.seed`` and run index
draw the same episodes from the same initial weights at either precision,
and run i of seed s is run 0 of seed s + i. ``--epochs``, ``--tasks`` and
``--test-tasks`` cut the depth (``chip_smoke.py`` drives the path with
them); the defaults are the protocol's.

The summary holds the JAX script's keys and, per run, the median train step
(ms, the metrics log's per-epoch medians) of the first and of the last 10
epochs, the epochs ran, the epoch of the best validation, the validation
curve, the launches of K1 (SpecAugment views), K2 (episode scores) and K3
(mel + log) per train step and per eval batch, and whether the test ran on
the weights of the run's ``model.ckpt``; per pass the peak of allocated
memory (``torch.cuda.max_memory_allocated``, reset before the pass); and
the card's name and power limit. It runs where the config says (the
shipped ``"tpu"``: the card) and raises with no card. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

N_MELS, N_FRAMES = 128, 157
EXPERIMENT_CONFIG = REPO / "configs" / "esc50_cpl.json"
MODEL_CONFIG = REPO / "configs" / "model_config_esc50.json"
EXPERIMENTS_ROOT = REPO / "experiments"
DTYPE_TAG = {"bfloat16": "bf16", "float32": "f32"}
DRIFT_EPOCHS = 10  # the first and the last this many epochs' step times


def dataset_name(band_gain: float, mseg: bool) -> str:
    return f"full_protocol{'_mseg' if mseg else ''}_g{band_gain:g}"


def experiment_folder(mseg: bool, compute_dtype: str, seed: int = 0) -> str:
    return f"torch_full_protocol{'_mseg' if mseg else ''}_{DTYPE_TAG[compute_dtype]}{f'_seed{seed}' if seed else ''}"


def experiment_json(band_gain: float, runs: int, mseg: bool, compute_dtype: str = "bfloat16", data_root: str = "",
                    epochs: int = 200, tasks: int = 100, test_tasks: int = 2000, seed: int = 0) -> dict:
    """The flagship ESC-50 CPL hyperparameters (``configs/esc50_cpl.json``,
    the reference README's best values) at the protocol's scale: the JAX
    script's config, in the port's folder and at ``compute_dtype``."""
    with open(EXPERIMENT_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(
        {
            "dataset_name": dataset_name(band_gain, mseg),
            "data_root": data_root,
            "num_epochs": epochs,
            "n_training_tasks": tasks,
            "n_testing_tasks": test_tasks,
            "multi_segm": mseg,
            "tie_strategy": "max_posterior" if mseg else "",
            "experiment_folder": experiment_folder(mseg, compute_dtype, seed),
        }
    )
    cfg["tpu"] = {
        "episode_batch": 1,  # the reference's granularity: one optimizer step per episode
        "eval_episode_batch": 16,
        "mesh_shape": 1,
        "num_runs": runs,
        "compute_dtype": compute_dtype,
        "seed": seed,  # run i draws from seed + i
    }
    return cfg


def make_data(band_gain: float, mseg: bool, data_root: str) -> str:
    """The JAX script's synthetic dataset under ``data_root``."""
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    root = os.path.join(data_root, dataset_name(band_gain, mseg))
    make_synthetic_dataset(
        root,
        n_classes=20,
        items_per_class=15,
        n_mels=N_MELS,
        n_frames=N_FRAMES,
        multi_segm=mseg,
        max_segments=6,
        split_fractions=(10, 5, 5),
        seed=31,
        band_gain=band_gain,
    )
    return root



def run_summary(rows: list, result: dict) -> dict:
    """One run's summary from its metrics log and its result file."""
    best, best_epoch = -1.0, None
    for r in rows:  # early stopping re-checkpoints on ">="
        if r["val_accuracy"] >= best:
            best, best_epoch = r["val_accuracy"], r["epoch"]
    steps = [r["step_ms"] for r in rows]
    return {
        "test_acc": round(float(result["mean_accuracy"]), 4),
        "best_val_acc": round(float(result["best_val_accuracy"]), 4),
        "train_seconds": round(float(result["train_seconds"]), 1),
        "train_eps_per_sec": round(float(result["train_episodes_per_sec"]), 1),
        "test_acc_std": float(result["accuracy_std"]),
        "epochs_ran": len(rows),
        "best_val_epoch": best_epoch,
        "step_ms_first_epochs_median": statistics.median(steps[:DRIFT_EPOCHS]),
        "step_ms_last_epochs_median": statistics.median(steps[-DRIFT_EPOCHS:]),
        "drift_epochs": min(DRIFT_EPOCHS, len(rows)),
        "val_curve": [r["val_accuracy"] for r in rows],
    }


def run_pass(band_gain: float, runs: int, mseg: bool, compute_dtype: str, data_root: str,
             experiments_root: str, epochs: int, tasks: int, test_tasks: int, seed: int = 0) -> dict:
    from audio_few_shot_learning_tpu_torch.cli import train_test
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig
    from audio_few_shot_learning_tpu_torch.device import config_device
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    cfg = experiment_json(band_gain, runs, mseg, compute_dtype, data_root, epochs, tasks, test_tasks, seed)
    device = config_device(ExperimentConfig.from_dict(cfg))  # no card and no "device": "cpu" raises here
    make_data(band_gain, mseg, data_root)
    cfg_path = os.path.join(data_root, f"full_protocol_exp{'_mseg' if mseg else ''}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    cuda = device.type == "cuda"
    folder = os.path.join(experiments_root, cfg["experiment_folder"])
    model_path = os.path.join(folder, "model.ckpt")

    # the weights each run's test ran on, held against the run's best checkpoint
    reloaded = []
    test = Trainer.test

    def checked_test(self):
        best = torch.load(model_path, map_location="cpu", weights_only=True)  # train/checkpoint.py's format
        live = self.model.state_dict()
        reloaded.append(set(best) == set(live) and all(torch.equal(best[k].cpu(), live[k].cpu()) for k in best))
        return test(self)

    if cuda:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialized
        torch.cuda.reset_peak_memory_stats(device)
    steps, batches = [], []
    t0 = time.perf_counter()
    Trainer.test = checked_test
    try:
        with launches_per_call(Trainer, "train_step", steps), launches_per_call(Trainer, "_eval_episodes", batches):
            results = train_test.main(["-e", cfg_path, "-m", str(MODEL_CONFIG), "--experiments-root", experiments_root])
    finally:
        Trainer.test = test
    wall = time.perf_counter() - t0

    per_run, epochs_ran = [], []
    for i, result in enumerate(results):
        with open(os.path.join(folder, f"metrics_run{i}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        run = run_summary(rows, result)
        run["test_ran_on_model_ckpt"] = reloaded[i]
        per_run.append(run)
        epochs_ran.append(run["epochs_ran"])
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    return {
        "variant": "multiseg" if mseg else "single",
        "runs": runs,
        "band_gain": band_gain,
        "compute_dtype": compute_dtype,
        "seed": seed,
        "device": str(device),
        "experiment_folder": cfg["experiment_folder"],
        "epochs": epochs,
        "tasks": tasks,
        "test_tasks": test_tasks,
        "wall_clock_seconds": round(wall, 1),
        "peak_hbm_gb": None if peak is None else round(peak, 3),  # the JAX script's key
        "peak_memory_allocated_gb": peak,
        "epochs_ran_per_run": epochs_ran,
        "train_steps": len(steps),
        "launches_per_train_step": tally_launches(steps),
        "eval_batches": len(batches),
        "launches_per_eval_batch": tally_launches(batches),
        "per_run": per_run,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--mseg-runs", type=int, default=2)
    ap.add_argument("--band-gain", type=float, default=1.2)
    ap.add_argument("--compute-dtype", choices=sorted(DTYPE_TAG), default="bfloat16")
    ap.add_argument("--epochs", type=int, default=200, help="cut depth (default: the protocol's 200)")
    ap.add_argument("--tasks", type=int, default=100, help="train (and validation) tasks an epoch")
    ap.add_argument("--test-tasks", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0, help="tpu.seed; run i draws from seed + i")
    ap.add_argument("--experiments-root", default=str(EXPERIMENTS_ROOT))
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    summary = {
        "protocol": f"{args.runs}x({args.epochs} epochs x {args.tasks} tasks) + {args.test_tasks}-task test "
                    "(reference src/train_test.py:103, README.md:74-124)",
        "card": card() if torch.cuda.is_available() else None,
        "torch": torch.__version__,
        "compute_dtype": args.compute_dtype,
    }
    out = Path(args.experiments_root) / experiment_folder(False, args.compute_dtype, args.seed) / "summary.json"
    passes = [("single_segment", args.runs, False)]
    if args.mseg_runs:
        passes.append(("multi_segment", args.mseg_runs, True))
    with tempfile.TemporaryDirectory(prefix="torch_full_protocol_") as data_root:
        for key, runs, mseg in passes:
            summary[key] = run_pass(args.band_gain, runs, mseg, args.compute_dtype, data_root, args.experiments_root,
                                    args.epochs, args.tasks, args.test_tasks, args.seed)
            summary["total_wall_clock_minutes"] = round((time.perf_counter() - t0) / 60, 1)
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "w") as f:
                json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
