"""Accuracy-parity runbook of the PyTorch/CUDA port: every shipped
(dataset x loss) config end to end, the port's counterpart of
``scripts/parity_runbook.py``.

    python scripts/torch_port_parity_runbook.py --data-root /data

runs each of the 15 ``configs/{dataset}_{loss}.json`` (with
``configs/model_config_{dataset}.json``) through the port's
``run_experiment``, the driver ``cli.train_test`` runs (5 runs each, as the
config says), and writes ``PARITY_TORCH_RESULTS.md`` and ``.json``. The
data is the MetaAudio layout under ``--data-root``
(``<root>/<dataset_name>/features/<class>/*.npy`` + ``splits.npy`` +
``norm_stats/glob_norm.npy``, what ``preprocessing.full_stack`` writes).

    python scripts/torch_port_parity_runbook.py --dry-run

fabricates a synthetic dataset per config instead (20 classes x 14 items
of 128x157, multi-segment with up to 3 segments where the config says so,
split 8 / 6 / 6, seed 0: the JAX runbook's) under
``experiments/torch_parity_data/`` and runs each cell at toy scale (1 run,
2 epochs of 4 tasks, 8 test tasks, patience 5), writing
``PARITY_TORCH_DRYRUN.md`` and ``.json``. Each cell's folder is
``torch_parity_{dataset}_{loss}`` under ``--experiments-root``
(``experiments/torch_parity/``).

Beside the accuracy each cell records the launches of K1 (SpecAugment
views), K2 (episode scores) and K3 (mel + log) per train step and per eval
batch, every step and batch read around the call; the median train step
of the last epoch (ms, the metrics log's); the peak of allocated memory
over the cell (``torch.cuda.max_memory_allocated``, reset before it); and,
for a multi-segment config on the card, the eval batch E the engine
reckoned for its test and the peak of allocated memory over one batch of
E after the test, divided by E x the reckoned block-0 bytes
(``train/engine.py::measure_eval_peak``, held under ``EVAL_PEAK_FACTOR``
by ``chip_smoke.py``).

The configs run where they say (``"device"``: the shipped ``"tpu"`` means
the card; ``"cpu"`` runs on the CPU); with no card they raise. A cell that
fails is recorded with its error and the others still run; any failed cell
makes the script exit 1. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CONFIG_DIR = os.path.join(REPO, "configs")
DATASETS = ["esc50", "fsd2018", "nsynth", "birdclef", "voxceleb"]
LOSSES = ["plain", "cpl", "apl"]
DRY_RUN_SHAPE = (128, 157)  # the fabricated spectrograms' mel bins x frames
EXPERIMENTS_ROOT = os.path.join(REPO, "experiments", "torch_parity")
DRY_RUN_DATA = os.path.join(REPO, "experiments", "torch_parity_data")


def load_cell_configs(dataset: str, loss: str):
    from audio_few_shot_learning_tpu_torch.config import load_configs

    return load_configs(os.path.join(CONFIG_DIR, f"{dataset}_{loss}.json"),
                        os.path.join(CONFIG_DIR, f"model_config_{dataset}.json"))


def make_dry_run_data(exp, root: str) -> None:
    """A synthetic dataset in the reference layout under ``root /
    exp.dataset_name``, multi-segment where the config is: the JAX
    runbook's arguments, so the files are its files."""
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    # every shipped config is 5-way 5-shot 5-query: each split needs >= 5
    # classes (6 for margin) and >= 10 items a class
    make_synthetic_dataset(
        os.path.join(root, exp.dataset_name),
        n_classes=20,
        items_per_class=14,
        n_mels=DRY_RUN_SHAPE[0],
        n_frames=DRY_RUN_SHAPE[1],
        multi_segm=exp.multi_segm,
        max_segments=3,
        split_fractions=(8, 6, 6),
        seed=0,
    )


def shrink_for_dry_run(exp):
    return dataclasses.replace(
        exp,
        num_epochs=2,
        n_training_tasks=4,
        n_testing_tasks=8,
        patience=5,
        tpu=dataclasses.replace(exp.tpu, num_runs=1),
    )


def run_cell(dataset: str, loss: str, data_root: str, experiments_root: str, dry_run: bool,
             runs, log) -> dict:
    from audio_few_shot_learning_tpu_torch.device import config_device
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer, measure_eval_peak
    from audio_few_shot_learning_tpu_torch.train.experiment import run_experiment
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    exp, mdl = load_cell_configs(dataset, loss)
    exp = dataclasses.replace(exp, data_root=data_root, experiment_folder=f"torch_parity_{dataset}_{loss}")
    device = config_device(exp)  # no card and no "device": "cpu" raises here
    if dry_run:
        make_dry_run_data(exp, data_root)
        exp = shrink_for_dry_run(exp)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialized
        torch.cuda.reset_peak_memory_stats(device)

    peaks = []
    test = Trainer.test

    def test_then_measure(self):
        out = test(self)
        if cuda and exp.multi_segm:  # after the test, so its episodes are the run's own
            peaks.append(measure_eval_peak(
                self, self.test_store, exp.n_testing_tasks, exp.n_way_test, exp.n_shot_test,
                exp.n_query_test, exp.test_query_augmentations, exp.tie_strategy))
        return out

    steps, batches = [], []
    t0 = time.perf_counter()
    Trainer.test = test_then_measure
    try:
        with launches_per_call(Trainer, "train_step", steps), launches_per_call(Trainer, "_eval_episodes", batches):
            results = run_experiment(exp, mdl, experiments_root=experiments_root, log_fn=log, num_runs=runs)
    finally:
        Trainer.test = test
    wall = time.perf_counter() - t0
    folder = os.path.join(experiments_root, exp.experiment_folder)
    with open(os.path.join(folder, "metrics_run0.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    accs = [r["mean_accuracy"] for r in results]
    cell = {
        "dataset": dataset,
        "loss": loss,
        "runs": len(results),
        "mean_accuracy": float(np.mean(accs)),
        "std_over_runs": float(np.std(accs)),
        "per_run": accs,
        "wall_seconds": wall,
        "multi_segm": exp.multi_segm,
        "specaugment": exp.specaug_params.use,
        "device": str(device),
        "train_steps": len(steps),
        "launches_per_train_step": tally_launches(steps),
        "eval_batches": len(batches),
        "launches_per_eval_batch": tally_launches(batches),
        "step_ms_last_epoch": rows[-1]["step_ms"],
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
    }
    if peaks:
        p = peaks[0]
        cell.update(eval_batch=p["eval_batch"], episode_block0_gb=p["episode_bytes"] / 1e9,
                    eval_peak_gb=p["peak_bytes"] / 1e9, eval_peak_factor=p["peak_factor"],
                    eval_peak_share_of_free=p["peak_share_of_free"])
    return cell


def _launch_text(d: dict) -> str:
    return ", ".join(f"{k} x{n}" for k, n in sorted(d.items()))


def write_table(cells: list, out_path: str, dry_run: bool) -> None:
    lines = [
        "# Accuracy parity vs reference best-hparam configs: PyTorch/CUDA port",
        "",
        f"Generated by `scripts/torch_port_parity_runbook.py`"
        f"{' --dry-run (synthetic data — numbers are NOT parity evidence)' if dry_run else ''}.",
        "Reference column: the reference repo publishes no accuracy numbers",
        "(SURVEY.md §6) — fill from the paper or a reproduced reference run.",
        "Launches are K1 K2 K3 per call x calls; ms/step is the last epoch's median step;",
        "peak/reckoned is one multi-segment eval batch's peak over E x the reckoned block-0 bytes.",
        "",
        "| dataset | loss | ours (mean ± std over runs) | reference | Δ | launches per train step "
        "| launches per eval batch | ms/step | peak GB | E | peak/reckoned |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if "error" in c:
            lines.append(f"| {c['dataset']} | {c['loss']} | ERROR: {c['error']} | — | — | | | | | | |")
            continue
        peak = "—" if c["peak_memory_gb"] is None else f"{c['peak_memory_gb']:.3f}"
        e = c.get("eval_batch", "—")
        factor = f"{c['eval_peak_factor']:.3f}" if "eval_peak_factor" in c else "—"
        lines.append(
            f"| {c['dataset']} | {c['loss']} | "
            f"{100 * c['mean_accuracy']:.2f} ± {100 * c['std_over_runs']:.2f} % ({c['runs']} runs) | _fill_ | _fill_ "
            f"| {_launch_text(c['launches_per_train_step'])} | {_launch_text(c['launches_per_eval_batch'])} "
            f"| {c['step_ms_last_epoch']:.2f} | {peak} | {e} | {factor} |"
        )
    lines += ["", "Raw per-run JSON: `<experiments root>/torch_parity_*/result_run*.json`."]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cell_line(c: dict) -> str:
    if "error" in c:
        return f"{c['dataset']} / {c['loss']}: ERROR {c['error']}"
    extra = ""
    if "eval_peak_factor" in c:
        extra = f", E {c['eval_batch']}, peak/reckoned {c['eval_peak_factor']:.3f}"
    peak = "" if c["peak_memory_gb"] is None else f", peak {c['peak_memory_gb']:.3f} GB"
    return (f"{c['dataset']} / {c['loss']}: {100 * c['mean_accuracy']:.2f} ± {100 * c['std_over_runs']:.2f} % "
            f"in {c['wall_seconds']:.1f} s, launches per step {_launch_text(c['launches_per_train_step'])}, "
            f"per eval batch {_launch_text(c['launches_per_eval_batch'])}, "
            f"{c['step_ms_last_epoch']:.2f} ms/step{peak}{extra}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", default=None, help="MetaAudio preprocessed root")
    p.add_argument("--datasets", default=",".join(DATASETS))
    p.add_argument("--losses", default=",".join(LOSSES))
    p.add_argument("--runs", type=int, default=None, help="Override runs per cell (default: config, 5)")
    p.add_argument("--experiments-root", default=EXPERIMENTS_ROOT)
    p.add_argument("--out", default=None,
                   help="Table path (default PARITY_TORCH_DRYRUN.md with --dry-run, else PARITY_TORCH_RESULTS.md)")
    p.add_argument("--dry-run", action="store_true", help="Synthetic data, toy scale — wiring check only")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if not args.data_root and not args.dry_run:
        p.error("--data-root is required unless --dry-run")
    out = args.out or os.path.join(REPO, "PARITY_TORCH_DRYRUN.md" if args.dry_run else "PARITY_TORCH_RESULTS.md")
    data_root = args.data_root or DRY_RUN_DATA
    log = (lambda *a, **k: None) if args.quiet else print

    cells = []
    for dataset in args.datasets.split(","):
        for loss in args.losses.split(","):
            print(f"=== {dataset} / {loss} ===", flush=True)
            try:
                cells.append(run_cell(dataset, loss, data_root, args.experiments_root, args.dry_run, args.runs, log))
            except Exception as e:  # keep the sweep alive; record the failure
                traceback.print_exc()
                cells.append({"dataset": dataset, "loss": loss, "error": f"{type(e).__name__}: {e}"})
            print("    " + cell_line(cells[-1]), flush=True)
            gc.collect()  # one cell's stores and models leave before the next cell's peak
            if torch.cuda.is_available():
                torch.cuda.empty_cache()

    write_table(cells, out, args.dry_run)
    with open(os.path.splitext(out)[0] + ".json", "w") as f:
        json.dump(cells, f, indent=2)
    print(f"Wrote {out}")
    return 0 if all("error" not in c for c in cells) else 1


if __name__ == "__main__":
    sys.exit(main())
