#!/usr/bin/env python3
"""Head-to-head training A/B of the PyTorch/CUDA port against the reference
torch code and the JAX package: the port's counterpart of
``scripts/ab_vs_reference.py``, its "ours" arm and its report.

The JAX script trains two arms on one on-disk synthetic dataset (written
once in the reference's layout by ``make_synthetic_dataset``, seed 77) with
one protocol: N epochs x T tasks an epoch, a T-task validation each epoch,
early stopping on validation accuracy with the best model reloaded, then a
single-segment test (or, ``--multiseg``, the majority-vote test under each of
the three tie strategies). Its two arms are the reference code itself
(torch on a CPU) and the JAX package; their rows are recorded in
``experiments/ab_vs_reference/results.jsonl``. This script runs the same
protocol through the port (``Trainer`` + ``run_single_training`` + ``test``
or ``evaluate``) on the same dataset, which the port's
``make_synthetic_dataset`` writes bit for bit as the JAX package does, and
appends its rows (``arm: "ours_torch"``, the JAX rows' keys plus the card,
the launches of K1 (SpecAugment views), K2 (episode scores) and K3 (mel +
log) per train step and per eval batch, and the median train step) to
``experiments/torch_ab_vs_reference/results.jsonl``. The reference arm
(``ab_vs_reference.py:163-378``) imports the reference's sources, which are
not in this repository; it is not ported, and the recorded rows stand in
for it.

    python3 scripts/torch_port_ab_vs_reference.py --seeds 0 1 2 [--loss cpl|plain] [--band-gain 1.2]
        [--multiseg] [--epochs 10 --tasks 16 --test-tasks 150] [--device cuda:0|cpu]
    python3 scripts/torch_port_ab_vs_reference.py --report [--out PARITY_AB_TORCH.md]

``--report`` folds the port's rows and the recorded ones into tables, one
per (regime, loss family) cell and tie strategy, three arms each, with the
JAX report's statistics (population std over seeds, as the JAX report: with
n = 2-3 seeds it understates the spread, ADVICE.md:5) and its verdict rule
for each pair of arms: the difference of the arm means against twice the
larger seed std. Only accuracies are shown for the recorded arms: their
seconds are TPU and torch-CPU wall times. Runs on ``cuda:0`` unless given
``--device cpu``; with no card it raises. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

RESULTS = REPO / "experiments" / "torch_ab_vs_reference" / "results.jsonl"
RECORDED = REPO / "experiments" / "ab_vs_reference" / "results.jsonl"  # the JAX repo's two arms
REPORT = REPO / "PARITY_AB_TORCH.md"
MODEL_CONFIG = REPO / "configs" / "model_config_fsd2018.json"

N_MELS, N_FRAMES = 128, 157  # the reference's SpecAugment hardcodes 128 mel bins
DATASET_SEED = 77
DEFAULT_BAND_GAIN = 0.45
TIE_STRATEGIES = ("", "min_label", "max_posterior")
ARM = "ours_torch"
ARM_ORDER = ("ours_torch", "ours_jax", "reference_torch")
SECTION = "ab_vs_reference"
PAIRS = (("ours_torch", "reference_torch"), ("ours_jax", "reference_torch"), ("ours_torch", "ours_jax"))


def experiment_dict(epochs: int, tasks: int, test_tasks: int, loss: str = "cpl", multiseg: bool = False) -> dict:
    """The reference experiment_config schema at A/B scale, the JAX
    script's (``experiment_dict``) for the same arguments.

    loss="cpl"    flagship FSD2018-CPL values: Hybrid + attention +
                  SpecAugment 4 views + CPL.
    loss="plain"  the plain-ProtoNet family: no attention, no contrastive
                  term, no SpecAugment views.
    """
    if loss not in ("cpl", "plain"):
        raise ValueError(f"loss {loss!r}: cpl or plain")
    cpl = loss == "cpl"
    return {
        "encoder_name": "Hybrid",
        "dataset_name": "ab_vs_ref",
        "use_attention": cpl,
        "use_contrastive": cpl,
        "input_type": "spec",
        "n_way_train": 5, "n_way_validation": 5, "n_way_test": 5,
        "n_shot_train": 5, "n_shot_validation": 5, "n_shot_test": 5,
        "n_query_train": 5, "n_query_validation": 5, "n_query_test": 5,
        "train_query_augmentations": cpl,
        "validation_query_augmentations": cpl,
        "test_query_augmentations": cpl,
        "lr": 0.0007,
        "num_epochs": epochs,
        "multi_segm": multiseg,
        "tie_strategy": "",  # per-strategy evals loop over TIE_STRATEGIES
        "relation_head": False,
        "n_training_tasks": tasks,
        "n_testing_tasks": test_tasks,
        "device": "cpu",
        "gpu_index": 0,
        # milestones beyond the A/B's epoch budget: a constant learning rate
        "scheduler_milestones": [20, 40, 60],
        "scheduler_gamma": 0.4482,
        "patience": epochs + 1,  # never fires; the best save and reload still run
        "normalize_prototypes": True,
        "project_prototypes": True,
        "specaug_params": {
            "use": cpl, "mask_param": 16, "W": 22,
            "num_mask": 1, "mask_value": 0, "p": 0.282,
        },
        "waveaug_params": {"use": False, "aug_num": 3},
        "experiment_folder": "ab_vs_ref",
        "loss": {
            "l_param": 2.022308 if cpl else 0.0,
            "cpl": {"use": cpl, "m_param": 5, "t_param": 9.2361 if cpl else 1.0},
            "angular": {"use": False, "angle": 0, "prototypes_as_anchors": True},
        },
    }


def ours_dict(epochs: int, tasks: int, test_tasks: int, loss: str, multiseg: bool, seed: int,
              device: torch.device) -> dict:
    """The "ours" arm's config: ``experiment_dict`` on ``device`` with the
    JAX script's ``tpu`` block (E=1, eval E=16, run seed ``seed``)."""
    cfg = experiment_dict(epochs, tasks, test_tasks, loss, multiseg)
    cfg["device"] = "cpu" if device.type == "cpu" else "cuda"
    cfg["gpu_index"] = device.index or 0
    cfg["tpu"] = {"episode_batch": 1, "eval_episode_batch": 16, "mesh_shape": 1, "seed": seed, "num_runs": 1}
    return cfg


def model_dict() -> dict:
    with open(MODEL_CONFIG) as f:
        return json.load(f)


def dataset_dir(band_gain: float, multiseg: bool) -> str:
    """The JAX script's directory name: one per (gain, multi-segment)."""
    name = "ab_vs_ref"
    if band_gain != DEFAULT_BAND_GAIN or multiseg:
        name += f"_g{band_gain:g}" + ("_mseg" if multiseg else "")
    return name


def make_dataset(data_root, band_gain: float = DEFAULT_BAND_GAIN, multiseg: bool = False) -> Path:
    """The JAX script's dataset (16 classes x 12 items of 128x157, split
    6 / 5 / 5, 1-6 segments an item with ``multiseg``, seed 77) under
    ``data_root``."""
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    return make_synthetic_dataset(
        Path(data_root) / dataset_dir(band_gain, multiseg),
        n_classes=16,
        items_per_class=12,
        n_mels=N_MELS,
        n_frames=N_FRAMES,
        multi_segm=multiseg,
        max_segments=6,
        split_fractions=(6, 5, 5),
        seed=DATASET_SEED,
        band_gain=band_gain,
    )


def run_ours_arm(root: Path, seed: int, epochs: int, tasks: int, test_tasks: int, loss: str = "cpl",
                 multiseg: bool = False, device="cuda:0") -> dict:
    """One training run of the port (``ab_vs_reference.py:381-439``): its
    row, with the JAX arm's keys."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.train.experiment import run_single_training
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    device = resolve_device(device)
    cfg = ours_dict(epochs, tasks, test_tasks, loss, multiseg, seed, device)
    exp, mdl = ExperimentConfig.from_dict(cfg), ModelConfig.from_dict(model_dict())
    load = lambda s: MetaAudioDataset(exp, root, s).to_packed_store(device=device)  # noqa: E731
    trainer = Trainer(exp, mdl, load("train"), val_store=load("valid"), test_store=load("test"), device=device)
    steps, batches = [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as results_dir, \
            launches_per_call(Trainer, "train_step", steps), launches_per_call(Trainer, "_eval_episodes", batches):
        log = run_single_training(trainer, results_dir=results_dir, run_idx=0, log_fn=lambda *a: None)
        row = {
            "arm": ARM,
            "loss": loss,
            "seed": seed,
            "best_val_acc": round(float(log["best_val_accuracy"]), 4),
            "backend": device.type,
        }
        if multiseg:
            for tie in TIE_STRATEGIES:
                mean, std = trainer.evaluate(
                    trainer.test_store, n_tasks=test_tasks, n_way=cfg["n_way_test"], k_shot=cfg["n_shot_test"],
                    k_query=cfg["n_query_test"], augment_query=cfg["test_query_augmentations"],
                    multisegment=True, tie_strategy=tie,
                )
                key = tie or "first"
                row[f"test_acc_{key}"] = round(float(mean), 4)
                row[f"test_acc_{key}_task_std"] = round(float(std), 4)
            row["test_acc"] = row["test_acc_max_posterior"]
            row["test_acc_task_std"] = row["test_acc_max_posterior_task_std"]
        else:
            test = trainer.test()
            row["test_acc"] = round(float(test["mean_accuracy"]), 4)
            row["test_acc_task_std"] = round(float(test["accuracy_std"]), 4)
        row["seconds"] = round(time.perf_counter() - t0, 1)
        row["step_ms_median"] = statistics.median(h["step_ms"] for h in log["history"])
    row["launches_per_train_step"] = tally_launches(steps)
    row["launches_per_eval_batch"] = tally_launches(batches)
    row["card"] = card()["nvidia_smi"] if device.type == "cuda" else None
    row["torch"] = torch.__version__
    return row


def append_result(row: dict, epochs: int, tasks: int, test_tasks: int, band_gain: float, multiseg: bool,
                  path: Path = RESULTS) -> dict:
    """``row`` with the protocol's keys (the JAX script's ``append_result``),
    appended to ``path`` as one JSON line and printed."""
    row = {**row, "epochs": epochs, "tasks": tasks, "test_tasks": test_tasks, "band_gain": band_gain,
           "multiseg": multiseg, "dataset_seed": DATASET_SEED}
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

FAMILY_DESC = {
    "cpl": "flagship FSD2018-CPL config (Hybrid + SpecAugment 4v + attention + CPL, 5w5s5q)",
    "plain": "plain-ProtoNet family (Hybrid, no attention, no contrastive term, no SpecAugment views; "
             "configs/fsd2018_plain.json semantics, 5w5s5q)",
}


def read_rows(*paths: Path) -> list:
    rows = []
    for path in paths:
        if Path(path).exists():
            with open(path) as f:
                rows += [json.loads(line) for line in f if line.strip()]
    return rows


def arm_stats(frows: list, acc_key: str = "test_acc") -> dict:
    """Per arm: (mean, population std over seeds, n, mean per-run task std),
    the JAX report's statistics (``_arm_table``)."""
    arms = {}
    for r in frows:
        arms.setdefault(r["arm"], []).append(r)
    out = {}
    for arm, rows in arms.items():
        rows = sorted(rows, key=lambda r: r["seed"])
        accs = [r[acc_key] for r in rows]
        out[arm] = dict(accs=accs, mean=float(np.mean(accs)), std=float(np.std(accs)), n=len(accs),
                        task_std=float(np.mean([r[acc_key + "_task_std"] for r in rows])))
    return out


def pair_verdict(stats: dict, a: str, b: str, frows: list, acc_key: str = "test_acc") -> dict:
    """The JAX report's comparison of two arms: the difference of their
    means against twice the larger seed std, the minimum detectable effect
    (twice the standard error of the difference of means) and the task
    sampling's standard error of one run (over the two arms' rows)."""
    (m0, s0, n0), (m1, s1, n1) = ((stats[x]["mean"], stats[x]["std"], stats[x]["n"]) for x in (a, b))
    rows = [r for r in frows if r["arm"] in (a, b)]
    delta = abs(m0 - m1)
    noise = max(s0, s1, 1e-9)
    sem = float(np.mean([r[acc_key + "_task_std"] for r in rows])) / np.sqrt(rows[0]["test_tasks"])
    mde = 2.0 * float(np.sqrt(s0**2 / max(n0, 1) + s1**2 / max(n1, 1)))
    within = delta <= 2 * noise
    return dict(delta=delta, noise=noise, mde=mde, sem=sem, within=within,
                verdict="WITHIN seed noise" if within else "EXCEEDS 2x seed noise")


def arm_table(lines: list, frows: list, acc_key: str = "test_acc") -> dict:
    """One table of the cell's arms in ``ARM_ORDER`` (the JAX report's rows)
    and a verdict line per pair of arms present; returns the verdicts."""
    stats = arm_stats(frows, acc_key)
    lines += ["| arm | seed accs (test) | mean ± std (seeds) | mean per-run task std |", "|---|---|---|---|"]
    for arm in sorted(stats, key=lambda a: ARM_ORDER.index(a) if a in ARM_ORDER else len(ARM_ORDER)):
        st = stats[arm]
        lines.append(f"| {arm} | {', '.join(f'{a:.3f}' for a in st['accs'])} | "
                     f"{st['mean']:.3f} ± {st['std']:.3f} | {st['task_std']:.3f} |")
    lines.append("")
    verdicts = {}
    for a, b in PAIRS:
        if a in stats and b in stats:
            v = verdicts[f"{a} vs {b}"] = pair_verdict(stats, a, b, frows, acc_key)
            lines += [f"`{a}` vs `{b}`: arm delta {v['delta']:.3f} vs max seed std {v['noise']:.3f} -> "
                      f"**{v['verdict']}**; MDE(95%) ~{v['mde']:.3f} accuracy points "
                      f"(single-run task-sampling SEM ~{v['sem']:.3f}).", ""]
    return verdicts


def report(rows: list) -> tuple:
    """The markdown section and the verdicts by cell."""
    regimes = {}
    for r in rows:
        key = (bool(r.get("multiseg", False)), float(r.get("band_gain", DEFAULT_BAND_GAIN)))
        regimes.setdefault(key, []).append(r)
    port = [r for r in rows if r["arm"] == ARM]
    cards = sorted({r["card"] for r in port if r.get("card")})
    lines = [
        "## vs reference torch (synthetic): the port's arm beside the recorded arms",
        "",
        "Every cell trains on the same on-disk synthetic dataset (16 classes split 6 / 5 / 5, 128x157, "
        "seed 77; difficulty set by band_gain), which the port's `make_synthetic_dataset` writes bit for bit "
        "as the JAX package's. `ours_torch` is the PyTorch/CUDA port on "
        + (", ".join(cards) if cards else "the CPU")
        + " (`scripts/torch_port_ab_vs_reference.py`, rows in `experiments/torch_ab_vs_reference/results.jsonl`); "
        "`ours_jax` (the JAX package on a TPU) and `reference_torch` (the reference code on a CPU) are the rows "
        "recorded in `experiments/ab_vs_reference/results.jsonl` by `scripts/ab_vs_reference.py`; only their "
        "accuracies are shown. The statistics are the JAX report's: seed std is the population std "
        "(ddof 0), which with n = 2-3 seeds understates the spread (ADVICE.md), and a pair of arms is "
        "within noise when the difference of their means is at most twice the larger seed std.",
        "",
    ]
    verdicts = {}
    for mseg, gain in sorted(regimes):
        rrows = regimes[(mseg, gain)]
        families = {}
        for r in rrows:
            families.setdefault(r.get("loss", "cpl"), []).append(r)
        for fam in sorted(families):
            frows = families[fam]
            proto = next((r for r in frows if r["arm"] == ARM), frows[0])
            lines += [
                f"### band_gain {gain:g}, "
                + ("multi-segment (1-6 segs/item, vote eval)" if mseg else "single-segment")
                + f", {proto['epochs']} epochs x {proto['tasks']} tasks, {proto['test_tasks']} test tasks; "
                f"loss family {fam}",
                "",
                f"{FAMILY_DESC.get(fam, fam)}.",
                "",
            ]
            for tie in (TIE_STRATEGIES if mseg else (None,)):
                acc_key = "test_acc" if tie is None else f"test_acc_{tie or 'first'}"
                tie_rows = [r for r in frows if acc_key in r]
                if not tie_rows:
                    continue
                if tie is not None:
                    lines += [f"tie strategy `{tie or '(first occurrence)'}`:", ""]
                cell = f"{'mseg' if mseg else 'single'} g{gain:g} {fam}" + ("" if tie is None else f" {tie or 'first'}")
                verdicts[cell] = arm_table(lines, tie_rows, acc_key)
    return "\n".join(lines), verdicts


def write_section(out: Path, section: str, text: str) -> str:
    """Writes ``text`` into ``out`` between the section's markers, keeping
    the file's other sections (the calibration and the deviations write
    their own)."""
    begin, end = f"<!-- {section}: begin -->", f"<!-- {section}: end -->"
    block = f"{begin}\n{text}\n{end}"
    out = Path(out)
    old = out.read_text() if out.exists() else "# Accuracy A/Bs of the PyTorch/CUDA port (synthetic data)\n"
    if begin in old and end in old:
        new = old[: old.index(begin)] + block + old[old.index(end) + len(end):]
    else:
        new = old.rstrip("\n") + "\n\n" + block + "\n"
    out.write_text(new)
    return text


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--tasks", type=int, default=16)
    ap.add_argument("--test-tasks", type=int, default=150)
    ap.add_argument("--loss", choices=["cpl", "plain"], default="cpl")
    ap.add_argument("--band-gain", type=float, default=DEFAULT_BAND_GAIN)
    ap.add_argument("--multiseg", action="store_true",
                    help="multi-segment dataset + majority-vote eval under all three tie strategies")
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--data-root", help="where the dataset goes (default: a temporary directory)")
    ap.add_argument("--results", default=str(RESULTS), help="the JSONL file rows are appended to")
    ap.add_argument("--recorded", default=str(RECORDED), help="the JAX repo's recorded rows (for --report)")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=str(REPORT))
    args = ap.parse_args(argv)

    if args.report:
        text, _ = report(read_rows(Path(args.results), Path(args.recorded)))
        print(write_section(Path(args.out), SECTION, text))
        return []
    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        root = make_dataset(args.data_root or tmp, args.band_gain, args.multiseg)
        for seed in args.seeds:
            row = run_ours_arm(root, seed, args.epochs, args.tasks, args.test_tasks, args.loss, args.multiseg,
                               device)
            rows.append(append_result(row, args.epochs, args.tasks, args.test_tasks, args.band_gain,
                                      args.multiseg, Path(args.results)))
    return rows


if __name__ == "__main__":
    main()
