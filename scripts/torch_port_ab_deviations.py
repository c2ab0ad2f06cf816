#!/usr/bin/env python3
"""Paired accuracy bounds of the three documented deviations in the
PyTorch/CUDA port: the port's counterpart of ``scripts/ab_deviations.py``.

(a) BatchNorm's batch statistics: the fused E*V*(S+Q) batch (the default)
    against one group per (episode, view, support|query), the reference's
    per-view loop (``tpu.bn_per_view_group``);
(b) pitch shift: the clip/zero-pad resample (the default) against the
    duration-preserving phase vocoder (``waveaug_params.pitchshift_mode:
    "pv"``);
(c) low-pass: the reference's chain order (its own FFT pair, noise added
    after it) against ``waveaug_params.fuse_lowpass`` (the low-pass joins the
    shared noise / high-pass / band-stop spectrum, so added noise is
    low-passed too).

The two arms of a seed start from the same parameters (the model is made
from the run's seed), draw the same episodes, views and dropout masks from
one generator seeded alike, and are evaluated on the same episodes: only the
knob differs, so the per-seed differences are paired. A deviation is within
noise when the mean paired difference is at most its minimum detectable
effect, twice the standard error of the differences (the JAX script's
``summarize``).

    python3 scripts/torch_port_ab_deviations.py [--seeds 5] [--epochs 10] [--experiment bn|pitch|lowpass|all]
        [--light] [--device cuda:0|cpu] [--out PARITY_AB_TORCH.md] [--json FILE] [--cache FILE]

The datasets are the JAX script's (``make_synthetic_dataset`` /
``make_synthetic_wav_dataset``, the same arguments and seeds) in a
temporary directory. Finished runs are appended to ``--cache`` (default
``build/torch_ab_deviations_cache.jsonl``), keyed on experiment, arm, seed,
epochs, scale, depth and device type, so a killed run resumes.
``--tasks`` / ``--test-tasks`` cut the depth. The section goes into
``--out`` between its markers; ``--json`` writes the summary and every run.
Runs on ``cuda:0`` unless given ``--device cpu``; with no card it raises.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

_spec = importlib.util.spec_from_file_location("torch_port_ab_vs_reference",
                                               REPO / "scripts" / "torch_port_ab_vs_reference.py")
ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab)

CACHE = REPO / "build" / "torch_ab_deviations_cache.jsonl"
SECTION = "ab_deviations"


def spec_dicts(seed: int, bn_grouped: bool, epochs: int, light: bool = False):
    """(experiment dict, model dict) of the BatchNorm A/B (the JAX
    ``build_spec_exp``): the flagship structure at full scale, a CNN without
    attention or CPL at light scale (48x60 features)."""
    exp = {
        "dataset_name": "ab_spec",
        "encoder_name": "CNN" if light else "Hybrid",
        "use_attention": not light, "use_contrastive": not light,
        "n_way_train": 5, "n_way_validation": 4, "n_way_test": 4,
        "n_shot_train": 5, "n_shot_validation": 5, "n_shot_test": 5,
        "n_query_train": 5, "n_query_validation": 5, "n_query_test": 5,
        "n_training_tasks": 10 if light else 20, "n_testing_tasks": 200,
        "lr": 1e-3, "num_epochs": epochs, "patience": epochs + 1,
        "train_query_augmentations": True,
        "specaug_params": {"use": True, "mask_param": 10, "W": 10, "num_mask": 1, "mask_value": 0.0, "p": 0.3},
        "loss": {"l_param": 1.0, "cpl": {"use": not light, "m_param": 3, "t_param": 6.0}},
        "tpu": {"episode_batch": 1, "eval_episode_batch": 8, "mesh_shape": 1,
                "seed": seed, "num_runs": 1, "bn_per_view_group": bn_grouped},
    }
    mdl = ({"CNN": {"pool_dim": [2, 2], "hidden_channels": 32, "out_dim": 48},
            "Projection": {"input_dim": 48, "hidden_dim": 48, "output_dim": 48}} if light else {})
    return exp, mdl


WAV_MODEL = {"CNN": {"pool_dim": [2, 2], "hidden_channels": 16, "out_dim": 32},
             "Projection": {"input_dim": 32, "hidden_dim": 32, "output_dim": 32}}


def _wav_dict(seed: int, epochs: int, light: bool, waveaug: dict) -> dict:
    return {
        "dataset_name": "ab_wav",
        "encoder_name": "CNN", "use_attention": False, "use_contrastive": False,
        "input_type": "wav",
        "n_way_train": 4, "n_way_validation": 3, "n_way_test": 3,
        "n_shot_train": 3, "n_shot_validation": 3, "n_shot_test": 3,
        "n_query_train": 3, "n_query_validation": 3, "n_query_test": 3,
        "n_training_tasks": 10 if light else 20, "n_testing_tasks": 200,
        "lr": 2e-3, "num_epochs": epochs, "patience": epochs + 1,
        "train_query_augmentations": False,
        "specaug_params": {"use": False},
        "waveaug_params": waveaug,
        "tpu": {"episode_batch": 1, "eval_episode_batch": 4, "mesh_shape": 1, "seed": seed, "num_runs": 1},
    }


def wav_dicts(seed: int, pv: bool, epochs: int, light: bool = False):
    """The pitch-shift A/B (the JAX ``build_wav_exp``): pitch shift dominant
    (p 0.8, +-3 semitones) with a light rest of the chain."""
    return _wav_dict(seed, epochs, light, {
        "use": True, "aug_num": 2,
        "pitchshift_mode": "pv" if pv else "resample",
        "pitchshift_p": 0.8,
        "pitchshift_min_transpose_semitones": -3,
        "pitchshift_max_transpose_semitones": 3,
        "min_gain_in_db": -4, "max_gain_in_db": 4, "gain_p": 0.3,
        "min_snr_in_db": 15, "max_snr_in_db": 25,
        "noise_min_f_decay": -1, "noise_max_f_decay": 1, "noise_p": 0.3,
        "lowpass_p": 0.0, "highpass_p": 0.0, "bandstop_p": 0.0,
        "shift_p": 0.3, "shift_min_shift": -0.2, "shift_max_shift": 0.2,
        "timeinversion_p": 0, "spliceout_p": 0, "timestretch_p": 0,
        "timemasking_p": 0,
    }), dict(WAV_MODEL)


def lowpass_dicts(seed: int, fused: bool, epochs: int, light: bool = False):
    """The low-pass A/B (the JAX ``build_lowpass_exp``): low-pass and the
    noise group often on together (p 0.6 each), where the order matters."""
    return _wav_dict(seed, epochs, light, {
        "use": True, "aug_num": 2,
        "fuse_lowpass": fused,
        "lowpass_p": 0.6,
        "min_snr_in_db": 10, "max_snr_in_db": 20,
        "noise_min_f_decay": -1, "noise_max_f_decay": 1, "noise_p": 0.6,
        "highpass_p": 0.3, "bandstop_p": 0.3,
        "min_gain_in_db": -4, "max_gain_in_db": 4, "gain_p": 0.3,
        "pitchshift_p": 0.0, "shift_p": 0.0, "timeinversion_p": 0,
        "spliceout_p": 0, "timestretch_p": 0, "timemasking_p": 0,
    }), dict(WAV_MODEL)


# experiment -> (its dicts' function, its two arms as (name, knob), section title)
EXPERIMENTS = {
    "bn": (spec_dicts, (("bn_fused", False), ("bn_per_view_group", True)),
           "BatchNorm stats: fused batch vs per-(episode,view,support|query) groups "
           "(PARITY.md deviation; reference main_modules.py:18-23)"),
    "pitch": (wav_dicts, (("ps_resample", False), ("ps_pv", True)),
              "Pitch shift: clip/zero-pad resample vs duration-preserving phase vocoder "
              "(PARITY.md deviation; torch_audiomentations PitchShift semantics)"),
    "lowpass": (lowpass_dicts, (("lp_reference_order", False), ("lp_fused", True)),
                "LowPass fusion: reference chain order (own FFT pair, noise added after lowpass) vs "
                "`waveaug_params.fuse_lowpass` (lowpass joins the shared spectrum group)"),
}


def make_dataset(experiment: str, data_root, light: bool = False) -> Path:
    """The JAX script's dataset of ``experiment`` under ``data_root``."""
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset, make_synthetic_wav_dataset

    if experiment == "bn":
        return make_synthetic_dataset(
            Path(data_root) / "ab_spec", n_classes=14, items_per_class=12,
            n_mels=48 if light else 128, n_frames=60 if light else 157,
            split_fractions=(6, 4, 4), seed=100,
            band_gain=0.55,  # mid-range: the default 4.0 saturates at 0.94-0.97
        )
    name, seed = ("ab_wav", 200) if experiment == "pitch" else ("ab_wav_lp", 300)
    return make_synthetic_wav_dataset(Path(data_root) / name, n_classes=10, items_per_class=10, seconds=1.0,
                                      split_fractions=(4, 3, 3), seed=seed)


def arm_configs(experiment: str, seed: int, knob: bool, epochs: int, light: bool, device: torch.device,
                tasks: Optional[int] = None, test_tasks: Optional[int] = None):
    """(ExperimentConfig, ModelConfig) of one arm on ``device``, its depth
    cut by ``tasks`` / ``test_tasks``."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig

    exp, mdl = EXPERIMENTS[experiment][0](seed, knob, epochs, light)
    if device.type == "cpu":
        exp["device"] = "cpu"
    if tasks is not None:
        exp["n_training_tasks"] = tasks
    if test_tasks is not None:
        exp["n_testing_tasks"] = test_tasks
    return ExperimentConfig.from_dict(exp), ModelConfig.from_dict(mdl)


def cache_key(experiment: str, arm: str, seed: int, epochs: int, light: bool, device: torch.device,
              tasks: Optional[int], test_tasks: Optional[int]) -> str:
    depth = "" if tasks is None and test_tasks is None else f"/t{tasks}-{test_tasks}"
    return f"{experiment}/{arm}/seed{seed}/ep{epochs}/{'light' if light else 'full'}{depth}/{device.type}"


def cache_load(path: Path) -> dict:
    if not path.exists():
        return {}
    with open(path) as f:
        return {row["key"]: row["result"] for row in map(json.loads, f)}


def make_trainer(exp, mdl, root, device):
    from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    load = lambda s: MetaAudioDataset(exp, root, s).to_packed_store(device=device)  # noqa: E731
    return Trainer(exp, mdl, load("train"), load("valid"), load("test"), device=device)


def run_arm(exp, mdl, root, device, key=None, cache=None, cache_path: Path = CACHE) -> dict:
    """Train one arm ``num_epochs`` epochs, then validate and test; a run
    finished before (``key`` in ``cache``) is read from the cache."""
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    if cache is not None and key in cache:
        return {**cache[key], "cached": True}
    tr = make_trainer(exp, mdl, root, device)
    steps, batches = [], []
    t0 = time.perf_counter()
    with launches_per_call(Trainer, "train_step", steps), launches_per_call(Trainer, "_eval_episodes", batches):
        for _ in range(exp.num_epochs):
            tr.train_epoch()
        val_mean, _ = tr.validate()
        test = tr.test()
    result = {
        "val_acc": round(float(val_mean), 4),
        "test_acc": round(float(test["mean_accuracy"]), 4),
        "train_seconds": round(time.perf_counter() - t0, 1),
        "launches_per_train_step": tally_launches(steps),
        "launches_per_eval_batch": tally_launches(batches),
    }
    if key is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        with open(cache_path, "a") as f:
            f.write(json.dumps({"key": key, "result": result}) + "\n")
    return result


def summarize(name: str, arm_names, results: dict, out_lines: list) -> dict:
    """The JAX script's paired analysis: per-seed differences of the two
    arms, their mean, sample std and minimum detectable effect 2 std /
    sqrt(n); within noise when |mean| <= that effect."""
    line = [f"### {name}", "", "| arm | seed accs (test) | mean ± std |", "|---|---|---|"]
    for arm in arm_names:
        accs = [r["test_acc"] for r in results[arm]]
        line.append(f"| {arm} | {', '.join(f'{a:.3f}' for a in accs)} | "
                    f"{float(np.mean(accs)):.3f} ± {float(np.std(accs)):.3f} |")
    a0, a1 = arm_names
    deltas = np.array([r0["test_acc"] - r1["test_acc"] for r0, r1 in zip(results[a0], results[a1])])
    n = len(deltas)
    d_mean = float(np.mean(deltas))
    d_std = float(np.std(deltas, ddof=1)) if n > 1 else float("nan")
    mde = 2.0 * d_std / np.sqrt(n) if n > 1 else float("nan")
    verdict = "WITHIN paired noise" if abs(d_mean) <= mde else "EXCEEDS paired noise (2 SEM)"
    line += [
        "",
        f"Paired per-seed deltas ({a0} − {a1}): {', '.join(f'{d:+.3f}' for d in deltas)} → mean {d_mean:+.4f}, "
        f"std {d_std:.4f}, minimum detectable effect (2·SEM) {mde:.4f} -> **{verdict}**.",
        "",
    ]
    out_lines += line
    return {
        "paired_delta_mean": round(d_mean, 4),
        "paired_delta_std": round(d_std, 4) if d_std == d_std else None,
        "min_detectable_effect": round(mde, 4) if mde == mde else None,
        "n_seeds": n,
        "verdict": verdict,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--experiment", choices=["bn", "pitch", "lowpass", "all"], default="all")
    ap.add_argument("--light", action="store_true",
                    help="the CPU-feasible scale: CNN encoder, 48x60 features, 10 tasks an epoch")
    ap.add_argument("--tasks", type=int, help="train (and validation) tasks an epoch (default: the experiment's)")
    ap.add_argument("--test-tasks", type=int, help="test tasks (default: the experiment's 200)")
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--cache", default=str(CACHE))
    ap.add_argument("--out", default=str(ab.REPORT))
    ap.add_argument("--json", help="write the summary and every run's result to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    cache_path = Path(args.cache)
    cache = cache_load(cache_path)
    if cache:
        print(f"resuming: {len(cache)} finished runs in {cache_path}", flush=True)
    card_name = card()["nvidia_smi"] if device.type == "cuda" else "the CPU"
    stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
    out_lines = [
        "## Deviation A/B bounds of the port",
        "",
        f"Generated by `scripts/torch_port_ab_deviations.py` on {card_name}, torch {torch.__version__}: "
        f"{args.seeds} seeds x {args.epochs} epochs{' (light scale)' if args.light else ''}, {stamp}. "
        "The two arms of a seed start from the same parameters and draw the same episodes, views and eval "
        "episodes from one generator seeded alike (only the knob differs), so per-seed deltas are paired. "
        "The JAX package's bounds, from the JAX script on a TPU, are in PARITY_AB.md.",
        "",
    ]
    summary, runs = {}, {}
    names = list(EXPERIMENTS) if args.experiment == "all" else [args.experiment]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            _, arms, title = EXPERIMENTS[name]
            root = make_dataset(name, tmp, args.light)
            results = {arm: [] for arm, _ in arms}
            for seed in range(args.seeds):
                for arm, knob in arms:
                    exp, mdl = arm_configs(name, seed, knob, args.epochs, args.light, device, args.tasks,
                                           args.test_tasks)
                    key = cache_key(name, arm, seed, args.epochs, args.light, device, args.tasks, args.test_tasks)
                    r = run_arm(exp, mdl, root, device, key, cache, cache_path)
                    results[arm].append(r)
                    print(f"[{name}] seed={seed} arm={arm}: {r}", flush=True)
            summary[name] = summarize(title, [a for a, _ in arms], results, out_lines)
            runs[name] = results
    ab.write_section(Path(args.out), SECTION, "\n".join(out_lines).rstrip("\n"))
    out = {"summary": summary, "runs": runs, "card": card_name, "torch": torch.__version__,
           "seeds": args.seeds, "epochs": args.epochs, "light": args.light, "device": device.type}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(summary, indent=2))
    return out


if __name__ == "__main__":
    main()
