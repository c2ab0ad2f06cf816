"""Experiment driver (counterpart of the JAX package's ``train/experiment.py``,
the reference's ``src/train_test.py`` flow).

Per run: a fresh model from the run's seed -> epochs of training, each
followed by validation, early stopping and a best-checkpoint write -> the
best checkpoint reloaded -> ``Trainer.test()``. Beyond the reference: a
resume checkpoint after every epoch (model, optimizer, schedule, generator,
epoch and early-stopping counters), a per-epoch JSONL metrics log (with the
epoch's median train step in ms), an episodes/s counter, and a divergence
guard that stops a run whose loss goes non-finite and keeps a crash
checkpoint of it.

On a mesh of W ranks (``tpu.mesh_shape``, under ``torchrun``) every rank
runs this flow on its own device and rank 0 alone writes ``config.json``,
``model.ckpt``, the resume and crash checkpoints, ``result_run{i}.json`` and
the metrics log, and logs. Early stopping and the divergence guard read
values that are equal on every rank (metrics averaged, accuracies
gathered), so the ranks stop together; every rank reloads the best
checkpoint once rank 0 has written it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import time
from typing import Dict, List, Optional, Union

import torch

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split
from audio_few_shot_learning_tpu_torch.device import config_device
from audio_few_shot_learning_tpu_torch.parallel.mesh import make_mesh
from audio_few_shot_learning_tpu_torch.train import checkpoint as ckpt
from audio_few_shot_learning_tpu_torch.train.early_stopping import EarlyStopping
from audio_few_shot_learning_tpu_torch.train.engine import Trainer
from audio_few_shot_learning_tpu_torch.utils import EpisodeThroughput, MetricsLogger


class TrainingDiverged(RuntimeError):
    """The training loss went non-finite; the run's state is in a crash
    checkpoint."""


def run_single_training(
    trainer: Trainer,
    results_dir: str,
    run_idx: int = 0,
    log_fn=print,
    resume: bool = False,
) -> Dict:
    """Train one model to early stopping; leaves the best weights in
    ``trainer.model`` and returns the training log. On a mesh every rank
    calls it; rank 0 writes and logs."""
    exp = trainer.exp
    main = trainer.mesh.rank == 0
    log_fn = log_fn if main else _quiet
    model_path = os.path.join(results_dir, "model.ckpt")
    resume_path = os.path.join(results_dir, f"resume_run{run_idx}.ckpt")
    metrics_path = os.path.join(results_dir, f"metrics_run{run_idx}.jsonl")
    if main:
        os.makedirs(results_dir, exist_ok=True)

    stopper = EarlyStopping(
        patience=exp.patience,
        verbose=True,
        save_fn=(lambda: ckpt.save_model(model_path, trainer.model)) if main else None,
        trace_func=log_fn,
    )
    start_epoch = 1
    if resume and os.path.exists(resume_path):
        meta = ckpt.load_resume(resume_path, trainer)
        stopper.load_state_dict(meta["early_stopping"])
        start_epoch = meta["epoch"] + 1
        log_fn(f"Resumed run {run_idx} from epoch {meta['epoch']}")

    history: List[Dict] = []
    metrics_log = MetricsLogger(metrics_path if main else None, stdout=False)
    throughput = EpisodeThroughput()
    try:
        for epoch in range(start_epoch, exp.num_epochs + 1):
            if stopper.early_stop:  # a resumed run that had already stopped
                break
            log_fn(f"Epoch: {epoch:03}/{exp.num_epochs:03}")
            train_metrics = trainer.train_epoch()
            eps_per_sec = throughput.update(exp.n_training_tasks, trainer.last_epoch_seconds)
            if not math.isfinite(train_metrics["fsl_loss"]):
                crash = os.path.join(results_dir, f"crash_run{run_idx}.ckpt")
                ckpt.save_resume(crash, trainer, epoch, {"early_stopping": stopper.state_dict()})
                raise TrainingDiverged(
                    f"non-finite loss at epoch {epoch} (metrics={train_metrics}); "
                    f"state saved to {crash}"
                )
            log_fn({k: train_metrics[k] for k in ("loss", "fsl_loss", "cpl_loss")})
            val_acc, val_std = trainer.validate()
            row = {
                "epoch": epoch,
                **train_metrics,
                "val_accuracy": val_acc,
                "val_accuracy_std": val_std,
                "episodes_per_sec": eps_per_sec,
                "step_ms": statistics.median(trainer.last_step_ms),  # the epoch's median train step
            }
            history.append(row)
            metrics_log.log(step=epoch, metrics=row)

            stopper(val_accuracy=val_acc, epoch=epoch)
            ckpt.save_resume(resume_path, trainer, epoch, {"early_stopping": stopper.state_dict()})
            if stopper.early_stop:
                log_fn("Early Stopping.")
                break
    finally:
        metrics_log.close()

    trainer.mesh.barrier()  # rank 0 has written the best checkpoint
    ckpt.load_model(model_path, trainer.model)  # the best checkpoint (loops/loops.py:163-167)
    return {
        "history": history,
        "best_val_accuracy": stopper.val_accuracy_max,
        # smoothed train-step throughput (validation and checkpoints excluded)
        "train_episodes_per_sec": throughput.value,
    }


def run_experiment(
    exp: ExperimentConfig,
    mdl: ModelConfig,
    experiments_root: str = "experiments",
    log_fn=print,
    resume: bool = False,
    num_runs: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> List[Dict]:
    """The reference flow: load the three splits, then ``num_runs`` x (train
    -> test); writes ``config.json`` and ``result_run{i}.json``. On a mesh
    (``tpu.mesh_shape``) every rank calls it and loads the splits onto its
    own device; rank 0 writes and logs."""
    device = config_device(exp, device)
    mesh = make_mesh(exp.tpu.mesh_shape, device)
    main = mesh.rank == 0
    log_fn = log_fn if main else _quiet
    dataset_path = os.path.join(exp.data_root, exp.dataset_name)
    log_fn(f"Loading Dataset:::  {exp.dataset_name}, Device:::  {device}, ranks:::  {mesh.world}")
    train_store = load_packed_split(exp, dataset_path, "train", device)
    val_store = load_packed_split(exp, dataset_path, "valid", device)
    test_store = load_packed_split(exp, dataset_path, "test", device)

    results_dir = os.path.join(experiments_root, exp.experiment_folder)
    if main:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "config.json"), "w") as f:
            json.dump({"experiment": dataclasses.asdict(exp), "model": dataclasses.asdict(mdl)}, f, indent=2)

    runs = exp.tpu.num_runs if num_runs is None else num_runs
    all_results = []
    for i in range(runs):
        log_fn(f"NEW RUN !!! NUMBER OF RUN ::: {i}")
        trainer = Trainer(exp, mdl, train_store, val_store, test_store, seed=exp.tpu.seed + i, mesh=mesh)
        t0 = time.perf_counter()
        train_log = run_single_training(trainer, results_dir, run_idx=i, log_fn=log_fn, resume=resume)
        log_fn("Starting to test")
        msg = trainer.test()
        msg["train_seconds"] = time.perf_counter() - t0
        msg["best_val_accuracy"] = train_log["best_val_accuracy"]
        msg["train_episodes_per_sec"] = train_log["train_episodes_per_sec"]
        log_fn(msg)
        all_results.append(msg)
        if main:
            with open(os.path.join(results_dir, f"result_run{i}.json"), "w") as f:
                json.dump(msg, f, indent=2)
    return all_results


def _quiet(*args, **kwargs) -> None:
    """The log of a rank other than 0."""
