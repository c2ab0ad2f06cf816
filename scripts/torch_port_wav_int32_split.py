#!/usr/bin/env python3
"""A wav split past int32 sample addressing through the PyTorch port, on one card.

    python3 scripts/torch_port_wav_int32_split.py [--root DIR] [--keep]

Writes a seeded dataset in the reference's wav layout whose train split
holds more than 2^31 - 1 samples (40 classes x 112 clips of 30 s at 16 kHz:
2 150 400 000 float32 samples, 8.6 GB of .npy files), then, on the card:
``load_packed_split`` under ``tpu.host_store: null`` (the split is within
the card's memory rule, so only its sample count sends it to the host
store), one host-fed train step (the flagship on wav input, multi-segment,
5-s segments, E=1) and one multi-segment eval batch, with the kernels'
launches. Prints one JSON line. Needs ~9 GB of disk under ``--root``
(default ``build/int32_split``, removed afterwards unless ``--keep``) and
~9 GB of host RAM.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES, PER_CLASS, SECONDS, SR = 40, 112, 30, 16000


def write_dataset(root: str) -> int:
    names = [f"class_{c:03d}" for c in range(N_CLASSES)]

    def write(c):
        rng = np.random.default_rng(c)
        d = os.path.join(root, "waveforms_npy", names[c])
        os.makedirs(d, exist_ok=True)
        for i in range(PER_CLASS):
            np.save(os.path.join(d, f"item_{i:04d}.npy"),
                    0.3 * rng.standard_normal(SECONDS * SR, dtype=np.float32))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(N_CLASSES)))
    os.makedirs(os.path.join(root, "norm_stats"), exist_ok=True)
    np.save(os.path.join(root, "norm_stats", "glob_norm.npy"), np.array([[[20.0]], [[5.0]]], np.float32))
    splits = np.array([np.array(names, dtype=object), np.array(names[:5], dtype=object),
                       np.array(names[:5], dtype=object)], dtype=object)
    np.save(os.path.join(root, "splits.npy"), splits, allow_pickle=True)
    return N_CLASSES * PER_CLASS * SECONDS * SR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(REPO, "build", "int32_split"))
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data import datasets
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    dev = torch.device("cuda:0")
    out = {"card": torch.cuda.get_device_name(0)}
    try:
        t0 = time.perf_counter()
        samples = write_dataset(args.root)
        out.update(samples=samples, max_device_samples=datasets.MAX_DEVICE_SAMPLES,
                   file_gb=samples * 4 / 1e9, write_s=time.perf_counter() - t0)
        exp = ExperimentConfig.from_dict({
            "input_type": "wav", "multi_segm": True, "use_attention": True, "use_contrastive": True,
            "specaug_params": {"use": False}, "waveaug_params": {"use": False}, "lr": 7e-4,
            "n_training_tasks": 1, "n_testing_tasks": 1, "test_query_augmentations": True,
            "loss": {"l_param": 2.022308, "cpl": {"use": True, "m_param": 5, "t_param": 9.2361}},
            "tpu": {"episode_batch": 1, "eval_episode_batch": 1, "compute_dtype": "bfloat16"},
        })
        t0 = time.perf_counter()
        store = datasets.load_packed_split(exp, args.root, "train", dev)
        out.update(load_s=time.perf_counter() - t0, store=type(store).__name__,
                   store_gb=store.nbytes() / 1e9, store_samples=store.n_samples, s_max=store.s_max,
                   card_memory_gb=torch.cuda.get_device_properties(dev).total_memory / 1e9,
                   estimated_gb=datasets.MetaAudioDataset(exp, args.root, "train").estimated_packed_bytes() / 1e9)
        if not isinstance(store, WavHostStore):
            raise AssertionError(f"the split loaded as {type(store).__name__}, not a WavHostStore")
        trainer = Trainer(exp, ModelConfig(), store, test_store=store, device=dev, seed=0)
        kernels = (specaugment.views_cuda, protohead.episode_scores_cuda, mel.mel_log_cuda)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train_epoch()
        out.update(train_step_s=time.perf_counter() - t0, train=metrics,
                   train_launches=[k.launches for k in kernels])
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        acc = trainer.test()
        out.update(eval_batch_s=time.perf_counter() - t0, test=acc, eval_launches=[k.launches for k in kernels],
                   eval_batch=trainer.last_eval_batch, h2d_bytes=trainer.stager.h2d_bytes)
        if not (np.isfinite(metrics["loss"]) and 0.0 <= acc["mean_accuracy"] <= 1.0):
            raise AssertionError(f"non-finite results: {out}")
    finally:
        if not args.keep:
            shutil.rmtree(args.root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
