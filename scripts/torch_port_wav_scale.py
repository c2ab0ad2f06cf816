#!/usr/bin/env python3
"""BirdClef-scale raw-audio training through the PyTorch port, on one card:
the port's counterpart of ``scripts/wav_scale_stress.py``.

    python3 scripts/torch_port_wav_scale.py [--items 65000] [--classes 120] [--scale 1.0]
        [--dtype f16|f32] [--steps 12] [--episode-batch 4] [--eval-tasks 3] [--pack-only]
        [--device cuda:0|cpu] [--out FILE]

Builds the JAX script's synthetic split in host RAM: 65 000 items with
lognormal durations of 1-180 s (median 18 s) at 16 kHz, labels over 120
classes, the samples a tiled noise bank with a phase per item, the same
generator and seed, bit for bit. It goes straight into the port's
``WavHostStore`` layout: one buffer holding every item's samples, then one
5-s tail row per item shorter than a segment; no list of per-item arrays
is made. At ``--scale 1.0`` and ``--dtype f16`` that is ~61 GB of host RAM
(``--scale`` shrinks the durations; 5-s segments stay, so s_max is 36 only
at 1.0).

Then, on the card, the JAX script's experiment (the flagship Hybrid on wav
input, attention, CPL, WaveAugment on at its probabilities, multi-segment
with ``max_posterior`` ties, 5-way 5-shot 5-query, E = ``--episode-batch``)
through ``Trainer`` in host mode: two train epochs of ``--steps`` steps
(asserting ``host_mode``, ``is_wav`` and a finite loss), the transfer floor
of the same per-step payload (the bytes the staging copied per step, as
one pinned host-to-device copy timed with CUDA events), and multi-segment
``evaluate`` at the store's s_max over ``--eval-tasks`` tasks. Asserts K1 0
/ K2 1 / K3 1 launches per train step and per eval batch (0 / 0 / 0 on the
CPU, where the wrappers run their plain versions). ``--pack-only`` builds
the store and times the host's episode assembly, as the JAX script's.

Prints one JSON line: the JAX script's keys plus the card's name and power
limit, the launches, the device peaks, the peak RSS, the staging bytes and
the store class (``--out`` also writes it to a file). Runs on ``cuda:0``
unless given ``--device cpu``; with no card it raises. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from audio_few_shot_learning_tpu_torch.utils.profiling import card, rss_gb  # noqa: E402

SR = 16000
SEG_SECONDS = 5
BANK = 1_000_003
MODEL_CONFIG: dict = {}  # the flagship's widths (ModelConfig's defaults), as the JAX script
WAV_LAUNCHES = [0, 1, 1]  # K1 (SpecAugment views), K2 (episode scores), K3 (mel + log) per call
FLOOR_REPS = 8



def birdclef_lengths(n_items: int, scale: float, rng: np.random.Generator) -> np.ndarray:
    """Long-tail duration draw: lognormal with median ~18 s clipped to
    [1 s, 180 s], in samples (the JAX script's draw)."""
    secs = np.clip(rng.lognormal(mean=np.log(18.0), sigma=1.0, size=n_items), 1.0, 180.0)
    return np.maximum((secs * scale * SR).astype(np.int64), SR // 4)


def tile_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[:] = np.resize(src, len(dst))`` (``src`` repeated cyclically)
    without a temporary: one copy of ``src``, then the filled prefix doubled."""
    n = min(len(src), len(dst))
    dst[:n] = src[:n]
    while n < len(dst):
        m = min(n, len(dst) - n)
        dst[n : n + m] = dst[:m]
        n += m


def build_store(n_items: int, n_classes: int, scale: float, dtype: str):
    """The JAX script's store (``build_store``) in the port's layout: the
    same draws from ``default_rng(0)`` (lengths, labels, then the noise
    bank), item i the bank from phase ``(i * 7919) % len(bank)`` tiled to its
    length, a short item's tail row its samples tiled to a segment. Returns
    (``WavHostStore``, seconds from the buffer's allocation on)."""
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore

    rng = np.random.default_rng(0)
    lengths = birdclef_lengths(n_items, scale, rng)
    labels = rng.integers(0, n_classes, size=n_items).astype(np.int32)
    np_dtype = np.float16 if dtype == "f16" else np.float32
    seg_len = SEG_SECONDS * SR

    offsets = np.zeros(n_items, np.int64)
    offsets[1:] = np.cumsum(lengths)[:-1]
    total = int(lengths.sum())
    n_samples = max(total, seg_len)
    short = lengths < seg_len
    tail_index = np.where(short, np.cumsum(short) - 1, 0).astype(np.int64)
    n_tails = max(int(short.sum()), 1)
    t0 = time.perf_counter()
    buffer = torch.empty(n_samples + n_tails * seg_len, dtype=torch.float16 if dtype == "f16" else torch.float32)
    buf = buffer.numpy()
    # tiled noise bank with a varying phase per item: fills at memcpy speed
    bank = rng.standard_normal(BANK).astype(np_dtype)
    for i in range(n_items):
        off = int(offsets[i])
        tile_into(buf[off : off + int(lengths[i])], bank[(i * 7919) % len(bank) :])
    buf[total:n_samples] = 0
    tails = buf[n_samples:].reshape(n_tails, seg_len)
    tails[0] = 0  # the placeholder row when no item is short
    for i in np.nonzero(short)[0]:
        off = int(offsets[i])
        tile_into(tails[tail_index[i]], buf[off : off + int(lengths[i])])
    seg_counts = np.maximum(-(-lengths // seg_len), 1).astype(np.int32)
    store = WavHostStore(buffer, n_samples, offsets, lengths, tail_index, seg_counts, seg_len, labels, n_classes)
    return store, time.perf_counter() - t0


def experiment(episode_batch: int, steps: int, eval_tasks: int, device: torch.device):
    """The JAX script's experiment config, field for field (plus the
    device)."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    cfg = {
        "encoder_name": "Hybrid",
        "dataset_name": "birdclef_stress",
        "input_type": "wav",
        "use_attention": True,
        "use_contrastive": True,
        "multi_segm": True,
        "tie_strategy": "max_posterior",
        "n_way_train": 5, "n_way_validation": 5, "n_way_test": 5,
        "n_shot_train": 5, "n_shot_validation": 5, "n_shot_test": 5,
        "n_query_train": 5, "n_query_validation": 5, "n_query_test": 5,
        "train_query_augmentations": True,
        "validation_query_augmentations": True,
        "test_query_augmentations": True,
        "lr": 1e-3, "num_epochs": 1,
        "n_training_tasks": episode_batch * steps,
        "n_testing_tasks": eval_tasks,
        "scheduler_milestones": [100], "scheduler_gamma": 0.5, "patience": 5,
        "specaug_params": {"use": False},
        "waveaug_params": {
            "use": True, "aug_num": 3, "gain_p": 0.5, "gain_min_db": -6,
            "gain_max_db": 6, "gaussiannoise_p": 0.5,
            "gaussiannoise_min_amp": 0.001, "gaussiannoise_max_amp": 0.015,
            "pitchshift_p": 0.2, "timestretch_p": 0.2,
            "timemasking_masks": 3, "timemasking_mask_fraction": 0.05,
            "timemasking_p": 0.3,
        },
        "loss": {"l_param": 0.5, "cpl": {"use": True, "m_param": 4, "t_param": 9.0},
                 "angular": {"use": False, "angle": 0, "prototypes_as_anchors": True}},
        "tpu": {"episode_batch": episode_batch, "eval_episode_batch": 4, "mesh_shape": 1},
    }
    if device.type == "cpu":
        cfg["device"] = "cpu"
    return ExperimentConfig.from_dict(cfg)


def transfer_floor(nbytes: int, device: torch.device, reps: int = FLOOR_REPS) -> float:
    """Copies a second of ``nbytes`` from pinned host memory to the card,
    ``reps`` back to back between two CUDA events (one warm copy first)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst.copy_(host, non_blocking=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return reps / (start.elapsed_time(end) / 1e3)


def check_launches(what: str, tally: dict, cuda: bool) -> None:
    want = {" ".join(map(str, WAV_LAUNCHES if cuda else [0, 0, 0]))}
    if set(tally) != want:
        raise AssertionError(f"launches per {what} {tally}; expected {want}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=65000)
    ap.add_argument("--classes", type=int, default=120)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dtype", choices=["f16", "f32"], default="f16")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--episode-batch", type=int, default=4)
    ap.add_argument("--eval-tasks", type=int, default=3)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--pack-only", action="store_true",
                    help="build + size the ragged store and time the host's episode assembly, "
                         "skip training and eval")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import (
        kernel_counters, launches_per_call, tally_launches)

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialized
    rss_start = rss_gb()
    store, pack_s = build_store(args.items, args.classes, args.scale, args.dtype)
    out = {
        "items": args.items,
        "scale": args.scale,
        "dtype": args.dtype,
        "store_gb": round(store.nbytes() / 1e9, 2),
        "s_max": store.s_max,
        "pack_seconds": round(pack_s, 1),
        "store": type(store).__name__,
        "store_samples": store.n_samples,
        "device": str(device),
        "card": card() if cuda else None,
        "torch": torch.__version__,
        "rss_at_start_gb": round(rss_start, 2),
        "peak_rss_gb_after_pack": round(rss_gb(), 2),
    }

    if args.pack_only:
        rng = np.random.default_rng(1)
        t0 = time.perf_counter()
        n_asm = 6
        for _ in range(n_asm):
            eb = store.sample_episode_batch(rng, n_way=5, k_support=5, k_query=5, batch=args.episode_batch)
        out["host_assembly_ms_per_step"] = round((time.perf_counter() - t0) / n_asm * 1e3, 1)
        out["episode_batch"] = args.episode_batch
        out["support_shape"] = list(eb.support.shape)
        out["query_shape"] = list(eb.query.shape)
        out["peak_rss_gb"] = round(rss_gb(), 2)
        return emit(out, args.out)

    exp = experiment(args.episode_batch, args.steps, args.eval_tasks, device)
    trainer = Trainer(exp, ModelConfig.from_dict(MODEL_CONFIG), store, val_store=store, test_store=store,
                      device=device, seed=0)
    if not (trainer.host_mode and trainer.is_wav):
        raise AssertionError(f"host_mode {trainer.host_mode}, is_wav {trainer.is_wav}: expected both")
    counters = kernel_counters()
    for k in counters:
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    steps = []
    with launches_per_call(Trainer, "train_step", steps):
        m = trainer.train_epoch()  # first plans + stream
        m2 = trainer.train_epoch()
    out["train_launches"] = [k.launches for k in counters]
    out["launches_per_train_step"] = tally_launches(steps)
    out["train_eps_per_sec"] = round(max(m["episodes_per_sec"], m2["episodes_per_sec"]), 2)
    out["train_eps_per_sec_epochs"] = [m["episodes_per_sec"], m2["episodes_per_sec"]]
    out["train_ms_per_step_median"] = float(np.median(trainer.last_step_ms))
    out["loss"] = m2["loss"]
    out["loss_finite"] = bool(np.isfinite(m2["loss"]))
    out["train_peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    step_bytes = trainer.stager.h2d_bytes // max(len(steps), 1)
    out["staging_bytes_per_step"] = step_bytes
    out["staging_bytes_train"] = trainer.stager.h2d_bytes
    check_launches("train step", out["launches_per_train_step"], cuda)
    if not out["loss_finite"]:
        raise AssertionError(f"train loss {m2['loss']}")

    if cuda:  # the link's floor for the same per-step payload
        floor = transfer_floor(step_bytes, device)
        out["raw_device_put_floor_steps_per_sec"] = round(floor, 2)  # the JAX script's key
        out["raw_floor_eps_per_sec"] = round(floor * args.episode_batch, 2)
        out["transfer_floor_gbps"] = step_bytes * floor / 1e9
    else:
        out["raw_device_put_floor_steps_per_sec"] = out["raw_floor_eps_per_sec"] = None  # not measured

    # the real BirdClef eval geometry: all segments of every test query,
    # padded to s_max, majority vote on the card
    for k in counters:
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    staged = trainer.stager.h2d_bytes
    batches = []
    t0 = time.perf_counter()
    with launches_per_call(Trainer, "_eval_episodes", batches):
        mean, _ = trainer.evaluate(store, n_tasks=args.eval_tasks, n_way=5, k_shot=5, k_query=5,
                                   augment_query=True, multisegment=True, tie_strategy="max_posterior")
    out["eval_smax_tasks_per_sec"] = round(args.eval_tasks / (time.perf_counter() - t0), 3)
    out["eval_acc_sane"] = bool(0.0 <= mean <= 1.0)
    out["eval_accuracy"] = mean
    out["eval_batch"] = trainer.last_eval_batch
    out["eval_launches"] = [k.launches for k in counters]
    out["launches_per_eval_batch"] = tally_launches(batches)
    out["staging_bytes_eval"] = trainer.stager.h2d_bytes - staged
    out["eval_peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    out["backend"] = device.type
    out["peak_rss_gb"] = round(rss_gb(), 2)
    check_launches("eval batch", out["launches_per_eval_batch"], cuda)
    if not out["eval_acc_sane"]:
        raise AssertionError(f"eval accuracy {mean}")
    return emit(out, args.out)


def emit(out: dict, path=None) -> dict:
    line = json.dumps(out)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
