#!/usr/bin/env python3
"""NSynth-scale data substrate through the PyTorch port, on one card: the
port's counterpart of ``scripts/stress_nsynth_scale.py``.

    python3 scripts/torch_port_nsynth_scale.py [--items 306000] [--classes 1006]
        [--mels 128] [--frames 126] [--root DIR] [--keep] [--skip-gen]
        [--device cuda:0|cpu] [--out FILE]

Writes the JAX script's synthetic split (NSynth's 306 000 items in 1 006
long-tail classes at 128x126, the same generator and seed, the same files
bit for bit; ~19.7 GB of float32 ``.npy`` under ``--root``, default
``build/nsynth_scale``, removed afterwards unless ``--keep``), then:

* scans it (``MetaAudioDataset``) and packs it with the port's native
  packer into a bfloat16 host store (~9.9 GB of host RAM): scan and pack
  seconds, peak RSS and RSS before the pack, the store's size, the class
  table's ``m_max`` and skew, and the seconds of the pack's header probe
  (one native call, which also sizes the split for the placement rule);
* moves it to the card as a ``PackedStore`` and times the device sampler
  (``sample_episode_batch``, batch 8, 5-way 5-shot 5-query; best of 12
  rounds of 10 calls, CUDA-synchronised) against a small control store
  (12 classes x 15 items): ``sampling_flat`` is the JAX script's rule, big
  < 5 x small + 5 ms;
* times ``HostStore.sample_episode_batch`` on the same arrays (ms per 8
  episodes, GB/s, batch MB), as the JAX script's host arm;
* trains and tests the shipped config at its full width on the split
  (``configs/nsynth_cpl.json`` + ``configs/model_config_nsynth.json``, the
  split stored in bfloat16 as above), cut in depth only to one epoch of 32
  tasks at the config's E (1) and a 64-task test at E=16 on the same split
  (its validation and test splits hold one class), through
  ``load_packed_split`` twice: under ``tpu.host_store: null`` (the port's
  rule: the split goes to the card) and ``true`` (the JAX package's
  placement at this scale). Each arm asserts K1 2 / K2 1 / K3 0 launches
  per train step and per eval batch (0 / 0 / 0 on the CPU, where the
  wrappers run their plain versions), a finite loss and an accuracy in
  [0, 1], and records train ms a step, eval episodes/s and the device peak.

Prints one JSON line: the JAX script's keys plus the card's name and power
limit, the launches, the device peaks, the peak RSS and the store class of
each arm (``--out`` also writes it to a file). Runs on ``cuda:0`` unless
given ``--device cpu``; with no card it raises. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from audio_few_shot_learning_tpu_torch.utils.profiling import card, rss_gb  # noqa: E402

EXPERIMENT_CONFIG = REPO / "configs" / "nsynth_cpl.json"
MODEL_CONFIG = REPO / "configs" / "model_config_nsynth.json"
DEFAULT_ROOT = REPO / "build" / "nsynth_scale"
TRAIN_TASKS, TEST_TASKS, TEST_BATCH = 32, 64, 16
SAMPLING_WARM, SAMPLING_ROUNDS, SAMPLING_CALLS = 10, 12, 10
HOST_WARM = 5
WRITE_THREADS = 8
SPEC_LAUNCHES = [2, 1, 0]  # K1 (SpecAugment views), K2 (episode scores), K3 (mel + log) per call



def long_tail_counts(rng, n_classes: int, total: int, min_count: int = 20) -> np.ndarray:
    """NSynth-like skewed class sizes: Zipf-weighted, clipped, scaled to sum
    (the JAX script's draw, call for call)."""
    w = 1.0 / np.arange(1, n_classes + 1) ** 0.9
    rng.shuffle(w)
    counts = np.maximum(min_count, (w / w.sum() * total).astype(np.int64))
    # trim/pad deterministically to hit the exact total
    diff = int(total - counts.sum())
    order = np.argsort(-counts)
    i = 0
    while diff != 0:
        c = order[i % n_classes]
        step = 1 if diff > 0 else -1
        if counts[c] + step >= min_count:
            counts[c] += step
            diff -= step
        i += 1
    return counts


def _npy_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def generate(root: Path, n_classes: int, total: int, n_mels: int, n_frames: int, seed: int,
             threads: int = WRITE_THREADS):
    """The JAX script's split under ``root``, file for file: per class one
    base drawn in class order from one Generator, item ``ii`` the base plus
    ``0.01 * (ii % 97)``. The 97 payloads of a class are serialised once and
    the classes written by ``threads`` threads. Returns (counts, seconds)."""
    rng = np.random.default_rng(seed)
    counts = long_tail_counts(rng, n_classes, total)
    feat = root / "features"
    feat.mkdir(parents=True, exist_ok=True)
    (root / "norm_stats").mkdir(exist_ok=True)
    names = [f"class_{i:04d}" for i in range(n_classes)]
    sample_vals, bases = [], []
    t0 = time.perf_counter()
    for ci in range(n_classes):  # every draw first, in the JAX script's order
        base = rng.standard_normal((n_mels, n_frames)).astype(np.float32)
        band = 4 + (ci * (n_mels - 20)) // max(n_classes - 1, 1)
        base[band : band + 8, :] += 4.0
        bases.append(base)
        if ci % 200 == 0:
            sample_vals.append(base.ravel()[:2000])

    def write_class(ci: int) -> None:
        cdir = feat / names[ci]
        cdir.mkdir(exist_ok=True)
        payloads = [_npy_bytes(bases[ci] + np.float32(0.01 * k)) for k in range(min(int(counts[ci]), 97))]
        for ii in range(int(counts[ci])):
            (cdir / f"item_{ii:05d}.npy").write_bytes(payloads[ii % 97])

    with ThreadPoolExecutor(threads) as pool:
        for ci, _ in enumerate(pool.map(write_class, range(n_classes))):
            if ci % 200 == 0:
                print(f"  gen class {ci}/{n_classes} (count {counts[ci]})", file=sys.stderr, flush=True)
    flat = np.concatenate(sample_vals)
    np.save(root / "norm_stats" / "glob_norm.npy",
            np.array([[[flat.mean()]], [[flat.std()]]], dtype=np.float32))
    # all classes in the train split: the stress target is one 306k-item split
    splits = np.array(
        [np.array(names, dtype=object), np.array(names[:1], dtype=object),
         np.array(names[:1], dtype=object)], dtype=object)
    np.save(root / "splits.npy", splits, allow_pickle=True)
    return counts, time.perf_counter() - t0


def scan_config(root: Path, dataset_name: str, device: torch.device):
    """The JAX script's experiment config for scanning and packing a split."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict({
        "dataset_name": dataset_name, "data_root": str(root.parent),
        "encoder_name": "CNN",
        "n_way_train": 5, "n_shot_train": 5, "n_query_train": 5,
        "specaug_params": {"use": False},
        "tpu": {"store_dtype": "bfloat16", "mesh_shape": 1},
        "device": device.type,
    })


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_sampling(store, device: torch.device) -> float:
    """Best ms per call of the device sampler (8 episodes, 5-way 5-shot
    5-query) over ``SAMPLING_ROUNDS`` rounds of ``SAMPLING_CALLS`` calls,
    each round ended by a synchronisation; the JAX script's best-of-rounds
    (page faults and reclaim right after a large pack spike single rounds)."""
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode_batch

    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(SAMPLING_WARM):
        sample_episode_batch(gen, store, 5, 5, 5, False, batch=8)
    _sync(device)
    best = float("inf")
    for _ in range(SAMPLING_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(SAMPLING_CALLS):
            sample_episode_batch(gen, store, 5, 5, 5, False, batch=8)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / SAMPLING_CALLS * 1e3)
    return best


def time_host_sampling(host_store) -> tuple:
    """(best ms per 8 host-sampled episodes, the batch's bytes), timed as
    ``time_sampling`` on the host sampler from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    for _ in range(HOST_WARM):
        ep = host_store.sample_episode_batch(rng, 5, 5, 5, batch=8)
    best = float("inf")
    for _ in range(SAMPLING_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(SAMPLING_CALLS):
            ep = host_store.sample_episode_batch(rng, 5, 5, 5, batch=8)
        best = min(best, (time.perf_counter() - t0) / SAMPLING_CALLS * 1e3)
    batch_bytes = sum(t.numel() * t.element_size() for t in (ep.support, ep.query))
    return best, batch_bytes


def train_config(root: Path, host_store, device: torch.device):
    """``configs/nsynth_cpl.json`` and ``model_config_nsynth.json`` as
    shipped, cut in depth (one epoch of ``TRAIN_TASKS`` tasks at the
    config's E, a ``TEST_TASKS``-task test at E=``TEST_BATCH``), on this
    split in bfloat16, with ``tpu.host_store`` set to ``host_store``."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig

    cfg = json.loads(Path(EXPERIMENT_CONFIG).read_text())
    cfg.update(dataset_name=root.name, data_root=str(root.parent), num_epochs=1,
               n_training_tasks=TRAIN_TASKS, n_testing_tasks=TEST_TASKS)
    cfg["tpu"] = {**cfg.get("tpu", {}), "store_dtype": "bfloat16", "host_store": host_store,
                  "eval_episode_batch": TEST_BATCH}
    if device.type == "cpu":
        cfg["device"] = "cpu"
    return ExperimentConfig.from_dict(cfg), ModelConfig.from_dict(json.loads(Path(MODEL_CONFIG).read_text()))


def train_arm(root: Path, host_store, device: torch.device) -> dict:
    """Load the split under ``tpu.host_store: host_store``, train one epoch
    and test, holding launches, loss and accuracy."""
    from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    exp, mdl = train_config(root, host_store, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    store = load_packed_split(exp, root, "train", device)
    load_s = time.perf_counter() - t0
    trainer = Trainer(exp, mdl, store, test_store=store, device=device, seed=0)
    steps, batches = [], []
    with launches_per_call(Trainer, "train_step", steps), launches_per_call(Trainer, "_eval_episodes", batches):
        metrics = trainer.train_epoch()
        acc = trainer.test()
    out = {
        "tpu_host_store": host_store,
        "store": type(store).__name__,
        "host_mode": trainer.host_mode,
        "load_seconds": round(load_s, 1),
        "train_steps": len(steps),
        "episode_batch": exp.tpu.episode_batch,
        "train_ms_per_step_median": statistics.median(trainer.last_step_ms),
        "train_ms_per_step_min": min(trainer.last_step_ms),
        "train_eps_per_sec": metrics["episodes_per_sec"],
        "loss": metrics["loss"],
        "eval_tasks": TEST_TASKS,
        "eval_batch": trainer.last_eval_batch,
        "eval_eps_per_sec": TEST_TASKS / trainer.last_eval_seconds,
        "test_accuracy": acc["mean_accuracy"],
        "launches_per_train_step": tally_launches(steps),
        "launches_per_eval_batch": tally_launches(batches),
        "h2d_bytes": trainer.stager.h2d_bytes if trainer.host_mode else 0,
        "peak_memory_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
        "peak_rss_gb": rss_gb(),
    }
    want = {" ".join(map(str, SPEC_LAUNCHES if cuda else [0, 0, 0]))}
    if set(out["launches_per_train_step"]) != want or set(out["launches_per_eval_batch"]) != want:
        raise AssertionError(f"host_store {host_store}: launches per train step {out['launches_per_train_step']}, "
                             f"per eval batch {out['launches_per_eval_batch']}; expected {want} for each")
    if not (np.isfinite(out["loss"]) and 0.0 <= out["test_accuracy"] <= 1.0):
        raise AssertionError(f"host_store {host_store}: loss {out['loss']}, accuracy {out['test_accuracy']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--items", type=int, default=306_000)
    ap.add_argument("--classes", type=int, default=1006)
    ap.add_argument("--mels", type=int, default=128)
    ap.add_argument("--frames", type=int, default=126)  # 4 s NSynth geometry
    ap.add_argument("--keep", action="store_true", help="keep generated files")
    ap.add_argument("--skip-gen", action="store_true", help="reuse existing root")
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.data import native_pack
    from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset, make_synthetic_dataset
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialized
    root = Path(args.root)
    small_root = root.parent / f"{root.name}_small"
    native_pack.get_lib()  # builds the packer, or raises
    out = {"items": args.items, "classes": args.classes, "feat_shape": [args.mels, args.frames],
           "native_packer": True, "device": str(device), "card": card() if cuda else None,
           "torch": torch.__version__, "rss_at_start_gb": round(rss_gb(), 2)}
    try:
        if not args.skip_gen:
            if root.exists():
                shutil.rmtree(root)
            print(f"generating {args.items} items / {args.classes} classes at {root} ...", file=sys.stderr,
                  flush=True)
            counts, gen_s = generate(root, args.classes, args.items, args.mels, args.frames, seed=0)
            out["gen_seconds"] = round(gen_s, 1)
            out["class_count_min"] = int(counts.min())
            out["class_count_max"] = int(counts.max())
            out["class_count_mean"] = round(float(counts.mean()), 1)

        exp = scan_config(root, "nsynth_scale", device)
        t0 = time.perf_counter()
        ds = MetaAudioDataset(exp, root, "train")
        out["scan_seconds"] = round(time.perf_counter() - t0, 1)
        out["scanned_items"] = len(ds)

        rss_before = rss_gb()
        # the pack's header probe (one native call for the split, which also
        # gives the split's size for the placement rule), then the pack;
        # pack_seconds holds both
        t0 = time.perf_counter()
        probes = native_pack.probe_files(ds.filepaths)
        out["probe_seconds"] = time.perf_counter() - t0
        host = ds.to_host_store(dtype="bfloat16", probes=probes)
        out["pack_seconds"] = round(time.perf_counter() - t0, 1)
        del probes
        out["peak_rss_gb"] = round(rss_gb(), 2)
        out["rss_before_pack_gb"] = round(rss_before, 2)
        out["store_gb"] = round(host.nbytes() / 1e9, 2)
        out["store_dtype"] = str(host.dtype).replace("torch.", "")
        out["store_class"] = type(host).__name__

        t0 = time.perf_counter()
        store = PackedStore.from_flat_arrays(host.segments, host.seg_counts, host.labels, host.n_classes,
                                             device=device)
        _sync(device)
        out["device_store_seconds"] = round(time.perf_counter() - t0, 1)
        ct = store.class_counts.double()
        out["class_table_m_max"] = int(store.class_table.shape[1])
        out["class_table_skew"] = round(float(store.class_table.shape[1] / ct.mean()), 1)
        out["class_table_mb"] = store.class_table.numel() * store.class_table.element_size() / 1e6

        big_ms = time_sampling(store, device)
        out["sample_ms_per_8ep_306k"] = round(big_ms, 2)
        del store

        host_ms, batch_bytes = time_host_sampling(host)
        out["host_sample_ms_per_8ep_306k"] = round(host_ms, 2)
        out["host_assemble_gbps"] = round(batch_bytes / (host_ms / 1e3) / 1e9, 2)
        out["host_batch_mb"] = round(batch_bytes / 1e6, 2)
        del host

        if small_root.exists():
            shutil.rmtree(small_root)
        make_synthetic_dataset(small_root, n_classes=12, items_per_class=15, n_mels=args.mels,
                               n_frames=args.frames, split_fractions=(8, 2, 2))
        small = MetaAudioDataset(scan_config(small_root, "small", device), small_root, "train").to_packed_store(
            dtype="bfloat16", device=device)
        small_ms = time_sampling(small, device)
        out["sample_ms_per_8ep_small"] = round(small_ms, 2)
        out["sampling_flat"] = bool(big_ms < 5 * small_ms + 5.0)
        del small

        out["train"] = {placement: train_arm(root, host_store, device)
                        for placement, host_store in (("host_store_null", None), ("host_store_true", True))}
        out["peak_rss_gb_run"] = round(rss_gb(), 2)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(small_root, ignore_errors=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
