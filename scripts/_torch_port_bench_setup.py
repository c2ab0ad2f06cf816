"""What the port's drivers take from the JAX repo's ``bench.py`` and
``__graft_entry__.py``, in the port's own copy (no measurement of its own).

* ``FLAGSHIP_EXPERIMENT``: ``__graft_entry__.py:25-65``'s flagship
  configuration as a dict (Hybrid + SpecAugment 4 views + attention + CPL,
  5-way 5-shot 5-query); the model is ``ModelConfig()``'s defaults,
  ``MODEL_CONFIG``, which the CPU tests narrow (the JAX file's small model
  is not used by any driver);
* ``make_store`` (``bench.py:37-55``: 35 classes x 40 items of 128x157 from
  ``default_rng(0)``), ``make_wav_store`` (``:74-87``, the device store: 12
  classes x 20 clips of 5 s) and ``make_trainer`` (``:90-116``);
* what the drivers measure with: ``device_profile`` (device time by kernel
  and by launching ATen op under ``torch.profiler``), ``kernel_family`` and
  ``event_ms``.

``bench.py``'s measurements and its benchmark are not ported here. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

N_MELS, N_FRAMES = 128, 157
N_WAY, K_SHOT, K_QUERY = 5, 5, 5

FLAGSHIP_EXPERIMENT = {
    "encoder_name": "Hybrid",
    "use_attention": True,
    "use_contrastive": True,
    "input_type": "spec",
    "n_way_train": 5,
    "n_shot_train": 5,
    "n_query_train": 5,
    "lr": 7e-4,
    "loss": {
        "l_param": 2.022308,
        "cpl": {"use": True, "m_param": 5, "t_param": 9.2361},
        "angular": {"use": False},
    },
    "specaug_params": {"use": True, "mask_param": 16, "W": 22, "num_mask": 1, "mask_value": 0, "p": 0.282},
    "train_query_augmentations": True,
    "project_prototypes": True,
}
MODEL_CONFIG: dict = {}  # ModelConfig()'s defaults: the flagship's widths
TASKS_PER_EPISODE_BATCH = 20  # an epoch of make_trainer's is 20 steps


def make_store(multiseg: bool = False, s_max: int = 6, n_classes: int = 35, per_class: int = 40,
               dtype: str = "float32", device="cuda"):
    """``bench.make_store`` as a ``PackedStore`` on ``device`` in ``dtype``:
    the same draws from ``default_rng(0)`` (float64 noise cast to float32,
    item by item)."""
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore

    rng = np.random.default_rng(0)
    if multiseg:
        items = [rng.standard_normal((int(rng.integers(1, s_max + 1)), N_MELS, N_FRAMES)).astype(np.float32)
                 for _ in range(n_classes * per_class)]
    else:
        items = [rng.standard_normal((N_MELS, N_FRAMES)).astype(np.float32) for _ in range(n_classes * per_class)]
    labels = list(np.repeat(np.arange(n_classes), per_class))
    return PackedStore.pack(items, labels, n_classes=n_classes, dtype=dtype, device=device)


def make_wav_store(device="cuda", seconds: float = 5.0):
    """``bench.make_wav_store()``: 12 classes x 20 clips of noise, 16 kHz, on
    ``device`` (the CPU tests shorten ``seconds``)."""
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    rng = np.random.default_rng(0)
    n_classes, per_class = 12, 20
    wavs = [rng.standard_normal(int(16000 * seconds)).astype(np.float32) for _ in range(n_classes * per_class)]
    return PackedWavStore.pack(wavs, list(np.repeat(np.arange(n_classes), per_class)), n_classes=n_classes,
                               device=device)


def trainer_dict(episode_batch: int = 1, microbatch: Optional[int] = None, wav: bool = False,
                 waveaug: Optional[dict] = None) -> dict:
    """``bench.make_trainer``'s experiment: the flagship, ``episode_batch *
    20`` tasks an epoch, eval E=16; with ``wav`` raw-audio input with
    SpecAugment off and WaveAugment on (aug_num 3, ``waveaug`` overriding
    its keys)."""
    d = {**FLAGSHIP_EXPERIMENT, "n_training_tasks": episode_batch * TASKS_PER_EPISODE_BATCH,
         "tpu": {"episode_batch": episode_batch, "eval_episode_batch": 16, "episode_microbatch": microbatch}}
    if wav:
        d.update(input_type="wav", specaug_params={**d["specaug_params"], "use": False},
                 waveaug_params={"use": True, "aug_num": 3, **(waveaug or {})})
    return d


def make_trainer(episode_batch: int = 1, microbatch: Optional[int] = None, wav: bool = False, store=None,
                 device="cuda", waveaug: Optional[dict] = None):
    """``bench.make_trainer`` on ``device``; the store defaults to
    ``make_wav_store()`` or ``make_store()``."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    d = trainer_dict(episode_batch, microbatch, wav, waveaug)
    if store is None:
        store = make_wav_store(device) if wav else make_store(device=device)
    exp, mdl = ExperimentConfig.from_dict(d), ModelConfig.from_dict(MODEL_CONFIG)
    return Trainer(exp, mdl, store, val_store=store, test_store=store, device=device)


def bench_train(trainer, repeats: int = 3) -> float:
    """``bench.bench_train``: one warm-up epoch, then the best episodes/s of
    ``repeats`` epochs (each epoch reads its metrics back once)."""
    trainer.train_epoch()
    return max(trainer.train_epoch()["episodes_per_sec"] for _ in range(repeats))


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn: Callable[[], object], iters: int, device, warmup: int = 3) -> Optional[float]:
    """Mean ms per call of ``fn`` over ``iters`` calls between two CUDA
    events, after ``warmup`` calls; None on the CPU (not a device time)."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# cuDNN, cuBLAS and ATen kernel names on sm_90, by what they compute; the
# first family whose words a kernel's name holds (lower case) takes it
FAMILIES = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("pool", ("pool",)),
    ("conv", ("conv", "xmma", "cutlass", "gemm", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "nchwtonhwc",
              "nhwctonchw")),
    ("k1_k2_k3", ("views_kernel", "episode_scores_kernel", "mel_log_kernel")),
    ("fft", ("fft",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill")),
    ("copy", ("memcpy", "memset", "copy")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, words in FAMILIES:
        if any(w in low for w in words):
            return family
    return "other"


def device_profile(fn: Callable[[], object], calls: int, device) -> Dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``, then a
    synchronization: the wall ms a call, the device's busy ms a call (the sum
    of its kernels' and copies' time) and share, and device ms a call by
    kernel family, by kernel name and by the ATen op that launched the
    kernels. On the CPU every device figure is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return dict(calls=calls, wall_ms=1e3 * (time.perf_counter() - t0) / calls, device_ms=None,
                    busy_share=None, by_family=None, by_kernel=None, by_op=None)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync(device)
        wall = time.perf_counter() - t0
    kernels: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for evt in prof.key_averages():
        us = float(getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0))
        if us > 0:
            table = kernels if str(getattr(evt, "device_type", "")).endswith("CUDA") else ops
            table[evt.key] = table.get(evt.key, 0.0) + us / 1e3 / calls
    busy = sum(kernels.values())
    if busy == 0:
        raise AssertionError("the profiler saw no device time")
    families: Dict[str, float] = {}
    for name, ms in kernels.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])  # noqa: E731
    return dict(calls=calls, wall_ms=1e3 * wall / calls, device_ms=busy, busy_share=busy / (1e3 * wall / calls),
                by_family=top(families, len(families)), by_kernel={k[:90]: v for k, v in top(kernels, 12).items()},
                by_op=top(ops, 12))
