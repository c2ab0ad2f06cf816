"""What the port's drivers take from the JAX repo's ``bench.py`` and
``__graft_entry__.py``, in the port's own copy.

* ``FLAGSHIP_EXPERIMENT``: ``__graft_entry__.py:25-65``'s flagship
  configuration as a dict (Hybrid + SpecAugment 4 views + attention + CPL,
  5-way 5-shot 5-query); the model is ``ModelConfig()``'s defaults,
  ``MODEL_CONFIG``, which the CPU tests narrow (the JAX file's small model
  is not used by any driver);
* ``entry`` (``__graft_entry__.py:68-100``): the flagship's eval forward on
  one episode batch, as ``(fn, args)``;
* ``make_store`` (``bench.py:37-55``: 35 classes x 40 items of 128x157 from
  ``default_rng(0)``), ``make_host_store`` (``:58-71``, the same split in
  host RAM), ``make_wav_store`` (``:74-87``: 12 classes x 20 clips of 5 s,
  on the device or with ``host`` in host RAM), ``make_trainer``
  (``:90-116``), ``bench_train`` (``:119-125``) and ``bench_eval``
  (``:128-140``);
* what the drivers measure with: ``device_profile`` (device time by kernel
  and by launching ATen op under ``torch.profiler``), ``kernel_family`` and
  ``event_ms``.

``bench.py``'s own measurements (the reference loop, the FLOP count, the
matmul roof, the headline) are ported in ``scripts/torch_port_bench.py``.
Imports nothing of JAX or of the JAX package.
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
EVAL_WARMUP_TASKS = 16  # bench_eval's warm-up run


def _spec_items(multiseg: bool, s_max: int, n_classes: int, per_class: int):
    """``bench.py``'s spec split: float64 noise from ``default_rng(0)`` cast
    to float32 item by item (1 to ``s_max`` segments an item with
    ``multiseg``), and its labels."""
    rng = np.random.default_rng(0)
    if multiseg:
        items = [rng.standard_normal((int(rng.integers(1, s_max + 1)), N_MELS, N_FRAMES)).astype(np.float32)
                 for _ in range(n_classes * per_class)]
    else:
        items = [rng.standard_normal((N_MELS, N_FRAMES)).astype(np.float32) for _ in range(n_classes * per_class)]
    return items, list(np.repeat(np.arange(n_classes), per_class))


def make_store(multiseg: bool = False, s_max: int = 6, n_classes: int = 35, per_class: int = 40,
               dtype: str = "float32", device="cuda"):
    """``bench.make_store`` as a ``PackedStore`` on ``device`` in ``dtype``."""
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore

    items, labels = _spec_items(multiseg, s_max, n_classes, per_class)
    return PackedStore.pack(items, labels, n_classes=n_classes, dtype=dtype, device=device)


def make_host_store():
    """``bench.make_host_store``: ``make_store()``'s split as a float32
    ``HostStore`` in host RAM (the streaming path of a split larger than
    the card)."""
    from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore

    items, labels = _spec_items(False, 1, 35, 40)
    return HostStore.pack(items, labels, n_classes=35)


def make_wav_store(device="cuda", seconds: float = 5.0, host: bool = False):
    """``bench.make_wav_store(host)``: 12 classes x 20 clips of noise, 16
    kHz, on ``device``, or with ``host`` as a float32 ``WavHostStore`` in
    host RAM (the CPU tests shorten ``seconds``)."""
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    rng = np.random.default_rng(0)
    n_classes, per_class = 12, 20
    wavs = [rng.standard_normal(int(16000 * seconds)).astype(np.float32) for _ in range(n_classes * per_class)]
    labels = list(np.repeat(np.arange(n_classes), per_class))
    if host:
        return WavHostStore.pack(wavs, labels, n_classes=n_classes)
    return PackedWavStore.pack(wavs, labels, n_classes=n_classes, device=device)


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


def bench_eval(trainer, store, n_tasks: int = 256, multisegment: bool = False, repeats: int = 2) -> float:
    """``bench.bench_eval``: a warm-up run of ``EVAL_WARMUP_TASKS``, then
    the best tasks/s of ``repeats`` runs of ``n_tasks`` (augmented queries;
    majority vote with ``max_posterior`` ties for ``multisegment``), the
    card synchronised before each clock read."""
    kwargs = dict(n_way=N_WAY, k_shot=K_SHOT, k_query=K_QUERY, augment_query=True, multisegment=multisegment,
                  tie_strategy="max_posterior" if multisegment else "")
    trainer.evaluate(store, n_tasks=EVAL_WARMUP_TASKS, **kwargs)
    best = 0.0
    for _ in range(repeats):
        sync(trainer.device)
        t0 = time.perf_counter()
        trainer.evaluate(store, n_tasks=n_tasks, **kwargs)
        sync(trainer.device)
        best = max(best, n_tasks / (time.perf_counter() - t0))
    return best


def entry(device="cuda"):
    """``__graft_entry__.entry``: ``(fn, args)``, the flagship's eval forward
    on one episode batch. ``args`` are the model (seeded torch-default
    weights, on ``device``, in eval mode), support and query views ``[1, 25,
    4, N_MELS, N_FRAMES]`` of zeros and the support labels ``[1, 25]``;
    ``fn(*args)`` gives the scores ``[1, 25, 5]``. Raises without a card
    unless ``device`` is the CPU."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel

    device = resolve_device(device)
    exp, mdl = ExperimentConfig.from_dict(FLAGSHIP_EXPERIMENT), ModelConfig.from_dict(MODEL_CONFIG)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FewShotEpisodeModel(exp, mdl, (N_MELS, N_FRAMES))
    model = model.to(device).eval()
    e, s, q, v = 1, N_WAY * K_SHOT, N_WAY * K_QUERY, 4
    support = torch.zeros((e, s, v, N_MELS, N_FRAMES), device=device)
    query = torch.zeros((e, q, v, N_MELS, N_FRAMES), device=device)
    labels = torch.arange(N_WAY, device=device).repeat_interleave(K_SHOT)[None].expand(e, -1)

    @torch.inference_mode()
    def fn(model, support, query, labels):
        return model(support, query, labels, N_WAY).scores

    return fn, (model, support, query, labels)


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
        if us > 0 and not getattr(evt, "is_user_annotation", False):  # spans' device mirrors are no work
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
