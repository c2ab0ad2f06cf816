#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``audio_few_shot_learning_tpu_torch/
   csrc/`` with ``nvcc`` (one process per source, all at once) into
   ``build/torch_kernels/``, and prints their registers and spills;
3. kernel phase: times the launch floor (one trivial kernel), then holds K1
   (SpecAugment 4-view emitter), K2 (episode head, at the spec and wav eval
   batches, a predict episode and a ragged case, on inputs as the path gives
   them, asserting that one call runs K2 and nothing else on the device) and
   K3 (mel filterbank + log, both flavours, at the wav eval batch, a predict
   episode, ragged row counts and bases that are not 16-byte aligned)
   against their plain PyTorch versions on the card, and times kernel, plain
   version and the PyTorch library call(s) computing the same function.
   Times are device times: 20 calls captured in one CUDA graph and replayed
   between CUDA events, so the host's cost of issuing a call is not in them;
4. spec slice phase: on a seeded packed store of the benchmark's geometry
   (35 classes x 40 items x 128x157 f32) and the flagship model with seeded
   weights (Hybrid, 64 channels, pool 3, RNN 64, attention 64/1/256, bf16),
   runs ``Trainer.test()`` over 64 single-segment tasks (4 eval batches of 16
   episodes) and one ``predict_episode``, with the kernels' launch counts set
   to 0 just before each and read just after; the launches per eval batch
   and per prediction must be K1 2 (support, queries), K2 1 and K3 0. Then
   it times 4 more eval runs and 10 more predictions, and runs each once
   more under ``torch.profiler``: device time by kernel and the device's
   busy share of the wall time;
5. spec card-vs-CPU phase: one float32 eval batch of 16 episodes with the
   same weights and the same augmentation draws on the card (kernels) and on
   the CPU (plain versions);
6. wav slice phase: the same on a seeded packed waveform store (35 classes x
   40 clips of 5 s at 16 kHz, 448 MB) and the flagship model with wav input
   (online log-mel on the device, one view): launches per eval batch and per
   prediction K3 1, K2 1, K1 0;
7. wav card-vs-CPU phase: one float32 wav eval batch of 16 episodes, card
   (K3, K2) against CPU (plain versions);
8. raw-audio CLI phase: seeded ``.wav`` clips for a 5-way 5-shot support set
   and 5 queries, the seeded flagship spec model saved as ``model.pt``, and
   ``cli.predict.main`` in-process on the card (offline log-mel per clip,
   then SpecAugment views and the head): launches K3 one per clip, K1 2, K2 1;
9. prints ``{"kernels": [...]}`` and, last, the ``{"ok": true, ...}`` line.

Any failure raises and exits non-zero. Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))

N_MELS, N_FRAMES, N_BINS = 128, 157, 513
SR, CLIP = 16000, 80000  # 5-s clips: 1 + 80000 // 512 = 157 frames
N_WAY, K_SHOT, K_QUERY = 5, 5, 5
EVAL_BATCH = 16
TEST_TASKS = 64
# launches of K1, K2, K3 per eval batch and per prediction
SPEC_LAUNCHES = [2, 1, 0]
WAV_LAUNCHES = [0, 1, 1]
GRAPH_CALLS, GRAPH_REPLAYS = 20, 5
K1_TOL_F32 = 1e-5  # same separately rounded f32 ops as the plain version
K2_ATOL, K2_RTOL = 1e-4, 1e-5  # another summation order than the plain matmul
K3_ATOL_DB = 1e-3  # the same f32 products summed in another order, then log10
SLICE_ATOL, SLICE_ARGMAX_AGREE = 1e-3, 0.99
WAV_MEAN, WAV_STD = 20.0, 5.0  # roughly z-scores the online log-mel of the seeded clips


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The host issues
    each call once, at capture, so its cost is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall time, the device's busy
    time and share of it, device time and calls per kernel name, and the
    device time of the kernels each ATen op launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, ops = {}, {}
    for evt in prof.key_averages():
        us = float(getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0))
        if us <= 0:
            continue
        # device-side entries are kernels and copies; host-side entries are
        # the ATen ops that launched them (aten::sum, aten::_fft_r2c, ...)
        table = kernels if str(getattr(evt, "device_type", "")).endswith("CUDA") else ops
        t, n = table.get(evt.key, (0.0, 0))
        table[evt.key] = (t + us, n + evt.count)
    busy = sum(t for t, _ in kernels.values())
    if busy == 0:
        raise AssertionError("the profiler saw no device time")

    def per_launch_us(name):
        t = sum(v[0] for k, v in kernels.items() if name in k)
        n = sum(v[1] for k, v in kernels.items() if name in k)
        return t / n if n else None

    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        wall_us=wall_us, device_busy_us=busy, device_busy_share=busy / wall_us,
        k1_us_per_launch=per_launch_us("views_kernel"),
        k2_us_per_launch=per_launch_us("episode_scores_kernel"),
        k3_us_per_launch=per_launch_us("mel_log_kernel"),
        fft_us=sum(t for k, (t, _) in kernels.items() if "fft" in k.lower()),
        top_kernels_us_calls=[[k[:80], t, n] for k, (t, n) in top],
        top_ops_device_us_calls=[[k[:80], t, n] for k, (t, n) in top_ops],
    )


def device_kernels(fn) -> list:
    """Names of the device activities (kernels, copies, fills) that one call
    of ``fn`` runs, under ``torch.profiler``, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            names += [evt.key] * evt.count
    return names


def launch_floor_ms(dev) -> float:
    """Graph-replay time of one trivial kernel (``zero_()`` on a one-element
    tensor): what any launch costs on this card, the floor for K2."""
    import torch

    x = torch.ones(1, device=dev)
    return graph_ms(lambda: x.zero_())


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_phase(dev):
    """The launch floor, then K1, K2 and K3 against their plain versions at
    the main path's shapes."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import SpecAugParams
    from audio_few_shot_learning_tpu_torch.ops import protohead, specaugment

    gen = torch.Generator(device=dev).manual_seed(0)
    params = SpecAugParams(use=True, mask_param=16, W=22, num_mask=1, mask_value=0.0, p=0.282)
    rows = {"launch_floor_ms": launch_floor_ms(dev)}

    # K1: one launch per view call; the eval batch makes E=16 episodes x 25 items
    k1 = []
    for dtype in (torch.float32, torch.bfloat16):
        spec = torch.randn(
            (EVAL_BATCH, N_WAY * K_SHOT, N_MELS, N_FRAMES), generator=gen, device=dev
        ).to(dtype)
        ys, tm, fm = specaugment.draw_views_params(
            gen, params, EVAL_BATCH, N_WAY * K_SHOT, N_MELS, N_FRAMES, dev
        )
        args = (spec, ys, tm, fm, params.mask_value)
        out = specaugment.views_cuda(*args)
        ref = specaugment.views_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # bf16: at most one bf16 rounding step (2^-8 relative) at the largest value
        tol = K1_TOL_F32 if dtype == torch.float32 else 2.0**-8 * spec.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K1 {dtype} disagrees with its plain version: {err} > {tol}")
        ms = graph_ms(lambda: specaugment.views_cuda(*args))
        plain = graph_ms(lambda: specaugment.views_reference(*args))
        b_ms, b_by = bound_ms(nbytes(spec, ys, tm, fm) + nbytes(out), 3 * out.numel() / 4)
        k1.append(dict(dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tolerance=tol,
                       ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
    rows["K1"] = k1

    # K2: one launch per eval batch, on the inputs as the path gives them:
    # support and queries are slices of the attention output [E, S+Q, D],
    # labels int64 expanded over the episodes (stride 0). Flagship spec E=16,
    # S=Q=25, D=V*64=256, N=5; the wav path's D=64 (one view); a predict
    # episode (E=1); a ragged case (N=7, uneven classes, one empty class).
    k2 = []
    for name, n_way, labels_np, e, d in (
        ("flagship", N_WAY, np.repeat(np.arange(N_WAY), K_SHOT), EVAL_BATCH, 4 * 64),
        ("wav", N_WAY, np.repeat(np.arange(N_WAY), K_SHOT), EVAL_BATCH, 64),
        ("predict", N_WAY, np.repeat(np.arange(N_WAY), K_SHOT), 1, 4 * 64),
        ("ragged", 7, np.array([0] * 9 + [1] * 2 + [2] * 5 + [3] * 1 + [4] * 4 + [5] * 4),
         EVAL_BATCH, 4 * 64),
    ):
        s, q = len(labels_np), N_WAY * K_QUERY
        fused = torch.randn((e, s + q, d), generator=gen, device=dev)
        sup, qry = fused[:, :s], fused[:, s:]
        lab = torch.as_tensor(labels_np, device=dev).expand(e, -1)
        out = protohead.episode_scores_cuda(sup, lab, qry, n_way)
        ref = protohead.batched_episode_scores_reference(sup, lab, qry, n_way)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, atol=K2_ATOL, rtol=K2_RTOL):
            raise AssertionError(f"K2 {name} disagrees with its plain version: max err {err}")
        # the wrapper launches K2 and nothing else: no label cast, no feature copy
        device_ops = device_kernels(lambda: protohead.episode_scores_cuda(sup, lab, qry, n_way))
        if len(device_ops) != 1 or "episode_scores_kernel" not in device_ops[0]:
            raise AssertionError(f"K2 {name}: one call ran {device_ops} on the device")
        ms = graph_ms(lambda: protohead.episode_scores_cuda(sup, lab, qry, n_way))
        plain = graph_ms(lambda: protohead.batched_episode_scores_reference(sup, lab, qry, n_way))
        protos = protohead.compute_prototypes(sup, lab, n_way)
        library = graph_ms(lambda: torch.cdist(qry, protos))
        flops = e * (s * d + q * n_way * 2 * d + q * 2 * d + n_way * 3 * d)
        # labels: the S distinct int64 values the expanded tensor holds
        b_ms, b_by = bound_ms(nbytes(sup, qry, out) + lab.untyped_storage().nbytes(), flops)
        k2.append(dict(case=name, e=e, d=d, n_way=n_way, max_abs_err=err,
                       tolerance=[K2_ATOL, K2_RTOL], device_ops_per_call=device_ops, ms=ms,
                       plain_ms=plain, library_ms=library, bound_ms=b_ms, bound_by=b_by))
    rows["K2"] = k2
    rows["K3"] = k3_cases(dev, gen)
    return rows


def unaligned_copy(x):
    """A contiguous copy of ``x [..., K]`` f32 whose base is 4 bytes past a
    16-byte boundary: rows 1: of a flat [M + 1, K] buffer (K = 513 makes
    each row 2 052 bytes, 4 mod 16)."""
    import torch

    k = x.shape[-1]
    flat = torch.empty((x.numel() // k + 1, k), device=x.device, dtype=x.dtype)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    if out.data_ptr() % 16 == 0 or not out.is_contiguous():
        raise AssertionError("unaligned_copy made an aligned or strided tensor")
    return out


def k3_cases(dev, gen):
    """K3 against its plain version: the online flavour at the wav eval
    batch (M = 16 x 50 x 157 = 125 600), the offline flavour at a predict
    episode (M = 50 x 157 = 7 850), ragged row counts (M = 157, M = 1, and
    M = 33, 35, 63, which leave 1, 3 and 31 rows in the last tile), and
    inputs whose base is not 16-byte aligned (plain loads instead of the
    bulk copies). Inputs are power spectrograms of seeded noise, as the path
    makes them."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import mel

    rows = []
    hop = 512
    for case, flavor, clips, length, aligned in (
        ("eval", "online", EVAL_BATCH * N_WAY * (K_SHOT + K_QUERY), CLIP, True),
        ("predict", "offline", N_WAY * (K_SHOT + K_QUERY), CLIP, True),
        ("ragged M=157", "online", 1, CLIP, True),
        ("ragged M=1", "offline", 1, 100, True),
        ("ragged M=33", "online", 1, 32 * hop, True),
        ("ragged M=35", "offline", 1, 34 * hop, True),
        ("ragged M=63", "online", 1, 62 * hop, True),
        ("unaligned M=33", "online", 1, 32 * hop, False),
        ("unaligned M=35", "offline", 1, 34 * hop, False),
        ("unaligned M=63", "online", 1, 62 * hop, False),
        ("unaligned predict", "offline", N_WAY * (K_SHOT + K_QUERY), CLIP, False),
    ):
        spec = mel.MelSpec(flavor)
        wav = 0.3 * torch.randn((clips, length), generator=gen, device=dev)
        pspec = mel.power_spectrogram(wav, pad_mode=spec.pad_mode)
        if not aligned:
            pspec = unaligned_copy(pspec)
        fb = torch.from_numpy(spec.fb).to(dev)
        bands = mel.band_table(spec.fb).to(dev)
        args = (pspec, fb, spec.log_mult, spec.eps)
        out = mel.mel_log_cuda(*args, bands)
        ref = mel.mel_log_reference(*args).transpose(-1, -2)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= K3_ATOL_DB:
            raise AssertionError(f"K3 {case} ({flavor}) disagrees with its plain version: {err} dB")
        ms = graph_ms(lambda: mel.mel_log_cuda(*args, bands))
        plain = graph_ms(lambda: mel.mel_log_reference(*args))
        library = graph_ms(lambda: torch.log10(torch.matmul(pspec, fb)))
        m = pspec.numel() // N_BINS
        nnz = bands.weights.numel()
        # the work this filterbank needs: one multiply-add per nonzero weight
        b_ms, b_by = bound_ms(nbytes(pspec, fb, out), 2 * m * nnz)
        rows.append(dict(
            case=case, flavor=flavor, m=m, base_16b_aligned=aligned, max_abs_err=err,
            tolerance=K3_ATOL_DB, ms=ms, plain_ms=plain, library_ms=library, bound_ms=b_ms,
            bound_by=b_by, share_of_bound=b_ms / ms,
            bound_ms_dense_flops=2 * m * N_BINS * N_MELS / F32_FLOPS * 1e3,
            filterbank_nonzeros=nnz,
        ))
    return rows


def make_store(dev):
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore

    n_classes, per_class = 35, 40
    rng = np.random.default_rng(0)
    segments = rng.standard_normal((n_classes * per_class, N_MELS, N_FRAMES), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    return PackedStore.from_flat_arrays(
        segments, np.ones(len(labels), np.int64), labels, n_classes, device=dev
    )


def make_wav_store(dev):
    """35 classes x 40 clips of 5 s of seeded noise: 448 MB on the card."""
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    n_classes, per_class = 35, 40
    rng = np.random.default_rng(0)
    clips = 0.3 * rng.standard_normal((n_classes * per_class, CLIP), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    return PackedWavStore.pack(list(clips), labels, n_classes, mean=WAV_MEAN, std=WAV_STD, device=dev)


def flagship_dict(input_type="spec", **tpu):
    return {
        "encoder_name": "Hybrid", "use_attention": True, "use_contrastive": True,
        "input_type": input_type, "n_testing_tasks": TEST_TASKS,
        "specaug_params": {"use": True, "mask_param": 16, "W": 22, "num_mask": 1,
                           "mask_value": 0, "p": 0.282},
        "waveaug_params": {"use": False},
        "test_query_augmentations": True,
        "tpu": {"eval_episode_batch": EVAL_BATCH, "compute_dtype": "bfloat16", **tpu},
    }


def flagship_exp(input_type="spec", **tpu):
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict(flagship_dict(input_type, **tpu))


def kernel_counters():
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    return (specaugment.views_cuda, protohead.episode_scores_cuda, mel.mel_log_cuda)


def serve_phase(dev, store, input_type, expected):
    """Trainer.test() and predict_episode on the flagship model, bf16, with
    the launches of K1, K2, K3 per eval batch and per prediction asserted."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(flagship_exp(input_type), ModelConfig(), store, test_store=store,
                      device=dev, seed=0)
    trainer.evaluate(store, EVAL_BATCH, N_WAY, K_SHOT, K_QUERY, True)  # warm-up: cuDNN plans

    for k in kernels:
        k.launches = 0
    result = trainer.test()
    eval_launches = [k.launches for k in kernels]
    eval_s = [trainer.last_eval_seconds]
    acc = result["mean_accuracy"]
    if not (np.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"test accuracy out of range: {result}")
    n_batches = TEST_TASKS // EVAL_BATCH
    per_batch = [n / n_batches for n in eval_launches]
    if per_batch != expected:
        raise AssertionError(
            f"{input_type} eval path launched K1, K2, K3 {per_batch} times per batch "
            f"({eval_launches} in {n_batches} batches); expected {expected}"
        )

    def run_eval():
        trainer.evaluate(store, TEST_TASKS, N_WAY, K_SHOT, K_QUERY, True)

    for _ in range(4):
        run_eval()
        eval_s.append(trainer.last_eval_seconds)
    eval_profile = profile(run_eval)

    rng = np.random.default_rng(1)
    items = torch.as_tensor(rng.integers(0, store.num_items, 2 * N_WAY * K_SHOT), device=dev)
    if input_type == "wav":
        rows = store.extract_segment(items, torch.zeros_like(items)).cpu().numpy()  # [50, L]
    else:
        rows = store.segments[items].float().cpu().numpy()  # [50, F, T]
    support, query = rows[: N_WAY * K_SHOT], rows[N_WAY * K_SHOT :]
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    trainer.predict_episode(support, labels, query)  # warm-up
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    pred, scores = trainer.predict_episode(support, labels, query)
    predict_ms = [1e3 * (time.perf_counter() - t0)]
    predict_launches = [k.launches for k in kernels]
    if scores.shape != (N_WAY * K_QUERY, N_WAY) or not np.isfinite(scores).all():
        raise AssertionError(f"predict scores malformed: {scores.shape}")
    if pred.shape != (N_WAY * K_QUERY,) or pred.min() < 0 or pred.max() >= N_WAY:
        raise AssertionError(f"predictions malformed: {pred}")
    if predict_launches != expected:
        raise AssertionError(
            f"{input_type} predict path launched K1, K2, K3 {predict_launches} times; "
            f"expected {expected}"
        )

    def run_predict():
        trainer.predict_episode(support, labels, query)

    for _ in range(10):
        t0 = time.perf_counter()
        run_predict()
        predict_ms.append(1e3 * (time.perf_counter() - t0))
    predict_profile = profile(run_predict)

    eps = [TEST_TASKS / t for t in eval_s]
    return dict(
        test=result, eval_seconds=eval_s, eval_episodes_per_s=eps,
        eval_episodes_per_s_median=float(np.median(eps)),
        eval_batch_ms_median=1e3 * float(np.median(eval_s)) / n_batches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        predict_ms=predict_ms, predict_ms_median=float(np.median(predict_ms)),
        eval_launches=eval_launches, eval_launches_per_batch=per_batch,
        predict_launches=predict_launches,
        eval_profile=eval_profile, predict_profile=predict_profile,
    )


def card_vs_cpu_phase(dev, store, input_type):
    """One float32 eval batch (E=16, as the timed path), same weights,
    episodes and augmentation draws, card (kernels) vs CPU (plain versions)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    e = EVAL_BATCH
    exp = flagship_exp(input_type, compute_dtype="float32", eval_episode_batch=e)
    card = Trainer(exp, ModelConfig(), store, device=dev, seed=3)
    cpu = Trainer(exp, ModelConfig(), store, device="cpu", seed=3)  # the store only gives shapes
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})

    ep = sample_episode(torch.Generator(device=dev).manual_seed(5), store, N_WAY, K_SHOT, K_QUERY, e)
    ep_cpu = type(ep)(**{f.name: getattr(ep, f.name).cpu() for f in dataclasses.fields(ep)})
    draws_card = draws_cpu = None
    if input_type == "spec":
        g = torch.Generator().manual_seed(6)
        draws_cpu = tuple(
            draw_views_params(g, exp.specaug_params, e, n, N_MELS, N_FRAMES, "cpu")
            for n in (N_WAY * K_SHOT, N_WAY * K_QUERY)
        )
        draws_card = tuple(tuple(x.to(dev) for x in d) for d in draws_cpu)
    with torch.inference_mode():
        s_card = card._episode_scores(ep, N_WAY, True, card.gen, draws_card, store).cpu()
        s_cpu = cpu._episode_scores(ep_cpu, N_WAY, True, cpu.gen, draws_cpu, store)
    err = (s_card - s_cpu).abs().max().item()
    agree = (s_card.argmax(-1) == s_cpu.argmax(-1)).float().mean().item()
    if not (err <= SLICE_ATOL and agree >= SLICE_ARGMAX_AGREE):
        raise AssertionError(
            f"{input_type} card vs CPU: max err {err} (atol {SLICE_ATOL}), argmax agree {agree}"
        )
    return dict(max_abs_err=err, atol=SLICE_ATOL, argmax_agree=agree, episodes=e)


def cli_phase(dev):
    """The raw-audio predict CLI in-process on the card: seeded .wav clips
    (5 classes x 5 support, 5 queries), the seeded flagship spec model as
    ``model.pt``, ``--norm-stats``; the JSON it writes is checked."""
    import scipy.io.wavfile
    import torch

    from audio_few_shot_learning_tpu_torch.cli import predict
    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel

    rng = np.random.default_rng(7)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        classes = [f"class{c}" for c in range(N_WAY)]
        for c, name in enumerate(classes):
            os.makedirs(os.path.join(tmp, "support", name))
            for i in range(K_SHOT):
                x = (0.3 * (1 + c) / N_WAY * rng.standard_normal(CLIP) * 32767).astype(np.int16)
                scipy.io.wavfile.write(os.path.join(tmp, "support", name, f"{i}.wav"), SR, x)
        os.makedirs(os.path.join(tmp, "query"))
        for i in range(N_WAY):
            x = (0.3 * rng.standard_normal(CLIP)).astype(np.float32)
            scipy.io.wavfile.write(os.path.join(tmp, "query", f"q{i}.wav"), SR, x)
        np.save(os.path.join(tmp, "stats.npy"), np.array([-10.0, 10.0], np.float32).reshape(2, 1, 1))
        with open(os.path.join(tmp, "exp.json"), "w") as f:
            json.dump(flagship_dict("spec"), f)
        with open(os.path.join(tmp, "mdl.json"), "w") as f:
            json.dump({}, f)
        torch.manual_seed(0)
        model = FewShotEpisodeModel(flagship_exp("spec"), ModelConfig(), (N_MELS, N_FRAMES))
        torch.save(model.state_dict(), os.path.join(tmp, "model.pt"))

        kernels = kernel_counters()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            predict.main([
                "-e", os.path.join(tmp, "exp.json"), "-m", os.path.join(tmp, "mdl.json"),
                "--checkpoint", os.path.join(tmp, "model.pt"),
                "--support", os.path.join(tmp, "support"), "--query", os.path.join(tmp, "query"),
                "--norm-stats", os.path.join(tmp, "stats.npy"),
                "--output", os.path.join(tmp, "out.json"),
            ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        with open(os.path.join(tmp, "out.json")) as f:
            out = json.load(f)
    preds = out["predictions"]
    if out["classes"] != classes or out["n_way"] != N_WAY or len(preds) != N_WAY:
        raise AssertionError(f"predict CLI output malformed: {out}")
    for p in preds:
        scores = list(p["scores"].values())
        if (p["predicted_class"] not in classes or sorted(p["scores"]) != classes
                or not all(np.isfinite(scores))):
            raise AssertionError(f"predict CLI prediction malformed: {p}")
    if not (launches[2] >= 1 and launches[:2] == [2, 1]):
        raise AssertionError(f"raw-audio predict launched K1, K2, K3 {launches} times; "
                             "expected 2, 1 and at least 1")
    return dict(launches=launches, seconds=seconds, clips=N_WAY * K_SHOT + N_WAY,
                predicted=[p["predicted_class"] for p in preds])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from audio_few_shot_learning_tpu_torch.ops import cuda_build

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = cuda_build.build(["specaugment", "protohead", "mel"])
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs) or 'nothing (cached)'} from csrc/ with nvcc for sm_90a "
          f"in {build_s:.1f} s", flush=True)
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = kernel_phase(dev)
    print("kernel phase: " + json.dumps(kern), flush=True)

    store = make_store(dev)
    slc = serve_phase(dev, store, "spec", SPEC_LAUNCHES)
    print(f"spec slice phase ({card}): " + json.dumps(slc), flush=True)

    t0 = time.perf_counter()
    cmp = card_vs_cpu_phase(dev, store, "spec")
    cmp["seconds"] = time.perf_counter() - t0
    print("spec card vs CPU: " + json.dumps(cmp), flush=True)
    del store

    t0 = time.perf_counter()
    wav_store = make_wav_store(dev)
    print(f"wav store: {wav_store.nbytes() / 1e6:.1f} MB on the card, packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wav = serve_phase(dev, wav_store, "wav", WAV_LAUNCHES)
    print(f"wav slice phase ({card}): " + json.dumps(wav), flush=True)

    t0 = time.perf_counter()
    wav_cmp = card_vs_cpu_phase(dev, wav_store, "wav")
    wav_cmp["seconds"] = time.perf_counter() - t0
    print("wav card vs CPU: " + json.dumps(wav_cmp), flush=True)
    del wav_store

    cli = cli_phase(dev)
    print("raw-audio CLI: " + json.dumps(cli), flush=True)

    k1_f32, k2_flag, k3_eval = kern["K1"][0], kern["K2"][0], kern["K3"][0]
    common = [
        dict(name="specaugment_views",
             source="audio_few_shot_learning_tpu_torch/csrc/specaugment.cu",
             replaces="audio_few_shot_learning_tpu/ops/specaugment.py:228", row=k1_f32,
             path=slc, library_ms=None, in_eval_us=slc["eval_profile"]["k1_us_per_launch"],
             extra=dict(bf16=kern["K1"][1])),
        dict(name="episode_scores",
             source="audio_few_shot_learning_tpu_torch/csrc/protohead.cu",
             replaces="audio_few_shot_learning_tpu/ops/protohead.py:136", row=k2_flag,
             path=slc, library_ms=k2_flag["library_ms"],
             in_eval_us=slc["eval_profile"]["k2_us_per_launch"],
             extra=dict(library="torch.cdist on precomputed prototypes",
                        device_ops_per_call=k2_flag["device_ops_per_call"],
                        cases=kern["K2"][1:], wav_path_launches=wav["eval_launches"][1])),
        dict(name="mel_log",
             source="audio_few_shot_learning_tpu_torch/csrc/mel.cu",
             replaces="audio_few_shot_learning_tpu/ops/mel.py:179", row=k3_eval,
             path=wav, library_ms=k3_eval["library_ms"],
             in_eval_us=wav["eval_profile"]["k3_us_per_launch"],
             extra=dict(library="torch.matmul + torch.log10 (two calls, without eps and log_mult)",
                        bound_ms_dense_flops=k3_eval["bound_ms_dense_flops"],
                        cases=kern["K3"][1:], cli_launches=cli["launches"][2])),
    ]
    kernels = []
    for i, k in enumerate(common):
        r, path = k["row"], k["path"]
        kernels.append(dict(
            name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
            launches=path["eval_launches"][i],
            launches_per_eval_batch=path["eval_launches_per_batch"][i],
            launches_predict=path["predict_launches"][i], max_abs_err=r["max_abs_err"],
            tolerance=r["tolerance"], ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=1e3 * r["bound_ms"], bound_by=r["bound_by"],
            library_ms=k["library_ms"], launch_floor_ms=kern["launch_floor_ms"],
            profiler_us_in_eval=k["in_eval_us"], **k["extra"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
