#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``audio_few_shot_learning_tpu_torch/
   csrc/`` with ``nvcc`` (one process per source, all at once) into
   ``build/torch_kernels/``, and prints their registers and spills;
3. kernel phase: times the launch floor (one trivial kernel), then holds K1
   (SpecAugment 4-view emitter, at the flagship's eval batch, E=16, and
   train step, E=1, and at NSynth's 128x126 for a train step and an eval
   batch, in float32 and bf16, equal to the bit, asserting that one call
   runs K1 and nothing else on the device), K2 (episode head, at the spec
   and wav eval batches, a predict episode, a ragged case and the classifier API's
   support and query encodes, on inputs as the path gives them, asserting
   that one call runs K2 and nothing else on the device) and
   K3 (mel filterbank + log, both flavours, at the wav eval batch, a predict
   episode, ragged row counts and bases that are not 16-byte aligned)
   against their plain PyTorch versions on the card, and times kernel, plain
   version and the PyTorch library call(s) computing the same function.
   Times are device times: 20 calls captured in one CUDA graph and replayed
   between CUDA events, so the host's cost of issuing a call is not in them;
   K4 (eval block 0) and K5 (eval blocks 1-3): the profiler's view of one
   call at items 34's and 35's shapes here (one device op, or the run
   fails), held and timed last (items 34, 35);
4. spec slice phase: on a seeded packed store of the benchmark's geometry
   (35 classes x 40 items x 128x157 f32) and the flagship model with seeded
   weights (Hybrid, 64 channels, pool 3, RNN 64, attention 64/1/256, bf16),
   runs ``Trainer.test()`` over 64 single-segment tasks (4 eval batches of 16
   episodes) and one ``predict_episode``, with the kernels' launch counts set
   to 0 just before each and read just after; the launches per eval batch
   and per prediction must be K1 2 (support, queries), K2 1 and K3 0, and
   K4 1 (block 0 of the one encoder pass; so on every eval path) and K5 3
   (blocks 1-3 in bf16; none in a float32 eval, none in training). Then
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
9. K2 backward phase: the closed-form VJP that K2's ``autograd.Function``
   runs in backward, against autograd through the plain version on the card
   (atol 1e-5) at the train step's head shapes (E=1 and a chunk of E=4),
   and its time beside the forward kernel's;
10. spec train phase: ``Trainer.train_epoch`` on the same 35 x 40 store and
   the flagship CPL configuration (lr 7e-4, l 2.022308, M 5, T 9.2361, bf16)
   at ``episode_batch: 1``, 2 epochs of 32 tasks, then ``validate()``; the
   launches per step must be K1 2, K2 1, K3 0; prints episodes/s and ms per
   step (median over the second epoch's steps, CUDA events), peak memory,
   the profiler's busy share and top ops over 4 more steps, and the losses,
   which must be finite; then K1's time per launch as the profiler saw it
   in the eval and train passes beside its graph-replay times;
11. accumulation phase: ``episode_batch: 8, episode_microbatch: 4`` (remat
   on), 3 steps: launches per step K1 2 x 2, K2 1 x 2, and every BatchNorm's
   ``num_batches_tracked`` moved once per chunk (not twice through the
   recompute);
12. APL phase and wav train phase (``Trainer.train_epoch``, 4 steps each;
   wav: launches per step K3 1, K2 1, K1 0);
13. train card-vs-CPU phase: one flagship step (E=1), float32 with TF32 off
   on the card against float64 on the CPU, with the same weights, episode,
   views, view permutations and CPL draws given as data and every dropout
   at p = 0 on both copies: loss, every gradient and every parameter after
   the Adam step compared;
14. multi-segment kernel cases, run after the phases 15-17 at the eval
   batch E each of them took: K1 on the flagship's queries at s_max 6 and
   36 ([E, 150 | 900, 128, 157]; bit-equal, one device op a call), K2 at
   150 and 900 query rows (flagship D 256, wav and plain D 64), K3 at the wav multi-segment eval batch
   (M = E x 25 x 7 x 157) and a 36-segment file, each against its plain
   version and timed as in 3;
15. multi-segment spec phases, ``configs/birdclef_{cpl,plain}.json`` as
   shipped (bf16): ``Trainer.test()`` with ``multi_segm`` on a seeded store
   of 35 classes x 40 items of 1-6 segments (flagship, 64 tasks, then the
   other two tie strategies over 16 tasks each), and on 12 classes x 10
   items of 1-36 segments (flagship and plain, 16 tasks, ``max_posterior``).
   Each prints the eval batch E the engine reckoned from the free memory,
   the peak of allocated memory over one batch (held below the engine's
   ``EVAL_PEAK_FACTOR`` x the reckoned block-0 bytes and its
   ``EVAL_MEMORY_SHARE`` of the free memory), episodes/s (median of 3 runs
   of 4 full batches) and a profiler pass; launches per batch K1 2, K2 1,
   K3 0 (plain: 0, 1, 0);
16. multi-segment card-vs-CPU phase: one float32 batch at E=2, s_max 6,
   same weights, episode and draws: scores within 1e-3, argmax agreement
   >= 99%, and the card's votes equal to the reference's host loop on the
   card's scores, exactly, for all three tie strategies;
17. multi-segment wav phase: the same on a seeded ``PackedWavStore`` of 35
   classes x 20 clips of 1-30 s (5-s segments, s_max 6): launches per
   batch K1 0, K2 1, K3 1, then card vs CPU at E=2;
18. ``cli.train_test`` phase: a 15-class 128x157 dataset written by the
   port's ``make_synthetic_dataset`` (5 classes per split, 5-way on each),
   1 run of 2 epochs x 16 tasks, 32 test tasks; ``result_run0.json`` must
   exist and its accuracy exceed 0.4 (5-way chance 0.2);
19. preprocessing phase: a seeded class-foldered ``.wav`` tree (15 classes
   x 12 clips of 1-20 s, a tone per class in noise) through
   ``wav_dir_to_npy`` -> ``npy_dir_to_var_spec`` (one K3 launch per file)
   -> ``compute_global_norm`` -> ``make_splits(counts=(5, 5, 5))`` ->
   ``compute_waveform_norm``, then ``cli.train_test`` on it with the
   flagship multi-segment config (accuracy above 0.4), and
   ``npy_dir_to_spec`` on fixed 5-s clips against K3's plain version;
20. WaveAugment (wav input, aug_num 3, the default chain, as bench.py:98-104
   trains it), on the 448 MB wav store: (a) ``Trainer.train_epoch`` at E=1
   for 2 epochs of 32 tasks with launches per step K1 0, K2 1, K3 1, ms per
   step, peak memory and a profiler pass, then the chain alone on the step's
   rows (its share of the step's device time, its top kernels), then one
   step with ``pitchshift_mode: "pv"`` and one with ``fuse_lowpass`` + time
   stretch + time inversion; (b) ``Trainer.test()`` at E=16 and
   ``predict_episode`` (launches K3 1, K2 1, K1 0 per batch and per
   prediction), and multi-segment ``test()`` on the wav store of 1-30 s
   clips at s_max 6 with the E the engine reckons (its chain's bytes
   included) and the peak held under its rule; (c) card against CPU: the
   chain on the same draws (each row within 1e-5 of its input's RMS), one
   eval batch at E=2, and one train step, card float32 against CPU float64
   (gradients within 1e-1 of the largest |g|: see WAVAUG_TRAIN_GRAD_REL);
21. model variants on the spec store: one train step and one eval batch of
   StandardCNN, the relation head (K2 0 launches) and
   ``bn_per_view_group`` (E=8 in chunks of 4, every BatchNorm moved once per
   chunk), launches asserted;
22. K3 at the WaveAugment shapes (M = 31 400 for a train step, 502 400 for
   an eval batch of 16), against its plain version and timed as in 3;
23. host-resident streaming, the same seeded stores loaded a second time as
   host stores (``HostStore``, ``WavHostStore``: episodes drawn on the host,
   gathered into pinned buffers, copied on a copy stream while the card
   runs the previous step), each beside its device-store phase of this run:
   (a) ``train_epoch`` from a bf16 ``HostStore`` of the 35 x 40 store, E=1
   (2 epochs of 32 tasks) and E=8 in chunks of 4 (3 steps): launches per
   step K1 2, K2 1, K3 0, ms per step and episodes/s, H2D bytes per step,
   the copy's own time (CUDA events on the copy stream), the busy share
   under the profiler; (b) ``Trainer.test()`` at E=16 (64 tasks) and one
   ``predict_episode``, and multi-segment ``test()`` with
   ``configs/birdclef_cpl.json`` on bf16 host copies of the s_max 6 and 36
   stores at the E the engine reckons: launches per batch K1 2, K2 1, K3 0,
   rates, bytes and copy time per batch; (c) a float16 ``WavHostStore`` of
   the 448 MB clip store: ``test()`` at E=16, ``train_epoch`` at E=1 (2
   epochs of 32 tasks), and multi-segment ``test()`` on the 1-30 s store
   at s_max 6: launches K1 0, K2 1, K3 1; (d) staging integrity: a checksum
   of every batch as it arrives on the card, for one host-fed epoch and one
   host-fed eval run, read back at the end and held exactly against the same
   batches regenerated on the host from the same Generator; (e) the native
   packer: a seeded tree of 1 400 spec files packed to float32 and bfloat16
   by the packer and by the numpy path, bit-equal, files/s and GB/s of both;
24. entry points, after the ``cli.train_test`` phase, in a directory under
   ``build/``: (a) ``cli.make_synthetic_dataset.main`` writes a 15-class
   128x157 set (5 classes per split) and ``cli.run_sweep.main`` runs
   ``configs/esc50_apl.json`` + ``configs/model_config_esc50.json`` on it
   over ``--key angle --values 0 30 --runs 2`` (2 epochs x 16 tasks at E=1,
   32 test tasks, bf16): launches per train step K1 2, K2 1, K3 0 (each
   step's counts read around it), the folders ``esc50_apl_angle=0`` and
   ``=30`` with ``result_run0/1.json``, and
   ``cli.aggregate_results.main([root, "--sweep", "angle", "--json"])``
   giving 2 groups of 2 runs whose accuracies are the result files' and
   above 0.4; (b) one sweep folder's ``model.ckpt`` through
   ``cli.convert_checkpoint`` to the JAX package's format and back: every
   tensor bit-equal but the BatchNorm counters (dead state the JAX format
   lacks: back as 0), ``Trainer.test()`` (64 tasks, E=16, one seed) on both
   weights with equal accuracy and one batch's scores within 1e-6, and
   ``train/checkpoint.py::load_model`` refusing the JAX file; (c) the
   classifier API on those weights: the views of one 5-way 5-shot 25-query
   episode by K1 from fixed draws, ``PrototypicalNetworks``'
   ``process_support_set`` and call against the model's own forward (K2)
   on the same views (scores within 1e-3, equal argmax; K2 once per encode
   call), the same in float32 card vs CPU (1e-3, argmax >= 99%), and
   ``ContrastivePrototypicalNetworks.contrastive_forward`` with a fixed
   permutation; (d) ``Trainer.profile_epoch`` over 8 steps writes a Chrome
   trace that names K1's and K2's kernels;
25. data parallelism, after the E=8 accumulation phase: (a) one rank in an
   NCCL process group: 4 steps of the flagship at E=8 in chunks of 4 with
   remat in float32 (TF32 off) against the plain Trainer from the same seed
   (epoch loss, every parameter, the running statistics), then in bf16 with
   launches per step K1 4, K2 2, K3 0, ms per step beside the plain E=8/4
   phase, NCCL's kernels and device time per step (one rank's all-reduce may
   launch none), and ``test()`` over 64
   tasks equal to the plain Trainer's; (b) two ranks on the one card over
   gloo on CUDA tensors, ``parallel/dryrun.py::dryrun_multichip`` at the
   flagship's widths in float32, E=8 (4 per rank): one step's loss,
   gradients and running statistics against one process's E=8 step on the
   same episodes and draws, 4 steps, a gathered 32-task eval against one
   process replaying each rank's draws, launches per rank and step K1 2,
   K2 1, K3 0;
26. bf16, the shipped configs' precision, after the float32 card-vs-CPU
   phases (spec, then wav): the flagship at 128x157 in bf16 and in float32,
   on the card and in the port on the CPU, from the same weights, episodes
   and draws: one spec eval batch at E=2 (K1 2, K2 1), one train step at
   E=1 (K1 2, K2 1) and one wav eval batch at E=2 (K3 1, K2 1), each
   kernel's input dtype recorded. Each quantity prints the card-bf16 vs
   CPU-bf16 deviation beside card-bf16 vs card-float32 and CPU-bf16 vs
   CPU-float32; the card's is held within ``BF16_C`` x the CPU's (scores,
   running statistics, gradient shares over the leaves) and under caps
   relative to the quantity's scale (``BF16_*``);
27. ``--resume`` on the card, after the ``cli.train_test`` phase: the
   flagship at E=1 on a split of a synthetic dataset, 2 epochs of 8 tasks
   straight through against 1 epoch, a resume checkpoint and 1 resumed
   epoch from the same seed: step, generator and epoch equal, parameters
   within 2 lr a step, validation accuracy within ``RESUME_VAL_ATOL``;
28. prints ``{"kernels": [...]}`` (K1-K5, each with its bound, times and
   its launches on every path the run took) and, last, the
   ``{"ok": true, ...}`` line;
29. the parity runbook, after the ``--resume`` phase, in a directory under
   ``build/``: ``scripts/torch_port_parity_runbook.py --dry-run``
   in-process over the 15 shipped configs (each on its fabricated split, 2
   epochs of 4 tasks, 8 test tasks, bf16): return code 0, each cell's
   accuracy finite, launches per train step and per eval batch K1 2, K2 1,
   K3 0 (the plain configs, SpecAugment off: K1 0), and each multi-segment
   cell's peak over one eval batch under ``EVAL_PEAK_FACTOR`` x its
   reckoned block-0 bytes; prints each cell's line and the phase's seconds;
30. the full protocol cut to ``--epochs 3 --tasks 16 --test-tasks 64``:
   ``scripts/torch_port_full_protocol.py`` in-process, one single-segment
   and one multi-segment run in bf16 through ``cli.train_test``:
   ``result_run0.json`` of both and ``summary.json`` with the JAX script's
   keys and the port's, launches per train step and eval batch K1 2, K2 1,
   K3 0, the test run on the weights of the run's ``model.ckpt`` (the
   best-model reload), test accuracy above 0.4;
31. the two dataset-scale drivers at reduced depth, after the full
   protocol, in a directory under ``build/``:
   ``scripts/torch_port_nsynth_scale.py`` in-process at NSynth's 1 006
   classes and 128x126 over 40 000 items (``long_tail_counts`` needs 20 a
   class: at least 20 120) and ``scripts/torch_port_wav_scale.py`` at
   BirdClef's config over 3 000 items at ``--scale`` 1.0 (2.7 GB, s_max 36:
   ``--scale`` shortens the clips and not the 5-s segments, so 0.1 would
   stop at s_max 4), with each driver's assertions (launches per train
   step and per eval batch K1 2 / K2 1 / K3 0 on both NSynth placements and
   K1 0 / K2 1 / K3 1 on the wav run, a finite loss, accuracies in [0, 1],
   host mode on the wav store) and ``sampling_flat``, the placements'
   store classes and s_max 36 held here;
32. the JAX repo's last ten drivers at reduced depth, after the
   dataset-scale drivers, in-process in a directory under ``build/``: the
   accuracy A/B's "ours" arm (``torch_port_ab_vs_reference.py``, seed 0, 2
   epochs x 4 tasks, 16 test tasks, band gain 1.2, single and multi-segment,
   then ``--report``), the calibration at one gain, the three deviation
   A/Bs (one seed each, full scale), and the seven anatomy and probe
   drivers (step anatomy at E=1 and E=8 in chunks of 4, 5 steps a stage;
   the conv stack's six cells and the BatchNorm fold at 5 iterations; the
   wav path's full and ``-gain`` variants; predict latency; both store
   dtypes at E=1; the kernel A/B), each driver's own assertions, and the
   launches of every train step and eval batch they ran held here: K1 2,
   K2 1, K3 0 (a chunk) on the SpecAugment configs, K1 0, K2 1, K3 1 on
   the wav configs;
33. ``scripts/torch_port_bench.py`` (the port's ``bench.py``) in default
   mode, after the ported drivers: the reference's per-episode loop on the
   card, the flagship's E=1 train rate, a 128-task eval, the step's FLOP
   count (on the CPU) and the matmul roof; its one JSON line parsed and
   printed, ``bench.py``'s headline keys and the port's, ``value`` and
   ``vs_baseline`` above 0, ``mfu`` and ``fraction_of_matmul_roof`` in
   (0, 1.05], launches per headline step and eval batch K1 2, K2 1, K3 0,
   the entry points' TF32 flags back after the baseline's defaults; then
   the set-up's ``entry`` (``__graft_entry__.entry``'s counterpart, the
   flagship's eval forward on one episode batch) on the card: finite scores
   of shape [1, 25, 5];
34. K4 (eval block 0: conv, folded bias, max-pool, ReLU) at the main path's
   [200, 1, 128, 157], [3 700, 1, 128, 157] and [200, 1, 128, 126], bf16 and
   float32, held to its plain version within the rounding bound of
   ``tests/test_torch_port_cuda.py``, one node in a CUDA graph captured from
   a call, timed beside its bound on float32 FMAs and, in bf16, on the
   tensor cores (the 9 taps padded to K = 16: there the bytes bound the
   pass), its plain version and today's cuDNN conv + bias ``add_`` +
   max-pool + ReLU. Every eval phase asserts K4's launches (one a batch, a
   prediction and a classifier encode) and every train phase none. It runs last, so its plain version's 9.5-19 GB
   maps stay out of the other phases' memory;
35. K5 (eval blocks 1-3: a 3x3 conv over 64 channels on the tensor cores,
   folded bias, max-pool, ReLU) at the flagship's 42x52, 14x17 and 4x5
   maps of an eval batch (200) and a multi-segment batch (11 100), held to
   its plain version within the same rounding bound, one node in a CUDA
   graph, timed beside its bound on the tensor cores and on its bytes, its
   plain version and today's cuDNN conv + bias ``add_`` + max-pool + ReLU
   on the NCHW map. Every eval phase asserts K5's launches (3 a batch, a
   prediction and a classifier encode in bf16) and every train phase
   none.

The list goes by topic; ``main`` runs the spec phases first, then the wav
phases (one waveform store on the card at a time), then the CLIs and the
preprocessing; each host-fed phase runs after its device-store phase. The
card is resolved as every entry point resolves it (``device.py``: TF32 off
for cuBLAS and cuDNN); the script sets no precision flag of its own. Any failure raises and exits non-zero. Exits non-zero without a result when
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
BF16_DENSE_FLOPS = 989.4e12  # H100 SXM dense bf16 on the tensor cores: the whole step's mfu
REPO = os.path.dirname(os.path.abspath(__file__))

N_MELS, N_FRAMES, N_BINS = 128, 157, 513
NSYNTH_FRAMES = 126  # NSynth's 4-s notes
SR, CLIP = 16000, 80000  # 5-s clips: 1 + 80000 // 512 = 157 frames
N_WAY, K_SHOT, K_QUERY = 5, 5, 5
EVAL_BATCH = 16
TEST_TASKS = 64
# launches of K1, K2, K3 per eval batch, per prediction and per train step (or chunk)
SPEC_LAUNCHES = [2, 1, 0]
PLAIN_LAUNCHES = [0, 1, 0]  # no SpecAugment
WAV_LAUNCHES = [0, 1, 1]
MULTISEG_TIE_TASKS = 16  # per other tie strategy
S36_TASKS = 16
TIMED_BATCHES, TIMED_RUNS = 4, 3  # multi-segment rates: full batches per run, runs
TRAIN_TASKS = 32
K2_BWD_ATOL = 1e-5  # closed form vs autograd through the plain version, both f32
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3  # of each tensor's largest |g|
# a conv bias ahead of a train-mode BatchNorm, which removes its mean, has
# a gradient of zero but for rounding: held to this share of its conv
# weight's largest |g|
BN_BIAS_NOISE = 1e-2
GRAPH_CALLS, GRAPH_REPLAYS = 20, 5
K1_TOL = 0.0  # the same separately rounded f32 ops as the plain version, in f32 and bf16
K2_ATOL, K2_RTOL = 1e-4, 1e-5  # another summation order than the plain matmul
K3_ATOL_DB = 1e-3  # the same f32 products summed in another order, then log10
# K4 against its plain version, per pooled value, with S the largest sum of
# |tap| x |input| over its window's conv outputs: (atol over S, rtol);
# tests/test_torch_port_cuda.py::assert_block0_close says why
K4_TOL = {"float32": (2.0 ** -19, 2.0 ** -22), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
K4_CASES = (("flagship eval batch", 200, 157), ("multi-segment episode, s_max 36", 3700, 157),
            ("nsynth eval batch", 200, NSYNTH_FRAMES))
K4_CHANNELS, K4_POOL = 64, (3, 3)
K4_PROFILE_ATTEMPTS = 5
# K4's bf16 products are exact in float32 and summed in float32, which is
# what the tensor cores compute: at that rate, with the 9 taps padded to an
# mma's K of 16, the pass is bound by its bytes
K4_MMA_K = 16
# K5 (eval blocks 1-3, bf16) against its plain version: the same bound as
# K4's in bf16 (tests/test_torch_port_cuda.py::assert_blocks_close)
K5_TOL = (2.0 ** -7, 2.0 ** -7)
# blocks 1-3 of the flagship's 128x157 at an eval batch of 200 maps and a
# multi-segment batch of 3 episodes at s_max 36 (11 100 maps)
K5_CASES = (("eval batch, block 1", 200, 42, 52), ("eval batch, block 2", 200, 14, 17),
            ("eval batch, block 3", 200, 4, 5), ("multi-segment batch, block 1", 11100, 42, 52),
            ("multi-segment batch, block 2", 11100, 14, 17), ("multi-segment batch, block 3", 11100, 4, 5))
K5_CHANNELS, K5_POOL = 64, (3, 3)
SLICE_ATOL, SLICE_ARGMAX_AGREE = 1e-3, 0.99
WAV_MEAN, WAV_STD = 20.0, 5.0  # roughly z-scores the online log-mel of the seeded clips
# WaveAugment as bench.py:98-104 trains it: the default chain, 3 augmented copies
WAVEAUG = {"use": True, "aug_num": 3}
# the knobs tests/test_knob_trainstep.py:86-100 trains, one step each
WAVEAUG_KNOBS = {
    "pv": {"pitchshift_mode": "pv", "pitchshift_p": 1.0},
    "fuse_lowpass": {"fuse_lowpass": True, "timestretch_p": 0.7, "timeinversion_p": 0.5},
}
CHAIN_RMS_TOL = 1e-5  # card (cuFFT) vs CPU chain on the same draws, of each input row's RMS
# a wav + WaveAugment train step, card float32 vs CPU float64: the filters'
# exact stop bands put the log-mel at float32 FFT rounding noise beside the
# log's eps, and the conv stack's gradients are that ill-conditioned (the
# port's float32 step is 1.3e-2 of the largest |g| off float64 on the CPU,
# tests/test_torch_port_train.py)
WAVAUG_TRAIN_GRAD_REL = 1e-1


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
    kernels, ops, collectives = {}, {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):  # the program's spans and their device mirrors
            continue
        us = float(getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0))
        if "all_reduce" in evt.key or "allreduce" in evt.key:  # the host's collective calls
            collectives[evt.key] = evt.count
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
        nccl_us=sum(t for k, (t, _) in kernels.items() if "nccl" in k.lower()),
        nccl_kernels=sum(n for k, (_, n) in kernels.items() if "nccl" in k.lower()),
        all_reduce_calls=collectives,
        top_kernels_us_calls=[[k[:80], t, n] for k, (t, n) in top],
        top_ops_device_us_calls=[[k[:80], t, n] for k, (t, n) in top_ops],
    )


def device_kernels(fn, attempts: int = 3) -> list:
    """Names of the device activities (kernels, copies, fills) that one call
    of ``fn`` runs, under ``torch.profiler``, after a warm-up call. A trace
    that holds no device activity at all is the profiler's loss, not the
    call's (every ``fn`` here launches at least one kernel, which its
    counter shows), so such a trace is taken again, up to ``attempts``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(attempts):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = []
        for evt in prof.key_averages():
            if str(getattr(evt, "device_type", "")).endswith("CUDA") and not getattr(evt, "is_user_annotation", False):
                names += [evt.key] * evt.count
        if names:
            break
    return names


def graph_device_ops(fn) -> list:
    """The device ops one call of ``fn`` puts on the stream, read off a CUDA
    graph captured from it: each node's type from the driver ("kernel",
    "memcpy", "memset", ...). A view of the call that does not depend on
    the profiler's trace."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}

    def ok(status, what):
        if status != 0:
            raise RuntimeError(f"{what}: CUDA driver error {status}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        out.append(kinds.get(kind.value, f"type {kind.value}"))
    return out


def episode_to_cpu(ep):
    return type(ep)(**{f.name: None if getattr(ep, f.name) is None else getattr(ep, f.name).cpu()
                       for f in dataclasses.fields(ep)})


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


def k1_case(case, args, **extra):
    """K1 on ``args`` against its plain version (equal to the bit, in f32
    and bf16: the same separately rounded ops), asserting that one call runs
    K1 and nothing else on the device (the masks reach it as views of the
    bool tensors), then timed as the other kernels are."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import specaugment

    spec = args[0]
    out = specaugment.views_cuda(*args)
    ref = specaugment.views_reference(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if err != K1_TOL:
        raise AssertionError(f"K1 {case} {spec.dtype} at {list(spec.shape)} disagrees with its plain version: "
                             f"max error {err}")
    b_ms, b_by = bound_ms(nbytes(*args[:4]) + nbytes(out), 3 * out.numel() / 4)
    del out, ref
    # both views of one call: the profiler's kernel names (a trace it lost
    # comes back empty) and the nodes of a graph captured from the call,
    # during which the wrapper counts its one launch
    device_ops = device_kernels(lambda: specaugment.views_cuda(*args))
    before = specaugment.views_cuda.launches
    graph_ops = graph_device_ops(lambda: specaugment.views_cuda(*args))
    launched = specaugment.views_cuda.launches - before
    if (graph_ops != ["kernel"] or launched != 2  # the warm-up call and the captured one
            or device_ops and (len(device_ops) != 1 or "views_kernel" not in device_ops[0])):
        raise AssertionError(f"K1 {case} {spec.dtype}: one call ran {device_ops} on the device (profiler), "
                             f"{graph_ops} (graph nodes), {launched} launches in two calls")
    plan = specaugment.views_plan(*spec.shape, spec.element_size(),
                                  torch.cuda.get_device_properties(spec.device).multi_processor_count,
                                  spec.data_ptr() % 16 == 0)
    return dict(case=case, shape=list(spec.shape), **extra, max_abs_err=err, tolerance=K1_TOL,
                device_ops_per_call=device_ops, graph_nodes_per_call=graph_ops, vec=plan.vec, rows=plan.rows, blocks=plan.blocks,
                ms=graph_ms(lambda: specaugment.views_cuda(*args)),
                plain_ms=graph_ms(lambda: specaugment.views_reference(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def kernel_phase(dev):
    """The launch floor, then K1, K2 and K3 against their plain versions at
    the main path's shapes."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import SpecAugParams
    from audio_few_shot_learning_tpu_torch.ops import protohead, specaugment

    gen = torch.Generator(device=dev).manual_seed(0)
    params = SpecAugParams(use=True, mask_param=16, W=22, num_mask=1, mask_value=0.0, p=0.282)
    rows = {"launch_floor_ms": launch_floor_ms(dev)}

    # K1: one launch per view call; the eval batch makes E=16 episodes x 25
    # items, a train step E=1. Then NSynth's 4-s notes (128x126,
    # configs/nsynth_cpl.json's SpecAugment) at a train step's E=1 and an
    # eval batch's E=16, as the dataset-scale phase runs them.
    with open(os.path.join(REPO, "configs", "nsynth_cpl.json")) as f:
        nsynth = SpecAugParams.from_dict(json.load(f)["specaug_params"])
    k1 = []
    for case, e, frames, prm in (("flagship eval batch", EVAL_BATCH, N_FRAMES, params),
                                 ("flagship train step", 1, N_FRAMES, params),
                                 ("nsynth train step", 1, NSYNTH_FRAMES, nsynth),
                                 ("nsynth eval batch", EVAL_BATCH, NSYNTH_FRAMES, nsynth)):
        for dtype in (torch.float32, torch.bfloat16):
            spec = torch.randn((e, N_WAY * K_SHOT, N_MELS, frames), generator=gen, device=dev).to(dtype)
            ys, tm, fm = specaugment.draw_views_params(gen, prm, e, N_WAY * K_SHOT, N_MELS, frames, dev)
            args = (spec, ys, tm, fm, prm.mask_value)
            k1.append(k1_case(case, args, dtype=str(dtype).replace("torch.", "")))
    rows["K1"] = k1

    # K2: one launch per eval batch, on the inputs as the path gives them:
    # support and queries are slices of the attention output [E, S+Q, D],
    # labels int64 expanded over the episodes (stride 0). Flagship spec E=16,
    # S=Q=25, D=V*64=256, N=5; the wav path's D=64 (one view); a predict
    # episode (E=1); a ragged case (N=7, uneven classes, one empty class);
    # the classifier API's one-row dummy episodes: a support encode (S=25,
    # Q=1: the q_tile=1 plan) and a query encode (S=1, Q=25, N=1).
    k2 = []
    support = np.repeat(np.arange(N_WAY), K_SHOT)
    queries = N_WAY * K_QUERY
    for name, n_way, labels_np, e, d, q in (
        ("flagship", N_WAY, support, EVAL_BATCH, 4 * 64, queries),
        ("wav", N_WAY, support, EVAL_BATCH, 64, queries),
        ("predict", N_WAY, support, 1, 4 * 64, queries),
        ("ragged", 7, np.array([0] * 9 + [1] * 2 + [2] * 5 + [3] * 1 + [4] * 4 + [5] * 4),
         EVAL_BATCH, 4 * 64, queries),
        ("classifier support encode", N_WAY, support, 1, 4 * 64, 1),
        ("classifier query encode", 1, np.zeros(1, np.int64), 1, 4 * 64, queries),
    ):
        s = len(labels_np)
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
        q_tile = protohead.head_plan(e, s, q, d, n_way).q_tile
        k2.append(dict(case=name, e=e, s=s, q=q, d=d, n_way=n_way, q_tile=q_tile, max_abs_err=err,
                       tolerance=[K2_ATOL, K2_RTOL], device_ops_per_call=device_ops, ms=ms,
                       plain_ms=plain, library_ms=library, bound_ms=b_ms, bound_by=b_by))
    rows["K2"] = k2
    rows["K3"] = k3_cases(dev, gen)
    rows["K4"] = k4_device_ops(dev)
    rows["K5"] = k5_device_ops(dev)
    return rows


def k4_inputs(gen, dev, maps, frames, dtype):
    """Block 0's input [maps, 1, 128, frames], folded weight and bias, in ``dtype``."""
    import torch

    x = (2 * torch.randn((maps, 1, N_MELS, frames), generator=gen, device=dev)).to(dtype)
    weight = (torch.randn((K4_CHANNELS, 1, 3, 3), generator=gen, device=dev) / 3).to(dtype)
    bias = (torch.randn(K4_CHANNELS, generator=gen, device=dev) / 2).to(dtype)
    return x, weight, bias


def k4_device_ops(dev) -> dict:
    """The profiler's view of one K4 call at each of ``K4_CASES``, bf16 and
    float32: one device op, ``block0_conv_kernel``. Taken here, at the start
    of the run (K4's own phase runs last), and retried as ``device_kernels``
    retries; a trace that stays empty fails the run."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import convblock

    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for case, maps, frames in K4_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{case} {str(dtype).replace('torch.', '')}"
            x, weight, bias = k4_inputs(gen, dev, maps, frames, dtype)
            ops = device_kernels(lambda: convblock.block0_cuda(x, weight, bias, K4_POOL), attempts=K4_PROFILE_ATTEMPTS)
            if len(ops) != 1 or "block0_conv_kernel" not in ops[0]:
                raise AssertionError(f"K4 {name}: one call ran {ops} on the device (profiler, "
                                     f"{K4_PROFILE_ATTEMPTS} traces)")
            out[name] = ops
            del x, weight, bias
    return out


def k4_phase(dev, device_ops):
    """K4 (eval block 0) against its plain version at the main path's shapes,
    one device op a call (``device_ops``: the profiler's view, taken in the
    kernel phase; here the nodes of a CUDA graph captured from a call), timed
    beside its bound on float32 FMAs and, in bf16, on the tensor cores, its
    plain version and today's cuDNN conv + bias add_ + max-pool + ReLU as
    the library's."""
    import torch
    import torch.nn.functional as F

    from audio_few_shot_learning_tpu_torch.ops import convblock

    gen = torch.Generator(device=dev).manual_seed(4)
    ph, pw = K4_POOL
    rows = []
    for case, maps, frames in K4_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            x, weight, bias = k4_inputs(gen, dev, maps, frames, dtype)
            out = convblock.block0_cuda(x, weight, bias, K4_POOL)
            ref = convblock.block0_reference(x, weight, bias, K4_POOL)
            s_sum = F.max_pool2d(F.conv2d(x.float().abs(), weight.float().abs(), padding=1), K4_POOL)
            atol, rtol = K4_TOL[name]
            err = (out.float() - ref.float()).abs()
            over = (err - atol * s_sum - rtol * ref.float().abs()).max().item()
            max_err = err.max().item()
            del ref, s_sum, err
            if over > 0:
                raise AssertionError(f"K4 {case} {name} disagrees with its plain version: max error {max_err}, "
                                     f"{over} beyond the rounding bound")

            def call():
                return convblock.block0_cuda(x, weight, bias, K4_POOL)

            before = convblock.block0_cuda.launches
            graph_ops = graph_device_ops(call)
            launched = convblock.block0_cuda.launches - before
            if graph_ops != ["kernel"] or launched != 2:  # the warm-up call and the captured one
                raise AssertionError(f"K4 {case} {name}: one call put {graph_ops} on the stream (graph nodes), "
                                     f"{launched} launches in two calls")
            calls = 2 if maps > 1000 else GRAPH_CALLS  # the plain version holds 9.5-19 GB a call at 3 700 maps
            hp, wp = N_MELS // ph, frames // pw
            flops = 2 * 9 * ph * pw * K4_CHANNELS * hp * wp * maps
            n_bytes = nbytes(x, weight, bias, out)
            b_ms, b_by = bound_ms(n_bytes, flops)
            mma = None
            if dtype == torch.bfloat16:
                t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops * K4_MMA_K / 9 / BF16_DENSE_FLOPS
                mma = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
            ms = graph_ms(call, calls=calls)
            plan = convblock.block0_plan(maps, N_MELS, frames, K4_CHANNELS, ph, pw)
            rows.append(dict(
                case=case, shape=[maps, 1, N_MELS, frames], dtype=name, channels=K4_CHANNELS, pool=list(K4_POOL),
                max_abs_err=max_err, tolerance=list(K4_TOL[name]),
                device_ops_per_call=device_ops[f"{case} {name}"], graph_nodes_per_call=graph_ops,
                pair=plan.pair, tile_rows=plan.tile_rows, blocks=plan.blocks, threads=plan.threads,
                smem_bytes=plan.smem_bytes, ms=ms,
                plain_ms=graph_ms(lambda: convblock.block0_reference(x, weight, bias, K4_POOL), calls=calls),
                library_ms=graph_ms(lambda: F.relu(F.max_pool2d(
                    F.conv2d(x, weight, padding=1).add_(bias[:, None, None]), K4_POOL)), calls=calls),
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms, gflop=flops / 1e9,
                bound_ms_tensor_cores=mma and mma[0], bound_by_tensor_cores=mma and mma[1],
                share_of_tensor_core_bound=mma and mma[0] / ms))
            del x, weight, bias, out
            torch.cuda.empty_cache()  # the plain version's 9.5-19 GB maps at 3 700 maps
    return rows


def k5_inputs(gen, dev, maps, h, w):
    """Block 1-3 input [maps, 64, h, w] as K4 or K5 leaves it (channels-last,
    non-negative), the folded weight and bias, bf16."""
    import torch

    x = torch.randn((maps, K5_CHANNELS, h, w), generator=gen, device=dev).abs().bfloat16().contiguous(
        memory_format=torch.channels_last)
    weight = (torch.randn((K5_CHANNELS, K5_CHANNELS, 3, 3), generator=gen, device=dev) / 24).bfloat16()
    bias = (torch.randn(K5_CHANNELS, generator=gen, device=dev) / 2).bfloat16()
    return x, weight, bias


def k5_device_ops(dev) -> dict:
    """The profiler's view of one K5 call at each of ``K5_CASES``: one device
    op, ``blocks_conv_kernel``, taken in the kernel phase as K4's is."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import convblock

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for case, maps, h, w in K5_CASES:
        x, weight, bias = k5_inputs(gen, dev, maps, h, w)
        ops = device_kernels(lambda: convblock.blocks_cuda(x, weight, bias, K5_POOL), attempts=K4_PROFILE_ATTEMPTS)
        if len(ops) != 1 or "blocks_conv_kernel" not in ops[0]:
            raise AssertionError(f"K5 {case}: one call ran {ops} on the device (profiler, {K4_PROFILE_ATTEMPTS} traces)")
        out[case] = ops
        del x, weight, bias
    return out


def k5_phase(dev, device_ops):
    """K5 (eval blocks 1-3) against its plain version at the main path's
    shapes, one device op a call (``device_ops``: the profiler's view, taken
    in the kernel phase; here the nodes of a CUDA graph captured from a
    call), timed beside its bound on the tensor cores (the conv's FLOPs over
    every conv output, 989.4 TFLOP/s) and on its bytes (input, weights and
    pooled output once), its plain version and today's cuDNN conv + bias
    add_ + max-pool + ReLU on the NCHW map as the library's."""
    import torch
    import torch.nn.functional as F

    from audio_few_shot_learning_tpu_torch.ops import convblock

    gen = torch.Generator(device=dev).manual_seed(5)
    atol, rtol = K5_TOL
    rows = []
    for case, maps, h, w in K5_CASES:
        x, weight, bias = k5_inputs(gen, dev, maps, h, w)
        out = convblock.blocks_cuda(x, weight, bias, K5_POOL)
        ref = convblock.blocks_reference(x, weight, bias, K5_POOL)
        s_sum = F.max_pool2d(F.conv2d(x.float().abs(), weight.float().abs(), padding=1), K5_POOL)
        err = (out.float() - ref.float()).abs()
        over = (err - atol * s_sum - rtol * ref.float().abs()).max().item()
        max_err = err.max().item()
        del ref, s_sum, err
        if over > 0:
            raise AssertionError(f"K5 {case} disagrees with its plain version: max error {max_err}, "
                                 f"{over} beyond the rounding bound")

        def call():
            return convblock.blocks_cuda(x, weight, bias, K5_POOL)

        before = convblock.blocks_cuda.launches
        graph_ops = graph_device_ops(call)
        launched = convblock.blocks_cuda.launches - before
        if graph_ops != ["kernel"] or launched != 2:  # the warm-up call and the captured one
            raise AssertionError(f"K5 {case}: one call put {graph_ops} on the stream (graph nodes), "
                                 f"{launched} launches in two calls")
        calls = 2 if maps > 1000 else GRAPH_CALLS
        flops = 2 * 9 * K5_CHANNELS * K5_CHANNELS * h * w * maps
        b_ms, b_by = bound_ms(nbytes(x, weight, bias, out), 0)
        t_ms = flops / BF16_DENSE_FLOPS * 1e3
        x_nchw = x.contiguous()
        ms = graph_ms(call, calls=calls)
        plan = convblock.blocks_plan(maps, h, w, *K5_POOL, torch.cuda.get_device_properties(dev).multi_processor_count)
        rows.append(dict(
            case=case, shape=[maps, K5_CHANNELS, h, w], dtype="bfloat16", pool=list(K5_POOL),
            max_abs_err=max_err, tolerance=list(K5_TOL), device_ops_per_call=device_ops[case],
            graph_nodes_per_call=graph_ops, mode=plan.mode, tile_px=plan.tile_px, rect=[plan.rr, plan.rc, plan.sr],
            stages=plan.stages, stage_bytes=plan.stage_bytes, tiles=plan.tiles, ctas=plan.ctas,
            smem_bytes=plan.smem_bytes, useful=plan.useful, ms=ms,
            plain_ms=graph_ms(lambda: convblock.blocks_reference(x, weight, bias, K5_POOL), calls=calls),
            library_ms=graph_ms(lambda: F.relu(F.max_pool2d(
                F.conv2d(x_nchw, weight, padding=1).add_(bias[:, None, None]), K5_POOL)), calls=calls),
            gflop=flops / 1e9, bound_ms_tensor_cores=t_ms, share_of_tensor_core_bound=t_ms / ms,
            bound_ms_bytes=b_ms, share_of_byte_bound=b_ms / ms))
        del x, x_nchw, weight, bias, out
        torch.cuda.empty_cache()
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
    hop = 512
    return [k3_case(dev, gen, *c) for c in (
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
    )]


def k3_case(dev, gen, case, flavor, clips, length, aligned=True):
    """K3 against its plain version on the power spectrogram of ``clips``
    rows of seeded noise, timed with its bound and the library calls."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import mel

    spec = mel.MelSpec(flavor)
    wav = 0.3 * torch.randn((clips, length), generator=gen, device=dev)
    pspec = mel.power_spectrogram(wav, pad_mode=spec.pad_mode)
    del wav
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
    del ref
    ms = graph_ms(lambda: mel.mel_log_cuda(*args, bands))
    plain = graph_ms(lambda: mel.mel_log_reference(*args))
    library = graph_ms(lambda: torch.log10(torch.matmul(pspec, fb)))
    m = pspec.numel() // N_BINS
    nnz = bands.weights.numel()
    # the work this filterbank needs: one multiply-add per nonzero weight
    b_ms, b_by = bound_ms(nbytes(pspec, fb, out), 2 * m * nnz)
    return dict(
        case=case, flavor=flavor, m=m, base_16b_aligned=aligned, max_abs_err=err,
        tolerance=K3_ATOL_DB, ms=ms, plain_ms=plain, library_ms=library, bound_ms=b_ms,
        bound_by=b_by, share_of_bound=b_ms / ms,
        bound_ms_dense_flops=2 * m * N_BINS * N_MELS / F32_FLOPS * 1e3,
        filterbank_nonzeros=nnz,
    )


def make_store(dev, host_dtype=None):
    """35 classes x 40 items of 128x157 seeded noise, f32 on the card (112
    MB), or with ``host_dtype`` the same segments in a HostStore."""
    from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore

    n_classes, per_class = 35, 40
    rng = np.random.default_rng(0)
    segments = rng.standard_normal((n_classes * per_class, N_MELS, N_FRAMES), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    if host_dtype:
        return HostStore.from_flat_arrays(segments, np.ones(len(labels), np.int64), labels, n_classes,
                                          dtype=host_dtype)
    return PackedStore.from_flat_arrays(
        segments, np.ones(len(labels), np.int64), labels, n_classes, device=dev
    )


def make_wav_store(dev, host_dtype=None):
    """35 classes x 40 clips of 5 s of seeded noise: 448 MB on the card, or
    with ``host_dtype`` the same clips in a WavHostStore."""
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    n_classes, per_class = 35, 40
    rng = np.random.default_rng(0)
    clips = 0.3 * rng.standard_normal((n_classes * per_class, CLIP), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    if host_dtype:
        return WavHostStore.pack(list(clips), labels, n_classes, mean=WAV_MEAN, std=WAV_STD, dtype=host_dtype)
    return PackedWavStore.pack(list(clips), labels, n_classes, mean=WAV_MEAN, std=WAV_STD, device=dev)


def flagship_dict(input_type="spec", waveaug=None, **tpu):
    """The flagship; ``waveaug`` turns WaveAugment on for wav input."""
    return {
        "encoder_name": "Hybrid", "use_attention": True, "use_contrastive": True,
        "input_type": input_type, "n_testing_tasks": TEST_TASKS,
        "specaug_params": {"use": True, "mask_param": 16, "W": 22, "num_mask": 1,
                           "mask_value": 0, "p": 0.282},
        "waveaug_params": waveaug or {"use": False},
        "test_query_augmentations": True,
        "tpu": {"eval_episode_batch": EVAL_BATCH, "compute_dtype": "bfloat16", **tpu},
    }


def flagship_exp(input_type="spec", waveaug=None, **tpu):
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict(flagship_dict(input_type, waveaug, **tpu))


def train_dict(input_type="spec", loss="cpl", tasks=TRAIN_TASKS, waveaug=None, over=None, **tpu):
    """The flagship training configuration (``__graft_entry__.py:25-65``:
    lr 7e-4, CPL with l 2.022308, M 5, T 9.2361; with ``loss="apl"`` the
    angular loss of ``configs/esc50_apl.json``: l 1.7235, 15 degrees,
    prototypes as anchors), ``tasks`` training tasks per epoch; ``over``
    replaces top-level keys (``encoder_name``, ``relation_head``)."""
    d = flagship_dict(input_type, waveaug, **tpu)
    aux = {"l_param": 2.022308, "cpl": {"use": True, "m_param": 5, "t_param": 9.2361},
           "angular": {"use": False}}
    if loss == "apl":
        aux = {"l_param": 1.7235, "cpl": {"use": False},
               "angular": {"use": True, "angle": 15, "prototypes_as_anchors": True}}
    d.update(lr=7e-4, n_training_tasks=tasks, num_epochs=2, train_query_augmentations=True,
             validation_query_augmentations=True, loss=aux, **(over or {}))
    return d


def train_exp(input_type="spec", loss="cpl", tasks=TRAIN_TASKS, waveaug=None, over=None, **tpu):
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict(train_dict(input_type, loss, tasks, waveaug, over, **tpu))


def multiseg_launches(i, flagship, s36, wav) -> dict:
    """Kernel ``i``'s launches on the multi-segment paths (total, per batch)."""
    out = dict(launches_multiseg_s6=flagship["launches"][i],
               launches_per_multiseg_batch_s6=flagship["launches_per_batch"][i])
    for name, run in s36.items():
        out[f"launches_multiseg_s36_{name}"] = run["launches"][i]
        out[f"launches_per_multiseg_batch_s36_{name}"] = run["launches_per_batch"][i]
    if wav is not None:
        out["launches_multiseg_wav"] = wav["launches"][i]
        out["launches_per_multiseg_batch_wav"] = wav["launches_per_batch"][i]
    return out


def kernel_counters():
    from audio_few_shot_learning_tpu_torch.utils.profiling import kernel_counters as counters

    return counters()


def block0_counter():
    """K4's wrapper, which counts its launches in ``.launches`` (apart from
    K1-K3's counters, whose lists every phase compares whole)."""
    from audio_few_shot_learning_tpu_torch.ops import convblock

    return convblock.block0_cuda


def blocks_counter():
    """K5's wrapper (eval blocks 1-3), which counts its launches in ``.launches``."""
    from audio_few_shot_learning_tpu_torch.ops import convblock

    return convblock.blocks_cuda


def k5_per_forward(model) -> int:
    """K5's launches in one eval forward of ``model``'s conv encoder: one for
    each of blocks 1-3 in bf16 with the BatchNorm folded (a float32 eval
    keeps cuDNN there)."""
    import torch

    enc = model.backbone.encoder
    return sum(b.fold_bn_eval for b in list(enc.conv_encoder)[1:]) if enc.compute_dtype == torch.bfloat16 else 0


def serve_phase(dev, store, input_type, expected, waveaug=None):
    """Trainer.test() and predict_episode on the flagship model, bf16, with
    the launches of K1, K2, K3 per eval batch and per prediction asserted,
    and K4's (one a batch and a prediction)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels, k4, k5 = kernel_counters(), block0_counter(), blocks_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(flagship_exp(input_type, waveaug), ModelConfig(), store, test_store=store,
                      device=dev, seed=0)
    trainer.evaluate(store, EVAL_BATCH, N_WAY, K_SHOT, K_QUERY, True)  # warm-up: cuDNN plans

    for k in (*kernels, k4, k5):
        k.launches = 0
    result = trainer.test()
    eval_launches = [k.launches for k in kernels]
    k4_eval, k5_eval, k5_want = k4.launches, k5.launches, k5_per_forward(trainer.model)
    eval_s = [trainer.last_eval_seconds]
    acc = result["mean_accuracy"]
    if not (np.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"test accuracy out of range: {result}")
    n_batches = TEST_TASKS // EVAL_BATCH
    per_batch = [n / n_batches for n in eval_launches]
    if per_batch != expected or k4_eval != n_batches or k5_eval != k5_want * n_batches:
        raise AssertionError(
            f"{input_type} eval path launched K1, K2, K3 {per_batch} times per batch "
            f"({eval_launches} in {n_batches} batches; K4 {k4_eval}, K5 {k5_eval}); expected {expected}, "
            f"K4 1 and K5 {k5_want}"
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
    for k in (*kernels, k4, k5):
        k.launches = 0
    t0 = time.perf_counter()
    pred, scores = trainer.predict_episode(support, labels, query)
    predict_ms = [1e3 * (time.perf_counter() - t0)]
    predict_launches = [k.launches for k in kernels]
    k4_predict, k5_predict = k4.launches, k5.launches
    if scores.shape != (N_WAY * K_QUERY, N_WAY) or not np.isfinite(scores).all():
        raise AssertionError(f"predict scores malformed: {scores.shape}")
    if pred.shape != (N_WAY * K_QUERY,) or pred.min() < 0 or pred.max() >= N_WAY:
        raise AssertionError(f"predictions malformed: {pred}")
    if predict_launches != expected or k4_predict != 1 or k5_predict != k5_want:
        raise AssertionError(
            f"{input_type} predict path launched K1, K2, K3 {predict_launches} times, K4 {k4_predict}, "
            f"K5 {k5_predict}; expected {expected}, K4 1 and K5 {k5_want}"
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
        predict_launches=predict_launches, k4_eval_launches=k4_eval,
        k4_launches_per_eval_batch=k4_eval / n_batches, k4_launches_per_predict=k4_predict,
        k5_eval_launches=k5_eval, k5_launches_per_eval_batch=k5_eval / n_batches, k5_launches_per_predict=k5_predict,
        eval_profile=eval_profile, predict_profile=predict_profile,
    )


def card_vs_cpu_phase(dev, store, input_type, waveaug=None, e=EVAL_BATCH):
    """One float32 eval batch (E=16, as the timed path; E=2 with
    WaveAugment), same weights, episodes and augmentation draws, card
    (kernels) vs CPU (plain versions)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    exp = flagship_exp(input_type, waveaug, compute_dtype="float32", eval_episode_batch=e)
    card = Trainer(exp, ModelConfig(), store, device=dev, seed=3)
    cpu = Trainer(exp, ModelConfig(), store, device="cpu", seed=3)  # the store only gives shapes
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})

    ep = sample_episode(torch.Generator(device=dev).manual_seed(5), store, N_WAY, K_SHOT, K_QUERY, e)
    ep_cpu = episode_to_cpu(ep)
    draws_card = draws_cpu = None
    if input_type == "spec":
        g = torch.Generator().manual_seed(6)
        draws_cpu = tuple(
            draw_views_params(g, exp.specaug_params, e, n, N_MELS, N_FRAMES, "cpu")
            for n in (N_WAY * K_SHOT, N_WAY * K_QUERY)
        )
        draws_card = tuple(tuple(x.to(dev) for x in d) for d in draws_cpu)
    elif waveaug:
        g = torch.Generator().manual_seed(6)
        n = exp.waveaug_params.aug_num
        draws_cpu = tuple(cpu.waveaugment.draw(g, (e, n, k), CLIP, "cpu")
                          for k in (N_WAY * K_SHOT, N_WAY * K_QUERY))
        draws_card = tuple(chain_to(d, dev) for d in draws_cpu)
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


def chain_to(draws, dev, dtype=None):
    """WaveAugment draws moved to ``dev`` (floats cast to ``dtype``)."""
    return {name: {k: v.to(dev, dtype) if dtype is not None and v.is_floating_point() else v.to(dev)
                   for k, v in d.items()} for name, d in draws.items()}


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


def k2_backward_phase(dev):
    """K2's backward (the closed-form VJP) against autograd through the
    plain version on the card, at the train step's head: E=1 and a chunk of
    E=4, S=Q=25, D=4x64, N=5, support and queries slices of one tensor."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import protohead

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for e in (1, 4):
        s = q = N_WAY * K_SHOT
        fused = torch.randn((e, s + q, 4 * 64), generator=gen, device=dev)
        sup, qry = fused[:, :s], fused[:, s:]
        lab = torch.arange(N_WAY, device=dev).repeat_interleave(K_SHOT).expand(e, -1)
        cot = torch.randn((e, q, N_WAY), generator=gen, device=dev)
        scores = protohead.episode_scores_cuda(sup, lab, qry, N_WAY)
        g_sup, g_qry = protohead.episode_scores_backward(cot, sup, lab, qry, scores, N_WAY)
        a, b = sup.detach().clone().requires_grad_(True), qry.detach().clone().requires_grad_(True)
        protohead.batched_episode_scores_reference(a, lab, b, N_WAY).backward(cot)
        torch.cuda.synchronize()
        err = max((g_sup - a.grad).abs().max().item(), (g_qry - b.grad).abs().max().item())
        if not err <= K2_BWD_ATOL:
            raise AssertionError(f"K2 backward at E={e} disagrees with autograd of the plain version: {err}")

        def plain_bwd():
            x, y = sup.detach().requires_grad_(True), qry.detach().requires_grad_(True)
            torch.autograd.grad(protohead.batched_episode_scores_reference(x, lab, y, N_WAY), (x, y), cot)

        rows.append(dict(
            e=e, max_abs_err=err, tolerance=K2_BWD_ATOL,
            forward_ms=graph_ms(lambda: protohead.episode_scores_cuda(sup, lab, qry, N_WAY)),
            backward_ms=graph_ms(lambda: protohead.episode_scores_backward(cot, sup, lab, qry, scores, N_WAY)),
            plain_forward_backward_ms=graph_ms(plain_bwd),
        ))
    return rows


def bn_counts(model) -> list:
    return [int(m.num_batches_tracked) for m in model.modules() if hasattr(m, "num_batches_tracked")]


def train_phase(dev, store, exp, expected, epochs=2, profile_steps=4, check_bn=False):
    """``Trainer.train_epoch`` for ``epochs`` epochs on ``store`` with the
    launches of K1, K2, K3 per step (per chunk: ``expected`` x chunks; K4
    none: train mode) and,
    with ``check_bn``, each BatchNorm's updates per chunk asserted; then
    ``validate()`` and a profiler pass over ``profile_steps`` more steps."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(exp, ModelConfig(), store, val_store=store, test_store=store, device=dev, seed=0)
    e = trainer.episode_batch
    chunks = e // (trainer.microbatch or e)
    steps = trainer.steps_per_epoch
    bn_before = bn_counts(trainer.model)
    k4, k5 = block0_counter(), blocks_counter()
    for k in (*kernels, k4, k5):
        k.launches = 0
    epochs_out = [trainer.train_epoch()]
    launches, k4_launches, k5_launches = [k.launches for k in kernels], k4.launches, k5.launches
    bn_moves = [b - a for a, b in zip(bn_before, bn_counts(trainer.model))]
    want = [n * chunks for n in expected]
    if [n / steps for n in launches] != want or k4_launches or k5_launches:
        raise AssertionError(
            f"train path launched K1, K2, K3 {launches} times in {steps} steps of {chunks} "
            f"chunk(s), K4 {k4_launches}, K5 {k5_launches}; expected {want} per step and K4, K5 0 (train mode)"
        )
    if check_bn and bn_moves != [steps * chunks] * len(bn_moves):
        raise AssertionError(
            f"BatchNorm statistics moved {bn_moves} times in {steps} steps of {chunks} chunks; "
            f"expected {steps * chunks} each (once per chunk)"
        )
    for _ in range(1, epochs):
        epochs_out.append(trainer.train_epoch())
    step_ms = trainer.last_step_ms  # the last epoch's
    for out in epochs_out:
        if not all(np.isfinite(out[k]) for k in ("loss", "fsl_loss", "cpl_loss")):
            raise AssertionError(f"non-finite training losses: {epochs_out}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    val = trainer.validate()
    if not (np.isfinite(val[0]) and 0.0 <= val[0] <= 1.0):
        raise AssertionError(f"validation accuracy out of range: {val}")

    def steps_fn():
        for _ in range(profile_steps):
            trainer.train_step(sample_episode(trainer.gen, store, N_WAY, K_SHOT, K_QUERY, e))

    prof = profile(steps_fn)
    med = float(np.median(step_ms))
    return dict(
        episode_batch=e, microbatch=trainer.microbatch, chunks=chunks,
        remat=trainer.exp.tpu.remat_enabled(), steps_per_epoch=steps, epochs=epochs_out,
        launches_first_epoch=launches, launches_per_step=[n / steps for n in launches],
        k4_launches_per_step=k4_launches / steps, k5_launches_per_step=k5_launches / steps, bn_updates_first_epoch=bn_moves, step_ms=step_ms, step_ms_median=med,
        train_episodes_per_s_median=1e3 * e / med, peak_mem_gb=peak,
        validate=dict(mean=val[0], std=val[1], seconds=trainer.last_eval_seconds),
        profile_steps=profile_steps, profile=prof,
    )


def train_card_vs_cpu_phase(dev, store, input_type="spec", waveaug=None, grad_rel=TRAIN_GRAD_REL):
    """One flagship train step (E=1) in float32 with TF32 off on the card
    (K1, K2 and its closed-form backward, cuDNN) against the same step in
    float64 on the CPU (plain versions): same weights, episode, views,
    permutations and CPL draws, every dropout at p = 0 on both. The CPU runs
    float64 because a float32 CPU step is itself off by up to 1.8e-3 of the
    largest |g| in blocks 0-1 (4M-term reductions), where the card's float32
    step is within 1.5e-4 of float64 (PERF.md, Findings). With wav input
    and WaveAugment the chain's draws are given as data and the chain and the
    log-mel run in float32 on both (the CPU's model in float64); gradients
    are held to ``grad_rel``."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.losses import draw_cpl_gumbel
    from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws, Trainer

    exp = train_exp(input_type, waveaug=waveaug, compute_dtype="float32", episode_batch=1)
    card = Trainer(exp, ModelConfig(), store, device=dev, seed=3)
    exp64 = train_exp(input_type, waveaug=waveaug, compute_dtype="float64", episode_batch=1)
    cpu = Trainer(exp64, ModelConfig(), store, device="cpu", seed=3)  # the store only gives shapes
    cpu.model.double()
    init = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
    cpu.model.load_state_dict(init)
    for model in (card.model, cpu.model):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0

    ep = sample_episode(torch.Generator(device=dev).manual_seed(5), store, N_WAY, K_SHOT, K_QUERY, 1)
    ep_cpu = episode_to_cpu(ep)
    g = torch.Generator().manual_seed(6)
    draws_cpu = TrainDraws(
        perms=torch.rand((1, 3), generator=g).argsort(dim=-1) + 1,
        cpl_gumbel=draw_cpl_gumbel(g, 1, N_WAY * K_QUERY, N_WAY, "cpu"),
    )
    draws_card = TrainDraws(perms=draws_cpu.perms.to(dev), cpl_gumbel=draws_cpu.cpl_gumbel.to(dev))
    if input_type == "spec":
        draws_cpu.support, draws_cpu.query = (
            draw_views_params(g, exp.specaug_params, 1, k, N_MELS, N_FRAMES, "cpu")
            for k in (N_WAY * K_SHOT, N_WAY * K_QUERY))
        draws_card.support = tuple(x.to(dev) for x in draws_cpu.support)
        draws_card.query = tuple(x.to(dev) for x in draws_cpu.query)
    else:
        n = exp.waveaug_params.aug_num
        draws_cpu.wave_support, draws_cpu.wave_query = (
            cpu.waveaugment.draw(g, (1, n, k), CLIP, "cpu") for k in (N_WAY * K_SHOT, N_WAY * K_QUERY))
        draws_card.wave_support = chain_to(draws_cpu.wave_support, dev)
        draws_card.wave_query = chain_to(draws_cpu.wave_query, dev)
    t0 = time.perf_counter()
    m_card = card.train_step(ep, draws_card).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu = cpu.train_step(ep_cpu, draws_cpu)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(m_card[0].item() - m_cpu[0].item()) / abs(m_cpu[0].item())
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train step loss card {m_card.tolist()} vs CPU {m_cpu.tolist()}")

    cpu_params = dict(cpu.model.named_parameters())
    lr = exp.lr
    worst = dict(grad_rel=0.0, bn_bias_grad_rel=0.0, param_over_lr=0.0, small_param_over_lr=0.0)
    for name, p in card.model.named_parameters():
        if p.grad is None:  # the reference's unused projection LayerNorms
            continue
        gc, gp = p.grad.cpu().double(), cpu_params[name].grad
        pc, pp = p.detach().cpu().double(), cpu_params[name].detach()
        if name.startswith("backbone.encoder.conv_encoder.") and name.endswith(".0.bias"):
            ref = cpu_params[name.replace(".bias", ".weight")].grad.abs().max().item()
            rel = max(gc.abs().max().item(), gp.abs().max().item()) / ref
            worst["bn_bias_grad_rel"] = max(worst["bn_bias_grad_rel"], rel)
            if not rel <= BN_BIAS_NOISE:
                raise AssertionError(f"{name}: gradient {rel} of its conv weight's, not rounding noise")
            small = torch.ones_like(gp, dtype=torch.bool)
        else:
            scale = gp.abs().max().item()
            diff = (gc - gp).abs().max().item()
            worst["grad_rel"] = max(worst["grad_rel"], diff / scale if scale else diff)
            if not diff <= grad_rel * scale:
                raise AssertionError(f"{name}: gradient card vs CPU differs by {diff}, largest |g| {scale}")
            # Adam's first step is ~lr * sign(g): where |g| is within the
            # allowed difference its sign, and the step, may flip
            small = gp.abs() <= grad_rel * scale
        diff = (pc - pp).abs() / lr
        big_diff = diff[~small].max().item() if (~small).any() else 0.0
        small_diff = diff[small].max().item() if small.any() else 0.0
        worst["param_over_lr"] = max(worst["param_over_lr"], big_diff)
        worst["small_param_over_lr"] = max(worst["small_param_over_lr"], small_diff)
        # a flipped step is 2 x lr apart, plus the float32 rounding of the card's parameter
        flip = 2.0 + np.finfo(np.float32).eps * pp.abs().max().item() / lr
        if not (big_diff <= 1e-2 and small_diff <= flip):
            raise AssertionError(f"{name}: parameters after Adam differ by {big_diff} x lr "
                                 f"(where the gradient's sign is sure) and {small_diff} x lr (else)")

    # the same step in float32 on the CPU, against float64: why the CPU copy
    # runs float64 (reported, not asserted)
    cpu32 = Trainer(exp, ModelConfig(), store, device="cpu", seed=3)
    cpu32.model.load_state_dict(init)
    for m in cpu32.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    cpu32.train_step(ep_cpu, draws_cpu)
    f32_rel = {}
    for name, p in cpu32.model.named_parameters():
        if p.grad is None or name.endswith(".0.bias") and "conv_encoder" in name:
            continue
        gp = cpu_params[name].grad
        scale = gp.abs().max().item()
        if scale:
            f32_rel[name] = dict(
                cpu_float32=(p.grad.double() - gp).abs().max().item() / scale,
                card_float32=(dict(card.model.named_parameters())[name].grad.cpu().double() - gp)
                .abs().max().item() / scale,
            )
    top = sorted(f32_rel.items(), key=lambda kv: -kv[1]["cpu_float32"])[:4]
    return dict(loss_card=m_card.tolist(), loss_cpu=m_cpu.tolist(), loss_rel=loss_rel,
                tolerances=dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel=grad_rel,
                                bn_bias_grad_rel=BN_BIAS_NOISE, param_over_lr=1e-2,
                                small_param_over_lr=2.0),
                worst=worst, card_step_s=card_s, cpu_step_s=cpu_s,
                float32_grad_rel_vs_float64_largest_on_cpu=dict(top))


# ---------------------------------------------------------------------------
# bf16, the shipped configs' precision: card against the port on the CPU
# ---------------------------------------------------------------------------

# tests/test_torch_port_bf16.py holds the port's bf16 error within C = 1.5 x
# the JAX package's on the CPU. Here the card's bf16 deviation from its own
# float32 run is held within BF16_C x the CPU's bf16 deviation from the
# CPU's float32 run (the float32 runs stand in for the truth: their own
# error is ~1e-4 of the bf16 one), on the largest and the RMS element.
# BF16_C is that C times 2: the card rounds each conv's output to bf16 and
# then adds the bias in a second bf16 pass (cuDNN's conv, then an add_),
# as the JAX package does, where oneDNN on the CPU adds it inside the conv;
# on the CPU tests that second rounding left the JAX package up to 1.8x the
# port's error (the flagship step's running statistics, RMS)
BF16_C = 3.0
# caps on the card's bf16 deviation from its float32 run, relative to the
# float32 result's scale (largest |x|): ~4x the CPU tests' worst figures
# (scores 2.7%, loss 4.3%, a gradient leaf's RMS share over leaves 0.26)
BF16_SCORE_REL, BF16_LOSS_REL, BF16_GRAD_RMS_SHARE = 0.1, 0.15, 1.0
BF16_EVAL_BATCH = 2


def _dev_err(x, ref):
    """(largest, RMS) of ``x - ref`` on the CPU, in float64."""
    d = x.detach().cpu().double() - ref.detach().cpu().double()
    return d.abs().max().item(), d.square().mean().sqrt().item()


def bf16_hold(name, card16, card32, cpu16, cpu32, scale_rel=None, against_cpu=True):
    """The card's bf16 deviation from its float32 run within BF16_C x the
    CPU's (largest and RMS; ``against_cpu``) and, with ``scale_rel``, within
    that share of the float32 result's largest |x|. Returns the deviations."""
    card, cpu, cross = _dev_err(card16, card32), _dev_err(cpu16, cpu32), _dev_err(card16, cpu16)
    scale = card32.detach().abs().max().item()
    row = dict(card_bf16_vs_card_f32=card, cpu_bf16_vs_cpu_f32=cpu, card_bf16_vs_cpu_bf16=cross,
               card_f32_vs_cpu_f32=_dev_err(card32, cpu32), scale=scale)
    for k, what in enumerate(("largest", "RMS")):
        if against_cpu and not card[k] <= BF16_C * cpu[k]:
            raise AssertionError(f"bf16 {name}: the card's {what} deviation {card[k]} > {BF16_C} x the CPU's "
                                 f"{cpu[k]}: {row}")
    if scale_rel is not None and not card[0] <= scale_rel * scale:
        raise AssertionError(f"bf16 {name}: the card's deviation {card[0]} above {scale_rel} of the scale: {row}")
    return row


class _DtypeSpy:
    """Stands in for a kernel's wrapper in its module: records the dtype of
    the first argument of every call, and keeps the launch count on the
    wrapper (which counts through its module's name, now this spy)."""

    def __init__(self, fn, name: str, out: dict):
        self.fn, self.name, self.out = fn, name, out

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        self.out.setdefault(self.name, set()).add(str(args[0].dtype).replace("torch.", ""))
        return self.fn(*args, **kwargs)


@contextlib.contextmanager
def kernel_dtypes(out: dict):
    """Record the dtypes each kernel's wrapper is called with (by kernel
    name, a set) while the block runs."""
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    wrapped = [(specaugment, "views_cuda", "K1"), (protohead, "episode_scores_cuda", "K2"),
               (mel, "mel_log_cuda", "K3")]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in wrapped]
    for (module, attr, name), (_, _, fn) in zip(wrapped, saved):
        setattr(module, attr, _DtypeSpy(fn, name, out))
    try:
        yield out
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def check_float32_inputs(dtypes: dict, what: str) -> None:
    """At bf16 each kernel is still fed float32, as in the JAX package: K1
    the store's specs, K2 the features cast up after the encoder (JAX
    protonets.py:141), K3 the power spectrum."""
    if any(v != {"float32"} for v in dtypes.values()):
        raise AssertionError(f"{what}: kernel input dtypes {dtypes}, expected float32 throughout")


def _four_trainers(dev, store, exp_of):
    """Card and CPU trainers in bf16 and float32 (``exp_of(dtype)``), every
    one with the card's bf16 model's weights and every dropout at p = 0."""
    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        for dtype in ("bfloat16", "float32"):
            out[f"{where}{16 if dtype == 'bfloat16' else 32}"] = Trainer(
                exp_of(dtype), ModelConfig(), store, device=device, seed=3)  # a CPU copy takes shapes only
    init = {k: v.detach().cpu().clone() for k, v in out["card16"].model.state_dict().items()}
    for t in out.values():
        t.model.load_state_dict(init)
        for m in t.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return out


def bf16_eval_phase(dev, store, input_type):
    """One bf16 eval batch of the flagship at E=2 (spec: K1 then K2; wav: K3
    then K2), on the card and on the CPU, beside float32 runs of the same
    batch: same weights, episodes and SpecAugment draws."""
    import torch

    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params

    e, t0 = BF16_EVAL_BATCH, time.perf_counter()
    tr = _four_trainers(dev, store, lambda dtype: flagship_exp(input_type, compute_dtype=dtype,
                                                               eval_episode_batch=e))
    ep = sample_episode(torch.Generator(device=dev).manual_seed(7), store, N_WAY, K_SHOT, K_QUERY, e)
    ep_cpu = episode_to_cpu(ep)
    draws_cpu = draws_card = None
    if input_type == "spec":
        g = torch.Generator().manual_seed(8)
        draws_cpu = tuple(draw_views_params(g, tr["cpu16"].exp.specaug_params, e, n, N_MELS, N_FRAMES, "cpu")
                          for n in (N_WAY * K_SHOT, N_WAY * K_QUERY))
        draws_card = tuple(tuple(x.to(dev) for x in d) for d in draws_cpu)
    kernels = kernel_counters()
    scores, dtypes = {}, {}
    with torch.inference_mode():
        for name, t in tr.items():
            on_card = name.startswith("card")
            if name == "card16":
                for k in kernels:
                    k.launches = 0
            with kernel_dtypes(dtypes) if name == "card16" else contextlib.nullcontext():
                s = t._episode_scores(ep if on_card else ep_cpu, N_WAY, True, t.gen,
                                      draws_card if on_card else draws_cpu, store)
            if name == "card16":
                torch.cuda.synchronize()
                launches = [k.launches for k in kernels]
            scores[name] = s.float().cpu()
    if not all(torch.isfinite(s).all() for s in scores.values()):
        raise AssertionError(f"bf16 {input_type} eval: scores not finite")
    row = bf16_hold(f"{input_type} eval scores", scores["card16"], scores["card32"], scores["cpu16"],
                    scores["cpu32"], BF16_SCORE_REL)
    want = WAV_LAUNCHES if input_type == "wav" else SPEC_LAUNCHES
    if launches != want:
        raise AssertionError(f"bf16 {input_type} eval batch launched K1-K3 {launches}, expected {want}")
    check_float32_inputs(dtypes, f"bf16 {input_type} eval")
    agree = {k: (scores[k].argmax(-1) == scores[k.replace("16", "32")].argmax(-1)).float().mean().item()
             for k in ("card16", "cpu16")}
    # a row whose argmax the card's bf16 run loses and the CPU's keeps is a
    # near tie: its float32 top-two margin under 2 x the CPU's deviation
    top2 = scores["card32"].topk(2, dim=-1).values
    lost = (scores["card16"].argmax(-1) != scores["card32"].argmax(-1)) & (
        scores["cpu16"].argmax(-1) == scores["cpu32"].argmax(-1))
    margins = (top2[..., 0] - top2[..., 1])[lost]
    if not (margins < 2 * row["cpu_bf16_vs_cpu_f32"][0]).all():
        raise AssertionError(f"bf16 {input_type} eval: the card loses rows of float32 margin {margins.tolist()}")
    row.update(launches=launches, kernel_input_dtypes={k: sorted(v) for k, v in dtypes.items()},
               argmax_agree_with_own_f32=agree, rows_lost_by_card_margins=margins.tolist(), episodes=e,
               seconds=time.perf_counter() - t0)
    return row


def bf16_train_phase(dev, store):
    """One bf16 flagship train step at E=1 (K1 2, K2 1) on the card and on
    the CPU, beside float32 steps: same weights, episode, views, view
    permutations and CPL draws, every dropout at p = 0. The loss, every
    gradient (each leaf's deviation as a share of its largest float32 |g|,
    then the largest and the RMS over the leaves) and the running
    statistics."""
    import torch

    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.losses import draw_cpl_gumbel
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws

    t0 = time.perf_counter()
    tr = _four_trainers(dev, store, lambda dtype: train_exp(compute_dtype=dtype, episode_batch=1))
    ep = sample_episode(torch.Generator(device=dev).manual_seed(9), store, N_WAY, K_SHOT, K_QUERY, 1)
    g = torch.Generator().manual_seed(10)
    draws_cpu = TrainDraws(perms=torch.rand((1, 3), generator=g).argsort(dim=-1) + 1,
                           cpl_gumbel=draw_cpl_gumbel(g, 1, N_WAY * K_QUERY, N_WAY, "cpu"))
    draws_cpu.support, draws_cpu.query = (
        draw_views_params(g, tr["cpu16"].exp.specaug_params, 1, k, N_MELS, N_FRAMES, "cpu")
        for k in (N_WAY * K_SHOT, N_WAY * K_QUERY))
    draws_card = TrainDraws(perms=draws_cpu.perms.to(dev), cpl_gumbel=draws_cpu.cpl_gumbel.to(dev),
                            support=tuple(x.to(dev) for x in draws_cpu.support),
                            query=tuple(x.to(dev) for x in draws_cpu.query))
    kernels = kernel_counters()
    loss, grads, stats, dtypes = {}, {}, {}, {}
    for name, t in tr.items():
        on_card = name.startswith("card")
        if name == "card16":
            for k in kernels:
                k.launches = 0
        with kernel_dtypes(dtypes) if name == "card16" else contextlib.nullcontext():
            m = t.train_step(ep if on_card else episode_to_cpu(ep), draws_card if on_card else draws_cpu)
        if name == "card16":
            torch.cuda.synchronize()
            launches = [k.launches for k in kernels]
        loss[name] = m[0:1].float().cpu()
        grads[name] = {n: p.grad.float().cpu() for n, p in t.model.named_parameters() if p.grad is not None}
        stats[name] = torch.cat([b.float().cpu().ravel() for n, b in t.model.named_buffers()
                                 if n.endswith(("running_mean", "running_var"))])
    if launches != SPEC_LAUNCHES:
        raise AssertionError(f"bf16 train step launched K1-K3 {launches}, expected {SPEC_LAUNCHES}")
    check_float32_inputs(dtypes, "bf16 train step")
    if not all(torch.isfinite(x).all() for x in loss.values()):
        raise AssertionError(f"bf16 train step: loss {loss}")
    # one scalar: its two deviations are two draws of bf16 noise, whose
    # ratio says nothing (the CPU tests hold the loss over 8 batches), so
    # only the cap applies
    row = dict(loss=bf16_hold("train loss", *(loss[k] for k in ("card16", "card32", "cpu16", "cpu32")),
                              scale_rel=BF16_LOSS_REL, against_cpu=False),
               running_stats=bf16_hold("running statistics",
                                       *(stats[k] for k in ("card16", "card32", "cpu16", "cpu32"))))
    shares = {"card": [], "cpu": [], "cross": []}
    for n, ref in grads["card32"].items():
        if n.startswith("backbone.encoder.conv_encoder.") and n.endswith(".0.bias"):
            continue  # zero but for rounding ahead of train-mode BatchNorm
        scale = ref.abs().max().item()
        if scale == 0.0:
            continue
        shares["card"].append((grads["card16"][n] - ref).abs().max().item() / scale)
        shares["cpu"].append((grads["cpu16"][n] - grads["cpu32"][n]).abs().max().item() / scale)
        shares["cross"].append((grads["card16"][n] - grads["cpu16"][n]).abs().max().item() / scale)
    agg = {k: (max(v), float(np.sqrt(np.mean(np.square(v))))) for k, v in shares.items()}
    for i, what in enumerate(("largest", "RMS")):
        if not agg["card"][i] <= BF16_C * agg["cpu"][i]:
            raise AssertionError(f"bf16 train step: the card's {what} gradient share {agg['card'][i]} > "
                                 f"{BF16_C} x the CPU's {agg['cpu'][i]}")
    if not agg["card"][1] <= BF16_GRAD_RMS_SHARE:
        raise AssertionError(f"bf16 train step: gradient RMS share {agg['card'][1]} above {BF16_GRAD_RMS_SHARE}")
    row.update(grad_share_card_bf16_vs_card_f32=agg["card"], grad_share_cpu_bf16_vs_cpu_f32=agg["cpu"],
               grad_share_card_bf16_vs_cpu_bf16=agg["cross"], launches=launches,
               kernel_input_dtypes={k: sorted(v) for k, v in dtypes.items()}, seconds=time.perf_counter() - t0)
    return row


RESUME_TASKS, RESUME_EPOCHS = 8, 2
# validation accuracy of the resumed run against the straight run's (8 tasks
# of 25 queries: 0.05 is 10 queries)
RESUME_VAL_ATOL = 0.05


def resume_phase():
    """``--resume`` on the card: on a split of a synthetic dataset written by
    ``make_synthetic_dataset`` (15 classes of 128x157, band gain 1), the
    flagship (bf16, E=1) trains 2 epochs of 8 tasks straight through; then
    from the same seed 1 epoch, a resume checkpoint, a fresh trainer resumed
    from it and the second epoch. The resumed run's step, generator state and
    epoch, the parameters and the validation accuracy against the straight
    run's (cuDNN's backward is not deterministic, so each parameter is held
    to 2 lr a step, the most two Adam trajectories can part by)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split, make_synthetic_dataset
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.train.experiment import run_single_training

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = make_synthetic_dataset(os.path.join(tmp, "synth"), n_classes=15, items_per_class=10,
                                      n_mels=N_MELS, n_frames=N_FRAMES, split_fractions=(5, 5, 5), band_gain=1.0)

        def trainer(epochs):
            d = train_dict(tasks=RESUME_TASKS, episode_batch=1)
            d.update(num_epochs=epochs, patience=5)
            exp = ExperimentConfig.from_dict(d)
            train, val = (load_packed_split(exp, root, s, "cuda") for s in ("train", "valid"))
            return Trainer(exp, ModelConfig(), train, val_store=val, test_store=val, seed=11)

        logs = []
        straight = run_single_training(trainer(RESUME_EPOCHS), os.path.join(tmp, "a"), log_fn=logs.append)
        run_single_training(trainer(RESUME_EPOCHS - 1), os.path.join(tmp, "b"), log_fn=logs.append)
        resumed = run_single_training(trainer(RESUME_EPOCHS), os.path.join(tmp, "b"), log_fn=logs.append,
                                      resume=True)
        a, b = (torch.load(os.path.join(tmp, d, "resume_run0.ckpt"), weights_only=True) for d in ("a", "b"))
        meta = json.load(open(os.path.join(tmp, "b", "resume_run0.ckpt.meta.json")))
    if f"Resumed run 0 from epoch {RESUME_EPOCHS - 1}" not in logs:
        raise AssertionError(f"the resumed run did not resume: {logs}")
    steps = RESUME_EPOCHS * RESUME_TASKS
    if not (a["step"] == b["step"] == steps and meta["epoch"] == RESUME_EPOCHS
            and torch.equal(a["generator"], b["generator"])):
        raise AssertionError(f"resume: steps {a['step']} / {b['step']}, epoch {meta['epoch']}, generators "
                             f"equal {torch.equal(a['generator'], b['generator'])}")
    lr = train_exp().lr
    param_over_lr = max((b["model"][k].double() - v.double()).abs().max().item() / lr
                        for k, v in a["model"].items() if v.is_floating_point())
    if not param_over_lr <= 2 * steps:
        raise AssertionError(f"resume: parameters {param_over_lr} lr apart, above 2 lr a step ({2 * steps})")
    h_s, h_r = straight["history"][-1], resumed["history"][-1]
    if not abs(h_r["val_accuracy"] - h_s["val_accuracy"]) <= RESUME_VAL_ATOL:
        raise AssertionError(f"resume: validation accuracy {h_r['val_accuracy']} vs {h_s['val_accuracy']}")
    return dict(steps=steps, param_max_diff_over_lr=param_over_lr, param_bound_over_lr=2 * steps,
                val_accuracy_straight=h_s["val_accuracy"], val_accuracy_resumed=h_r["val_accuracy"],
                loss_straight=h_s["loss"], loss_resumed=h_r["loss"], seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the protocol drivers: the parity runbook's dry run, the full protocol cut
# ---------------------------------------------------------------------------

PROTOCOL_EPOCHS, PROTOCOL_TASKS, PROTOCOL_TEST_TASKS = 3, 16, 64
PROTOCOL_ACC = 0.4  # 5-way chance is 0.2


def load_script(name: str):
    """A script of ``scripts/`` as a module, to drive it in-process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def launches_key(launches) -> str:
    """The drivers' key of a call's K1 K2 K3 launches."""
    from audio_few_shot_learning_tpu_torch.utils.profiling import tally_launches

    (key,) = tally_launches([launches])
    return key


def per_call(counts: dict, i: int) -> int:
    """Kernel ``i``'s launches per call from a driver's ``{"K1 K2 K3": calls}``
    record, whose calls the phases have held to one pattern."""
    (key,) = counts
    return int(key.split()[i])


def parity_dry_run_phase():
    """``scripts/torch_port_parity_runbook.py --dry-run`` in-process over the
    15 shipped configs, in a directory under ``build/``: its return code 0,
    every cell's accuracy finite, every train step and eval batch launching
    K1 2, K2 1, K3 0 (plain configs, which turn SpecAugment off: K1 0), and
    each multi-segment cell's eval peak over its reckoned bytes under
    ``EVAL_PEAK_FACTOR``."""
    from audio_few_shot_learning_tpu_torch.train import engine

    runbook = load_script("torch_port_parity_runbook")
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        out = os.path.join(tmp, "PARITY_TORCH_DRYRUN.md")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = runbook.main(["--dry-run", "--quiet", "--data-root", os.path.join(tmp, "data"),
                               "--experiments-root", os.path.join(tmp, "experiments"), "--out", out])
        with open(os.path.join(tmp, "PARITY_TORCH_DRYRUN.json")) as f:
            cells = json.load(f)
    seconds = time.perf_counter() - t0
    if rc != 0 or len(cells) != 15 or any("error" in c for c in cells):
        raise AssertionError(f"the parity dry run returned {rc}: {[c for c in cells if 'error' in c]}")
    for c in cells:
        want = launches_key(SPEC_LAUNCHES if c["specaugment"] else PLAIN_LAUNCHES)
        if set(c["launches_per_train_step"]) != {want} or set(c["launches_per_eval_batch"]) != {want}:
            raise AssertionError(f"{c['dataset']} / {c['loss']}: launches per train step "
                                 f"{c['launches_per_train_step']}, per eval batch {c['launches_per_eval_batch']}; "
                                 f"expected {want} for each")
        if not (np.isfinite(c["mean_accuracy"]) and 0.0 <= c["mean_accuracy"] <= 1.0):
            raise AssertionError(f"{c['dataset']} / {c['loss']}: accuracy {c['mean_accuracy']}")
        if c["multi_segm"] and not c["eval_peak_factor"] <= engine.EVAL_PEAK_FACTOR:
            raise AssertionError(f"{c['dataset']} / {c['loss']}: eval peak {c['eval_peak_factor']} x the reckoned "
                                 f"bytes at E={c['eval_batch']}, above EVAL_PEAK_FACTOR {engine.EVAL_PEAK_FACTOR}")
    return dict(lines=[runbook.cell_line(c) for c in cells], cells=cells, seconds=seconds)


def full_protocol_phase():
    """``scripts/torch_port_full_protocol.py --epochs 3 --tasks 16
    --test-tasks 64``, one single-segment and one multi-segment run in bf16,
    in-process, in a directory under ``build/``: ``result_run0.json`` of
    both passes and ``summary.json`` with the JAX script's keys
    (``experiments/full_protocol/summary.json``) and the port's, launches
    per train step and per eval batch K1 2, K2 1, K3 0, the test run on the
    weights of the run's ``model.ckpt`` (the best-model reload), and test
    accuracy above ``PROTOCOL_ACC``."""
    protocol = load_script("torch_port_full_protocol")
    with open(os.path.join(REPO, "experiments", "full_protocol", "summary.json")) as f:
        jax_summary = json.load(f)
    port_keys = {"card", "compute_dtype", "torch"}
    port_pass_keys = {"compute_dtype", "device", "peak_memory_allocated_gb", "launches_per_train_step",
                      "launches_per_eval_batch", "train_steps", "eval_batches"}
    port_run_keys = {"epochs_ran", "best_val_epoch", "step_ms_first_epochs_median", "step_ms_last_epochs_median",
                     "val_curve", "test_ran_on_model_ckpt"}
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "experiments")
        with contextlib.redirect_stdout(io.StringIO()):
            protocol.main(["--runs", "1", "--mseg-runs", "1", "--epochs", str(PROTOCOL_EPOCHS), "--tasks",
                           str(PROTOCOL_TASKS), "--test-tasks", str(PROTOCOL_TEST_TASKS), "--experiments-root", root])
        with open(os.path.join(root, "torch_full_protocol_bf16", "summary.json")) as f:
            summary = json.load(f)
        missing_results = [d for d in ("torch_full_protocol_bf16", "torch_full_protocol_mseg_bf16")
                           if not os.path.exists(os.path.join(root, d, "result_run0.json"))]
    seconds = time.perf_counter() - t0
    if missing_results:
        raise AssertionError(f"the full protocol wrote no result_run0.json in {missing_results}")
    if not (set(jax_summary) | port_keys) <= set(summary):
        raise AssertionError(f"summary.json keys {sorted(summary)}")
    want = launches_key(SPEC_LAUNCHES)
    out = dict(seconds=seconds, card=summary["card"])
    for key in ("single_segment", "multi_segment"):
        got = summary[key]
        run = got["per_run"][0]
        if not ((set(jax_summary[key]) | port_pass_keys) <= set(got)
                and (set(jax_summary[key]["per_run"][0]) | port_run_keys) <= set(run)):
            raise AssertionError(f"{key}: summary keys {sorted(got)}, run keys {sorted(run)}")
        if got["launches_per_train_step"] != {want: PROTOCOL_EPOCHS * PROTOCOL_TASKS} or \
                set(got["launches_per_eval_batch"]) != {want}:
            raise AssertionError(f"{key}: launches per train step {got['launches_per_train_step']}, per eval batch "
                                 f"{got['launches_per_eval_batch']}; expected {want}")
        if run["test_ran_on_model_ckpt"] is not True:
            raise AssertionError(f"{key}: the test did not run on the best checkpoint's weights")
        if not run["test_acc"] > PROTOCOL_ACC:
            raise AssertionError(f"{key}: test accuracy {run['test_acc']} not above {PROTOCOL_ACC}")
        out[key] = {k: got[k] for k in ("wall_clock_seconds", "peak_memory_allocated_gb", "launches_per_train_step",
                                        "launches_per_eval_batch", "eval_batches")}
        out[key].update({k: run[k] for k in ("test_acc", "best_val_acc", "best_val_epoch", "epochs_ran",
                                             "step_ms_first_epochs_median", "step_ms_last_epochs_median",
                                             "train_eps_per_sec", "val_curve")})
    return out


SCALE_NSYNTH_ITEMS = 40_000
SCALE_WAV_ITEMS = 3_000


def scale_drivers_phase():
    """The two dataset-scale drivers in-process at reduced depth (item 31 of
    the module's list), in a directory under ``build/``; each raises on its
    own checks, and this phase holds what their lines report."""
    nsynth_driver = load_script("torch_port_nsynth_scale")
    wav_driver = load_script("torch_port_wav_scale")
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp, contextlib.redirect_stdout(io.StringIO()):
        nsynth = nsynth_driver.main(["--root", os.path.join(tmp, "nsynth_scale"),
                                     "--items", str(SCALE_NSYNTH_ITEMS)])
    nsynth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        wav = wav_driver.main(["--items", str(SCALE_WAV_ITEMS)])
    wav_s = time.perf_counter() - t0
    arms = nsynth["train"]
    if not nsynth["sampling_flat"] or (nsynth["classes"], nsynth["feat_shape"]) != (1006, [128, 126]):
        raise AssertionError(f"NSynth scale: sampling_flat {nsynth['sampling_flat']}, {nsynth['classes']} classes "
                             f"at {nsynth['feat_shape']}")
    if [arms[k]["store"] for k in ("host_store_null", "host_store_true")] != ["PackedStore", "HostStore"]:
        raise AssertionError(f"NSynth scale: the placements loaded as {[a['store'] for a in arms.values()]}")
    want = launches_key(SPEC_LAUNCHES)
    for name, arm in arms.items():
        if arm["launches_per_train_step"] != {want: nsynth_driver.TRAIN_TASKS} or \
                set(arm["launches_per_eval_batch"]) != {want}:
            raise AssertionError(f"NSynth scale, {name}: launches per train step {arm['launches_per_train_step']}, "
                                 f"per eval batch {arm['launches_per_eval_batch']}")
    want = launches_key(WAV_LAUNCHES)
    if wav["s_max"] != 36 or wav["store"] != "WavHostStore" or set(wav["launches_per_train_step"]) != {want} or \
            set(wav["launches_per_eval_batch"]) != {want} or not (wav["loss_finite"] and wav["eval_acc_sane"]):
        raise AssertionError(f"wav scale: {wav}")
    keep = ("load_seconds", "store", "train_ms_per_step_median", "eval_eps_per_sec", "test_accuracy",
            "launches_per_train_step", "launches_per_eval_batch", "peak_memory_allocated_gb")
    return dict(
        nsynth_seconds=nsynth_s, wav_seconds=wav_s,
        nsynth={k: nsynth[k] for k in ("items", "gen_seconds", "pack_seconds", "probe_seconds",
                                       "store_gb", "class_table_m_max",
                                       "class_table_skew", "sample_ms_per_8ep_306k", "sample_ms_per_8ep_small",
                                       "host_sample_ms_per_8ep_306k", "sampling_flat", "peak_rss_gb_run")},
        nsynth_arms={name: {k: arm[k] for k in keep} for name, arm in arms.items()},
        wav={k: wav[k] for k in ("items", "store_gb", "s_max", "pack_seconds", "train_eps_per_sec",
                                 "train_ms_per_step_median", "raw_floor_eps_per_sec", "eval_smax_tasks_per_sec",
                                 "eval_batch", "launches_per_train_step", "launches_per_eval_batch",
                                 "train_peak_memory_allocated_gb", "eval_peak_memory_allocated_gb",
                                 "staging_bytes_per_step", "peak_rss_gb")},
    )


DRIVER_DEPTH = ["--epochs", "2", "--tasks", "4", "--test-tasks", "16"]
ANATOMY_STEPS = "5"


def ported_drivers_phase():
    """Item 32: the ten drivers ported from the JAX repo, in-process at
    reduced depth; each raises on its own checks, and this phase holds the
    launches of every train step and eval batch each driver ran to the
    pattern of its configs (SpecAugment: K1 2, K2 1, K3 0 a chunk; wav:
    K1 0, K2 1, K3 1)."""
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    spec, wav = launches_key(SPEC_LAUNCHES), launches_key(WAV_LAUNCHES)
    chunked = launches_key([2 * n for n in SPEC_LAUNCHES])  # E=8 in chunks of 4
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        report = os.path.join(tmp, "PARITY_AB_TORCH.md")
        results = os.path.join(tmp, "ab_results.jsonl")
        runs = [
            ("ab_vs_reference", "torch_port_ab_vs_reference", ["--seeds", "0", "--band-gain", "1.2", "--results",
                                                               results, "--out", report, *DRIVER_DEPTH], {spec}),
            ("ab_vs_reference_mseg", "torch_port_ab_vs_reference",
             ["--seeds", "0", "--band-gain", "1.2", "--multiseg", "--results", results, "--out", report,
              *DRIVER_DEPTH], {spec}),
            ("ab_report", "torch_port_ab_vs_reference", ["--report", "--results", results, "--out", report], None),
            ("ab_calibrate", "torch_port_ab_calibrate", ["--gains", "1.2", "--out", report, *DRIVER_DEPTH], {spec}),
            ("ab_deviations_bn", "torch_port_ab_deviations",
             ["--seeds", "1", "--experiment", "bn", "--cache", os.path.join(tmp, "cache.jsonl"), "--out", report,
              *DRIVER_DEPTH], {spec}),
            ("ab_deviations_pitch", "torch_port_ab_deviations",
             ["--seeds", "1", "--experiment", "pitch", "--cache", os.path.join(tmp, "cache.jsonl"), "--out", report,
              *DRIVER_DEPTH], {wav}),
            ("ab_deviations_lowpass", "torch_port_ab_deviations",
             ["--seeds", "1", "--experiment", "lowpass", "--cache", os.path.join(tmp, "cache.jsonl"), "--out", report,
              *DRIVER_DEPTH], {wav}),
            ("step_anatomy", "torch_port_step_anatomy",
             ["--steps", ANATOMY_STEPS, "--profile-steps", "2", "--episode-batches", "1", "8"], {spec, chunked}),
            ("backward_anatomy", "torch_port_backward_anatomy", ["--iters", ANATOMY_STEPS], None),
            ("bn_fold_eval", "torch_port_bn_fold_eval", ["--iters", ANATOMY_STEPS], None),
            ("profile_wav_path", "torch_port_profile_wav_path",
             ["--variants=full,-gain", "--repeats", "1", "--profile-steps", "2"], {wav}),
            ("predict_latency", "torch_port_predict_latency", ["--calls", ANATOMY_STEPS], None),
            ("ab_store_dtype", "torch_port_ab_store_dtype", ["--e", "1", "--repeats", "1"], {spec}),
            ("ab_kernels", "torch_port_ab_kernels", [], None),
        ]
        for name, script, argv, want in runs:
            module = load_script(script)
            steps, batches = [], []
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), launches_per_call(Trainer, "train_step", steps), \
                    launches_per_call(Trainer, "_eval_episodes", batches):
                result = module.main(argv)
            seconds[name] = time.perf_counter() - t0
            row = dict(launches_per_train_step=tally_launches(steps), launches_per_eval_batch=tally_launches(batches))
            if want is not None and (not steps or set(row["launches_per_train_step"]) - want
                                     or set(row["launches_per_eval_batch"]) - want):
                raise AssertionError(f"{name}: launches per train step {row['launches_per_train_step']}, per eval "
                                     f"batch {row['launches_per_eval_batch']}; expected {sorted(want)}")
            if want is None and (steps or batches):
                raise AssertionError(f"{name} trained or evaluated: {row}")
            out[name] = {**row, **driver_summary(name, result)}
        with open(report) as f:
            text = f.read()
    for section in ("ab_vs_reference", "ab_calibrate", "ab_deviations"):
        if f"<!-- {section}: begin -->" not in text:
            raise AssertionError(f"the A/B report has no {section} section")
    return dict(drivers=out, seconds=seconds, total_seconds=sum(seconds.values()))


def driver_summary(name: str, result) -> dict:
    """The figures of a driver's result that the phase prints."""
    if name.startswith("ab_vs_reference"):
        return {"test_acc": [r["test_acc"] for r in result], "step_ms_median": [r["step_ms_median"] for r in result]}
    if name == "ab_calibrate":
        return {"sweep": result["sweep"]}
    if name.startswith("ab_deviations"):
        return {"summary": result["summary"]}
    if name == "step_anatomy":
        return {f"E{r['episode_batch']}": {k: [v["wall_ms"], v["device_ms"]] for k, v in r["stages"].items()}
                for r in result["runs"]}
    if name == "backward_anatomy":
        return {f"{c['pool']} {c['norm']}": [c["fwd_ms"], c["fwd_bwd_ms"]] for c in result["cells"]}
    if name == "bn_fold_eval":
        return {k: result[k] for k in ("speedup", "max_abs_dev")}
    if name == "profile_wav_path":
        return {k: [v["step_ms_median"], v["device_ms"]] for k, v in result["variants"].items()}
    if name == "predict_latency":
        return {k: result[k] for k in ("cold_seconds", "warm_median_ms", "bf16_agree", "launches_per_call")}
    if name == "ab_store_dtype":
        return {r["store_dtype"]: r["eps"] for r in result["rows"]}
    if name == "ab_kernels":
        return {"k1_ms": result["specaugment"]["kernel_ms"], "k2_ms": [r["kernel_ms"] for r in result["protohead"]],
                "launches": result["kernel_launches"]}
    return {}


BENCH_HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "config", "backend", "device",
                       "matrix", "launches_per_step", "step_flops"}
SHARE_CAP = 1.05  # a share of a peak above 1 is a fault of the count or the clock


def bench_driver_phase():
    """Item 33: ``scripts/torch_port_bench.py`` in default mode, in-process;
    its one line parsed and held (keys, rates, shares, launches per headline
    step and per eval batch, the TF32 flags it leaves)."""
    import torch

    module = load_script("torch_port_bench")
    if module.BF16_DENSE_FLOPS != BF16_DENSE_FLOPS:
        raise AssertionError(f"the bench driver's bf16 peak {module.BF16_DENSE_FLOPS} is not {BF16_DENSE_FLOPS}")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        (line,) = module.main([])
    seconds = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != line:
        raise AssertionError(f"the bench driver printed {len(lines)} lines, not its one JSON line")
    if set(line) != BENCH_HEADLINE_KEYS or line["backend"] != "cuda":
        raise AssertionError(f"bench line keys {sorted(line)}, backend {line['backend']}")
    m = line["matrix"]
    if not (line["value"] > 0 and line["vs_baseline"] > 0 and m["eval_eps"] > 0):
        raise AssertionError(f"bench rates: {line['value']}, vs baseline {line['vs_baseline']}, eval {m['eval_eps']}")
    for share in ("mfu", "fraction_of_matmul_roof"):
        if not (m[share] is not None and 0 < m[share] <= SHARE_CAP):
            raise AssertionError(f"bench {share} {m[share]} outside (0, {SHARE_CAP}]")
    want = launches_key(SPEC_LAUNCHES)
    for name, tally in (("headline step", line["launches_per_step"]), ("eval batch", m["launches_per_eval_batch"])):
        if set(tally) != {want}:
            raise AssertionError(f"bench launches per {name}: {tally}, expected {want}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the bench driver left TF32 on")
    fn, args = module.setup.entry("cuda:0")  # __graft_entry__.entry's counterpart
    scores = fn(*args)
    if tuple(scores.shape) != (1, N_WAY * K_QUERY, N_WAY) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"entry(): scores {tuple(scores.shape)}, finite {bool(torch.isfinite(scores).all())}")
    return dict(line=line, seconds=seconds, entry_scores_shape=list(scores.shape))


DP_PARAM_LR = 8.0  # 4 Adam steps, each ~lr * sign(g): a flipped sign moves a parameter 2 lr a step


def dp_world1_phase(dev, store, accum):
    """(a) Data parallelism over NCCL with one rank on the card: a process
    group of one (``file://`` rendezvous), the flagship CPL model at E=8 in
    chunks of 4 with remat, 4 steps of ``train_epoch``. Float32 (TF32 off)
    against the plain Trainer (no process group) from the same seed: epoch
    loss within TRAIN_LOSS_RTOL, every parameter within DP_PARAM_LR x lr,
    the running statistics within 1e-3 of their largest. bf16: launches per
    step K1 4, K2 2, K3 0, ms per step beside the plain E=8/4 phase of this
    run, and NCCL's kernels and device time per step under the profiler
    (reported: NCCL may carry out one rank's all-reduce without a kernel).
    Then ``test()`` over 64 tasks at E=16 equals the plain Trainer's."""
    import torch
    import torch.distributed as dist

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, make_mesh, maybe_initialize_distributed
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    alone = EpisodeMesh(0, 1, dev)  # the plain Trainer: no process group, no collective
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    kernels = kernel_counters()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        maybe_initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, "nccl")
        try:
            mesh = make_mesh(1, dev)
            out = dict(backend=dist.get_backend(), world=mesh.world)
            exp32 = train_exp(tasks=32, episode_batch=8, episode_microbatch=4, compute_dtype="float32")
            runs = {}
            for name, m in (("dp", mesh), ("plain", alone)):
                trainer = Trainer(exp32, ModelConfig(), store, device=dev, seed=0, mesh=m)
                runs[name] = (trainer, trainer.train_epoch())
            (dp, m_dp), (plain, m_plain) = runs["dp"], runs["plain"]
            loss_rel = abs(m_dp["loss"] - m_plain["loss"]) / abs(m_plain["loss"])
            params = dict(plain.model.named_parameters())
            param_lr = max((p.detach() - params[n].detach()).abs().max().item()
                           for n, p in dp.model.named_parameters()) / exp32.lr
            buffers = dict(plain.model.named_buffers())
            stats_rel = max((b - buffers[n]).abs().max().item() / max(1.0, buffers[n].abs().max().item())
                            for n, b in dp.model.named_buffers() if "running" in n)
            bit_equal = all(torch.equal(v, plain.model.state_dict()[k]) for k, v in dp.model.state_dict().items())
            if not (loss_rel <= TRAIN_LOSS_RTOL and param_lr <= DP_PARAM_LR and stats_rel <= 1e-3):
                raise AssertionError(f"one-rank NCCL float32 epoch vs the plain Trainer: loss {loss_rel:.2e}, "
                                     f"parameters {param_lr:.2e} x lr, statistics {stats_rel:.2e}")
            out["float32"] = dict(loss_dp=m_dp["loss"], loss_plain=m_plain["loss"], loss_rel=loss_rel,
                                  param_max_over_lr=param_lr, stats_rel=stats_rel, bit_equal=bit_equal,
                                  bounds=dict(loss_rel=TRAIN_LOSS_RTOL, param_over_lr=DP_PARAM_LR, stats_rel=1e-3))
            del runs, dp, plain

            trainer = Trainer(train_exp(tasks=32, episode_batch=8, episode_microbatch=4), ModelConfig(), store,
                              device=dev, seed=0, mesh=mesh)
            for k in kernels:
                k.launches = 0
            first = trainer.train_epoch()
            launches = [k.launches / trainer.steps_per_epoch for k in kernels]
            if launches != [4, 2, 0]:
                raise AssertionError(f"one-rank NCCL bf16 step launched K1, K2, K3 {launches} times; "
                                     "expected [4, 2, 0]")
            second = trainer.train_epoch()
            prof = profile(lambda: [trainer.train_step(sample_episode(trainer.gen, store, N_WAY, K_SHOT, K_QUERY, 8))
                                    for _ in range(2)])
            if not (np.isfinite(first["loss"]) and np.isfinite(second["loss"])):
                raise AssertionError(f"one-rank NCCL bf16 epochs {first}, {second}")
            med = float(np.median(trainer.last_step_ms))
            out["bf16"] = dict(launches_per_step=launches, step_ms=trainer.last_step_ms, step_ms_median=med,
                               train_episodes_per_s_median=8e3 / med, plain_step_ms_median=accum["step_ms_median"],
                               nccl_kernels_per_step=prof["nccl_kernels"] / 2, nccl_us_per_step=prof["nccl_us"] / 2,
                               all_reduce_calls=prof["all_reduce_calls"],
                               busy_share=prof["device_busy_share"], epochs=[first, second])
            del trainer

            tests = {}
            for name, m in (("dp", mesh), ("plain", alone)):
                trainer = Trainer(flagship_exp(), ModelConfig(), store, test_store=store, device=dev, seed=0, mesh=m)
                tests[name] = trainer.test()
            if tests["dp"]["mean_accuracy"] != tests["plain"]["mean_accuracy"]:
                raise AssertionError(f"one-rank NCCL test() {tests['dp']} vs the plain Trainer's {tests['plain']}")
            out["test"] = tests
        finally:
            dist.destroy_process_group()
    return out


def dp_two_ranks_phase():
    """(b) Two ranks on the one card over gloo on CUDA tensors (NCCL refuses
    two ranks on one device): ``parallel/dryrun.py::dryrun_multichip`` at
    the flagship's widths in float32, E=8 (4 per rank). Its checks hold one
    step's loss, gradients and running statistics against one process's
    E=8 step on the same episodes and draws (the gradients within the dry
    run's flagship bound: max-pool argmax flips, see
    ``parallel/dryrun.py::GRAD_REL``), 4 steps' mean loss, and a 32-task
    eval gathered against one process replaying each rank's episodes and
    draws. Here besides: launches per rank per step K1 2, K2 1, K3 0."""
    import torch

    from audio_few_shot_learning_tpu_torch.parallel.dryrun import STEPS, dryrun_multichip

    # the two rank processes share the card with this one, whose caching
    # allocator still holds 20-30 GB of free blocks from the earlier phases
    torch.cuda.empty_cache()
    out = dryrun_multichip(2, "gloo", "cuda", width="flagship", per_rank=4, eval_tasks=32)
    if out["launches_per_step"] != [[SPEC_LAUNCHES] * STEPS] * 2:
        raise AssertionError(f"two-rank steps launched K1, K2, K3 {out['launches_per_step']} per rank and step; "
                             f"expected {SPEC_LAUNCHES}")
    return out


def train_cli_phase():
    """``cli.train_test`` in-process on the card, on a dataset written by the
    port's ``make_synthetic_dataset``: 15 classes of 128x157 (5 per split,
    so every split holds a 5-way episode), band gain 4.0."""
    import torch

    from audio_few_shot_learning_tpu_torch.cli import train_test
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        make_synthetic_dataset(os.path.join(tmp, "synth"), n_classes=15, items_per_class=15,
                               n_mels=N_MELS, n_frames=N_FRAMES, split_fractions=(5, 5, 5),
                               band_gain=4.0)
        d = train_dict(tasks=16, num_runs=1)
        d.update(dataset_name="synth", data_root=tmp, n_testing_tasks=32, experiment_folder="smoke",
                 patience=5)
        with open(os.path.join(tmp, "exp.json"), "w") as f:
            json.dump(d, f)
        with open(os.path.join(tmp, "mdl.json"), "w") as f:
            json.dump({}, f)
        kernels = kernel_counters()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            results = train_test.main(["-e", os.path.join(tmp, "exp.json"), "-m",
                                       os.path.join(tmp, "mdl.json"),
                                       "--experiments-root", os.path.join(tmp, "experiments")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        path = os.path.join(tmp, "experiments", "smoke", "result_run0.json")
        if not os.path.exists(path):
            raise AssertionError("cli.train_test wrote no result_run0.json")
        with open(path) as f:
            result = json.load(f)
    if not result["mean_accuracy"] > 0.4:
        raise AssertionError(f"cli.train_test test accuracy {result} is not above 0.4")
    if not (launches[0] > 0 and launches[1] > 0):
        raise AssertionError(f"cli.train_test launched K1, K2, K3 {launches} times")
    return dict(result=result, results=results, wall_s=seconds, launches=launches)


# ---------------------------------------------------------------------------
# entry points: the sweep and aggregation CLIs, checkpoint conversion, the
# classifier API and profiling
# ---------------------------------------------------------------------------

SWEEP_VALUES = ("0", "30")
SWEEP_RUNS = 2
CLASSIFIER_ATOL = 1e-3  # the classifier's plain head vs the model's forward (K2), same views
ROUND_TRIP_SCORE_ATOL = 1e-6
PROFILE_STEPS = 8


def sweep_exp_dict(data_root) -> dict:
    """``configs/esc50_apl.json`` pointed at the synthetic set: 2 epochs x 16
    tasks at E=1, 32 test tasks, bf16."""
    with open(os.path.join(REPO, "configs", "esc50_apl.json")) as f:
        d = json.load(f)
    d.update(dataset_name="synth", data_root=data_root, num_epochs=2, n_training_tasks=16,
             n_testing_tasks=32, tpu={"episode_batch": 1, "eval_episode_batch": EVAL_BATCH,
                                      "compute_dtype": "bfloat16"})
    return d


def entry_points_phase(dev):
    """(a) ``cli.make_synthetic_dataset`` and ``cli.run_sweep`` (APL angle 0
    and 30, 2 runs each) read back by ``cli.aggregate_results``; (b)
    ``cli.convert_checkpoint`` to the JAX format and back, and ``test()``
    on both; (c) the classifier API on the trained weights; (d)
    ``Trainer.profile_epoch``."""
    import torch

    from audio_few_shot_learning_tpu_torch.cli import (
        aggregate_results, convert_checkpoint, make_synthetic_dataset, run_sweep,
    )
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, load_configs
    from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.models.classifier_api import (
        ContrastivePrototypicalNetworks, PrototypicalNetworks,
    )
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params, spec_augment_views
    from audio_few_shot_learning_tpu_torch.train import checkpoint as ckpt
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call

    kernels = kernel_counters()
    out = {}
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        # (a) synthetic data, the sweep, the aggregation
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            make_synthetic_dataset.main(["--root", os.path.join(tmp, "synth"), "--n-classes", "15",
                                         "--items-per-class", "15", "--splits", "5", "5", "5"])
        exp_json, mdl_json = os.path.join(tmp, "exp.json"), os.path.join(REPO, "configs", "model_config_esc50.json")
        with open(exp_json, "w") as f:
            json.dump(sweep_exp_dict(tmp), f)
        root = os.path.join(tmp, "experiments")
        data_s = time.perf_counter() - t0
        for k in kernels:
            k.launches = 0
        per_step = []
        t0 = time.perf_counter()
        with launches_per_call(Trainer, "train_step", per_step), contextlib.redirect_stdout(io.StringIO()):
            run_sweep.main(["-e", exp_json, "-m", mdl_json, "--key", "angle", "--values", *SWEEP_VALUES,
                            "--runs", str(SWEEP_RUNS), "--experiments-root", root])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sweep_launches = [k.launches for k in kernels]
        bad = [n for n in per_step if n != SPEC_LAUNCHES]
        steps_expected = len(SWEEP_VALUES) * SWEEP_RUNS * 2 * 16
        if bad or len(per_step) != steps_expected:
            raise AssertionError(f"sweep train steps launched K1, K2, K3 {bad[:3]} (of {len(per_step)} "
                                 f"steps, {steps_expected} expected); expected {SPEC_LAUNCHES} each")
        folders = sorted(os.listdir(root))
        want_folders = sorted(f"esc50_apl_angle={v}" for v in SWEEP_VALUES)
        if folders != want_folders:
            raise AssertionError(f"sweep folders {folders}, expected {want_folders}")
        results = {}
        for name in folders:
            files = os.listdir(os.path.join(root, name))
            for i in range(SWEEP_RUNS):
                if f"result_run{i}.json" not in files:
                    raise AssertionError(f"{name} has no result_run{i}.json: {sorted(files)}")
            results[name] = []
            for i in range(SWEEP_RUNS):
                with open(os.path.join(root, name, f"result_run{i}.json")) as f:
                    results[name].append(json.load(f))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            sw = aggregate_results.main([root, "--sweep", "angle", "--json"])
        summary = aggregate_results.collect(root)
        aggregate_s = time.perf_counter() - t0
        if sorted(sw["groups"]) != sorted(f"{float(v)}" for v in SWEEP_VALUES) or any(
                g["runs"] != SWEEP_RUNS for g in sw["groups"].values()):
            raise AssertionError(f"aggregate_results --sweep angle gave {sw}")
        for name, runs in results.items():
            accs = [r["mean_accuracy"] for r in runs]
            if summary[name]["run_accuracies"] != accs:
                raise AssertionError(f"{name}: aggregated {summary[name]['run_accuracies']}, files {accs}")
            if not all(a > 0.4 for a in accs):
                raise AssertionError(f"{name}: test accuracies {accs} not above 0.4")
        out["sweep"] = dict(
            data_s=data_s, sweep_s=sweep_s, aggregate_s=aggregate_s, train_steps=len(per_step),
            launches_per_step=per_step[0], launches=sweep_launches, groups=sw["groups"],
            run_accuracies={k: v["run_accuracies"] for k, v in summary.items()},
            train_episodes_per_s={k: [r["train_episodes_per_sec"] for r in v] for k, v in results.items()},
            train_seconds={k: [r["train_seconds"] for r in v] for k, v in results.items()},
        )

        # (b) the checkpoint round trip through the JAX format
        t0 = time.perf_counter()
        src = os.path.join(root, want_folders[0], "model.ckpt")
        cfg = ["-e", os.path.join(root, want_folders[0], "exp.json"), "-m", mdl_json]
        with open(os.path.join(root, want_folders[0], "config.json")) as f:
            swept = json.load(f)["experiment"]
        exp_d = sweep_exp_dict(tmp)
        exp_d["loss"] = swept["loss"]
        exp_d["n_testing_tasks"] = TEST_TASKS
        with open(cfg[1], "w") as f:
            json.dump(exp_d, f)
        jax_file, back_file = os.path.join(tmp, "jax_model.ckpt"), os.path.join(tmp, "back.ckpt")
        with contextlib.redirect_stdout(io.StringIO()):
            dirs = [convert_checkpoint.main(cfg + ["--input", src, "--output", jax_file]),
                    convert_checkpoint.main(cfg + ["--input", jax_file, "--output", back_file])]
        if dirs != ["to-jax", "from-jax"]:
            raise AssertionError(f"convert_checkpoint took the directions {dirs}")
        original = torch.load(src, weights_only=True)
        back = torch.load(back_file, weights_only=True)
        counters = sorted(k for k in original if k.endswith("num_batches_tracked"))
        differ = [k for k in original if k not in counters and not (
            back[k].dtype == original[k].dtype and torch.equal(back[k], original[k]))]
        if set(back) != set(original) or differ:
            raise AssertionError(f"round trip changed {differ[:5]} (keys equal: {set(back) == set(original)})")
        if any(back[k].item() != 0 for k in counters):
            raise AssertionError("the BatchNorm counters should come back as 0")
        exp, mdl = load_configs(cfg[1], mdl_json)
        try:
            ckpt.load_model(jax_file, torch.nn.Linear(1, 1))
            raise AssertionError("load_model read a JAX package file")
        except ValueError as err:
            if "convert_checkpoint" not in str(err):
                raise
        test_store = load_packed_split(exp, os.path.join(tmp, "synth"), "test", dev)
        trainers = []
        for sd in (original, back):
            trainer = Trainer(exp, mdl, test_store, test_store=test_store, seed=0, device=dev)
            trainer.model.load_state_dict(sd, strict=True)
            trainers.append(trainer)
        tested, test_launches = [], []
        for trainer in trainers:
            for k in kernels:
                k.launches = 0
            tested.append(trainer.test()["mean_accuracy"])
            test_launches.append([k.launches for k in kernels])
        if tested[0] != tested[1]:
            raise AssertionError(f"round-tripped weights test at {tested[1]}, the original at {tested[0]}")
        if test_launches[0] != [n * TEST_TASKS // EVAL_BATCH for n in SPEC_LAUNCHES]:
            raise AssertionError(f"test() launched K1, K2, K3 {test_launches[0]} times")
        scores = []
        for trainer in trainers:
            gen = torch.Generator(device=dev).manual_seed(3)
            with torch.inference_mode():
                ep = sample_episode(gen, test_store, N_WAY, K_SHOT, K_QUERY, EVAL_BATCH)
                scores.append(trainer._episode_scores(ep, N_WAY, True, gen).float())
        score_err = float((scores[0] - scores[1]).abs().max())
        if not score_err <= ROUND_TRIP_SCORE_ATOL:
            raise AssertionError(f"round-tripped scores differ by {score_err}")
        out["checkpoint"] = dict(
            seconds=time.perf_counter() - t0, tensors_equal=len(original) - len(counters),
            counters_reset=len(counters), jax_file_bytes=os.path.getsize(jax_file), test_accuracy=tested,
            test_launches=test_launches, score_max_abs_err=score_err, tolerance=ROUND_TRIP_SCORE_ATOL,
        )

        # (c) the classifier API on the trained weights
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(4)
        with torch.inference_mode():
            ep = sample_episode(gen, test_store, N_WAY, K_SHOT, K_QUERY, 1)
        params = exp.specaug_params
        f_len, t_len = ep.support.shape[-2:]
        n_items = N_WAY * K_SHOT
        draws = [draw_views_params(gen, params, 1, n_items, f_len, t_len, dev) for _ in range(2)]
        for k in kernels:
            k.launches = 0
        sup_v = spec_augment_views(ep.support, None, params, draws=draws[0])[0]
        qry_v = spec_augment_views(ep.query, None, params, draws=draws[1])[0]
        labels = ep.support_labels[0]
        view_launches = [k.launches for k in kernels]
        clf = PrototypicalNetworks(exp, mdl, state_dict=original, device=dev)
        encode, k4_encode, k5_encode = [], [], []
        for call in (lambda: clf.process_support_set(sup_v, labels), lambda: clf(qry_v)):
            before, k4_before = [k.launches for k in kernels], block0_counter().launches
            k5_before = blocks_counter().launches
            result = call()
            encode.append([k.launches - b for k, b in zip(kernels, before)])
            k4_encode.append(block0_counter().launches - k4_before)
            k5_encode.append(blocks_counter().launches - k5_before)
        clf_scores = result.float()
        with torch.inference_mode():
            model_scores = clf.model(sup_v, qry_v, labels, N_WAY).scores.float()
        clf_err = float((clf_scores - model_scores).abs().max())
        if not (clf_err <= CLASSIFIER_ATOL and torch.equal(clf_scores.argmax(-1), model_scores.argmax(-1))):
            raise AssertionError(f"classifier scores {clf_err} off the model's forward, or another argmax")
        if (view_launches != [2, 0, 0] or any(n != [0, 1, 0] for n in encode) or k4_encode != [1, 1]
                or k5_encode != [k5_per_forward(clf.model)] * 2):
            raise AssertionError(f"views launched {view_launches}, encode calls {encode}, K4 {k4_encode}, "
                                 f"K5 {k5_encode}")
        exp32 = dataclasses.replace(exp, tpu=dataclasses.replace(exp.tpu, compute_dtype="float32"))
        pair = []
        for device in (dev, "cpu"):
            c = PrototypicalNetworks(exp32, mdl, state_dict=original, device=device)
            c.process_support_set(sup_v.to(device), labels.to(device))
            pair.append(c(qry_v.to(device)).float().cpu())
        f32_err = float((pair[0] - pair[1]).abs().max())
        agree = float((pair[0].argmax(-1) == pair[1].argmax(-1)).float().mean())
        if not (f32_err <= SLICE_ATOL and agree >= SLICE_ARGMAX_AGREE):
            raise AssertionError(f"float32 classifier card vs CPU: {f32_err}, argmax agreement {agree}")
        con = ContrastivePrototypicalNetworks(exp, mdl, state_dict=original, device=dev)
        con.process_support_set(sup_v, labels)
        perm = torch.tensor([3, 1, 2])
        feats, protos = con.contrastive_forward(qry_v, True, perm=perm)
        shapes = [list(feats.shape), list(protos.shape)]
        if shapes != [[N_WAY * K_QUERY, mdl.projection.output_dim], [N_WAY, mdl.projection.output_dim]] or not (
                torch.isfinite(feats).all() and torch.isfinite(protos).all()):
            raise AssertionError(f"contrastive_forward gave shapes {shapes} or non-finite values")
        out["classifier"] = dict(
            seconds=time.perf_counter() - t0, view_launches=view_launches, launches_per_encode_call=encode,
            k4_launches_per_encode_call=k4_encode, k5_launches_per_encode_call=k5_encode,
            scores_max_abs_err_vs_forward=clf_err, tolerance=CLASSIFIER_ATOL, compute_dtype=exp.tpu.compute_dtype,
            float32_card_vs_cpu_max_abs_err=f32_err, float32_argmax_agreement=agree,
            accuracy=float((clf_scores.argmax(-1) == ep.query_labels[0]).float().mean()),
            contrastive_shapes=shapes,
        )

        # (d) profiling
        t0 = time.perf_counter()
        prof_d = sweep_exp_dict(tmp)
        prof_d["n_training_tasks"] = PROFILE_STEPS
        prof_exp = ExperimentConfig.from_dict(prof_d)
        train_store = load_packed_split(prof_exp, os.path.join(tmp, "synth"), "train", dev)
        trainer = Trainer(prof_exp, mdl, train_store, seed=0, device=dev)
        log_dir = os.path.join(tmp, "profile")
        metrics = trainer.profile_epoch(log_dir)
        traces = [n for n in os.listdir(log_dir) if n.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"profile_epoch wrote {traces}")
        with open(os.path.join(log_dir, traces[0])) as f:
            text = f.read()
        names = {"views_kernel": text.count("views_kernel"), "episode_scores_kernel": text.count("episode_scores_kernel")}
        if not all(names.values()) or not np.isfinite(metrics["loss"]):
            raise AssertionError(f"the trace names K1 and K2 {names} times; metrics {metrics}")
        out["profile"] = dict(seconds=time.perf_counter() - t0, steps=trainer.steps_per_epoch,
                              trace_mb=len(text) / 1e6, kernel_name_mentions=names, metrics=metrics)
    return out


# ---------------------------------------------------------------------------
# multi-segment evaluation and preprocessing
# ---------------------------------------------------------------------------


def multiseg_kernel_cases(dev, e_flag6, e_flag36, e_plain36, e_wav):
    """K1, K2 and K3 at the shapes the multi-segment phases gave them, with
    each phase's eval batch E as the engine reckoned it, each against its
    plain version and timed as in the kernel phase: K1 on the flagship's
    queries at s_max 6 ([E, 150, 128, 157] f32) and 36 ([E, 900, 128, 157]);
    K2 at Q = 25 x 6 = 150 (flagship D 256, wav D 64) and 25 x 36 = 900
    (flagship D 256, plain D 64); K3 at the wav eval batch at s_max 6
    (M = E x 25 x 7 x 157, online) and at a 36-segment file (M = 5 652,
    offline)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import SpecAugParams
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    gen = torch.Generator(device=dev).manual_seed(20)
    rows = {}
    params = SpecAugParams(use=True, mask_param=6, W=29, num_mask=1, mask_value=0.0, p=0.298)
    k1 = []
    for e, s_max in ((e_flag6, 6), (e_flag36, 36)):
        b = N_WAY * K_QUERY * s_max
        spec = torch.randn((e, b, N_MELS, N_FRAMES), generator=gen, device=dev)
        ys, tm, fm = specaugment.draw_views_params(gen, params, e, b, N_MELS, N_FRAMES, dev)
        k1.append(k1_case(f"flagship queries E={e} s_max {s_max}", (spec, ys, tm, fm, params.mask_value),
                          dtype="float32"))
        del spec
        torch.cuda.empty_cache()
    rows["K1"] = k1

    k2 = []
    s = N_WAY * K_SHOT
    lab_np = np.repeat(np.arange(N_WAY), K_SHOT)
    for e, s_max, d in ((e_flag6, 6, 256), (e_wav, 6, 64), (e_flag36, 36, 256), (e_plain36, 36, 64)):
        q = N_WAY * K_QUERY * s_max
        fused = torch.randn((e, s + q, d), generator=gen, device=dev)
        sup, qry = fused[:, :s], fused[:, s:]
        lab = torch.as_tensor(lab_np, device=dev).expand(e, -1)
        out = protohead.episode_scores_cuda(sup, lab, qry, N_WAY)
        ref = protohead.batched_episode_scores_reference(sup, lab, qry, N_WAY)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, atol=K2_ATOL, rtol=K2_RTOL):
            raise AssertionError(f"K2 at E={e} Q={q} D={d} disagrees with its plain version: {err}")
        plan = protohead.head_plan(e, s, q, d, N_WAY)
        protos = protohead.compute_prototypes(sup, lab, N_WAY)
        flops = e * (s * d + q * N_WAY * 2 * d + q * 2 * d + N_WAY * 3 * d)
        b_ms, b_by = bound_ms(nbytes(sup, qry, out) + lab.untyped_storage().nbytes(), flops)
        k2.append(dict(
            case=f"E={e} Q={q} D={d}", e=e, q=q, d=d, blocks=plan.blocks, q_tile=plan.q_tile,
            max_abs_err=err, tolerance=[K2_ATOL, K2_RTOL],
            ms=graph_ms(lambda: protohead.episode_scores_cuda(sup, lab, qry, N_WAY)),
            plain_ms=graph_ms(lambda: protohead.batched_episode_scores_reference(sup, lab, qry, N_WAY)),
            library_ms=graph_ms(lambda: torch.cdist(qry, protos)), bound_ms=b_ms, bound_by=b_by,
        ))
    rows["K2"] = k2

    k3 = []
    for case, flavor, clips in (
        (f"wav eval batch E={e_wav}, s_max 6", "online", e_wav * N_WAY * (K_SHOT + K_QUERY * 6)),
        ("36-segment file", "offline", 36),
    ):
        spec = mel.MelSpec(flavor)
        wav = 0.3 * torch.randn((clips, CLIP), generator=gen, device=dev)
        pspec = mel.power_spectrogram(wav, pad_mode=spec.pad_mode)
        del wav
        fb = torch.from_numpy(spec.fb).to(dev)
        bands = mel.band_table(spec.fb).to(dev)
        args = (pspec, fb, spec.log_mult, spec.eps)
        out = mel.mel_log_cuda(*args, bands)
        ref = mel.mel_log_reference(*args).transpose(-1, -2)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= K3_ATOL_DB:
            raise AssertionError(f"K3 {case} disagrees with its plain version: {err} dB")
        m = pspec.numel() // N_BINS
        b_ms, b_by = bound_ms(nbytes(pspec, fb, out), 2 * m * bands.weights.numel())
        ms = graph_ms(lambda: mel.mel_log_cuda(*args, bands))
        k3.append(dict(
            case=case, flavor=flavor, m=m, elements=pspec.numel(), max_abs_err=err,
            tolerance=K3_ATOL_DB, ms=ms, plain_ms=graph_ms(lambda: mel.mel_log_reference(*args)),
            library_ms=graph_ms(lambda: torch.log10(torch.matmul(pspec, fb))),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
        ))
        del pspec, out, ref
    rows["K3"] = k3
    torch.cuda.empty_cache()
    return rows


def make_multiseg_store(dev, n_classes, per_class, s_max, seed, host_dtype=None):
    """Seeded 128x157 f32 items of 1..s_max segments (item 0 has s_max);
    with ``host_dtype`` in a HostStore."""
    from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, s_max + 1, n_classes * per_class)
    counts[0] = s_max
    segments = rng.standard_normal((int(counts.sum()), N_MELS, N_FRAMES), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    if host_dtype:
        return HostStore.from_flat_arrays(segments, counts, labels, n_classes, dtype=host_dtype)
    return PackedStore.from_flat_arrays(segments, counts, labels, n_classes, device=dev)


def make_multiseg_wav_store(dev, host_dtype=None):
    """35 classes x 20 clips of 1-30 s of seeded noise at 16 kHz, 5-s
    segments (s_max 6): ~700 MB on the card; with ``host_dtype`` in a
    WavHostStore."""
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    n_classes, per_class = 35, 20
    rng = np.random.default_rng(2)
    lengths = rng.integers(SR, 30 * SR + 1, n_classes * per_class)
    lengths[0] = 30 * SR
    clips = [0.3 * rng.standard_normal(int(n), dtype=np.float32) for n in lengths]
    labels = np.repeat(np.arange(n_classes), per_class)
    if host_dtype:
        return WavHostStore.pack(clips, labels, n_classes, mean=WAV_MEAN, std=WAV_STD, multi_segm=True,
                                 dtype=host_dtype)
    return PackedWavStore.pack(clips, labels, n_classes, mean=WAV_MEAN, std=WAV_STD,
                               multi_segm=True, device=dev)


def birdclef_dict(name, **over):
    """``configs/birdclef_{cpl,plain}.json`` as shipped, on the card, bf16."""
    with open(os.path.join(REPO, "configs", f"birdclef_{name}.json")) as f:
        d = json.load(f)
    d.update(device="cuda", **over)
    d.setdefault("tpu", {})
    d["tpu"].update(eval_episode_batch=EVAL_BATCH, compute_dtype="bfloat16")
    return d


def multiseg_phase(dev, store, exp_dict, expected, tasks, tie_tasks=0, profile_run=True, timed_runs=TIMED_RUNS):
    """``Trainer.test()`` with ``multi_segm`` over ``tasks`` tasks (the
    config's tie strategy), launches of K1, K2, K3 (and K4, one) per eval batch asserted;
    the eval batch E the engine reckoned from the free memory, and the peak
    of allocated memory over one batch against the reckoned bytes (it must
    stay within ``EVAL_PEAK_FACTOR``); with ``tie_tasks``, ``evaluate`` under
    the other two tie strategies; then TIMED_RUNS runs of TIMED_BATCHES full
    batches of E for the rate (median) and a profiler pass over one more."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.train import engine

    exp = ExperimentConfig.from_dict({**exp_dict, "n_testing_tasks": tasks})
    kernels, k4, k5 = kernel_counters(), block0_counter(), blocks_counter()
    trainer = engine.Trainer(exp, ModelConfig(), store, test_store=store, device=dev, seed=0)
    aug = exp.test_query_augmentations
    run = dict(n_way=N_WAY, k_shot=K_SHOT, k_query=K_QUERY, augment_query=aug, multisegment=True)

    # one batch at the reckoned E; warms cuDNN up
    m = engine.measure_eval_peak(trainer, store, tasks, N_WAY, K_SHOT, K_QUERY, aug, exp.tie_strategy)
    e, episode_bytes, peak, factor = m["eval_batch"], m["episode_bytes"], m["peak_bytes"], m["peak_factor"]
    free, free_card = m["free_bytes"], m["free_reported_by_card"]
    if not (m["ran_batch"] == e and factor <= engine.EVAL_PEAK_FACTOR
            and peak <= engine.EVAL_MEMORY_SHARE * free):
        raise AssertionError(
            f"eval batch E={trainer.last_eval_batch} (reckoned {e}); its peak {peak / 1e9:.2f} GB is "
            f"{factor:.3f} x the reckoned block-0 bytes (EVAL_PEAK_FACTOR {engine.EVAL_PEAK_FACTOR}) "
            f"and {peak / free:.3f} of the free memory (EVAL_MEMORY_SHARE {engine.EVAL_MEMORY_SHARE})")

    for k in (*kernels, k4, k5):
        k.launches = 0
    result = trainer.test()
    launches = [k.launches for k in kernels]
    acc = result["mean_accuracy"]
    if not (np.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"multi-segment test accuracy out of range: {result}")
    n_batches = -(-tasks // trainer.last_eval_batch)
    per_batch = [n / n_batches for n in launches]
    k4_per_batch, k5_per_batch = k4.launches / n_batches, k5.launches / n_batches
    if per_batch != expected or k4_per_batch != 1 or k5_per_batch != k5_per_forward(trainer.model):
        raise AssertionError(f"multi-segment eval launched K1, K2, K3 {per_batch} times per batch "
                             f"({launches} in {n_batches} batches), K4 {k4_per_batch}, K5 {k5_per_batch}; "
                             f"expected {expected}, K4 1 and K5 {k5_per_forward(trainer.model)}")
    # the rate: runs of TIMED_BATCHES full batches of the reckoned E
    timed = TIMED_BATCHES * e
    eval_s = []
    for _ in range(timed_runs):
        trainer.evaluate(store, timed, tie_strategy=exp.tie_strategy, **run)
        if trainer.last_eval_batch != e:
            raise AssertionError(f"timed run took E={trainer.last_eval_batch}, the first {e}")
        eval_s.append(trainer.last_eval_seconds)
    ties = {}
    others = [t for t in ("", "min_label", "max_posterior") if t != exp.tie_strategy] if tie_tasks else []
    for tie in others:
        mean, std = trainer.evaluate(store, tie_tasks, tie_strategy=tie, **run)
        if not 0.0 <= mean <= 1.0:
            raise AssertionError(f"{tie!r} vote accuracy out of range: {mean}")
        ties[tie or '""'] = dict(mean=mean, std=std, tasks=tie_tasks, seconds=trainer.last_eval_seconds)
    prof = profile(lambda: trainer.evaluate(store, timed, tie_strategy=exp.tie_strategy, **run)) \
        if profile_run else None
    eps = [timed / t for t in eval_s]
    return dict(
        s_max=store.s_max, tie_strategy=exp.tie_strategy, test=result,
        eval_batch=trainer.last_eval_batch, free_gb=free / 1e9, free_reported_by_card_gb=free_card / 1e9,
        episode_block0_gb=episode_bytes / 1e9, peak_over_one_batch_gb=peak / 1e9,
        peak_factor=factor, peak_factor_limit=engine.EVAL_PEAK_FACTOR, peak_share_of_free=peak / free,
        share_limit=engine.EVAL_MEMORY_SHARE,
        launches=launches, launches_per_batch=per_batch, k4_launches_per_batch=k4_per_batch,
        k5_launches_per_batch=k5_per_batch, batches=n_batches,
        timed_tasks=timed, timed_batches=TIMED_BATCHES, timed_runs=timed_runs, eval_seconds=eval_s, eval_episodes_per_s=eps, eval_episodes_per_s_median=float(np.median(eps)),
        other_tie_strategies=ties, profile=prof,
    )


def multiseg_card_vs_cpu_phase(dev, store, exp_dict, input_type):
    """One float32 multi-segment eval batch at E=2, same weights, episode
    and augmentation draws, card (kernels) vs CPU (plain versions): scores
    within SLICE_ATOL, argmax agreement; and the card's vote accuracies
    equal, exactly, the reference's host loop on the card's own scores,
    for every tie strategy."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.train.evaluate import majority_vote_accuracy_host

    e = 2
    d = json.loads(json.dumps(exp_dict))
    d["tpu"].update(compute_dtype="float32", eval_episode_batch=e)
    exp = ExperimentConfig.from_dict(d)
    card = Trainer(exp, ModelConfig(), store, device=dev, seed=3)
    cpu = Trainer(exp, ModelConfig(), store, device="cpu", seed=3)  # the store only gives shapes
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    ep = sample_episode(torch.Generator(device=dev).manual_seed(5), store, N_WAY, K_SHOT, K_QUERY, e,
                        is_test=True)
    ep_cpu = episode_to_cpu(ep)
    qtot = ep.query.shape[1]
    draws_card = draws_cpu = None
    if input_type == "spec":
        g = torch.Generator().manual_seed(6)
        draws_cpu = tuple(draw_views_params(g, exp.specaug_params, e, n, N_MELS, N_FRAMES, "cpu")
                          for n in (N_WAY * K_SHOT, qtot))
        draws_card = tuple(tuple(x.to(dev) for x in dr) for dr in draws_cpu)
    aug = exp.test_query_augmentations
    t0 = time.perf_counter()
    with torch.inference_mode():
        s_card = card._episode_scores(ep, N_WAY, aug, card.gen, draws_card, store)
        votes = {tie: Trainer.vote_accuracy(s_card, ep, N_WAY, tie, store.s_max).cpu().numpy()
                 for tie in ("", "min_label", "max_posterior")}
        s_card = s_card.cpu()
        card_s = time.perf_counter() - t0
        s_cpu = cpu._episode_scores(ep_cpu, N_WAY, aug, cpu.gen, draws_cpu, store)
    err = (s_card - s_cpu).abs().max().item()
    agree = (s_card.argmax(-1) == s_cpu.argmax(-1)).float().mean().item()
    if not (err <= SLICE_ATOL and agree >= SLICE_ARGMAX_AGREE):
        raise AssertionError(f"{input_type} multi-segment card vs CPU: max err {err}, argmax agree {agree}")
    first = s_card[:, :qtot].numpy()
    mask = ep_cpu.query_mask.numpy() > 0
    for tie, got in votes.items():
        want = np.array([
            majority_vote_accuracy_host(first[i].argmax(-1)[mask[i]], ep_cpu.audio_ids[i].numpy()[mask[i]],
                                        ep_cpu.query_labels[i].numpy()[mask[i]], first[i].max(-1)[mask[i]], tie)
            for i in range(e)], np.float32)
        if not np.array_equal(got, want):
            raise AssertionError(f"card vote {got} != host oracle {want} for tie strategy {tie!r}")
    return dict(episodes=e, s_max=store.s_max, query_rows=qtot, max_abs_err=err, atol=SLICE_ATOL,
                argmax_agree=agree, votes_equal_host_oracle=True,
                card_votes={k or '""': v.tolist() for k, v in votes.items()}, card_s=card_s)


def tone_tree(root, rng):
    """Class-foldered .wav files: 15 classes x 12 clips of 1-20 s at 16 kHz,
    each class a tone of its own (and its octave) in noise."""
    import scipy.io.wavfile

    lengths = []
    for c in range(15):
        d = os.path.join(root, f"class{c:02d}")
        os.makedirs(d)
        f0 = 150.0 * 1.25 ** c
        for i in range(12):
            n = int(rng.integers(SR, 20 * SR + 1))
            t = np.arange(n) / SR
            x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(4 * np.pi * f0 * t)
            x = x + 0.2 * rng.standard_normal(n)
            scipy.io.wavfile.write(os.path.join(d, f"clip{i:02d}.wav"), SR, (x * 32767 / 1.5).astype(np.int16))
            lengths.append(n)
    return lengths


def preprocess_phase(dev):
    """The offline chain on the card on a seeded tone tree: ``wav_dir_to_npy``
    -> ``npy_dir_to_var_spec`` (one K3 launch per file) -> ``compute_global_norm``
    -> ``make_splits(counts=(5, 5, 5))`` (5 classes a split: each must hold a
    5-way episode) -> ``compute_waveform_norm``; then ``cli.train_test`` on
    the result with the flagship multi-segment config (1 run, 2 epochs x 16
    tasks, 32 test tasks): ``result_run0.json``'s accuracy must exceed 0.4.
    Last, ``npy_dir_to_spec`` on 2 classes x 3 fixed 5-s clips, each output
    against K3's plain version on the same power spectrogram."""
    import torch

    from audio_few_shot_learning_tpu_torch.cli import train_test
    from audio_few_shot_learning_tpu_torch.ops import mel
    from audio_few_shot_learning_tpu_torch.preprocessing import (
        compute_global_norm, compute_waveform_norm, make_splits, npy_dir_to_spec,
        npy_dir_to_var_spec, wav_dir_to_npy,
    )

    rng = np.random.default_rng(9)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    out = {}
    kernels = kernel_counters()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        main_dir = os.path.join(tmp, "tones")
        lengths = tone_tree(os.path.join(tmp, "audio"), rng)
        quiet = dict(log_fn=lambda *_: None)
        t0 = time.perf_counter()
        n_npy = wav_dir_to_npy(os.path.join(tmp, "audio"), os.path.join(main_dir, "Sorted_npy"), **quiet)
        t_npy = time.perf_counter() - t0
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        n_spec = npy_dir_to_var_spec(os.path.join(main_dir, "Sorted_npy"), os.path.join(main_dir, "features"),
                                     device=dev, **quiet)
        torch.cuda.synchronize()
        t_spec = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        if n_npy != len(lengths) or n_spec != n_npy or launches != [0, 0, n_spec]:
            raise AssertionError(f"to_var_spec wrote {n_spec} of {n_npy} files with K1, K2, K3 launches "
                                 f"{launches}; expected one K3 launch per file")
        t0 = time.perf_counter()
        compute_global_norm(os.path.join(main_dir, "features"), os.path.join(main_dir, "norm_stats", "glob_norm.npy"))
        make_splits(os.path.join(main_dir, "features"), os.path.join(main_dir, "splits.npy"), counts=(5, 5, 5))
        wf = compute_waveform_norm(os.path.join(main_dir, "Sorted_npy"),
                                   os.path.join(main_dir, "norm_stats", "waveform_norm.npy"))
        t_rest = time.perf_counter() - t0
        segs = [np.load(os.path.join(main_dir, "features", c, f), mmap_mode="r").shape
                for c in sorted(os.listdir(os.path.join(main_dir, "features")))
                for f in os.listdir(os.path.join(main_dir, "features", c))]
        want_segs = sorted(max(1, -(-n // CLIP)) for n in lengths)
        if sorted(s[0] for s in segs) != want_segs or {s[1:] for s in segs} != {(N_MELS, N_FRAMES)}:
            raise AssertionError("to_var_spec wrote unexpected feature shapes")
        out["preprocess"] = dict(
            files=n_spec, audio_s=sum(lengths) / SR, segments=int(sum(want_segs)), s_max=max(want_segs),
            wav_dir_to_npy_s=t_npy, to_var_spec_s=t_spec, to_var_spec_files_per_s=n_spec / t_spec,
            norms_and_splits_s=t_rest, to_var_spec_launches=launches, waveform_norm=wf.tolist(),
        )

        d = birdclef_dict("cpl", dataset_name="tones", data_root=tmp, n_training_tasks=16,
                          n_testing_tasks=32, num_epochs=2, experiment_folder="smoke", patience=5)
        d["tpu"]["num_runs"] = 1
        with open(os.path.join(tmp, "exp.json"), "w") as f:
            json.dump(d, f)
        with open(os.path.join(tmp, "mdl.json"), "w") as f:
            json.dump({}, f)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_test.main(["-e", os.path.join(tmp, "exp.json"), "-m", os.path.join(tmp, "mdl.json"),
                             "--experiments-root", os.path.join(tmp, "experiments")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = [k.launches for k in kernels]
        path = os.path.join(tmp, "experiments", "smoke", "result_run0.json")
        if not os.path.exists(path):
            raise AssertionError("cli.train_test wrote no result_run0.json")
        with open(path) as f:
            result = json.load(f)
        if not result["mean_accuracy"] > 0.4:
            raise AssertionError(f"cli.train_test on the preprocessed set: accuracy {result} is not above 0.4")
        out["train_test"] = dict(result=result, wall_s=cli_s, launches=cli_launches)

        fixed_npy, fixed_spec = os.path.join(tmp, "fixed_npy"), os.path.join(tmp, "fixed_spec")
        for c in range(2):
            os.makedirs(os.path.join(fixed_npy, f"c{c}"))
            for i in range(3):
                np.save(os.path.join(fixed_npy, f"c{c}", f"{i}.npy"), 0.3 * rng.standard_normal(CLIP, dtype=np.float32))
        for k in kernels:
            k.launches = 0
        n_fixed = npy_dir_to_spec(fixed_npy, fixed_spec, sample_length=5, device=dev, **quiet)
        spec_launches = [k.launches for k in kernels]
        offline = mel.MelSpec("offline")
        fb = torch.from_numpy(offline.fb).to(dev)
        worst = 0.0
        for c in range(2):
            wav = torch.from_numpy(np.stack([np.load(os.path.join(fixed_npy, f"c{c}", f"{i}.npy"))
                                             for i in range(3)])).to(dev)
            pspec = mel.power_spectrogram(wav, pad_mode=offline.pad_mode)
            ref = mel.mel_log_reference(pspec, fb, offline.log_mult, offline.eps).transpose(-1, -2).cpu().numpy()
            for i in range(3):
                worst = max(worst, float(np.abs(np.load(os.path.join(fixed_spec, f"c{c}", f"{i}.npy")) - ref[i]).max()))
        if n_fixed != 6 or spec_launches != [0, 0, 2] or not worst <= K3_ATOL_DB:
            raise AssertionError(f"npy_dir_to_spec wrote {n_fixed} files in {spec_launches} launches, "
                                 f"{worst} dB off K3's plain version")
        out["to_spec"] = dict(files=n_fixed, launches=spec_launches, max_abs_err_db=worst, tolerance=K3_ATOL_DB)
    return out


# ---------------------------------------------------------------------------
# WaveAugment and the model variants
# ---------------------------------------------------------------------------


def wavaug_train_phase(dev, store):
    """(a) ``Trainer.train_epoch`` with WaveAugment (bench.py:98-104: the
    flagship on wav input, aug_num 3, the default chain) at E=1 for 2 epochs
    of 32 tasks, launches per step K1 0, K2 1, K3 1; then the chain alone on
    the step's rows under the profiler (its device time against the step's,
    its top kernels, ms per call by CUDA events); then one step with each of
    the knobs of WAVEAUG_KNOBS, launches asserted."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.ops.waveaugment import WaveAugment
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    exp = train_exp("wav", waveaug=WAVEAUG, episode_batch=1)
    out = train_phase(dev, store, exp, WAV_LAUNCHES)
    aug = WaveAugment(exp.waveaug_params, dataset_name=exp.dataset_name)
    gen = torch.Generator(device=dev).manual_seed(3)
    items = torch.arange(N_WAY * (K_SHOT + K_QUERY), device=dev)
    x = store.extract_segment(items, torch.zeros_like(items))[None]  # [1, 50, L], the step's rows
    steps = out["profile_steps"]
    chain_prof = profile(lambda: [aug(x, gen) for _ in range(steps)])
    for _ in range(3):
        aug(x, gen)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        aug(x, gen)
    end.record()
    torch.cuda.synchronize()
    out["chain"] = dict(
        rows=int(x.shape[1]) * exp.waveaug_params.aug_num, ms_per_call=start.elapsed_time(end) / 10,
        device_share_of_step=chain_prof["device_busy_us"] / out["profile"]["device_busy_us"],
        device_us_per_step=chain_prof["device_busy_us"] / steps, profile=chain_prof,
        row_bytes_reckoned=aug.row_bytes(CLIP),
    )

    kernels = kernel_counters()
    knobs = {}
    for name, knob in WAVEAUG_KNOBS.items():
        trainer = Trainer(train_exp("wav", waveaug={**WAVEAUG, **knob}, episode_batch=1), ModelConfig(),
                          store, device=dev, seed=0)
        ep = sample_episode(trainer.gen, store, N_WAY, K_SHOT, K_QUERY, 1)
        trainer.train_step(ep)  # warm-up
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = trainer.train_step(ep).tolist()
        seconds = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        if launches != WAV_LAUNCHES or not all(np.isfinite(metrics)):
            raise AssertionError(f"WaveAugment {name} step: launches {launches}, metrics {metrics}")
        knobs[name] = dict(metrics=metrics, launches=launches, step_s=seconds,
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["knob_steps"] = knobs
    return out


def chain_card_vs_cpu_phase(dev, store):
    """(c) The chain on the train step's rows ([1, 50, 80 000], aug_num 3),
    the same draws given as data, card float32 against CPU float32: each
    augmented row within CHAIN_RMS_TOL of its input row's RMS. The default
    chain and the fuse_lowpass knob (with time stretch and inversion)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import WaveAugParams
    from audio_few_shot_learning_tpu_torch.ops.waveaugment import WaveAugment

    items = torch.arange(N_WAY * (K_SHOT + K_QUERY), device=dev)
    x = store.extract_segment(items, torch.zeros_like(items))[None]
    x_cpu = x.cpu()
    rms = x_cpu.double().square().mean(-1).sqrt()[0]  # [50]
    rows = {}
    for name, raw in (("default", WAVEAUG), ("fuse_lowpass", {**WAVEAUG, **WAVEAUG_KNOBS["fuse_lowpass"]})):
        aug = WaveAugment(WaveAugParams.from_dict(raw))
        draws = aug.draw(torch.Generator().manual_seed(4), (1, aug.params.aug_num, x.shape[1]), CLIP, "cpu")
        got = aug(x, draws=chain_to(draws, dev)).cpu()
        want = aug(x_cpu, draws=draws)
        err = ((got - want).abs().amax(-1)[0] / rms[:, None]).max().item()  # [50, 4] over the input RMS
        if not err <= CHAIN_RMS_TOL:
            raise AssertionError(f"WaveAugment {name} card vs CPU: {err} of the row RMS (tolerance {CHAIN_RMS_TOL})")
        rows[name] = dict(max_err_over_rms=err, tolerance=CHAIN_RMS_TOL, rows=int(got.shape[1] * (got.shape[2] - 1)))
    return rows


def variant_phase(dev, store, exp, expected, check_bn=False):
    """(d) One train step and one eval batch (E=16) of a model variant on
    the spec store, launches of K1, K2, K3 per step (per chunk) and per
    batch asserted; with ``check_bn``, every BatchNorm moved once per chunk."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels = kernel_counters()
    trainer = Trainer(exp, ModelConfig(), store, val_store=store, test_store=store, device=dev, seed=0)
    e = trainer.episode_batch
    chunks = e // (trainer.microbatch or e)
    ep = sample_episode(trainer.gen, store, N_WAY, K_SHOT, K_QUERY, e)
    trainer.train_step(ep)  # warm-up
    bn_before = bn_counts(trainer.model)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = trainer.train_step(ep).tolist()
    step_s = time.perf_counter() - t0
    train_launches = [k.launches for k in kernels]
    bn_moves = [b - a for a, b in zip(bn_before, bn_counts(trainer.model))]
    if train_launches != [n * chunks for n in expected] or not all(np.isfinite(metrics)):
        raise AssertionError(f"variant step launched K1, K2, K3 {train_launches} in {chunks} chunk(s) "
                             f"(expected {expected} per chunk); metrics {metrics}")
    if check_bn and bn_moves != [chunks] * len(bn_moves):
        raise AssertionError(f"BatchNorm statistics moved {bn_moves} times in {chunks} chunks")
    for k in kernels:
        k.launches = 0
    mean, _ = trainer.evaluate(store, EVAL_BATCH, N_WAY, K_SHOT, K_QUERY, True)
    eval_launches = [k.launches for k in kernels]
    if eval_launches != expected or not 0.0 <= mean <= 1.0:
        raise AssertionError(f"variant eval batch launched K1, K2, K3 {eval_launches} (expected {expected}); "
                             f"accuracy {mean}")
    return dict(episode_batch=e, chunks=chunks, remat=trainer.exp.tpu.remat_enabled(), metrics=metrics,
                train_launches=train_launches, bn_updates=bn_moves, step_s=step_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, eval_launches=eval_launches,
                eval_accuracy=mean, eval_s=trainer.last_eval_seconds)


def k3_wavaug_cases(dev):
    """(e) K3 at the WaveAugment path's shapes: a train step at E=1 (M = 50
    x 4 x 157 = 31 400) and a single-segment eval batch at E=16 (M = 16 x
    50 x 4 x 157 = 502 400), online flavour."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(30)
    views = 1 + WAVEAUG["aug_num"]
    rows = [k3_case(dev, gen, "wavaug train step E=1", "online", N_WAY * (K_SHOT + K_QUERY) * views, CLIP),
            k3_case(dev, gen, f"wavaug eval batch E={EVAL_BATCH}", "online",
                    EVAL_BATCH * N_WAY * (K_SHOT + K_QUERY) * views, CLIP)]
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# host-resident streaming: HostStore / WavHostStore through the staging
# ---------------------------------------------------------------------------


def copy_stats(traces) -> dict:
    """The staged copies' own device times (CUDA events on the copy stream)
    and bytes, from the ``trace`` lists of stagers."""
    copies = [c for trace in traces for c in trace]
    ms = [a.elapsed_time(b) for a, b, _ in copies]
    n = [x for _, _, x in copies]
    return dict(copies=len(ms), copy_ms_median=float(np.median(ms)), copy_ms_total=float(sum(ms)),
                bytes_per_copy=float(np.mean(n)), h2d_gb_per_s=sum(n) / max(sum(ms), 1e-9) / 1e6)


@contextlib.contextmanager
def traced_stagers():
    """Every ``Trainer.stager`` made inside records its copies; yields the
    list of their traces."""
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    traces, make = [], Trainer.stager.fget

    def traced(self):
        stager = make(self)
        if stager.trace is None:
            stager.trace = []
            traces.append(stager.trace)
        return stager

    Trainer.stager = property(traced)
    try:
        yield traces
    finally:
        Trainer.stager = property(make)


def store_row(store) -> dict:
    return dict(store=type(store).__name__, store_dtype=str(store.dtype).replace("torch.", ""),
                store_gb=store.nbytes() / 1e9)


def hostfed_train_phase(dev, store, exp, expected, device_row, epochs=2):
    """``Trainer.train_epoch`` on a host store (the host sampler, pinned
    double-buffered copies), launches of K1, K2, K3 per step (per chunk; K4 none)
    asserted as on the device store; ms per step and episodes/s beside
    ``device_row`` (the device-store train phase of this run), H2D bytes per
    step, the copy's own time, and the device's busy share under the
    profiler over one more epoch; then ``validate()``."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels, k4, k5 = kernel_counters(), block0_counter(), blocks_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(exp, ModelConfig(), store, val_store=store, test_store=store, device=dev, seed=0)
    if not trainer.host_mode:
        raise AssertionError("a host store should put the trainer in host mode")
    e, steps = trainer.episode_batch, trainer.steps_per_epoch
    chunks = e // (trainer.microbatch or e)
    for k in (*kernels, k4, k5):
        k.launches = 0
    epochs_out = [trainer.train_epoch()]
    launches, k4_launches, k5_launches = [k.launches for k in kernels], k4.launches, k5.launches
    want = [n * chunks for n in expected]
    if [n / steps for n in launches] != want or k4_launches or k5_launches:
        raise AssertionError(f"host-fed train launched K1, K2, K3 {launches} times in {steps} steps, K4 "
                             f"{k4_launches}, K5 {k5_launches}; expected {want} per step and K4, K5 0 (train mode)")
    trainer.stager.trace = []
    h2d0 = trainer.stager.h2d_bytes
    for _ in range(1, epochs):
        epochs_out.append(trainer.train_epoch())
    step_ms = trainer.last_step_ms  # the last epoch's
    for out in epochs_out:
        if not all(np.isfinite(out[k]) for k in ("loss", "fsl_loss", "cpl_loss")):
            raise AssertionError(f"non-finite host-fed training losses: {epochs_out}")
    copies = copy_stats([trainer.stager.trace]) if epochs > 1 else None
    h2d_per_step = (trainer.stager.h2d_bytes - h2d0) / (steps * (epochs - 1)) if epochs > 1 else None
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile(trainer.train_epoch)
    val = trainer.validate()
    if not 0.0 <= val[0] <= 1.0:
        raise AssertionError(f"host-fed validation accuracy out of range: {val}")
    med = float(np.median(step_ms))
    return dict(
        **store_row(store), episode_batch=e, chunks=chunks, steps_per_epoch=steps, epochs=epochs_out,
        launches_first_epoch=launches, launches_per_step=[n / steps for n in launches],
        k4_launches_per_step=k4_launches / steps, k5_launches_per_step=k5_launches / steps, step_ms=step_ms,
        step_ms_median=med, step_ms_min=min(step_ms), train_episodes_per_s_median=1e3 * e / med,
        device_store_step_ms_median=device_row["step_ms_median"], device_store_step_ms_min=min(device_row["step_ms"]),
        device_store_episodes_per_s_median=device_row["train_episodes_per_s_median"],
        step_ms_over_device_store=med / device_row["step_ms_median"], h2d_bytes_per_step=h2d_per_step,
        copy=copies, peak_mem_gb=peak, device_busy_share=prof["device_busy_share"], profile=prof,
        validate=dict(mean=val[0], std=val[1], seconds=trainer.last_eval_seconds),
    )


def hostfed_eval_phase(dev, store, input_type, expected, device_row):
    """``Trainer.test()`` (single segment, E=16, 64 tasks) and one
    ``predict_episode`` with a host store as train and test store, launches
    per batch and per prediction asserted; rates over 4 more runs beside
    ``device_row`` (the device-store serve phase of this run), bytes and
    copy time per batch, the busy share under the profiler."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    kernels, k4, k5 = kernel_counters(), block0_counter(), blocks_counter()
    trainer = Trainer(flagship_exp(input_type), ModelConfig(), store, test_store=store, device=dev, seed=0)
    trainer.evaluate(store, EVAL_BATCH, N_WAY, K_SHOT, K_QUERY, True)  # warm-up: cuDNN plans, buffers
    for k in (*kernels, k4, k5):
        k.launches = 0
    result = trainer.test()
    launches = [k.launches for k in kernels]
    n_batches = TEST_TASKS // EVAL_BATCH
    per_batch = [n / n_batches for n in launches]
    k4_per_batch, k5_per_batch = k4.launches / n_batches, k5.launches / n_batches
    k5_want = k5_per_forward(trainer.model)
    if (per_batch != expected or k4_per_batch != 1 or k5_per_batch != k5_want
            or not 0.0 <= result["mean_accuracy"] <= 1.0):
        raise AssertionError(f"host-fed {input_type} eval launched K1, K2, K3 {per_batch} per batch, K4 "
                             f"{k4_per_batch}, K5 {k5_per_batch} (expected {expected}, K4 1 and K5 {k5_want}); "
                             f"{result}")
    trainer.stager.trace = []
    eval_s = [trainer.last_eval_seconds]
    for _ in range(4):
        trainer.evaluate(store, TEST_TASKS, N_WAY, K_SHOT, K_QUERY, True)
        eval_s.append(trainer.last_eval_seconds)
    torch.cuda.synchronize()
    copies = copy_stats([trainer.stager.trace])
    trainer.stager.trace = None
    prof = profile(lambda: trainer.evaluate(store, TEST_TASKS, N_WAY, K_SHOT, K_QUERY, True))
    ep = store.sample_episode_batch(np.random.default_rng(1), N_WAY, K_SHOT, K_QUERY)
    support, query = ep.support[0].float().numpy(), ep.query[0].float().numpy()
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    trainer.predict_episode(support, labels, query)  # warm-up
    for k in (*kernels, k4, k5):
        k.launches = 0
    t0 = time.perf_counter()
    _, scores = trainer.predict_episode(support, labels, query)
    predict_ms = 1e3 * (time.perf_counter() - t0)
    predict_launches = [k.launches for k in kernels]
    if (predict_launches != expected or k4.launches != 1 or k5.launches != k5_want
            or scores.shape != (N_WAY * K_QUERY, N_WAY) or not np.isfinite(scores).all()):
        raise AssertionError(f"host-fed predict launched K1, K2, K3 {predict_launches}, K4 {k4.launches}, "
                             f"K5 {k5.launches}; scores {scores.shape}")
    eps = [TEST_TASKS / t for t in eval_s]
    med = float(np.median(eps))
    return dict(
        **store_row(store), test=result, launches=launches, launches_per_batch=per_batch,
        k4_launches_per_batch=k4_per_batch, k4_launches_per_predict=k4.launches,
        k5_launches_per_batch=k5_per_batch, k5_launches_per_predict=k5.launches, eval_episodes_per_s=eps, eval_episodes_per_s_median=med,
        eval_batch_ms_median=1e3 * float(np.median(eval_s)) / n_batches,
        device_store_eval_episodes_per_s_median=device_row["eval_episodes_per_s_median"],
        device_store_eval_batch_ms_median=device_row["eval_batch_ms_median"],
        rate_over_device_store=med / device_row["eval_episodes_per_s_median"],
        h2d_bytes_per_batch=copies["bytes_per_copy"], copy=copies, device_busy_share=prof["device_busy_share"],
        profile=prof, predict_ms=predict_ms, predict_launches=predict_launches,
    )


def hostfed_multiseg_phase(dev, store, exp_dict, expected, tasks, device_row, profile_run=True):
    """``multiseg_phase`` on a host store (E as the engine reckons it, the
    peak over one batch held under its rule, launches per batch asserted),
    its rate beside ``device_row`` (the device-store phase of this run), and
    the staged bytes and copy time per batch."""
    import torch

    with traced_stagers() as traces:
        out = multiseg_phase(dev, store, exp_dict, expected, tasks, profile_run=profile_run)
    torch.cuda.synchronize()
    copies = copy_stats(traces)
    med = out["eval_episodes_per_s_median"]
    out.update(
        **store_row(store), device_store_eval_batch=device_row["eval_batch"],
        device_store_eval_episodes_per_s_median=device_row["eval_episodes_per_s_median"],
        rate_over_device_store=med / device_row["eval_episodes_per_s_median"],
        h2d_bytes_per_batch=copies["bytes_per_copy"], copy=copies,
        device_busy_share=out["profile"]["device_busy_share"] if profile_run else None,
    )
    return out


def checksum(t):
    """An order-free integer checksum of a tensor's bits, equal on any
    device: the int16/int32 patterns weighted by position, summed in int64."""
    import torch

    bits = t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16).reshape(-1).long()
    weights = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return (bits * weights).sum()


def batch_checksums(ep):
    import torch

    fields = [ep.support, ep.query] + ([ep.query_mask] if ep.query_mask is not None else [])
    return torch.stack([checksum(x) for x in fields])


def staging_integrity_phase(dev, spec_store, wav_store):
    """Checksums of every batch as it arrives on the card (computed there,
    on the compute stream, and read back once at the end) for one host-fed
    train epoch (spec, bf16, E=1, 32 steps) and one host-fed eval run (wav,
    f16, E=16, 64 tasks, 128 MB a batch), held exactly against the same
    batches regenerated on the host from the same Generator and staged as
    the engine stages them on the CPU. A slot refilled before its copy had
    finished would show here."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ModelConfig
    from audio_few_shot_learning_tpu_torch.data.staging import EpisodeStager
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    seen = []
    stage = EpisodeStager.stage

    def recording(self, store, p):
        ep = stage(self, store, p)
        seen.append(batch_checksums(ep))
        return ep

    out = {}
    for name, store, exp, run in (
        ("train_spec_bf16", spec_store, train_exp(episode_batch=1), "train"),
        ("eval_wav_f16", wav_store, flagship_exp("wav"), "eval"),
    ):
        trainer = Trainer(exp, ModelConfig(), store, val_store=store, test_store=store, device=dev, seed=4)
        before = trainer.gen.get_state()
        seen.clear()
        EpisodeStager.stage = recording
        try:
            if run == "train":
                trainer.train_epoch()
                sizes, is_test = [trainer.episode_batch] * trainer.steps_per_epoch, False
            else:
                trainer.test()
                sizes, is_test = [EVAL_BATCH] * (TEST_TASKS // EVAL_BATCH), False
        finally:
            EpisodeStager.stage = stage
        card = torch.stack(seen).cpu()  # the one read back
        trainer.gen.set_state(before)
        rng = trainer.host_rng()  # the Generator the run drew its batches from
        cpu = EpisodeStager("cpu")
        host = torch.stack([batch_checksums(cpu.stage(store, store.plan(rng, N_WAY, K_SHOT, K_QUERY, is_test, e)))
                            for e in sizes])
        if card.shape != host.shape or not torch.equal(card, host):
            raise AssertionError(f"staging integrity {name}: card {card.shape} vs host {host.shape}, "
                                 f"{int((card != host).any(-1).sum()) if card.shape == host.shape else '?'} "
                                 "batches changed")
        out[name] = dict(batches=len(sizes), checksums_per_batch=card.shape[1], equal=True)
    return out


def native_pack_phase():
    """A seeded tree of 35 classes x 40 .npy spec files of 128x157 f32 (112
    MB, written by ``make_synthetic_dataset``) packed to float32 and
    bfloat16 by the native packer and by the numpy path
    (``native_pack.normalize``): equal bit for bit; files/s and GB/s of file
    data for both (the library built first, its g++ time apart; the native
    time includes the loader's probe of every header, also timed alone)."""
    import torch

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig
    from audio_few_shot_learning_tpu_torch.data import native_pack
    from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset, make_synthetic_dataset

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    native_pack.get_lib()
    out = dict(gxx_build_s=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = make_synthetic_dataset(os.path.join(tmp, "ds"), n_classes=37, items_per_class=40, n_mels=N_MELS,
                                      n_frames=N_FRAMES, split_fractions=(35, 1, 1))
        ds = MetaAudioDataset(ExperimentConfig.from_dict({"device": "cpu"}), root, "train")
        files, gb = len(ds.filepaths), sum(p.stat().st_size for p in ds.filepaths) / 1e9
        t0 = time.perf_counter()
        elems, _, _ = native_pack.probe_files(ds.filepaths)  # the loader's header check, one call for the split
        out["probe_s"] = time.perf_counter() - t0
        if (elems < 0).any():
            raise AssertionError("the packer's probe refused a regular file")
        for dtype, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
            t0 = time.perf_counter()
            native = ds._pack_spec_native(dtype)
            native_s = time.perf_counter() - t0
            if native is None:
                raise AssertionError("the native packer refused a regular tree")
            t0 = time.perf_counter()
            items = [native_pack.normalize(np.load(p)[None], ds.mean, ds.std) for p in ds.filepaths]
            numpy_path = torch.from_numpy(np.concatenate(items)).to(dtype)
            numpy_s = time.perf_counter() - t0
            if not torch.equal(native[0].view(bits), numpy_path.view(bits)):
                raise AssertionError(f"native packer and numpy path differ in {dtype}")
            out[str(dtype).replace("torch.", "")] = dict(
                files=files, file_gb=gb, bit_equal=True, native_s=native_s, numpy_s=numpy_s,
                native_files_per_s=files / native_s, numpy_files_per_s=files / numpy_s,
                native_gb_per_s=gb / native_s, numpy_gb_per_s=gb / numpy_s)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.ops import cuda_build

    dev = resolve_device("cuda:0")  # as every entry point: TF32 off (device.py)
    started = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.sources())
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs) or 'nothing (cached)'} from csrc/ with nvcc for sm_90a "
          f"in {build_s:.1f} s", flush=True)
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kern = kernel_phase(dev)
    print("kernel phase: " + json.dumps(kern), flush=True)

    store = make_store(dev)
    slc = serve_phase(dev, store, "spec", SPEC_LAUNCHES)
    print(f"spec slice phase ({card}): " + json.dumps(slc), flush=True)

    t0 = time.perf_counter()
    cmp = card_vs_cpu_phase(dev, store, "spec")
    cmp["seconds"] = time.perf_counter() - t0
    print("spec card vs CPU: " + json.dumps(cmp), flush=True)

    k2_bwd = k2_backward_phase(dev)
    print("K2 backward: " + json.dumps(k2_bwd), flush=True)
    train = train_phase(dev, store, train_exp(episode_batch=1), SPEC_LAUNCHES)
    print(f"spec train phase, E=1 ({card}): " + json.dumps(train), flush=True)
    k1_graph = {f"{r['case']} {r['dtype']}": r["ms"] for r in kern["K1"]}
    print(f"K1 per launch ({card}): " + json.dumps(dict(
        graph_replay_ms=k1_graph, k1_us_per_launch_in_eval=slc["eval_profile"]["k1_us_per_launch"],
        k1_us_per_launch_in_train=train["profile"]["k1_us_per_launch"])), flush=True)
    accum = train_phase(dev, store, train_exp(tasks=24, episode_batch=8, episode_microbatch=4),
                        SPEC_LAUNCHES, epochs=1, profile_steps=2, check_bn=True)
    print(f"spec train phase, E=8 in chunks of 4 with remat ({card}): " + json.dumps(accum), flush=True)
    if not accum["remat"]:
        raise AssertionError("episode_microbatch 4 should turn remat on")
    t0 = time.perf_counter()
    dp1 = dp_world1_phase(dev, store, accum)
    dp1["seconds"] = time.perf_counter() - t0
    print(f"(a) data-parallel phase, one rank over NCCL ({card}): " + json.dumps(dp1), flush=True)
    t0 = time.perf_counter()
    dp2 = dp_two_ranks_phase()
    dp2["seconds"] = time.perf_counter() - t0
    print(f"(b) data-parallel phase, two ranks on one card over gloo ({card}): " + json.dumps(dp2), flush=True)
    t0 = time.perf_counter()
    host_store = make_store(dev, host_dtype="bfloat16")
    print(f"host spec store: {host_store.nbytes() / 1e6:.1f} MB bf16 in host RAM, packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    host_train = hostfed_train_phase(dev, host_store, train_exp(episode_batch=1), SPEC_LAUNCHES, train)
    print(f"(a) host-fed spec train phase, E=1 ({card}): " + json.dumps(host_train), flush=True)
    host_accum = hostfed_train_phase(dev, host_store, train_exp(tasks=24, episode_batch=8, episode_microbatch=4),
                                     SPEC_LAUNCHES, accum, epochs=1)
    print(f"(a) host-fed spec train phase, E=8 in chunks of 4 ({card}): " + json.dumps(host_accum), flush=True)
    host_eval = hostfed_eval_phase(dev, host_store, "spec", SPEC_LAUNCHES, slc)
    print(f"(b) host-fed spec eval phase, E=16 ({card}): " + json.dumps(host_eval), flush=True)
    apl = train_phase(dev, store, train_exp(loss="apl", tasks=4, episode_batch=1), SPEC_LAUNCHES,
                      epochs=1, profile_steps=2)
    print(f"APL train phase ({card}): " + json.dumps(apl), flush=True)
    variants = {}
    for name, exp, expected, check_bn in (
        ("cnn", train_exp(episode_batch=1, over={"encoder_name": "CNN"}), SPEC_LAUNCHES, False),
        ("relation", train_exp(episode_batch=1, over={"relation_head": True}), [2, 0, 0], False),
        ("bn_per_view_group", train_exp(episode_batch=8, episode_microbatch=4, bn_per_view_group=True),
         SPEC_LAUNCHES, True),
    ):
        variants[name] = variant_phase(dev, store, exp, expected, check_bn)
        print(f"variant {name}: train step + eval batch ({card}): " + json.dumps(variants[name]), flush=True)
    t0 = time.perf_counter()
    train_cmp = train_card_vs_cpu_phase(dev, store)
    train_cmp["seconds"] = time.perf_counter() - t0
    print("train step card vs CPU: " + json.dumps(train_cmp), flush=True)
    bf16 = dict(spec_eval=bf16_eval_phase(dev, store, "spec"), train_step=bf16_train_phase(dev, store))
    for name in ("spec_eval", "train_step"):
        print(f"bf16 phase, {name}, card vs CPU ({card}): " + json.dumps(bf16[name]), flush=True)
    del store

    ms_store = make_multiseg_store(dev, 35, 40, 6, seed=1)
    print(f"multi-segment store: {ms_store.segments.numel() * 4 / 1e6:.1f} MB, s_max {ms_store.s_max}",
          flush=True)
    ms_flag = multiseg_phase(dev, ms_store, birdclef_dict("cpl"), SPEC_LAUNCHES, TEST_TASKS,
                             tie_tasks=MULTISEG_TIE_TASKS)
    print(f"multi-segment spec phase, flagship, s_max 6 ({card}): " + json.dumps(ms_flag), flush=True)
    t0 = time.perf_counter()
    ms_cmp = multiseg_card_vs_cpu_phase(dev, ms_store, birdclef_dict("cpl"), "spec")
    ms_cmp["seconds"] = time.perf_counter() - t0
    print("multi-segment spec card vs CPU: " + json.dumps(ms_cmp), flush=True)
    del ms_store
    host_ms = hostfed_multiseg_phase(dev, make_multiseg_store(dev, 35, 40, 6, seed=1, host_dtype="bfloat16"),
                                     birdclef_dict("cpl"), SPEC_LAUNCHES, TEST_TASKS, ms_flag)
    print(f"(b) host-fed multi-segment spec phase, flagship, s_max 6 ({card}): " + json.dumps(host_ms), flush=True)
    s36_store = make_multiseg_store(dev, 12, 10, 36, seed=2)
    print(f"s_max 36 store: {s36_store.segments.numel() * 4 / 1e6:.1f} MB", flush=True)
    s36 = {}
    for name, launches in (("cpl", SPEC_LAUNCHES), ("plain", PLAIN_LAUNCHES)):
        s36[name] = multiseg_phase(dev, s36_store, birdclef_dict(name, tie_strategy="max_posterior"),
                                   launches, S36_TASKS)
        print(f"multi-segment spec phase, {name}, s_max 36 ({card}): " + json.dumps(s36[name]), flush=True)
    del s36_store
    host_s36 = hostfed_multiseg_phase(dev, make_multiseg_store(dev, 12, 10, 36, seed=2, host_dtype="bfloat16"),
                                      birdclef_dict("cpl", tie_strategy="max_posterior"), SPEC_LAUNCHES, S36_TASKS,
                                      s36["cpl"], profile_run=False)
    print(f"(b) host-fed multi-segment spec phase, flagship, s_max 36 ({card}): " + json.dumps(host_s36), flush=True)

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
    bf16["wav_eval"] = bf16_eval_phase(dev, wav_store, "wav")
    print(f"bf16 phase, wav_eval, card vs CPU ({card}): " + json.dumps(bf16["wav_eval"]), flush=True)
    bf16_launches = [sum(row["launches"][i] for row in bf16.values()) for i in range(3)]
    if not all(bf16_launches):
        raise AssertionError(f"the bf16 phase launched K1-K3 {bf16_launches} times")
    wav_train = train_phase(dev, wav_store, train_exp("wav", tasks=4, episode_batch=1), WAV_LAUNCHES,
                            epochs=1, profile_steps=2)
    print(f"wav train phase ({card}): " + json.dumps(wav_train), flush=True)
    t0 = time.perf_counter()
    host_wav_store = make_wav_store(dev, host_dtype="float16")
    print(f"host wav store: {host_wav_store.nbytes() / 1e6:.1f} MB f16 in host RAM, packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    host_wav_eval = hostfed_eval_phase(dev, host_wav_store, "wav", WAV_LAUNCHES, wav)
    print(f"(c) host-fed wav eval phase, E=16 ({card}): " + json.dumps(host_wav_eval), flush=True)
    host_wav_train = hostfed_train_phase(dev, host_wav_store, train_exp("wav", episode_batch=1), WAV_LAUNCHES,
                                         wav_train)
    print(f"(c) host-fed wav train phase, E=1 ({card}): " + json.dumps(host_wav_train), flush=True)
    integrity = staging_integrity_phase(dev, host_store, host_wav_store)
    print("(d) staging integrity: " + json.dumps(integrity), flush=True)
    del host_store, host_wav_store
    wa_train = wavaug_train_phase(dev, wav_store)
    print(f"WaveAugment train phase, E=1 ({card}): " + json.dumps(wa_train), flush=True)
    wa = serve_phase(dev, wav_store, "wav", WAV_LAUNCHES, waveaug=WAVEAUG)
    print(f"WaveAugment eval + predict phase ({card}): " + json.dumps(wa), flush=True)
    t0 = time.perf_counter()
    wa_cmp = dict(chain=chain_card_vs_cpu_phase(dev, wav_store),
                  eval=card_vs_cpu_phase(dev, wav_store, "wav", waveaug=WAVEAUG, e=2),
                  train=train_card_vs_cpu_phase(dev, wav_store, "wav", WAVEAUG, WAVAUG_TRAIN_GRAD_REL))
    wa_cmp["seconds"] = time.perf_counter() - t0
    print("WaveAugment card vs CPU: " + json.dumps(wa_cmp), flush=True)
    del wav_store

    t0 = time.perf_counter()
    mw_store = make_multiseg_wav_store(dev)
    print(f"multi-segment wav store: {mw_store.nbytes() / 1e6:.1f} MB on the card, s_max "
          f"{mw_store.s_max}, packed in {time.perf_counter() - t0:.1f} s", flush=True)
    mw_dict = flagship_dict("wav")
    mw_dict["multi_segm"] = True
    mw = multiseg_phase(dev, mw_store, mw_dict, WAV_LAUNCHES, TEST_TASKS)
    print(f"multi-segment wav phase ({card}): " + json.dumps(mw), flush=True)
    t0 = time.perf_counter()
    host_mw_store = make_multiseg_wav_store(dev, host_dtype="float16")
    print(f"host multi-segment wav store: {host_mw_store.nbytes() / 1e6:.1f} MB f16, packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    host_mw = hostfed_multiseg_phase(dev, host_mw_store, mw_dict, WAV_LAUNCHES, TEST_TASKS, mw)
    print(f"(c) host-fed multi-segment wav phase ({card}): " + json.dumps(host_mw), flush=True)
    del host_mw_store
    t0 = time.perf_counter()
    mw_cmp = multiseg_card_vs_cpu_phase(dev, mw_store, mw_dict, "wav")
    mw_cmp["seconds"] = time.perf_counter() - t0
    print("multi-segment wav card vs CPU: " + json.dumps(mw_cmp), flush=True)
    mwa_dict = flagship_dict("wav", WAVEAUG)
    mwa_dict["multi_segm"] = True
    mwa = multiseg_phase(dev, mw_store, mwa_dict, WAV_LAUNCHES, 16, profile_run=False, timed_runs=1)
    print(f"multi-segment WaveAugment phase ({card}): " + json.dumps(mwa), flush=True)
    del mw_store
    kern_ms = multiseg_kernel_cases(dev, ms_flag["eval_batch"], s36["cpl"]["eval_batch"],
                                    s36["plain"]["eval_batch"], mw["eval_batch"])
    print("multi-segment kernel cases: " + json.dumps(kern_ms), flush=True)
    k3_wa = k3_wavaug_cases(dev)
    print("K3 at the WaveAugment shapes: " + json.dumps(k3_wa), flush=True)

    packer = native_pack_phase()
    print("(e) native packer: " + json.dumps(packer), flush=True)
    cli = cli_phase(dev)
    print("raw-audio CLI: " + json.dumps(cli), flush=True)
    train_cli = train_cli_phase()
    print("cli.train_test: " + json.dumps(train_cli), flush=True)
    resume = resume_phase()
    print(f"resume on the card ({card}): " + json.dumps(resume), flush=True)
    parity = parity_dry_run_phase()
    for line in parity["lines"]:
        print(f"parity dry run ({card}): {line}", flush=True)
    print(f"parity dry run: 15 configs in {parity['seconds']:.1f} s", flush=True)
    protocol = full_protocol_phase()
    print(f"full protocol, cut to {PROTOCOL_EPOCHS} epochs x {PROTOCOL_TASKS} tasks ({card}): "
          + json.dumps(protocol), flush=True)
    scale = scale_drivers_phase()
    print(f"dataset-scale drivers, reduced depth ({card}): " + json.dumps(scale), flush=True)
    ported = ported_drivers_phase()
    for name, row in ported["drivers"].items():
        print(f"ported driver {name}, reduced depth ({card}): " + json.dumps(row), flush=True)
    print(f"ported drivers: {len(ported['drivers'])} runs in {ported['total_seconds']:.1f} s: "
          + json.dumps(ported["seconds"]), flush=True)
    bench_run = bench_driver_phase()
    print(f"bench driver, default mode, in {bench_run['seconds']:.1f} s ({card}): " + json.dumps(bench_run["line"]),
          flush=True)
    entry = entry_points_phase(dev)
    for name, row in entry.items():
        print(f"entry points, {name} ({card}): " + json.dumps(row), flush=True)
    prep = preprocess_phase(dev)
    print(f"preprocessing + multi-segment cli.train_test ({card}): " + json.dumps(prep), flush=True)

    k1_f32, k2_flag, k3_eval = kern["K1"][0], kern["K2"][0], kern["K3"][0]
    train_path = [train, train, wav_train]  # K3 trains on the wav path only
    common = [
        dict(name="specaugment_views",
             source="audio_few_shot_learning_tpu_torch/csrc/specaugment.cu",
             replaces="audio_few_shot_learning_tpu/ops/specaugment.py:228", row=k1_f32,
             path=slc, library_ms=None, in_eval_us=slc["eval_profile"]["k1_us_per_launch"],
             extra=dict(bf16=kern["K1"][1], device_ops_per_call=k1_f32["device_ops_per_call"],
                        graph_nodes_per_call=k1_f32["graph_nodes_per_call"],
                        train_step_cases=kern["K1"][2:4], nsynth_cases=kern["K1"][4:], in_train_us=train["profile"]["k1_us_per_launch"],
                        **multiseg_launches(0, ms_flag, s36, None), multiseg_cases=kern_ms["K1"],
                        launches_per_wavaug_eval_batch=wa["eval_launches_per_batch"][0])),
        dict(name="episode_scores",
             source="audio_few_shot_learning_tpu_torch/csrc/protohead.cu",
             replaces="audio_few_shot_learning_tpu/ops/protohead.py:136", row=k2_flag,
             path=slc, library_ms=k2_flag["library_ms"],
             in_eval_us=slc["eval_profile"]["k2_us_per_launch"],
             extra=dict(library="torch.cdist on precomputed prototypes",
                        device_ops_per_call=k2_flag["device_ops_per_call"],
                        cases=kern["K2"][1:], wav_path_launches=wav["eval_launches"][1],
                        backward=k2_bwd, in_train_us=train["profile"]["k2_us_per_launch"],
                        **multiseg_launches(1, ms_flag, s36, mw), multiseg_cases=kern_ms["K2"],
                        launches_per_wavaug_train_step=wa_train["launches_per_step"][1],
                        launches_per_wavaug_eval_batch=wa["eval_launches_per_batch"][1],
                        launches_per_wavaug_multiseg_batch=mwa["launches_per_batch"][1],
                        in_wavaug_eval_us=wa["eval_profile"]["k2_us_per_launch"],
                        variant_train_launches={k: v["train_launches"][1] for k, v in variants.items()})),
        dict(name="mel_log",
             source="audio_few_shot_learning_tpu_torch/csrc/mel.cu",
             replaces="audio_few_shot_learning_tpu/ops/mel.py:179", row=k3_eval,
             path=wav, library_ms=k3_eval["library_ms"],
             in_eval_us=wav["eval_profile"]["k3_us_per_launch"],
             extra=dict(library="torch.matmul + torch.log10 (two calls, without eps and log_mult)",
                        bound_ms_dense_flops=k3_eval["bound_ms_dense_flops"],
                        cases=kern["K3"][1:], cli_launches=cli["launches"][2],
                        in_train_us=wav_train["profile"]["k3_us_per_launch"],
                        **multiseg_launches(2, ms_flag, s36, mw),
                        launches_to_var_spec=prep["preprocess"]["to_var_spec_launches"][2],
                        to_var_spec_files=prep["preprocess"]["files"],
                        launches_to_spec=prep["to_spec"]["launches"][2], multiseg_cases=kern_ms["K3"],
                        launches_per_wavaug_train_step=wa_train["launches_per_step"][2],
                        launches_per_wavaug_eval_batch=wa["eval_launches_per_batch"][2],
                        launches_per_wavaug_multiseg_batch=mwa["launches_per_batch"][2],
                        in_wavaug_eval_us=wa["eval_profile"]["k3_us_per_launch"], wavaug_cases=k3_wa)),
    ]
    hostfed = dict(hostfed_train=host_train, hostfed_accum=host_accum, hostfed_eval=host_eval,
                   hostfed_multiseg_s6=host_ms, hostfed_multiseg_s36=host_s36, hostfed_wav_eval=host_wav_eval,
                   hostfed_wav_train=host_wav_train, hostfed_multiseg_wav=host_mw)
    kernels = []
    for i, k in enumerate(common):
        r, path = k["row"], k["path"]
        kernels.append(dict(
            name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
            launches=path["eval_launches"][i],
            launches_per_eval_batch=path["eval_launches_per_batch"][i],
            launches_predict=path["predict_launches"][i],
            launches_train=train_path[i]["launches_first_epoch"][i],
            launches_per_train_step=train_path[i]["launches_per_step"][i],
            launches_per_train_step_in_chunks=accum["launches_per_step"][i],
            max_abs_err=r["max_abs_err"],
            tolerance=r["tolerance"], ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=1e3 * r["bound_ms"], bound_by=r["bound_by"],
            library_ms=k["library_ms"], launch_floor_ms=kern["launch_floor_ms"],
            profiler_us_in_eval=k["in_eval_us"], **k["extra"],
            # per step (train) or per batch (eval) from a host store
            **{f"launches_per_{name}": row.get("launches_per_step", row.get("launches_per_batch"))[i]
               for name, row in hostfed.items()},
            launches_per_sweep_train_step=entry["sweep"]["launches_per_step"][i],
            launches_per_dp_one_rank_step=dp1["bf16"]["launches_per_step"][i],
            launches_per_dp_rank_step_two_ranks=dp2["launches_per_step"][0][0][i],
            launches_per_classifier_encode_call=entry["classifier"]["launches_per_encode_call"][0][i],
            launches_bf16_phase=bf16_launches[i],
            launches_per_protocol_train_step=per_call(protocol["single_segment"]["launches_per_train_step"], i),
            launches_per_protocol_eval_batch=per_call(protocol["single_segment"]["launches_per_eval_batch"], i),
            launches_per_parity_train_step={f"{c['dataset']}_{c['loss']}": per_call(c["launches_per_train_step"], i)
                                            for c in parity["cells"]},
            launches_per_nsynth_scale_train_step={name: per_call(arm["launches_per_train_step"], i)
                                                  for name, arm in scale["nsynth_arms"].items()},
            launches_per_nsynth_scale_eval_batch={name: per_call(arm["launches_per_eval_batch"], i)
                                                  for name, arm in scale["nsynth_arms"].items()},
            launches_per_wav_scale_train_step=per_call(scale["wav"]["launches_per_train_step"], i),
            launches_per_wav_scale_eval_batch=per_call(scale["wav"]["launches_per_eval_batch"], i),
            launches_per_ported_driver_train_step={name: sorted({per_call({k: 1}, i) for k in row["launches_per_train_step"]})
                                                   for name, row in ported["drivers"].items()
                                                   if row["launches_per_train_step"]},
            launches_per_bench_headline_step=per_call(bench_run["line"]["launches_per_step"], i),
        ))
    # last: its plain version's 9.5-19 GB maps at 3 700 maps stay out of the
    # other phases' memory (the multi-segment phases reckon E from what is free)
    k4 = k4_phase(dev, kern["K4"])
    print(f"K4 phase ({card}): " + json.dumps(k4), flush=True)
    r = k4[0]  # the flagship eval batch, bf16
    kernels.append(dict(
        name="block0_conv", route="cuda", source="audio_few_shot_learning_tpu_torch/csrc/block0.cu",
        replaces="cuDNN conv + ATen bias add_ + max_pool2d + relu of eval block 0 (ConvBlock._block); "
                 "no TPU kernel (XLA fuses the block)",
        launches=slc["k4_eval_launches"], launches_per_eval_batch=slc["k4_launches_per_eval_batch"],
        launches_predict=slc["k4_launches_per_predict"], launches_per_train_step=train["k4_launches_per_step"],
        launches_per_train_step_in_chunks=accum["k4_launches_per_step"],
        max_abs_err=r["max_abs_err"], tolerance=r["tolerance"], ms=r["ms"], kernel_ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_us=1e3 * r["bound_ms"], bound_by=r["bound_by"],
        share_of_bound=r["share_of_bound"], bound_ms_tensor_cores=r["bound_ms_tensor_cores"],
        bound_by_tensor_cores=r["bound_by_tensor_cores"], share_of_tensor_core_bound=r["share_of_tensor_core_bound"],
        library_ms=r["library_ms"], library="cuDNN conv + ATen add_ + max_pool2d + relu (today's code on the card)",
        launch_floor_ms=kern["launch_floor_ms"], device_ops_per_call=r["device_ops_per_call"],
        graph_nodes_per_call=r["graph_nodes_per_call"], cases=k4[1:],
        launches_per_wav_eval_batch=wav["k4_launches_per_eval_batch"],
        launches_wav_predict=wav["k4_launches_per_predict"],
        launches_per_wavaug_eval_batch=wa["k4_launches_per_eval_batch"],
        launches_per_wav_train_step=wav_train["k4_launches_per_step"],
        launches_per_multiseg_batch_s6=ms_flag["k4_launches_per_batch"],
        **{f"launches_per_multiseg_batch_s36_{name}": run["k4_launches_per_batch"] for name, run in s36.items()},
        launches_per_multiseg_batch_wav=mw["k4_launches_per_batch"],
        launches_per_wavaug_multiseg_batch=mwa["k4_launches_per_batch"],
        **{f"launches_per_{name}": row.get("k4_launches_per_step", row.get("k4_launches_per_batch"))
           for name, row in hostfed.items()},
        launches_hostfed_predict=host_eval["k4_launches_per_predict"],
        launches_hostfed_wav_predict=host_wav_eval["k4_launches_per_predict"],
        launches_per_classifier_encode_call=entry["classifier"]["k4_launches_per_encode_call"],
    ))
    k5 = k5_phase(dev, kern["K5"])
    print(f"K5 phase ({card}): " + json.dumps(k5), flush=True)
    r = k5[3]  # block 1 of a multi-segment batch
    kernels.append(dict(
        name="block_conv", route="cuda", source="audio_few_shot_learning_tpu_torch/csrc/convblocks.cu",
        replaces="cuDNN conv (with its NCHW <-> NHWC transposes) + ATen bias add_ + max_pool2d + relu of eval "
                 "blocks 1-3 (ConvBlock._block); no TPU kernel (XLA fuses the blocks)",
        launches=slc["k5_eval_launches"], launches_per_eval_batch=slc["k5_launches_per_eval_batch"],
        launches_predict=slc["k5_launches_per_predict"], launches_per_train_step=train["k5_launches_per_step"],
        launches_per_train_step_in_chunks=accum["k5_launches_per_step"],
        max_abs_err=r["max_abs_err"], tolerance=r["tolerance"], ms=r["ms"], kernel_ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms_tensor_cores"], bound_us=1e3 * r["bound_ms_tensor_cores"],
        bound_by="operations", share_of_bound=r["share_of_tensor_core_bound"],
        bound_ms_bytes=r["bound_ms_bytes"], library_ms=r["library_ms"],
        library="cuDNN conv + ATen add_ + max_pool2d + relu on the NCHW map (today's code on the card)",
        launch_floor_ms=kern["launch_floor_ms"], device_ops_per_call=r["device_ops_per_call"],
        graph_nodes_per_call=r["graph_nodes_per_call"], cases=k5,
        launches_per_wav_eval_batch=wav["k5_launches_per_eval_batch"],
        launches_wav_predict=wav["k5_launches_per_predict"],
        launches_per_wavaug_eval_batch=wa["k5_launches_per_eval_batch"],
        launches_per_wav_train_step=wav_train["k5_launches_per_step"],
        launches_per_multiseg_batch_s6=ms_flag["k5_launches_per_batch"],
        **{f"launches_per_multiseg_batch_s36_{name}": run["k5_launches_per_batch"] for name, run in s36.items()},
        launches_per_multiseg_batch_wav=mw["k5_launches_per_batch"],
        launches_per_wavaug_multiseg_batch=mwa["k5_launches_per_batch"],
        **{f"launches_per_{name}": row.get("k5_launches_per_step", row.get("k5_launches_per_batch"))
           for name, row in hostfed.items()},
        launches_hostfed_predict=host_eval["k5_launches_per_predict"],
        launches_hostfed_wav_predict=host_wav_eval["k5_launches_per_predict"],
        launches_per_classifier_encode_call=entry["classifier"]["k5_launches_per_encode_call"],
    ))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
