"""Training traffic of an AST configuration: the ``train`` kind's closed loop
of optimizer steps as ``Trainer.train_epoch`` takes them (its ``unit``,
``window`` and ``finish``; the program's sampler and draws from a generator
of the seed, then ``Trainer.train_step``), with the weights and the check
of ``reference/ast.py``: the program's weights are made from
``reference/ast.py::param_specs``, and after the window the reference
follows the first ``check_steps`` steps on the same episodes and draws,
judged first as the ``train`` kind judges them. The numbers compared are
the ``train`` kind's (``numbers_vs``). ``describe`` gives the step's FLOPs
from ``roofline/ast.py``, its attention and GEMM parts apart, and K1's
launches as the ``train`` kind gives them.

Mix parameters: ``check_steps``, ``warm_units``, ``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data, harness, program, roofline
from benchmark.reference import ast as ref_ast
from benchmark.reference import model as ref
from benchmark.roofline import ast as roofline_ast

base = harness.load_module(harness.HERE / "traffic" / "train.py", "benchmark_traffic_train")
unit, window, finish, numbers_vs, readings = base.unit, base.window, base.finish, base.numbers_vs, base.readings


def weights(config: dict, seed: int, device) -> dict:
    """The model's weights from the run's seed (``reference/ast.py::param_specs``)."""
    specs = ref_ast.param_specs(config["model"], config["dataset"]["feat_shape"], program.views(config))
    return ref.make_weights(specs, data.sub_seed(seed, program.WEIGHT_STREAM), device)


def build(run, split: dict):
    """``(trainer, store)`` as ``program.build`` makes them, with AST's weights."""
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    cfg = run.config
    exp, mdl = ExperimentConfig.from_dict(cfg["experiment"]), ModelConfig.from_dict(cfg["model"])
    store = PackedStore.from_flat_arrays(
        split["segments"], split["counts"].cpu().numpy().astype(np.int64), split["labels"].cpu().numpy(),
        cfg["dataset"]["classes"], device=run.device, dtype=exp.tpu.store_dtype)
    trainer = Trainer(exp, mdl, store, val_store=store, test_store=store, seed=0, device=run.device)
    trainer.model.load_state_dict(weights(cfg, run.seed, run.device), strict=True)
    trainer.gen = data.generator(run.seed, program.DROPOUT_STREAM, run.device)
    return trainer, store


def setup(run) -> base.State:
    """As the ``train`` kind's: the program's first ``check_steps`` steps by
    the window's own call, their episodes and draws kept, each leaf's first
    gradient (Adam's first moment after one step) and change read."""
    s = base.State()
    s.run = run
    exp = run.config["experiment"]
    s.n, s.ks, s.kq = exp["n_way_train"], exp["n_shot_train"], exp["n_query_train"]
    s.trainer, s.store = build(run, data.make_split(run.config["dataset"], run.seed, run.device))
    s.feed = data.generator(run.seed, program.FEED_STREAM, run.device)
    s.episodes = s.trainer.episode_batch
    s.metrics, s.marks, s.kept = {}, {}, {}
    s.failed_units = set()
    s.weights0 = {k: v.detach().clone() for k, v in s.trainer.model.named_parameters()}
    run.plant("trainer", s.trainer)
    s.check_steps = int(run.mix["check_steps"])
    for i in range(s.check_steps):
        unit(s, i)
        if i == 0:
            beta1 = s.trainer.optimizer.param_groups[0]["betas"][0]
            state = s.trainer.optimizer.state
            s.prog_grads = {k: float(state[p]["exp_avg"].double().norm()) / (1.0 - beta1)
                            for k, p in s.trainer.model.named_parameters() if p in state and "exp_avg" in state[p]}
    s.prog_change = {k: float((p.detach() - s.weights0[k]).double().norm())
                     for k, p in s.trainer.model.named_parameters()}
    s.weights0 = None
    s.prog = dict(losses=[float(s.metrics[i][0]) for i in range(s.check_steps)], grads=s.prog_grads,
                  change=s.prog_change)
    s.next = s.check_steps
    return s


def describe(s) -> dict:
    cfg = s.run.config
    f, t = cfg["dataset"]["feat_shape"]
    flops = roofline_ast.train_step_flops(cfg["model"], (f, t), program.views(cfg), s.n * s.ks, s.n * s.kq, s.n)
    return dict(episodes_per_unit=s.episodes, flops_per_episode=flops["total"],
                ast_attention_flops_per_episode=flops["attention"], ast_gemm_flops_per_episode=flops["gemm"],
                peak_flops=roofline.PEAK_BF16_FLOPS, unit_ms=s.step_ms,
                # K1 as the ``train`` kind counts it: once for the support, once for the queries
                launches={"views_kernel": [roofline.k1_bytes(s.episodes, s.n * s.ks, f, t),
                                           roofline.k1_bytes(s.episodes, s.n * s.kq, f, t)]})


def check(s) -> dict:
    """Free the program; follow its first steps with the reference."""
    run = s.run
    kept = [s.kept[i] for i in range(s.check_steps)]
    steps_per_epoch = s.trainer.steps_per_epoch
    s.trainer = s.store = s.metrics = s.marks = s.kept = None
    if run.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = reference_numbers(run, kept, steps_per_epoch, "float32")
    s.check_seconds = time.perf_counter() - t0
    out = numbers_vs(s.prog, numbers, run.limits["limits"])
    harness.note(f"readings not compared: {out.pop('readings')}")
    return out


def reference_numbers(run, kept: list, steps_per_epoch: int, precision: str, mutate=None) -> dict:
    cfg = run.config
    eps, faults = base.reference_episodes(run, kept)
    w = weights(cfg, run.seed, run.device)
    r = ref_ast.train_steps(eps, w, cfg["experiment"], cfg["model"], data.sub_seed(run.seed, program.DROPOUT_STREAM),
                            steps_per_epoch, precision, mutate)
    return {**r, "episode_faults": faults}
