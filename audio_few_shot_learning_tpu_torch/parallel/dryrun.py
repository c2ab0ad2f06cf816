"""Dry run of episode-axis data parallelism on ``n`` ranks (counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n, backend, device)`` starts ``n`` ranks
(``parallel/spawn.py``) that train the flagship's structure (Hybrid,
SpecAugment's 4 views, attention, CPL, projected prototypes) in float32 on a
seeded store, and holds them to one process training the same model on the
same data, with the JAX dry run's three checks:

1. one train step of E = ``n * per_rank`` episodes, each rank taking its
   share, against one process taking all E (the same weights, episodes,
   views, view permutations and CPL draws, given as data; every dropout at
   p = 0, since each rank's masks come from its own generator): loss within
   ``LOSS_RTOL`` relative, each gradient within ``GRAD_REL[width]`` of its
   scale (its largest |g|, floored at ``SCALE_FLOOR`` of the largest over
   all gradients), and the running statistics within ``STATS_REL`` of their
   largest. A conv bias ahead of a BatchNorm has a gradient of zero but for
   rounding: on both sides it stays under ``BN_BIAS_NOISE`` of its conv
   weight's largest |g|;
2. ``STEPS`` such steps: the mean loss within ``EPOCH_RTOL`` of the one
   process's (the trajectory: parameters, Adam state, running statistics
   and the schedule carried from step to step);
3. an eval pass over ``eval_tasks`` episodes, each rank drawing its share
   from its own generator: accuracies in [0, 1], the same on every rank,
   and equal to one process replaying each rank's episodes and draws from
   that rank's generator state.

Then one ``train_epoch`` of ``STEPS`` steps with every rank sampling its
own episodes: a finite loss, the same on every rank. Each rank also reports
its launches of K1-K3 per step (0 on the CPU, where the plain versions run).

``width="small"`` is the JAX dry run's geometry (48x64 features, pool 2,
8 channels: every module at a fraction of the cost); ``"flagship"`` the
published widths (128x157, 64 channels, attention 64, projection
256 -> 128 -> 256) on a store of 35 classes x 40 items. ``device`` is
``"cpu"`` or ``"cuda"`` (rank r on card ``r % count``, so two ranks can
share one card under gloo).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.losses import draw_cpl_gumbel
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
from audio_few_shot_learning_tpu_torch.parallel.mesh import make_mesh
from audio_few_shot_learning_tpu_torch.parallel.spawn import run_ranks
from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws, Trainer, _slice_tree, fill_shares

STEPS = 4
SEED, BATCH_SEED, DRAW_SEED = 0, 100, 200
N_WAY = K_SHOT = K_QUERY = 5
LOSS_RTOL, SCALE_FLOOR, STATS_REL, EPOCH_RTOL, BN_BIAS_NOISE = 1e-5, 2e-2, 1e-4, 1e-3, 1e-2
# The JAX dry run's gradient bound at its geometry. At the flagship's
# widths two float32 steps of the same function differ by more: a forward
# difference of ~1e-7 moves the argmax of near-tied max-pool windows and
# reroutes their gradient, and with 1 600 items x 4 blocks of windows some
# do. On an NVIDIA H100 at E=8, the two-rank step's conv-2 weight gradient
# was 2.3e-2 of its scale off one process's (that one process's own
# gradients 6.4e-3 and, in the attention, 1.3e-2 off a float64 step:
# scripts/torch_port_dp_precision.py).
GRAD_REL = {"small": 1e-2, "flagship": 5e-2}
WIDTHS = {
    # (feature shape, store classes x items, model config dict)
    "small": ((48, 64), (8, 12), {
        "Hybrid": {"pool_dim": [2, 2], "hidden_channels": 8, "seq_type": "RNN", "out_dim": 32},
        "Attention": {"embed_dim": 32, "num_heads": 1, "ffn_dim": 32, "dropout": 0.1},
        "Projection": {"input_dim": 128, "hidden_dim": 32, "output_dim": 64},
    }),
    "flagship": ((128, 157), (35, 40), {}),
}


def dryrun_configs(width: str, episode_batch: int, compute_dtype: str = "float32", tasks: int = 0,
                   eval_batch: int = 16, device: str = "cpu"):
    """(experiment, model, feature shape) of the dry run: the flagship's
    training configuration (``__graft_entry__.py:25-65``) at ``width``."""
    feat_shape, _, model = WIDTHS[width]
    exp = ExperimentConfig.from_dict({
        "encoder_name": "Hybrid", "use_attention": True, "use_contrastive": True, "input_type": "spec",
        "n_way_train": N_WAY, "n_shot_train": K_SHOT, "n_query_train": K_QUERY, "lr": 7e-4,
        "n_training_tasks": tasks or episode_batch, "project_prototypes": True,
        "loss": {"l_param": 2.022308, "cpl": {"use": True, "m_param": 5, "t_param": 9.2361},
                 "angular": {"use": False}},
        "specaug_params": {"use": True, "mask_param": 16, "W": 22, "num_mask": 1, "mask_value": 0, "p": 0.282},
        "train_query_augmentations": True, "test_query_augmentations": True,
        "tpu": {"episode_batch": episode_batch, "eval_episode_batch": eval_batch,
                "compute_dtype": compute_dtype},
        "device": device,
    })
    return exp, ModelConfig.from_dict(model), feat_shape


def dryrun_store(width: str, device) -> PackedStore:
    """Seeded noise features of the width's shape, one segment per item."""
    (f, t), (classes, per_class), _ = WIDTHS[width]
    rng = np.random.default_rng(0)
    segments = rng.standard_normal((classes * per_class, f, t), dtype=np.float32)
    labels = np.repeat(np.arange(classes), per_class)
    return PackedStore.from_flat_arrays(segments, np.ones(len(labels), np.int64), labels, classes, device=device)


def rank_device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def global_batch(trainer: Trainer, e: int, step: int):
    """The step's E episodes and every draw of the step as data, the same
    on every rank and in one process."""
    store, params = trainer.train_store, trainer.exp.specaug_params
    f, t = trainer.feat_shape
    ep = sample_episode(torch.Generator(device=trainer.device).manual_seed(BATCH_SEED + step),
                        store, N_WAY, K_SHOT, K_QUERY, e)
    g = torch.Generator().manual_seed(DRAW_SEED + step)
    draws = TrainDraws(
        support=draw_views_params(g, params, e, N_WAY * K_SHOT, f, t, "cpu"),
        query=draw_views_params(g, params, e, N_WAY * K_QUERY, f, t, "cpu"),
        perms=torch.rand((e, 3), generator=g).argsort(dim=-1) + 1,
        cpl_gumbel=draw_cpl_gumbel(g, e, N_WAY * K_QUERY, N_WAY, "cpu"),
    )
    to = lambda x: x.to(trainer.device)  # noqa: E731
    return ep, TrainDraws(support=tuple(map(to, draws.support)), query=tuple(map(to, draws.query)),
                          perms=to(draws.perms), cpl_gumbel=to(draws.cpl_gumbel))


def no_dropout(trainer: Trainer) -> None:
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _kernel_counters():
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    return (specaugment.views_cuda, protohead.episode_scores_cuda, mel.mel_log_cuda)


def _stats(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _grads(model) -> Dict[str, np.ndarray]:
    return {n: p.grad.detach().cpu().numpy().copy() for n, p in model.named_parameters() if p.grad is not None}


def _rank(width: str, per_rank: int, device: str, eval_tasks: int) -> dict:
    """One rank's part: the fed steps, the eval pass, the sampled epoch."""
    mesh = make_mesh(device=rank_device(device, torch.distributed.get_rank()))
    e = mesh.world * per_rank
    exp, mdl, _ = dryrun_configs(width, e, tasks=STEPS * e, eval_batch=e, device=device)
    store = dryrun_store(width, mesh.device)
    trainer = Trainer(exp, mdl, store, val_store=store, test_store=store, seed=SEED, mesh=mesh)
    no_dropout(trainer)
    kernels = _kernel_counters()
    out = dict(rank=mesh.rank, losses=[], launches_per_step=[])
    share = mesh.episode_shard(e)
    t0 = time.perf_counter()
    for step in range(STEPS):
        ep, draws = global_batch(trainer, e, step)
        before = [k.launches for k in kernels]
        metrics = trainer.train_step(_slice_tree(ep, share), _slice_tree(draws, share))
        out["launches_per_step"].append([k.launches - b for k, b in zip(kernels, before)])
        out["losses"].append(float(metrics[0]))
        if step == 0:
            out["grads"], out["stats"] = _grads(trainer.model), _stats(trainer.model)
    out["steps_s"] = time.perf_counter() - t0
    out["state_dict"] = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    out["eval_generator"] = trainer.gen.get_state()
    out["eval_accuracies"] = trainer.eval_accuracies(store, eval_tasks, N_WAY, K_SHOT, K_QUERY, True)
    out["eval_batch"] = trainer.last_eval_batch
    out["epoch"] = trainer.train_epoch()
    return out


def _replay_eval(ref: Trainer, ranks: List[dict], eval_tasks: int) -> np.ndarray:
    """The eval pass in one process: each rank's batches drawn from its
    generator state, in its order, placed as the engine places them."""
    ref.model.load_state_dict(ranks[0]["state_dict"])
    ref.model.eval()
    caps = [r["eval_batch"] for r in ranks]
    acc = np.full(eval_tasks, np.nan, np.float32)
    for r, rank in enumerate(ranks):
        ref.gen.set_state(rank["eval_generator"])
        done = 0
        while done < eval_tasks:
            shares = fill_shares(eval_tasks - done, caps)
            lo, size = done + sum(shares[:r]), shares[r]
            if size:
                with torch.inference_mode():
                    ep = sample_episode(ref.gen, ref.train_store, N_WAY, K_SHOT, K_QUERY, size)
                    acc[lo : lo + size] = ref._eval_episodes(ep, N_WAY, True, store=ref.train_store).cpu().numpy()
            done += sum(shares)
    return acc


def dryrun_multichip(
    n: int,
    backend: str = "gloo",
    device: str = "cpu",
    width: str = "small",
    per_rank: int = 1,
    eval_tasks: Optional[int] = None,
    timeout_s: float = 600.0,
    threads: Optional[int] = None,
) -> dict:
    """Run the dry run on ``n`` ranks and hold it to one process; raises on
    any failed check, else returns the deviations, losses and launch counts."""
    e = n * per_rank
    eval_tasks = eval_tasks or e
    t0 = time.perf_counter()
    ranks = run_ranks(_rank, n, (width, per_rank, device, eval_tasks), backend=backend,
                      timeout_s=timeout_s, threads=threads)
    sharded_s = time.perf_counter() - t0

    dev = rank_device(device, 0)
    exp, mdl, _ = dryrun_configs(width, e, tasks=STEPS * e, eval_batch=e, device=device)
    store = dryrun_store(width, dev)
    ref = Trainer(exp, mdl, store, val_store=store, test_store=store, seed=SEED, device=dev)
    no_dropout(ref)
    losses = []
    for step in range(STEPS):
        losses.append(float(ref.train_step(*global_batch(ref, e, step))[0]))
        if step == 0:
            ref_grads, ref_stats = _grads(ref.model), _stats(ref.model)
    r0 = ranks[0]

    loss_rel = abs(r0["losses"][0] - losses[0]) / abs(losses[0])
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"sharded step loss {r0['losses'][0]} vs one process {losses[0]}: {loss_rel:.2e}")
    if set(r0["grads"]) != set(ref_grads):
        raise AssertionError("the sharded and one-process steps give gradients to different parameters")
    global_scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    grad_dev, bias_noise = {}, 0.0
    for name, g in ref_grads.items():
        if name.startswith("backbone.encoder.conv_encoder.") and name.endswith(".0.bias"):
            weight = float(np.abs(ref_grads[name.replace(".bias", ".weight")]).max())
            bias_noise = max(bias_noise, float(max(np.abs(g).max(), np.abs(r0["grads"][name]).max())) / weight)
            continue
        scale = max(float(np.abs(g).max()), SCALE_FLOOR * global_scale)
        grad_dev[name] = float(np.abs(r0["grads"][name] - g).max()) / scale
    if not bias_noise <= BN_BIAS_NOISE:
        raise AssertionError(f"a conv bias ahead of a BatchNorm has a gradient {bias_noise:.2e} of its weight's")
    worst = max(grad_dev, key=grad_dev.get)
    if not grad_dev[worst] <= GRAD_REL[width]:
        raise AssertionError(f"sharded gradient of {worst} deviates {grad_dev[worst]:.2e} of its scale")
    stats_dev = max(float(np.abs(r0["stats"][k] - v).max()) / max(1.0, float(np.abs(v).max()))
                    for k, v in ref_stats.items())
    if not stats_dev <= STATS_REL:
        raise AssertionError(f"running statistics after the sharded step deviate {stats_dev:.2e}")
    mean_rel = abs(np.mean(r0["losses"]) - np.mean(losses)) / abs(np.mean(losses))
    if not mean_rel <= EPOCH_RTOL:
        raise AssertionError(f"{STEPS}-step mean loss {np.mean(r0['losses'])} vs one process {np.mean(losses)}")
    if any(r["losses"] != r0["losses"] for r in ranks):
        raise AssertionError(f"ranks report different step losses: {[r['losses'] for r in ranks]}")

    acc = r0["eval_accuracies"]
    if not (len(acc) == eval_tasks and np.all((acc >= 0) & (acc <= 1))):
        raise AssertionError(f"eval accuracies malformed: {acc}")
    if any(not np.array_equal(r["eval_accuracies"], acc) for r in ranks):
        raise AssertionError("ranks gathered different eval accuracies")
    replayed = _replay_eval(ref, ranks, eval_tasks)
    if not np.array_equal(acc, replayed):
        raise AssertionError(f"gathered eval accuracies {acc} differ from one process's {replayed}")
    epoch_losses = [r["epoch"]["loss"] for r in ranks]
    if not (np.isfinite(epoch_losses[0]) and len(set(epoch_losses)) == 1):
        raise AssertionError(f"sampled epoch losses per rank: {epoch_losses}")

    return dict(
        ranks=n, backend=backend, device=device, width=width, episodes_per_step=e, steps=STEPS,
        loss_rel=loss_rel, grad_worst_rel_of_scale=grad_dev[worst], grad_worst_leaf=worst,
        conv_bias_grad_rel_of_weight=bias_noise,
        stats_rel=stats_dev, mean_loss_rel=mean_rel, losses=r0["losses"], one_process_losses=losses,
        eval_accuracy=float(acc.mean()), eval_tasks=eval_tasks, eval_batch_per_rank=[r["eval_batch"] for r in ranks],
        epoch=r0["epoch"], launches_per_step=[r["launches_per_step"] for r in ranks],
        sharded_s=sharded_s, rank_steps_s=[r["steps_s"] for r in ranks],
        tolerances=dict(loss_rtol=LOSS_RTOL, grad_rel=GRAD_REL[width], scale_floor=SCALE_FLOOR, stats_rel=STATS_REL,
                        epoch_rtol=EPOCH_RTOL, bn_bias_noise=BN_BIAS_NOISE),
    )
