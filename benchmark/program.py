"""The system under test, as the benchmark builds it: the port's ``Trainer``
over a ``PackedStore`` of the run's split, with the benchmark's weights
loaded and a generator from the seed for the dropout masks, and the feed of
each unit of work: the program's sampler and its random draws, from a
second generator of the seed. Imported only by the traffic kinds; the
reference imports nothing of this."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data
from benchmark.reference import model as ref

WEIGHT_STREAM, DROPOUT_STREAM, FEED_STREAM = 5, 4, 3  # data.sub_seed streams of the run's seed
VIEWS = 4  # SpecAugment's views: original, warp, time mask, frequency mask


def views(config: dict) -> int:
    return VIEWS if config["experiment"]["specaug_params"]["use"] else 1


def weights(config: dict, seed: int, device) -> dict:
    """The model's weights from the run's seed (``reference.model.param_specs``)."""
    specs = ref.param_specs(config["model"], config["dataset"]["feat_shape"], views(config))
    return ref.make_weights(specs, data.sub_seed(seed, WEIGHT_STREAM), device)


def build(run, split: dict):
    """``(trainer, store)`` on ``run.device`` for ``run.config``."""
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
    trainer.gen = data.generator(run.seed, DROPOUT_STREAM, run.device)
    return trainer, store


def feed_views(trainer, gen: torch.Generator, episodes: int, items: int, enabled: bool = True):
    """The SpecAugment draws of one views call of ``episodes`` x ``items``
    rows, by the program's own draw (``draw_views_params``), or None where
    the program makes no views."""
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params

    if not (trainer.specaug and enabled):
        return None
    f, t = trainer.feat_shape
    return draw_views_params(gen, trainer.exp.specaug_params, episodes, items, f, t, trainer.device)


def train_feed(trainer, store, gen: torch.Generator, episodes: int):
    """One train step's input as ``Trainer.train_epoch`` gives it: the
    program's sampler's episodes and the step's draws from ``gen`` by the
    program's own draws (the view shuffle as ``Trainer._loss_and_metrics``
    draws it), so the reference can follow them."""
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.losses.cpl import draw_cpl_gumbel
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws

    exp = trainer.exp
    n, ks, kq = exp.n_way_train, exp.n_shot_train, exp.n_query_train
    ep = sample_episode(gen, store, n, ks, kq, episodes)
    query_views = exp.train_query_augmentations
    perms = gumbel = None
    if exp.use_attention and trainer.specaug and query_views:
        u = torch.rand((episodes, VIEWS - 1), generator=gen, device=trainer.device)
        perms = u.argsort(dim=-1) + 1
    if trainer.aux_loss and exp.loss.cpl.use:
        gumbel = draw_cpl_gumbel(gen, episodes, n * kq, n, trainer.device)
    return ep, TrainDraws(support=feed_views(trainer, gen, episodes, n * ks),
                          query=feed_views(trainer, gen, episodes, n * kq, query_views),
                          perms=perms, cpl_gumbel=gumbel)


def eval_feed(trainer, store, gen: torch.Generator, episodes: int, n: int, ks: int, kq: int, augment: bool,
              multisegment: bool):
    """One eval batch's input as ``Trainer.eval_accuracies`` gives it: the
    program's sampler's episodes (every segment of each query item for a
    multi-segment split) and their draws from ``gen``."""
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode

    ep = sample_episode(gen, store, n, ks, kq, episodes, is_test=multisegment)
    return ep, (feed_views(trainer, gen, episodes, ep.support.shape[1]),
                feed_views(trainer, gen, episodes, ep.query.shape[1], augment))


def as_dict(ep) -> dict:
    """An ``EpisodeBatch``'s fields by name (the tensors themselves)."""
    return {name: getattr(ep, name) for name in ("support", "support_labels", "query", "query_labels", "query_mask")}
