"""The engine: episodic training, evaluation and fixed-episode prediction.

Counterpart of the JAX package's ``train/engine.py``.

Training: every optimizer step samples E episodes (``episode_batch``) from
the device-resident store, makes SpecAugment's views for support and
queries (K1 on the card), runs the episode model in train mode with the
fused head (K2 forward on the card, its closed-form backward in plain
tensor ops), adds FSL and ``l_param`` x (CPL | APL) against the projected
(or L2-normalized) prototypes, and takes one Adam step under the MultiStepLR
schedule. With ``episode_microbatch`` the batch goes through in chunks whose
gradients and metrics are averaged, the BatchNorm statistics carried from
chunk to chunk. An epoch synchronizes with the host once, to read its
metrics. Views, view permutations, dropout masks and CPL's Gumbel draws all
come from the trainer's one ``torch.Generator``, so a run is reproducible
from its seed and a resumed run replays it; ``TrainDraws`` fixes all but
the dropout masks as data.

Evaluation: every eval batch samples E episodes, makes the views, runs the
model in eval mode and scores the argmax, with no host synchronization
until the accuracies of the whole run are read back. Multi-segment
evaluation (``multisegment=True``; ``test()`` with ``multi_segm``) scores
every segment of each query item and takes the majority vote of its real
segments (``train/evaluate.py``); since an episode then carries
``s_max`` times the query rows, E is cut to what the card's free memory
holds (``multisegment_eval_batch``). ``predict_episode`` runs the same
pipeline on one caller-supplied episode.

Wav-input configs (``input_type: "wav"``) sample raw waveforms from a
``PackedWavStore`` instead. With ``waveaug_params.use`` the waveforms first
go through WaveAugment (``ops/waveaugment.py``), 1 + ``aug_num`` views per
item: one chain call over every episode of the batch (support and queries
together when both are augmented). Then every view row of both groups goes
through one online log-mel call (K3 on the card) and the store's global
z-norm, and through the same model.

Host-resident stores (``HostStore``, ``WavHostStore``: a split too large
for the card, or ``tpu.host_store: true``) feed the same paths from host
RAM (``host_mode`` for training, per store for evaluation): each batch is
drawn on the host with a numpy Generator, the JAX package's calls in its
order, gathered into a pinned staging buffer and copied to the card on a
copy stream while the card runs the previous step (``data/staging.py``);
nothing changes after episode assembly. One Generator is seeded per epoch
and one per ``evaluate`` call from words drawn from the trainer's
generator (one host synchronization each), so a resumed run, whose
generator state is checkpointed, replays the same episode stream. The JAX
package seeds its host Generator from its run key instead; like the device
sampler's, the draws differ between the packages (a documented RNG
deviation), the semantics do not.

Data parallelism (``tpu.mesh_shape`` W > 1, or a ``mesh`` from
``parallel/mesh.py``; the JAX package's episode mesh): W ranks, one process
each in an initialised process group, each take E/W of every step's
episodes (with ``episode_microbatch``, their share of every chunk), drawn
from their own generator. Train-mode BatchNorm normalizes with moments over
the global batch (``parallel/mesh.py::CrossRankBatchNorm``), the gradients and
metrics are averaged over the ranks once per optimizer step, and every rank
takes the same Adam step. Eval splits every batch over the ranks (a
multi-segment batch: each rank takes the E its own card holds) and gathers
exactly ``n_tasks`` accuracies, the same on every rank. Rank r seeds its
generator with ``seed + 1 + r * RANK_SEED_STRIDE``; rank 0 of one rank seeds
as a run without a mesh does, and reproduces it. ``tpu.mesh_shape`` above 1
outside a process group raises.

The engine runs on the card unless the caller asks for the CPU, through
``device="cpu"`` or the config's ``"device": "cpu"``; with no card and no
such request it raises. It takes every configuration the JAX package's
``Trainer`` takes.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.config import HOP_LENGTH, N_MELS, ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.data.episodes import EpisodeBatch, sample_episode
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
from audio_few_shot_learning_tpu_torch.data.staging import EpisodeStager
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.device import config_device
from audio_few_shot_learning_tpu_torch.losses import angular_loss, cpl_loss, fsl_loss
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec
from audio_few_shot_learning_tpu_torch.ops.specaugment import Draws, spec_augment_views
from audio_few_shot_learning_tpu_torch.ops.waveaugment import ChainDraws, WaveAugment
from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, make_mesh
from audio_few_shot_learning_tpu_torch.train.evaluate import majority_vote_accuracy
from audio_few_shot_learning_tpu_torch.train.state import make_optimizer, scheduled_lr
from audio_few_shot_learning_tpu_torch.utils.profiling import (
    MARK_RING, mark, mark_intervals, marks_made, profile_trace, set_counter, span, spanned,
)

NUM_SPECAUG_VIEWS = 4  # fixed 4-view expansion
Store = Union[PackedStore, PackedWavStore, HostStore, WavHostStore]
METRIC_NAMES = ("loss", "fsl_loss", "cpl_loss")
RANK_SEED_STRIDE = 2**32  # rank r's generator: seed + 1 + r * stride (runs take seed + i)
STEP_SPAN = "afsl.train_step"  # the step's span, and the label of its step marks (utils/profiling.py)

# Multi-segment eval batch on the card. Each encoder names what one map
# holds at the widest point of its eval forward (``eval_item_bytes``):
# block 0's conv output for the conv encoders (channels x F x T in the
# compute dtype, 2.57 MB in bf16 at 128x157); for AST a block's residual
# stream, a LayerNorm output and the MLP hidden (602 tokens x (2 x 768 +
# 3 072) in bf16, 5.55 MB at 128x512). chip_smoke.py measures the
# peak of allocated memory over one batch against it on an NVIDIA H100 80GB
# HBM3 at 700 W: 1.62-1.63 x for the flagship and plain spec configs at
# s_max 6 and 36, 1.75 x for wav (its log-mel front), at E = 3-16. E is the
# number of episodes whose EVAL_PEAK_FACTOR x those bytes fill
# EVAL_MEMORY_SHARE of the free memory; chip_smoke.py holds each batch's
# peak below both. Since block 0 runs as one kernel in eval mode on the
# card (ops/convblock.py), which never writes that full-resolution map, the
# rule over-reckons a conv encoder's spec batch on the card. AST
# (measure_eval_peak on the same card, the esc50_ast_cpl model): 1.27 x at
# s_max 1 (E = 16) and at s_max 6 (E = 9).
EVAL_PEAK_FACTOR = 1.8
EVAL_MEMORY_SHARE = 0.8
# Where the device reports no memory (the CPU), the JAX package's rule:
# 36 segment-episodes of 128x157 store rows, scaled by the store's row size.
CPU_SEGMENT_BUDGET, CPU_BUDGET_ROW = 36, 128 * 157


def multisegment_eval_batch(
    batch: int,
    s_max: int,
    episode_bytes: int,
    free_bytes: Optional[int],
    row_elems: int,
    budget: Optional[int] = None,
) -> int:
    """Episodes per multi-segment eval batch, at most ``batch``.

    ``budget`` (``tpu.eval_segment_budget``, in segment-episodes) wins:
    ``budget // s_max``. On the card: ``EVAL_MEMORY_SHARE * free_bytes``
    over ``EVAL_PEAK_FACTOR * episode_bytes`` (``eval_episode_bytes``: what
    the encoder holds over one episode). With no memory to read
    (``free_bytes`` None): the JAX package's segment budget for store rows
    of ``row_elems`` elements."""
    if budget is not None:
        return max(1, min(batch, max(1, budget) // max(s_max, 1)))
    if free_bytes is None:
        seg_budget = max(1, int(CPU_SEGMENT_BUDGET * CPU_BUDGET_ROW / max(row_elems, 1)))
        return max(1, min(batch, seg_budget // max(s_max, 1)))
    fit = int(EVAL_MEMORY_SHARE * free_bytes // (EVAL_PEAK_FACTOR * max(episode_bytes, 1)))
    return max(1, min(batch, fit))


def eval_episode_bytes(
    n_support: int,
    n_query_rows: int,
    v_support: int,
    v_query: int,
    item_bytes: int,
    chain_rows: int = 0,
    chain_row_bytes: int = 0,
) -> int:
    """What the encoder holds over one eval episode at its widest point:
    ``item_bytes`` (the encoder's ``eval_item_bytes``) for every (item,
    view) it takes. With WaveAugment, plus its chain's working set:
    ``chain_rows`` augmented rows of ``chain_row_bytes`` each
    (``WaveAugment.row_bytes``)."""
    return (n_support * v_support + n_query_rows * v_query) * item_bytes + chain_rows * chain_row_bytes


def measure_eval_peak(trainer: "Trainer", store, n_tasks: int, n_way: int, k_shot: int, k_query: int,
                      augment_query: bool, tie_strategy: str = "") -> Dict[str, float]:
    """One multi-segment eval batch at the E the engine reckons for
    ``n_tasks`` tasks, on the card: E, the free memory the rule read, one
    episode's reckoned bytes (``episode_bytes``), and the peak of allocated memory over
    the batch above what was allocated before it, as bytes and over
    ``E x eval_episode_bytes`` (``peak_factor``, held under
    ``EVAL_PEAK_FACTOR`` by its callers)."""
    dev = trainer.device
    if dev.type != "cuda":
        raise ValueError("the eval peak is measured on the card")
    torch.cuda.synchronize(dev)
    free_card = torch.cuda.mem_get_info(dev)[0]
    free = free_card + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    e = trainer.eval_batch_size(store, n_tasks, n_way, k_shot, k_query, augment_query, True)
    episode = trainer.episode_bytes(store, n_way, k_shot, k_query, augment_query)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.evaluate(store, e, n_way, k_shot, k_query, augment_query, True, tie_strategy)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return dict(eval_batch=e, ran_batch=trainer.last_eval_batch, free_bytes=free, free_reported_by_card=free_card,
                episode_bytes=episode, peak_bytes=peak, peak_factor=peak / (e * episode),
                peak_share_of_free=peak / free)


def _slice_tree(obj, sl: slice):
    """``obj`` with every tensor in it (dataclass fields, tuples) sliced on
    its leading episode axis; None stays None."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj[sl]
    if isinstance(obj, tuple):
        return tuple(_slice_tree(x, sl) for x in obj)
    if isinstance(obj, dict):
        return {k: _slice_tree(v, sl) for k, v in obj.items()}
    return type(obj)(**{f.name: _slice_tree(getattr(obj, f.name), sl) for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class TrainDraws:
    """Randomness of one train step given as data, each with a leading
    episode axis E; a field left None is drawn from the trainer's generator.
    The dropout masks always come from the generator."""

    support: Optional[Draws] = None  # SpecAugment draws of the support (ys, tmask, fmask)
    query: Optional[Draws] = None  # ... of the queries
    perms: Optional[torch.Tensor] = None  # [E, V-1] view shuffle of the contrastive branch
    cpl_gumbel: Optional[torch.Tensor] = None  # [E, B, N, B] CPL's sampling noise
    # WaveAugment draws of the support and the queries (wav input), leaves
    # [E, aug_num, S|Q, ...] as WaveAugment.draw makes them
    wave_support: Optional[ChainDraws] = None
    wave_query: Optional[ChainDraws] = None


def fill_shares(n: int, caps: Sequence[int]) -> List[int]:
    """Episodes each rank takes of an eval batch of ``n``: as many as its
    ``caps`` entry allows, rank by rank, until the batch is spread."""
    shares = []
    for cap in caps:
        shares.append(min(cap, n))
        n -= shares[-1]
    return shares


def is_host_resident(store) -> bool:
    return getattr(store, "is_host_resident", False)


class Trainer:
    """Owns the model, the stores and the run's random generator."""

    def __init__(
        self,
        exp: ExperimentConfig,
        mdl: ModelConfig,
        train_store: Store,
        val_store: Optional[Store] = None,
        test_store: Optional[Store] = None,
        seed: Optional[int] = None,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[EpisodeMesh] = None,
    ):
        """``mesh`` (default ``make_mesh(tpu.mesh_shape)``) gives this rank
        and the process group; with it, ``device`` defaults to its device."""
        self.is_wav = exp.input_type == "wav"
        self.exp = exp
        self.mdl = mdl
        if mesh is None:
            self.device = config_device(exp, device)
            mesh = make_mesh(exp.tpu.mesh_shape, self.device)
        else:
            self.device = config_device(exp, mesh.device if device is None else device)
        self.mesh = mesh
        self.train_store = train_store
        self.host_mode = is_host_resident(train_store)
        self._stager: Optional[EpisodeStager] = None
        self.val_store = val_store
        self.test_store = test_store
        self.specaug = not self.is_wav and exp.specaug_params.use
        self.waveaug = self.is_wav and exp.waveaug_params.use
        self.v_support = self._v_query(True)
        self.eval_episode_batch = exp.tpu.eval_episode_batch
        self.episode_batch = exp.tpu.episode_batch
        self.microbatch = exp.tpu.episode_microbatch
        if self.microbatch is not None and self.episode_batch % self.microbatch != 0:
            raise ValueError(
                f"episode_microbatch={self.microbatch} must divide "
                f"episode_batch={self.episode_batch}"
            )
        for name, n in (("episode_batch", self.episode_batch), ("episode_microbatch", self.microbatch)):
            if n is not None and n % mesh.world:
                raise ValueError(f"{name}={n} must divide over the mesh's {mesh.world} ranks")
        self.steps_per_epoch = -(-exp.n_training_tasks // self.episode_batch)
        self.aux_loss = exp.use_contrastive and (exp.loss.cpl.use or exp.loss.angular.use)
        if self.is_wav:
            # the reference's on-device torchaudio MelSpectrogram + 10*log10
            self.mel = MelSpec(flavor="online")
            self.waveaugment = WaveAugment(exp.waveaug_params, dataset_name=exp.dataset_name)
            self.feat_shape = (N_MELS, 1 + train_store.seg_len // HOP_LENGTH)
        else:
            self.feat_shape = tuple(train_store.feat_shape)

        seed = exp.tpu.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):  # seeded torch-default init
            torch.manual_seed(seed)
            model = FewShotEpisodeModel(exp, mdl, self.feat_shape)
        self.model = model.to(self.device).eval()
        self.mesh.broadcast_(list(self.model.state_dict().values()))
        self.model.set_mesh(self.mesh)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1 + mesh.rank * RANK_SEED_STRIDE)
        self.optimizer = make_optimizer(self.model.parameters(), exp.lr)
        self.step = 0  # optimizer updates taken; drives the schedule
        self.last_eval_seconds: Optional[float] = None
        self.last_eval_batch: Optional[int] = None
        self.last_epoch_seconds: Optional[float] = None
        self.last_step_ms: List[float] = []

    # ------------------------------------------------------------------
    # host-fed batches
    # ------------------------------------------------------------------

    @property
    def stager(self) -> EpisodeStager:
        """The pinned double-buffered staging of host-sampled batches (made
        at first use)."""
        if self._stager is None:
            self._stager = EpisodeStager(self.device)
        return self._stager

    def host_rng(self) -> np.random.Generator:
        """A numpy Generator for the host sampler, seeded from four words of
        the trainer's generator (one host synchronization)."""
        words = torch.randint(0, 2**31 - 1, (4,), generator=self.gen, device=self.device)
        return np.random.default_rng(words.tolist())

    def _batches(self, store: Store, n_way: int, k_shot: int, k_query: int, is_test: bool = False):
        """A function ``size -> EpisodeBatch`` on the device: from the device
        sampler, or for a host store from the host sampler through the
        staging buffers, with one Generator for every batch it gives."""
        if not is_host_resident(store):
            return lambda size: sample_episode(self.gen, store, n_way, k_shot, k_query, size, is_test=is_test)
        rng = self.host_rng()

        def staged(size: int) -> EpisodeBatch:
            with span("afsl.sample"):
                plan = store.plan(rng, n_way, k_shot, k_query, is_test, size)
            return self.stager.stage(store, plan)

        return staged

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def _v_query(self, augment_query: bool) -> int:
        if self.specaug and augment_query:
            return NUM_SPECAUG_VIEWS
        if self.waveaug and augment_query:
            return 1 + self.exp.waveaug_params.aug_num
        return 1

    @spanned("afsl.views")
    def _make_views(
        self,
        specs: torch.Tensor,
        enabled: bool,
        gen: torch.Generator,
        draws: Optional[Draws] = None,
    ) -> torch.Tensor:
        """``[E, B, F, T] -> [E, B, V, F, T]``: one augmentation call for all
        E episodes, masks drawn per episode from ``gen`` (``draws`` fixes them)."""
        if not enabled:
            return specs[:, :, None]
        return spec_augment_views(specs, gen, self.exp.specaug_params, draws=draws)

    @spanned("afsl.views")
    def _make_wav_views(
        self,
        sup: torch.Tensor,
        qry: torch.Tensor,
        augment_query: bool,
        store: Union[PackedWavStore, WavHostStore],
        gen: torch.Generator,
        draws: Optional[Tuple[Optional[ChainDraws], Optional[ChainDraws]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Waveforms ``[E, S, L]``, ``[E, Q, L]`` -> views ``[E, S, Vs, F, T]``,
        ``[E, Q, Vq, F, T]`` (JAX ``_make_wav_views_pair``, engine.py:196-253).

        When support and queries are both augmented, or neither is, one
        WaveAugment call (or none) runs over ``[E, S+Q]``; otherwise each
        group is augmented on its own. Then one online log-mel call over
        every view row of both groups and the store's global z-norm
        (batch_creation.py:123-143). ``draws = (support, queries)`` fixes the
        chain's draws (leaves ``[E, aug_num, S|Q, ...]``); otherwise they
        come from ``gen``."""
        e, s, length = sup.shape
        q = qry.shape[1]
        aug_s, aug_q = self.waveaug, self.waveaug and augment_query
        d_s, d_q = draws if draws is not None else (None, None)
        if aug_s == aug_q:
            both = torch.cat([sup, qry], dim=1)  # [E, S+Q, L]
            if aug_s:
                if (d_s is None) != (d_q is None):
                    raise ValueError("WaveAugment draws: give both the support's and the queries', or neither")
                joined = None if d_s is None else {
                    name: {k: torch.cat([v, d_q[name][k]], dim=2) for k, v in d.items()}
                    for name, d in d_s.items()
                }
                views = self.waveaugment(both, gen, joined)  # [E, S+Q, V, L]
            else:
                views = both[:, :, None]
            v = views.shape[2]
            flat = views.reshape(-1, length)
            sizes = (s * v, q * v)
        else:
            sup_v = self.waveaugment(sup, gen, d_s) if aug_s else sup[:, :, None]
            qry_v = self.waveaugment(qry, gen, d_q) if aug_q else qry[:, :, None]
            sizes = (s * sup_v.shape[2], q * qry_v.shape[2])
            flat = torch.cat(
                [sup_v.reshape(e, sizes[0], length), qry_v.reshape(e, sizes[1], length)], dim=1
            ).reshape(-1, length)
        mels = self.mel(flat)  # [E*(S*Vs + Q*Vq), F, T]
        mels = (mels - store.mean) / store.std
        per_ep = mels.reshape(e, sizes[0] + sizes[1], *mels.shape[-2:])
        return (per_ep[:, : sizes[0]].reshape(e, s, sizes[0] // s, *mels.shape[-2:]),
                per_ep[:, sizes[0] :].reshape(e, q, sizes[1] // q, *mels.shape[-2:]))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _loss_and_metrics(
        self, ep: EpisodeBatch, draws: Optional[TrainDraws] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean loss over the E episodes of ``ep`` and its metrics
        ``[loss, fsl_loss, cpl_loss]`` (detached), in train mode."""
        exp = self.exp
        n_way = exp.n_way_train
        vq = self._v_query(exp.train_query_augmentations)
        e = ep.support.shape[0]
        draws = draws or TrainDraws()
        if self.is_wav:
            sup_views, qry_views = self._make_wav_views(
                ep.support, ep.query, vq > 1, self.train_store, self.gen,
                (draws.wave_support, draws.wave_query),
            )
        else:
            sup_views = self._make_views(ep.support, self.specaug, self.gen, draws.support)
            qry_views = self._make_views(ep.query, vq > 1, self.gen, draws.query)

        perms = None
        if exp.use_attention and vq > 1:
            perms = draws.perms
            if perms is None:
                with span("afsl.draws"):
                    u = torch.rand((e, vq - 1), generator=self.gen, device=self.device)
                    perms = u.argsort(dim=-1) + 1
        with span("afsl.forward"):
            outs = self.model(
                sup_views, qry_views, ep.support_labels, n_way,
                shuffle_perm=perms, with_contrastive=exp.use_contrastive, gen=self.gen,
            )
        with span("afsl.loss"):
            tile = 1 if exp.use_attention else vq
            q_labels = ep.query_labels.repeat(1, tile)  # loops/loops.py:36-37

            fsl = fsl_loss(outs.scores, q_labels)  # [E]
            aux = torch.zeros_like(fsl)
            if self.aux_loss:
                if exp.project_prototypes:  # projecting overrides normalizing
                    protos_c = outs.cpl_prototypes_projected
                elif exp.normalize_prototypes:
                    protos_c = F.normalize(outs.prototypes, dim=-1)
                else:
                    protos_c = outs.prototypes
                if exp.loss.cpl.use:
                    aux = cpl_loss(
                        protos_c, outs.cpl_features, q_labels, exp.loss.cpl.m_param,
                        exp.loss.cpl.t_param, gumbel=draws.cpl_gumbel, gen=self.gen,
                    )
                else:
                    ang = exp.loss.angular
                    aux = angular_loss(
                        protos_c, outs.cpl_features, q_labels, ang.angle, ang.prototypes_as_anchors
                    )
            total = (fsl + exp.loss.l_param * aux).mean()
            metrics = torch.stack([total, fsl.mean(), aux.mean()]).detach()
        return total, metrics

    def train_step(self, ep: EpisodeBatch, draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """One optimizer step on an assembled episode batch; returns its
        metrics ``[loss, fsl_loss, cpl_loss]`` on the device (no host
        synchronization). With ``episode_microbatch`` the batch goes through
        in chunks: gradients and metrics are averaged over the chunks, and
        each chunk's forward moves the BatchNorm statistics.

        On a mesh of W ranks ``ep`` is this rank's share of the global batch
        (``EpisodeMesh.chunk_shard`` of it, with chunks), each chunk holding
        ``episode_microbatch / W`` of its episodes; the gradients and
        metrics are averaged over the ranks after the last chunk.

        The step runs in the ``afsl.train_step`` span, which opens with a
        step mark: the step's boundary on the device (``last_step_ms``)."""
        with span(STEP_SPAN):
            mark(self.device, STEP_SPAN)
            self.model.train()
            e = ep.support.shape[0]
            chunk = self.microbatch // self.mesh.world if self.microbatch else e
            size = chunk if chunk < e else e
            chunks = e // size
            with span("afsl.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            metrics = None
            for c in range(chunks):
                sl = slice(c * size, (c + 1) * size)
                total, m = self._loss_and_metrics(_slice_tree(ep, sl), _slice_tree(draws, sl))
                with span("afsl.backward"):
                    (total / chunks).backward()
                metrics = m if metrics is None else metrics + m
            with span("afsl.optimizer"):
                metrics = metrics / chunks
                self.mesh.all_reduce_mean_([p.grad for p in self.model.parameters() if p.grad is not None]
                                           + [metrics])
                exp = self.exp
                lr = scheduled_lr(
                    self.step, exp.lr, exp.scheduler_milestones, exp.scheduler_gamma, self.steps_per_epoch
                )
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            self.step += 1
            return metrics

    @spanned("afsl.train_epoch")
    def train_epoch(self) -> Dict[str, float]:
        """``steps_per_epoch`` steps of ``episode_batch`` episodes sampled from
        the train store (host-fed for a host store: the JAX package's
        ``_run_epoch_hostfed``), each rank of a mesh sampling its share; the
        metrics are read back once, at the end. ``last_step_ms`` holds each
        step's milliseconds, from its start to the next step's (the last
        step's to its end), on the device's clock; an epoch of more steps
        than the step marks' ring holds keeps its last ones, and warns."""
        exp = self.exp
        per_step = []
        t0 = time.perf_counter()
        batches = self._batches(self.train_store, exp.n_way_train, exp.n_shot_train, exp.n_query_train)
        first = marks_made()
        for _ in range(self.steps_per_epoch):
            per_step.append(self.train_step(batches(self.episode_batch // self.mesh.world)))
        mark(self.device, STEP_SPAN, end=True)  # closes the last step's interval
        if marks_made() - first > MARK_RING:
            warnings.warn(f"last_step_ms holds the last {MARK_RING - 1} of the epoch's {self.steps_per_epoch} steps",
                          stacklevel=2)
        means = torch.stack(per_step).mean(dim=0).tolist()  # the epoch's one synchronization
        self.last_epoch_seconds = time.perf_counter() - t0
        self.last_step_ms = [m["ms"] for m in mark_intervals(STEP_SPAN, first)]
        out = dict(zip(METRIC_NAMES, means))
        if not self.aux_loss:
            out["cpl_loss"] = float("nan")  # the reference reports NaN (loops/loops.py:59)
        out["episodes_per_sec"] = self.steps_per_epoch * self.episode_batch / self.last_epoch_seconds
        return out

    def profile_epoch(self, log_dir: str) -> Dict[str, float]:
        """One ``train_epoch`` under a ``torch.profiler`` trace written into
        ``log_dir`` (``utils/profiling.py::profile_trace``); its metrics."""
        with profile_trace(log_dir, device=self.device):
            return self.train_epoch()

    def validate(self) -> Tuple[float, float]:
        exp = self.exp
        return self.evaluate(
            self.val_store,
            n_tasks=exp.n_training_tasks,  # the reference validates on num_train_tasks (src/train_test.py:136)
            n_way=exp.n_way_validation,
            k_shot=exp.n_shot_validation,
            k_query=exp.n_query_validation,
            augment_query=exp.validation_query_augmentations,
        )

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _episode_scores(
        self,
        ep: EpisodeBatch,
        n_way: int,
        augment_query: bool,
        gen: torch.Generator,
        draws: Optional[Tuple] = None,
        store: Union[PackedWavStore, WavHostStore, None] = None,
    ) -> torch.Tensor:
        """Scores ``[E, Q*, n_way]`` of an assembled episode batch;
        ``draws = (support_draws, query_draws)`` fixes the augmentation
        (SpecAugment ``Draws``, or WaveAugment ``ChainDraws`` for wav input).
        A wav batch is normalized with ``store``'s statistics."""
        if self.is_wav:
            sup_views, qry_views = self._make_wav_views(
                ep.support, ep.query, self._v_query(augment_query) > 1, store, gen, draws)
        else:
            sup_draws, qry_draws = draws if draws is not None else (None, None)
            sup_views = self._make_views(ep.support, self.specaug, gen, sup_draws)
            qry_views = self._make_views(ep.query, self._v_query(augment_query) > 1, gen, qry_draws)
        with span("afsl.forward"):
            return self.model(sup_views, qry_views, ep.support_labels, n_way).scores

    @spanned("afsl.eval_batch")
    def _eval_episodes(
        self,
        ep: EpisodeBatch,
        n_way: int,
        augment_query: bool,
        draws: Optional[Tuple] = None,
        store: Union[PackedWavStore, WavHostStore, None] = None,
        multisegment: bool = False,
        tie_strategy: str = "",
        s_max: int = 1,
    ) -> torch.Tensor:
        """Accuracy per episode ``[E]``: of every query row, or with
        ``multisegment`` of the majority votes over each query item's
        ``s_max`` rows (``vote_accuracy``). Sets ``last_eval_batch`` to the
        batch's E."""
        self.last_eval_batch = ep.support.shape[0]
        scores = self._episode_scores(ep, n_way, augment_query, self.gen, draws, store)
        if multisegment:
            return self.vote_accuracy(scores, ep, n_way, tie_strategy, s_max)
        tile = 1 if self.exp.use_attention else self._v_query(augment_query)
        q_labels = ep.query_labels.repeat(1, tile)
        return (scores.argmax(dim=-1) == q_labels).to(torch.float32).mean(dim=-1)

    @staticmethod
    @spanned("afsl.vote")
    def vote_accuracy(
        scores: torch.Tensor, ep: EpisodeBatch, n_way: int, tie_strategy: str, s_max: int
    ) -> torch.Tensor:
        """Majority-vote accuracy per episode ``[E]`` from the scores of a
        multi-segment episode batch, query-major ``Q x s_max`` rows. Without
        attention and with augmented queries the scores hold ``Q * s_max``
        rows per view, view-major; the vote reads the original view's block
        only, as the reference's audio_ids are never tiled
        (loops/loops.py:257-277). A batch with no ``query_mask`` counts
        every row as real."""
        e, qtot = ep.query.shape[:2]
        q = qtot // s_max
        first = scores[:, :qtot]
        preds = first.argmax(dim=-1).reshape(e, q, s_max)
        posts = first.amax(dim=-1).reshape(e, q, s_max)
        mask = torch.ones_like(posts) if ep.query_mask is None else ep.query_mask.reshape(e, q, s_max)
        true = ep.query_labels.reshape(e, q, s_max)[:, :, 0]
        return majority_vote_accuracy(preds, posts, mask, true, n_way, tie_strategy)

    def eval_batch_size(
        self,
        store: Store,
        n_tasks: int,
        n_way: int,
        k_shot: int,
        k_query: int,
        augment_query: bool,
        multisegment: bool,
    ) -> int:
        """Episodes per eval batch: ``eval_episode_batch`` (at most
        ``n_tasks``), cut for multi-segment eval to ``multisegment_eval_batch``
        of the memory free now: what the card reports free plus what the
        caching allocator holds unused. The multi-segment rule's reading of
        the free memory goes to the counter ``eval.rule_free_bytes`` (None on
        the CPU)."""
        batch = min(self.eval_episode_batch, n_tasks)
        if not multisegment:
            return batch
        free = None
        if self.device.type == "cuda":
            free = (torch.cuda.mem_get_info(self.device)[0] + torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device))
        episode = self.episode_bytes(store, n_way, k_shot, k_query, augment_query)
        set_counter("eval.rule_free_bytes", free)
        return multisegment_eval_batch(
            batch, store.s_max, episode, free, int(np.prod(store.feat_shape)),
            self.exp.tpu.eval_segment_budget,
        )

    def episode_bytes(
        self, store: Store, n_way: int, k_shot: int, k_query: int,
        augment_query: bool,
    ) -> int:
        """``eval_episode_bytes`` of one multi-segment eval episode of this
        model on ``store`` (``Q x s_max`` query rows), with WaveAugment's
        chain over its augmented rows."""
        n_sup, n_qry = n_way * k_shot, n_way * k_query * store.s_max
        vq = self._v_query(augment_query)
        chain_rows = chain_row_bytes = 0
        if self.waveaug:
            chain_rows = self.exp.waveaug_params.aug_num * (n_sup + (n_qry if vq > 1 else 0))
            chain_row_bytes = self.waveaugment.row_bytes(store.seg_len)
        return eval_episode_bytes(
            n_sup, n_qry, self.v_support, vq, self.model.backbone.encoder.eval_item_bytes, chain_rows,
            chain_row_bytes,
        )

    def evaluate(
        self,
        store: Store,
        n_tasks: int,
        n_way: int,
        k_shot: int,
        k_query: int,
        augment_query: bool,
        multisegment: bool = False,
        tie_strategy: str = "",
    ) -> Tuple[float, float]:
        """Mean and std of per-task accuracy over ``n_tasks`` episodes
        (``eval_accuracies``)."""
        acc = self.eval_accuracies(store, n_tasks, n_way, k_shot, k_query, augment_query, multisegment,
                                   tie_strategy)
        return float(acc.mean()), float(acc.std())

    @spanned("afsl.eval_accuracies")
    @torch.inference_mode()
    def eval_accuracies(
        self,
        store: Store,
        n_tasks: int,
        n_way: int,
        k_shot: int,
        k_query: int,
        augment_query: bool,
        multisegment: bool = False,
        tie_strategy: str = "",
    ) -> np.ndarray:
        """Accuracy of each of ``n_tasks`` episodes; with ``multisegment``,
        of the majority votes of each query item's segments under
        ``tie_strategy``. The accuracies are read back once, at the end;
        ``last_eval_batch`` then holds the episodes per batch on this device. A
        host store feeds the batches from the host (the JAX package's
        host-fed eval), with one host Generator for the call.

        On a mesh every batch is split over the ranks, each sampling its
        share: a single-segment batch of ``eval_episode_batch`` evenly, a
        multi-segment batch as each rank's card holds (``eval_batch_size``
        on every rank); the last batch fills the ranks in order, and a rank
        left without episodes still joins the gather. Every rank returns
        the same ``n_tasks`` accuracies, batch by batch in rank order."""
        self.model.eval()
        eligible = int((store.class_counts >= k_shot + k_query).sum())
        if eligible < n_way:
            raise ValueError(
                f"only {eligible} classes have {k_shot + k_query} items; {n_way}-way needs {n_way}"
            )
        batch = self.eval_batch_size(store, n_tasks, n_way, k_shot, k_query, augment_query, multisegment)
        mesh = self.mesh
        if multisegment:
            caps = mesh.gather(torch.tensor([batch]), [mesh.rank], mesh.world).tolist()
        else:
            caps = mesh.shares(batch)
        t0 = time.perf_counter()
        batches = self._batches(store, n_way, k_shot, k_query, is_test=multisegment)
        accs, positions = [], []
        done = 0
        while done < n_tasks:  # the last batch takes what remains
            shares = fill_shares(n_tasks - done, caps)
            lo, size = done + sum(shares[: mesh.rank]), shares[mesh.rank]
            if size:
                accs.append(self._eval_episodes(
                    batches(size), n_way, augment_query, store=store, multisegment=multisegment,
                    tie_strategy=tie_strategy, s_max=store.s_max,
                ))
                positions.extend(range(lo, lo + size))
            done += sum(shares)
        local = torch.cat(accs) if accs else torch.zeros(0, device=self.device)
        acc = mesh.gather(local, positions, n_tasks).cpu().numpy()
        self.last_eval_seconds = time.perf_counter() - t0
        self.last_eval_batch = caps[mesh.rank]  # the per-batch E, not the last batch's remainder
        return acc

    def test(self) -> Dict[str, float]:
        exp = self.exp
        mean, std = self.evaluate(
            self.test_store,
            n_tasks=exp.n_testing_tasks,
            n_way=exp.n_way_test,
            k_shot=exp.n_shot_test,
            k_query=exp.n_query_test,
            augment_query=exp.test_query_augmentations,
            multisegment=exp.multi_segm,
            tie_strategy=exp.tie_strategy,
        )
        return {"mean_accuracy": mean, "accuracy_std": std}

    @spanned("afsl.predict")
    @torch.inference_mode()
    def predict_episode(
        self,
        support: np.ndarray,
        support_labels: Sequence[int],
        query: np.ndarray,
        n_way: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Tuple] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Classify fixed query items against a fixed support set: the
        serving entry point (``cli/predict.py``).

        support ``[S, F, T]`` normalized spec features, or ``[S, L]`` raw
        waveforms for a wav model (log-mel and the train store's z-norm on
        the device, as in eval), support_labels ``[S]`` ints in
        ``[0, n_way)``, query ``[Q, F, T]`` / ``[Q, L]``. Returns (pred ``[Q]``,
        scores ``[Q, n_way]`` f32). Support takes the training augmentation,
        queries follow ``test_query_augmentations``. ``generator`` (on this
        trainer's device) or ``draws = (support_draws, query_draws)``, each
        ``(ys [1, S|Q, T], tmask [1, T], fmask [1, F])`` for SpecAugment or
        WaveAugment draws with leaves ``[1, aug_num, S|Q, ...]`` for a wav
        model, fix the augmentation; by default the draws come from a
        generator seeded with 0.
        """
        self.model.eval()
        labels = torch.as_tensor(np.asarray(support_labels), dtype=torch.long)
        if n_way is None:
            n_way = int(labels.max()) + 1
        sup = torch.as_tensor(np.asarray(support, np.float32))
        qry = torch.as_tensor(np.asarray(query, np.float32))
        with span("afsl.h2d"):
            sup, qry = sup.to(self.device)[None], qry.to(self.device)[None]
        ep = EpisodeBatch(
            support=sup,
            support_labels=labels.to(self.device)[None],
            query=qry,
            query_labels=torch.zeros((1, qry.shape[1]), dtype=torch.long, device=self.device),
        )
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        scores = self._episode_scores(
            ep, n_way, self.exp.test_query_augmentations, gen, draws, self.train_store
        )
        # no-attention + augmented queries: Q*vq rows view-major; keep the
        # original-view block
        scores = scores[0, : qry.shape[1]].to(torch.float32)
        with span("afsl.readback"):  # the host waits here for the device
            scores = scores.cpu()
        return scores.argmax(dim=-1).numpy(), scores.numpy()
