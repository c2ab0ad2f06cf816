"""Typed configuration tree.

Accepts the reference's two JSON config files **verbatim** (the
``experiment_config.json`` schema documented at reference README.md:73-197 and
the ``model_config.json`` schema at README.md:382-429) while giving the rest
of the framework a typed, defaulted, validated view.  The reference validates
configs only by ``KeyError`` on direct dict access (src/train_test.py:48-122);
here missing keys either take documented defaults or raise a clear error.

Extra TPU-specific knobs (``episode_batch``, ``mesh_shape``, ``dtype`` …) live
under optional keys so reference configs run unmodified.

This is the PyTorch package's own copy of the JAX package's schema: same
keys, same defaults, pure Python. The ``tpu.*`` block is parsed unchanged so
one JSON file drives both packages; here ``episode_batch``,
``episode_microbatch``, ``eval_episode_batch``, ``compute_dtype``, ``remat``,
``store_dtype``, ``fold_bn_eval``, ``eval_segment_budget``,
``bn_per_view_group``, ``seed`` and ``num_runs`` take effect, as does
``host_store`` (true keeps the splits in host RAM, false on the card, null
picks by size), and ``mesh_shape``, the world size of a data-parallel run:
it must equal that of the initialised process group (``torchrun``), and
above 1 without one it raises. ``use_pallas``, which names TPU machinery,
is accepted and inert.
``device`` selects the card (anything but ``"cpu"``) or the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple


_SENTINEL = object()


def _get(d: Dict[str, Any], key: str, default=_SENTINEL):
    if key in d:
        return d[key]
    if default is _SENTINEL:
        raise KeyError(f"Missing required config key: {key!r}")
    return default


@dataclasses.dataclass(frozen=True)
class SpecAugParams:
    """SpecAugment knobs (reference utils/augmentations.py:21-31)."""

    use: bool = False
    mask_param: int = 16
    W: int = 22
    num_mask: int = 1
    mask_value: float = 0.0
    p: float = 0.282

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SpecAugParams":
        return SpecAugParams(
            use=bool(_get(d, "use", False)),
            mask_param=int(_get(d, "mask_param", 16)),
            W=int(_get(d, "W", 22)),
            num_mask=int(_get(d, "num_mask", 1)),
            mask_value=float(_get(d, "mask_value", 0.0)),
            p=float(_get(d, "p", 0.282)),
        )


@dataclasses.dataclass(frozen=True)
class WaveAugParams:
    """Waveform augmentation bank knobs (reference utils/augmentations.py:180-376).

    Stored as a plain dict because the bank has ~25 scalar knobs that are
    consumed per-transform; see ops/waveaugment.py.
    """

    use: bool = False
    aug_num: int = 3
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "WaveAugParams":
        return WaveAugParams(
            use=bool(_get(d, "use", False)),
            aug_num=int(_get(d, "aug_num", 3)),
            raw=dict(d),
        )


@dataclasses.dataclass(frozen=True)
class CPLParams:
    """Contrastive-prototypical loss (reference loops/loss.py:99-165)."""

    use: bool = False
    m_param: int = 5
    t_param: float = 1.0


@dataclasses.dataclass(frozen=True)
class AngularParams:
    """Angular prototypical loss (reference loops/loss.py:39-97)."""

    use: bool = False
    angle: float = 0.0
    prototypes_as_anchors: bool = True


@dataclasses.dataclass(frozen=True)
class LossConfig:
    l_param: float = 1.0
    cpl: CPLParams = CPLParams()
    angular: AngularParams = AngularParams()

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LossConfig":
        cpl = d.get("cpl", {})
        ang = d.get("angular", {})
        return LossConfig(
            l_param=float(_get(d, "l_param", 1.0)),
            cpl=CPLParams(
                use=bool(cpl.get("use", False)),
                m_param=int(cpl.get("m_param", 5)),
                t_param=float(cpl.get("t_param", 1.0)),
            ),
            angular=AngularParams(
                use=bool(ang.get("use", False)),
                angle=float(ang.get("angle", 0.0)),
                prototypes_as_anchors=bool(ang.get("prototypes_as_anchors", True)),
            ),
        )


@dataclasses.dataclass(frozen=True)
class TPUConfig:
    """TPU-specific extensions — absent from reference configs, all defaulted.

    episode_batch: number of episodes fused into one jitted train step. The
        reference takes one optimizer step per episode (loops/loops.py:26-61);
        ``episode_batch=1`` reproduces that exactly, larger values average the
        gradient over E episodes per step (documented deviation, the headline
        throughput lever).
    mesh_shape: ranks along the ``episode`` data-parallel mesh axis, one
        process and one card each: the world size, checked against the
        initialised process group (``torchrun --nproc_per_node W``). None =
        the group's world, or one process without a group.
    compute_dtype: "bfloat16" (default, MXU-native) or "float32".
    use_pallas: route hot ops through Pallas kernels (auto-disabled off-TPU).
    """

    episode_batch: int = 1
    episode_microbatch: Optional[int] = None  # grad-accum chunk size (must divide episode_batch)
    eval_episode_batch: int = 16
    mesh_shape: Optional[int] = None
    compute_dtype: str = "bfloat16"
    use_pallas: bool = True
    # Rematerialize conv blocks in the backward pass. None = auto: on only
    # when the per-backward episode count (microbatch or episode_batch) is
    # >= 4, where block0's pre-pool activations (~4 GB at E=8 x 50 items x
    # 4 views) would cap HBM; off at reference granularity E=1, measured
    # ~5% faster on the v5e (BASELINE.md).
    remat: Optional[bool] = None
    # Multi-segment eval memory budget in "segment-episodes" (eval batch x
    # store.s_max). None = reckon the eval batch from the card's free memory
    # (train/engine.py::multisegment_eval_batch). Set explicitly to lower it
    # for bigger models without touching engine code.
    eval_segment_budget: Optional[int] = None
    store_dtype: str = "float32"
    # Keep the packed split in host RAM and stream sampled episode batches to
    # the device per step (data/hoststore.py) instead of the HBM-resident
    # PackedStore. None = auto: host-resident only when the packed split
    # would not fit beside the training program (> ~60% of the device's
    # reported HBM). True/False force. Spec input only.
    host_store: Optional[bool] = None
    seed: int = 0
    num_runs: int = 5  # reference hardcodes 5 repeated runs (src/train_test.py:103)
    # A/B knob (scripts/ab_deviations.py): emulate the reference's BatchNorm
    # batch-stat granularity — one stat group per (episode, view,
    # support|query) pass (its per-view Python loop normalizes 25-item
    # groups) instead of the fused E*V*(S+Q) batch. Training-dynamics
    # emulation only; default off = fused batch (documented deviation,
    # PARITY.md).
    bn_per_view_group: bool = False
    # Fold eval-mode BatchNorm (a per-channel affine of running stats) into
    # the conv kernels on forward-only paths (train=False). Removes one
    # full-size elementwise read/write pair per conv block from the eval
    # forward — XLA does NOT fuse the affine into the conv epilogue (measured
    # 1.29x on the 4-block eval stack, scripts/bn_fold_eval.py). Exactly
    # BN(conv(x,K,b)) == conv(x, K*inv, b*inv+shift) up to compute-dtype
    # rounding; training paths are untouched.
    fold_bn_eval: bool = True

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TPUConfig":
        fields = {f.name for f in dataclasses.fields(TPUConfig)}
        return TPUConfig(**{k: v for k, v in d.items() if k in fields})

    def remat_enabled(self) -> bool:
        """Resolve the remat policy (None = auto by per-backward batch)."""
        if self.remat is not None:
            return self.remat
        return (self.episode_microbatch or self.episode_batch) >= 4


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Mirror of the reference experiment_config.json (README.md:73-197)."""

    encoder_name: str = "Hybrid"
    dataset_name: str = "ESC-50-master"
    use_attention: bool = True
    use_contrastive: bool = True
    input_type: str = "spec"
    n_way_train: int = 5
    n_way_validation: int = 5
    n_way_test: int = 5
    n_shot_train: int = 5
    n_shot_validation: int = 5
    n_shot_test: int = 5
    n_query_train: int = 5
    n_query_validation: int = 5
    n_query_test: int = 5
    train_query_augmentations: bool = True
    validation_query_augmentations: bool = True
    test_query_augmentations: bool = True
    lr: float = 1e-3
    loss: LossConfig = LossConfig()
    num_epochs: int = 200
    multi_segm: bool = False
    tie_strategy: str = ""
    relation_head: bool = False
    n_training_tasks: int = 100
    n_testing_tasks: int = 2000
    device: str = "tpu"
    gpu_index: int = 0
    scheduler_milestones: Tuple[int, ...] = (20, 40, 60)
    scheduler_gamma: float = 0.5
    patience: int = 70
    experiment_folder: str = "default"
    normalize_prototypes: bool = True
    project_prototypes: bool = True
    specaug_params: SpecAugParams = SpecAugParams()
    waveaug_params: WaveAugParams = WaveAugParams()
    tpu: TPUConfig = TPUConfig()
    # Data root: reference hardcodes '/data' (src/train_test.py:35); here it is
    # a config key with the same default.
    data_root: str = "/data"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        return ExperimentConfig(
            encoder_name=str(_get(d, "encoder_name", "Hybrid")),
            dataset_name=str(_get(d, "dataset_name", "ESC-50-master")),
            use_attention=bool(_get(d, "use_attention", True)),
            use_contrastive=bool(_get(d, "use_contrastive", True)),
            input_type=str(_get(d, "input_type", "spec")),
            n_way_train=int(_get(d, "n_way_train", 5)),
            n_way_validation=int(_get(d, "n_way_validation", 5)),
            n_way_test=int(_get(d, "n_way_test", 5)),
            n_shot_train=int(_get(d, "n_shot_train", 5)),
            n_shot_validation=int(_get(d, "n_shot_validation", 5)),
            n_shot_test=int(_get(d, "n_shot_test", 5)),
            n_query_train=int(_get(d, "n_query_train", 5)),
            n_query_validation=int(_get(d, "n_query_validation", 5)),
            n_query_test=int(_get(d, "n_query_test", 5)),
            train_query_augmentations=bool(_get(d, "train_query_augmentations", True)),
            validation_query_augmentations=bool(
                _get(d, "validation_query_augmentations", True)
            ),
            test_query_augmentations=bool(_get(d, "test_query_augmentations", True)),
            lr=float(_get(d, "lr", 1e-3)),
            loss=LossConfig.from_dict(_get(d, "loss", {})),
            num_epochs=int(_get(d, "num_epochs", 200)),
            multi_segm=bool(_get(d, "multi_segm", False)),
            tie_strategy=str(_get(d, "tie_strategy", "")),
            relation_head=bool(_get(d, "relation_head", False)),
            n_training_tasks=int(_get(d, "n_training_tasks", 100)),
            n_testing_tasks=int(_get(d, "n_testing_tasks", 2000)),
            device=str(_get(d, "device", "tpu")),
            gpu_index=int(_get(d, "gpu_index", 0)),
            scheduler_milestones=tuple(_get(d, "scheduler_milestones", (20, 40, 60))),
            scheduler_gamma=float(_get(d, "scheduler_gamma", 0.5)),
            patience=int(_get(d, "patience", 70)),
            experiment_folder=str(_get(d, "experiment_folder", "default")),
            normalize_prototypes=bool(_get(d, "normalize_prototypes", True)),
            project_prototypes=bool(_get(d, "project_prototypes", True)),
            specaug_params=SpecAugParams.from_dict(_get(d, "specaug_params", {})),
            waveaug_params=WaveAugParams.from_dict(_get(d, "waveaug_params", {})),
            tpu=TPUConfig.from_dict(_get(d, "tpu", {})),
            data_root=str(_get(d, "data_root", "/data")),
        )

    def validate(self) -> None:
        if self.encoder_name not in ("CNN", "Hybrid", "AST"):
            raise ValueError(f"encoder_name must be CNN|Hybrid|AST, got {self.encoder_name}")
        if self.input_type not in ("spec", "wav"):
            raise ValueError(f"input_type must be spec|wav, got {self.input_type}")
        if self.tie_strategy not in ("", "min_label", "max_posterior"):
            raise ValueError(f"unknown tie_strategy {self.tie_strategy!r}")
        if self.loss.cpl.use and self.loss.angular.use:
            raise ValueError("cpl and angular losses are mutually exclusive")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    in_channels: int = 1
    hidden_channels: int = 64
    pool_dim: Tuple[int, int] = (3, 3)
    out_dim: int = 64


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    in_channels: int = 1
    seq_layers: int = 1
    seq_type: str = "RNN"
    bidirectional: bool = False
    hidden_channels: int = 64
    pool_dim: Tuple[int, int] = (3, 3)
    out_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    """The Audio Spectrogram Transformer (Gong, Chung and Glass, 2021,
    arXiv:2104.01778; ``src/models/ast_models.py::ASTModel``): a ViT of
    ``depth`` pre-LN blocks of width ``embed_dim``, ``num_heads`` heads and an
    MLP of ``mlp_dim``, over ``patch`` x ``patch`` patches taken at strides
    ``(fstride, tstride)``, LayerNorm eps ``ln_eps``; its ``mlp_head`` gives
    ``out_dim`` features. The JAX package has no such encoder. Defaults are
    the published ViT-B widths and the ESC-50 recipe's strides."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch: int = 16
    fstride: int = 10
    tstride: int = 10
    out_dim: int = 64
    ln_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    embed_dim: int = 64
    num_heads: int = 1
    ffn_dim: int = 256
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    input_dim: int = 256
    hidden_dim: int = 128
    output_dim: int = 256


@dataclasses.dataclass(frozen=True)
class RelationConfig:
    """Relation-head block. Present in the reference config schema
    (README.md:417-424) but has **no implementation** in the reference code;
    implemented here as a config-compatible MLP relation module."""

    input_dim: int = 512
    hidden_dim1: int = 256
    hidden_dim2: int = 128
    hidden_dim3: int = 256
    out_dim: int = 1


def _pool(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mirror of the reference model_config.json (README.md:382-429)."""

    cnn: CNNConfig = CNNConfig()
    hybrid: HybridConfig = HybridConfig()
    attention: AttentionConfig = AttentionConfig()
    projection: ProjectionConfig = ProjectionConfig()
    relation: RelationConfig = RelationConfig()
    ast: ASTConfig = ASTConfig()

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        c = d.get("CNN", {})
        t = d.get("AST", {})
        h = d.get("Hybrid", {})
        a = d.get("Attention", {})
        p = d.get("Projection", {})
        r = d.get("Relation", {})
        return ModelConfig(
            cnn=CNNConfig(
                in_channels=int(c.get("in_channels", 1)),
                hidden_channels=int(c.get("hidden_channels", 64)),
                pool_dim=_pool(c.get("pool_dim", (3, 3))),
                out_dim=int(c.get("out_dim", 64)),
            ),
            hybrid=HybridConfig(
                in_channels=int(h.get("in_channels", 1)),
                seq_layers=int(h.get("seq_layers", 1)),
                seq_type=str(h.get("seq_type", "RNN")),
                bidirectional=bool(h.get("bidirectional", False)),
                hidden_channels=int(h.get("hidden_channels", 64)),
                pool_dim=_pool(h.get("pool_dim", (3, 3))),
                out_dim=int(h.get("out_dim", 64)),
            ),
            attention=AttentionConfig(
                embed_dim=int(a.get("embed_dim", 64)),
                num_heads=int(a.get("num_heads", 1)),
                ffn_dim=int(a.get("ffn_dim", 256)),
                dropout=float(a.get("dropout", 0.1)),
            ),
            projection=ProjectionConfig(
                input_dim=int(p.get("input_dim", 256)),
                hidden_dim=int(p.get("hidden_dim", 128)),
                output_dim=int(p.get("output_dim", 256)),
            ),
            relation=RelationConfig(
                input_dim=int(r.get("input_dim", 512)),
                hidden_dim1=int(r.get("hidden_dim1", 256)),
                hidden_dim2=int(r.get("hidden_dim2", 128)),
                hidden_dim3=int(r.get("hidden_dim3", 256)),
                out_dim=int(r.get("out_dim", 1)),
            ),
            ast=ASTConfig(
                embed_dim=int(t.get("embed_dim", 768)),
                depth=int(t.get("depth", 12)),
                num_heads=int(t.get("num_heads", 12)),
                mlp_dim=int(t.get("mlp_dim", 3072)),
                patch=int(t.get("patch", 16)),
                fstride=int(t.get("fstride", 10)),
                tstride=int(t.get("tstride", 10)),
                out_dim=int(t.get("out_dim", 64)),
                ln_eps=float(t.get("ln_eps", 1e-6)),
            ),
        )


def load_configs(
    experiment_path: str, model_path: str
) -> Tuple[ExperimentConfig, ModelConfig]:
    """Load the two reference-schema JSON files (src/train_test.py:27-32)."""
    with open(experiment_path, "r") as f:
        exp = ExperimentConfig.from_dict(json.load(f))
    with open(model_path, "r") as f:
        mdl = ModelConfig.from_dict(json.load(f))
    exp.validate()
    return exp, mdl


# Canonical feature-extraction constants shared by the whole framework
# (reference offline_preprocessing/full_stack_ESC.py:40-45, src/train_test.py:123-129).
SAMPLE_RATE = 16000
N_MELS = 128
N_FFT = 1024
HOP_LENGTH = 512
MEL_POWER = 2.0
SEGMENT_SECONDS = 5  # NSynth uses 4 (full_stack_NSYNTH.py:35-40)
