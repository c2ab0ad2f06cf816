"""PyTorch port: the two dataset-scale drivers, ``scripts/torch_port_nsynth_scale.py``
and ``scripts/torch_port_wav_scale.py``, against the JAX package's
``scripts/stress_nsynth_scale.py`` and ``scripts/wav_scale_stress.py``
(loaded with ``importlib``), on the CPU (~30 s in one process).

* The generators: ``long_tail_counts`` (NSynth's 1 006 classes over 306 000
  items, and small) and ``birdclef_lengths`` (65 000 items at scale 1.0, and
  small) give equal arrays; at a tiny size the generated ``.npy`` files and
  ``splits.npy`` are bit-equal.
* The stores: the port's wav ``build_store`` equals the JAX script's
  ``WavHostStore`` field by field (float16 and float32), its buffer the JAX
  ``flat`` followed by ``tails``; the port's packed NSynth-style split (the
  driver's bfloat16 ``HostStore`` and the ``PackedStore`` made from it) has
  the JAX ``PackedStore``'s segments, labels, class table (as values) and
  ``m_max``; one host-sampled episode batch from each store is bit-equal to
  the JAX host sampler's from the same ``np.random.Generator``.
* The configs: the wav driver's experiment is the JAX script's field for
  field (captured where the JAX ``main`` builds it); the NSynth driver's
  train config is ``configs/nsynth_cpl.json`` + ``model_config_nsynth.json``
  as shipped but for the depth cuts, the split's folder and the ``tpu``
  placement fields.
* Both drivers end to end with ``--device cpu`` at the helpers' small
  geometry (the shipped configs' model widths monkeypatched, as
  ``tests/test_torch_port_protocol_drivers.py`` does): the JSON keys, the
  launches of the plain versions (0 0 0), a finite loss, accuracies in
  [0, 1]; with no card and no ``--device cpu`` each driver raises.
* One eval batch of ``configs/nsynth_cpl.json`` + ``model_config_nsynth.json``
  at NSynth's real geometry, 128x126 (E=1, 5-way 1-shot 1-query, the
  SpecAugment draws fed as data), through the JAX package and the port on
  the same weights in float32: scores within ``SCORE_ATOL`` = 1e-3 (the
  slice tests' tolerance), equal argmax and accuracy.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401 (jax_native_packer: a fixture)
    GEOMETRIES, jax_native_packer, jax_variables, jax_views, numpy_draws, port_model, torch_draws,
)
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.datasets import MetaAudioDataset as JaxMetaAudioDataset
from audio_few_shot_learning_tpu.data.hoststore import HostStore as JaxHostStore
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset
from audio_few_shot_learning_tpu_torch.data.episodes import EpisodeBatch
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.train.engine import Trainer

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("support", "support_labels", "query", "query_labels", "audio_ids", "query_mask")
SCORE_ATOL = 1e-3


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port_ns = _load("torch_port_nsynth_scale", REPO / "scripts" / "torch_port_nsynth_scale.py")
port_wav = _load("torch_port_wav_scale", REPO / "scripts" / "torch_port_wav_scale.py")
jax_ns = _load("jax_stress_nsynth_scale", REPO / "scripts" / "stress_nsynth_scale.py")
jax_wav = _load("jax_wav_scale_stress", REPO / "scripts" / "wav_scale_stress.py")


def _bits(x):
    """Comparable numpy bits of a numpy or torch array (bfloat16 as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_episodes(want, got: EpisodeBatch, upcast=False):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if upcast and f in ("support", "query"):
            b = b.float()
        assert tuple(np.shape(a)) == tuple(b.shape), f
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=f)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_classes,total", [(1006, 306_000), (1006, 40_000), (10, 250), (7, 1000)])
def test_long_tail_counts_are_the_jax_scripts(n_classes, total):
    want = jax_ns.long_tail_counts(np.random.default_rng(0), n_classes, total)
    got = port_ns.long_tail_counts(np.random.default_rng(0), n_classes, total)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == total and got.min() >= 20
    if (n_classes, total) == (1006, 306_000):  # NSynth's skew: the JAX script's record
        assert (got.min(), got.max()) == (57, 29045)


@pytest.mark.parametrize("n_items,scale", [(65000, 1.0), (3000, 1.0), (300, 0.05)])
def test_birdclef_lengths_are_the_jax_scripts(n_items, scale):
    want = jax_wav.birdclef_lengths(n_items, scale, np.random.default_rng(0))
    got = port_wav.birdclef_lengths(n_items, scale, np.random.default_rng(0))
    np.testing.assert_array_equal(got, want)
    if scale == 1.0:  # 180-s items at 5-s segments: BirdClef's s_max
        assert -(-got.max() // (port_wav.SEG_SECONDS * port_wav.SR)) == 36


def test_nsynth_files_are_the_jax_scripts(tmp_path):
    want_counts, _ = jax_ns.generate(tmp_path / "jax", 10, 250, 16, 12, seed=0)
    got_counts, _ = port_ns.generate(tmp_path / "port", 10, 250, 16, 12, seed=0, threads=4)
    np.testing.assert_array_equal(got_counts, want_counts)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy"))
    assert len(files) == 250 + 2
    for rel in files:
        if rel.name == "splits.npy":
            a, b = (np.load(tmp_path / d / rel, allow_pickle=True) for d in ("jax", "port"))
            assert [list(s) for s in a] == [list(s) for s in b]
        else:
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


# ---------------------------------------------------------------------------
# stores and the host sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f16", "f32"])
def test_wav_store_is_the_jax_scripts(dtype):
    want, _ = jax_wav.build_store(300, 6, 0.05, dtype)
    got, _ = port_wav.build_store(300, 6, 0.05, dtype)
    assert got.dtype == (torch.float16 if dtype == "f16" else torch.float32)
    assert got.flat.numpy().dtype == want.flat.dtype and want.flat.size > got.seg_len
    want_buffer = np.concatenate([want.flat, want.tails.reshape(-1)])
    np.testing.assert_array_equal(got.buffer.numpy().view(np.uint8), want_buffer.view(np.uint8))  # bit for bit
    np.testing.assert_array_equal(got.tails.numpy(), want.tails)
    for f in ("offsets", "lengths", "tail_index", "seg_counts", "labels", "class_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for a, b in zip(got.class_items, want.class_items):
        np.testing.assert_array_equal(a, b)
    assert (got.seg_len, got.n_classes, got.s_max, got.multi_segm, got.num_items, got.nbytes()) == \
        (want.seg_len, want.n_classes, want.s_max, want.multi_segm, want.num_items, want.nbytes())


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_wav_store_samples_the_jax_episodes(is_test):
    want_store, _ = jax_wav.build_store(300, 6, 0.05, "f16")
    got_store, _ = port_wav.build_store(300, 6, 0.05, "f16")
    assert got_store.s_max > 1
    want = want_store.sample_episode_batch(np.random.default_rng(1), 5, 5, 5, is_test, 4)
    got = got_store.sample_episode_batch(np.random.default_rng(1), 5, 5, 5, is_test, 4)
    _assert_same_episodes(want, got, upcast=True)


def _nsynth_split(tmp_path):
    root = tmp_path / "nsynth_scale"
    port_ns.generate(root, 10, 250, 16, 12, seed=0)
    return root


def test_nsynth_split_packs_as_the_jax_store(tmp_path, jax_native_packer):
    root = _nsynth_split(tmp_path)
    jexp = jcfg.ExperimentConfig.from_dict({
        "dataset_name": "nsynth_scale", "encoder_name": "CNN", "specaug_params": {"use": False},
        "tpu": {"store_dtype": "bfloat16", "mesh_shape": 1}})
    want = JaxMetaAudioDataset(jexp, root, "train").to_packed_store(dtype="bfloat16")
    ds = MetaAudioDataset(port_ns.scan_config(root, "nsynth_scale", torch.device("cpu")), root, "train")
    host = ds.to_host_store(dtype="bfloat16")
    stores = (PackedStore.from_flat_arrays(host.segments, host.seg_counts, host.labels, host.n_classes,
                                           device="cpu"),
              ds.to_packed_store(dtype="bfloat16", device="cpu"))
    assert len(ds) == 250 and host.segments.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(host.segments), _bits(want.segments))
    for got in stores:
        np.testing.assert_array_equal(_bits(got.segments), _bits(want.segments))
        for f in ("labels", "seg_offsets", "seg_counts", "class_counts", "class_table"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        assert got.class_table.shape[1] == want.class_table.shape[1] == int(np.asarray(want.class_counts).max())
        assert (got.n_classes, got.s_max, got.multi_segm) == (want.n_classes, want.s_max, want.multi_segm)

    # the driver's host arm: one host-sampled batch, bit-equal to the JAX host sampler's
    jhost = JaxHostStore.from_flat_arrays(np.asarray(want.segments), np.asarray(want.seg_counts),
                                          np.asarray(want.labels), want.n_classes)
    _assert_same_episodes(jhost.sample_episode_batch(np.random.default_rng(0), 5, 5, 5, batch=8),
                          host.sample_episode_batch(np.random.default_rng(0), 5, 5, 5, batch=8))


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


def _fields(exp) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(exp)))  # tuples as lists, as both packages' configs hold them


def test_wav_experiment_is_the_jax_scripts(monkeypatch):
    """The JAX script's config, captured where its ``main`` builds it (at a
    tiny store), field for field against the port driver's."""
    import audio_few_shot_learning_tpu.config as jax_config

    seen = []

    def capture(d):
        seen.append(d)
        raise KeyboardInterrupt  # stop before the JAX script trains

    monkeypatch.setattr(jax_config.ExperimentConfig, "from_dict", staticmethod(capture))
    monkeypatch.setattr("sys.argv", ["wav_scale_stress.py", "--items", "300", "--scale", "0.05", "--steps", "5",
                                     "--episode-batch", "2", "--eval-tasks", "7", "--cpu"])
    with pytest.raises(KeyboardInterrupt):
        jax_wav.main()
    monkeypatch.undo()
    want = _fields(jcfg.ExperimentConfig.from_dict(seen[0]))
    got = _fields(port_wav.experiment(2, 5, 7, torch.device("cuda:0")))
    assert got == want
    assert _fields(port_wav.experiment(2, 5, 7, torch.device("cpu"))) == {**want, "device": "cpu"}


@pytest.mark.parametrize("host_store", [None, True])
def test_nsynth_train_config_is_the_shipped_one_cut_in_depth(tmp_path, host_store):
    exp, mdl = port_ns.train_config(tmp_path / "nsynth_scale", host_store, torch.device("cuda:0"))
    shipped = tcfg.load_configs(str(REPO / "configs" / "nsynth_cpl.json"),
                                str(REPO / "configs" / "model_config_nsynth.json"))
    assert dataclasses.asdict(mdl) == dataclasses.asdict(shipped[1])
    got, want = _fields(exp), _fields(shipped[0])
    cut = {"dataset_name": "nsynth_scale", "data_root": str(tmp_path), "num_epochs": 1,
           "n_training_tasks": port_ns.TRAIN_TASKS, "n_testing_tasks": port_ns.TEST_TASKS}
    assert {k: got[k] for k in cut} == cut
    assert {k: v for k, v in got.items() if k not in cut and k != "tpu"} == \
        {k: v for k, v in want.items() if k not in cut and k != "tpu"}
    tpu = {"store_dtype": "bfloat16", "host_store": host_store, "eval_episode_batch": port_ns.TEST_BATCH}
    assert got["tpu"] == {**want["tpu"], **tpu} and got["tpu"]["episode_batch"] == 1


# ---------------------------------------------------------------------------
# the drivers end to end on the CPU
# ---------------------------------------------------------------------------


JAX_NSYNTH_KEYS = set(json.loads((REPO / "experiments" / "stress_nsynth_306k_r4.json").read_text()))
JAX_WAV_KEYS = {"items", "scale", "dtype", "store_gb", "s_max", "pack_seconds", "train_eps_per_sec", "loss_finite",
                "raw_device_put_floor_steps_per_sec", "raw_floor_eps_per_sec", "eval_smax_tasks_per_sec",
                "eval_acc_sane", "backend"}
JAX_WAV_PACK_ONLY_KEYS = {"items", "scale", "dtype", "store_gb", "s_max", "pack_seconds",
                          "host_assembly_ms_per_step", "episode_batch", "support_shape", "query_shape"}


def test_nsynth_driver_runs_on_the_cpu(tmp_path, monkeypatch):
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    monkeypatch.setattr(port_ns, "MODEL_CONFIG", tmp_path / "mdl.json")
    root = tmp_path / "build" / "nsynth_scale"
    (f, t) = GEOMETRIES["small"][0]
    out = port_ns.main(["--root", str(root), "--items", "250", "--classes", "10", "--mels", str(f), "--frames",
                        str(t), "--device", "cpu", "--out", str(tmp_path / "result.json")])
    assert JAX_NSYNTH_KEYS <= set(out) and json.loads((tmp_path / "result.json").read_text()) == out
    assert (out["items"], out["scanned_items"], out["classes"], out["feat_shape"]) == (250, 250, 10, [f, t])
    assert out["store_dtype"] == "bfloat16" and out["store_class"] == "HostStore" and out["native_packer"]
    assert out["class_table_m_max"] == out["class_count_max"] and out["sampling_flat"] in (True, False)
    assert out["device"] == "cpu" and out["card"] is None and out["peak_rss_gb_run"] >= out["peak_rss_gb"] > 0
    arms = out["train"]
    assert {a["store"] for a in arms.values()} == {"PackedStore", "HostStore"}
    assert arms["host_store_true"]["host_mode"] and not arms["host_store_null"]["host_mode"]
    for arm in arms.values():
        assert arm["launches_per_train_step"] == {"0 0 0": port_ns.TRAIN_TASKS}  # plain versions on the CPU
        assert arm["launches_per_eval_batch"] == {"0 0 0": port_ns.TEST_TASKS // port_ns.TEST_BATCH}
        assert np.isfinite(arm["loss"]) and 0.0 <= arm["test_accuracy"] <= 1.0
        assert arm["eval_batch"] == port_ns.TEST_BATCH and arm["peak_memory_allocated_gb"] is None
    assert not root.exists() and not root.with_name("nsynth_scale_small").exists()  # removed without --keep


@pytest.mark.parametrize("pack_only", [False, True], ids=["train_eval", "pack_only"])
def test_wav_driver_runs_on_the_cpu(tmp_path, monkeypatch, pack_only):
    monkeypatch.setattr(port_wav, "MODEL_CONFIG", GEOMETRIES["wav"][1])
    argv = ["--items", "150", "--classes", "6", "--scale", "0.05", "--steps", "1", "--episode-batch", "1",
            "--eval-tasks", "1", "--device", "cpu", "--out", str(tmp_path / "result.json")]
    out = port_wav.main(argv + (["--pack-only"] if pack_only else []))
    assert json.loads((tmp_path / "result.json").read_text()) == out
    assert out["store"] == "WavHostStore" and out["s_max"] == 2 and out["device"] == "cpu"
    if pack_only:
        assert JAX_WAV_PACK_ONLY_KEYS <= set(out) and "train_eps_per_sec" not in out
        assert out["support_shape"] == [1, 25, port_wav.SEG_SECONDS * port_wav.SR]
        return
    assert JAX_WAV_KEYS <= set(out) and out["backend"] == "cpu"
    assert out["launches_per_train_step"] == {"0 0 0": 2} and out["train_launches"] == [0, 0, 0]  # 2 epochs x 1 step
    assert out["launches_per_eval_batch"] == {"0 0 0": 1} and out["eval_batch"] == 1
    assert out["loss_finite"] and np.isfinite(out["loss"]) and out["eval_acc_sane"]
    assert 0.0 <= out["eval_accuracy"] <= 1.0
    assert out["raw_device_put_floor_steps_per_sec"] is None  # no card: not measured


def test_drivers_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ns.main(["--root", str(tmp_path / "ns"), "--items", "250", "--classes", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_wav.main(["--items", "150", "--classes", "6", "--scale", "0.05"])
    assert not (tmp_path / "ns").exists()  # raised before writing anything


# ---------------------------------------------------------------------------
# NSynth's real geometry against the JAX package
# ---------------------------------------------------------------------------


def test_nsynth_geometry_eval_batch_matches_jax():
    """One eval batch of the shipped NSynth CPL config at 128x126, float32."""
    cfg = json.loads((REPO / "configs" / "nsynth_cpl.json").read_text())
    cfg.update(device="cpu", n_shot_test=1, n_query_test=1, tpu={"compute_dtype": "float32"})
    mdl = json.loads((REPO / "configs" / "model_config_nsynth.json").read_text())
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(cfg), jcfg.ModelConfig.from_dict(mdl)
    texp, tmdl = tcfg.ExperimentConfig.from_dict(cfg), tcfg.ModelConfig.from_dict(mdl)
    f, t = 128, 126
    n_way = texp.n_way_test
    jmodel, variables = jax_variables(jexp, jmdl, (f, t), seed=5)
    rng = np.random.default_rng(6)
    sup = rng.standard_normal((1, n_way, f, t)).astype(np.float32)
    qry = rng.standard_normal((1, n_way, f, t)).astype(np.float32)
    ways = np.arange(n_way)
    ep = EpisodeBatch(support=torch.from_numpy(sup), support_labels=torch.from_numpy(ways[None]),
                      query=torch.from_numpy(qry), query_labels=torch.from_numpy(ways[None]))
    w = texp.specaug_params.W
    draws_s, draws_q = numpy_draws(rng, 1, n_way, f, t, w), numpy_draws(rng, 1, n_way, f, t, w)
    want = np.asarray(jax.jit(lambda v, s, q, lab: jmodel.apply(v, s, q, lab, n_way, train=False).scores)(
        variables, jax_views(sup, draws_s, texp.specaug_params.mask_value),
        jax_views(qry, draws_q, texp.specaug_params.mask_value), ways[None]))

    store = PackedStore.pack(list(sup[0]) + list(qry[0]), np.tile(ways, 2), device="cpu")
    trainer = Trainer(texp, tmdl, store, test_store=store)
    trainer.model = port_model(texp, tmdl, (f, t), variables)
    draws = (torch_draws(draws_s), torch_draws(draws_q))
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, n_way, True, trainer.gen, draws).numpy()
        acc = trainer._eval_episodes(ep, n_way, True, draws).numpy()
    assert scores.shape == (1, n_way, n_way) and trainer.feat_shape == (f, t)
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(acc, (want.argmax(-1) == ways[None]).mean(-1), atol=1e-6)
