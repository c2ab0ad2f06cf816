"""PyTorch port: the public API against the JAX package's, on the CPU.

* Every public name of each of the JAX package's nine subpackages exists in
  the port's subpackage of the same name, but for ``JAX_ONLY`` below: the
  names bound in the package, its modules, and each module's own top-level
  names (``def``, ``class`` and assignments, read from its source) as
  attributes of the port's module of the same name. ``RENAMED`` maps a
  name the port spells otherwise, held equal in value.
* The functions the port added for that, on the JAX package's inputs:
  ``pack_dataset`` gives the JAX ``PackedStore``'s segments, labels and
  class counts (bit-equal); ``make_synthetic_wav_dataset`` writes the JAX
  files (waveforms bit-equal, ``glob_norm`` within the log-mel tolerance of
  1e-3 dB); ``log_mel_spectrogram`` is the JAX one within 1e-3 dB (both
  flavours); ``SpecAugment`` is ``spec_augment_views`` with its parameters
  and, on given draws, the JAX views; ``time_warp`` is the warp view of
  ``views_reference`` on the same draws, and the JAX warp view;
  ``sample_episode_batch`` is ``sample_episode``; ``param_count`` counts the
  JAX tree plus the reference's two unused LayerNorms. The counterparts of
  the other subpackages' names are held in ``test_torch_port_interop.py``.
* Importing any subpackage of the port imports no JAX and builds no kernel;
  resolving a card for an entry point turns TF32 off.
"""

import ast
import importlib
import inspect
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_few_shot_learning_tpu.data as jax_data
import audio_few_shot_learning_tpu.ops as jax_ops
import audio_few_shot_learning_tpu_torch.data as port_data
import audio_few_shot_learning_tpu_torch.ops as port_ops
from _torch_port_helpers import SPECAUG, configs, jax_variables, jax_views, port_model
from audio_few_shot_learning_tpu.config import SpecAugParams as JaxSpecAugParams
from audio_few_shot_learning_tpu.ops.specaugment import _views_xla
from audio_few_shot_learning_tpu.train.state import param_count as jax_param_count
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch import device as port_device
from audio_few_shot_learning_tpu_torch.config import SpecAugParams
from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params, draw_warp_positions, views_reference
from audio_few_shot_learning_tpu_torch.train.state import param_count

SUBPACKAGES = ("data", "ops", "models", "losses", "train", "parallel", "utils", "preprocessing", "cli")
# JAX names with no counterpart in the port, and why; "module.name" is a
# module's own name, a bare name is bound in the package (or is a module,
# whose names are then all JAX-only)
JAX_ONLY = {
    "ops": {
        "pallas_utils",  # Pallas TPU helpers (tiling, interpret mode); the port's kernels are CUDA C++
    },
    "data": {
        "native_pack.native_available",  # the port builds the packer or raises; there is nothing to probe
    },
    "train": {
        # a flax train state (params, batch_stats, optax state); the port's
        # Trainer holds the model, its torch optimizer and the schedule
        "TrainState", "create_train_state", "state.TrainState", "state.create_train_state",
    },
    "parallel": {
        # jax.sharding over a device mesh; the port's rank is a process:
        "episode_sharding", "mesh.episode_sharding",  # EpisodeMesh.episode_shard / chunk_shard (this rank's slice)
        "replicated", "mesh.replicated",  # EpisodeMesh.broadcast_ (the same tensors on every rank)
        "shard_episode_keys", "mesh.shard_episode_keys",  # rank generators seeded seed + 1 + r * RANK_SEED_STRIDE
        "mesh.from_process_local",  # EpisodeMesh.gather (each rank's episodes into one global batch)
    },
    "utils": {
        "xla_flags",  # XLA_FLAGS merging for the TPU runtime; the port runs no XLA
    },
}
# JAX name -> the port's name for the same thing, held equal in value
RENAMED = {
    "data": {"datasets.HOST_STORE_HBM_FRACTION": "datasets.HOST_STORE_MEMORY_FRACTION"},
}
LOG_MEL_ATOL_DB = 1e-3


def exported(pkg) -> set:
    """Names defined in ``pkg`` or its modules and bound in its namespace,
    plus its modules."""
    names = {m.name for m in pkgutil.iter_modules(pkg.__path__)}
    for name, obj in vars(pkg).items():
        if name.startswith("_"):
            continue
        origin = obj.__name__ if inspect.ismodule(obj) else getattr(obj, "__module__", "") or ""
        if origin == pkg.__name__ or origin.startswith(pkg.__name__ + "."):
            names.add(name)
    return names


def module_names(module) -> set:
    """A module's own public top-level names: its ``def``s, ``class``es and
    assigned names, read from its source."""
    names = set()
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def public_names(pkg, skip=frozenset()) -> set:
    """``exported(pkg)`` plus ``module.name`` for each module's own names,
    but for the modules in ``skip``."""
    names = set(exported(pkg))
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name not in skip:
            module = importlib.import_module(f"{pkg.__name__}.{info.name}")
            names |= {f"{info.name}.{n}" for n in module_names(module)}
    return names


def port_has(port_pkg, name: str) -> bool:
    """A bare name among ``exported(port_pkg)``; ``module.name`` an attribute
    of the port's module of that name."""
    if "." not in name:
        return name in exported(port_pkg)
    module, attr = name.split(".")
    try:
        return hasattr(importlib.import_module(f"{port_pkg.__name__}.{module}"), attr)
    except ModuleNotFoundError:
        return False


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_jax_name(sub):
    jax_pkg = importlib.import_module(f"audio_few_shot_learning_tpu.{sub}")
    port_pkg = importlib.import_module(f"audio_few_shot_learning_tpu_torch.{sub}")
    jax_only, renamed = JAX_ONLY.get(sub, set()), RENAMED.get(sub, {})
    names = public_names(jax_pkg, skip={n for n in jax_only if "." not in n}) - jax_only
    missing = sorted(n for n in names if not port_has(port_pkg, renamed.get(n, n)))
    assert not missing, f"{port_pkg.__name__} lacks {missing}"
    assert not {n for n in jax_only if port_has(port_pkg, n)}  # listed as JAX-only but ported
    for jax_name, port_name in renamed.items():
        assert jax_name in names and not port_has(port_pkg, jax_name)  # one name in the port
        (jm, ja), (pm, pa) = jax_name.split("."), port_name.split(".")
        assert getattr(importlib.import_module(f"{jax_pkg.__name__}.{jm}"), ja) == \
            getattr(importlib.import_module(f"{port_pkg.__name__}.{pm}"), pa)


def test_pack_dataset_packs_as_the_jax_package():
    rng = np.random.default_rng(0)
    dataset = [(rng.standard_normal((int(rng.integers(1, 4)), 8, 6) if i % 3 == 0 else (8, 6)).astype(np.float32),
                i % 4) for i in range(14)]
    want = jax_data.pack_dataset(dataset, mean=0.3, std=1.7)
    got = port_data.pack_dataset(dataset, mean=0.3, std=1.7, device="cpu")
    assert isinstance(got, port_data.PackedStore) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.class_counts.numpy(), np.asarray(want.class_counts))
    np.testing.assert_array_equal(got.seg_counts.numpy(), np.asarray(want.seg_counts))


def test_pack_dataset_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_data.pack_dataset([(np.zeros((2, 3), np.float32), 0)])


@pytest.mark.parametrize("variable_length", [False, True])
def test_synthetic_wav_dataset_writes_the_jax_files(tmp_path, variable_length):
    kw = dict(n_classes=4, items_per_class=3, seconds=1.0, split_fractions=(2, 1, 1), seed=3,
              variable_length=variable_length)
    port_data.make_synthetic_wav_dataset(tmp_path / "port", **kw)
    jax_data.make_synthetic_wav_dataset(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy"))
    assert len(files) == 4 * 3 + 2
    for rel in files:
        a, b = (np.load(tmp_path / side / rel, allow_pickle=True) for side in ("port", "jax"))
        if rel.name == "glob_norm.npy":
            np.testing.assert_allclose(a, b, atol=LOG_MEL_ATOL_DB, rtol=0)
        elif rel.name == "splits.npy":
            assert [list(x) for x in a] == [list(x) for x in b]
        else:
            np.testing.assert_array_equal(a, b)
    ds = port_data.MetaAudioDataset(tcfg.ExperimentConfig.from_dict({"input_type": "wav", "device": "cpu"}),
                                    tmp_path / "port", "train")
    assert len(ds.filepaths) == 2 * 3


@pytest.mark.parametrize("flavor", ["online", "offline"])
def test_log_mel_spectrogram_matches_jax(flavor):
    wav = (0.3 * np.random.default_rng(1).standard_normal((2, 8000))).astype(np.float32)
    want = np.asarray(jax_ops.log_mel_spectrogram(jnp.asarray(wav), flavor, use_pallas=False))
    got = port_ops.log_mel_spectrogram(torch.from_numpy(wav), flavor)
    assert got.shape == want.shape == (2, 128, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=LOG_MEL_ATOL_DB, rtol=0)
    torch.testing.assert_close(got, port_ops.MelSpec(flavor)(torch.from_numpy(wav)), atol=0, rtol=0)


def test_spec_augment_callable():
    params = SpecAugParams.from_dict(SPECAUG)
    aug = port_ops.SpecAugment(params)
    assert aug.num_views == 4
    spec = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 5, 16, 40)).astype(np.float32))
    got = aug(spec, torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, port_ops.spec_augment_views(spec, torch.Generator().manual_seed(9), params),
                               atol=0, rtol=0)
    assert got.shape == (2, 5, 4, 16, 40)
    # on given draws: the JAX package's views of the same draws
    draws = draw_views_params(torch.Generator().manual_seed(4), params, 2, 5, 16, 40, "cpu")
    want = jax_views(spec.numpy(), tuple(d.numpy() for d in draws), SPECAUG["mask_value"])
    np.testing.assert_allclose(aug(spec, None, draws).numpy(), want, atol=1e-6, rtol=0)
    jax_aug = jax_ops.SpecAugment(JaxSpecAugParams.from_dict(SPECAUG))
    assert jax_aug.num_views == aug.num_views
    jax_views_of = jax.jit(lambda x, k: jax_aug(x, k))
    assert jax_views_of(jnp.asarray(spec[0].numpy()), jax.random.PRNGKey(0)).shape == got[0].shape


def test_time_warp_is_the_warp_view():
    spec = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 16, 40)).astype(np.float32))
    w = SPECAUG["W"]
    got = port_ops.time_warp(spec, torch.Generator().manual_seed(5), w)
    ys = draw_warp_positions(torch.Generator().manual_seed(5), (6,), 40, w, "cpu")
    none_t, none_f = torch.zeros((1, 40), dtype=torch.bool), torch.zeros((1, 16), dtype=torch.bool)
    want = views_reference(spec[None], ys[None], none_t, none_f, 0.0)[0, :, 1]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    jax_want = np.asarray(_views_xla(jnp.asarray(spec.numpy()), jnp.asarray(ys.numpy()),
                                     jnp.zeros(40, bool), jnp.zeros(16, bool), 0.0))[:, 1]
    np.testing.assert_allclose(got.numpy(), jax_want, atol=1e-6, rtol=0)
    assert not torch.equal(got, spec)


def test_sample_episode_batch_is_sample_episode():
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode

    rng = np.random.default_rng(4)
    store = port_data.pack_dataset([(rng.standard_normal((8, 6)).astype(np.float32), i % 5) for i in range(25)],
                                   device="cpu")
    a = port_data.sample_episode_batch(torch.Generator().manual_seed(1), store, 3, 2, 2, batch=4)
    b = sample_episode(torch.Generator().manual_seed(1), store, 3, 2, 2, 4)
    for name in ("support", "support_labels", "query", "query_labels"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), atol=0, rtol=0)
    assert a.support.shape == (4, 6, 8, 6)


@pytest.mark.parametrize("use_attention", [True, False])
def test_param_count_counts_the_jax_tree(use_attention):
    jexp, jmdl, texp, tmdl, feat_shape = configs("small", use_attention)
    _, variables = jax_variables(jexp, jmdl, feat_shape)
    model = port_model(texp, tmdl, feat_shape, variables)
    dead = sum(p.numel() for n, p in model.named_parameters() if n.startswith(("projection_head.ln1",
                                                                               "projection_head.ln2")))
    assert dead == 2 * (tmdl.projection.hidden_dim + tmdl.projection.output_dim)
    assert param_count(model) == jax_param_count(variables["params"]) + dead


def test_importing_ops_builds_no_kernel():
    code = ("import sys; import audio_few_shot_learning_tpu_torch.ops as o; "
            "from audio_few_shot_learning_tpu_torch.ops import cuda_build as b; "
            "assert not b._LIBS and not b._FUNCS, b._LIBS; "
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.fixture(scope="module")
def subpackage_imports():
    """Each subpackage imported in a fresh interpreter, all at once: what
    each one's import left in ``sys.modules`` and in the kernels' and the
    packer's caches."""
    code = ("import sys; import audio_few_shot_learning_tpu_torch.{}; "
            "from audio_few_shot_learning_tpu_torch.ops import cuda_build as b; "
            "from audio_few_shot_learning_tpu_torch.data import native_pack as n; "
            "assert not b._LIBS and not b._FUNCS and n._lib is None, b._LIBS; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'triton', 'audio_few_shot_learning_tpu')]; assert not bad, bad")
    procs = {sub: subprocess.Popen([sys.executable, "-c", code.format(sub)], stderr=subprocess.PIPE, text=True)
             for sub in SUBPACKAGES}
    return {sub: (p.wait(timeout=120), p.stderr.read()) for sub, p in procs.items()}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_importing_a_subpackage_imports_no_jax_and_builds_no_kernel(sub, subpackage_imports):
    rc, err = subpackage_imports[sub]
    assert rc == 0, err


def test_resolving_a_card_turns_tf32_off(monkeypatch):
    """An entry point that resolves a card runs float32 as float32: TF32 off
    for cuBLAS and cuDNN; the CPU leaves the flags alone."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert port_device.resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device().type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
