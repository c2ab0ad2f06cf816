"""PyTorch port: the counterparts of the JAX package's last public names,
each against the JAX function on the same inputs, on the CPU (~25 s in one
process).

* ``train/torch_interop.py``: the port model made by
  ``from_jax_variables(variables)`` exports the keys and arrays of JAX
  ``export_reference_state_dict(variables)``, bit-equal in float32 (Hybrid
  with and without attention, the CNN with its permuted head); the JAX
  import of the port's export gives ``variables`` back bit-equal; the
  port's import of the JAX export loads strict and gives the same tensors;
  a missing key, a shape mismatch and a stray key raise the same exception
  types on both sides; the reference's dead state is ignored on both.
* ``models/encoders.py::ConvEncoder``: the JAX ``ConvEncoder``'s output on
  the same weights and input, within the backbone tolerance (1e-4, float32,
  the models tests' ``FEAT_ATOL``), eval (folded and unfolded) and train.
* ``data/native_pack.py::pack_files``: the JAX ``pack_files`` bit for bit on
  a seeded tree (float32 and float64 files, 2-D and 3-D, shorter than a row);
  where the JAX one returns False the port's raises.
* ``data/episodes.py::sample_wav_episode``: by distribution against the JAX
  sampler on the same store (chi-square over classes and segment starts,
  as tests/test_data.py compares samplers); on a ``WavHostStore`` the JAX
  host sampler's episodes, exactly, from one numpy Generator; a spec store
  raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_port_helpers import GEOMETRIES, configs, exp_dict, jax_native_packer, jax_variables, port_model  # noqa: F401
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data import episodes as jax_episodes
from audio_few_shot_learning_tpu.data.wavhoststore import WavHostStore as JaxWavHostStore
from audio_few_shot_learning_tpu.data.wavstore import PackedWavStore as JaxWavStore
from audio_few_shot_learning_tpu.models.encoders import ConvEncoder as JaxConvEncoder
from audio_few_shot_learning_tpu.train import torch_interop as jax_interop
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data import native_pack
from audio_few_shot_learning_tpu_torch.data.episodes import sample_wav_episode
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.models.encoders import ConvEncoder
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.train import torch_interop

FEAT_ATOL = 1e-4  # tests/test_torch_port_models.py's backbone tolerance
CHI2_P = 1e-4
CNN_FPRIME = {"CNN": {"pool_dim": [2, 2], "hidden_channels": 8, "out_dim": 32},
              "Projection": {"input_dim": 32, "hidden_dim": 32, "output_dim": 64}}
_CACHE = {}


def _bridged(case):
    """(port model, JAX variables as numpy, port exp, port mdl, feat_shape)."""
    if case not in _CACHE:
        if case == "cnn_fprime":  # F' x T' = 3 x 4 > 1: the head's permuted rows
            feat_shape = GEOMETRIES["fprime"][0]
            e = exp_dict(use_attention=False, encoder_name="CNN")
            jexp, jmdl = jcfg.ExperimentConfig.from_dict(e), jcfg.ModelConfig.from_dict(CNN_FPRIME)
            texp, tmdl = tcfg.ExperimentConfig.from_dict(e), tcfg.ModelConfig.from_dict(CNN_FPRIME)
        else:
            geometry, attention = {"small": ("small", True), "small_no_attention": ("small", False)}[case]
            jexp, jmdl, texp, tmdl, feat_shape = configs(geometry, attention)
        _, variables = jax_variables(jexp, jmdl, feat_shape)
        _CACHE[case] = (port_model(texp, tmdl, feat_shape, variables), variables, texp, tmdl, feat_shape)
    return _CACHE[case]


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{path}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# train/torch_interop.py
# ---------------------------------------------------------------------------

CASES = ["small", "small_no_attention", "cnn_fprime"]


@pytest.mark.parametrize("case", CASES)
def test_export_matches_jax(case):
    model, variables, *_ = _bridged(case)
    got = torch_interop.export_reference_state_dict(model)
    want = jax_interop.export_reference_state_dict(variables)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_import_round_trips_with_jax(case):
    model, variables, texp, tmdl, feat_shape = _bridged(case)
    # the JAX import of the port's export is the variables it came from
    back = jax_interop.import_reference_state_dict(torch_interop.export_reference_state_dict(model), variables)
    _tree_equal({k: back[k] for k in variables}, variables)
    # the port's import of the JAX export: a strict load into a copy
    fresh = FewShotEpisodeModel(texp, tmdl, feat_shape)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    loaded = torch_interop.import_reference_state_dict(jax_interop.export_reference_state_dict(variables), fresh)
    assert loaded is not fresh
    for key, value in fresh.state_dict().items():  # the template is left as it was
        assert torch.equal(value, before[key]), key
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert torch_interop.import_reference_state_dict(model.state_dict(), fresh, inplace=True) is fresh
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def _corrupt(sd, how):
    sd = dict(sd)
    if how == "missing":
        del sd["projection_head.fc1.weight"]
    elif how == "shape":
        sd["projection_head.fc2.bias"] = np.zeros(3, np.float32)
    elif how == "stray":
        sd["backbone.encoder.extra.weight"] = np.zeros(2, np.float32)
    elif how == "dead_state":  # ignored on both sides
        sd["projection_head.ln1.weight"] = np.full_like(sd["projection_head.ln1.weight"], 7.0)
        sd["backbone.encoder.conv_encoder.0.1.num_batches_tracked"] = np.array(99, np.int64)
    return sd


@pytest.mark.parametrize("how,error,match", [
    ("missing", KeyError, "projection_head.fc1.weight"),
    ("shape", ValueError, "projection_head.fc2.bias"),
    ("stray", ValueError, "backbone.encoder.extra.weight"),
    ("dead_state", None, None),
])
def test_import_errors_match_jax(how, error, match):
    model, variables, *_ = _bridged("small")
    sd = _corrupt(jax_interop.export_reference_state_dict(variables), how)
    if error is None:
        jax_interop.import_reference_state_dict(sd, variables)
        loaded = torch_interop.import_reference_state_dict(sd, model)
        assert loaded.state_dict()["projection_head.ln1.weight"].eq(1.0).all()  # the model's own dead state
        return
    with pytest.raises(error, match=match):
        jax_interop.import_reference_state_dict(sd, variables)
    with pytest.raises(error, match=match):
        torch_interop.import_reference_state_dict(sd, model)


def test_relation_head_has_no_reference_format():
    _, _, texp, tmdl, feat_shape = _bridged("small")
    model = FewShotEpisodeModel(dataclasses.replace(texp, relation_head=True), tmdl, feat_shape)
    with pytest.raises(ValueError, match="relation_head"):
        torch_interop.export_reference_state_dict(model)
    with pytest.raises(ValueError, match="relation_head"):
        torch_interop.import_reference_state_dict(model.state_dict(), model)


# ---------------------------------------------------------------------------
# models/encoders.py::ConvEncoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval_folded", "eval_unfolded", "train"])
def test_conv_encoder_matches_jax(mode):
    model, variables, texp, tmdl, (f, t) = _bridged("small")
    encoder = model.backbone.encoder.conv_encoder
    assert isinstance(encoder, ConvEncoder) and [name for name, _ in encoder.named_children()] == ["0", "1", "2", "3"]
    fold, train = mode == "eval_folded", mode == "train"
    for block in encoder:
        block.fold_bn_eval = fold
    encoder.train(train)
    x = np.random.default_rng(5).standard_normal((6, f, t)).astype(np.float32)
    cfg = tmdl.hybrid
    jax_encoder = JaxConvEncoder(cfg.hidden_channels, tuple(cfg.pool_dim), "float32", remat=False,
                                 fold_bn_eval=fold)
    enc_vars = {"params": variables["params"]["backbone"]["ConvEncoder_0"],
                "batch_stats": variables["batch_stats"]["backbone"]["ConvEncoder_0"]}
    if train:
        want, _ = jax_encoder.apply(enc_vars, jnp.asarray(x)[..., None], True, mutable=["batch_stats"])
    else:
        want = jax_encoder.apply(enc_vars, jnp.asarray(x)[..., None], False)
    try:
        with torch.no_grad():
            got = encoder(torch.from_numpy(x)[:, None])
    finally:
        encoder.eval()
        for block in encoder:
            block.fold_bn_eval = texp.tpu.fold_bn_eval
    if train:  # the running statistics moved; put the bridged ones back for the other tests
        model.load_state_dict(_bridged_state(variables))
    assert got.shape == (6, cfg.hidden_channels, *np.asarray(want).shape[1:3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=FEAT_ATOL, rtol=0)


def _bridged_state(variables):
    from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

    return from_jax_variables(variables)


# ---------------------------------------------------------------------------
# data/native_pack.py::pack_files
# ---------------------------------------------------------------------------


def _tree(tmp_path, rng, row):
    """Seeded .npy files of float32 / float64, 2-D and 3-D, each at most a
    row of ``row`` elements."""
    paths = []
    for i in range(12):
        shape = (int(rng.integers(1, 3)), 4, int(rng.integers(2, 6))) if i % 3 == 0 else (4, int(rng.integers(3, 10)))
        x = rng.standard_normal(shape) * 3 + 1
        assert x.size <= row
        paths.append(tmp_path / f"{i:02d}.npy")
        np.save(paths[-1], x.astype(np.float64 if i % 4 == 1 else np.float32))
    return paths


def test_pack_files_matches_jax(tmp_path, jax_native_packer):
    rng = np.random.default_rng(7)
    paths = _tree(tmp_path, rng, 40)
    got, want = np.zeros((len(paths), 4, 10), np.float32), np.zeros((len(paths), 4, 10), np.float32)
    assert jax_native_packer.pack_files([str(p) for p in paths], want, 0.7, 2.3, threads=3)
    assert native_pack.pack_files(paths, got, 0.7, 2.3, threads=3) is True
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[:, -1, -1] == 0).any()  # rows shorter than the stride keep their padding


@pytest.mark.parametrize("case", ["float64_out", "row_too_small", "not_npy"])
def test_pack_files_raises_where_jax_falls_back(tmp_path, case, jax_native_packer):
    paths = _tree(tmp_path, np.random.default_rng(8), 40)
    out = np.zeros((len(paths), 40), np.float64 if case == "float64_out" else np.float32)
    if case == "row_too_small":
        out = np.zeros((len(paths), 8), np.float32)
    if case == "not_npy":
        paths[3].write_bytes(b"not a numpy file")
    assert jax_native_packer.pack_files([str(p) for p in paths], out, 0.0, 1.0) is False
    with pytest.raises((ValueError, RuntimeError)):
        native_pack.pack_files(paths, out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# data/episodes.py::sample_wav_episode
# ---------------------------------------------------------------------------

N_CLASSES, PER_CLASS, N_WAY, K_SHOT, K_QUERY, EPISODES = 8, 6, 4, 2, 2, 300


def _id_items():
    """Item i holds 3 one-second segments at 4 Hz; segment s is all 10*i + s,
    so a sampled row names its item and segment."""
    labels = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    return [np.repeat(10.0 * i + np.arange(3), 4).astype(np.float32) for i in range(len(labels))], labels


def _classes_and_segments(rows, labels):
    values = np.asarray(rows)[..., 0].round().astype(int).ravel()
    return (np.bincount(labels[values // 10], minlength=N_CLASSES), np.bincount(values % 10, minlength=3))


def test_sample_wav_episode_matches_jax_by_distribution():
    items, labels = _id_items()
    kw = dict(multi_segm=True, segment_seconds=1, sr=4)
    store = PackedWavStore.pack(items, labels, device="cpu", **kw)
    jax_store = JaxWavStore.pack(items, labels, **kw)
    got = sample_wav_episode(torch.Generator().manual_seed(0), store, N_WAY, K_SHOT, K_QUERY, False, EPISODES)
    keys = jax.random.split(jax.random.PRNGKey(0), EPISODES)
    want = jax.jit(jax.vmap(lambda k: jax_episodes.sample_wav_episode(k, jax_store, N_WAY, K_SHOT, K_QUERY,
                                                                     False)))(keys)
    assert got.support.shape == (EPISODES, *np.asarray(want.support).shape[1:])
    assert got.query.shape == (EPISODES, *np.asarray(want.query).shape[1:])
    for rows_got, rows_want in ((got.support, want.support), (got.query, want.query)):
        for counts_got, counts_want in zip(_classes_and_segments(rows_got, labels),
                                           _classes_and_segments(rows_want, labels)):
            assert scipy.stats.chisquare(counts_got).pvalue > CHI2_P, counts_got
            assert scipy.stats.chi2_contingency([counts_got, counts_want]).pvalue > CHI2_P, (counts_got,
                                                                                            counts_want)
    # a test episode of the multi-segment store: every segment of each query item
    test = sample_wav_episode(torch.Generator().manual_seed(1), store, N_WAY, K_SHOT, K_QUERY, True)
    jtest = jax_episodes.sample_wav_episode(jax.random.PRNGKey(1), jax_store, N_WAY, K_SHOT, K_QUERY, True)
    assert test.query.shape[1:] == np.asarray(jtest.query).shape
    np.testing.assert_array_equal(test.audio_ids[0].numpy(), np.asarray(jtest.audio_ids))
    np.testing.assert_array_equal(test.query_mask[0].numpy(), np.asarray(jtest.query_mask))


@pytest.mark.parametrize("is_test", [False, True])
def test_sample_wav_episode_on_a_host_store_is_the_jax_host_sampler(is_test):
    items, labels = _id_items()
    kw = dict(multi_segm=True, segment_seconds=1, sr=4)
    got = sample_wav_episode(np.random.default_rng(3), WavHostStore.pack(items, labels, **kw), N_WAY, K_SHOT,
                             K_QUERY, is_test, 4)
    want = JaxWavHostStore.pack(items, labels, **kw).sample_episode_batch(np.random.default_rng(3), N_WAY, K_SHOT,
                                                                         K_QUERY, is_test, 4)
    for name in ("support", "support_labels", "query", "query_labels", "audio_ids", "query_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)


def test_sample_wav_episode_refuses_a_spec_store():
    store = PackedStore.pack([np.zeros((4, 5), np.float32)] * 6, [0, 0, 1, 1, 2, 2], device="cpu")
    with pytest.raises(TypeError, match="PackedWavStore"):
        sample_wav_episode(torch.Generator(), store, 2, 1, 1, False)
