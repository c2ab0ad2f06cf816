"""PyTorch port: the serving slice as a whole, on the CPU.

``Trainer.predict_episode`` and one ``evaluate`` batch of the port, with the
augmentation draws fixed, against the JAX model on the same views and
weights (equal argmax, scores within 1e-3); the CLI end to end; the rule
that the port, ``chip_smoke.py`` and the port's drivers
(``scripts/torch_port_*.py``) import nothing of JAX (nor pandas, absent
beside the card);
and the rule that the engine raises instead of running on the CPU unasked.
"""

import ast
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    configs, jax_variables, jax_views, numpy_draws, torch_draws,
)
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.train.engine import Trainer
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "audio_few_shot_learning_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "pandas", "audio_few_shot_learning_tpu"}
SCORE_ATOL = 1e-3
N_WAY, K_SHOT, K_QUERY = 3, 2, 2


def _store(feat_shape, n_classes=5, per_class=6, seed=0):
    rng = np.random.default_rng(seed)
    items = [rng.standard_normal(feat_shape).astype(np.float32) for _ in range(n_classes * per_class)]
    return PackedStore.pack(items, np.repeat(np.arange(n_classes), per_class), device="cpu")


@pytest.fixture(scope="module")
def bridged():
    """JAX model + variables and a CPU port Trainer on the same weights."""
    jexp, jmdl, texp, tmdl, feat_shape = configs("small")
    jmodel, variables = jax_variables(jexp, jmdl, feat_shape, seed=21)
    store = _store(feat_shape)
    trainer = Trainer(texp, tmdl, store, test_store=store)  # config says "device": "cpu"
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, trainer, store, feat_shape


def _jax_scores(jmodel, variables, sup, qry, labels, draws_s, draws_q):
    sup_v, qry_v = jax_views(sup, draws_s), jax_views(qry, draws_q)
    scores = jax.jit(lambda v, s, q, lab: jmodel.apply(v, s, q, lab, N_WAY, train=False).scores)
    return np.asarray(scores(variables, sup_v, qry_v, labels))


def test_predict_episode_matches_jax(bridged):
    jmodel, variables, trainer, _, (f, t) = bridged
    rng = np.random.default_rng(1)
    sup = rng.standard_normal((N_WAY * K_SHOT, f, t)).astype(np.float32)
    qry = rng.standard_normal((N_WAY * K_QUERY, f, t)).astype(np.float32)
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    w = trainer.exp.specaug_params.W
    draws_s = numpy_draws(rng, 1, len(sup), f, t, w)
    draws_q = numpy_draws(rng, 1, len(qry), f, t, w)

    pred, scores = trainer.predict_episode(
        sup, labels, qry, draws=(torch_draws(draws_s), torch_draws(draws_q))
    )
    want = _jax_scores(jmodel, variables, sup[None], qry[None], labels[None], draws_s, draws_q)[0]
    assert scores.shape == (N_WAY * K_QUERY, N_WAY) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(pred, want.argmax(-1))


def test_eval_batch_matches_jax(bridged):
    jmodel, variables, trainer, store, (f, t) = bridged
    e = 2
    ep = sample_episode(torch.Generator().manual_seed(2), store, N_WAY, K_SHOT, K_QUERY, e)
    rng = np.random.default_rng(3)
    w = trainer.exp.specaug_params.W
    draws_s = numpy_draws(rng, e, N_WAY * K_SHOT, f, t, w)
    draws_q = numpy_draws(rng, e, N_WAY * K_QUERY, f, t, w)
    draws = (torch_draws(draws_s), torch_draws(draws_q))

    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, True, trainer.gen, draws).numpy()
        acc = trainer._eval_episodes(ep, N_WAY, True, draws).numpy()
    want = _jax_scores(jmodel, variables, ep.support.numpy(), ep.query.numpy(),
                       ep.support_labels.numpy(), draws_s, draws_q)
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want.argmax(-1))
    want_acc = (want.argmax(-1) == ep.query_labels.numpy()).mean(-1)
    np.testing.assert_allclose(acc, want_acc, atol=1e-6)


def test_test_run_reports_accuracy(bridged, monkeypatch):
    *_, trainer, store, _ = bridged
    monkeypatch.setattr(trainer, "exp", dataclasses.replace(trainer.exp, n_testing_tasks=5))
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0 and result["accuracy_std"] >= 0.0


def test_multi_segment_evaluates_and_waveaugment_is_a_later_slice(bridged):
    """Multi-segment eval runs; a wav config with WaveAugment, once a later
    slice, now builds a Trainer with 1 + aug_num views and evaluates."""
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    *_, trainer, store, _ = bridged
    mean, std = trainer.evaluate(store, 2, N_WAY, K_SHOT, K_QUERY, True, multisegment=True)
    assert 0.0 <= mean <= 1.0 and std >= 0.0
    _, _, texp, tmdl, _ = configs("wav")
    wav_aug = dataclasses.replace(
        texp, input_type="wav", waveaug_params=dataclasses.replace(texp.waveaug_params, use=True)
    )
    rng = np.random.default_rng(5)
    wav_store = PackedWavStore.pack(list((0.3 * rng.standard_normal((12, 16000))).astype(np.float32)),
                                    np.repeat(np.arange(3), 4), mean=19.0, std=5.0, device="cpu")
    wav_trainer = Trainer(wav_aug, tmdl, wav_store)
    assert wav_trainer.waveaug and wav_trainer.v_support == 1 + wav_aug.waveaug_params.aug_num == 4
    mean, _ = wav_trainer.evaluate(wav_store, 1, N_WAY, 1, 1, True)
    assert 0.0 <= mean <= 1.0


def test_trainer_without_cuda_raises(monkeypatch):
    """No device asked for and no card: the engine raises, never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, texp, tmdl, feat_shape = configs("small")
    gpu_exp = dataclasses.replace(texp, device="cuda")
    store = _store(feat_shape, n_classes=3, per_class=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(gpu_exp, tmdl, store)
    assert Trainer(gpu_exp, tmdl, store, device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    drivers = sorted((REPO / "scripts").glob("torch_port_*.py"))
    assert {"torch_port_nsynth_scale.py", "torch_port_wav_scale.py"} <= {p.name for p in drivers}
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + drivers
    assert len(files) > 10
    host_path = {"hoststore.py", "wavhoststore.py", "native_pack.py", "staging.py"}
    assert host_path <= {p.name for p in files if p.parent.name == "data"}
    entry_points = {"utils/msgpack_codec.py", "ops/util_functions.py", "models/classifier_api.py",
                    "utils/profiling.py", "cli/convert_checkpoint.py", "cli/aggregate_results.py",
                    "cli/run_sweep.py", "cli/make_synthetic_dataset.py"}
    assert entry_points <= {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    bad = [
        f"{path.relative_to(REPO)}: {name}"
        for path in files
        for name in _imports(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_predict_cli_end_to_end(bridged, tmp_path):
    from audio_few_shot_learning_tpu_torch.cli import predict

    jmodel, variables, trainer, _, (f, t) = bridged
    rng = np.random.default_rng(4)
    for name in ("bird", "dog", "rain"):
        (tmp_path / "support" / name).mkdir(parents=True)
        for i in range(2):
            np.save(tmp_path / "support" / name / f"{i}.npy", rng.standard_normal((f, t)).astype(np.float32))
    (tmp_path / "q").mkdir()
    np.save(tmp_path / "q" / "a.npy", rng.standard_normal((2, f, t)).astype(np.float32))
    np.save(tmp_path / "q" / "b.npy", rng.standard_normal((f, t)).astype(np.float32))
    torch.save(from_jax_variables(variables), tmp_path / "model.pt")
    from _torch_port_helpers import GEOMETRIES, exp_dict

    (tmp_path / "exp.json").write_text(json.dumps(exp_dict()))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    args = ["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
            "--checkpoint", str(tmp_path / "model.pt"), "--support", str(tmp_path / "support"),
            "--query", str(tmp_path / "q"), "--output", str(tmp_path / "out.json")]
    predict.main(args)
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["classes"] == ["bird", "dog", "rain"] and len(out["predictions"]) == 2
    assert all(p["predicted_class"] in out["classes"] for p in out["predictions"])

    # raw audio into a spec model needs the dataset's normalization
    np.save(tmp_path / "q" / "c.npy", rng.standard_normal(16000).astype(np.float32))
    with pytest.raises(SystemExit, match="norm-stats"):
        predict.main(args)
