"""PyTorch port: the offline preprocessing chain on the CPU, against the JAX package.

Each module of the port's ``preprocessing/`` against its JAX counterpart on
the same input: ``variable_splits`` and ``normalise`` exactly; the log-mel
writers (``stacked_spec``, ``npy_dir_to_var_spec``, ``npy_dir_to_spec``)
write the same files and shapes, values within 5e-3 dB (the two packages'
``MelSpec`` on noise); their skip rules; ``make_splits`` the same arrays;
the norm files within 1e-6 relative; ``folder_sort`` the same sorted trees
(the port reads the CSVs without pandas) and the same BirdClef prunes;
``full_stack_voxceleb`` end to end, loaded back with ``load_packed_split``.
And without a card and without ``device="cpu"`` the writers raise.
"""

import json
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu import preprocessing as jpre
from audio_few_shot_learning_tpu.ops.mel import MelSpec as JaxMelSpec
from audio_few_shot_learning_tpu.preprocessing import folder_sort as jsort
from audio_few_shot_learning_tpu.preprocessing import full_stack as jfull
from audio_few_shot_learning_tpu.preprocessing import to_spec as jto_spec
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch import preprocessing as tpre
from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split
from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec
from audio_few_shot_learning_tpu_torch.preprocessing import folder_sort as tsort
from audio_few_shot_learning_tpu_torch.preprocessing import full_stack as tfull
from audio_few_shot_learning_tpu_torch.preprocessing import to_spec as tto_spec

SR = 16000
MEL_ATOL_DB = 5e-3  # the two MelSpecs on noise (test_torch_port_mel.py)
NORM_RTOL = 1e-6


def _noise(rng, n, scale=0.3):
    return (scale * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n", [1000, 5 * SR, 2 * 5 * SR, 5 * SR + 1000, 3 * 5 * SR + 7])
def test_variable_splits_match_jax(n):
    x = np.arange(n, dtype=np.float32)
    got, want = tpre.variable_splits(x), jpre.variable_splits(x)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_normalise_matches_jax():
    rng = np.random.default_rng(0)
    for x in (3.0 + 2.0 * rng.standard_normal(4000), np.full(100, 7.0), np.zeros(10)):
        np.testing.assert_array_equal(tpre.normalise(x), jpre.normalise(x))


def test_stacked_spec_matches_jax():
    rng = np.random.default_rng(1)
    x = _noise(rng, 2 * 5 * SR + 3000)
    x[100] = np.nan  # scrubbed before the mel, as the reference does
    got = tpre.stacked_spec(x, MelSpec("offline"), device="cpu")
    want = jpre.stacked_spec(x, JaxMelSpec(flavor="offline", use_pallas=False))
    assert got.shape == want.shape == (3, 128, 157) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MEL_ATOL_DB, rtol=0)


def _npy_tree(root, rng, lengths):
    """``root/<class>/<i>.npy`` waveforms of the given lengths per class."""
    for cls, lens in lengths.items():
        (root / cls).mkdir(parents=True)
        for i, n in enumerate(lens):
            np.save(root / cls / f"{i}.npy", _noise(rng, n) if n else np.zeros(0, np.float32))


def _compare_trees(got_dir, want_dir, atol):
    want_files = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.npy"))
    got_files = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.npy"))
    assert got_files == want_files and want_files
    for rel in want_files:
        a, b = np.load(got_dir / rel), np.load(want_dir / rel)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, rel
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=str(rel))


def test_npy_dir_to_var_spec_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    # 0.3 s (repeated), 5 s, 7 s (tail repeat), 12 s; one empty and one constant file skipped
    _npy_tree(tmp_path / "npy", rng, {"a": [4800, 5 * SR, 7 * SR], "b": [12 * SR, 0]})
    np.save(tmp_path / "npy" / "b" / "flat.npy", np.ones(SR, np.float32))
    logs = []
    n = tpre.npy_dir_to_var_spec(tmp_path / "npy", tmp_path / "port", log_fn=logs.append, device="cpu")
    m = jpre.npy_dir_to_var_spec(tmp_path / "npy", tmp_path / "jax", log_fn=lambda *_: None)
    assert n == m == 4 and len(logs) == 2
    _compare_trees(tmp_path / "port", tmp_path / "jax", MEL_ATOL_DB)
    assert np.load(tmp_path / "port" / "b" / "0.npy").shape == (3, 128, 157)


def test_npy_dir_to_spec_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    # fixed 2-s clips, batched 2 at a time: 3 calls for class a; class b holds
    # a wrong length, a short clip and a NaN clip, all skipped
    _npy_tree(tmp_path / "npy", rng, {"a": [2 * SR] * 5, "b": [2 * SR, 3 * SR, SR // 2]})
    nan = _noise(rng, 2 * SR)
    nan[7] = np.nan
    np.save(tmp_path / "npy" / "b" / "nan.npy", nan)
    kw = dict(sample_length=2, batch_size=2, log_fn=lambda *_: None)
    n = tpre.npy_dir_to_spec(tmp_path / "npy", tmp_path / "port", device="cpu", **kw)
    m = jpre.npy_dir_to_spec(tmp_path / "npy", tmp_path / "jax", **kw)
    assert n == m == 6
    _compare_trees(tmp_path / "port", tmp_path / "jax", MEL_ATOL_DB)
    # any length: each length its own batch
    n = tpre.npy_dir_to_spec(tmp_path / "npy", tmp_path / "port_any", sample_length=None, device="cpu",
                             log_fn=lambda *_: None)
    m = jpre.npy_dir_to_spec(tmp_path / "npy", tmp_path / "jax_any", sample_length=None, log_fn=lambda *_: None)
    assert n == m == 7
    _compare_trees(tmp_path / "port_any", tmp_path / "jax_any", MEL_ATOL_DB)


def test_skip_rules_match_jax():
    rng = np.random.default_rng(4)
    nan = _noise(rng, SR)
    nan[3] = np.nan
    cases = [_noise(rng, SR), np.zeros(2 * SR, np.float32), _noise(rng, SR - 1), nan, _noise(rng, 3 * SR)]
    for length in (None, 1, 3):
        for x in cases:
            got = tto_spec._should_skip(x, "f", length, SR, lambda *_: None)
            assert got == jto_spec._should_skip(x, "f", length, SR, lambda *_: None)


@pytest.mark.parametrize("counts,dataset", [((4, 3, 2), None), (None, "esc"), (None, "birdclef")])
def test_make_splits_match_jax(tmp_path, counts, dataset):
    feat = tmp_path / "features"
    for i in range(9):
        (feat / f"class_{i:02d}").mkdir(parents=True)
    (feat / "stray.npy").write_bytes(b"")  # a file beside the class folders is not a class
    got = tpre.make_splits(feat, tmp_path / "port.npy", counts=counts, dataset=dataset, seed=3)
    want = jpre.make_splits(feat, tmp_path / "jax.npy", counts=counts, dataset=dataset, seed=3)
    for a, b in zip(np.load(tmp_path / "port.npy", allow_pickle=True), np.load(tmp_path / "jax.npy", allow_pickle=True)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tpre.REFERENCE_SPLIT_COUNTS == jpre.REFERENCE_SPLIT_COUNTS


def test_norm_files_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    _npy_tree(tmp_path / "npy", rng, {"a": [SR, 2 * SR], "b": [3000]})
    for c in ("a", "b"):
        (tmp_path / "feat" / c).mkdir(parents=True)
        np.save(tmp_path / "feat" / c / "x.npy", (10 * rng.standard_normal((2, 8, 5)) - 30).astype(np.float32))
    got = tpre.compute_global_norm(tmp_path / "feat", tmp_path / "port" / "glob_norm.npy")
    want = jpre.compute_global_norm(tmp_path / "feat", tmp_path / "jax" / "glob_norm.npy")
    assert got.shape == want.shape == (2, 1, 1)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "glob_norm.npy"), want, rtol=NORM_RTOL, atol=0)
    got = tpre.compute_waveform_norm(tmp_path / "npy", tmp_path / "port" / "waveform_norm.npy")
    want = jpre.compute_waveform_norm(tmp_path / "npy", tmp_path / "jax" / "waveform_norm.npy")
    assert got.shape == (2,)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "waveform_norm.npy"), want, rtol=NORM_RTOL, atol=0)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _raw_datasets(root):
    """Tiny ESC-50, FSDKaggle2018 and NSynth layouts with their metadata;
    one listed file is missing, as in partial downloads."""
    esc = root / "esc"
    (esc / "meta").mkdir(parents=True)
    (esc / "audio").mkdir()
    rows = [("1-1-A.wav", "0", "dog"), ("1-2-A.wav", "0", "rain"), ("2-1-B.wav", "1", "dog"),
            ("missing.wav", "1", "rain")]
    (esc / "meta" / "esc50.csv").write_text(
        "filename,fold,category\n" + "".join(f"{a},{b},{c}\n" for a, b, c in rows))
    for name, *_ in rows[:3]:
        (esc / "audio" / name).write_bytes(name.encode())
    kag = root / "kaggle"
    (kag / "FSDKaggle2018.meta").mkdir(parents=True)
    for split, rows in (("train", [("t1.wav", "Bark"), ("t2.wav", "Cough")]),
                        ("test", [("s1.wav", "Bark"), ("s2.wav", "Hi-Hat")])):
        audio = kag / f"FSDKaggle2018.audio_{split}"
        audio.mkdir()
        for f, _ in rows:
            (audio / f).write_bytes(f.encode())
    (kag / "FSDKaggle2018.meta" / "train_post_competition.csv").write_text(
        "fname,label,manually_verified\nt1.wav,Bark,1\nt2.wav,Cough,0\n")
    (kag / "FSDKaggle2018.meta" / "test_post_competition_scoring_clips.csv").write_text(
        "fname,label,usage\ns1.wav,Bark,Public\ns2.wav,Hi-Hat,Private\n")
    ns = root / "nsynth"
    for sub, keys in (("nsynth-train", ["bass_acoustic_000-024-025", "keyboard_electronic_001-060-100"]),
                      ("nsynth-valid", ["bass_acoustic_000-030-050"])):
        (ns / sub / "audio").mkdir(parents=True)
        meta = {k: {"instrument_str": k.split("-")[0]} for k in keys}
        (ns / sub / "examples.json").write_text(json.dumps(meta))
        for k in keys:
            (ns / sub / "audio" / f"{k}.wav").write_bytes(k.encode())
    return esc, kag, ns


@pytest.mark.parametrize("which", ["esc50", "kaggle18", "nsynth"])
def test_folder_sort_matches_jax(tmp_path, which):
    port = _raw_datasets(tmp_path / "port")
    jax_ = _raw_datasets(tmp_path / "jax")
    i = ("esc50", "kaggle18", "nsynth").index(which)
    got = getattr(tsort, f"sort_{which}")(port[i])
    want = getattr(jsort, f"sort_{which}")(jax_[i])
    assert got.name == want.name
    assert _tree(got) == _tree(want) and _tree(got)
    for rel in _tree(want):
        assert (got / rel).read_bytes() == (want / rel).read_bytes()


def test_prune_birdclef_matches_jax(tmp_path):
    """bird0 loses its one 3-s file (over 2 s) and keeps 3; bird1 has 2 files,
    under the 3 a class needs, and goes; bird2 stays whole."""
    for side in ("port", "jax"):
        for c, (n_files, n_long) in enumerate(((4, 1), (2, 0), (5, 0))):
            d = tmp_path / side / f"bird{c}"
            d.mkdir(parents=True)
            for i in range(n_files):
                np.save(d / f"{i}.npy", np.zeros((3 if i < n_long else 1) * 8, np.float32))
    kw = dict(time_thresh_s=2.0, class_thresh=3, sr=8, log_fn=lambda *_: None)
    got = tsort.prune_birdclef(tmp_path / "port", **kw)
    want = list(jsort.prune_birdclef(tmp_path / "jax", **kw).itertuples(index=False, name=None))
    assert got[0] == want[0] == ("bird0", "0.npy")  # the long file comes first
    assert sorted(got) == sorted(want) == [("bird0", "0.npy"), ("bird1", "0.npy"), ("bird1", "1.npy")]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == sorted(
        [f"bird0/{i}.npy" for i in (1, 2, 3)] + [f"bird2/{i}.npy" for i in range(5)])


def _voxceleb_audio(main, rng):
    for c in range(6):
        d = main / "audio" / f"spk{c}"
        d.mkdir(parents=True)
        for i in range(3):
            n = SR * (1 + (c + i) % 3) + c * 1000  # 1-3 s: one or more 1-s segments
            scipy.io.wavfile.write(d / f"u{i}.wav", SR, (rng.standard_normal(n) * 0.2 * 32767).astype(np.int16))


def test_full_stack_voxceleb_matches_jax_and_loads(tmp_path, monkeypatch):
    """The port's VoxCeleb pipeline end to end on the CPU against the JAX
    package's, at 1-s segments (the pipelines' 5-s segments would take far longer on the
    CPU); the features load as a multi-segment split."""
    for mod in (tfull, jfull):
        monkeypatch.setattr(mod, "npy_dir_to_var_spec",
                            lambda *a, f=mod.npy_dir_to_var_spec, **kw: f(*a, **{**kw, "length_s": 1}))
    _voxceleb_audio(tmp_path / "port", np.random.default_rng(7))
    _voxceleb_audio(tmp_path / "jax", np.random.default_rng(7))
    tfull.full_stack_voxceleb(tmp_path / "port", device="cpu")
    jfull.full_stack_voxceleb(tmp_path / "jax")
    _compare_trees(tmp_path / "port" / "features", tmp_path / "jax" / "features", MEL_ATOL_DB)
    for f in ("norm_stats/glob_norm.npy", "norm_stats/waveform_norm.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f),
                                   rtol=NORM_RTOL, atol=1e-7)
    for a, b in zip(np.load(tmp_path / "port" / "splits.npy", allow_pickle=True),
                    np.load(tmp_path / "jax" / "splits.npy", allow_pickle=True)):
        np.testing.assert_array_equal(a, b)

    exp = tcfg.ExperimentConfig.from_dict({"multi_segm": True, "device": "cpu"})
    stores = {s: load_packed_split(exp, tmp_path / "port", s, "cpu") for s in ("train", "valid", "test")}
    assert sum(st.num_items for st in stores.values()) == 18
    assert stores["train"].feat_shape == (128, 32) and any(st.s_max == 3 for st in stores.values())
    jexp = jcfg.ExperimentConfig.from_dict({"multi_segm": True})
    from audio_few_shot_learning_tpu.data.datasets import load_packed_split as jax_load

    want = jax_load(jexp, tmp_path / "port", "train")
    np.testing.assert_array_equal(stores["train"].seg_counts.numpy(), np.asarray(want.seg_counts))


def test_writers_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _npy_tree(tmp_path / "npy", np.random.default_rng(8), {"a": [SR]})
    for call in (
        lambda: tpre.npy_dir_to_var_spec(tmp_path / "npy", tmp_path / "out"),
        lambda: tpre.npy_dir_to_spec(tmp_path / "npy", tmp_path / "out", sample_length=1),
        lambda: tpre.stacked_spec(np.ones(SR, np.float32), MelSpec("offline")),
        lambda: tfull.full_stack_voxceleb(tmp_path / "vox"),
        lambda: tfull.main(["esc", str(tmp_path / "esc")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "out").exists() and not (tmp_path / "vox").exists()
    assert tpre.npy_dir_to_var_spec(tmp_path / "npy", tmp_path / "out", device="cpu", log_fn=print) == 1


def test_full_stack_cli_arguments(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setitem(tfull._PIPELINES, "birdclef", lambda *a, **kw: seen.update(args=a, kw=kw))
    tfull.main(["birdclef", str(tmp_path), str(tmp_path / "wav"), "--device", "cpu"])
    assert seen == {"args": (str(tmp_path),), "kw": {"device": "cpu", "wav_dir": str(tmp_path / "wav")}}
    with pytest.raises(SystemExit):
        tfull.main(["esc", str(tmp_path), str(tmp_path / "wav")])
    with pytest.raises(SystemExit):
        tfull.main(["imagenet", str(tmp_path)])
    assert not os.listdir(tmp_path)
