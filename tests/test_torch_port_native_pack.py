"""PyTorch port: the native packer (``csrc/npy_pack.cc``,
``data/native_pack.py``) against the JAX package's and the numpy path.

Every comparison is exact: the port's build of its copy of the C++ source
writes the bytes the JAX package's build writes, for 2-D and 3-D files in
float32 and float64, packed to float32 and to bfloat16 (the bits against
ml_dtypes' rounding, special values included), and the port's numpy path
(``native_pack.normalize``, for irregular files) computes the same float32
values. A dataset whose files the packer does not take goes to the numpy
path; a missing compiler or a failed build raises. The JAX package's packer
is built into a directory of the test process (``jax_native_packer``), so
that no other pytest worker's build of its shared file can send it to its
numpy fallback.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port_helpers import jax_native_packer  # noqa: F401  (a fixture)
from audio_few_shot_learning_tpu.config import ExperimentConfig as JaxExperimentConfig
from audio_few_shot_learning_tpu.data.datasets import MetaAudioDataset as JaxDataset
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data import native_pack
from audio_few_shot_learning_tpu_torch.data.datasets import MetaAudioDataset, make_synthetic_dataset

MEAN, STD = 0.37, 1.9


def _files(tmp_path, shapes, rng):
    paths, arrays = [], []
    for i, shape in enumerate(shapes):
        a = (3 * rng.standard_normal(shape)).astype(np.float64 if i % 3 == 2 else np.float32)
        paths.append(str(tmp_path / f"f{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
    return paths, arrays


@pytest.mark.parametrize("ndim", [2, 3])
def test_probe_matches_jax(tmp_path, ndim, jax_native_packer):
    jax_native = jax_native_packer
    shapes = [(8, 5), (8, 5)] if ndim == 2 else [(3, 8, 5), (1, 8, 5), (2, 8, 5)]
    paths, _ = _files(tmp_path, shapes, np.random.default_rng(0))
    np.save(tmp_path / "w.npy", np.zeros(77))
    paths.append(str(tmp_path / "w.npy"))
    for p in paths:
        assert native_pack.probe(p) == jax_native.probe(p)
    assert native_pack.probe(paths[0]) == ((40, 1) if ndim == 2 else (120, 3))
    np.save(tmp_path / "i.npy", np.zeros((8, 5), np.int32))  # not f4/f8: irregular
    np.save(tmp_path / "h.npy", np.zeros((8, 5), np.float16))
    (tmp_path / "x.npy").write_bytes(b"not an npy")
    for name in ("i", "h", "x", "missing"):
        assert native_pack.probe(tmp_path / f"{name}.npy") is None


def test_probe_files_is_one_native_call(tmp_path, monkeypatch):
    """``probe_files`` gives ``probe``'s answer and the size on disk of every
    file from one native call on the packer's threads, and loading a split
    under ``tpu.host_store: null`` probes it once, for the placement rule's
    size estimate and for the pack: at NSynth's 306 000 files one Python
    ``probe`` call per file, and before it one ``stat`` per file for the
    estimate, were most of the load's time."""
    import os

    from audio_few_shot_learning_tpu_torch.data import datasets

    rng = np.random.default_rng(2)
    shapes = [(8, 5), (3, 8, 5), (1, 8, 5), (8, 5), (77,)]
    paths, _ = _files(tmp_path, shapes, rng)
    np.save(tmp_path / "i.npy", np.zeros((8, 5), np.int32))
    (tmp_path / "x.npy").write_bytes(b"not an npy")
    paths += [str(tmp_path / "i.npy"), str(tmp_path / "x.npy"), str(tmp_path / "missing.npy")]
    want = [(int(np.prod(s)), s[0] if len(s) == 3 else 1) for s in shapes] + [None] * 3
    assert [native_pack.probe(p) for p in paths] == want
    sizes = [os.path.getsize(p) if os.path.exists(p) else -1 for p in paths]
    for threads in (1, 3):
        elems, segs, nbytes = native_pack.probe_files(paths, threads=threads)
        assert elems.dtype == segs.dtype == nbytes.dtype == np.int64
        assert [None if e < 0 else (int(e), int(s)) for e, s in zip(elems, segs)] == want
        assert nbytes.tolist() == sizes
    assert [a.shape for a in native_pack.probe_files([])] == [(0,), (0,), (0,)]

    root = _dataset(tmp_path, multi_segm=True, max_segments=3)
    exp = tcfg.ExperimentConfig.from_dict({"multi_segm": True, "device": "cpu"})
    ds = MetaAudioDataset(exp, root, "train")
    want = ds.to_host_store("float32").segments
    est = sum(os.path.getsize(p) for p in ds.filepaths)
    assert MetaAudioDataset(exp, root, "train").estimated_packed_bytes("float32") == est
    probe_files, calls = native_pack.probe_files, []
    monkeypatch.setattr(native_pack, "probe_files", lambda paths: calls.append(len(paths)) or probe_files(paths))
    monkeypatch.setattr(native_pack, "probe", lambda path: pytest.fail("a per-file probe call"))
    files, stats, stat = set(ds.filepaths), [], type(ds.filepaths[0]).stat
    monkeypatch.setattr(type(ds.filepaths[0]), "stat",
                        lambda self, **kw: (self in files and stats.append(self)) or stat(self, **kw))
    monkeypatch.setattr(datasets, "_device_memory_bytes", lambda device: 10 * est)  # routed by size: the card
    store = datasets.load_packed_split(exp, root, "train", "cpu")
    monkeypatch.undo()
    torch.testing.assert_close(store.segments, want, atol=0, rtol=0)
    assert calls == [len(ds)]
    assert stats == ds.filepaths[:1]  # np.load's mmap of the first file, for the feature shape; no stat per file


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_flat_pack_matches_jax_and_numpy(tmp_path, ndim, dtype, jax_native_packer):
    jax_native = jax_native_packer
    rng = np.random.default_rng(1)
    shapes = [(8, 5)] * 6 if ndim == 2 else [(int(rng.integers(1, 4)), 8, 5) for _ in range(6)]
    paths, arrays = _files(tmp_path, shapes, rng)
    sizes = np.array([a.size for a in arrays], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    got = torch.empty(int(sizes.sum()), dtype=getattr(torch, dtype))
    native_pack.pack_files_flat(paths, got, offsets, MEAN, STD, threads=3)
    want = np.zeros(int(sizes.sum()), np.float32 if dtype == "float32" else ml_dtypes.bfloat16)
    assert jax_native.pack_files_flat(paths, want, offsets, MEAN, STD)
    numpy_path = torch.from_numpy(np.concatenate([native_pack.normalize(a, MEAN, STD).ravel()
                                                  for a in arrays])).to(got.dtype)
    if dtype == "bfloat16":
        got, numpy_path, want = got.view(torch.int16), numpy_path.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(numpy_path.numpy(), want)


def test_bf16_rounding_matches_ml_dtypes(tmp_path):
    """Round to nearest even on mantissa ties, subnormals, +-max, Inf;
    NaN stays NaN (its payload may differ)."""
    bits = np.array([0x3F800080, 0x3F800180, 0x40490FDB, 0x00000001, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x3F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00001, 0x7F800001], dtype=np.uint32).view(np.float32)
    x = np.concatenate([np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 37.5, bits])
    np.save(tmp_path / "x.npy", x.reshape(1, -1))
    out = torch.empty(x.size, dtype=torch.bfloat16)
    native_pack.pack_files_flat([tmp_path / "x.npy"], out, np.array([0, x.size]), 0.0, 1.0)
    nan = np.isnan(x)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(out.view(torch.int16).numpy()[~nan], want[~nan])
    assert torch.isnan(out.float()[torch.from_numpy(nan)]).all()


def _dataset(tmp_path, **kw):
    return make_synthetic_dataset(tmp_path / "ds", n_classes=6, items_per_class=4, n_mels=16, n_frames=12,
                                  split_fractions=(2, 2, 2), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dataset_packs_as_the_jax_package(tmp_path, dtype, jax_native_packer):
    """``to_packed_store`` and ``to_host_store`` through the native packer
    equal the JAX package's native pack of the same multi-segment split."""
    root = _dataset(tmp_path, multi_segm=True, max_segments=3)
    want = JaxDataset(JaxExperimentConfig.from_dict({"multi_segm": True}), root, "train").to_packed_store(dtype=dtype)
    want = np.asarray(want.segments)
    ds = MetaAudioDataset(tcfg.ExperimentConfig.from_dict({"multi_segm": True, "device": "cpu"}), root, "train")
    for store in (ds.to_packed_store(dtype, device="cpu"), ds.to_host_store(dtype)):
        got = store.segments
        if dtype == "bfloat16":
            got, w = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got, w = got.numpy(), want
        np.testing.assert_array_equal(got, w)


def test_irregular_files_take_the_numpy_path(tmp_path, monkeypatch):
    """A file the packer does not take (float16) sends the split to the
    numpy path, which gives the bits the packer gives the same values."""
    root = _dataset(tmp_path)
    ds = MetaAudioDataset(tcfg.ExperimentConfig.from_dict({"device": "cpu"}), root, "valid")
    x = np.load(ds.filepaths[0]).astype(np.float16)
    for p in ds.filepaths:
        np.save(p, np.load(p).astype(np.float16).astype(np.float32))
    native = ds.to_packed_store("bfloat16", device="cpu").segments
    np.save(ds.filepaths[0], x)
    calls = []
    monkeypatch.setattr(native_pack, "pack_files_flat", lambda *a, **k: calls.append(a))
    irregular = ds.to_packed_store("bfloat16", device="cpu").segments
    assert not calls
    torch.testing.assert_close(irregular.view(torch.int16), native.view(torch.int16), atol=0, rtol=0)


def test_missing_compiler_or_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_pack, "_lib", None)
    monkeypatch.setattr(native_pack, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_pack.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native_pack.probe(tmp_path / "a.npy")
    monkeypatch.undo()
    monkeypatch.setattr(native_pack, "_lib", None)
    monkeypatch.setattr(native_pack, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_pack, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g.. failed"):
        native_pack.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))
