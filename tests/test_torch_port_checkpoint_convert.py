"""PyTorch port: the JAX package's model files, read and written without flax.

The port's standard-library msgpack codec (``utils/msgpack_codec.py``)
against ``msgpack`` and flax's own encoding and decoding; the inverse weight
bridge ``to_jax_variables``; ``save_jax_model`` / ``load_jax_model`` against
flax's ``from_bytes`` and the JAX package's ``train/checkpoint.py``; the
converter CLI in both directions and from a reference ``model.pt``; and
``load_model``'s error on a JAX package file. Every leaf is held exactly.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings, strategies as st

from _torch_port_helpers import GEOMETRIES, exp_dict, jax_variables
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.train import checkpoint as jckpt
from audio_few_shot_learning_tpu.train.torch_interop import export_reference_state_dict
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.cli import convert_checkpoint
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.train import checkpoint as tckpt
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables, to_jax_variables
from audio_few_shot_learning_tpu_torch.utils import msgpack_codec
from audio_few_shot_learning_tpu_torch.utils.msgpack_codec import MsgpackError

# name -> (experiment overrides, feature shape, model dict)
TREES = {
    "hybrid_attention": ({}, (96, 99), GEOMETRIES["small"][1]),
    # pool 2 leaves F' x T' = 6 x 6 at 96x99: the head's rows are permuted
    "cnn": ({"encoder_name": "CNN"}, (96, 99),
            {**GEOMETRIES["small"][1], "CNN": {"pool_dim": [2, 2], "hidden_channels": 8, "out_dim": 64}}),
    "relation": ({"relation_head": True}, (96, 99), GEOMETRIES["small"][1]),
    "bn_per_view_group": ({"tpu": {"bn_per_view_group": True}}, (96, 99), GEOMETRIES["small"][1]),
}


def _configs(name):
    over, feat_shape, mdl = TREES[name]
    d = exp_dict(**{k: v for k, v in over.items() if k != "tpu"})
    d["tpu"].update(over.get("tpu", {}))
    return d, mdl, feat_shape


@pytest.fixture(scope="module", params=sorted(TREES))
def tree(request):
    d, mdl, feat_shape = _configs(request.param)
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=5)
    return request.param, d, mdl, feat_shape, variables


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (list(got), list(want))
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif isinstance(want, (np.ndarray, np.generic, jnp.ndarray)):
        assert isinstance(got, np.ndarray) == isinstance(want, (np.ndarray, jnp.ndarray))
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want, (got, want)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_codec_decodes_flax_to_bytes(tree):
    _, _, _, _, variables = tree
    data = serialization.to_bytes(variables)
    got = msgpack_codec.unpackb(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))  # msgpack + flax's decode
    _assert_trees_equal(got, variables)
    assert msgpack_codec.packb(got) == data  # and writes flax's bytes back


def test_save_jax_model_is_read_by_flax_and_the_jax_package(tree, tmp_path):
    name, d, _, _, variables = tree
    sd = from_jax_variables(variables)
    texp = tcfg.ExperimentConfig.from_dict(d)
    path = str(tmp_path / "model.ckpt")
    tckpt.save_jax_model(path, sd, texp)
    tree_out = to_jax_variables(sd, texp)
    _assert_trees_equal(tree_out, variables)
    with open(path, "rb") as f:
        data = f.read()
    _assert_trees_equal(serialization.from_bytes(variables, data), tree_out)
    params, stats = jckpt.load_model(path, variables["params"], variables["batch_stats"])
    _assert_trees_equal({"batch_stats": stats, "params": params}, tree_out)
    back = tckpt.load_jax_model(path)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd), name


def test_from_jax_variables_inverts_to_jax_variables(tree):
    name, d, mdl, feat_shape, variables = tree
    texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
    # the port's own state_dict, with trained-looking BatchNorm counters
    model = FewShotEpisodeModel(texp, tmdl, feat_shape)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    for key, buf in model.named_buffers():
        if key.endswith("num_batches_tracked"):
            buf.fill_(7)
    sd = model.state_dict()
    back = from_jax_variables(to_jax_variables(sd, texp))
    assert set(back) == set(sd)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            assert back[k].item() == 0  # dead state, not in the flax tree
        else:
            assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), (name, k)


def test_to_jax_variables_refuses_stray_and_missing_keys():
    d, mdl, feat_shape = _configs("hybrid_attention")
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=5)
    texp = tcfg.ExperimentConfig.from_dict(d)
    sd = from_jax_variables(variables)
    with pytest.raises(ValueError, match="no slot"):
        to_jax_variables({**sd, "backbone.extra.weight": torch.zeros(2)}, texp)
    missing = {k: v for k, v in sd.items() if k != "projection_head.fc2.bias"}
    with pytest.raises(KeyError, match="projection_head.fc2.bias"):
        to_jax_variables(missing, texp)


# ---------------------------------------------------------------------------
# the converter CLI
# ---------------------------------------------------------------------------


def _write_configs(tmp_path, d, mdl):
    (tmp_path / "exp.json").write_text(json.dumps(d))
    (tmp_path / "mdl.json").write_text(json.dumps(mdl))
    return ["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json")]


def test_cli_round_trip_both_directions(tree, tmp_path):
    name, d, mdl, feat_shape, variables = tree
    cfg = _write_configs(tmp_path, d, mdl) + ["--feat-shape", *map(str, feat_shape)]
    jax_file, port_file, back_file = (str(tmp_path / n) for n in ("jax.ckpt", "port.ckpt", "back.ckpt"))
    jckpt.save_model(jax_file, variables["params"], variables["batch_stats"])

    assert convert_checkpoint.main(cfg + ["--input", jax_file, "--output", port_file]) == "from-jax"
    sd = torch.load(port_file, weights_only=True)
    want = from_jax_variables(variables)
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)

    assert convert_checkpoint.main(cfg + ["--input", port_file, "--output", back_file,
                                          "--direction", "to-jax"]) == "to-jax"
    with open(jax_file, "rb") as f, open(back_file, "rb") as g:
        assert f.read() == g.read(), name  # the JAX package's own bytes
    params, stats = jckpt.load_model(back_file, variables["params"], variables["batch_stats"])
    _assert_trees_equal({"batch_stats": stats, "params": params}, variables)

    with pytest.raises(ValueError, match="read as from-jax"):
        convert_checkpoint.main(cfg + ["--input", jax_file, "--output", back_file, "--direction", "to-jax"])


@pytest.mark.parametrize("name", ["hybrid_attention", "cnn"])
def test_cli_takes_a_reference_model_pt(name, tmp_path):
    d, mdl, feat_shape = _configs(name)
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=6)
    # what the JAX package's converter writes for the reference code
    ref = {k: torch.tensor(v) for k, v in export_reference_state_dict(variables).items()}
    torch.save(ref, tmp_path / "model.pt")
    cfg = _write_configs(tmp_path, d, mdl) + ["--feat-shape", *map(str, feat_shape)]
    out = str(tmp_path / "model.ckpt")
    convert_checkpoint.main(cfg + ["--input", str(tmp_path / "model.pt"), "--output", out])
    params, stats = jckpt.load_model(out, variables["params"], variables["batch_stats"])
    _assert_trees_equal({"batch_stats": stats, "params": params}, variables)
    # another geometry gives the CNN head another width: the strict load refuses it
    if name == "cnn":
        with pytest.raises(RuntimeError, match="size mismatch"):
            convert_checkpoint.main(_write_configs(tmp_path, d, mdl)
                                    + ["--input", str(tmp_path / "model.pt"), "--output", out])


def test_load_model_names_the_converter_for_a_jax_file(tmp_path):
    d, mdl, feat_shape = _configs("hybrid_attention")
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=5)
    path = str(tmp_path / "model.ckpt")
    jckpt.save_model(path, variables["params"], variables["batch_stats"])
    model = FewShotEpisodeModel(tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl), feat_shape)
    with pytest.raises(ValueError, match="JAX package checkpoint.*convert_checkpoint"):
        tckpt.load_model(path, model)
    model.load_state_dict(tckpt.load_jax_model(path), strict=True)
    tckpt.save_model(str(tmp_path / "port.ckpt"), model)  # a torch.save zip still loads
    assert not tckpt.is_jax_model_file(str(tmp_path / "port.ckpt"))
    tckpt.load_model(str(tmp_path / "port.ckpt"), model)
    # a legacy (pickle) torch.save file is not taken for msgpack either
    torch.save(model.state_dict(), tmp_path / "legacy.pt", _use_new_zipfile_serialization=False)
    assert not tckpt.is_jax_model_file(str(tmp_path / "legacy.pt"))
    tckpt.load_model(str(tmp_path / "legacy.pt"), model)


# ---------------------------------------------------------------------------
# ext values, refusals
# ---------------------------------------------------------------------------


def test_bfloat16_and_numpy_scalar_leaves(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {"bf": jnp.asarray(w, jnp.bfloat16), "f32": np.float32(1.25), "i64": np.int64(-7),
            "b": np.bool_(True), "shape0": np.zeros((0, 4), np.float32)}
    data = serialization.to_bytes(tree)
    got = msgpack_codec.unpackb(data)
    assert got["bf"].dtype == torch.bfloat16 and tuple(got["bf"].shape) == (3, 5)
    want_bits = np.asarray(tree["bf"]).view(np.int16)
    np.testing.assert_array_equal(got["bf"].view(torch.int16).numpy(), want_bits)
    assert type(got["f32"]) is np.float32 and got["f32"] == np.float32(1.25)
    assert type(got["i64"]) is np.int64 and got["i64"] == -7
    assert type(got["b"]) is np.bool_ and got["b"]
    assert got["shape0"].shape == (0, 4)
    # read, not written: the port saves float32 arrays only
    for leaf in (got["bf"], got["f32"], got["i64"], got["b"], np.float64(0.5)):
        with pytest.raises(MsgpackError, match="cannot pack"):
            msgpack_codec.packb({"w": leaf})

    # a bf16 JAX model file reads as float32 weights of the same values
    d, mdl, feat_shape = _configs("hybrid_attention")
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=5)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    path = str(tmp_path / "bf16.ckpt")
    jckpt.save_model(path, bf["params"], bf["batch_stats"])
    sd = tckpt.load_jax_model(path)
    want = from_jax_variables(jax.tree.map(lambda a: np.asarray(a, np.float32), bf))
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_codec_refuses_chunked_complex_unknown_and_malformed():
    chunked = serialization._chunk(np.arange(6, dtype=np.float32))
    data = msgpack.packb({"w": chunked}, default=serialization._msgpack_ext_pack, use_bin_type=True)
    assert serialization.msgpack_restore(data)["w"].shape == (6,)  # flax reads it
    with pytest.raises(MsgpackError, match="chunked"):
        msgpack_codec.unpackb(data)
    with pytest.raises(MsgpackError, match="complex"):
        msgpack_codec.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(MsgpackError, match="unknown msgpack ext code 7"):
        msgpack_codec.unpackb(msgpack.packb(msgpack.ExtType(7, b"abc")))
    with pytest.raises(MsgpackError, match="truncated"):
        msgpack_codec.unpackb(msgpack.packb({"a": "long enough string"})[:-3])
    with pytest.raises(MsgpackError, match="follow"):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(MsgpackError, match="0xc1"):
        msgpack_codec.unpackb(b"\xc1")
    with pytest.raises(MsgpackError, match="cannot pack"):
        msgpack_codec.packb({"s": {1, 2}})
    with pytest.raises(MsgpackError, match="does not fit"):
        msgpack_codec.packb(2**64)


# ---------------------------------------------------------------------------
# property: the codec against msgpack itself
# ---------------------------------------------------------------------------

BOUNDARY_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
BOUNDARY_LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

_ints = st.sampled_from(BOUNDARY_INTS) | st.integers(-2**63, 2**64 - 1)
_arrays = st.builds(
    lambda dtype, shape, seed: np.random.default_rng(seed).integers(-50, 50, shape).astype(dtype),
    st.sampled_from(["float32", "float64", "int8", "int32", "int64", "uint16", "bool"]),
    st.lists(st.integers(0, 4), max_size=3).map(tuple),
    st.integers(0, 2**16),
)
_scalars = (
    st.none() | st.booleans() | _ints | st.floats(allow_nan=False)
    | st.text(max_size=40) | st.binary(max_size=40)
    | st.sampled_from(BOUNDARY_LENS).map(lambda n: "a" * n)
    | st.sampled_from(BOUNDARY_LENS).map(lambda n: b"\x01" * n)
    | _arrays
)
_np_scalars = st.sampled_from([np.float32(0.5), np.float64(-2.0), np.int32(7), np.uint8(200), np.bool_(False)])


def _nest(leaves):
    return st.recursive(
        leaves,
        lambda kids: (
            st.lists(kids, max_size=18)
            | st.dictionaries(st.text(max_size=12), kids, max_size=18)
            | st.sampled_from([15, 16, 65536]).map(lambda n: [None] * n)
            | st.sampled_from([15, 16, 65536]).map(lambda n: {str(i): i for i in range(n)})
        ),
        max_leaves=30,
    )


_trees = _nest(_scalars)  # what the codec writes
_read_trees = _nest(_scalars | _np_scalars)  # what it reads: a JAX file may hold numpy scalars


def _flax_pack(obj):
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack, use_bin_type=True, strict_types=True)


def _flax_unpack(data):
    return msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False, strict_map_key=False)


@settings(max_examples=100, deadline=None)
@given(_trees)
def test_codec_matches_msgpack(obj):
    data = msgpack_codec.packb(obj)
    assert data == _flax_pack(obj)
    _assert_trees_equal(msgpack_codec.unpackb(data), _flax_unpack(data))


@settings(max_examples=100, deadline=None)
@given(_read_trees)
def test_codec_reads_msgpack(obj):
    data = _flax_pack(obj)
    _assert_trees_equal(msgpack_codec.unpackb(data), _flax_unpack(data))
