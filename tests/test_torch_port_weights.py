"""PyTorch port: the weight bridge ``weights.from_jax_variables`` against the
JAX package's ``export_reference_state_dict``, key by key and value by
value, and a ``strict=True`` load into the port's model."""

import numpy as np
import pytest
import torch

from _torch_port_helpers import configs, jax_variables
from audio_few_shot_learning_tpu.train.torch_interop import (
    build_mapping as jax_build_mapping,
    export_reference_state_dict,
)
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.train.weights import build_mapping, from_jax_variables

CASES = [("small", True), ("fprime", True), ("gru_bi", True), ("small", False)]


@pytest.mark.parametrize("geometry,use_attention", CASES)
def test_bridge_matches_export_reference_state_dict(geometry, use_attention):
    jexp, jmdl, texp, tmdl, feat_shape = configs(geometry, use_attention)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=11)
    want = export_reference_state_dict(variables)
    got = from_jax_variables(variables)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == tuple(np.shape(value)), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)

    model = FewShotEpisodeModel(texp, tmdl, feat_shape)
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)
    # the reference-format dict (numpy arrays made tensors) loads the same way
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}, strict=True)
    torch.testing.assert_close(
        model.state_dict()["backbone.encoder.conv_encoder.0.0.weight"],
        got["backbone.encoder.conv_encoder.0.0.weight"],
    )


@pytest.mark.parametrize("geometry,use_attention", CASES)
def test_mapping_copy_equals_jax_mapping(geometry, use_attention):
    """The port keeps its own copy of the leaf mapping; it must not drift."""
    jexp, jmdl, _, _, feat_shape = configs(geometry, use_attention)
    _, variables = jax_variables(jexp, jmdl, feat_shape)
    assert build_mapping(variables) == jax_build_mapping(variables)


def test_strict_load_rejects_a_mismatched_model():
    jexp, jmdl, _, _, feat_shape = configs("small")
    _, variables = jax_variables(jexp, jmdl, feat_shape)
    _, _, texp, tmdl, _ = configs("small", use_attention=False)
    model = FewShotEpisodeModel(texp, tmdl, feat_shape)
    with pytest.raises(RuntimeError):
        model.load_state_dict(from_jax_variables(variables), strict=True)
