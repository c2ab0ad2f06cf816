"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_port_*.py).

Both packages get the same configuration dict, both run in float32, the JAX
model's variables are made once per geometry and handed to the port through
``weights.from_jax_variables`` as numpy arrays, and randomness enters as
numpy data.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.models.protonets import FewShotEpisodeModel as FewShotEpisodeModel_jax
from audio_few_shot_learning_tpu.ops.specaugment import _views_xla
from audio_few_shot_learning_tpu.train.state import create_train_state, make_optimizer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.ops.specaugment import hermite_warp_positions
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

SPECAUG = {"use": True, "mask_param": 16, "W": 6, "num_mask": 1, "mask_value": 0.0, "p": 0.282}

# name -> (feature shape, model config dict). "small" is the flagship's
# structure at narrow widths (F' = 1 after four pool-3 stages); "fprime" has
# F' = 3, T' = 4 (48x64, pool 2), where the (F', C) flatten order matters;
# "gru_bi" is a two-layer bidirectional GRU at the same geometry; "wav" is
# the 128-mel log-mel of a 1-s clip (128x32) with pool 2, as
# tests/test_wav_pipeline.py sizes its model (the flagship's pool 3 x 4 blocks
# would leave no width).
GEOMETRIES = {
    "small": (
        (96, 99),
        {
            "Hybrid": {"pool_dim": [3, 3], "hidden_channels": 8, "seq_type": "RNN"},
            "Attention": {"embed_dim": 64, "num_heads": 1, "ffn_dim": 64},
            "Projection": {"input_dim": 256, "hidden_dim": 32, "output_dim": 64},
        },
    ),
    "fprime": (
        (48, 64),
        {
            "Hybrid": {"pool_dim": [2, 2], "hidden_channels": 8, "seq_type": "RNN", "out_dim": 32},
            "Attention": {"embed_dim": 32, "num_heads": 2, "ffn_dim": 32},
            "Projection": {"input_dim": 128, "hidden_dim": 32, "output_dim": 64},
        },
    ),
    "gru_bi": (
        (48, 64),
        {
            "Hybrid": {"pool_dim": [2, 2], "hidden_channels": 8, "seq_type": "GRU",
                       "seq_layers": 2, "bidirectional": True, "out_dim": 32},
            "Attention": {"embed_dim": 32, "num_heads": 1, "ffn_dim": 32},
            "Projection": {"input_dim": 128, "hidden_dim": 32, "output_dim": 64},
        },
    ),
    "wav": (
        (128, 32),
        {
            "Hybrid": {"pool_dim": [2, 2], "hidden_channels": 16, "seq_type": "RNN", "out_dim": 32},
            "Attention": {"embed_dim": 32, "num_heads": 1, "ffn_dim": 32},
            "Projection": {"input_dim": 128, "hidden_dim": 32, "output_dim": 64},
        },
    ),
}


def exp_dict(use_attention=True, fold_bn_eval=True, **over):
    d = {
        "encoder_name": "Hybrid",
        "use_attention": use_attention,
        "use_contrastive": True,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
        "specaug_params": SPECAUG,
        "test_query_augmentations": True,
        "tpu": {"compute_dtype": "float32", "fold_bn_eval": fold_bn_eval, "eval_episode_batch": 2},
        "device": "cpu",
    }
    d.update(over)
    return d


def configs(geometry: str, use_attention=True, fold_bn_eval=True):
    """(jax exp, jax mdl, port exp, port mdl, feat_shape) from one dict."""
    feat_shape, mdl = GEOMETRIES[geometry]
    if not use_attention:  # the projection then reads encoder features
        out_dim = mdl["Hybrid"].get("out_dim", 64)
        mdl = {**mdl, "Projection": {**mdl["Projection"], "input_dim": out_dim}}
    e = exp_dict(use_attention, fold_bn_eval)
    return (
        jcfg.ExperimentConfig.from_dict(e),
        jcfg.ModelConfig.from_dict(mdl),
        tcfg.ExperimentConfig.from_dict(e),
        tcfg.ModelConfig.from_dict(mdl),
        feat_shape,
    )


def to_numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_variables(jexp, jmdl, feat_shape, seed=0):
    """The JAX model and variables of its structure, filled from numpy.

    ``create_train_state`` is traced for shapes only (``jax.eval_shape``:
    compiling the init costs seconds per geometry); weights are then drawn
    U(+-1/sqrt(fan_in)), biases U(+-0.1), and BatchNorm statistics and
    affines randomized so that eval BN (and its fold) is not the identity."""
    opt = make_optimizer(1e-3, (), 0.5, 1)
    views = 4 if jexp.input_type == "spec" and jexp.specaug_params.use else 1  # as the Trainer makes them
    state = jax.eval_shape(
        lambda k: create_train_state(k, jexp, jmdl, feat_shape, opt, v_support=views, v_query=views)[1],
        jax.random.PRNGKey(seed),
    )
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    tree = {"params": state.params, "batch_stats": state.batch_stats}
    variables = to_numpy_tree(jax.tree_util.tree_map_with_path(fill, tree))
    return FewShotEpisodeModel_jax(exp=jexp, mdl=jmdl), variables


def port_model(texp, tmdl, feat_shape, variables):
    model = FewShotEpisodeModel(texp, tmdl, feat_shape)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


def numpy_draws(rng: np.random.Generator, e: int, b: int, f_len: int, t_len: int, w: int):
    """(ys [E,B,T], tmask [E,T], fmask [E,F]) from numpy: warp control draws
    through the port's Hermite curve, one random interval per mask."""
    warp_p = rng.integers(w, t_len - w, (e, b))
    warp_d = rng.integers(-w, w, (e, b))
    ys = hermite_warp_positions(torch.from_numpy(warp_p), torch.from_numpy(warp_d), t_len).numpy()

    def mask(length):
        m = np.zeros((e, length), bool)
        for i in range(e):
            lo = rng.integers(0, length - 4)
            m[i, lo : lo + int(rng.integers(1, 5))] = True
        return m

    return ys.astype(np.float32), mask(t_len), mask(f_len)


def jax_views(spec, draws, mask_value=0.0):
    """JAX views [E, B, 4, F, T] of numpy spec [E, B, F, T] from numpy draws."""
    ys, tm, fm = draws
    return np.asarray(
        jax.vmap(lambda s, y, t, f: _views_xla(s, y, t, f, mask_value))(
            jnp.asarray(spec), jnp.asarray(ys), jnp.asarray(tm), jnp.asarray(fm)
        )
    )


def torch_draws(draws):
    return tuple(torch.from_numpy(np.asarray(d)) for d in draws)


def episode_cpu(ep):
    return type(ep)(**{f.name: None if getattr(ep, f.name) is None else getattr(ep, f.name).cpu()
                       for f in dataclasses.fields(ep)})
