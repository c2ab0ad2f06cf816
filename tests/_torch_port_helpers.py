"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_port_*.py).

Both packages get the same configuration dict, in float32 unless a test asks
for another ``compute_dtype`` (the bf16 tests), the JAX
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
import pytest
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


def exp_dict(use_attention=True, fold_bn_eval=True, compute_dtype="float32", **over):
    d = {
        "encoder_name": "Hybrid",
        "use_attention": use_attention,
        "use_contrastive": True,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
        "specaug_params": SPECAUG,
        "test_query_augmentations": True,
        "tpu": {"compute_dtype": compute_dtype, "fold_bn_eval": fold_bn_eval, "eval_episode_batch": 2},
        "device": "cpu",
    }
    d.update(over)
    return d


def configs(geometry: str, use_attention=True, fold_bn_eval=True, compute_dtype="float32"):
    """(jax exp, jax mdl, port exp, port mdl, feat_shape) from one dict."""
    feat_shape, mdl = GEOMETRIES[geometry]
    if not use_attention:  # the projection then reads encoder features
        out_dim = mdl["Hybrid"].get("out_dim", 64)
        mdl = {**mdl, "Projection": {**mdl["Projection"], "input_dim": out_dim}}
    e = exp_dict(use_attention, fold_bn_eval, compute_dtype)
    return (
        jcfg.ExperimentConfig.from_dict(e),
        jcfg.ModelConfig.from_dict(mdl),
        tcfg.ExperimentConfig.from_dict(e),
        tcfg.ModelConfig.from_dict(mdl),
        feat_shape,
    )


_JAX_PACKER_DIR = []  # one private build directory per test process


@pytest.fixture
def jax_native_packer(tmp_path_factory, monkeypatch):
    """The JAX package's native packer, built into a directory of this test
    process. Its own build writes ``native/build/libafslnpy.so`` in place
    (``g++ -o``, audio_few_shot_learning_tpu/data/native_pack.py:29-39):
    under ``pytest -n`` another worker may be writing that file while this
    one loads it, the load fails, the module remembers the failure and its
    dataset loader falls back to numpy ``(x - mean) / std``, 1 ulp off the
    packer's ``x * (1 / std)``. With this fixture the comparison is always
    native against native."""
    from audio_few_shot_learning_tpu.data import native_pack as jax_native

    if not _JAX_PACKER_DIR:
        _JAX_PACKER_DIR.append(tmp_path_factory.mktemp("jax_native_pack"))
    build = _JAX_PACKER_DIR[0]
    monkeypatch.setattr(jax_native, "_BUILD_DIR", build)
    monkeypatch.setattr(jax_native, "_LIB_PATH", build / "libafslnpy.so")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", False)
    assert jax_native.native_available(), "the JAX package's native packer did not build"
    return jax_native


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
    if jexp.input_type == "spec":  # as the Trainer makes them
        views = 4 if jexp.specaug_params.use else 1
    else:
        views = 1 + jexp.waveaug_params.aug_num if jexp.waveaug_params.use else 1
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


# ---------------------------------------------------------------------------
# WaveAugment: the draws the JAX functions take from their keys, recomputed
# on the same split trees (audio_few_shot_learning_tpu/ops/waveaugment.py)
# ---------------------------------------------------------------------------


def _ju(key, shape, lo, hi):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _japplied(key, b, p):
    return np.asarray(jax.random.uniform(key, (b,)) < p)


def jd_cut(key, b, lo, hi, p):
    """lowpass / highpass: k1 -> cut [B, 1], k2 -> applied."""
    k1, k2 = jax.random.split(key)
    return {"cut": _ju(k1, (b, 1), lo, hi), "applied": _japplied(k2, b, p)}


def jd_bandstop(key, b, lo, hi, frac_lo, frac_hi, p):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"center": _ju(k1, (b, 1), lo, hi), "bw_frac": _ju(k2, (b, 1), frac_lo, frac_hi),
            "applied": _japplied(k3, b, p)}


def jd_gain(key, b, lo, hi, p):
    k1, k2 = jax.random.split(key)
    return {"db": _ju(k1, (b, 1), lo, hi), "applied": _japplied(k2, b, p)}


def jd_inversion(key, b, p):
    return {"applied": _japplied(key, b, p)}


def jd_shift(key, b, lo, hi, p):
    k1, k2 = jax.random.split(key)
    return {"frac": _ju(k1, (b,), lo, hi), "applied": _japplied(k2, b, p)}


def jd_noise(key, b, l, snr_lo, snr_hi, dec_lo, dec_hi, p, spectrum):
    """add_colored_noise (white [B, L]) or the fused group (spectrum normals)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = {"snr": _ju(k1, (b, 1), snr_lo, snr_hi), "decay": _ju(k2, (b, 1), dec_lo, dec_hi),
         "applied": _japplied(k4, b, p)}
    if spectrum:
        d["w"] = np.asarray(jax.random.normal(k3, (b, l // 2 + 1, 2)))
    else:
        d["white"] = np.asarray(jax.random.normal(k3, (b, l)))
    return d


@jax.jit
def _semitone_rate(st):
    return 2.0 ** (st / 12.0)


def jd_pitch(key, b, lo, hi, p, jitted=False):
    """The rate 2^(st/12), computed by jnp as the JAX function computes it:
    eagerly, or under jit (``jitted``) for a JAX call inside ``jax.jit``;
    the two differ by an ulp on ~4% of draws, which moves the resample's
    positions near i ~ 1.6e4 by ~2e-3 samples."""
    k1, k2 = jax.random.split(key)
    st = jax.random.uniform(k1, (b,), minval=lo, maxval=hi)
    rate = _semitone_rate(st) if jitted else 2.0 ** (st / 12.0)
    return {"rate": np.asarray(rate), "applied": _japplied(k2, b, p)}


def jd_stretch(key, b, lo, hi, p):
    k1, k2 = jax.random.split(key)
    return {"ratio": _ju(k1, (b,), lo, hi), "applied": _japplied(k2, b, p)}


def jd_splice(key, b, l, n, max_width, p):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"starts": np.asarray(jax.random.randint(k1, (b, n), 0, max(l - max_width, 1))),
            "widths": np.asarray(jax.random.randint(k2, (b, n), 1, max_width + 1)),
            "applied": _japplied(k3, b, p)}


def jd_timemask(key, b, l, n, fraction, p):
    k1, k2 = jax.random.split(key)
    mask_len = max(int(l * fraction), 1)
    return {"starts": np.asarray(jax.random.randint(k1, (b, n), 0, max(l - mask_len, 1))),
            "applied": _japplied(k2, b, p)}


def jax_chain_draws(raw, dataset_name, key, b, l, jitted=False):
    """The draws of the JAX ``WaveAugment.apply_once`` for ``[b, l]`` rows
    from ``key`` (its 12-way split, ``:523``), keyed as the port's chain;
    ``jitted`` for a chain that runs inside ``jax.jit``."""
    from audio_few_shot_learning_tpu.ops.waveaugment import FEATURE_STATS, _DEFAULT_STATS

    stats = FEATURE_STATS.get(dataset_name, _DEFAULT_STATS)
    c, bw = float(stats["avg_centroid"]), float(stats["avg_bandwidth"])
    adapted = float(raw.get("max_snr_in_db", 25.0)) * (1.0 - float(stats["avg_flatness"]))
    min_snr = float(raw.get("min_snr_in_db", 10.0))
    prob = lambda name, default: float(raw.get(name, default))  # noqa: E731
    ks = jax.random.split(key, 12)
    p_lp, p_noise, p_hp, p_bs = prob("lowpass_p", 0.5), prob("noise_p", 0.5), prob("highpass_p", 0.3), prob("bandstop_p", 0.5)
    fuse_lp = bool(raw.get("fuse_lowpass", False)) and p_lp > 0 and (p_noise > 0 or p_hp > 0 or p_bs > 0)
    fused = fuse_lp or (p_noise > 0) + (p_hp > 0) + (p_bs > 0) >= 2
    bs = (c - bw / 2, c, raw.get("bandstop_min_bandwidth_fraction", 0.5), raw.get("bandstop_max_bandwidth_fraction", 1.0))
    noise = (min_snr, adapted, raw.get("noise_min_f_decay", -2), raw.get("noise_max_f_decay", 2))
    d = {}
    if p_lp > 0:
        d["lowpass"] = jd_cut(ks[0], b, c, c + bw / 2, p_lp)
    if prob("pitchshift_p", 0.5) > 0:
        d["pitchshift"] = jd_pitch(ks[1], b, raw.get("pitchshift_min_transpose_semitones", -4),
                                   raw.get("pitchshift_max_transpose_semitones", 4), prob("pitchshift_p", 0.5),
                                   jitted)
    if prob("shift_p", 0.5) > 0:
        d["shift"] = jd_shift(ks[2], b, raw.get("shift_min_shift", -0.5), raw.get("shift_max_shift", 0.5),
                              prob("shift_p", 0.5))
    if prob("timeinversion_p", 0.0) > 0:
        d["timeinversion"] = jd_inversion(ks[3], b, prob("timeinversion_p", 0.0))
    if prob("gain_p", 0.5) > 0:
        d["gain"] = jd_gain(ks[4], b, raw.get("min_gain_in_db", -6), raw.get("max_gain_in_db", 6), prob("gain_p", 0.5))
    if p_noise > 0:
        d["noise"] = jd_noise(ks[5], b, l, *noise, p_noise, spectrum=fused)
    if p_hp > 0 and (fused or p_noise == 0):
        d["highpass"] = jd_cut(ks[6], b, c - bw / 2, c, p_hp)
    if p_bs > 0 and (fused or (p_noise == 0 and p_hp == 0)):
        d["bandstop"] = jd_bandstop(ks[7], b, *bs, p_bs)
    if prob("spliceout_p", 0.5) > 0:
        d["spliceout"] = jd_splice(ks[8], b, l, int(raw.get("spliceout_num_time_intervals", 8)),
                                   int(raw.get("spliceout_max_width", 400)), prob("spliceout_p", 0.5))
    if prob("timestretch_p", 0.0) > 0:
        d["timestretch"] = jd_stretch(ks[9], b, raw.get("min_stretch_ratio", 0.9),
                                      raw.get("max_stretch_ratio", 1.1), prob("timestretch_p", 0.0))
    if prob("timemasking_p", 0.5) > 0:
        d["timemasking"] = jd_timemask(ks[10], b, l, int(raw.get("timemasking_masks", 5)),
                                       float(raw.get("timemasking_mask_fraction", 0.01)), prob("timemasking_p", 0.5))
    return d


def torch_chain(draws):
    """numpy chain draws -> torch (integer starts and widths as int64)."""
    def conv(a):
        t = torch.from_numpy(np.array(a))
        return t.long() if t.dtype in (torch.int32, torch.int64) else t
    return {name: {k: conv(v) for k, v in d.items()} for name, d in draws.items()}


def jax_episode_chain_draws(raw, dataset_name, key, e, n, b, l, jitted=False):
    """Draws of the JAX engine's chain over E episodes of ``b`` rows: one
    key per episode (``split(key, E)``, engine.py:223-224), each chain over
    its ``n x b`` copy-major rows. Leaves ``[E, n, b, ...]``, as the port's
    ``WaveAugment.draw`` lays them out."""
    per = [jax_chain_draws(raw, dataset_name, k, n * b, l, jitted) for k in jax.random.split(key, e)]
    return {name: {k: np.stack([p[name][k] for p in per]).reshape(e, n, b, *per[0][name][k].shape[1:])
                   for k in per[0][name]} for name in per[0]}


def split_chain(draws, s):
    """Combined-chain draws ``[E, n, S+Q, ...]`` -> (support, queries)."""
    sup = {name: {k: v[:, :, :s] for k, v in d.items()} for name, d in draws.items()}
    qry = {name: {k: v[:, :, s:] for k, v in d.items()} for name, d in draws.items()}
    return sup, qry


def episode_cpu(ep):
    return type(ep)(**{f.name: None if getattr(ep, f.name) is None else getattr(ep, f.name).cpu()
                       for f in dataclasses.fields(ep)})
