"""PyTorch port: the seven anatomy and probe drivers (``scripts/torch_port_
{step_anatomy,backward_anatomy,bn_fold_eval,profile_wav_path,
predict_latency,ab_store_dtype,ab_kernels}.py``) and their shared set-up
``scripts/_torch_port_bench_setup.py``, against the JAX repo's scripts and
``bench.py`` / ``__graft_entry__.py`` (loaded with ``importlib``), on the CPU
(~30 s in one process).

* The set-up: the flagship's experiment, in every field the JAX package's
  ``_flagship_configs`` gives, and ``bench.make_trainer``'s configs (spec and
  wav, E=1 and E=8 in chunks of 4); ``make_store`` bit-equal to
  ``bench.make_store`` at a small size, single and multi-segment.
* ``backward_anatomy``'s ``Stack`` against the JAX ``_Stack`` on the same
  weights, in float32 at a small shape, for every pool form and norm: the
  output within ``STACK_RTOL`` of its scale and every parameter's gradient
  within ``STACK_RTOL`` of that gradient's largest entry (another
  summation order in the convolutions; a conv bias under BatchNorm, whose
  gradient is 0 but for rounding, of its conv weight's); the three pool forms' forwards
  equal to the bit.
* ``bn_fold_eval``: the weights and input are the JAX script's draws
  (read off the JAX ``main`` at its full size, input in bf16 to the bit,
  weights to the bit), and ``stack`` matches the JAX ``_stack`` on them in
  float32 at a small shape, folded and unfolded, within ``STACK_RTOL``; the
  two arms agree within ``STACK_RTOL`` too (the fold is exact arithmetic).
* ``profile_wav_path``'s ``PROB_KEYS`` and variants are the JAX script's.
* ``ab_store_dtype``'s stores are the JAX script's, bit for bit in float32
  and in bf16 (and so ``make_store``'s at full size).
* ``predict_latency``: bf16 inputs give the float32 predictions.
* Each driver end to end with ``--device cpu`` at the helpers' small
  geometry (widths monkeypatched): no device figure is reported (None), the
  plain versions' launches (0 0 0); with no card and no ``--device cpu``
  each raises.
"""

import dataclasses
import importlib.util
import inspect
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port_helpers import GEOMETRIES

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import _torch_port_bench_setup as bench  # noqa: E402

STACK_RTOL = 1e-4  # float32 convolutions of two libraries: another summation order


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # flax's dataclass transform looks its module up
    spec.loader.exec_module(module)
    return module


port = {n: _load(f"torch_port_{n}", REPO / "scripts" / f"torch_port_{n}.py") for n in (
    "step_anatomy", "backward_anatomy", "bn_fold_eval", "profile_wav_path", "predict_latency", "ab_store_dtype",
    "ab_kernels")}
jax_bwd = _load("jax_backward_anatomy", REPO / "scripts" / "backward_anatomy.py")
jax_fold = _load("jax_bn_fold_eval", REPO / "scripts" / "bn_fold_eval.py")
jax_wavpath = _load("jax_profile_wav_path", REPO / "scripts" / "profile_wav_path.py")
jax_store = _load("jax_ab_store_dtype", REPO / "scripts" / "ab_store_dtype.py")
import bench as jax_bench  # noqa: E402  (the JAX repo's bench.py, on the path through the JAX scripts)
import __graft_entry__ as graft  # noqa: E402

CPU = torch.device("cpu")


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("ast", None)  # the port's AST group: the JAX package has no AST encoder
    return json.loads(json.dumps(d))


# ---------------------------------------------------------------------------
# the shared set-up
# ---------------------------------------------------------------------------


def test_flagship_config_is_the_jax_ones():
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig

    jexp, jmdl = graft._flagship_configs()
    assert _fields(ExperimentConfig.from_dict(bench.FLAGSHIP_EXPERIMENT)) == _fields(jexp)
    assert _fields(ModelConfig.from_dict(bench.MODEL_CONFIG)) == _fields(jmdl)


@pytest.mark.parametrize("e,mb,wav", [(1, None, False), (8, 4, False), (1, None, True)], ids=["e1", "e8_4", "wav"])
def test_make_trainer_config_is_bench_pys(monkeypatch, e, mb, wav):
    """``bench.make_trainer``'s config, captured where it builds its
    ``Trainer``, field for field against the port's."""
    import audio_few_shot_learning_tpu.train.engine as jax_engine

    seen = []

    class Capture:
        def __init__(self, exp, mdl, *a, **k):
            seen.append((exp, mdl))

    monkeypatch.setattr(jax_engine, "Trainer", Capture)
    jax_bench.make_trainer(e, microbatch=mb, wav=wav, store=object())
    monkeypatch.undo()
    (jexp, jmdl), = seen
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig

    got, want = _fields(ExperimentConfig.from_dict(bench.trainer_dict(e, mb, wav))), _fields(jexp)
    if wav:  # the port's WaveAugParams keeps the dict it was given; the JAX replace kept the flagship's
        assert got["waveaug_params"].pop("raw") == {"use": True, "aug_num": 3}
        want["waveaug_params"].pop("raw")
    assert got == want


@pytest.mark.parametrize("multiseg", [False, True], ids=["single", "mseg"])
def test_make_store_is_bench_pys(monkeypatch, multiseg):
    for module in (bench, jax_bench):
        monkeypatch.setattr(module, "N_MELS", 16)
        monkeypatch.setattr(module, "N_FRAMES", 12)
    want = jax_bench.make_store(multiseg=multiseg, n_classes=5, per_class=4)
    got = bench.make_store(multiseg=multiseg, n_classes=5, per_class=4, device=CPU)
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    for f in ("labels", "seg_offsets", "seg_counts", "class_counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert (got.s_max, got.n_classes) == (want.s_max, want.n_classes)


# ---------------------------------------------------------------------------
# backward_anatomy: the stack against the JAX _Stack
# ---------------------------------------------------------------------------

POOL_NAMES = {"max_pool2d": "rw", "reshape": "reshape", "strided": "strided"}


@pytest.fixture
def jax_float32_stack(monkeypatch):
    """The JAX ``_Stack`` at 8 channels, its bf16 casts made float32."""
    f32 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    f32.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_bwd, "jnp", f32)
    monkeypatch.setattr(jax_bwd, "CH", 8)
    return jax_bwd._Stack


def _port_stack(pool_impl, norm, variables):
    stack = port["backward_anatomy"].Stack(pool_impl, norm, dtype=torch.float32, channels=8).train()
    p = jax.tree_util.tree_map(np.array, variables["params"])  # writable copies
    with torch.no_grad():
        for i in range(4):
            getattr(stack, f"k{i}").copy_(torch.from_numpy(p[f"k{i}"].transpose(3, 2, 0, 1).copy()))
            getattr(stack, f"b{i}").copy_(torch.from_numpy(p[f"b{i}"]))
            if norm == "bn":
                getattr(stack, f"bn{i}").weight.copy_(torch.from_numpy(p[f"bn{i}"]["scale"]))
                getattr(stack, f"bn{i}").bias.copy_(torch.from_numpy(p[f"bn{i}"]["bias"]))
            else:
                getattr(stack, f"s{i}").copy_(torch.from_numpy(p[f"s{i}"]))
                getattr(stack, f"t{i}").copy_(torch.from_numpy(p[f"t{i}"]))
    return stack


def _port_grad_in_jax_layout(name, grad):
    g = grad.numpy()
    return g.transpose(2, 3, 1, 0) if name.startswith("k") else g


@pytest.mark.parametrize("norm", ["bn", "affine"])
@pytest.mark.parametrize("pool_impl", ["max_pool2d", "reshape", "strided"])
def test_backward_stack_matches_jax(jax_float32_stack, pool_impl, norm):
    x = np.random.default_rng(3).standard_normal((3, 83, 85, 1)).astype(np.float32)  # floor pooling trims
    module = jax_float32_stack(POOL_NAMES[pool_impl], norm)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    params = variables["params"]
    rng = np.random.default_rng(4)  # the affine's and BatchNorm's ones and zeros made generic
    params = jax.tree_util.tree_map(lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                                    if v.ndim == 1 else v, params)
    variables = {**variables, "params": params}

    def loss(p):
        out, _ = module.apply({**variables, "params": p}, jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32)), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    stack = _port_stack(pool_impl, norm, variables)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    out = stack(xt)
    got_grads = torch.autograd.grad(out.sum(), list(stack.parameters()))
    want_nhwc = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), want_nhwc,
                               atol=STACK_RTOL * np.abs(want_nhwc).max(), rtol=0)
    flat = {}
    for name, value in jax.tree_util.tree_flatten_with_path(grads)[0]:
        flat[".".join(k.key for k in name)] = np.asarray(value)
    port_names = [n for n, _ in stack.named_parameters()]
    alias = {"weight": "scale", "bias": "bias"}
    for name, g in zip(port_names, got_grads):
        key = name if "." not in name else f"{name.split('.')[0]}.{alias[name.split('.')[1]]}"
        w = flat[key]
        # BatchNorm's mean subtraction cancels a conv bias: its gradient is 0 but for rounding, held at the
        # scale of its conv weight's gradient
        scale = np.abs(flat["k" + name[1:]] if norm == "bn" and name[0] == "b" and name[1:].isdigit() else w).max()
        np.testing.assert_allclose(_port_grad_in_jax_layout(name, g), w, atol=STACK_RTOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("norm", ["bn", "affine"])
def test_backward_stack_pool_forms_agree_to_the_bit(norm):
    x = torch.randn((3, 1, 83, 85), generator=torch.Generator().manual_seed(2))
    outs = []
    for pool_impl in port["backward_anatomy"].POOLS:
        torch.manual_seed(0)
        outs.append(port["backward_anatomy"].Stack(pool_impl, norm, dtype=torch.float32, channels=8).train()(x))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# ---------------------------------------------------------------------------
# bn_fold_eval: the weights, and the stack against the JAX _stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fold_draws():
    """The JAX script's input and weights, read off its ``main`` where it
    first times the unfolded stack (its closure holds the weights)."""
    seen = {}

    def capture(fn, *args, **kw):
        seen["x"] = args[0]
        seen.update(inspect.getclosurevars(fn.__wrapped__).nonlocals)
        raise KeyboardInterrupt  # stop before the JAX script times anything

    real = jax_fold.timeit
    jax_fold.timeit = capture
    try:
        with pytest.raises(KeyboardInterrupt):
            jax_fold.main()
    finally:
        jax_fold.timeit = real
    return seen


def test_fold_weights_are_the_jax_scripts(jax_fold_draws):
    x, (kernels, biases, invs, shifts) = port["bn_fold_eval"].weights()
    want_x = np.asarray(jax_fold_draws["x"])
    assert want_x.dtype == ml_dtypes.bfloat16 and want_x.shape == (200, 128, 157, 1)
    np.testing.assert_array_equal(x.to(torch.bfloat16).view(torch.int16).numpy().transpose(0, 2, 3, 1),
                                  want_x.view(np.int16))
    for got, want in ((kernels, "kernels"), (biases, "biases"), (invs, "invs"), (shifts, "shifts")):
        assert len(got) == len(jax_fold_draws[want]) == 4
        for g, w in zip(got, jax_fold_draws[want]):
            w = np.asarray(w)
            np.testing.assert_array_equal(g.numpy().transpose(2, 3, 1, 0) if g.dim() == 4 else g.numpy(), w)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_fold_stack_matches_jax(jax_fold_draws, folded):
    x = np.random.default_rng(5).standard_normal((2, 83, 85, 1)).astype(np.float32)
    names = ("kernels", "biases", "invs", "shifts")
    want = np.asarray(jax_fold._stack(jnp.asarray(x), *(jax_fold_draws[n] for n in names), folded))
    params = [[torch.from_numpy(np.array(w)) for w in jax_fold_draws[n]] for n in names]
    params[0] = [k.permute(3, 2, 0, 1).contiguous() for k in params[0]]
    stack = port["bn_fold_eval"].stack
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = stack(xt, *params, folded=folded).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=STACK_RTOL * np.abs(want).max(), rtol=0)
    other = stack(xt, *params, folded=not folded).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, other, atol=STACK_RTOL * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# profile_wav_path, ab_store_dtype, predict_latency
# ---------------------------------------------------------------------------


def test_wav_path_variants_are_the_jax_scripts():
    assert port["profile_wav_path"].PROB_KEYS == jax_wavpath.PROB_KEYS
    keys = jax_wavpath.PROB_KEYS
    want = {"full": {}, "+fuse_lowpass": {"fuse_lowpass": True}}  # the JAX main's variants, in its order
    want.update({f"-{name}": {k: 0.0} for name, k in keys.items()})
    want["chain-off"] = {k: 0.0 for k in keys.values()}
    got = port["profile_wav_path"].variants()
    assert list(got) == list(want) and got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_dtype_stores_are_the_jax_scripts(dtype):
    want = jax_store.make_store(dtype)
    got = bench.make_store(dtype=dtype, device=CPU)
    w = np.asarray(want.segments)
    assert str(got.segments.dtype) == f"torch.{dtype}" and got.segments.shape == w.shape == (35 * 40, 128, 157)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.segments.view(torch.int16).numpy(), w.view(np.int16))
    else:
        np.testing.assert_array_equal(got.segments.numpy(), w)
    for f in ("labels", "seg_counts", "class_counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the drivers end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def small(monkeypatch):
    (f, t), mdl = GEOMETRIES["small"]
    monkeypatch.setattr(bench, "MODEL_CONFIG", mdl)
    monkeypatch.setattr(bench, "N_MELS", f)
    monkeypatch.setattr(bench, "N_FRAMES", t)
    monkeypatch.setattr(bench, "TASKS_PER_EPISODE_BATCH", 2)
    monkeypatch.setattr(port["backward_anatomy"], "CH", 8)
    for name in ("B", "F_BINS", "T_FRAMES"):
        monkeypatch.setattr(port["backward_anatomy"], name, {"B": 3, "F_BINS": 83, "T_FRAMES": 85}[name])
    monkeypatch.setattr(port["bn_fold_eval"], "SHAPE", (3, 83, 85))
    monkeypatch.setattr(port["bn_fold_eval"], "CH", 8)
    monkeypatch.setattr(port["ab_kernels"], "K1_SHAPE", (2, 5, 16, 20))
    return monkeypatch


def test_step_anatomy_runs_on_the_cpu(small, tmp_path):
    out = port["step_anatomy"].main(["--steps", "2", "--profile-steps", "1", "--episode-batches", "1", "--device", "cpu",
                                     "--out", str(tmp_path / "o.json")])
    assert json.loads((tmp_path / "o.json").read_text()) == out and out["card"] is None
    (run,) = out["runs"]
    assert list(run["stages"]) == ["sample", "views", "forward", "backward", "step"]
    for row in run["stages"].values():
        assert row["wall_ms"] > 0 and row["device_ms"] is None and row["busy_share"] is None
    assert run["stages"]["step"]["launches_per_step"] == {"0 0 0": 5 + 2 + 1}  # warm-up, timed, profiled


def test_backward_anatomy_runs_on_the_cpu(small):
    out = port["backward_anatomy"].main(["--iters", "1", "--device", "cpu"])
    assert [(c["pool"], c["norm"]) for c in out["cells"]] == [(p, n) for p in ("max_pool2d", "strided", "reshape")
                                                              for n in ("bn", "affine")]
    assert all(c["fwd_ms"] is None and c["fwd_bwd_ms"] is None for c in out["cells"])
    assert all(c["by_family"] is None for c in out["cells"] if c["pool"] == "max_pool2d")


def test_bn_fold_eval_runs_on_the_cpu(small):
    out = port["bn_fold_eval"].main(["--iters", "1", "--device", "cpu"])
    assert out["unfolded"]["ms"] is None and out["speedup"] is None and out["shape"] == [3, 1, 83, 85]
    assert 0 <= out["max_abs_dev"] <= 0.05 * out["output_max_abs"]  # bf16 rounding of the two arms


def test_profile_wav_path_runs_on_the_cpu(small):
    small.setattr(bench, "MODEL_CONFIG", GEOMETRIES["wav"][1])
    real = bench.make_wav_store
    small.setattr(bench, "make_wav_store", lambda device="cuda": real(device, seconds=1.0))
    out = port["profile_wav_path"].main(["--variants=full,-gain,chain-off", "--repeats", "1", "--profile-steps", "1",
                                         "--device", "cpu"])
    rows = out["variants"]
    assert list(rows) == ["full", "-gain", "chain-off"]
    for r in rows.values():
        assert r["launches_per_step"] == {"0 0 0": 4} and r["device_ms"] is None and np.isfinite(r["loss"])
    assert rows["-gain"]["transform_cost_ms"] == pytest.approx(rows["full"]["ms_per_episode"] - rows["-gain"]["ms_per_episode"])
    assert "chain_device_ms" not in out
    with pytest.raises(ValueError, match="unknown variants"):
        port["profile_wav_path"].main(["--variants=-reverb", "--device", "cpu"])


def test_predict_latency_runs_on_the_cpu_and_bf16_agrees(small):
    out = port["predict_latency"].main(["--calls", "2", "--device", "cpu"])
    assert out["bf16_agree"] == 1.0 and out["bf16_max_abs_score_dev"] < 0.05
    assert out["launches_per_call"] == [0, 0, 0] and out["kernel_build_seconds"] is None and out["cold_seconds"] > 0


def test_ab_store_dtype_runs_on_the_cpu(small):
    out = port["ab_store_dtype"].main(["--e", "1", "--repeats", "1", "--device", "cpu"])
    assert [(r["store_dtype"], r["e"]) for r in out["rows"]] == [("float32", 1), ("bfloat16", 1)]
    f32, bf16 = (r["store_mb"] for r in out["rows"])
    assert f32 == pytest.approx(2 * bf16) and all(r["eps"] > 0 for r in out["rows"])


def test_ab_kernels_runs_on_the_cpu(small):
    out = port["ab_kernels"].main(["--device", "cpu"])
    assert out["specaugment"]["max_abs_err"] == 0 and out["specaugment"]["kernel_ms"] is None
    assert [(r["e"], r["s"], r["q"], r["d"]) for r in out["protohead"]] == [(8, 25, 25, 256), (32, 25, 25, 256)]
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in out["protohead"])
    assert out["kernel_launches"] == [0, 0, 0]


@pytest.mark.parametrize("name", sorted(port))
def test_anatomy_driver_raises_without_a_card(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port[name].main(["--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


DRIVERS = ["ab_vs_reference", "ab_calibrate", "ab_deviations", "step_anatomy", "backward_anatomy", "bn_fold_eval",
           "profile_wav_path", "predict_latency", "ab_store_dtype", "ab_kernels"]


def test_ported_drivers_import_nothing_of_jax_or_bench():
    """The ten drivers and their set-up import no JAX, no JAX package, and
    neither ``bench.py`` nor ``__graft_entry__.py``."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|bench|__graft_entry__|audio_few_shot_learning_tpu)\b",
                         re.MULTILINE)
    files = [REPO / "scripts" / f"torch_port_{n}.py" for n in DRIVERS] + [REPO / "scripts" / "_torch_port_bench_setup.py"]
    assert all(f.exists() for f in files)
    assert {f.name: pattern.findall(f.read_text()) for f in files} == {f.name: [] for f in files}
