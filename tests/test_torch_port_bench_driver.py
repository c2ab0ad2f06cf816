"""PyTorch port: ``scripts/torch_port_bench.py``, the port's counterpart of the
JAX repo's ``bench.py`` (loaded with ``importlib``), and the set-up's
``entry``, ``make_host_store``, ``make_wav_store(host=True)`` and
``bench_eval``, on the CPU (~40 s in one process).

* The reference loop at a small map (81x84, which the loop's four pool-3
  blocks take to 1x1; ``N_MELS`` / ``N_FRAMES`` monkeypatched on both
  sides) leaves the same parameters, to the bit, as ``bench.py``'s
  ``bench_torch_reference`` after 2 episodes (read off the Adam each one
  builds); it runs under PyTorch's default TF32 flags and leaves the
  caller's as they were.
* ``make_host_store`` and ``make_wav_store(host=True)`` are bit-equal to
  ``bench.py``'s.
* ``step_flops`` of a small model: the conv stack's forward count is the
  closed form sum 2 C_in C_out 9 H W over the blocks and the maps, exactly;
  the step counts between 2x and 3x its forward; the RNN, the attention and
  the projection each count more than 0.
* ``main`` at the small geometry with ``--device cpu``: default mode prints
  one line with ``bench.py``'s headline keys (without the TPU link's) and
  the port's (the device, ``mfu``, the launches); ``--full`` prints the
  headline, then the matrix with ``bench.py``'s keys. Every device figure
  and share is None. With no card and no ``--device cpu`` it raises.
* ``entry``'s scores against the JAX ``entry()``'s, the JAX weights carried
  over by ``from_jax_variables``, on the same seeded inputs, in float32 at
  the small model, and the fused features the scores come from.
"""

import ast
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import _torch_port_bench_setup as setup  # noqa: E402
import __graft_entry__ as graft  # noqa: E402


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port = _load("torch_port_bench", REPO / "scripts" / "torch_port_bench.py")
jax_bench = _load("jax_bench_py", REPO / "bench.py")

SMALL_MAP = (81, 84)  # four pool-3 blocks leave 1x1, as 128x157 does
# __graft_entry__._flagship_configs(small=True)'s model
SMALL_MODEL = {
    "Hybrid": {"pool_dim": [3, 3], "hidden_channels": 8, "seq_type": "RNN"},
    "Attention": {"embed_dim": 64, "num_heads": 1, "ffn_dim": 64, "dropout": 0.1},
    "Projection": {"input_dim": 256, "hidden_dim": 32, "output_dim": 64},
}
ENTRY_RTOL = 1e-4  # of the fused features' scale: float32 convolutions of two libraries, another summation order
SCORE_RTOL = 1e-3  # of the scores' scale: the head's float32 cancellation (test_entry_matches_the_jax_entry)


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _bench_py_keys(function: str, metric: str) -> set:
    """The keys of the dict literal in ``bench.py``'s ``function`` whose
    ``"metric"`` is ``metric``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function]
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys and any(isinstance(v, ast.Constant) and v.value == metric for v in node.values):
                return keys
    raise AssertionError(f"no {metric} dict in bench.py's {function}")


@pytest.fixture
def small_map(monkeypatch):
    for module in (setup, jax_bench):
        monkeypatch.setattr(module, "N_MELS", SMALL_MAP[0])
        monkeypatch.setattr(module, "N_FRAMES", SMALL_MAP[1])
    return monkeypatch


@pytest.fixture
def adam_params(monkeypatch):
    """Every ``torch.optim.Adam`` built meanwhile: its parameters and the
    TF32 flags at the time."""
    seen = []

    class Recording(torch.optim.Adam):
        def __init__(self, params, *args, **kwargs):
            params = list(params)
            seen.append((params, _flags()))
            super().__init__(params, *args, **kwargs)

    monkeypatch.setattr(torch.optim, "Adam", Recording)
    return seen


# ---------------------------------------------------------------------------
# the reference loop
# ---------------------------------------------------------------------------


def test_reference_loop_leaves_bench_pys_parameters(small_map, adam_params):
    want_eps = jax_bench.bench_torch_reference(n_episodes=1)  # one warm-up episode, one timed
    got_eps = port.bench_reference_loop(1, "cpu")
    (want, _), (got, _) = adam_params
    assert want_eps > 0 and got_eps > 0 and len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g.detach(), w.detach()), i


def test_reference_loop_runs_under_the_default_flags_and_restores_them(small_map, adam_params):
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False  # resolve_device's
        port.bench_reference_loop(0, "cpu", warmup=0)
        assert _flags() == (False, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    ((_, inside),) = adam_params
    assert inside == (port.REFERENCE_FLAGS["cudnn.allow_tf32"], port.REFERENCE_FLAGS["cuda.matmul.allow_tf32"])
    assert inside == (True, False)  # PyTorch's defaults


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------


def test_host_store_is_bench_pys(small_map):
    want, got = jax_bench.make_host_store(), setup.make_host_store()
    assert got.is_host_resident and got.segments.dtype == torch.float32
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    for f in ("seg_counts", "seg_offsets", "class_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.num_items, got.n_classes, got.feat_shape) == (want.num_items, want.n_classes, want.feat_shape)


def test_host_wav_store_is_bench_pys():
    want, got = jax_bench.make_wav_store(host=True), setup.make_wav_store("cpu", host=True)
    assert got.is_host_resident and got.dtype == torch.float32
    np.testing.assert_array_equal(got.flat.numpy(), want.flat)
    np.testing.assert_array_equal(got.tails.numpy(), want.tails)
    for name in ("offsets", "lengths", "tail_index", "seg_counts", "class_counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.seg_len, got.s_max, got.nbytes()) == (want.seg_len, want.s_max, want.nbytes())


# ---------------------------------------------------------------------------
# the FLOP count
# ---------------------------------------------------------------------------


def test_step_flops_counts_one_step(small_map):
    small_map.setattr(setup, "MODEL_CONFIG", SMALL_MODEL)
    count = port.step_flops()
    (h, w), c, maps = SMALL_MAP, SMALL_MODEL["Hybrid"]["hidden_channels"], 4 * (25 + 25)
    closed, cin = 0, 1
    for _ in range(4):  # conv3x3 keeps H x W; each block then pools by 3
        closed += 2 * cin * c * 9 * h * w * maps
        h, w, cin = h // 3, w // 3, c
    assert count["conv_stack_forward"] == closed == count["conv_stack_forward_closed_form"]
    assert 2 * count["forward_flops_per_episode"] < count["flops_per_episode"] < 3 * count["forward_flops_per_episode"]
    by = count["by_module"]
    assert set(by) == {"conv_stack", "rnn", "head", "attention", "projection", "losses"}
    assert by["rnn"] > 0 and by["attention"] > 0 and by["projection"] > 0 and by["losses"] >= 0
    assert sum(by.values()) == count["flops_per_episode"]
    assert count["remat"] is False and count["compute_dtype"] == "float32"


# ---------------------------------------------------------------------------
# the driver end to end
# ---------------------------------------------------------------------------


@pytest.fixture
def small(small_map):
    m = small_map
    m.setattr(setup, "MODEL_CONFIG", SMALL_MODEL)
    m.setattr(setup, "TASKS_PER_EPISODE_BATCH", 1)
    m.setattr(setup, "EVAL_WARMUP_TASKS", 1)
    real = setup.make_wav_store
    # 2.6-s clips: 82 log-mel frames, which the four pool-3 blocks take to 1
    m.setattr(setup, "make_wav_store", lambda device="cuda", host=False: real(device, seconds=2.6, host=host))
    for name, value in (("REFERENCE_WARMUP", 0), ("REFERENCE_EPISODES", 1), ("CPU_REFERENCE_EPISODES", 1),
                        ("HEADLINE_REPEATS", 1), ("ROW_REPEATS", 1), ("HEADLINE_EVAL_TASKS", 2),
                        ("EVAL_TASKS", 2), ("MULTISEG_TASKS", 2), ("SMAX36_TASKS", 1)):
        m.setattr(port, name, value)
    return m


HEADLINE_PORT_KEYS = {"device", "launches_per_step", "step_flops"}


def _check_headline(line: dict, with_matrix: bool):
    want = set(json.loads(jax_bench.headline_json(1.0, 1.0, "cpu", {"matrix": {}} if with_matrix else None, 6)))
    assert "link_probe_s" not in want and set(line) == want | HEADLINE_PORT_KEYS
    assert line["metric"] == "train_episodes_per_sec" and line["unit"] == "episodes/s"
    assert line["backend"] == "cpu" and line["device"] == {"name": None, "power_limit_w": None}
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / line["baseline"]["episodes_per_sec"])
    assert line["baseline"]["pinned"] is False and line["baseline"]["flags"] == port.REFERENCE_FLAGS
    assert line["launches_per_step"] == {"0 0 0": 2}  # the plain versions: a warm-up epoch and a timed one


def test_main_default_prints_one_headline_line(small, capsys):
    (out,) = port.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    _check_headline(out, with_matrix=True)
    m = out["matrix"]
    assert set(m) == {"eval_eps", "flops_per_episode_gflop", "mfu", "fraction_of_matmul_roof",
                      "launches_per_eval_batch"}
    assert m["eval_eps"] > 0 and m["flops_per_episode_gflop"] > 0
    assert m["mfu"] is None and m["fraction_of_matmul_roof"] is None
    assert m["launches_per_eval_batch"] == {"0 0 0": 1 + 2}  # the warm-up and two timed runs, one batch each


def test_main_full_prints_the_headline_then_the_matrix(small, capsys):
    head, matrix = port.main(["--full", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines] == [head, matrix]
    _check_headline(head, with_matrix=False)
    assert set(matrix) == _bench_py_keys("main", "bench_matrix") | {"baseline_cpu", "eval_batch", "launches", "device"}
    assert list(matrix["train_eps"]) == ["E1", "E2", "E4", "E8_accum4"]
    assert list(matrix["host_store_train_eps"]) == ["E1", "E8"]
    roof = matrix["roofline"]
    assert set(roof) == {"flops_per_episode", "flops_unit", "achieved_tflops", "device_matmul_roof_tflops",
                         "fraction_of_matmul_roof", "mfu"}
    assert roof["flops_unit"] == "GFLOP (FlopCounterMode, one step, fwd+bwd+update)"
    assert roof["device_matmul_roof_tflops"] is None and roof["fraction_of_matmul_roof"] is None and roof["mfu"] is None
    rates = [*matrix["train_eps"].values(), *matrix["host_store_train_eps"].values(), matrix["eval_eps"],
             matrix["eval_multiseg_eps"], matrix["eval_multiseg_smax36_eps"], matrix["wav_train_eps"],
             matrix["wav_host_store_train_eps"], matrix["baseline_cpu"]["episodes_per_sec"]]
    assert all(r > 0 for r in rates)
    assert set(matrix["launches"]) == {"train_E1", "train_E2", "train_E4", "train_E8_accum4", "host_store_train_E1",
                                       "host_store_train_E8", "eval", "eval_multiseg", "eval_multiseg_smax36",
                                       "wav_train", "wav_host_store_train"}
    assert all(set(v) == {"0 0 0"} for v in matrix["launches"].values())
    assert matrix["eval_batch"]["eval_multiseg_smax36"] == 1


def test_main_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_init_jitted(monkeypatch):
    """``create_train_state`` with the model's init jitted as one program:
    eagerly, flax compiles each of its ~200 ops apart (~15 s). The weights it
    gives are carried over to the port, so the comparison is the same."""
    from audio_few_shot_learning_tpu.train import state

    real = state.create_train_state

    def jitted(key, *args, **kwargs):
        made = {}

        def init(key):
            made["model"], train_state = real(key, *args, **kwargs)
            return train_state

        train_state = jax.jit(init)(key)
        return made["model"], train_state

    monkeypatch.setattr(state, "create_train_state", jitted)


def test_entry_matches_the_jax_entry(small_map, jax_init_jitted):
    """The fused features (what the encoder and the attention give the head)
    within ``ENTRY_RTOL`` of their scale, and the scores within
    ``SCORE_RTOL`` of theirs with equal argmax. The head's float32 distance
    |q|^2 + |p|^2 - 2 q.p cancels: each fused row has |f|^2 = 256 (4 views
    of a 64-wide LayerNorm) against distances of ~0.26 at random weights,
    so float32 alone moves a score by ~3e-4 (the port's float32 head against
    its float64 on the same features), in the JAX package's head as in the
    port's."""
    import inspect

    from audio_few_shot_learning_tpu import config as jcfg
    from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

    jexp, _ = graft._flagship_configs()
    jexp = dataclasses.replace(jexp, tpu=dataclasses.replace(jexp.tpu, compute_dtype="float32"))
    small_map.setattr(graft, "_flagship_configs", lambda: (jexp, jcfg.ModelConfig.from_dict(SMALL_MODEL)))
    small_map.setattr(setup, "MODEL_CONFIG", SMALL_MODEL)
    small_map.setattr(setup, "FLAGSHIP_EXPERIMENT", {**setup.FLAGSHIP_EXPERIMENT, "tpu": {"compute_dtype": "float32"}})
    jfn, (params, batch_stats, jsup, jqry, jlabels) = graft.entry()
    fn, (model, sup, qry, labels) = setup.entry("cpu")
    assert sup.shape == (1, 25, 4, *SMALL_MAP) and qry.shape == sup.shape and tuple(jsup.shape[:3]) == (1, 25, 4)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    variables = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": batch_stats})
    model.load_state_dict(from_jax_variables(variables))
    rng = np.random.default_rng(7)
    s = rng.standard_normal(sup.shape).astype(np.float32)
    q = rng.standard_normal(qry.shape).astype(np.float32)
    jargs = (params, batch_stats, s, q, np.asarray(jlabels))
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(model, torch.from_numpy(s), torch.from_numpy(q), labels).numpy()
    assert got.shape == want.shape == (1, 25, 5)
    np.testing.assert_allclose(got, want, atol=SCORE_RTOL * np.abs(want).max(), rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    jmodel = inspect.getclosurevars(jfn).nonlocals["model"]  # the flax module fn applies
    jouts = jax.jit(lambda p, b, *a: jmodel.apply({"params": p, "batch_stats": b}, *a, 5, train=False,
                                                  with_contrastive=False))(*jargs)
    with torch.inference_mode():
        outs = model(torch.from_numpy(s), torch.from_numpy(q), labels, 5)
    for f in ("support_features", "query_features"):
        w = np.asarray(getattr(jouts, f))
        np.testing.assert_allclose(getattr(outs, f).numpy(), w, atol=ENTRY_RTOL * np.abs(w).max(), rtol=0, err_msg=f)
