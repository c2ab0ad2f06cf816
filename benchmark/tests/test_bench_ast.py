"""The AST cell (``esc50_ast_cpl.train_e1``, kind ``traffic/train_ast.py``) on
the CPU at a tiny size: the run and its check against ``reference/ast.py``,
the planted faults and the controls, ``roofline/ast.py``'s FLOPs against
``FlopCounterMode``, and the AST readers on synthetic records.

    python -m pytest benchmark/tests/test_bench_ast.py -q
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control_ast, harness, program, roofline
from benchmark.roofline import PEAK_BF16_FLOPS
from benchmark.roofline import ast as roofline_ast

CELL = "esc50_ast_cpl.train_e1"
AST_TINY = {"embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_dim": 64, "patch": 16, "fstride": 10, "tstride": 10,
            "out_dim": 8, "ln_eps": 1e-6}
TINY_MODEL = {"AST": AST_TINY, "Attention": {"embed_dim": 8, "ffn_dim": 16},
              "Projection": {"input_dim": 32, "hidden_dim": 16, "output_dim": 32}}
TINY = {"config": {"model": TINY_MODEL, "dataset": {"classes": 6, "items_per_class": 10, "feat_shape": [32, 64]},
                   "experiment": {"tpu": {"compute_dtype": "float32"}}},
        "mix": {"warm_units": 1, "trace_units": 2}}
SEED = 2**31 + 11
NEW = ["ast.tokens_per_episode", "ast.fused_attention_share", "ast.attention_ms_per_episode",
       "ast_attention_roofline.train", "ast_gemm_roofline.train"]
SPANS = ["train.issue_ms", "train.feed_issue_ms", "train.backward_issue_ms", "train.optimizer_issue_ms",
         "train.device_step_ms_p50"]


def run_tiny(trace=False, fault=None):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 0.5, trace, device="cpu", overrides=TINY, fault=fault)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    out = run_tiny(trace)
    record = out.pop("_record")
    line = json.loads(json.dumps(out))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = harness.benchmark_json()
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    names = {m["name"] for m in wanted if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) <= names
    if trace:  # the CPU has no device trace: the program's counters and spans alone
        m = {k: v["value"] for k, v in line["metrics"].items()}
        assert m["ast.tokens_per_episode"] == 200 * 12  # 5 x (5 + 5) x 4 views, 12 tokens
        assert m["ast.fused_attention_share"] == 0.0  # no card: SDPA may run its math
        assert not any(k in m for k in NEW[2:])
        spans = {k: m[k] for k in SPANS}
        assert all(v > 0 for v in spans.values()), spans
        assert m["train.feed_issue_ms"] + m["train.backward_issue_ms"] + m["train.optimizer_issue_ms"] <= m[
            "train.issue_ms"]
    else:
        assert set(line["metrics"]) == names == {"train_episodes_per_s", "setup_s"}
    parts = record["ast_attention_flops_per_episode"] + record["ast_gemm_flops_per_episode"]
    assert record["flops_per_episode"] > parts
    assert record["launches"]["views_kernel"] == [roofline.k1_bytes(1, 25, 32, 64), roofline.k1_bytes(1, 25, 32, 64)]


def test_every_cell_is_rehearsed():
    """Each cell of ``BENCHMARK.json`` is either one of the shared rehearsal
    files' (``conftest.py``) or this file's."""
    from benchmark.tests import conftest, test_bench_rehearsal

    bench = harness.benchmark_json()
    for w in bench["workloads"]:
        kind = harness.load_cell(w["name"], bench)["mix"]["kind"]
        if kind in conftest.REHEARSED_KINDS:
            assert w["name"] in test_bench_rehearsal.CELLS
        else:
            assert conftest.OWN_FILE_KINDS[kind] == "test_bench_ast.py" and w["name"] == CELL, (w["name"], kind)


def _unchanged_state(stage, trainer):
    trainer.optimizer.step = lambda *a, **k: None


def _half_train_batch(stage, trainer):
    """Every other query left out of each step; the losses' means over the rest."""
    inner = trainer._loss_and_metrics

    def half(ep, draws=None):
        idx = torch.arange(0, ep.query.shape[1], 2)
        ep = type(ep)(support=ep.support, support_labels=ep.support_labels, query=ep.query[:, idx],
                      query_labels=ep.query_labels[:, idx])
        ys, tmask, fmask = draws.query
        draws = type(draws)(support=draws.support, query=(ys[:, idx].contiguous(), tmask, fmask),
                            perms=draws.perms, cpl_gumbel=draws.cpl_gumbel[:, idx][..., idx])
        return inner(ep, draws)

    trainer._loss_and_metrics = half


@pytest.mark.parametrize("fault", [_unchanged_state, _half_train_batch])
def test_fault_is_not_correct(fault):
    out = run_tiny(fault=fault)
    assert out["correct"] is False, out["checks"]


def test_sampler_fault_is_not_correct(monkeypatch):
    from audio_few_shot_learning_tpu_torch.data import episodes

    sample_episode = episodes.sample_episode

    def mislabelled(*args, **kwargs):
        ep = sample_episode(*args, **kwargs)
        sup = ep.support.clone()
        sup[:, [0, -1]] = sup[:, [-1, 0]]
        return type(ep)(**{**vars(ep), "support": sup})

    monkeypatch.setattr(episodes, "sample_episode", mislabelled)
    out = run_tiny()
    assert out["correct"] is False and out["checks"]["episode_faults"]["value"] > 0, out["checks"]


def test_controls_fail_a_limit():
    """The float8 reference and the half batch each fail at least one of the
    cell's limits, at this size too."""
    run = harness.Run(CELL, 2**31 + 29, 0.0, False, "cpu", TINY)
    limits = run.limits["limits"]
    for case, numbers in control_ast.controls(run).items():
        assert any(numbers[k] > v for k, v in limits.items()), (case, numbers, limits)


def _step_counts(model_cfg, feat):
    """``FlopCounterMode`` over one of the program's E=1 train steps on the
    CPU in float32, the attention on its math backend (written-out matmuls,
    which the counter counts), and over the encoder's forward and backward
    alone, by op."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.utils.flop_counter import FlopCounterMode

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    cfg = harness.load_cell(CELL)["config"]
    exp = ExperimentConfig.from_dict({**cfg["experiment"], "device": "cpu", "tpu": {"compute_dtype": "float32"}})
    segments = torch.randn(60, *feat)
    store = PackedStore.from_flat_arrays(segments, [1] * 60, torch.arange(6).repeat_interleave(10).numpy(), 6,
                                         device="cpu")
    trainer = Trainer(exp, ModelConfig.from_dict(model_cfg), store, seed=0, device="cpu")
    ep, draws = program.train_feed(trainer, store, torch.Generator().manual_seed(1), 1)
    with sdpa_kernel([SDPBackend.MATH]), FlopCounterMode(display=False) as step:
        trainer.train_step(ep, draws)
    enc = trainer.model.backbone.encoder
    with sdpa_kernel([SDPBackend.MATH]), FlopCounterMode(display=False) as encoder:
        enc(torch.randn(200, *feat)).sum().backward()
    by_op = {str(k): v for k, v in encoder.get_flop_counts()["Global"].items()}
    return step.get_total_flops(), by_op


def test_train_step_flops_match_the_program_count():
    feat = (32, 64)
    model_cfg = {**TINY_MODEL, "Attention": {"embed_dim": 8, "num_heads": 1, "ffn_dim": 16, "dropout": 0.1}}
    total, by_op = _step_counts(model_cfg, feat)
    want = roofline_ast.train_step_flops(model_cfg, feat, 4, 25, 25, 5)
    assert total == want["total"]
    assert by_op["aten.bmm"] == want["attention"]  # q k^T and (softmax) v, forward and backward
    assert by_op.get("aten.mm", 0) + by_op.get("aten.addmm", 0) == want["gemm"]
    assert by_op["aten.convolution"] + by_op.get("aten.convolution_backward", 0) == 2 * 200 * roofline_ast.\
        encoder_forward_flops(model_cfg, feat)["patch"]


def test_published_step_is_the_reckoned_count():
    """At the cell's size: 602 tokens a map, 200 maps a step."""
    cfg = harness.load_cell(CELL)["config"]
    assert roofline_ast.tokens(cfg["model"], (128, 512)) == 602
    fwd = roofline_ast.encoder_forward_flops(cfg["model"], (128, 512))
    assert 200 * 602 * 192.0e6 < 200 * sum(fwd.values()) < 200 * 602 * 193.0e6  # ~192.1 MFLOP a token
    step = roofline_ast.train_step_flops(cfg["model"], (128, 512), 4, 25, 25, 5)
    assert 68e12 < step["total"] < 70e12 and step["gemm"] + step["attention"] > 0.99 * step["total"]


def _record(kernels, units=2, episodes=1):
    return {"trace": {"kernels": kernels, "units": units}, "episodes_per_unit": episodes,
            "ast_attention_flops_per_episode": 1.0e12, "ast_gemm_flops_per_episode": 4.0e12,
            "peak_flops": PEAK_BF16_FLOPS}


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_trace_readers_on_a_synthetic_record():
    kernels = {
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64, 4>>": 0.002,
        "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<Flash_bwd_kernel_traits>": 0.004,
        "void cudnn::fusion::compute_dot_do_o_specialized<true, 64>(void const*, void const*)": 0.001,
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopA_TNT": 0.006,
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_cublas": 0.004,
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw": 0.5,  # the patch embedding
        "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>": 0.5,
    }
    r = _record(kernels)
    assert reader("ast.attention_ms_per_episode").read(r) == pytest.approx(1e3 * 0.007 / 2)
    assert reader("ast_attention_roofline.train").read(r) == pytest.approx(
        100 * 2 * 1.0e12 / PEAK_BF16_FLOPS / 0.007)
    assert reader("ast_gemm_roofline.train").read(r) == pytest.approx(100 * 2 * 4.0e12 / PEAK_BF16_FLOPS / 0.010)


@pytest.mark.parametrize("name", NEW[2:])
def test_trace_readers_read_none_without_their_kernels(name):
    assert reader(name).read(_record({"void at::native::vectorized_elementwise_kernel<4>": 0.5})) is None
    assert reader(name).read({**_record({}), "trace": None}) is None


@pytest.mark.parametrize("name", NEW[:2])
def test_counter_readers_read_none_without_their_counters(monkeypatch, name):
    from audio_few_shot_learning_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    assert reader(name).read(_record({})) is None
    profiling.set_counter("encoder.tokens", 2 * 120_400)
    profiling.set_counter("encoder.attention_calls", 24)
    profiling.set_counter("encoder.fused_attention_calls", 24)
    assert reader(name).read(_record({}, episodes=2)) == {"ast.tokens_per_episode": 120_400,
                                                          "ast.fused_attention_share": 100.0}[name]
    monkeypatch.delattr(profiling, "read_counter")  # an earlier program: no recorder
    assert reader(name).read(_record({})) is None
