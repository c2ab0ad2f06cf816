"""The frozen yardstick against what the program counts and the kernel
table's bounds (``PERF.md``): FLOPs of an E=1 train step and of the eval
forward, K1's and K2's bytes."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, program, roofline

ROOT = Path(harness.__file__).resolve().parents[1]
CONFIG = harness.load_cell("esc50_cpl.train_e1")["config"]
MODEL, FEAT = CONFIG["model"], (128, 157)
TRAIN_E1_FLOPS = 117_401_313_280  # scripts/torch_port_bench.py step_flops, recorded in PERF.md


def test_train_step_flops_is_the_recorded_count():
    assert roofline.train_step_flops(MODEL, FEAT, 4, 25, 25, 5) == TRAIN_E1_FLOPS
    blocks = roofline.conv_block_flops(FEAT, 64, (3, 3))
    assert 200 * sum(blocks) == 40_638_873_600  # the conv stack's forward


def test_train_step_flops_matches_the_program_count():
    """``FlopCounterMode`` over one of the program's E=1 steps on the CPU."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_port_bench
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    counted = torch_port_bench.step_flops()
    assert counted["flops_per_episode"] == roofline.train_step_flops(MODEL, FEAT, 4, 25, 25, 5)


@pytest.mark.parametrize("query_rows", [25, 3 * 5])
def test_eval_forward_flops_matches_the_program_count(query_rows):
    """``FlopCounterMode`` over the program's eval forward (float32, plain
    versions) of one episode of 25 support and ``query_rows`` query rows."""
    from torch.utils.flop_counter import FlopCounterMode

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel

    exp = ExperimentConfig.from_dict({**CONFIG["experiment"], "tpu": {"compute_dtype": "float32"}})
    model = FewShotEpisodeModel(exp, ModelConfig.from_dict(MODEL), FEAT).eval()
    model.load_state_dict(program.weights(CONFIG, 1, "cpu"))
    sup = torch.randn(1, 25, 4, *FEAT)
    qry = torch.randn(1, query_rows, 4, *FEAT)
    labels = torch.arange(5).repeat_interleave(5)[None]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(sup, qry, labels, 5)
    assert counter.get_total_flops() == roofline.eval_forward_flops(MODEL, FEAT, 4, 25, query_rows, 5)


def test_kernel_bounds_match_the_kernel_table():
    """K1 at [1, 25, 128, 157] and [16, 25, 128, 157] f32: 0.00300 and
    0.0481 ms; at [3, 900]: 0.3244 ms; K2 at E=16, Q=25, D=256: 0.000247 ms
    and at E=3, Q=900: 0.00086 ms."""
    ms = lambda *c: 1e3 * roofline.bound_seconds(*c)  # noqa: E731
    assert round(ms(roofline.k1_bytes(1, 25, *FEAT)), 5) == 0.00300
    assert round(ms(roofline.k1_bytes(16, 25, *FEAT)), 4) == 0.0481
    assert round(ms(roofline.k1_bytes(3, 900, *FEAT)), 4) == 0.3244
    assert round(ms(*roofline.k2_cost(16, 25, 25, 256, 5)), 6) == 0.000247
    assert round(ms(*roofline.k2_cost(3, 25, 900, 256, 5)), 5) == 0.00086
