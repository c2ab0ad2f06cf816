"""PyTorch port: eval-mode conv blocks 1-3 (``ops/convblock.py``, K5) on the CPU.

The kernel runs only on the card (``tests/test_torch_port_cuda.py``). Here:
its plain version against ``ConvBlock``'s eval output, bit for bit; the
kernel's index arithmetic (runs, slots, the lanes' pixels) replayed in
numpy against the plain version; the routing in ``ConvBlock._block`` (K5's
wrapper for an eval-mode bf16 block of C to C channels on a card tensor,
with the device predicate monkeypatched, and today's code everywhere else);
the counters and the benchmark's reader of them; and the wrapper's
refusals, raised before any launch, also where ``ConvBlock`` routes to it.
About 10 s in one process.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from audio_few_shot_learning_tpu_torch.config import HybridConfig
from audio_few_shot_learning_tpu_torch.models.encoders import ConvBlock, StandardHybrid
from audio_few_shot_learning_tpu_torch.ops import convblock, cuda_build
from audio_few_shot_learning_tpu_torch.utils import profiling

# (maps, channels, H, W, pool): blocks 1-3 of the flagship's 128x157
# (42x52, 14x17, 4x5) and of NSynth's 128x126 (42x42, 14x14, 4x4), the
# helpers' pool 2, an uneven pool, and fewer channels (padded in the kernel)
SHAPES = [(2, 64, 42, 52, (3, 3)), (3, 64, 14, 17, (3, 3)), (4, 64, 4, 5, (3, 3)), (2, 64, 42, 42, (3, 3)),
          (3, 64, 14, 14, (3, 3)), (4, 64, 4, 4, (3, 3)), (3, 16, 24, 30, (2, 2)), (3, 16, 20, 31, (3, 2)),
          (5, 8, 7, 9, (2, 3))]


def _ids(s):
    return "x".join(map(str, s[:4])) + f"-pool{s[4][0]}{s[4][1]}"


def _block(c: int, pool, fold: bool = True, remat: bool = False, seed: int = 0, c_in: int = None) -> ConvBlock:
    """A block of ``c_in`` (default C) to C channels with seeded weights and
    running statistics, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    block = ConvBlock(c if c_in is None else c_in, c, pool, fold, remat)
    with torch.no_grad():
        block[0].weight.copy_(torch.randn(block[0].weight.shape, generator=gen) / (3 * block[0].weight.shape[1] ** 0.5))
        block[0].bias.copy_(torch.randn(c, generator=gen) / 2)
        block[1].weight.copy_(1 + torch.rand(c, generator=gen))
        block[1].bias.copy_(torch.randn(c, generator=gen) / 4)
        block[1].running_mean.copy_(torch.randn(c, generator=gen) / 4)
        block[1].running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return block.eval()


def _folded(block: ConvBlock, dtype):
    inv, shift = block[1].fold()
    weight = (block[0].weight * inv[:, None, None, None]).to(dtype)
    return weight, (block[0].bias * inv + shift).to(dtype)


def _input(b, c, h, w, dtype, seed=1):
    """Block 1-3 input as the kernels leave it: channels-last, non-negative
    (the previous block's ReLU)."""
    x = torch.randn((b, c, h, w), generator=torch.Generator().manual_seed(seed)).abs()
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_version_is_today_s_eval_block_to_the_bit(dtype, shape):
    b, c, h, w, pool = shape
    block = _block(c, pool)
    x = _input(b, c, h, w, dtype)
    with torch.inference_mode():
        got = convblock.blocks_reference(x, *_folded(block, dtype), pool)
        want = block(x)
    assert got.dtype == dtype and got.shape == (b, c, h // pool[0], w // pool[1])
    assert torch.equal(got, want)


def _kernel_replay(x: np.ndarray, weight: np.ndarray, bias: np.ndarray, pool) -> np.ndarray:
    """K5's arithmetic with its index arithmetic, in numpy float64: the plan's
    tiles, each tile's slots filled as ``load_tile`` fills them (map and
    input row of each slot, the columns from ``col_lo``, zeros outside the
    map), and every pooled pixel computed from the slot rows and columns its
    lanes address (``srow + dy + ty``, ``scol + dx + tx``), max over the
    window, bias, ReLU. Returns NHWC ``[B, Hp, Wp, C]``."""
    b, c, h, w = x.shape
    ph, pw = pool
    hp, wp = h // ph, w // pw
    plan = convblock.blocks_plan(b, h, w, ph, pw)
    rows_map = ph * hp + 2
    out = np.full((b, hp, wp, c), np.nan)
    taps = weight.reshape(c, c, 9)  # [n, ci, tap]
    for t in range(plan.tiles):
        g = convblock.tile_geometry(t, plan, hp, wp, ph, pw, b * hp * wp)
        assert g["width"] <= g["pitch"] and g["slots"] * g["pitch"] * convblock.BLOCKS_PIXEL_BYTES <= plan.stage_bytes
        buf = np.zeros((g["slots"], g["width"], c))
        for s in range(g["slots"]):
            if s < g["rows0"]:
                m, row = g["m0"], ph * g["lo0"] - 1 + s
            else:
                k, r = divmod(s - g["rows0"], rows_map)
                m, row = g["m0"] + 1 + k, r - 1
            for sc in range(g["width"]):
                col = pw * g["col_lo"] + sc - 1
                if 0 <= row < h and 0 <= col < w:
                    buf[s, sc] = x[m, :, row, col]
        for r in range(g["n"]):
            m, py, px = convblock.tile_pixel(g, r, hp, wp)
            srow = ph * (py - g["lo0"]) if m == g["m0"] else g["rows0"] + (m - g["m0"] - 1) * rows_map + ph * py
            scol = pw * (px - g["col_lo"])
            best = np.full(c, -np.inf)
            for dy in range(ph):
                for dx in range(pw):
                    acc = np.zeros(c)
                    for tap in range(9):
                        acc += taps[:, :, tap] @ buf[srow + dy + tap // 3, scol + dx + tap % 3]
                    best = np.maximum(best, acc)
            assert np.isnan(out[m, py, px]).all()  # each pooled pixel in exactly one tile
            out[m, py, px] = np.maximum(best + bias, 0)
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("shape", [(3, 8, 42, 52, (3, 3)), (20, 8, 14, 17, (3, 3)), (40, 8, 4, 5, (3, 3)),
                                   (2, 8, 42, 42, (3, 3)), (2, 8, 42, 400, (3, 3)), (3, 8, 20, 31, (3, 2)),
                                   (5, 8, 7, 9, (2, 3))], ids=_ids)
def test_kernel_index_math_replays_the_plain_version(shape):
    """Every tile's slots and every lane's slot row and column, replayed: the
    pooled maps equal the plain version's (float64, to rounding), in each
    way the plan cuts tiles (rectangles with a right strip at 42x52 and
    42x400, rectangles alone at 42x42, runs across maps at 14x17 and 4x5)."""
    b, c, h, w, pool = shape
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((b, c, h, w), generator=gen, dtype=torch.float64)
    weight = torch.randn((c, c, 3, 3), generator=gen, dtype=torch.float64)
    bias = torch.randn(c, generator=gen, dtype=torch.float64)
    got = _kernel_replay(x.numpy(), weight.numpy(), bias.numpy(), pool)
    want = convblock.blocks_reference(x, weight, bias, pool).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@contextlib.contextmanager
def _card(monkeypatch):
    """The device predicate says "on the card" for every tensor, and both
    kernels' wrappers are stand-ins that record their calls and return the
    plain versions' outputs, channels-last as the kernels write them."""
    calls = {"block0": [], "blocks": []}

    def recorder(name, reference):
        def wrapper(x, weight, bias, pool):
            calls[name].append((tuple(x.shape), x.dtype, weight.dtype, bias.dtype, tuple(pool)))
            return reference(x, weight, bias, pool).contiguous(memory_format=torch.channels_last)
        return wrapper

    monkeypatch.setattr(convblock, "on_card", lambda x: True)
    monkeypatch.setattr(convblock, "block0_cuda", recorder("block0", convblock.block0_reference))
    monkeypatch.setattr(convblock, "blocks_cuda", recorder("blocks", convblock.blocks_reference))
    yield calls


def _counts():
    return tuple(profiling.read_counter(n) or 0 for n in (convblock.BLOCKS_FORWARDS, convblock.BLOCKS_KERNEL_FORWARDS))


def test_eval_bf16_block_on_the_card_goes_through_the_wrapper(monkeypatch):
    block = _block(16, (3, 3))
    x = _input(2, 16, 24, 25, torch.bfloat16)
    with torch.inference_mode():
        want = block(x)
        before = _counts()
        with _card(monkeypatch) as calls:
            got = block(x)
    assert calls == {"block0": [], "blocks": [((2, 16, 24, 25), torch.bfloat16, torch.bfloat16, torch.bfloat16,
                                               (3, 3))]}
    assert torch.equal(got, want)
    assert _counts() == (before[0] + 1, before[1] + 1)


def test_blocks_1_to_3_of_the_hybrid_go_through_the_wrapper(monkeypatch):
    """An eval forward of the whole bf16 encoder: block 0 through K4's
    wrapper, blocks 1-3 through K5's, one call each, three forwards that
    launched K5; the output as today's."""
    model = StandardHybrid(HybridConfig(pool_dim=(3, 3), hidden_channels=8, seq_type="RNN"), (96, 99),
                           fold_bn_eval=True).eval()
    x = torch.randn((4, 96, 99), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = model(x)
        before = _counts()
        with _card(monkeypatch) as calls:
            got = model(x)
    assert [c[0] for c in calls["block0"]] == [(4, 1, 96, 99)]
    assert calls["blocks"] == [((4, 8, 32, 33), *[torch.bfloat16] * 3, (3, 3)),
                               ((4, 8, 10, 11), *[torch.bfloat16] * 3, (3, 3)),
                               ((4, 8, 3, 3), *[torch.bfloat16] * 3, (3, 3))]
    assert torch.equal(got, want)
    assert _counts() == (before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("case", ["train", "remat", "float32", "unfolded", "block0"])
def test_other_blocks_and_modes_keep_today_s_code(monkeypatch, case):
    """Train mode (with and without remat), a float32 eval, ``fold_bn_eval:
    false`` and block 0 do not go through K5's wrapper, on the card or not;
    a float32 or unfolded eval-mode block 1-3 on the card counts as a
    forward that did not launch the kernel."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    block = _block(8, (3, 3), fold=case != "unfolded", remat=case == "remat", c_in=1 if case == "block0" else None)
    x = _input(2, 1 if case == "block0" else 8, 6, 25, dtype)
    if case in ("train", "remat"):
        block.train()
    grad = torch.enable_grad() if case in ("train", "remat") else torch.inference_mode()
    with grad:
        want = block(x)
        before = _counts()
        with _card(monkeypatch) as calls:
            got = block(x)
    assert calls["blocks"] == []
    assert len(calls["block0"]) == (case == "block0")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == (before[0] + (case in ("float32", "unfolded")), before[1])


@pytest.mark.parametrize("case,error,match", [
    ("grad", RuntimeError, "no backward"),
    ("channels", ValueError, "a multiple of 8"),
    ("wide", ValueError, "8 to 64 channels"),
    ("pool", ValueError, "pools up to 3x3"),
    ("nchw", ValueError, "channels-last"),
])
def test_eval_bf16_block_on_the_card_raises_what_the_kernel_does_not_take(monkeypatch, case, error, match):
    """A folded eval-mode bf16 block of C to C channels on the card always
    goes to K5's wrapper, which raises, before any launch, on an eval
    forward that autograd records, a channel count the kernel does not take,
    a pool past 3x3 and a map that is not channels-last; none of them falls
    back to today's code, and none counts as a forward."""

    def no_launch(*a, **k):
        raise AssertionError("the kernel was looked up for a launch")

    c = {"channels": 12, "wide": 128}.get(case, 8)
    block = _block(c, (4, 4) if case == "pool" else (3, 3))
    x = _input(2, c, 12, 25, torch.bfloat16)
    if case == "nchw":
        x = x.contiguous()
    monkeypatch.setattr(convblock, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", no_launch)
    before, launches = _counts(), convblock.blocks_cuda.launches
    with torch.enable_grad() if case == "grad" else torch.inference_mode():
        with pytest.raises(error, match=match):
            block(x)
    assert _counts() == before and convblock.blocks_cuda.launches == launches


def test_cpu_tensors_do_not_go_through_the_wrapper(monkeypatch):
    block = _block(8, (3, 3))
    x = _input(2, 8, 24, 25, torch.bfloat16)

    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called on a CPU tensor")

    monkeypatch.setattr(convblock, "blocks_cuda", refuse)
    before = _counts()
    with torch.inference_mode():
        out = block(x)
    assert out.shape == (2, 8, 8, 8)
    assert _counts() == before  # a CPU forward is no forward on the card


def test_share_reader_reads_the_blocks_counters(monkeypatch):
    """``benchmark/layer_metrics/test.blocks123_kernel_share.py``: None before
    any forward on the card (the CPU, or a program without the counters),
    then the share of them that launched the kernel, in %."""
    from benchmark import harness

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    reader = harness.load_module(harness.HERE / "layer_metrics" / "test.blocks123_kernel_share.py",
                                 "t_blocks_share")
    assert reader.read({}) is None
    for kernel in (True, True, False, True, True):
        convblock.count_blocks(kernel)
    assert reader.read({}) == pytest.approx(80.0)
    monkeypatch.delattr(profiling, "read_counter")
    assert reader.read({}) is None


def _bad_inputs():
    x = _input(2, 8, 12, 13, torch.bfloat16)
    w, b = torch.randn((8, 8, 3, 3)).bfloat16(), torch.randn(8).bfloat16()
    x12 = _input(2, 12, 12, 13, torch.bfloat16)
    x72 = _input(2, 72, 12, 13, torch.bfloat16)
    return {
        "a 3-d input": ((x[0], w, b, (3, 3)), ValueError),
        "other output channels": ((x, torch.randn((16, 8, 3, 3)).bfloat16(), torch.randn(16).bfloat16(), (3, 3)),
                                  ValueError),
        "a 5x5 kernel": ((x, torch.randn((8, 8, 5, 5)).bfloat16(), b, (3, 3)), ValueError),
        "bias of other channels": ((x, w, torch.randn(7).bfloat16(), (3, 3)), ValueError),
        "12 channels": ((x12, torch.randn((12, 12, 3, 3)).bfloat16(), torch.randn(12).bfloat16(), (3, 3)),
                        ValueError),
        "72 channels": ((x72, torch.randn((72, 72, 3, 3)).bfloat16(), torch.randn(72).bfloat16(), (3, 3)),
                        ValueError),
        "a pool taller than the map": ((x[:, :, :2], w, b, (3, 3)), ValueError),
        "a pool past 3x3": ((x, w, b, (4, 2)), ValueError),
        "float32": ((x.float(), w.float(), b.float(), (3, 3)), TypeError),
        "float16": ((x.half(), w.half(), b.half(), (3, 3)), TypeError),
        "weight of another dtype": ((x, w.float(), b, (3, 3)), TypeError),
        "a contiguous (NCHW) input": ((x.contiguous(), w, b, (3, 3)), ValueError),
        "a non-contiguous weight": ((x, w.transpose(2, 3).contiguous().transpose(2, 3), b, (3, 3)), ValueError),
        "CPU tensors": ((x, w, b, (3, 3)), ValueError),
        "a weight that records its gradient": ((x, w.float().requires_grad_().bfloat16(), b, (3, 3)), RuntimeError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses_before_any_launch(monkeypatch, case):
    args, error = _bad_inputs()[case]

    def no_launch(*a, **k):
        raise AssertionError("the kernel was looked up for a launch")

    monkeypatch.setattr(cuda_build, "function", no_launch)
    launches = convblock.blocks_cuda.launches
    with pytest.raises(error):
        convblock.blocks_cuda(*args)
    assert convblock.blocks_cuda.launches == launches


def test_kernel_source_is_built_with_the_others():
    """The first load builds every ``csrc/*.cu`` at once, K5's among them."""
    assert {"convblocks", "block0", "specaugment", "protohead", "mel"} <= set(cuda_build.sources())
