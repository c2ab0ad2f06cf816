"""PyTorch port: eval-mode block 0 (``ops/convblock.py``, K4) on the CPU.

The kernel runs only on the card (``tests/test_torch_port_cuda.py``). Here:
its plain version against ``ConvBlock``'s eval output, bit for bit; the
routing in ``ConvBlock._block`` (the kernel's wrapper for an eval-mode
block 0 on a card tensor, with the device predicate monkeypatched, and
today's code everywhere else); the block-0 counters and the benchmark's
reader of them; and the wrapper's refusals, raised before any launch, also
where ``ConvBlock`` routes to it.
About 5 s in one process.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from audio_few_shot_learning_tpu_torch.config import HybridConfig
from audio_few_shot_learning_tpu_torch.models.encoders import ConvBlock, StandardHybrid
from audio_few_shot_learning_tpu_torch.ops import convblock, cuda_build
from audio_few_shot_learning_tpu_torch.utils import profiling

# (maps, H, W, channels, pool): the flagship's 128x157 and NSynth's 128x126
# at pool 3 and 64 channels, H and W not multiples of the pool, a map the
# size of the pool, the test helpers' pool 2, a pool the kernel does not
# unroll, and the kernel's most channels
SHAPES = [(3, 128, 157, 64, (3, 3)), (2, 128, 126, 64, (3, 3)), (2, 10, 11, 8, (3, 3)),
          (1, 3, 3, 64, (3, 3)), (2, 48, 64, 8, (2, 2)), (2, 20, 31, 8, (2, 3)), (1, 16, 17, 256, (3, 3))]


def _block(c: int, pool, fold: bool = True, remat: bool = False, seed: int = 0) -> ConvBlock:
    """Block 0 with seeded weights and running statistics, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    block = ConvBlock(1, c, pool, fold, remat)
    with torch.no_grad():
        block[0].weight.copy_(torch.randn(block[0].weight.shape, generator=gen) / 3)
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


def _input(b, h, w, dtype, seed=1):
    return (2 * torch.randn((b, 1, h, w), generator=torch.Generator().manual_seed(seed))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:4])) + f"-pool{s[4][0]}{s[4][1]}")
def test_plain_version_is_today_s_eval_block_to_the_bit(dtype, shape):
    b, h, w, c, pool = shape
    block = _block(c, pool)
    x = _input(b, h, w, dtype)
    with torch.inference_mode():
        got = convblock.block0_reference(x, *_folded(block, dtype), pool)
        want = block(x)
    assert got.dtype == dtype and got.shape == (b, c, h // pool[0], w // pool[1])
    assert torch.equal(got, want)


@contextlib.contextmanager
def _card(monkeypatch):
    """The device predicate says "on the card" for every tensor, and the
    kernel's wrapper is a stand-in that records its calls and returns the
    plain version's output."""
    calls = []

    def wrapper(x, weight, bias, pool):
        calls.append((tuple(x.shape), weight.dtype, bias.dtype, tuple(pool)))
        return convblock.block0_reference(x, weight, bias, pool)

    monkeypatch.setattr(convblock, "on_card", lambda x: True)
    monkeypatch.setattr(convblock, "block0_cuda", wrapper)
    yield calls


def _counts():
    return tuple(profiling.read_counter(n) or 0 for n in (convblock.BLOCK0_FORWARDS, convblock.BLOCK0_KERNEL_FORWARDS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_eval_block0_on_the_card_goes_through_the_wrapper(monkeypatch, dtype):
    block = _block(8, (3, 3))
    x = _input(2, 24, 25, dtype)
    with torch.inference_mode():
        want = block(x)
        before = _counts()
        with _card(monkeypatch) as calls:
            got = block(x)
    assert calls == [((2, 1, 24, 25), dtype, dtype, (3, 3))]
    assert torch.equal(got, want)
    assert _counts() == (before[0] + 1, before[1] + 1)


def test_only_block0_of_the_hybrid_goes_through_the_wrapper(monkeypatch):
    """An eval forward of the whole encoder: block 0 through K4's wrapper,
    blocks 1-3 (C input channels) through K5's (``ops/convblock.py::
    blocks_cuda``; ``tests/test_torch_port_blocks.py`` holds its routing)."""
    model = StandardHybrid(HybridConfig(pool_dim=(3, 3), hidden_channels=8, seq_type="RNN"), (96, 99),
                           fold_bn_eval=True).eval()
    x = torch.randn((4, 96, 99), generator=torch.Generator().manual_seed(2))
    blocks_calls = []

    def blocks_wrapper(x, weight, bias, pool):
        blocks_calls.append(tuple(x.shape))
        return convblock.blocks_reference(x, weight, bias, pool)

    with torch.inference_mode():
        want = model(x)
        with _card(monkeypatch) as calls:
            monkeypatch.setattr(convblock, "blocks_cuda", blocks_wrapper)
            got = model(x)
    assert calls == [((4, 1, 96, 99), torch.bfloat16, torch.bfloat16, (3, 3))]
    assert blocks_calls == [(4, 8, 32, 33), (4, 8, 10, 11), (4, 8, 3, 3)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["train", "remat", "unfolded", "block1"])
def test_other_blocks_and_modes_keep_today_s_code(monkeypatch, case):
    """Train mode (with and without remat), ``fold_bn_eval: false`` and a
    block of more input channels do not go through the wrapper, on the card
    or not; an unfolded eval-mode block 0 on the card counts as a forward
    that did not launch the kernel."""
    block = _block(8, (3, 3), fold=case != "unfolded", remat=case == "remat")
    x = _input(2, 6, 25, torch.float32)
    if case in ("train", "remat"):
        block.train()
    if case == "block1":
        block = ConvBlock(8, 8, (3, 3), fold_bn_eval=True).eval()
        x = torch.randn((2, 8, 6, 25))
    grad = torch.enable_grad() if case in ("train", "remat") else torch.inference_mode()
    with grad:
        want = block(x)
        before = _counts()
        with _card(monkeypatch) as calls:
            got = block(x)
    assert calls == []
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == (before[0] + (case == "unfolded"), before[1])


@pytest.mark.parametrize("case,error,match", [
    ("grad", RuntimeError, "no backward"),
    ("channels", ValueError, "1 to 256 channels"),
    ("width", ValueError, "shared memory"),
])
def test_eval_block0_on_the_card_raises_what_the_kernel_does_not_take(monkeypatch, case, error, match):
    """A folded eval-mode block 0 on the card always goes to the kernel's
    wrapper, which raises, before any launch, on an eval forward that
    autograd records, more channels than the kernel takes and a map too
    wide for its tile; none of them falls back to today's code, and none
    counts as a forward."""

    def no_launch(*a, **k):
        raise AssertionError("the kernel was looked up for a launch")

    block = _block(300 if case == "channels" else 8, (3, 3))
    x = _input(2, 6, 60000 if case == "width" else 25, torch.float32)
    monkeypatch.setattr(convblock, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", no_launch)
    before, launches = _counts(), convblock.block0_cuda.launches
    with torch.enable_grad() if case == "grad" else torch.inference_mode():
        with pytest.raises(error, match=match):
            block(x)
    assert _counts() == before and convblock.block0_cuda.launches == launches


def test_cpu_tensors_do_not_go_through_the_wrapper(monkeypatch):
    block = _block(8, (3, 3))
    x = _input(2, 24, 25, torch.float32)

    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called on a CPU tensor")

    monkeypatch.setattr(convblock, "block0_cuda", refuse)
    before = _counts()
    with torch.inference_mode():
        out = block(x)
    assert out.shape == (2, 8, 8, 8)
    assert _counts() == before  # a CPU forward is no forward on the card


def test_share_reader_reads_the_block0_counters(monkeypatch):
    """``benchmark/layer_metrics/test.block0_kernel_share.py``: None before
    any forward on the card (the CPU, or a program without the counters),
    then the share of them that launched the kernel, in %."""
    from benchmark import harness

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    reader = harness.load_module(harness.HERE / "layer_metrics" / "test.block0_kernel_share.py", "t_block0_share")
    assert reader.read({}) is None
    for kernel in (True, True, True, False):
        convblock.count_block0(kernel)
    assert reader.read({}) == pytest.approx(75.0)
    monkeypatch.delattr(profiling, "read_counter")
    assert reader.read({}) is None


def _bad_inputs():
    x = _input(2, 12, 13, torch.float32)
    w, b = torch.randn((8, 1, 3, 3)), torch.randn(8)
    return {
        "two input channels": ((torch.randn((2, 2, 12, 13)), torch.randn((8, 2, 3, 3)), b, (3, 3)), ValueError),
        "a 5x5 kernel": ((x, torch.randn((8, 1, 5, 5)), b, (3, 3)), ValueError),
        "bias of other channels": ((x, w, torch.randn(7), (3, 3)), ValueError),
        "too many channels": ((x, torch.randn((257, 1, 3, 3)), torch.randn(257), (3, 3)), ValueError),
        "a pool taller than the map": ((x, w, b, (13, 3)), ValueError),
        "a pool wider than the map": ((x, w, b, (3, 14)), ValueError),
        "float16": ((x.half(), w.half(), b.half(), (3, 3)), TypeError),
        "float64": ((x.double(), w.double(), b.double(), (3, 3)), TypeError),
        "weight of another dtype": ((x, w.bfloat16(), b, (3, 3)), TypeError),
        "a non-contiguous input": ((x.transpose(2, 3).contiguous().transpose(2, 3), w, b, (3, 3)), ValueError),
        "CPU tensors": ((x, w, b, (3, 3)), ValueError),
        "a weight that records its gradient": ((x, w.clone().requires_grad_(), b, (3, 3)), RuntimeError),
        "a row wider than shared memory": ((_input(1, 3, 30000, torch.float32), w, b, (3, 3)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses_before_any_launch(monkeypatch, case):
    args, error = _bad_inputs()[case]

    def no_launch(*a, **k):
        raise AssertionError("the kernel was looked up for a launch")

    monkeypatch.setattr(cuda_build, "function", no_launch)
    launches = convblock.block0_cuda.launches
    with pytest.raises(error):
        convblock.block0_cuda(*args)
    assert convblock.block0_cuda.launches == launches


def test_kernel_source_is_built_with_the_others():
    """The first load builds every ``csrc/*.cu`` at once, K4's among them."""
    assert {"block0", "specaugment", "protohead", "mel"} <= set(cuda_build.sources())
