"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and skips
without one (the ``cuda`` fixture decides at run time).

This file imports nothing of JAX, so on a machine with the card and without
JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_few_shot_learning_tpu_torch.config import (  # noqa: E402
    ExperimentConfig, ModelConfig, SpecAugParams,
)
from audio_few_shot_learning_tpu_torch.data.store import PackedStore  # noqa: E402
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore  # noqa: E402
from audio_few_shot_learning_tpu_torch.device import resolve_device  # noqa: E402
from audio_few_shot_learning_tpu_torch.ops import convblock, mel, protohead, specaugment  # noqa: E402
from audio_few_shot_learning_tpu_torch.train.engine import Trainer  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return resolve_device("cuda:0")  # TF32 off, as the entry points run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the eval batch's support; multi-segment queries at the E the engine takes
# on an 80 GB card: 16 episodes at s_max 6, 3 at s_max 36 (flagship); a
# train step's single episode at 128x157 and NSynth's 128x126 (f32: 6-row
# tiles, a partial last one); odd T with F not a multiple of any 16-byte
# row span (the scalar path)
@pytest.mark.parametrize("shape", [(16, 25, 128, 157), (16, 150, 128, 157), (3, 900, 128, 157),
                                   (1, 3, 37, 1000), (2, 1, 1, 31), (1, 25, 128, 157),
                                   (1, 25, 128, 126), (2, 7, 37, 157)])
def test_specaugment_kernel_matches_plain(cuda, dtype, shape):
    e, b, f, t = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = SpecAugParams(use=True, mask_param=16, W=min(22, t // 3), num_mask=2, p=0.282)
    spec = (3 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    draws = specaugment.draw_views_params(gen, params, e, b, f, t, cuda)
    plan = specaugment.views_plan(e, b, f, t, spec.element_size(), 132)
    assert (plan.vec > 1) == ((f * t * spec.element_size()) % 16 == 0)
    before = specaugment.views_cuda.launches
    out = specaugment.views_cuda(spec, *draws, -0.5)
    ref = specaugment.views_reference(spec, *draws, -0.5)
    torch.cuda.synchronize()
    assert specaugment.views_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (e, b, 4, f, t)
    # identical separately rounded arithmetic: equal to the bit
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_specaugment_kernel_matches_plain_from_an_unaligned_base(cuda, dtype):
    """A contiguous spec whose base is one element past a 16-byte boundary:
    the plan takes the scalar path at the train step's shape."""
    shape = (1, 25, 128, 157)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = SpecAugParams(use=True, mask_param=16, W=22, num_mask=2, p=0.282)
    flat = torch.empty(int(np.prod(shape)) + 1, device=cuda, dtype=dtype)
    spec = flat[1:].view(shape)
    spec.copy_(3 * torch.randn(shape, generator=gen, device=cuda))
    assert spec.data_ptr() % 16 != 0 and spec.is_contiguous()
    draws = specaugment.draw_views_params(gen, params, *shape, cuda)
    out = specaugment.views_cuda(spec, *draws, 0.0)
    ref = specaugment.views_reference(spec, *draws, 0.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_specaugment_kernel_is_one_device_op(cuda, dtype):
    """One ``views_cuda`` call runs K1 and nothing else on the device: the
    masks reach it as views of the bool tensors, no conversion kernel."""
    from torch.profiler import ProfilerActivity, profile

    shape = (1, 25, 128, 157)
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = SpecAugParams(use=True, mask_param=16, W=22, num_mask=1, p=0.282)
    spec = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    draws = specaugment.draw_views_params(gen, params, *shape, cuda)
    specaugment.views_cuda(spec, *draws, 0.0)  # built, loaded and warm
    torch.cuda.synchronize()
    names = []
    for _ in range(3):  # a trace with no device activity at all is the profiler's loss
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            specaugment.views_cuda(spec, *draws, 0.0)
            torch.cuda.synchronize()
        names = [evt.key for evt in prof.key_averages() for _ in range(evt.count)
                 if str(evt.device_type).endswith("CUDA")]
        if names:
            break
    assert len(names) == 1 and "views_kernel" in names[0], names


def test_specaugment_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = SpecAugParams(use=True, mask_param=4, W=5, num_mask=1, p=0.282)
    spec = torch.randn((1, 3, 16, 40), generator=gen, device=cuda)
    ys, tm, fm = specaugment.draw_views_params(gen, params, 1, 3, 16, 40, cuda)
    with pytest.raises(ValueError, match="bool"):
        specaugment.views_cuda(spec, ys, tm.to(torch.uint8), fm, 0.0)
    with pytest.raises(TypeError, match="warp positions"):
        specaugment.views_cuda(spec, ys.double(), tm, fm, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        specaugment.views_cuda(spec.transpose(-1, -2).contiguous().transpose(-1, -2), ys, tm, fm, 0.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        specaugment.views_cuda(spec.half(), ys, tm, fm, 0.0)


# K4, eval block 0: (maps, H, W, channels, pool). The flagship eval batch's
# 200 maps of 128x157 (E=16 runs 16 of them at once: the same per map), a
# multi-segment episode's 3 700 at s_max 36, NSynth's 128x126, one map, H
# and W not multiples of the pool, a 3x3 map, the test helpers' pool 2 and
# another pool (both read the patch from shared memory), an odd pooled
# width at pool 3 (one pixel a thread), and the kernel's most channels
BLOCK0_SHAPES = [(200, 128, 157, 64, (3, 3)), (3700, 128, 157, 64, (3, 3)), (200, 128, 126, 64, (3, 3)),
                 (1, 128, 157, 64, (3, 3)), (5, 100, 101, 64, (3, 3)), (2, 3, 3, 64, (3, 3)),
                 (4, 48, 64, 8, (2, 2)), (3, 20, 31, 8, (2, 3)), (2, 30, 15, 8, (3, 3)),
                 (2, 49, 50, 256, (3, 3))]


def _block0_args(dev, b, h, w, c, dtype, seed=0):
    """x, the folded weight and bias as ``ConvBlock._block`` hands them over,
    rounded to the activation's dtype."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn((b, 1, h, w), generator=gen, device=dev)).to(dtype)
    weight = (torch.randn((c, 1, 3, 3), generator=gen, device=dev) / 3).to(dtype)
    bias = (torch.randn(c, generator=gen, device=dev) / 2).to(dtype)
    return x, weight, bias


def assert_block0_close(out, ref, x, weight, pool):
    """K4 against its plain version. S, per pooled value, is the largest sum
    of |tap| x |input| over the conv outputs of its window: a bound on every
    partial sum. In float32 both sum 9 products in their own order and round
    the bias add once: within 2^-19 S + 2^-22 |out| (9 roundings of at most
    2^-24 S each side, two of the output). In bf16 the plain path also rounds
    the conv output to bf16 before its bias add (half an ulp, 2^-8 of
    |conv| <= S) and each side rounds its output to bf16 once (2^-8 |out|):
    within 2^-7 S + 2^-7 |out|, twice the sum of those roundings."""
    atol, rtol = (2.0 ** -19, 2.0 ** -22) if x.dtype == torch.float32 else (2.0 ** -7, 2.0 ** -7)
    s = F.max_pool2d(F.conv2d(x.float().abs(), weight.float().abs(), padding=1), tuple(pool))
    err = (out.float() - ref.float()).abs()
    limit = atol * s + rtol * ref.float().abs()
    worst = (err - limit).max().item()
    assert worst <= 0, f"max error {err.max().item()} beyond the rounding bound by {worst}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BLOCK0_SHAPES, ids=lambda s: "x".join(map(str, s[:4])) + f"-pool{s[4][0]}{s[4][1]}")
def test_block0_kernel_matches_plain(cuda, dtype, shape):
    b, h, w, c, pool = shape
    x, weight, bias = _block0_args(cuda, b, h, w, c, dtype)
    before = convblock.block0_cuda.launches
    out = convblock.block0_cuda(x, weight, bias, pool)
    torch.cuda.synchronize()
    assert convblock.block0_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, c, h // pool[0], w // pool[1])
    ref = convblock.block0_reference(x, weight, bias, pool)
    assert_block0_close(out, ref, x, weight, pool)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block0_kernel_propagates_nan(cuda, dtype):
    """A NaN in the input reaches every pooled value whose conv window holds
    it, through the max and the ReLU, as max_pool2d and relu carry it."""
    x, weight, bias = _block0_args(cuda, 2, 30, 31, 16, dtype, seed=1)
    x[0, 0, 7, 9] = float("nan")
    x[1, 0, 0, 0] = float("nan")
    out = convblock.block0_cuda(x, weight, bias, (3, 3))
    ref = convblock.block0_reference(x, weight, bias, (3, 3))
    torch.cuda.synchronize()
    assert torch.isnan(ref).any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    finite = ~torch.isnan(ref)
    assert_block0_close(torch.where(finite, out, 0), torch.where(finite, ref, 0), torch.nan_to_num(x), weight, (3, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block0_kernel_is_one_device_op(cuda, dtype):
    from torch.profiler import ProfilerActivity, profile

    x, weight, bias = _block0_args(cuda, 200, 128, 157, 64, dtype, seed=2)
    convblock.block0_cuda(x, weight, bias, (3, 3))  # built, loaded and warm
    torch.cuda.synchronize()
    names = []
    for _ in range(3):  # a trace with no device activity at all is the profiler's loss
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            convblock.block0_cuda(x, weight, bias, (3, 3))
            torch.cuda.synchronize()
        names = [evt.key for evt in prof.key_averages() for _ in range(evt.count)
                 if str(evt.device_type).endswith("CUDA")]
        if names:
            break
    # the benchmark files it under "conv" (a name with "conv", without "pool" or "batch_norm")
    assert len(names) == 1 and "block0_conv_kernel" in names[0], names
    assert "pool" not in names[0].lower() and "batch_norm" not in names[0].lower()


def test_block0_kernel_refuses_what_it_does_not_take(cuda):
    x, weight, bias = _block0_args(cuda, 2, 12, 13, 8, torch.float32, seed=3)
    with pytest.raises(ValueError, match="one input channel"):
        convblock.block0_cuda(x.expand(2, 2, 12, 13).contiguous(), weight, bias, (3, 3))
    with pytest.raises(ValueError, match="3x3"):
        convblock.block0_cuda(x, torch.zeros((8, 1, 5, 5), device=cuda), bias, (3, 3))
    with pytest.raises(ValueError, match="does not fit"):
        convblock.block0_cuda(x, weight, bias, (13, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        convblock.block0_cuda(x.half(), weight.half(), bias.half(), (3, 3))
    with pytest.raises(ValueError, match="contiguous"):
        convblock.block0_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), weight, bias, (3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        convblock.block0_cuda(x, weight.cpu(), bias, (3, 3))
    with pytest.raises(ValueError, match="shared memory"):
        convblock.block0_cuda(torch.zeros((1, 1, 3, 30000), device=cuda), weight, bias, (3, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        convblock.block0_cuda(x, weight.clone().requires_grad_(), bias, (3, 3))


# K5 (eval blocks 1-3, bf16): the flagship's blocks 1-3 at an eval batch
# (42x52, 14x17, 4x5), block 1 at a multi-segment episode, NSynth's
# (42x42, 14x14, 4x4), fewer channels (padded in the kernel) at pools 2x2,
# 3x2 and 1x3, a wide map (rectangles and a strip of 6 columns) and a map
# the size of the pool
BLOCKS_SHAPES = [(200, 64, 42, 52, (3, 3)), (200, 64, 14, 17, (3, 3)), (200, 64, 4, 5, (3, 3)),
                 (3700, 64, 42, 52, (3, 3)), (200, 64, 42, 42, (3, 3)), (200, 64, 14, 14, (3, 3)),
                 (200, 64, 4, 4, (3, 3)), (7, 8, 24, 30, (2, 2)), (5, 16, 20, 31, (3, 2)), (3, 32, 11, 13, (1, 3)),
                 (2, 64, 42, 400, (3, 3)), (1, 64, 3, 3, (3, 3))]


def _blocks_args(dev, b, c, h, w, seed=0):
    """Block 1-3 input as K4 or K5 leaves it (channels-last, non-negative),
    the folded weight and bias, bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=gen, device=dev).abs().bfloat16().contiguous(
        memory_format=torch.channels_last)
    weight = (torch.randn((c, c, 3, 3), generator=gen, device=dev) / (3 * c ** 0.5)).bfloat16()
    bias = (torch.randn(c, generator=gen, device=dev) / 2).bfloat16()
    return x, weight, bias


def assert_blocks_close(out, ref, x, weight, pool):
    """K5 against its plain version in bf16, as ``assert_block0_close``: S,
    per pooled value, bounds every partial sum (the largest sum of |tap| x
    |input| over its window's conv outputs). Both sum the 9 C products in
    float32 in their own orders (576 roundings of at most 2^-24 S each side:
    under 2^-14 S); the plain path also rounds the conv output to bf16
    before its bias add (2^-8 S), and each side rounds its output once
    (2^-8 |out|): within 2^-7 S + 2^-7 |out|."""
    s = F.max_pool2d(F.conv2d(x.float().abs(), weight.float().abs(), padding=1), tuple(pool))
    err = (out.float() - ref.float()).abs()
    worst = (err - 2.0 ** -7 * s - 2.0 ** -7 * ref.float().abs()).max().item()
    assert worst <= 0, f"max error {err.max().item()} beyond the rounding bound by {worst}"


@pytest.mark.parametrize("shape", BLOCKS_SHAPES, ids=lambda s: "x".join(map(str, s[:4])) + f"-pool{s[4][0]}{s[4][1]}")
def test_blocks_kernel_matches_plain(cuda, shape):
    b, c, h, w, pool = shape
    x, weight, bias = _blocks_args(cuda, b, c, h, w)
    before = convblock.blocks_cuda.launches
    out = convblock.blocks_cuda(x, weight, bias, pool)
    torch.cuda.synchronize()
    assert convblock.blocks_cuda.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, c, h // pool[0], w // pool[1])
    assert out.is_contiguous(memory_format=torch.channels_last)
    ref = convblock.blocks_reference(x, weight, bias, pool)
    assert_blocks_close(out, ref, x, weight, pool)


def test_blocks_kernel_propagates_nan(cuda):
    """A NaN in the input reaches every pooled value whose conv windows read
    it, through the max and the ReLU, as max_pool2d and relu carry it."""
    x, weight, bias = _blocks_args(cuda, 3, 64, 42, 52, seed=1)
    x[0, 5, 7, 9] = float("nan")
    x[2, 0, 0, 0] = float("nan")
    x[1, 63, 41, 51] = float("nan")  # a row and a column the pool drops: read by conv row 40, column 50 only
    out = convblock.blocks_cuda(x, weight, bias, (3, 3))
    ref = convblock.blocks_reference(x, weight, bias, (3, 3))
    torch.cuda.synchronize()
    assert torch.isnan(ref).any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    finite = ~torch.isnan(ref)
    assert_blocks_close(torch.where(finite, out, 0), torch.where(finite, ref, 0), torch.nan_to_num(x), weight, (3, 3))


def test_blocks_kernel_is_one_device_op(cuda):
    from torch.profiler import ProfilerActivity, profile

    x, weight, bias = _blocks_args(cuda, 200, 64, 42, 52, seed=2)
    convblock.blocks_cuda(x, weight, bias, (3, 3))  # built, loaded and warm
    torch.cuda.synchronize()
    names = []
    for _ in range(3):  # a trace with no device activity at all is the profiler's loss
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            convblock.blocks_cuda(x, weight, bias, (3, 3))
            torch.cuda.synchronize()
        names = [evt.key for evt in prof.key_averages() for _ in range(evt.count)
                 if str(evt.device_type).endswith("CUDA")]
        if names:
            break
    # the benchmark files it under "conv" (a name with "conv", without "pool" or "batch_norm")
    assert len(names) == 1 and "blocks_conv_kernel" in names[0], names
    assert "pool" not in names[0].lower() and "batch_norm" not in names[0].lower()


def test_blocks_kernel_refuses_what_it_does_not_take(cuda):
    x, weight, bias = _blocks_args(cuda, 2, 8, 12, 13, seed=3)
    with pytest.raises(ValueError, match="channels-last"):
        convblock.blocks_cuda(x.contiguous(), weight, bias, (3, 3))
    with pytest.raises(TypeError, match="bfloat16"):
        convblock.blocks_cuda(x.float(), weight.float(), bias.float(), (3, 3))
    with pytest.raises(ValueError, match="a multiple of 8"):
        x12, w12, b12 = _blocks_args(cuda, 2, 12, 12, 13, seed=3)
        convblock.blocks_cuda(x12, w12, b12, (3, 3))
    with pytest.raises(ValueError, match="pools up to"):
        convblock.blocks_cuda(x, weight, bias, (4, 2))
    with pytest.raises(ValueError, match="does not fit"):
        convblock.blocks_cuda(x[:, :, :1].contiguous(memory_format=torch.channels_last), weight, bias, (2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        convblock.blocks_cuda(x, weight.cpu(), bias, (3, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        convblock.blocks_cuda(x, weight.float().requires_grad_().bfloat16(), bias, (3, 3))


@pytest.mark.parametrize("n_way,labels", [
    (5, np.repeat(np.arange(5), 5)),
    (7, np.array([0] * 9 + [1] * 2 + [2] * 5 + [3] * 1 + [4] * 4 + [5] * 4)),  # class 6 empty
    (40, np.arange(40) % 37),
])
def test_protohead_kernel_matches_plain(cuda, n_way, labels):
    gen = torch.Generator(device=cuda).manual_seed(1)
    e, s, q, d = 16, len(labels), 25, 256
    sup = torch.randn((e, s, d), generator=gen, device=cuda)
    qry = torch.randn((e, q, d), generator=gen, device=cuda)
    lab = torch.as_tensor(labels, device=cuda).expand(e, -1)  # int64, as torch gives
    out = protohead.episode_scores_cuda(sup, lab, qry, n_way)
    ref = protohead.batched_episode_scores_reference(sup, lab, qry, n_way)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("e,d", [(16, 64), (1, 256), (1, 64)])  # wav eval batch, predict
def test_protohead_kernel_matches_plain_at_path_shapes(cuda, e, d):
    """Inputs as the eval path gives them: support and queries slices of the
    attention output [E, S+Q, D], int64 labels expanded over episodes."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    s = q = 25
    fused = torch.randn((e, s + q, d), generator=gen, device=cuda)
    sup, qry = fused[:, :s], fused[:, s:]
    lab = torch.arange(5, device=cuda).repeat_interleave(5).expand(e, -1)
    out = protohead.episode_scores_cuda(sup, lab, qry, 5)
    ref = protohead.batched_episode_scores_reference(sup, lab, qry, 5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)


# E as the engine takes it on an 80 GB card: flagship and wav at s_max 6,
# flagship (D 256) and plain (D 64) at s_max 36
@pytest.mark.parametrize("e,s_max,d", [(16, 6, 256), (16, 6, 64), (3, 36, 256), (15, 36, 64)])
def test_protohead_kernel_matches_plain_at_multiseg_shapes(cuda, e, s_max, d):
    """Multi-segment eval: Q = 25 x s_max query rows (150 and 900: 19 and
    113 query tiles an episode), slices of one [E, S+Q, D] tensor."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    s, q = 25, 25 * s_max
    fused = torch.randn((e, s + q, d), generator=gen, device=cuda)
    sup, qry = fused[:, :s], fused[:, s:]
    lab = torch.arange(5, device=cuda).repeat_interleave(5).expand(e, -1)
    plan = protohead.head_plan(e, s, q, d, 5)
    assert plan.blocks == e * -(-q // plan.q_tile)
    out = protohead.episode_scores_cuda(sup, lab, qry, 5)
    ref = protohead.batched_episode_scores_reference(sup, lab, qry, 5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)


# the classifier API's one-row dummy episodes: a support encode (one query
# row, the q_tile=1 plan) and a query encode (one support row, one class)
@pytest.mark.parametrize("s,q,n_way,q_tile", [(25, 1, 5, 1), (1, 25, 1, 8)])
def test_protohead_kernel_matches_plain_at_classifier_shapes(cuda, s, q, n_way, q_tile):
    gen = torch.Generator(device=cuda).manual_seed(12)
    fused = torch.randn((1, s + q, 256), generator=gen, device=cuda)
    sup, qry = fused[:, :s], fused[:, s:]
    lab = (torch.arange(s, device=cuda) % n_way).expand(1, -1)
    assert protohead.head_plan(1, s, q, 256, n_way).q_tile == q_tile
    out = protohead.episode_scores_cuda(sup, lab, qry, n_way)
    ref = protohead.batched_episode_scores_reference(sup, lab, qry, n_way)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_protohead_call_launches_one_kernel(cuda, label_dtype):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(7)
    fused = torch.randn((16, 50, 256), generator=gen, device=cuda)
    sup, qry = fused[:, :25], fused[:, 25:]
    lab = torch.arange(5, device=cuda, dtype=label_dtype).repeat_interleave(5).expand(16, -1)
    protohead.episode_scores_cuda(sup, lab, qry, 5)  # build and load first
    torch.cuda.synchronize()
    before = protohead.episode_scores_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        protohead.episode_scores_cuda(sup, lab, qry, 5)
        torch.cuda.synchronize()
    device = [
        (evt.key, evt.count) for evt in prof.key_averages()
        if str(evt.device_type).endswith("CUDA")
    ]
    assert len(device) == 1 and device[0][1] == 1, device
    assert "episode_scores_kernel" in device[0][0]
    assert protohead.episode_scores_cuda.launches == before + 1


def test_protohead_kernel_refuses_too_many_classes(cuda):
    # 240 prototypes of D=256 alone take 240 KB, beyond the 227 KB a block may use
    sup = torch.zeros((1, 4, 256), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        protohead.episode_scores_cuda(sup, torch.zeros((1, 4), device=cuda, dtype=torch.long), sup, 240)


def test_fused_scores_backward_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    sup = torch.randn((3, 10, 64), generator=gen, device=cuda, requires_grad=True)
    qry = torch.randn((3, 6, 64), generator=gen, device=cuda, requires_grad=True)
    lab = torch.randint(0, 4, (3, 10), generator=gen, device=cuda)
    protohead.batched_episode_scores(sup, lab, qry, 4).square().sum().backward()
    g_sup, g_qry = sup.grad.clone(), qry.grad.clone()
    sup.grad = qry.grad = None
    protohead.batched_episode_scores_reference(sup, lab, qry, 4).square().sum().backward()
    torch.testing.assert_close(g_sup, sup.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(g_qry, qry.grad, atol=1e-4, rtol=1e-4)


def test_eval_path_launches_both_kernels(cuda):
    rng = np.random.default_rng(3)
    items = rng.standard_normal((6 * 4, 96, 99)).astype(np.float32)
    store = PackedStore.pack(list(items), np.repeat(np.arange(6), 4), device=cuda)
    exp = ExperimentConfig.from_dict({
        "specaug_params": {"use": True}, "n_testing_tasks": 4,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
        "tpu": {"eval_episode_batch": 2},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8}})
    trainer = Trainer(exp, mdl, store, test_store=store)
    specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = convblock.block0_cuda.launches = 0
    convblock.blocks_cuda.launches = 0
    names = (convblock.BLOCK0_FORWARDS, convblock.BLOCK0_KERNEL_FORWARDS, convblock.BLOCKS_FORWARDS,
             convblock.BLOCKS_KERNEL_FORWARDS)
    counts = [read_counter(n) or 0 for n in names]
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0
    # per batch: K1 twice (support, queries), block 0 once (one encoder pass),
    # blocks 1-3 once each (K5, bf16), K2 once
    assert (specaugment.views_cuda.launches, convblock.block0_cuda.launches, convblock.blocks_cuda.launches,
            protohead.episode_scores_cuda.launches) == (4, 2, 6, 2)
    assert [read_counter(n) for n in names] == [counts[0] + 2, counts[1] + 2, counts[2] + 6, counts[3] + 6]


@pytest.mark.parametrize("flavor", ["online", "offline"])
@pytest.mark.parametrize("lead,length", [
    ((16 * 50,), 80000),  # the flagship eval batch: M = 125 600
    ((16 * 175,), 80000),  # the wav multi-segment eval batch at s_max 6: M = 439 600
    ((36,), 80000),  # a 36-segment file in to_var_spec: M = 5 652
    ((50,), 80000),  # a predict episode
    ((1,), 80000),  # one clip: M = 157, a ragged last tile
    ((1,), 100),  # M = 1
    ((), 33 * 512),  # a flat [M, K] input, M = 34
    ((2, 3), 2000),  # two leading axes, 4 frames each
])
def test_mel_kernel_matches_plain(cuda, flavor, lead, length):
    spec = mel.MelSpec(flavor)
    gen = torch.Generator(device=cuda).manual_seed(4)
    wav = 0.3 * torch.randn((*lead, length), generator=gen, device=cuda)
    pspec = mel.power_spectrogram(wav, pad_mode=spec.pad_mode)
    fb = torch.from_numpy(spec.fb).to(cuda)
    before = mel.mel_log_cuda.launches
    out = mel.mel_log_cuda(pspec, fb, spec.log_mult, spec.eps)
    ref = mel.mel_log_reference(pspec, fb, spec.log_mult, spec.eps).transpose(-1, -2)
    torch.cuda.synchronize()
    assert mel.mel_log_cuda.launches == before + 1
    assert out.shape == ref.shape == (*lead, 128, 1 + length // 512)
    # the same f32 products summed in another order, then log10: 1e-3 dB
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=0)
    torch.testing.assert_close(spec(wav), out, atol=0, rtol=0)  # MelSpec launches the same kernel


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", [33, 35, 63, 7850])  # last tile of 1, 3, 31 and 10 rows
def test_mel_kernel_ragged_tail_and_unaligned_base(cuda, m, aligned):
    spec = mel.MelSpec("offline")
    gen = torch.Generator(device=cuda).manual_seed(8)
    rows = mel.power_spectrogram(0.3 * torch.randn((m - 1) * 512, generator=gen, device=cuda))
    assert rows.shape == (m, 513)
    # rows 1: of a flat [M + 1, 513] buffer: contiguous, base 2 052 bytes (4 mod 16) in
    flat = torch.empty((m + 1, 513), device=cuda)
    pspec = flat[1:] if not aligned else flat[:m]
    pspec.copy_(rows)
    assert pspec.is_contiguous() and (pspec.data_ptr() % 16 == 0) == aligned
    fb = torch.from_numpy(spec.fb).to(cuda)
    out = mel.mel_log_cuda(pspec, fb, spec.log_mult, spec.eps)
    ref = mel.mel_log_reference(pspec, fb, spec.log_mult, spec.eps).transpose(-1, -2)
    torch.cuda.synchronize()
    assert out.shape == (128, m)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=0)


def test_melspec_launches_mel_kernel_once_per_call(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    wav = 0.3 * torch.randn((2, 50, 80000), generator=gen, device=cuda)
    for flavor in ("online", "offline"):
        spec = mel.MelSpec(flavor)
        before = mel.mel_log_cuda.launches
        out = spec(wav)
        torch.cuda.synchronize()
        assert mel.mel_log_cuda.launches == before + 1
        assert out.shape == (2, 50, 128, 157) and torch.isfinite(out).all()


def test_mel_kernel_band_ranges_and_input_checks(cuda):
    spec = mel.MelSpec("online")
    fb = torch.from_numpy(spec.fb).to(cuda)
    lo, hi = mel.band_ranges(spec.fb)
    with pytest.raises(ValueError, match="outside the band ranges"):
        mel.band_table(fb, lo + 1, hi)
    pspec = torch.rand((4, 157, 513), device=cuda)
    with pytest.raises(ValueError, match="device"):
        mel.mel_log_cuda(pspec, fb, spec.log_mult, spec.eps, bands=mel.band_table(fb))  # on the CPU
    with pytest.raises(TypeError, match="float32"):
        mel.mel_log_cuda(pspec.double(), fb, spec.log_mult, spec.eps)
    with pytest.raises(TypeError, match="float32"):
        mel.mel_log_cuda(pspec.to(torch.bfloat16), fb, spec.log_mult, spec.eps)
    with pytest.raises(ValueError, match="contiguous"):
        mel.mel_log_cuda(pspec.transpose(0, 1), fb, spec.log_mult, spec.eps)


def test_wav_eval_path_launches_mel_and_head_kernels(cuda):
    rng = np.random.default_rng(5)
    wavs = list((0.3 * rng.standard_normal((6 * 4, 16000))).astype(np.float32))
    store = PackedWavStore.pack(wavs, np.repeat(np.arange(6), 4), mean=-20.0, std=15.0, device=cuda)
    exp = ExperimentConfig.from_dict({
        "input_type": "wav", "n_testing_tasks": 4,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
        "tpu": {"eval_episode_batch": 2},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"pool_dim": [2, 2], "hidden_channels": 8}})
    trainer = Trainer(exp, mdl, store, test_store=store)
    kernels = (mel.mel_log_cuda, protohead.episode_scores_cuda, specaugment.views_cuda)
    for k in kernels:
        k.launches = 0
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0
    assert tuple(k.launches for k in kernels) == (2, 2, 0)  # per batch: K3 1, K2 1, K1 0


@pytest.mark.parametrize("e", [1, 4])
def test_k2_closed_form_backward_matches_autograd_on_card(cuda, e):
    """K2's backward (the closed-form VJP, never the plain forward) against
    autograd through the plain version, atol 1e-5, at the train step's head:
    support and queries slices of one [E, S+Q, 4x64] tensor."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    fused = torch.randn((e, 50, 256), generator=gen, device=cuda)
    lab = torch.arange(5, device=cuda).repeat_interleave(5).expand(e, -1)
    cot = torch.randn((e, 25, 5), generator=gen, device=cuda)
    ours, plain = fused.clone().requires_grad_(True), fused.clone().requires_grad_(True)
    before = protohead.episode_scores_cuda.launches
    protohead.batched_episode_scores(ours[:, :25], lab, ours[:, 25:], 5).backward(cot)
    assert protohead.episode_scores_cuda.launches == before + 1  # the forward only
    protohead.batched_episode_scores_reference(plain[:, :25], lab, plain[:, 25:], 5).backward(cot)
    torch.cuda.synchronize()
    torch.testing.assert_close(ours.grad, plain.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("microbatch", [None, 1])
def test_train_step_launches_k1_and_k2_per_chunk(cuda, microbatch):
    rng = np.random.default_rng(12)
    items = rng.standard_normal((6 * 5, 96, 99)).astype(np.float32)
    store = PackedStore.pack(list(items), np.repeat(np.arange(6), 5), device=cuda)
    exp = ExperimentConfig.from_dict({
        "specaug_params": {"use": True}, "n_training_tasks": 4,
        "n_way_train": 3, "n_shot_train": 2, "n_query_train": 2,
        "loss": {"cpl": {"use": True, "m_param": 2, "t_param": 2.0}},
        "tpu": {"episode_batch": 2, "episode_microbatch": microbatch},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8},
                                 "Attention": {"embed_dim": 64, "ffn_dim": 64}})
    trainer = Trainer(exp, mdl, store)
    specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = 0
    out = trainer.train_epoch()
    chunks = 2 if microbatch else 1
    assert all(np.isfinite(out[k]) for k in ("loss", "fsl_loss", "cpl_loss"))
    # 2 steps: K1 twice (support, queries) and K2 once per chunk
    assert (specaugment.views_cuda.launches, protohead.episode_scores_cuda.launches) == (
        4 * chunks, 2 * chunks)


def test_multiseg_eval_batch_card_vs_cpu(cuda):
    """One multi-segment eval batch (E=2, items of 1-3 segments, 4 views,
    attention) on the card against the CPU in float32 with the same weights,
    episode and draws; the card's votes equal the reference's host loop on
    the card's scores for every tie strategy."""
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.train.evaluate import majority_vote_accuracy_host

    rng = np.random.default_rng(13)
    counts = rng.integers(1, 4, 6 * 5)
    counts[0] = 3
    segs = rng.standard_normal((int(counts.sum()), 96, 99)).astype(np.float32)
    labels = np.repeat(np.arange(6), 5)
    exp = ExperimentConfig.from_dict({
        "specaug_params": {"use": True}, "test_query_augmentations": True, "multi_segm": True,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
        "tpu": {"eval_episode_batch": 2, "compute_dtype": "float32"},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8}})
    store = PackedStore.from_flat_arrays(segs, counts, labels, 6, device=cuda)
    card = Trainer(exp, mdl, store, device=cuda, seed=1)
    cpu = Trainer(exp, mdl, store, device="cpu", seed=1)
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    ep = sample_episode(torch.Generator(device=cuda).manual_seed(2), store, 3, 2, 2, 2, is_test=True)
    ep_cpu = type(ep)(**{k: v.cpu() for k, v in vars(ep).items()})
    qtot = ep.query.shape[1]
    assert qtot == 3 * 2 * 3
    gen = torch.Generator().manual_seed(3)
    draws = tuple(specaugment.draw_views_params(gen, exp.specaug_params, 2, n, 96, 99, "cpu") for n in (6, qtot))
    with torch.inference_mode():
        s_card = card._episode_scores(ep, 3, True, card.gen, tuple(tuple(x.to(cuda) for x in d) for d in draws))
        s_cpu = cpu._episode_scores(ep_cpu, 3, True, cpu.gen, draws)
    torch.testing.assert_close(s_card.cpu(), s_cpu, atol=1e-3, rtol=0)
    first = s_card.cpu().numpy()
    real = ep_cpu.query_mask.numpy() > 0
    for tie in ("", "min_label", "max_posterior"):
        got = Trainer.vote_accuracy(s_card, ep, 3, tie, store.s_max).cpu().numpy()
        want = [majority_vote_accuracy_host(first[i].argmax(-1)[real[i]], ep_cpu.audio_ids[i].numpy()[real[i]],
                                            ep_cpu.query_labels[i].numpy()[real[i]], first[i].max(-1)[real[i]], tie)
                for i in range(2)]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("raw", [{"use": True, "aug_num": 3},
                                 {"use": True, "aug_num": 2, "fuse_lowpass": True, "timestretch_p": 0.7,
                                  "timeinversion_p": 0.5},
                                 {"use": True, "aug_num": 2, "pitchshift_mode": "pv", "pitchshift_p": 1.0}],
                         ids=["default", "fuse_lowpass", "pv"])
def test_waveaugment_chain_card_vs_cpu(cuda, raw):
    """The chain on the card (cuFFT, gathers) against the CPU on the same
    draws: each row within 1e-5 of its input's RMS (the phase vocoder, whose
    phase accumulator sums in another order, 5e-3 relative RMS on tones)."""
    from audio_few_shot_learning_tpu_torch.config import WaveAugParams
    from audio_few_shot_learning_tpu_torch.ops.waveaugment import WaveAugment

    t = torch.arange(16000) / 16000.0
    f0 = torch.tensor([220.0, 440.0, 880.0, 1320.0])[:, None]
    x = (0.5 * torch.sin(2 * torch.pi * f0 * t))[None]  # [1, 4, 16000]
    if raw.get("pitchshift_mode") != "pv":
        x = x + 0.2 * torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    aug = WaveAugment(WaveAugParams.from_dict(raw))
    draws = aug.draw(torch.Generator().manual_seed(1), (1, aug.params.aug_num, 4), 16000, "cpu")
    want = aug(x, draws=draws)
    got = aug(x.to(cuda), draws={n: {k: v.to(cuda) for k, v in d.items()} for n, d in draws.items()}).cpu()
    assert got.shape == want.shape == (1, 4, 1 + aug.params.aug_num, 16000)
    if raw.get("pitchshift_mode") == "pv":
        rel = ((got - want).square().mean(-1) / want.square().mean(-1)).sqrt()
        assert rel.max().item() <= 5e-3
    else:
        rms = x.square().mean(-1, keepdim=True).sqrt()[..., None]  # [1, 4, 1, 1]
        assert ((got - want).abs().amax(-1, keepdim=True) / rms).max().item() <= 1e-5


def test_waveaugment_and_relation_paths_launch_their_kernels(cuda):
    """A WaveAugment train step and eval batch launch K3 once and K2 once
    (K1 never); a relation-head model's train step launches K2 never."""
    rng = np.random.default_rng(14)
    wavs = list((0.3 * rng.standard_normal((6 * 4, 16000))).astype(np.float32))
    store = PackedWavStore.pack(wavs, np.repeat(np.arange(6), 4), mean=19.0, std=5.0, device=cuda)
    base = {"input_type": "wav", "n_training_tasks": 1, "n_testing_tasks": 2,
            "n_way_train": 3, "n_shot_train": 2, "n_query_train": 2,
            "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2,
            "loss": {"cpl": {"use": True, "m_param": 2, "t_param": 2.0}},
            "tpu": {"eval_episode_batch": 2}}
    mdl = ModelConfig.from_dict({"Hybrid": {"pool_dim": [2, 2], "hidden_channels": 8},
                                 "Attention": {"embed_dim": 64, "ffn_dim": 64}})
    kernels = (mel.mel_log_cuda, protohead.episode_scores_cuda, specaugment.views_cuda)
    for over, per_step in (({"waveaug_params": {"use": True, "aug_num": 3}}, (1, 1, 0)),
                           ({"relation_head": True}, (1, 0, 0))):
        trainer = Trainer(ExperimentConfig.from_dict({**base, **over}), mdl, store, test_store=store)
        for k in kernels:
            k.launches = 0
        out = trainer.train_epoch()
        assert np.isfinite(out["loss"]) and tuple(k.launches for k in kernels) == per_step
        for k in kernels:
            k.launches = 0
        assert 0.0 <= trainer.test()["mean_accuracy"] <= 1.0
        assert tuple(k.launches for k in kernels) == per_step  # one batch of 2 episodes


def _staged_reference(store, batch_args, seed):
    """The CPU batches a host store's sampler gives for ``batch_args`` from
    one Generator, as the staging hands them to the model: padded
    spectrogram rows zeroed, float16 upcast."""
    rng, out = np.random.default_rng(seed), []
    for is_test, e in batch_args:
        ep = store.sample_episode_batch(rng, 3, 2, 2, is_test, e)
        out.append((ep.support.float(), ep.query.float(), ep.query_mask if is_test and store.multi_segm else None))
    return out


def test_staging_carries_every_batch_unchanged(cuda):
    """Batches staged through the two pinned slots while the compute stream
    is kept busy (a sleep kernel after each) arrive on the card unchanged:
    no slot is refilled while its copy is in flight."""
    from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
    from audio_few_shot_learning_tpu_torch.data.staging import EpisodeStager
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore

    rng = np.random.default_rng(15)
    spec = HostStore.pack([rng.standard_normal((int(rng.integers(1, 4)), 64, 80)).astype(np.float32)
                           for _ in range(30)], np.repeat(np.arange(6), 5), dtype="bfloat16")
    wav = WavHostStore.pack([(0.3 * rng.standard_normal(int(rng.integers(4000, 30000)))).astype(np.float32)
                             for _ in range(30)], np.repeat(np.arange(6), 5), multi_segm=True,
                            segment_seconds=1, sr=8000, dtype="float16")
    batch_args = [(False, 4), (True, 3), (False, 1), (True, 4), (True, 2), (False, 4), (True, 4), (False, 2)]
    for store in (spec, wav):
        stager = EpisodeStager(cuda)
        gen, got = np.random.default_rng(16), []
        for is_test, e in batch_args:
            ep = stager.stage(store, store.plan(gen, 3, 2, 2, is_test, e))
            got.append((ep.support, ep.query, ep.query_mask))
            torch.cuda._sleep(2_000_000)  # keep the compute stream busy behind the batch
        torch.cuda.synchronize()
        for (sup, qry, mask), (want_s, want_q, want_m) in zip(got, _staged_reference(store, batch_args, 16)):
            torch.testing.assert_close(sup.float().cpu(), want_s, atol=0, rtol=0)
            torch.testing.assert_close(qry.float().cpu(), want_q, atol=0, rtol=0)
            assert (mask is None) == (want_m is None)
            if mask is not None:
                torch.testing.assert_close(mask.cpu(), want_m, atol=0, rtol=0)
        assert stager.h2d_bytes > 0


def test_hostfed_train_step_matches_device_fed_on_card(cuda):
    """A host store's staged batch through one train step on the card gives
    the device store's step on the same episode and draws."""
    from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws

    rng = np.random.default_rng(17)
    items = rng.standard_normal((6 * 5, 96, 99)).astype(np.float32)
    labels = np.repeat(np.arange(6), 5)
    host = HostStore.pack(list(items), labels)
    packed = PackedStore.pack(list(items), labels, device=cuda)
    exp = ExperimentConfig.from_dict({
        "specaug_params": {"use": True}, "n_training_tasks": 2, "n_way_train": 3, "n_shot_train": 2,
        "n_query_train": 2, "loss": {"cpl": {"use": True, "m_param": 2, "t_param": 2.0}},
        "tpu": {"episode_batch": 2, "compute_dtype": "float32"},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8}, "Attention": {"embed_dim": 64, "ffn_dim": 64}})
    a, b = Trainer(exp, mdl, host, seed=2), Trainer(exp, mdl, packed, seed=2)
    assert a.host_mode and not b.host_mode
    ep_host = a.stager.stage(host, host.plan(np.random.default_rng(18), 3, 2, 2, False, 2))
    ep = host.sample_episode_batch(np.random.default_rng(18), 3, 2, 2, False, 2)
    ep_dev = type(ep)(support=ep.support.to(cuda), support_labels=ep.support_labels.to(cuda),
                      query=ep.query.to(cuda), query_labels=ep.query_labels.to(cuda))
    g = torch.Generator(device=cuda).manual_seed(19)
    draws = TrainDraws(support=draw_views_params(g, exp.specaug_params, 2, 6, 96, 99, cuda),
                       query=draw_views_params(g, exp.specaug_params, 2, 6, 96, 99, cuda),
                       perms=torch.stack([torch.randperm(3, device=cuda) + 1 for _ in range(2)]))
    specaugment.views_cuda.launches = 0
    ma, mb = a.train_step(ep_host, draws), b.train_step(ep_dev, draws)
    torch.cuda.synchronize()
    assert specaugment.views_cuda.launches == 4
    torch.testing.assert_close(ma, mb, atol=1e-6, rtol=1e-5)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, atol=1e-6, rtol=1e-5)


def test_classifier_api_on_card_matches_cpu(cuda):
    """The classifier API on the card (views by K1, each encode call one K2
    launch) against the same weights and views on the CPU, float32."""
    from audio_few_shot_learning_tpu_torch.models.classifier_api import PrototypicalNetworks

    exp = ExperimentConfig.from_dict({"specaug_params": {"use": True}, "tpu": {"compute_dtype": "float32"}})
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8}})
    rng = np.random.default_rng(21)
    sup = torch.from_numpy(rng.standard_normal((1, 15, 96, 99)).astype(np.float32)).to(cuda)
    qry = torch.from_numpy(rng.standard_normal((1, 10, 96, 99)).astype(np.float32)).to(cuda)
    labels = np.repeat(np.arange(5), 3)
    gen = torch.Generator(device=cuda).manual_seed(2)
    specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = 0
    sup_v = specaugment.spec_augment_views(sup, gen, exp.specaug_params)[0]
    qry_v = specaugment.spec_augment_views(qry, gen, exp.specaug_params)[0]
    card = PrototypicalNetworks(exp, mdl, generator=torch.Generator().manual_seed(4))
    card.process_support_set(sup_v, labels)
    scores = card(qry_v)
    torch.cuda.synchronize()
    assert scores.device.type == "cuda"
    assert (specaugment.views_cuda.launches, protohead.episode_scores_cuda.launches) == (2, 2)
    cpu = PrototypicalNetworks(exp, mdl, state_dict=card.model.state_dict(), device="cpu")
    cpu.process_support_set(sup_v.cpu(), labels)
    want = cpu(qry_v.cpu())
    torch.testing.assert_close(scores.cpu(), want, atol=1e-3, rtol=0)
    assert (scores.argmax(-1).cpu() == want.argmax(-1)).float().mean() >= 0.99


def test_jax_model_file_tests_on_card(cuda, tmp_path):
    """A JAX package model file (written by ``save_jax_model``) read back by
    ``load_jax_model`` into a Trainer that tests on the card."""
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
    from audio_few_shot_learning_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(22)
    items = rng.standard_normal((6 * 4, 96, 99)).astype(np.float32)
    store = PackedStore.pack(list(items), np.repeat(np.arange(6), 4), device=cuda)
    exp = ExperimentConfig.from_dict({
        "specaug_params": {"use": True}, "n_testing_tasks": 4, "test_query_augmentations": True,
        "n_way_test": 3, "n_shot_test": 2, "n_query_test": 2, "tpu": {"eval_episode_batch": 2},
    })
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": 8}})
    torch.manual_seed(0)
    source = FewShotEpisodeModel(exp, mdl, (96, 99))
    path = str(tmp_path / "model.ckpt")
    ckpt.save_jax_model(path, source.state_dict(), exp)
    with pytest.raises(ValueError, match="convert_checkpoint"):
        ckpt.load_model(path, source)
    trainer = Trainer(exp, mdl, store, test_store=store)
    trainer.model.load_state_dict(ckpt.load_jax_model(path), strict=True)
    specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = convblock.block0_cuda.launches = 0
    convblock.blocks_cuda.launches = 0
    names = (convblock.BLOCK0_FORWARDS, convblock.BLOCK0_KERNEL_FORWARDS, convblock.BLOCKS_FORWARDS,
             convblock.BLOCKS_KERNEL_FORWARDS)
    counts = [read_counter(n) or 0 for n in names]
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0
    # per batch: K1 twice (support, queries), block 0 once (one encoder pass),
    # blocks 1-3 once each (K5, bf16), K2 once
    assert (specaugment.views_cuda.launches, convblock.block0_cuda.launches, convblock.blocks_cuda.launches,
            protohead.episode_scores_cuda.launches) == (4, 2, 6, 2)
    assert [read_counter(n) for n in names] == [counts[0] + 2, counts[1] + 2, counts[2] + 6, counts[3] + 6]
    for key, value in source.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(trainer.model.state_dict()[key].cpu(), value), key


def test_one_rank_nccl_step_matches_the_plain_trainer(cuda, tmp_path):
    """A process group of one rank over NCCL: 2 steps of the dry run's small
    flagship structure at E=4 in chunks of 2 (float32), launches per step K1
    4, K2 2, K3 0, against the plain Trainer (no group) from the same seed:
    epoch loss 1e-4 relative, parameters within 2 x lr a step (an Adam step
    whose sign flips on nondeterministic reductions moves 2 lr)."""
    import dataclasses

    import torch.distributed as dist

    from audio_few_shot_learning_tpu_torch.parallel import dryrun
    from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, make_mesh, maybe_initialize_distributed

    exp, mdl, _ = dryrun.dryrun_configs("small", 4, tasks=8, device="cuda")
    exp = dataclasses.replace(exp, tpu=dataclasses.replace(exp.tpu, episode_microbatch=2))
    store = dryrun.dryrun_store("small", cuda)
    maybe_initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, "nccl")
    try:
        runs = {}
        for name, mesh in (("nccl", make_mesh(1, cuda)), ("plain", EpisodeMesh(0, 1, cuda))):
            trainer = Trainer(exp, mdl, store, seed=0, mesh=mesh)
            specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = mel.mel_log_cuda.launches = 0
            metrics = trainer.train_epoch()
            launches = (specaugment.views_cuda.launches, protohead.episode_scores_cuda.launches,
                        mel.mel_log_cuda.launches)
            assert launches == (8, 4, 0), launches
            runs[name] = (metrics, trainer)
    finally:
        dist.destroy_process_group()
    (m_nccl, t_nccl), (m_plain, t_plain) = runs["nccl"], runs["plain"]
    assert t_nccl.mesh.group is not None and t_plain.mesh.group is None
    np.testing.assert_allclose(m_nccl["loss"], m_plain["loss"], rtol=1e-4)
    plain = dict(t_plain.model.named_parameters())
    for name, p in t_nccl.model.named_parameters():
        torch.testing.assert_close(p, plain[name], atol=2 * 2 * exp.lr, rtol=0, msg=name)


def test_two_ranks_share_one_card_over_gloo(cuda):
    """Two ranks on one card in a gloo group on CUDA tensors: the dry run's
    checks (one step, 4 steps and a gathered eval against one process)
    pass, and each rank launches K1 2, K2 1, K3 0 a step."""
    from audio_few_shot_learning_tpu_torch.parallel import dryrun

    out = dryrun.dryrun_multichip(2, "gloo", "cuda", width="small", per_rank=2, eval_tasks=8, timeout_s=300)
    assert out["launches_per_step"] == [[[2, 1, 0]] * dryrun.STEPS] * 2
    assert out["eval_batch_per_rank"] == [2, 2]
