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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_few_shot_learning_tpu_torch.config import (  # noqa: E402
    ExperimentConfig, ModelConfig, SpecAugParams,
)
from audio_few_shot_learning_tpu_torch.data.store import PackedStore  # noqa: E402
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore  # noqa: E402
from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment  # noqa: E402
from audio_few_shot_learning_tpu_torch.train.engine import Trainer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 25, 128, 157), (1, 3, 37, 1000), (2, 1, 1, 31)])
def test_specaugment_kernel_matches_plain(cuda, dtype, shape):
    e, b, f, t = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = SpecAugParams(use=True, mask_param=16, W=min(22, t // 3), num_mask=2, p=0.282)
    spec = (3 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    draws = specaugment.draw_views_params(gen, params, e, b, f, t, cuda)
    before = specaugment.views_cuda.launches
    out = specaugment.views_cuda(spec, *draws, -0.5)
    ref = specaugment.views_reference(spec, *draws, -0.5)
    torch.cuda.synchronize()
    assert specaugment.views_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (e, b, 4, f, t)
    # identical separately rounded arithmetic: equal to the bit
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


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


def test_protohead_kernel_refuses_too_many_classes(cuda):
    sup = torch.zeros((1, 4, 256), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        protohead.episode_scores_cuda(sup, torch.zeros((1, 4), device=cuda, dtype=torch.long), sup, 60)


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
    specaugment.views_cuda.launches = protohead.episode_scores_cuda.launches = 0
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0
    assert (specaugment.views_cuda.launches, protohead.episode_scores_cuda.launches) == (4, 2)


@pytest.mark.parametrize("flavor", ["online", "offline"])
@pytest.mark.parametrize("lead,length", [
    ((16 * 50,), 80000),  # the flagship eval batch: M = 125 600
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
