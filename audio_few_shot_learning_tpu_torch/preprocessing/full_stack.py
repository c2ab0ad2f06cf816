"""Full-stack per-dataset preprocessing pipelines.

Counterpart of the JAX package's ``preprocessing/full_stack.py``: one
callable per MetaAudio dataset, chaining sort -> npy + norm -> (prune) ->
spec / var-spec -> glob_norm, splits and waveform statistics, with the
reference's parameters (full_stack_ESC.py:40-45: sr 16000, 128 mels, n_fft
1024, hop 512, power 2; segments of 5 s, NSynth's 4 s).

The log-mel runs on the card unless a pipeline is given ``device="cpu"``
(``--device cpu``); with no card and no such request it raises before any
file is written.

Usage:
    python -m audio_few_shot_learning_tpu_torch.preprocessing.full_stack voxceleb /data/VoxCeleb1 [wav_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import torch

from audio_few_shot_learning_tpu_torch.preprocessing import folder_sort
from audio_few_shot_learning_tpu_torch.preprocessing.make_splits import compute_waveform_norm, make_splits
from audio_few_shot_learning_tpu_torch.preprocessing.norm_stats import compute_global_norm
from audio_few_shot_learning_tpu_torch.preprocessing.to_np_and_norm import wav_dir_to_npy
from audio_few_shot_learning_tpu_torch.preprocessing.to_spec import npy_dir_to_spec
from audio_few_shot_learning_tpu_torch.preprocessing.to_var_spec import npy_dir_to_var_spec
from audio_few_shot_learning_tpu_torch.device import resolve_device

SR = 16000
Device = Union[str, torch.device, None]


def _finish(main_dir: Path, spec_dir: Path, npy_dir: Path, dataset: str) -> None:
    """The files the loader reads besides the features: glob_norm, the
    seeded class split and the waveform statistics."""
    compute_global_norm(spec_dir, main_dir / "norm_stats" / "glob_norm.npy")
    make_splits(spec_dir, main_dir / "splits.npy", dataset=dataset)
    compute_waveform_norm(npy_dir, main_dir / "norm_stats" / "waveform_norm.npy")


def full_stack_esc(main_dir: Union[str, Path], device: Device = None) -> None:
    device = resolve_device(device)
    main_dir = Path(main_dir)
    sorted_dir = folder_sort.sort_esc50(main_dir)
    npy_dir = main_dir / "Sorted_npy"
    wav_dir_to_npy(sorted_dir, npy_dir, sr=SR)
    spec_dir = main_dir / "features"
    npy_dir_to_spec(npy_dir, spec_dir, sample_length=5, device=device)
    _finish(main_dir, spec_dir, npy_dir, "esc")


def full_stack_kaggle(main_dir: Union[str, Path], device: Device = None) -> None:
    device = resolve_device(device)
    main_dir = Path(main_dir)
    sorted_dir = folder_sort.sort_kaggle18(main_dir)
    npy_dir = main_dir / "Sorted_npy"
    wav_dir_to_npy(sorted_dir, npy_dir, sr=SR)
    # FSD2018 is variable length: stacked 5 s segments (full_stack_KAGGLE.py)
    spec_dir = main_dir / "features"
    npy_dir_to_var_spec(npy_dir, spec_dir, length_s=5, device=device)
    _finish(main_dir, spec_dir, npy_dir, "kaggle")


def full_stack_nsynth(main_dir: Union[str, Path], device: Device = None) -> None:
    device = resolve_device(device)
    main_dir = Path(main_dir)
    sorted_dir = folder_sort.sort_nsynth(main_dir)
    npy_dir = main_dir / "Sorted_nsynth_npy"
    wav_dir_to_npy(sorted_dir, npy_dir, sr=SR)
    spec_dir = main_dir / "features"
    npy_dir_to_spec(npy_dir, spec_dir, sample_length=4, device=device)  # NSynth is 4 s
    _finish(main_dir, spec_dir, npy_dir, "nsynth")


def full_stack_birdclef(
    main_dir: Union[str, Path], wav_dir: Optional[Union[str, Path]] = None, device: Device = None
) -> None:
    """BirdClef: class-foldered raw audio at ``wav_dir`` (the raw
    distribution is foldered by species)."""
    device = resolve_device(device)
    main_dir = Path(main_dir)
    wav_dir = Path(wav_dir) if wav_dir else main_dir / "audio"
    npy_dir = main_dir / "Sorted_npy"
    wav_dir_to_npy(wav_dir, npy_dir, sr=SR)
    folder_sort.prune_birdclef(npy_dir, time_thresh_s=180.0, class_thresh=50, sr=SR)
    spec_dir = main_dir / "features"
    npy_dir_to_var_spec(npy_dir, spec_dir, length_s=5, device=device)
    _finish(main_dir, spec_dir, npy_dir, "birdclef")


def full_stack_voxceleb(
    main_dir: Union[str, Path], wav_dir: Optional[Union[str, Path]] = None, device: Device = None
) -> None:
    device = resolve_device(device)
    main_dir = Path(main_dir)
    wav_dir = Path(wav_dir) if wav_dir else main_dir / "audio"
    npy_dir = main_dir / "Sorted_npy"
    wav_dir_to_npy(wav_dir, npy_dir, sr=SR)
    spec_dir = main_dir / "features"
    npy_dir_to_var_spec(npy_dir, spec_dir, length_s=5, device=device)
    _finish(main_dir, spec_dir, npy_dir, "voxceleb")


_PIPELINES = {
    "esc": full_stack_esc,
    "kaggle": full_stack_kaggle,
    "fsd2018": full_stack_kaggle,
    "nsynth": full_stack_nsynth,
    "birdclef": full_stack_birdclef,
    "voxceleb": full_stack_voxceleb,
}
_TAKES_WAV_DIR = ("birdclef", "voxceleb")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="full_stack", description=__doc__.split("\n\n")[0])
    parser.add_argument("dataset", choices=sorted(_PIPELINES))
    parser.add_argument("dataset_dir")
    parser.add_argument("wav_dir", nargs="?", help="class-foldered raw audio (birdclef, voxceleb)")
    parser.add_argument("--device", default=None, help="'cpu' to run the log-mel on the CPU")
    args = parser.parse_args(argv)
    extra = {}
    if args.wav_dir is not None:
        if args.dataset not in _TAKES_WAV_DIR:
            parser.error(f"{args.dataset} takes no wav_dir")
        extra["wav_dir"] = args.wav_dir
    _PIPELINES[args.dataset](args.dataset_dir, device=args.device, **extra)


if __name__ == "__main__":
    main()
