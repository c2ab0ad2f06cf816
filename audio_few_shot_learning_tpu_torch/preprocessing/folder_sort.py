"""Per-dataset class-folder sorters and BirdClef pruning.

Counterpart of the JAX package's ``preprocessing/folder_sort.py``, after the
reference's offline_preprocessing/folder_scripts/*:

* ESC-50: meta/esc50.csv (filename, category) -> Sorted/<category>/
  (folder_sort_ESC.py:72-109);
* FSDKaggle2018: the train and test post-competition CSVs (fname, label)
  merged into one Sorted/ tree (folder_sort_KAGGLE18.py:67-105);
* NSynth: nsynth-{train,valid,test}/examples.json sorted by instrument
  string (folder_sort_NSYNTH.py:118-148);
* BirdClef pruning: drop samples longer than ``time_thresh_s``, then
  classes with fewer than ``class_thresh`` samples (pruning_BirdClef.py:35-121).

CSV files are read with the standard ``csv`` module.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np


def _copy_rows(csv_path: Path, file_col: str, label_col: str, src_dir: Path, out_dir: Path):
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            cls_dir = out_dir / row[label_col]
            cls_dir.mkdir(parents=True, exist_ok=True)
            src = src_dir / row[file_col]
            if src.exists():
                shutil.copyfile(src, cls_dir / src.name)


def sort_esc50(main_dir: Union[str, Path]) -> Path:
    main_dir = Path(main_dir)
    out = main_dir / "Sorted"
    out.mkdir(exist_ok=True)
    _copy_rows(main_dir / "meta" / "esc50.csv", "filename", "category", main_dir / "audio", out)
    return out


def sort_kaggle18(main_dir: Union[str, Path]) -> Path:
    main_dir = Path(main_dir)
    meta = main_dir / "FSDKaggle2018.meta"
    out = main_dir / "Sorted"
    out.mkdir(exist_ok=True)
    _copy_rows(meta / "test_post_competition_scoring_clips.csv", "fname", "label",
               main_dir / "FSDKaggle2018.audio_test", out)
    _copy_rows(meta / "train_post_competition.csv", "fname", "label",
               main_dir / "FSDKaggle2018.audio_train", out)
    return out


def sort_nsynth(main_dir: Union[str, Path]) -> Path:
    main_dir = Path(main_dir)
    out = main_dir / "Sorted_nsynth"
    out.mkdir(exist_ok=True)
    for sub in ("nsynth-train", "nsynth-test", "nsynth-valid"):
        meta_path = main_dir / sub / "examples.json"
        if not meta_path.exists():
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        for key, entry in meta.items():
            # class = the full instrument string, e.g. "bass_acoustic_000"
            cls_dir = out / entry["instrument_str"]
            cls_dir.mkdir(exist_ok=True)
            src = main_dir / sub / "audio" / f"{key}.wav"
            if src.exists():
                shutil.copyfile(src, cls_dir / src.name)
    return out


def prune_birdclef(
    main_dir: Union[str, Path],
    time_thresh_s: float = 180.0,
    class_thresh: int = 50,
    sr: int = 16000,
    remove: bool = True,
    log_fn=print,
) -> List[Tuple[str, str]]:
    """Prune over-long samples, then under-populated classes, over a
    class-foldered npy tree. Returns the removed files as ``(class,
    file_name)`` rows (the reference writes them to remove_files.csv)."""
    main_dir = Path(main_dir)
    bad = []
    for cls in sorted(os.listdir(main_dir)):
        cdir = main_dir / cls
        if not cdir.is_dir():
            continue
        for fname in os.listdir(cdir):
            if not fname.endswith(".npy"):
                continue
            length_s = np.load(cdir / fname, mmap_mode="r").shape[0] / sr
            if length_s > time_thresh_s:
                bad.append((cls, fname))
                if remove:
                    os.remove(cdir / fname)
    if remove:
        n_valid = 0
        for cls in sorted(os.listdir(main_dir)):
            cdir = main_dir / cls
            if not cdir.is_dir():
                continue
            files = os.listdir(cdir)
            if len(files) < class_thresh:
                for fname in files:
                    bad.append((cls, fname))
                    os.remove(cdir / fname)
                os.rmdir(cdir)
            else:
                n_valid += 1
        log_fn(f"Number of classes Remaining: {n_valid}")
    return bad
