"""Few-shot inference CLI, the serving entry point (PyTorch port).

    python -m audio_few_shot_learning_tpu_torch.cli.predict \
        -e experiment_config.json -m model_config.json \
        --checkpoint experiments/<exp>/model.pt \
        --support /path/support_set --query clip1.wav clip2.npy ... \
        [--norm-stats <dataset>/norm_stats/glob_norm.npy] [--output out.json]

Classifies query items against a user-supplied support set with a trained
checkpoint, through ``Trainer.predict_episode``. ``--checkpoint`` is a
reference-layout ``model.pt`` ``state_dict`` (the JAX package's
``cli/convert_checkpoint.py`` writes one from its ``.ckpt``). Runs on the
card unless the experiment config says ``"device": "cpu"``.

Layout: --support is a directory with one subdirectory per class, each
holding that class's examples. Items may be:
  * .npy 2-D [F, T] spec features (offline to_spec layout); pass
    --norm-stats if they are raw (un-normalized),
  * .npy 3-D [S, F, T] stacked segments (the first segment is used),
  * .npy 1-D or audio files (.wav; .flac/.ogg/.mp3 through ffmpeg) of raw
    audio. For a spec-input model they become log-mel features through the
    offline flavour (to_spec semantics, on the device) and need
    --norm-stats; a wav-input model takes the waveforms, cut or zero-padded
    to the longest support clip, with the mel and --norm-stats' z-norm on
    the device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

AUDIO_EXTS = {".wav", ".flac", ".ogg", ".mp3"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-e", "--experiment_config", required=True)
    p.add_argument("-m", "--model_config", required=True)
    p.add_argument("--checkpoint", required=True, help="reference-layout model.pt state_dict")
    p.add_argument("--support", required=True,
                   help="directory: one subdir per class with example items")
    p.add_argument("--query", required=True, nargs="+",
                   help="query files, or one directory of them")
    p.add_argument("--norm-stats", default=None,
                   help="glob_norm.npy [2,1,1] (mean,std). Required for raw "
                        "audio into spec models; recommended for wav models")
    p.add_argument("--output", default=None, help="write predictions JSON here")
    p.add_argument("--key", type=int, default=0,
                   help="seed for the augmentation draws")
    return p.parse_args(argv)


def _collect_queries(paths):
    out = []
    for q in paths:
        qp = Path(q)
        if qp.is_dir():
            out += sorted(p for p in qp.iterdir() if p.suffix.lower() in AUDIO_EXTS | {".npy"})
        else:
            out.append(qp)
    if not out:
        sys.exit("predict: no query items found")
    return out


class _ItemLoader:
    """Loads one support/query item into the model's input space: a
    normalized ``[F, T]`` feature for a spec model, a waveform for a wav model."""

    def __init__(self, is_wav_model: bool, stats, device):
        self.is_wav = is_wav_model
        self.stats = stats  # (mean, std) or None
        self.device = device
        self._mel = None

    def _offline_mel(self, wave):
        import numpy as np
        import torch

        from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec

        if self.stats is None:
            sys.exit("predict: raw audio into a spec model needs --norm-stats "
                     "(the dataset's glob_norm.npy) to match training normalization")
        if self._mel is None:
            # offline flavour == preprocessing/to_spec.py semantics (librosa's
            # Slaney filterbank), the pipeline that made the training features
            self._mel = MelSpec(flavor="offline")
        feat = self._mel(torch.from_numpy(wave).to(self.device)).cpu().numpy()
        return ((feat - self.stats[0]) / self.stats[1]).astype(np.float32)

    def __call__(self, path: Path):
        import numpy as np

        from audio_few_shot_learning_tpu_torch.config import SAMPLE_RATE

        suffix = path.suffix.lower()
        if suffix == ".npy":
            x = np.load(path)
            if x.ndim == 3:  # stacked segments: deterministic first segment
                x = x[0]
            if x.ndim == 2:
                if self.is_wav:
                    sys.exit(f"predict: {path} is a 2-D feature but the model is wav-input; "
                             "provide raw audio")
                if self.stats is not None:
                    x = (x - self.stats[0]) / self.stats[1]
                return x.astype(np.float32)
            if x.ndim != 1:
                sys.exit(f"predict: {path} is {x.ndim}-D; expected [L], [F, T] or [S, F, T]")
            wave = x.astype(np.float32)  # 1-D raw waveform
        elif suffix in AUDIO_EXTS:
            from audio_few_shot_learning_tpu_torch.preprocessing.audio_io import load_audio

            wave = load_audio(path, sr=SAMPLE_RATE)
        else:
            sys.exit(f"predict: unsupported file type: {path}")
        return wave if self.is_wav else self._offline_mel(wave)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from audio_few_shot_learning_tpu_torch.config import load_configs
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
    from audio_few_shot_learning_tpu_torch.device import config_device
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    exp, mdl = load_configs(args.experiment_config, args.model_config)
    device = config_device(exp)

    stats = None
    if args.norm_stats:
        g = np.load(args.norm_stats).reshape(-1)
        stats = (float(g[0]), float(g[1]))

    is_wav = exp.input_type == "wav"
    loader = _ItemLoader(is_wav, stats, device)

    sup_root = Path(args.support)
    class_names = sorted(d.name for d in sup_root.iterdir() if d.is_dir())
    if len(class_names) < 2:
        sys.exit(f"predict: --support needs >=2 class subdirectories, found {class_names}")
    sup_items, sup_labels = [], []
    for li, name in enumerate(class_names):
        files = sorted(p for p in (sup_root / name).iterdir()
                       if p.suffix.lower() in AUDIO_EXTS | {".npy"})
        if not files:
            sys.exit(f"predict: support class '{name}' has no items")
        for f in files:
            sup_items.append(loader(f))
            sup_labels.append(li)

    query_files = _collect_queries(args.query)
    qry_items = [loader(f) for f in query_files]

    # one input geometry for the whole episode
    if is_wav:
        length = max(len(x) for x in sup_items)
        support, query = (
            np.stack([np.pad(x[:length], (0, max(0, length - len(x)))) for x in items])
            for items in (sup_items, qry_items)
        )
    else:
        shape = sup_items[0].shape
        for x, f in zip(sup_items + qry_items, ["support"] * len(sup_items) + query_files):
            if x.shape != shape:
                sys.exit(f"predict: item {f} has shape {x.shape}, support geometry is {shape}")
        support, query = np.stack(sup_items), np.stack(qry_items)

    # the Trainer takes its input geometry (and, for wav, the z-norm
    # statistics) from a store: the support set
    if is_wav:
        store = PackedWavStore.pack(
            list(support), sup_labels, len(class_names),
            mean=stats[0] if stats else 0.0, std=stats[1] if stats else 1.0, device=device,
        )
    else:
        store = PackedStore.pack(list(support), sup_labels, len(class_names), device=device)
    trainer = Trainer(exp, mdl, store, device=device)
    state = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(state, strict=True)

    pred, scores = trainer.predict_episode(
        support, np.asarray(sup_labels), query, n_way=len(class_names),
        generator=torch.Generator(device=device).manual_seed(args.key),
    )

    results = []
    for f, p, s in zip(query_files, pred, scores):
        order = np.argsort(-s)
        results.append({
            "file": str(f),
            "predicted_class": class_names[int(p)],
            "scores": {class_names[i]: round(float(s[i]), 4) for i in order},
        })
    payload = {"n_way": len(class_names), "classes": class_names,
               "checkpoint": args.checkpoint, "predictions": results}
    text = json.dumps(payload, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
