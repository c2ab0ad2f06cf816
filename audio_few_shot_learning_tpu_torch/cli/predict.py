"""Few-shot inference CLI, the serving entry point (PyTorch port).

    python -m audio_few_shot_learning_tpu_torch.cli.predict \
        -e experiment_config.json -m model_config.json \
        --checkpoint experiments/<exp>/model.pt \
        --support /path/support_set --query clip1.npy clip2.npy ... \
        [--norm-stats <dataset>/norm_stats/glob_norm.npy] [--output out.json]

Classifies query items against a user-supplied support set with a trained
checkpoint, through ``Trainer.predict_episode``. ``--checkpoint`` is a
reference-layout ``model.pt`` ``state_dict`` (the JAX package's
``cli/convert_checkpoint.py`` writes one from its ``.ckpt``). Runs on the
card unless the experiment config says ``"device": "cpu"``.

Layout: --support is a directory with one subdirectory per class, each
holding that class's examples as ``.npy`` spec features, 2-D ``[F, T]`` or
3-D ``[S, F, T]`` stacked segments (the first segment is used); pass
--norm-stats if they are raw (un-normalized). Raw audio needs the mel kernel
(K3), which a later slice ports.
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
                   help="glob_norm.npy [2,1,1] (mean,std) for raw features")
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


def _load_item(path: Path, stats):
    import numpy as np

    if path.suffix.lower() in AUDIO_EXTS:
        sys.exit(f"predict: {path} is raw audio; turning it into a spec needs the mel "
                 "kernel (K3), a later slice of the port — pass .npy spec features")
    if path.suffix.lower() != ".npy":
        sys.exit(f"predict: unsupported file type: {path}")
    x = np.load(path)
    if x.ndim == 3:  # stacked segments: deterministic first segment
        x = x[0]
    if x.ndim != 2:
        sys.exit(f"predict: {path} is raw audio ({x.ndim}-D); turning it into a spec needs "
                 "the mel kernel (K3), a later slice of the port")
    if stats is not None:
        x = (x - stats[0]) / stats[1]
    return x.astype(np.float32)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from audio_few_shot_learning_tpu_torch.config import load_configs
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer, resolve_device

    exp, mdl = load_configs(args.experiment_config, args.model_config)
    if exp.input_type == "wav":
        sys.exit("predict: wav-input models need the mel kernel (K3), a later slice of the port")
    device = resolve_device(exp)

    stats = None
    if args.norm_stats:
        g = np.load(args.norm_stats).reshape(-1)
        stats = (float(g[0]), float(g[1]))

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
            sup_items.append(_load_item(f, stats))
            sup_labels.append(li)

    query_files = _collect_queries(args.query)
    qry_items = [_load_item(f, stats) for f in query_files]

    shape = sup_items[0].shape
    for x, f in zip(sup_items + qry_items, ["support"] * len(sup_items) + query_files):
        if x.shape != shape:
            sys.exit(f"predict: item {f} has shape {x.shape}, support geometry is {shape}")
    support, query = np.stack(sup_items), np.stack(qry_items)

    # the Trainer takes its input geometry from a store: the support set
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
