"""Generate a synthetic dataset in the reference on-disk layout, for smoke
runs and benchmarks (the reference ships no data). The files are the JAX
package's CLI's for the same arguments.

    python -m audio_few_shot_learning_tpu_torch.cli.make_synthetic_dataset --root /tmp/synth_ds
"""

from __future__ import annotations

import argparse

from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--n-classes", type=int, default=20)
    p.add_argument("--items-per-class", type=int, default=20)
    p.add_argument("--n-mels", type=int, default=128)
    p.add_argument("--n-frames", type=int, default=157)
    p.add_argument("--multi-segm", action="store_true")
    p.add_argument("--max-segments", type=int, default=4)
    p.add_argument("--splits", type=int, nargs=3, default=(10, 5, 5))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    root = make_synthetic_dataset(
        args.root,
        n_classes=args.n_classes,
        items_per_class=args.items_per_class,
        n_mels=args.n_mels,
        n_frames=args.n_frames,
        multi_segm=args.multi_segm,
        max_segments=args.max_segments,
        split_fractions=tuple(args.splits),
        seed=args.seed,
    )
    print(f"Synthetic dataset written to {root}")
    return root


if __name__ == "__main__":
    main()
