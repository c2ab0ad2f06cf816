#!/usr/bin/env python3
"""Train episodes/s with a float32 against a bf16 packed store in the
PyTorch/CUDA port: the port's counterpart of ``scripts/ab_store_dtype.py``.

The store's dtype (``tpu.store_dtype``) sets only how the segments lie on
the card: a sampled episode is upcast on its gather and the compute path
does not change (``tpu.compute_dtype`` sets the conv's), so a bf16 store
halves the gather's and the views' input bytes at the cost of the inputs'
bf16 rounding. For each dtype the store is ``bench.make_store``'s (35
classes x 40 items of 128x157 from ``default_rng(0)``) and the flagship
trains at each E (``bench.bench_train``: one warm-up epoch of 20 steps,
then the best of three), reporting episodes/s and the median step (the
engine's step clock).

    python3 scripts/torch_port_ab_store_dtype.py [--e 1 4] [--repeats 3] [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit, a markdown table and one JSON line.
Runs on ``cuda:0`` unless given ``--device cpu`` (rates then are the CPU's,
not the card's); with no card it raises. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import torch  # noqa: E402

import _torch_port_bench_setup as bench  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

DTYPES = ("float32", "bfloat16")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--e", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "rows": []}
    print(f"card: {out['card']}", flush=True)
    for dtype in DTYPES:
        store = bench.make_store(dtype=dtype, device=device)
        mb = store.segments.numel() * store.segments.element_size() / 1e6
        print(f"store dtype={dtype}: {mb:.0f} MB", flush=True)
        for e in args.e:
            t0 = time.time()
            tr = bench.make_trainer(e, store=store, device=device)
            eps = bench.bench_train(tr, args.repeats)
            row = dict(store_dtype=dtype, store_mb=mb, e=e, eps=eps, step_ms_median=statistics.median(tr.last_step_ms))
            out["rows"].append(row)
            print(f"  E={e}: {eps:.2f} eps/s, step {row['step_ms_median']:.2f} ms  [{time.time() - t0:.0f}s]",
                  flush=True)
    print("\n| store dtype | E | train eps/s | step ms (median) |\n|---|---|---|---|\n" + "\n".join(
        f"| {r['store_dtype']} | {r['e']} | {r['eps']:.2f} | {r['step_ms_median']:.2f} |" for r in out["rows"]),
        flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
