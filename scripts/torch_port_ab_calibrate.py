#!/usr/bin/env python3
"""Band-gain calibration of the A/B's synthetic dataset through the
PyTorch/CUDA port: the port's counterpart of ``scripts/ab_calibrate.py``.

One "ours" run (``torch_port_ab_vs_reference.run_ours_arm``) per band gain
on the A/B's dataset at that gain, to see which gain puts the A/B where a
few-point difference shows (test accuracy well above the 0.2 chance floor
and below saturation). The JAX repo's sweep (``PARITY_AB.md``): 0.45 ->
0.28, 1.2 -> 0.68, 1.6 -> 0.73, 2.0 -> 0.84. Rows are not appended to the
A/B's results; the sweep, beside the JAX repo's, goes into ``--out``'s
calibration section (``PARITY_AB_TORCH.md``) and ``--json`` writes it as
one JSON object.

    python3 scripts/torch_port_ab_calibrate.py [--gains 0.8 1.2 1.6 2.0] [--loss cpl] [--seed 0]
        [--device cuda:0|cpu] [--out PARITY_AB_TORCH.md] [--json FILE]

Runs on ``cuda:0`` unless given ``--device cpu``; with no card it raises.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import tempfile
from pathlib import Path

SCRIPTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("torch_port_ab_vs_reference", SCRIPTS / "torch_port_ab_vs_reference.py")
ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab)

JAX_SWEEP = {0.45: 0.28, 1.2: 0.68, 1.6: 0.73, 2.0: 0.84}  # PARITY_AB.md, the JAX package on a TPU, seed 0
SECTION = "ab_calibrate"


def section(out: dict) -> str:
    """The sweep's markdown section: the port's test accuracy at each gain
    beside the JAX repo's."""
    rows = {g: a for g, a in out["sweep"]}
    lines = ["## Band-gain calibration of the A/B's dataset", "",
             f"`scripts/torch_port_ab_calibrate.py` on {out['card'] or 'the CPU'}: one `ours_torch` run a gain "
             f"({out['loss']}, seed {out['seed']}, {out['epochs']} epochs x {out['tasks']} tasks, "
             f"{out['test_tasks']} test tasks{', multi-segment' if out['multiseg'] else ''}), beside the JAX "
             "package's sweep on a TPU (`scripts/ab_calibrate.py`, recorded in PARITY_AB.md).", "",
             "| band gain | ours_torch test acc | ours_jax test acc (PARITY_AB.md) |", "|---|---|---|"]
    for g in sorted(set(rows) | set(JAX_SWEEP)):
        port = f"{rows[g]:.3f}" if g in rows else "not run"
        jax = f"{JAX_SWEEP[g]:.2f}" if g in JAX_SWEEP else "not run"
        lines.append(f"| {g:g} | {port} | {jax} |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gains", type=float, nargs="+", default=[0.8, 1.2, 1.6, 2.0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--tasks", type=int, default=16)
    ap.add_argument("--test-tasks", type=int, default=150)
    ap.add_argument("--loss", choices=["cpl", "plain"], default="cpl")
    ap.add_argument("--multiseg", action="store_true")
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", default=str(ab.REPORT), help="the markdown file of the calibration section")
    ap.add_argument("--json", help="also write the sweep to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for gain in args.gains:
            root = ab.make_dataset(tmp, gain, args.multiseg)
            row = ab.run_ours_arm(root, args.seed, args.epochs, args.tasks, args.test_tasks, args.loss,
                                  args.multiseg, device)
            row["band_gain"] = gain
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"sweep": [(r["band_gain"], r["test_acc"]) for r in rows], "rows": rows,
           "jax_sweep": sorted(JAX_SWEEP.items()), "loss": args.loss, "seed": args.seed,
           "epochs": args.epochs, "tasks": args.tasks, "test_tasks": args.test_tasks, "multiseg": args.multiseg,
           "card": rows[0]["card"] if rows else None}
    print(json.dumps({"sweep": out["sweep"]}), flush=True)
    ab.write_section(Path(args.out), SECTION, section(out))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
