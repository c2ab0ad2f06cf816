#!/usr/bin/env python3
"""The port's hand-written kernels against their plain PyTorch versions at
the JAX repo's A/B shapes: the port's counterpart of ``scripts/ab_pallas.py``.

* K1, SpecAugment's 4 views (``ops/specaugment.py::views_cuda``) against
  ``views_reference`` at E=8 episodes of B=50 items of 128x157, float32 (the
  JAX script's ``ab_specaugment``), on the same draws;
* K2, the episode head (``ops/protohead.py::episode_scores_cuda``) against
  ``batched_episode_scores_reference`` and against ``torch.cdist`` on
  prototypes computed beforehand (not the same function: the prototypes
  are not in its time), at E=8 and E=32, S=Q=25, D=256, 5-way, labels drawn
  at random (the JAX script's ``ab_protohead``).

Each is timed by CUDA-graph replay (``chip_smoke.graph_ms``: 20 calls
captured, replayed 5 times between CUDA events, so the host's issue is not
in the time) beside its bound (``chip_smoke.bound_ms``: bytes over 3.35
TB/s or float32 operations over 67 TFLOP/s), with the largest difference
from the plain version. ``ab_pallas.py --full`` also trained the step with
the kernels switched off; the port has no kernel switch (a wrapper launches
its kernel for every CUDA tensor and runs the plain version only on the
CPU), so that half is not ported.

    python3 scripts/torch_port_ab_kernels.py [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit and one JSON line. Runs on
``cuda:0`` unless given ``--device cpu`` (where both sides are the plain
version and nothing is timed); with no card it raises. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (timing and bound helpers; imports no JAX)
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

K1_SHAPE = (8, 50, 128, 157)  # E, B, F, T
K2_CASES = ((8, 25, 25, 256), (32, 25, 25, 256))  # E, S, Q, D
N_WAY = 5
K2_TOL = (chip_smoke.K2_ATOL, chip_smoke.K2_RTOL)


def timed(fn, cuda: bool):
    return chip_smoke.graph_ms(fn) if cuda else None


def ab_specaugment(device, shape=K1_SHAPE) -> dict:
    from audio_few_shot_learning_tpu_torch.config import SpecAugParams
    from audio_few_shot_learning_tpu_torch.ops import specaugment

    params = SpecAugParams(use=True, mask_param=16, W=22, num_mask=1, mask_value=0.0, p=0.282)
    e, b, f, t = shape
    specs = torch.as_tensor(np.random.default_rng(0).standard_normal(shape), dtype=torch.float32).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    ys, tm, fm = specaugment.draw_views_params(gen, params, e, b, f, t, device)
    cuda = device.type == "cuda"
    kernel = specaugment.views_cuda if cuda else specaugment.views_reference
    plain = lambda: specaugment.views_reference(specs, ys, tm, fm, params.mask_value)  # noqa: E731
    fast = lambda: kernel(specs, ys, tm, fm, params.mask_value)  # noqa: E731
    err = (fast() - plain()).abs().max().item()
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version by {err}")
    out = fast()
    b_ms, b_by = chip_smoke.bound_ms(chip_smoke.nbytes(specs, ys, tm, fm, out), 0)
    return dict(shape=list(shape), kernel_ms=timed(fast, cuda), plain_ms=timed(plain, cuda), bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, tolerance=0.0)


def ab_protohead(device, e: int, s: int, q: int, d: int) -> dict:
    from audio_few_shot_learning_tpu_torch.ops import protohead

    rng = np.random.default_rng(1)
    sup = torch.as_tensor(rng.standard_normal((e, s, d)), dtype=torch.float32).to(device)
    qry = torch.as_tensor(rng.standard_normal((e, q, d)), dtype=torch.float32).to(device)
    lab = torch.as_tensor(rng.integers(0, N_WAY, (e, s)), dtype=torch.int32).to(device)
    cuda = device.type == "cuda"
    kernel = protohead.episode_scores_cuda if cuda else protohead.batched_episode_scores_reference
    fast = lambda: kernel(sup, lab, qry, N_WAY)  # noqa: E731
    plain = lambda: protohead.batched_episode_scores_reference(sup, lab, qry, N_WAY)  # noqa: E731
    got, want = fast(), plain()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=K2_TOL[0], rtol=K2_TOL[1]):
        raise AssertionError(f"K2 E={e} differs from its plain version by {err}")
    protos = protohead.compute_prototypes(sup, lab, N_WAY)
    flops = e * (s * d + q * N_WAY * 2 * d + q * 2 * d + N_WAY * 3 * d)
    b_ms, b_by = chip_smoke.bound_ms(chip_smoke.nbytes(sup, qry, lab, got), flops)
    return dict(e=e, s=s, q=q, d=d, n_way=N_WAY, kernel_ms=timed(fast, cuda), plain_ms=timed(plain, cuda),
                cdist_on_precomputed_prototypes_ms=timed(lambda: torch.cdist(qry, protos), cuda),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, tolerance=list(K2_TOL))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.utils.profiling import kernel_counters

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "launch_floor_ms": chip_smoke.launch_floor_ms(device) if device.type == "cuda" else None}
    print(f"card: {out['card']}", flush=True)
    before = [k.launches for k in kernel_counters()]
    out["specaugment"] = ab_specaugment(device)
    out["protohead"] = [ab_protohead(device, *case) for case in K2_CASES]
    out["kernel_launches"] = [k.launches - b for k, b in zip(kernel_counters(), before)]
    if device.type == "cuda" and not all(out["kernel_launches"][:2]):
        raise AssertionError(f"K1 and K2 launched {out['kernel_launches'][:2]} times")
    k1 = out["specaugment"]
    if k1["kernel_ms"] is not None:
        print(f"specaugment E=8 B=50: kernel {k1['kernel_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
              f"bound {k1['bound_ms']:.4f} ms, max|kernel-plain| = {k1['max_abs_err']:.1e}", flush=True)
        for r in out["protohead"]:
            print(f"protohead E={r['e']} S={r['s']} Q={r['q']} D={r['d']}: kernel {r['kernel_ms']:.5f} ms, "
                  f"plain {r['plain_ms']:.5f} ms, cdist {r['cdist_on_precomputed_prototypes_ms']:.5f} ms, "
                  f"max|kernel-plain| = {r['max_abs_err']:.1e}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
