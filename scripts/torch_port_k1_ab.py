#!/usr/bin/env python3
"""K1 (the SpecAugment 4-view kernel) against an earlier version of itself,
in one process on one card.

    git archive <commit> | tar -x -C build/k1_parent
    python3 scripts/torch_port_k1_ab.py --parent build/k1_parent [--out build/k1_ab.json]
    python3 scripts/torch_port_k1_ab.py --parent scripts/k1_variants/specaugment_bulk_store.cu

Imports nothing of JAX. Builds the earlier K1 source (a checkout's
``audio_few_shot_learning_tpu_torch/csrc/specaugment.cu``, or a ``.cu`` file
given directly) with ``nvcc`` beside this tree's K1. Before its redesign K1's
C entry points took spec, ys, tmask, fmask, out, E, B, F, T, mask_value and
the stream; a source that takes this tree's launch plan too is launched with
``views_plan``. Then at every K1 case of ``chip_smoke.py``'s two kernel
phases (the multi-segment ones at the E the engine took on an 80 GB card),
in float32 and bf16, it:

1. holds both against the plain version (``views_reference``): max error 0;
2. times by CUDA-graph replay (``chip_smoke.graph_ms``), in turns earlier,
   this, this, earlier: the earlier kernel alone (masks converted to
   ``uint8`` beforehand), for K1 before its redesign also its wrapper's call
   as it ran (two mask conversion kernels, then K1), and this tree's
   ``views_cuda``; each figure is the mean of its two turns;
3. reports beside them the plain version's time, the byte bound
   (``chip_smoke.bound_ms``), the launch plan, and the device ops of one
   call under ``torch.profiler`` (this tree's: K1 alone, asserted).

Prints the card's name and power limit and one JSON line, and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (timing and bound helpers; imports no JAX)

# (case, E, B, T, SpecAugment config): the kernel phase's cases, then the
# multi-segment phase's at the E the engine took on an 80 GB card
CASES = (
    ("flagship eval batch", 16, 25, 157, "flagship"),
    ("flagship train step", 1, 25, 157, "flagship"),
    ("nsynth train step", 1, 25, 126, "nsynth"),
    ("nsynth eval batch", 16, 25, 126, "nsynth"),
    ("multi-segment s_max 6", 16, 150, 157, "birdclef"),
    ("multi-segment s_max 36", 3, 900, 157, "birdclef"),
)


def build_parent(parent: str):
    """The earlier K1's library and whether it takes this tree's launch plan
    (rows, tiles, threads, vector width, shared memory) before the stream,
    or only the shapes (K1 before its redesign)."""
    from audio_few_shot_learning_tpu_torch.ops import cuda_build

    src = parent if parent.endswith(".cu") else os.path.join(
        parent, "audio_few_shot_learning_tpu_torch", "csrc", "specaugment.cu")
    with open(src, "rb") as f:
        text = f.read()
    planned = b"tiles_per_item" in text
    out = cuda_build.BUILD_DIR / f"libspecaugment_parent-{hashlib.sha256(text).hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("afsl_specaugment_views_f32", "afsl_specaugment_views_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * (5 if planned else 0) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, planned


def parent_wrappers(lib, planned):
    """The earlier kernel alone (on masks converted to ``uint8`` once, here)
    and, for K1 before its redesign, its wrapper's call as it ran (the masks
    converted on every call); a planned source has no call of its own."""
    import torch

    from audio_few_shot_learning_tpu_torch.ops import cuda_build, specaugment

    def kernel(spec, ys, tm8, fm8, mask_value):
        e, b, f, t = spec.shape
        out = torch.empty((e, b, 4, f, t), device=spec.device, dtype=spec.dtype)
        fn = lib.afsl_specaugment_views_f32 if spec.dtype == torch.float32 else lib.afsl_specaugment_views_bf16
        plan = ()
        if planned:
            sm = torch.cuda.get_device_properties(spec.device).multi_processor_count
            p = specaugment.views_plan(e, b, f, t, spec.element_size(), sm, spec.data_ptr() % 16 == 0)
            plan = (p.rows, p.tiles_per_item, p.threads, p.vec, p.smem_bytes)
        status = fn(cuda_build.ptr(spec), cuda_build.ptr(ys), cuda_build.ptr(tm8), cuda_build.ptr(fm8),
                    cuda_build.ptr(out), e, b, f, t, float(mask_value), *plan,
                    cuda_build.stream_handle(spec.device))
        cuda_build.check_launch(status, "earlier SpecAugment kernel")
        return out

    def call(spec, ys, tmask, fmask, mask_value):
        return kernel(spec.contiguous(), ys.to(torch.float32).contiguous(), tmask.to(torch.uint8).contiguous(),
                      fmask.to(torch.uint8).contiguous(), mask_value)

    return kernel, None if planned else call


def spec_params(name):
    from audio_few_shot_learning_tpu_torch.config import SpecAugParams

    if name == "flagship":
        return SpecAugParams(use=True, mask_param=16, W=22, num_mask=1, mask_value=0.0, p=0.282)
    if name == "birdclef":
        return SpecAugParams(use=True, mask_param=6, W=29, num_mask=1, mask_value=0.0, p=0.298)
    with open(os.path.join(REPO, "configs", "nsynth_cpl.json")) as f:
        return SpecAugParams.from_dict(json.load(f)["specaug_params"])


def run_case(dev, gen, parent_kernel, parent_call, case, e, b, t, prm, dtype):
    import torch

    from audio_few_shot_learning_tpu_torch.ops import specaugment

    f = chip_smoke.N_MELS
    spec = torch.randn((e, b, f, t), generator=gen, device=dev).to(dtype)
    ys, tm, fm = specaugment.draw_views_params(gen, prm, e, b, f, t, dev)
    args = (spec, ys, tm, fm, prm.mask_value)
    kargs = (spec, ys, tm.to(torch.uint8), fm.to(torch.uint8), prm.mask_value)
    ref = specaugment.views_reference(*args)
    errs = {}
    for name, fn, a in (("new", specaugment.views_cuda, args), ("parent", parent_kernel, kargs)):
        out = fn(*a)
        torch.cuda.synchronize()
        errs[name] = (out.float() - ref.float()).abs().max().item()
        del out
    if any(errs.values()):
        raise AssertionError(f"K1 {case} {dtype} at {list(spec.shape)} is not bit-equal to its plain version: {errs}")
    ops = {"new": chip_smoke.device_kernels(lambda: specaugment.views_cuda(*args))}
    if parent_call is not None:
        ops["parent_call"] = chip_smoke.device_kernels(lambda: parent_call(*args))
    if len(ops["new"]) != 1 or "views_kernel" not in ops["new"][0]:
        raise AssertionError(f"K1 {case} {dtype}: one call ran {ops['new']} on the device")
    timed = {"parent_kernel": [], "new": []} | ({} if parent_call is None else {"parent_call": []})
    for turn in ("parent", "new", "new", "parent"):
        if turn == "new":
            timed["new"].append(chip_smoke.graph_ms(lambda: specaugment.views_cuda(*args)))
            continue
        timed["parent_kernel"].append(chip_smoke.graph_ms(lambda: parent_kernel(*kargs)))
        if parent_call is not None:
            timed["parent_call"].append(chip_smoke.graph_ms(lambda: parent_call(*args)))
    plain = chip_smoke.graph_ms(lambda: specaugment.views_reference(*args))
    n_out = e * b * 4 * f * t * spec.element_size()
    b_ms, b_by = chip_smoke.bound_ms(chip_smoke.nbytes(spec, ys, tm, fm) + n_out, 3 * e * b * f * t)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = specaugment.views_plan(e, b, f, t, spec.element_size(), sm, spec.data_ptr() % 16 == 0)
    mean = {k: sum(v) / len(v) for k, v in timed.items()}
    return dict(case=case, shape=[e, b, f, t], dtype=str(dtype).replace("torch.", ""), max_abs_err=errs,
                plan=dict(vec=plan.vec, rows=plan.rows, blocks=plan.blocks, threads=plan.threads,
                          smem_bytes=plan.smem_bytes),
                device_ops_per_call={k: [n[:60] for n in v] for k, v in ops.items()},
                ms=mean["new"], parent_kernel_ms=mean["parent_kernel"], parent_call_ms=mean.get("parent_call"),
                turns_ms=timed, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / mean["new"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the earlier tree, or a K1 source with this tree's C interface")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "k1_ab.json"))
    args = ap.parse_args(argv)

    import torch

    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_port_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda:0")
    card = chip_smoke.card_line()
    print(card, flush=True)
    cuda_build.build(["specaugment"])
    parent_kernel, parent_call = parent_wrappers(*build_parent(args.parent))
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {"card": card, "launch_floor_ms": chip_smoke.launch_floor_ms(dev), "cases": []}
    for case, e, b, t, cfg in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            row = run_case(dev, gen, parent_kernel, parent_call, case, e, b, t, spec_params(cfg), dtype)
            rows["cases"].append(row)
            print(json.dumps({k: row[k] for k in ("case", "dtype", "ms", "parent_kernel_ms", "parent_call_ms",
                                                  "plain_ms", "bound_ms", "share_of_bound")}), flush=True)
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
