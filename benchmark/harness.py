"""The benchmark's harness: one run of one cell, its last line on stdout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by its name:

* ``configs/<config>.json``: the experiment and model configuration as
  run, and the ``dataset`` group the split is made from;
* ``traffic/<traffic>.json``: the mix's parameters and its ``kind``, the
  generator in ``traffic/<kind>.py`` (``train``, ``test``, ``predict``):
  ``setup(run)`` makes the inputs and the program's state (``state.next``,
  the next unit), ``unit(state, i)`` issues unit i, ``window``, ``finish``,
  ``describe`` and ``check``;
* ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``, and how many units the check samples;
* ``layer_metrics/<metric>.py``: a ``read(record)`` that returns the
  metric from the traced run's record, or None where it finds nothing.

A run: set-up (``setup_s``: process start to the first timed unit; it makes
the inputs from the seed, builds the program's state and warms up the
cell's own shapes), a window of ``--seconds``, with ``--trace 1`` a short
traced stretch after it, then the check against the plain reference
(``reference/``) once the program's state is freed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audio_few_shot_learning_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's entry and its files: ``config``, ``mix``, ``limits``."""
    bench = bench or benchmark_json()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return dict(entry=entry, config=config, mix=mix, cell=cell, bench=bench)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def note(text: str) -> None:
    print(f"benchmark: {text}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Reservoir:
    """A uniform sample of ``k`` of the units seen, chosen from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0

    def take(self) -> int:
        """The slot the next unit goes to, or -1."""
        j = self.seen
        self.seen += 1
        if j < self.k:
            return j
        r = self.rng.randrange(j + 1)
        return r if r < self.k else -1


class Run:
    """What one run knows, handed to the traffic kind and the readers."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device, overrides: Optional[dict],
                 fault: Optional[Callable] = None):
        cell = load_cell(name)
        self.name = name
        self.entry, self.mix, self.limits = cell["entry"], cell["mix"], cell["cell"]
        self.bench = cell["bench"]
        self.config = cell["config"]
        if overrides:
            self.config = _merge(self.config, overrides.get("config", {}))
            self.mix = _merge(self.mix, overrides.get("mix", {}))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.fault = fault  # (stage, object) -> None: a planted fault, for the benchmark's own tests

    def plant(self, stage: str, obj) -> None:
        if self.fault is not None:
            self.fault(stage, obj)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def throughput_window(unit: Callable[[int], None], seconds: float, device, first: int = 0) -> dict:
    """Issue units until ``seconds`` have passed on the host clock, then
    wait for the device: every unit issued, over the whole time."""
    sync(device)
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds:
        unit(i)
        i += 1
    sync(device)
    return dict(first=first, units=i - first, seconds=time.perf_counter() - t0, t0=t0)


def latency_window(unit: Callable[[int], float], seconds: float, first: int = 0) -> dict:
    """A closed loop: each unit returns its own latency in seconds."""
    t0 = time.perf_counter()
    lat = []
    i = first
    while time.perf_counter() - t0 < seconds:
        lat.append(unit(i))
        i += 1
    return dict(first=first, units=i - first, seconds=time.perf_counter() - t0, latencies=lat, t0=t0)


def traced(run: Run, kind, state, first: int) -> dict:
    """``mix.trace_units`` units under ``torch.profiler`` (the device's
    kernels and the host's ops), read into a record: kernel seconds and
    launches by name, busy seconds (the union of the device's intervals)
    over the traced window, idle gaps by the host op under them."""
    from torch.profiler import ProfilerActivity, profile

    n = int(run.mix["trace_units"])
    if not run.cuda:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            kind.unit(state, i)
        return dict(units=n, window_s=time.perf_counter() - t0, busy_s=None, kernels={}, launches={},
                    gaps={}, families={})
    from benchmark.trace import read_profile

    sync(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            with torch.profiler.record_function("bench.unit"):
                kind.unit(state, i)
        sync(run.device)
        window = time.perf_counter() - t0
    rec = read_profile(prof)
    rec.update(units=n, window_s=window)
    return rec


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, t0: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict (and
    under ``"_record"`` what the readers read). ``t0`` is the process's
    start on ``time.perf_counter``'s clock (default: now)."""
    t0 = time.perf_counter() if t0 is None else t0
    run = Run(name, seed, seconds, trace, device, overrides, fault)
    kind = load_module(HERE / "traffic" / f"{run.mix['kind']}.py", f"benchmark_traffic_{run.mix['kind']}")
    t_setup = time.perf_counter()
    state = kind.setup(run)
    t_warm = time.perf_counter()
    for _ in range(int(run.mix["warm_units"])):  # the cell's own shapes, through the window's call
        kind.unit(state, state.next)
        state.next += 1
    sync(run.device)
    setup_s = time.perf_counter() - t0
    note(f"set-up {setup_s:.3f} s: start to set-up {t_setup - t0:.3f}, inputs and program {t_warm - t_setup:.3f}, "
         f"warm-up {t0 + setup_s - t_warm:.3f}")
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way during the window
    window = kind.window(state, run.seconds)
    trace_rec = traced(run, kind, state, window["first"] + window["units"]) if run.trace else None
    gc.unfreeze()
    outcome = kind.finish(state, window)  # reads the program's outputs back; counts failures
    memory_peak = int(torch.cuda.max_memory_allocated(run.device)) if run.cuda else 0
    record = dict(cell=name, window=window, trace=trace_rec, outcome=outcome, **kind.describe(state))
    t_check = time.perf_counter()
    checks = kind.check(state)  # frees the program's state first, then runs the reference
    note(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = _end_to_end(run, outcome, setup_s) if not run.trace else _per_layer(run, record)
    device_info = dict(platform="gpu" if run.cuda else "cpu",
                       kind=torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
                       count=1, memory_peak_bytes=memory_peak)
    result = dict(correct=correct, attempted=outcome["attempted"], failed=outcome["failed"], metrics=metrics,
                  device=device_info)
    if run.trace and trace_rec is not None and run.cuda:
        device_info.update(busy_s=trace_rec["busy_s"], window_s=trace_rec["window_s"])
        result["breakdown"] = trace_rec["breakdown"]
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    result["_record"] = record
    return result


def _end_to_end(run: Run, outcome: dict, setup_s: float) -> dict:
    out = {}
    for m in run.bench["end_to_end"]:
        if m["name"] == "setup_s":
            out["setup_s"] = dict(value=setup_s, unit=m["unit"])
        elif run.name in m.get("workloads", [run.name]) and m["name"] in outcome["metrics"]:
            out[m["name"]] = dict(value=outcome["metrics"][m["name"]], unit=m["unit"])
    return out


def _per_layer(run: Run, record: dict) -> dict:
    out = {}
    for m in run.bench["per_layer"]:
        if run.name not in m.get("workloads", [run.name]):
            continue
        path = HERE / "layer_metrics" / f"{m['name']}.py"
        reader = load_module(path, "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0", t0=t0)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: modules the benchmark may not load are loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    result.pop("_record")
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
