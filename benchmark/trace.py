"""Reading a ``torch.profiler`` trace of the card into the record the
per-layer readers take: device seconds and launches by kernel name and by
family, busy seconds (the union of the device's intervals), and the idle
gaps between them by the host operation that was running."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

# cuDNN, cuBLAS and ATen kernel names on sm_90, by what they compute; the
# first family whose words a kernel's name holds (lower case) takes it
FAMILIES = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("pool", ("pool",)),
    ("conv", ("conv", "xmma", "cutlass", "gemm", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "nchwtonhwc",
              "nhwctonchw")),
    ("k1_k2_k3", ("views_kernel", "episode_scores_kernel", "mel_log_kernel")),
    ("fft", ("fft",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill")),
    ("copy", ("memcpy", "memset", "copy")),
)
TOP = 10
SPAN_PREFIX = "bench."  # the benchmark's spans around its calls into the program


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, words in FAMILIES:
        if any(w in low for w in words):
            return family
    return "other"


def kernel_time(trace, word: str):
    """Device seconds and launches of the kernels whose name holds ``word``;
    ``(0.0, 0)`` without a device trace."""
    if not trace or not trace.get("kernels"):
        return 0.0, 0
    names = [n for n in trace["kernels"] if word in n]
    return sum(trace["kernels"][n] for n in names), sum(trace["launches"][n] for n in names)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read_profile(prof) -> dict:
    """Kernels and copies on the device, host ops (times in seconds)."""
    device: List[Tuple[str, float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for evt in prof.events():
        tr = evt.time_range
        if evt.name.startswith(SPAN_PREFIX) or getattr(evt, "is_user_annotation", False):
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                host.append((tr.start * 1e-6, tr.end * 1e-6, evt.name))
            continue  # the benchmark's own spans, mirrored on the device's timeline
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            device.append((evt.name, tr.start * 1e-6, tr.end * 1e-6))
        elif not evt.name.startswith("ProfilerStep"):
            host.append((tr.start * 1e-6, tr.end * 1e-6, evt.name))
    kernels: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    families: Dict[str, float] = {}
    for name, s, e in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s)
        launches[name] = launches.get(name, 0) + 1
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + (e - s)
    busy = _union([(s, e) for _, s, e in device])
    gaps = _gaps_by_host_op(busy, host)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return dict(kernels=kernels, launches=launches, families=families,
                busy_s=sum(e - s for s, e in busy) if busy else 0.0,
                gaps=gaps,
                breakdown=dict(device_ops=[[n[:120], v] for n, v in top(kernels)],
                               idle_gaps=[[n[:120], v] for n, v in top(gaps)]))


def _gaps_by_host_op(busy: List[Tuple[float, float]], host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of each idle gap between the device's busy intervals, summed
    by the innermost host op running at the gap's middle ("host" where none
    is)."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "host"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 400, -1), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        out[name] = out.get(name, 0.0) + (s1 - e0)
    return out
