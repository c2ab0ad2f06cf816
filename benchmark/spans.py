"""The program's own spans, step marks and counters (the port's
``utils/profiling.py`` recorder), as the per-layer readers take them: the
records whose start lies in the untraced window ``[t0, t0 + seconds]`` on
``time.perf_counter``'s clock, less those taken while the profiler recorded
(it stretches the host). Each function returns None where the program has
no recorder, as an earlier program has not, or the window holds nothing to
read."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional


def _window_ns(record: dict):
    w = record["window"]
    return int(w["t0"] * 1e9), int((w["t0"] + w["seconds"]) * 1e9)


def window_spans(record: dict) -> Optional[List[dict]]:
    """The window's untraced span records, oldest first."""
    try:
        from audio_few_shot_learning_tpu_torch.utils.profiling import read_spans
    except ImportError:
        return None
    lo, hi = _window_ns(record)
    spans = [s for s in read_spans() if lo <= s["start_ns"] <= hi and not s["traced"]]
    return spans or None


def ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def outermost(spans: List[dict], names: Iterable[str]) -> List[dict]:
    """The spans named in ``names`` whose parent is not named in them, so
    that nested spans of those names count once."""
    names = set(names)
    name_of: Dict[int, str] = {s["id"]: s["name"] for s in spans}
    return [s for s in spans if s["name"] in names and name_of.get(s["parent"]) not in names]


def roots(spans: List[dict]) -> List[dict]:
    return [s for s in spans if s["parent"] is None]


def ms_per_unit(record: dict, spans: Optional[List[dict]]) -> Optional[float]:
    """The spans' host milliseconds over the window's units."""
    units = record["window"]["units"]
    if not spans or not units:
        return None
    return sum(ms(s) for s in spans) / units


def named_ms_per_unit(record: dict, names: Iterable[str]) -> Optional[float]:
    spans = window_spans(record)
    return ms_per_unit(record, outermost(spans, names) if spans else None)


def step_ms_median(record: dict, label: str) -> Optional[float]:
    """Median milliseconds between the window's consecutive step marks of
    ``label`` on the device's clock."""
    try:
        from audio_few_shot_learning_tpu_torch.utils.profiling import mark_intervals
    except ImportError:
        return None
    lo, hi = _window_ns(record)
    kept = [m["ms"] for m in mark_intervals(label) if lo <= m["start_ns"] <= hi and not m["traced"]]
    return statistics.median(kept) if kept else None


def counter(name: str):
    try:
        from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter
    except ImportError:
        return None
    return read_counter(name)


def by_root(spans: List[dict], name: str) -> Dict[int, float]:
    """Milliseconds of the spans named ``name`` summed by their root."""
    out: Dict[int, float] = {}
    for s in spans:
        if s["name"] == name:
            out[s["root"]] = out.get(s["root"], 0.0) + ms(s)
    return out


def requests(spans: List[dict], call: str, before: str) -> List[dict]:
    """One entry a request: each root span named ``call`` with the root
    spans named ``before`` that ran since the previous request's call (the
    caller's draws): ``call`` (the root), ``before_ms``."""
    out, pending = [], 0.0
    for s in sorted(roots(spans), key=lambda s: s["start_ns"]):
        if s["name"] == before:
            pending += ms(s)
        elif s["name"] == call:
            out.append(dict(call=s, before_ms=pending))
            pending = 0.0
    return out
