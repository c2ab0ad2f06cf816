"""Profiling: a ``torch.profiler`` trace around a block, the episodes/s
counter (counterpart of the JAX package's ``utils/profiling.py``), the
kernels' launch counts per call of a method (``launches_per_call``), and
what a measurement script records beside its numbers (``card``, the card's
name and power limit; ``rss_gb``, the process's peak resident set).

``profile_trace`` records the host's ops and, for work on the card, its
kernels and copies, and writes a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and ``chrome://tracing`` read) into
``log_dir``. Unlike the JAX package's, which turns a trace that cannot
start or be written into a no-op, it raises: a profile that silently
records nothing would hide what the device did.

The span recorder names the host's time inside the program. ``span(name)``
is a context manager cheap enough to stay on (``spanned(name)`` wraps a
function in one): each span records its name, its start and end on
``time.perf_counter_ns()``, its parent (the span open when it started) and
its root (the outermost open span; a span opened with none open is its own
root), into a bounded ring in memory. While a ``torch.profiler`` records, a
span also enters ``torch.profiler.record_function(name)``, so it sits on the
profiler's timeline beside the kernels it issued; its record is then flagged
``traced``, as the profiler stretches the host's time. A span does no device
work, never synchronizes and draws nothing from any generator. The program's
span names start with ``afsl.``. Counters (``set_counter``, ``read_counter``)
live in the same registry. Step marks (``mark``, ``mark_intervals``) are a
CUDA event on the card, the host clock on the CPU: ``Trainer.train_step``
makes one as its ``afsl.train_step`` span opens, ``Trainer.train_epoch``
closes the epoch's last interval, and the intervals are read after the
device has passed the marks. One host thread issues the program's work, and
the recorder assumes it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import resource
import subprocess
import time
from typing import Dict, List, Optional, Union

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device: Union[str, torch.device, None] = None):
    """Trace the block into ``log_dir``; yields the ``torch.profiler``
    profile (None when not ``enabled``). CUDA activities are traced when
    ``device`` is a card, or, with no ``device``, when a card is present."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)  # raises where log_dir cannot be made
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)


SPAN_RING = 1 << 16  # records kept: a 20-s window of the busiest cell (~5 000 requests of 8 spans)
MARK_RING = 1 << 13  # step marks kept: an epoch's steps, or a 20-s window of train steps
_perf_ns = time.perf_counter_ns
_profiler_on = torch.autograd._profiler_enabled


class Recorder:
    """The spans' ring, the counters and the step marks. A span's
    id is its start on ``time.perf_counter_ns``: one thread opens spans, a
    microsecond or more apart, so no two share it."""

    def __init__(self, capacity: int = SPAN_RING, marks: int = MARK_RING):
        # (name, start_ns, end_ns, parent's start_ns or None, root's start_ns, traced)
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.counters: Dict[str, object] = {}
        # (seq, label, start_ns, CUDA event or None, end, traced)
        self.marks: collections.deque = collections.deque(maxlen=marks)
        self.marks_made = 0
        self.open: List[tuple] = []  # the open spans: (start_ns, root's start_ns, traced, record_function)

    def mark(self, device, label: str, end: bool = False) -> None:
        """A step boundary under ``label``: a CUDA event recorded on
        ``device``'s current stream, or on the CPU the host clock. ``end``
        closes the interval of the mark before it and opens none."""
        start_ns = _perf_ns()
        evt = None
        if torch.device(device).type == "cuda":
            evt = torch.cuda.Event(enable_timing=True)
            evt.record(torch.cuda.current_stream(device))
        self.marks.append((self.marks_made, label, start_ns, evt, end, _profiler_on()))
        self.marks_made += 1

    def mark_intervals(self, label: str, first: int = 0) -> List[dict]:
        """Each kept mark of ``label`` from mark number ``first`` on that a
        later mark of ``label`` closes: ``seq``, ``start_ns``, ``traced`` and
        ``ms`` to the next mark (CUDA events' elapsed time, or the host
        clock's). Read it once the device has passed the marks."""
        kept = [m for m in self.marks if m[1] == label]
        out = []
        for (seq, _, start, evt, end, traced), nxt in zip(kept, kept[1:]):
            if end or seq < first:
                continue
            ms = evt.elapsed_time(nxt[3]) if evt is not None else (nxt[2] - start) / 1e6
            out.append(dict(seq=seq, start_ns=start, ms=ms, traced=traced))
        return out

    def spans(self) -> List[dict]:
        """The ring's records, oldest first, as dicts."""
        return [dict(id=start, name=name, start_ns=start, end_ns=end, parent=parent, root=root, traced=traced)
                for name, start, end, parent, root, traced in self.records]


class _Span:
    """A span's name; the open span's state lives on the recorder's stack,
    so one object serves every call of a site, nested or not."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        traced = _profiler_on()
        rf = None
        if traced:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        stack = RECORDER.open
        start = _perf_ns()
        stack.append((start, stack[-1][1] if stack else start, traced, rf))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = _perf_ns()
        rec = RECORDER
        stack = rec.open
        start, root, traced, rf = stack.pop()
        rec.records.append((self.name, start, end, stack[-1][0] if stack else None, root, traced))
        if rf is not None:
            rf.__exit__(exc_type, exc, tb)
        return False


RECORDER = Recorder()
_SPANS: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span named ``name``, for a ``with`` block."""
    found = _SPANS.get(name)
    if found is None:
        found = _SPANS[name] = _Span(name)
    return found


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    site = span(name)

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with site:
                return fn(*args, **kwargs)

        return inner

    return wrap


def read_spans() -> List[dict]:
    """The recorder's span records, oldest first: ``id`` (= ``start_ns``),
    ``name``, ``start_ns``, ``end_ns`` (``time.perf_counter_ns``), ``parent``
    (the enclosing span's id, None for a root), ``root`` (the outermost
    enclosing span's id, its own for a root), ``traced`` (taken while a
    profiler recorded)."""
    return RECORDER.spans()


def mark(device, label: str, end: bool = False) -> None:
    RECORDER.mark(device, label, end)


def marks_made() -> int:
    """Step marks made so far: the ``first`` of the next mark."""
    return RECORDER.marks_made


def mark_intervals(label: str, first: int = 0) -> List[dict]:
    return RECORDER.mark_intervals(label, first)


def set_counter(name: str, value) -> None:
    RECORDER.counters[name] = value


def read_counter(name: str):
    """The counter's last value, None if never set."""
    return RECORDER.counters.get(name)


class EpisodeThroughput:
    """Exponentially smoothed episodes/s."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.total_episodes = 0

    def update(self, episodes: int, seconds: float) -> float:
        eps = episodes / max(seconds, 1e-9)
        self.total_episodes += episodes
        self.value = eps if self.value is None else self.alpha * eps + (1 - self.alpha) * self.value
        return self.value


def kernel_counters() -> tuple:
    """The wrappers of K1 (SpecAugment views), K2 (episode scores) and K3
    (mel + log); each counts its kernel's launches in ``.launches``."""
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    return specaugment.views_cuda, protohead.episode_scores_cuda, mel.mel_log_cuda


def tally_launches(rows: List[List[int]]) -> Dict[str, int]:
    """``{"K1 K2 K3": calls}``: how many recorded calls launched each
    pattern of K1, K2, K3 launches."""
    return {" ".join(map(str, k)): n for k, n in collections.Counter(map(tuple, rows)).items()}


@contextlib.contextmanager
def launches_per_call(owner, name: str, out: List[List[int]]):
    """While the block runs, each call of ``owner.name`` (a method of a
    class, e.g. ``Trainer.train_step``) appends the K1, K2, K3 launches it
    made to ``out``, read off the counters around the call."""
    counters = kernel_counters()
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        before = [k.launches for k in counters]
        result = fn(*args, **kwargs)
        out.append([k.launches - b for k, b in zip(counters, before)])
        return result

    setattr(owner, name, counted)
    try:
        yield out
    finally:
        setattr(owner, name, fn)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": None, "error": str(e)}
    return {"nvidia_smi": line.splitlines()[0] if line else line}


def rss_gb() -> float:
    """Peak resident set of this process so far, GB (``ru_maxrss`` is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
