"""Median host milliseconds a request spends copying its support and query
clips to the device over the untraced window: its ``afsl.h2d`` span (4 MB
from pageable host memory)."""

import statistics

from benchmark import spans


def read(record):
    found = spans.window_spans(record)
    copies = list(spans.by_root(found, "afsl.h2d").values()) if found else []
    return statistics.median(copies) if copies else None
