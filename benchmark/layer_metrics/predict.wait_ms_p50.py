"""Median milliseconds a request's host waits for the device over the
untraced window: its ``afsl.readback`` span, the scores' copy back, which
blocks until the card has finished the request."""

import statistics

from benchmark import spans


def read(record):
    found = spans.window_spans(record)
    waits = list(spans.by_root(found, "afsl.readback").values()) if found else []
    return statistics.median(waits) if waits else None
