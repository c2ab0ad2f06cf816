"""Median host milliseconds a request spends issuing work inside the
program over the untraced window: its ``afsl.predict`` span less the
``afsl.readback`` inside it (where the host waits for the device), plus the
request's own ``afsl.draws`` root spans before it."""

import statistics

from benchmark import spans


def read(record):
    found = spans.window_spans(record)
    if not found:
        return None
    readback = spans.by_root(found, "afsl.readback")
    issue = [spans.ms(r["call"]) - readback.get(r["call"]["id"], 0.0) + r["before_ms"]
             for r in spans.requests(found, "afsl.predict", "afsl.draws")]
    return statistics.median(issue) if issue else None
