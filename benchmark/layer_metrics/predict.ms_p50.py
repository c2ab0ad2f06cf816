"""Median latency of the untraced window's requests, host clock from the
call to the returned numpy arrays, in milliseconds."""

import statistics


def read(record):
    ms = record.get("unit_ms")
    return statistics.median(ms) if ms else None
