"""Median device milliseconds a train step over the untraced window: the
intervals between consecutive CUDA events the program records at the start
of each ``afsl.train_step`` span."""

from benchmark import spans


def read(record):
    return spans.step_ms_median(record, "afsl.train_step")
