"""Host milliseconds a train step issuing the backward pass over the
untraced window: ``afsl.backward`` spans over the window's steps."""

from benchmark import spans


def read(record):
    return spans.named_ms_per_unit(record, ("afsl.backward",))
