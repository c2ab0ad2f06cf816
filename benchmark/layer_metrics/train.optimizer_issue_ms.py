"""Host milliseconds a train step in the optimizer over the untraced window:
``afsl.optimizer`` spans (zeroing the gradients; the all-reduce, the
learning rate and Adam's step) over the window's steps."""

from benchmark import spans


def read(record):
    return spans.named_ms_per_unit(record, ("afsl.optimizer",))
