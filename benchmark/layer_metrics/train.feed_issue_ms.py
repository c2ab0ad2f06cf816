"""Host milliseconds a train step in the sampler and the draws over the
untraced window: ``afsl.sample`` and ``afsl.draws`` spans (the outermost of
them) over the window's steps."""

from benchmark import spans


def read(record):
    return spans.named_ms_per_unit(record, ("afsl.sample", "afsl.draws"))
