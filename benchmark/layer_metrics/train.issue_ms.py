"""Host milliseconds a train step inside the program over the untraced
window: the summed time of the root spans the benchmark's unit opens
(``afsl.sample``, ``afsl.draws``, ``afsl.train_step``) over the window's
steps. It holds the time the host is blocked on a full launch queue inside
those spans as well as its own issue: back to back, a host that runs ahead
of the device waits inside the program, so this reads issue alone only
while the device keeps up with the host."""

from benchmark import spans


def read(record):
    found = spans.window_spans(record)
    return spans.ms_per_unit(record, spans.roots(found) if found else None)
