"""Share of the untraced window's time in which the card had no kernel or
copy to run, in percent: 1 - the device's busy seconds a unit (the union of
its kernel and copy intervals over the traced stretch of eval batches, over
the units traced) over the window's wall seconds a unit (all its time over
all its units). The profiler stretches the traced stretch's wall, not its
kernels, so the untraced window's wall is the one that holds the host's
share; the traced stretch's own share is the line's ``busy_s`` over
``window_s``."""


def read(record):
    trace, window = record["trace"], record["window"]
    if not trace or not trace.get("busy_s") or not window["units"]:
        return None
    busy = trace["busy_s"] / trace["units"]
    wall = window["seconds"] / window["units"]
    return 100.0 * (1.0 - busy / wall)
