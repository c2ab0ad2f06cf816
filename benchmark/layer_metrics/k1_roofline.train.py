"""K1's share of its roofline, in percent: the byte bound of every launch in
the traced stretch (the input read once, the four views written once, in
the dtype K1 is fed; ``roofline.k1_bytes``) over the device seconds of
the ``views_kernel`` launches."""

from benchmark import roofline
from benchmark.trace import kernel_time

KERNEL = "views_kernel"


def read(record):
    trace = record["trace"]
    seconds, launches = kernel_time(trace, KERNEL)
    per_unit = record["launches"][KERNEL]
    if not launches or launches != len(per_unit) * trace["units"]:
        return None  # not this cell's launches: the kernel left the path or was merged
    bound = trace["units"] * sum(roofline.bound_seconds(cost) for cost in per_unit)
    return 100.0 * bound / seconds
