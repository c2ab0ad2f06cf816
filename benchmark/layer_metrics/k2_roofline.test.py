"""K2's share of its roofline, in percent: the larger of its bytes over the
card's bandwidth and its float32 operations over the float32 peak
(``roofline.k2_cost``), over the device seconds of the
``episode_scores_kernel`` launches."""

from benchmark import roofline
from benchmark.trace import kernel_time

KERNEL = "episode_scores_kernel"


def read(record):
    trace = record["trace"]
    seconds, launches = kernel_time(trace, KERNEL)
    per_unit = record["launches"][KERNEL]
    if not launches or launches != len(per_unit) * trace["units"]:
        return None  # not this cell's launches: the kernel left the path or was merged
    bound = trace["units"] * sum(roofline.bound_seconds(*cost) for cost in per_unit)
    return 100.0 * bound / seconds
