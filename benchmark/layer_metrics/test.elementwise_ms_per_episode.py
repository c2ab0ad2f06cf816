"""Device milliseconds an eval episode in the ``elementwise`` kernel family:
block 0's separate bias ``add_``, the ReLUs and the other pointwise ops."""

FAMILY = "elementwise"


def read(record):
    trace = record["trace"]
    if not trace or not trace.get("families"):
        return None
    return 1e3 * trace["families"].get(FAMILY, 0.0) / (trace["units"] * record["episodes_per_unit"])
