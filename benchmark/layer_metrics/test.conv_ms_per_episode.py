"""Device milliseconds an eval episode in the ``conv`` kernel family: cuDNN's
convolutions with their layout transposes."""

FAMILY = "conv"


def read(record):
    trace = record["trace"]
    if not trace or not trace.get("families"):
        return None
    return 1e3 * trace["families"].get(FAMILY, 0.0) / (trace["units"] * record["episodes_per_unit"])
