"""Device milliseconds a train step in the ``batchnorm`` kernel family
(``trace.FAMILIES``): train-mode BatchNorm's forward and backward."""

FAMILY = "batchnorm"


def read(record):
    trace = record["trace"]
    if not trace or not trace.get("families"):
        return None
    return 1e3 * trace["families"].get(FAMILY, 0.0) / (trace["units"] * 1)
