"""Share of the eval-mode block-0 forwards on the card that launched the
block-0 kernel (K4), in %: the program's ``eval.block0_kernel_forwards``
counter over its ``eval.block0_forwards``, both set by
``ConvBlock._block`` (``ops/convblock.py::count_block0``). None where the
program keeps no such counters, as an earlier program does not."""

from benchmark import spans


def read(record):
    forwards = spans.counter("eval.block0_forwards")
    if not forwards:
        return None
    return 100.0 * (spans.counter("eval.block0_kernel_forwards") or 0) / forwards
