"""Share of the eval-mode forwards on the card of conv blocks 1-3 (a block
of as many input as output channels) that launched their kernel (K5), in %:
the program's ``eval.blocks123_kernel_forwards`` counter over its
``eval.blocks123_forwards``, both set by ``ConvBlock._block``
(``ops/convblock.py::count_blocks``). None where the program keeps no such
counters, as an earlier program does not."""

from benchmark import spans


def read(record):
    forwards = spans.counter("eval.blocks123_forwards")
    if not forwards:
        return None
    return 100.0 * (spans.counter("eval.blocks123_kernel_forwards") or 0) / forwards
