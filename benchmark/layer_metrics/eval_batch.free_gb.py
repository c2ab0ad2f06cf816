"""The free device memory the multi-segment eval batch rule read when it
reckoned the cell's E, in GB: the program's ``eval.rule_free_bytes``
counter, set by ``Trainer.eval_batch_size``."""

from benchmark import spans


def read(record):
    free = spans.counter("eval.rule_free_bytes")
    return None if free is None else free / 1e9
