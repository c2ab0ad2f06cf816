"""Episodes a batch as the engine's eval batch rule reckons them
(``Trainer.eval_batch_size``) for the cell's split, as the window ran."""


def read(record):
    return record.get("eval_batch")
