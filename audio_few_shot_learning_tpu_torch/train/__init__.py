"""The engine (training, evaluation, prediction), optimizer and schedule,
checkpoints, early stopping, the experiment driver and the weight bridge.

The names the JAX package's ``train`` exports, but for its ``TrainState``
and ``create_train_state`` (a flax train state; here the model, its
optimizer and schedule live on the ``Trainer``)."""

from audio_few_shot_learning_tpu_torch.train.early_stopping import EarlyStopping  # noqa: F401
from audio_few_shot_learning_tpu_torch.train.engine import Trainer  # noqa: F401
from audio_few_shot_learning_tpu_torch.train.evaluate import (  # noqa: F401
    majority_vote_accuracy,
    majority_vote_accuracy_host,
)
