"""The engine (training, evaluation, prediction), optimizer and schedule,
checkpoints, early stopping, the experiment driver and the weight bridge."""
