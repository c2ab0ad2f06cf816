"""Patience-based stopping criterion on validation accuracy.

Behavioral parity target: reference callbacks/early_stopping.py:15-70 —
a best-checkpoint is written on the first epoch and whenever accuracy
reaches at least best+``delta``; a warning is emitted once the stall reaches
80% of the patience budget; the run stops when the budget is exhausted.
Checkpoint IO is delegated to ``save_fn`` so the trainer owns the format.
This is the PyTorch package's own copy of the JAX package's module; its
counters round-trip through ``state_dict`` / ``load_state_dict`` so a
resumed run continues the same patience budget.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_GREEN, _RED, _RESET = "\033[92m", "\033[91m", "\033[0m"


class EarlyStopping:
    """Tracks the best validation accuracy seen and a stall counter.

    Call once per epoch with the epoch's validation accuracy. Attributes:

    - ``early_stop``: True once ``patience`` consecutive epochs failed to
      reach the best score plus ``delta``.
    - ``counter``: current stall length (reset to 0 on improvement).
    - ``val_accuracy_max``: accuracy at the last checkpoint write.
    """

    def __init__(
        self,
        patience: int = 7,
        verbose: bool = False,
        delta: float = 0.0,
        save_fn: Optional[Callable[[], None]] = None,
        trace_func: Callable = print,
    ):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.save_fn = save_fn
        self.trace_func = trace_func
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.val_accuracy_max = -float("inf")

    def __call__(self, val_accuracy: float, epoch: int) -> None:
        # ">=": a score exactly at best+delta re-checkpoints (reference parity).
        improved = self.best_score is None or val_accuracy >= self.best_score + self.delta
        if improved:
            self.best_score = val_accuracy
            self.counter = 0
            self._checkpoint(val_accuracy, epoch)
            return
        self.counter += 1
        if self.counter >= int(0.8 * self.patience):
            self.trace_func(
                f"Epoch: {epoch}. No val-accuracy improvement for "
                f"{self.counter}/{self.patience} epochs"
            )
        if self.counter >= self.patience:
            self.early_stop = True

    def _checkpoint(self, val_accuracy: float, epoch: int) -> None:
        if self.verbose:
            prev = self.val_accuracy_max
            gain_pct = (val_accuracy - prev) / prev * 100 if prev > 0 else 0.0
            tint = _GREEN if gain_pct > 0 else _RED
            self.trace_func(
                f"Epoch {epoch}: new best val accuracy "
                f"{val_accuracy:.6f} (was {prev:.6f}, "
                f"{tint}{gain_pct:+.2f}%{_RESET}) — checkpointing"
            )
        if self.save_fn is not None:
            self.save_fn()
        self.val_accuracy_max = val_accuracy

    def state_dict(self) -> Dict[str, Any]:
        return {
            "counter": self.counter,
            "best_score": self.best_score,
            "early_stop": self.early_stop,
            "val_accuracy_max": self.val_accuracy_max,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.counter = int(state["counter"])
        self.best_score = state["best_score"]
        self.early_stop = bool(state["early_stop"])
        self.val_accuracy_max = float(state["val_accuracy_max"])
