"""Checkpoints of the PyTorch package (its own format; the JAX package's
flax msgpack files are not read, its weights cross over through
``train/weights.py::from_jax_variables``).

* ``model.ckpt``: the best-by-validation model's ``state_dict`` (the
  reference checkpoint's keys, so it is also a reference ``model.pt``);
* ``resume_run{i}.ckpt`` + ``.meta.json``: everything a resumed run needs to
  replay the rest of the run: the model, the optimizer, the schedule's step
  count, the trainer's generator state, and (in the meta file) the epoch and
  the early-stopping counters.

Files are written with ``torch.save`` and hold tensors and plain Python
data only, so they load with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save(payload, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a crash mid-write leaves the previous file whole


def save_model(path: str, model: torch.nn.Module) -> None:
    _save(_cpu(model.state_dict()), path)


def load_model(path: str, model: torch.nn.Module) -> None:
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)


def save_resume(path: str, trainer, epoch: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """The trainer's full training state after ``epoch``; ``extra`` (plain
    JSON data, e.g. the early-stopping counters) goes to the meta file."""
    payload = {
        "model": _cpu(trainer.model.state_dict()),
        "optimizer": _cpu(trainer.optimizer.state_dict()),
        "step": int(trainer.step),
        "generator": trainer.gen.get_state(),
    }
    _save(payload, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": int(epoch), **(extra or {})}, f)


def load_resume(path: str, trainer) -> Dict[str, Any]:
    """Restore ``trainer`` from ``save_resume``'s files; returns the meta."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.step = int(payload["step"])
    trainer.gen.set_state(payload["generator"])
    with open(path + ".meta.json") as f:
        return json.load(f)
