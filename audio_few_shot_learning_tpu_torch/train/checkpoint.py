"""Checkpoints of the PyTorch package, and the JAX package's model files.

* ``model.ckpt``: the best-by-validation model's ``state_dict`` (the
  reference checkpoint's keys, so it is also a reference ``model.pt``);
* ``resume_run{i}.ckpt`` + ``.meta.json``: everything a resumed run needs to
  replay the rest of the run: the model, the optimizer, the schedule's step
  count, the generator state of every rank of the trainer's mesh (``[W, n]``
  bytes; rank 0 writes the files), and (in the meta file) the epoch and the
  early-stopping counters.

Files are written with ``torch.save`` and hold tensors and plain Python
data only, so they load with ``weights_only=True``.

The JAX package names its model file ``model.ckpt`` too, but writes it as
flax msgpack (``{"params": ..., "batch_stats": ...}``). ``save_jax_model``
and ``load_jax_model`` write and read that format through
``utils/msgpack_codec.py`` and the weight bridge (``train/weights.py``);
``load_model`` given such a file raises and names
``cli/convert_checkpoint.py``, which converts between the two.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables, to_jax_variables
from audio_few_shot_learning_tpu_torch.utils import msgpack_codec


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


def is_jax_model_file(path: str) -> bool:
    """Whether ``path`` holds flax msgpack (the JAX package's ``model.ckpt``)
    rather than a ``torch.save`` file, by its first bytes."""
    with open(path, "rb") as f:
        return msgpack_codec.is_msgpack_map(f.read(16))


def load_model(path: str, model: torch.nn.Module) -> None:
    if is_jax_model_file(path):
        raise ValueError(
            f"{path} is a JAX package checkpoint (flax msgpack), not a torch state_dict; read it "
            "with train/checkpoint.py::load_jax_model or convert it with "
            "python -m audio_few_shot_learning_tpu_torch.cli.convert_checkpoint"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)


def save_jax_model(path: str, state_dict: Dict[str, torch.Tensor], exp) -> None:
    """``state_dict`` as the JAX package's ``model.ckpt`` for ``exp``'s
    model: flax msgpack of ``{"params": ..., "batch_stats": ...}``, which
    its ``train/checkpoint.py::load_model`` reads."""
    data = msgpack_codec.packb(to_jax_variables(state_dict, exp))  # sorted keys, as flax writes them
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _float32_leaves(tree):
    if isinstance(tree, dict):
        return {k: _float32_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # a bfloat16 leaf
        return tree.to(torch.float32).numpy()
    return np.asarray(tree, np.float32)


def load_jax_model(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's ``model.ckpt`` at ``path`` as this package's
    ``state_dict`` (``load_state_dict(strict=True)`` takes it)."""
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    if not (isinstance(payload, dict) and set(payload) == {"params", "batch_stats"}):
        raise ValueError(f"{path} holds no {{'params', 'batch_stats'}} map: not a JAX package model file")
    return from_jax_variables(_float32_leaves(payload))


def save_resume(path: str, trainer, epoch: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """The trainer's full training state after ``epoch``; ``extra`` (plain
    JSON data, e.g. the early-stopping counters) goes to the meta file. On
    a mesh every rank calls it (the generator states are gathered) and
    rank 0 writes."""
    mesh = trainer.mesh
    state = trainer.gen.get_state()
    generators = mesh.gather(state[None].long(), [mesh.rank], mesh.world).to("cpu", torch.uint8)
    if mesh.rank != 0:
        return
    payload = {
        "model": _cpu(trainer.model.state_dict()),
        "optimizer": _cpu(trainer.optimizer.state_dict()),
        "step": int(trainer.step),
        "generator": generators,
    }
    _save(payload, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": int(epoch), **(extra or {})}, f)


def load_resume(path: str, trainer) -> Dict[str, Any]:
    """Restore ``trainer`` from ``save_resume``'s files, each rank its own
    generator; returns the meta. The checkpoint must come from a run of as
    many ranks."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    generators = payload["generator"]
    if generators.dim() == 1:  # written before checkpoints held one state per rank
        generators = generators[None]
    if len(generators) != trainer.mesh.world:
        raise ValueError(f"{path} resumes a run of {len(generators)} ranks, not {trainer.mesh.world}")
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.step = int(payload["step"])
    trainer.gen.set_state(generators[trainer.mesh.rank].clone())
    with open(path + ".meta.json") as f:
        return json.load(f)
