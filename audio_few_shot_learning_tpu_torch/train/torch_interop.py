"""Reference-checkpoint interop: a reference ``model.pt`` state_dict <-> a
port model (counterpart of the JAX package's ``train/torch_interop.py``).

The port's modules carry the reference's names (``train/weights.py``), so
its ``state_dict`` is already a reference ``model.pt``: export is a numpy
copy of it, and import is a strict load under the JAX function's rules.

* ``export_reference_state_dict(model)`` -> ``{reference key: numpy
  array}``, float32 (the BatchNorm counters int64), the dead state
  included: ``projection_head.ln1/ln2`` (LayerNorms the reference defines
  but never applies) and every ``num_batches_tracked``.
* ``import_reference_state_dict(state_dict, model)`` loads a reference
  state_dict (torch tensors or numpy arrays) into a copy of ``model``, or
  into ``model`` itself with ``inplace=True``. Every key of the leaf
  mapping (``weights.build_mapping``) must be present (``KeyError``) with
  the model's shape (``ValueError`` naming the key); a key outside the
  mapping that is not the reference's dead state raises ``ValueError``
  listing them. The dead state is ignored and the model keeps its own.

A relation-head model has no reference counterpart (the reference reserves
the flag and ships no implementation); both functions refuse it, as the JAX
package's do.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from audio_few_shot_learning_tpu_torch.train.weights import (  # noqa: F401
    _DEAD_PREFIXES,
    _DEAD_SUFFIXES,
    Entry,
    _skeleton,
    build_mapping,
)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _mapped_keys(model: nn.Module) -> List[str]:
    """The reference keys of ``model``'s leaf mapping."""
    if getattr(model, "relation_head", None) is not None:
        raise ValueError(
            "relation_head models have no reference counterpart (the reference reserves the config flag "
            "but ships no implementation) — there is no torch checkpoint format to map"
        )
    own = {k: _np(v) for k, v in model.state_dict().items()}
    return [rkey for _, _, rkey, _ in build_mapping(_skeleton(own, model.exp))]


def export_reference_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s state_dict as a reference-keyed ``{key: numpy array}``
    that the reference model's ``load_state_dict(strict=True)`` accepts:
    floating tensors as float32, the BatchNorm counters as int64."""
    _mapped_keys(model)  # refuses a model with no reference layout
    out = {}
    for key, value in model.state_dict().items():
        value = value.detach().cpu()
        out[key] = value.float().numpy() if value.is_floating_point() else value.numpy().copy()
    return out


def import_reference_state_dict(state_dict: Dict[str, Any], model: nn.Module, inplace: bool = False) -> nn.Module:
    """Load a reference state_dict into a copy of ``model`` (``model`` itself
    with ``inplace``) and return it; ``model`` gives the structure and the
    dtypes. Strict as the JAX function: missing keys, shape mismatches and
    stray keys raise; the reference's dead state is ignored."""
    own = model.state_dict()
    sd = {k: _np(v) for k, v in state_dict.items()}
    mapped = _mapped_keys(model)
    loaded = dict(own)
    for key in mapped:
        if key not in sd:
            raise KeyError(f"reference checkpoint is missing '{key}'")
        want = tuple(own[key].shape)
        if tuple(sd[key].shape) != want:
            raise ValueError(
                f"shape mismatch for '{key}': checkpoint {tuple(sd[key].shape)} vs model {want} — "
                "do the -e/-m configs (and --feat-shape) match the checkpoint's?"
            )
        loaded[key] = torch.from_numpy(np.array(sd[key])).to(own[key].dtype)
    used = set(mapped)
    stray = sorted(k for k in sd if k not in used and not k.endswith(_DEAD_SUFFIXES)
                   and not k.startswith(_DEAD_PREFIXES))
    if stray:
        raise ValueError(
            f"reference checkpoint has keys this model has no slot for: {stray} "
            "— wrong encoder_name / use_attention / seq config?"
        )
    target = model if inplace else copy.deepcopy(model)
    target.load_state_dict(loaded, strict=True)
    return target
