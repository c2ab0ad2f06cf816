"""The weight bridge between the JAX package's flax variables and this package.

The port's modules carry the reference checkpoint's names, so its
``state_dict`` is a reference ``model.pt``: such a file (or the JAX
package's ``export_reference_state_dict``) loads with ``strict=True``.
``from_jax_variables`` takes a flax ``{"params", "batch_stats"}`` tree,
given as nested dicts of numpy arrays (no JAX needed), to that
``state_dict``; ``to_jax_variables`` is its inverse (the JAX package's
``import_reference_state_dict``). ``build_mapping`` is this package's own
copy of the leaf mapping in the JAX package's ``train/torch_interop.py``.

Layout transforms (flax -> torch): conv kernels ``[kh, kw, I, O]`` ->
``[O, I, kh, kw]``; Linear and recurrent matrices transpose (flax stores
``[in, out]``); BatchNorm and LayerNorm vectors map 1:1. The CNN head's
input rows are permuted from flax's ``(F', T', C)`` flatten to the
reference's ``(C, F', T')`` when ``F' * T' > 1`` (JAX
``train/torch_interop.py:35-43``). The relation head, which no reference
checkpoint has, maps to ``relation_head.{fc1,fc2,fc3,out}``; a grouped-BN
model's head BatchNorm (``bn_grouped``) maps to ``logits.1`` like the plain one.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (collection, flax path, ref key, kind); kind is a str tag or a
# ("head_vector"|"head_matrix", m, C) tuple for the CNN flattened-head permutation
Entry = Tuple[str, Tuple[str, ...], str, Any]


def _to_torch(a: np.ndarray, kind) -> np.ndarray:
    if kind == "conv_kernel":
        return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
    if kind == "matrix":
        return np.ascontiguousarray(np.transpose(a))
    if isinstance(kind, tuple):
        tag, m, c = kind
        if tag == "head_vector":  # flax (m, C) order -> torch (C, m) order
            return np.ascontiguousarray(a.reshape(m, c).T).reshape(-1)
        if tag == "head_matrix":  # flax [(m,C), out] -> torch [out, (C,m)]
            out = a.shape[1]
            return np.ascontiguousarray(a.reshape(m, c, out).transpose(2, 1, 0)).reshape(out, m * c)
        raise ValueError(f"unknown kind {kind!r}")
    return a


def _to_flax(a: np.ndarray, kind) -> np.ndarray:
    """The inverse of ``_to_torch``."""
    if kind == "conv_kernel":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if kind == "matrix":
        return np.ascontiguousarray(np.transpose(a))
    if isinstance(kind, tuple):
        tag, m, c = kind
        if tag == "head_vector":  # torch (C, m) order -> flax (m, C) order
            return np.ascontiguousarray(a.reshape(c, m).T).reshape(-1)
        if tag == "head_matrix":  # torch [out, (C,m)] -> flax [(m,C), out]
            out = a.shape[0]
            return np.ascontiguousarray(a.reshape(out, c, m).transpose(2, 1, 0)).reshape(m * c, out)
        raise ValueError(f"unknown kind {kind!r}")
    return a


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build_mapping(variables: Dict[str, Any]) -> List[Entry]:
    """The full leaf mapping, read off the variables tree's structure
    (encoder family, recurrent depth and direction, attention presence, the
    BN-granularity knob)."""
    params = variables["params"]
    entries: List[Entry] = []

    bk = params["backbone"]
    for name in sorted(bk["ConvEncoder_0"]):
        i = int(name.removeprefix("block"))
        r = f"backbone.encoder.conv_encoder.{i}"
        fp = ("backbone", "ConvEncoder_0", name)
        entries += [
            ("params", fp + ("kernel",), f"{r}.0.weight", "conv_kernel"),
            ("params", fp + ("bias",), f"{r}.0.bias", "vector"),
            ("params", fp + ("BandwidthBatchNorm_0", "scale"), f"{r}.1.weight", "vector"),
            ("params", fp + ("BandwidthBatchNorm_0", "bias"), f"{r}.1.bias", "vector"),
            ("batch_stats", fp + ("BandwidthBatchNorm_0", "mean"), f"{r}.1.running_mean", "vector"),
            ("batch_stats", fp + ("BandwidthBatchNorm_0", "var"), f"{r}.1.running_var", "vector"),
        ]

    if "seq_layers" in bk:  # Hybrid encoder
        for dname in sorted(bk["seq_layers"]):
            layer = int(dname[1 : dname.index("_")])
            suffix = "_reverse" if dname.endswith("_bwd") else ""
            r = "backbone.encoder.seq_layers"
            fp = ("backbone", "seq_layers", dname)
            entries += [
                ("params", fp + ("w_ih",), f"{r}.weight_ih_l{layer}{suffix}", "matrix"),
                ("params", fp + ("w_hh",), f"{r}.weight_hh_l{layer}{suffix}", "matrix"),
                ("params", fp + ("b_ih",), f"{r}.bias_ih_l{layer}{suffix}", "vector"),
                ("params", fp + ("b_hh",), f"{r}.bias_hh_l{layer}{suffix}", "vector"),
            ]

    head = bk["_LogitsHead_0"]
    bn = "bn_grouped" if "bn_grouped" in head else "BatchNorm_0"
    hp = ("backbone", "_LogitsHead_0")
    vec_kind, mat_kind = "vector", "matrix"
    if "seq_layers" not in bk:
        c = int(np.shape(_get(bk, ("ConvEncoder_0", "block3", "kernel")))[-1])
        width = int(np.shape(_get(head, (bn, "scale")))[0])
        if width % c != 0:
            raise ValueError(f"CNN head width {width} is not a multiple of the conv channels {c}")
        m = width // c
        if m > 1:
            vec_kind, mat_kind = ("head_vector", m, c), ("head_matrix", m, c)
    entries += [
        ("params", hp + (bn, "scale"), "backbone.encoder.logits.1.weight", vec_kind),
        ("params", hp + (bn, "bias"), "backbone.encoder.logits.1.bias", vec_kind),
        ("batch_stats", hp + (bn, "mean"), "backbone.encoder.logits.1.running_mean", vec_kind),
        ("batch_stats", hp + (bn, "var"), "backbone.encoder.logits.1.running_var", vec_kind),
        ("params", hp + ("Dense_0", "kernel"), "backbone.encoder.logits.2.weight", mat_kind),
        ("params", hp + ("Dense_0", "bias"), "backbone.encoder.logits.2.bias", "vector"),
    ]

    if "attention" in params:
        r = "attention_model.encoder_layer"
        ap = ("attention",)
        entries += [
            ("params", ap + ("in_proj", "kernel"), f"{r}.self_attn.in_proj_weight", "matrix"),
            ("params", ap + ("in_proj", "bias"), f"{r}.self_attn.in_proj_bias", "vector"),
            ("params", ap + ("out_proj", "kernel"), f"{r}.self_attn.out_proj.weight", "matrix"),
            ("params", ap + ("out_proj", "bias"), f"{r}.self_attn.out_proj.bias", "vector"),
            ("params", ap + ("linear1", "kernel"), f"{r}.linear1.weight", "matrix"),
            ("params", ap + ("linear1", "bias"), f"{r}.linear1.bias", "vector"),
            ("params", ap + ("linear2", "kernel"), f"{r}.linear2.weight", "matrix"),
            ("params", ap + ("linear2", "bias"), f"{r}.linear2.bias", "vector"),
            ("params", ap + ("norm1", "scale"), f"{r}.norm1.weight", "vector"),
            ("params", ap + ("norm1", "bias"), f"{r}.norm1.bias", "vector"),
            ("params", ap + ("norm2", "scale"), f"{r}.norm2.weight", "vector"),
            ("params", ap + ("norm2", "bias"), f"{r}.norm2.bias", "vector"),
        ]

    if "relation" in params:  # no reference layout: the port's own keys
        for name in ("fc1", "fc2", "fc3", "out"):
            entries += [
                ("params", ("relation", name, "kernel"), f"relation_head.{name}.weight", "matrix"),
                ("params", ("relation", name, "bias"), f"relation_head.{name}.bias", "vector"),
            ]

    pp = ("projection",)
    entries += [
        ("params", pp + ("fc1", "kernel"), "projection_head.fc1.weight", "matrix"),
        ("params", pp + ("fc1", "bias"), "projection_head.fc1.bias", "vector"),
        ("params", pp + ("fc2", "kernel"), "projection_head.fc2.weight", "matrix"),
        ("params", pp + ("fc2", "bias"), "projection_head.fc2.bias", "vector"),
    ]
    return entries


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree (nested dicts of numpy arrays)
    -> this package's ``state_dict`` (= the reference ``model.pt`` layout),
    ready for ``load_state_dict(strict=True)``. The reference's dead state
    (BatchNorm ``num_batches_tracked``, the unused ``projection_head.ln1/ln2``)
    is emitted at torch's fresh-init values."""
    sd: Dict[str, torch.Tensor] = {}
    for coll, path, rkey, kind in build_mapping(variables):
        leaf = np.asarray(_get(variables[coll], path), dtype=np.float32)
        sd[rkey] = torch.from_numpy(_to_torch(leaf, kind).copy())
    for name in sorted(variables["params"]["backbone"]["ConvEncoder_0"]):
        i = int(name.removeprefix("block"))
        sd[f"backbone.encoder.conv_encoder.{i}.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    sd["backbone.encoder.logits.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    hidden = sd["projection_head.fc1.weight"].shape[0]
    out_dim = sd["projection_head.fc2.weight"].shape[0]
    for ln, width in (("ln1", hidden), ("ln2", out_dim)):
        sd[f"projection_head.{ln}.weight"] = torch.ones(width)
        sd[f"projection_head.{ln}.bias"] = torch.zeros(width)
    return sd


# the reference's dead state, which the flax tree has no slot for
_DEAD_SUFFIXES = ("num_batches_tracked",)
_DEAD_PREFIXES = ("projection_head.ln1.", "projection_head.ln2.")


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _skeleton(sd: Dict[str, np.ndarray], exp) -> Dict[str, Any]:
    """The parts of the flax tree that ``build_mapping`` reads, from the
    state_dict's keys: conv blocks, recurrent layers and directions,
    attention, the relation head, and the head BatchNorm's name
    (``bn_grouped`` under ``tpu.bn_per_view_group``) and width."""
    bk: Dict[str, Any] = {}
    params: Dict[str, Any] = {"backbone": bk}
    for key, val in sd.items():
        m = re.fullmatch(r"backbone\.encoder\.conv_encoder\.(\d+)\.0\.weight", key)
        if m:
            _set(bk, ("ConvEncoder_0", f"block{m.group(1)}", "kernel"), np.empty(_to_flax(val, "conv_kernel").shape))
        m = re.fullmatch(r"backbone\.encoder\.seq_layers\.weight_ih_l(\d+)(_reverse)?", key)
        if m:
            _set(bk, ("seq_layers", f"l{m.group(1)}_{'bwd' if m.group(2) else 'fwd'}"), {})
        if key.startswith("attention_model."):
            params["attention"] = {}
        if key.startswith("relation_head."):
            params["relation"] = {}
    if "ConvEncoder_0" not in bk:
        raise KeyError("the state_dict has no backbone.encoder.conv_encoder weights")
    bn = "bn_grouped" if exp.tpu.bn_per_view_group else "BatchNorm_0"
    head_bn = sd["backbone.encoder.logits.1.weight"]
    _set(bk, ("_LogitsHead_0", bn, "scale"), np.empty(head_bn.shape))
    return {"params": params, "batch_stats": {}}


def refuse_ast(exp) -> None:
    """Raise for an ``AST`` experiment: the JAX package has no such encoder,
    so no flax tree holds its weights."""
    if exp.encoder_name == "AST":
        raise ValueError("encoder_name 'AST': the JAX package has no AST encoder, so its model files "
                         "cannot be converted to or from the JAX package's")


def to_jax_variables(state_dict: Dict[str, Any], exp) -> Dict[str, Any]:
    """This package's ``state_dict`` (a reference ``model.pt``) -> the flax
    ``{"params", "batch_stats"}`` tree of the JAX package's model for
    ``exp``, as nested dicts of float32 numpy arrays with sorted keys.

    The tree's structure comes from the state_dict's keys and
    ``exp.tpu.bn_per_view_group``; each leaf is the inverse of its
    ``from_jax_variables`` transform. The reference's dead state
    (``num_batches_tracked``, ``projection_head.ln1/ln2``) is dropped. Every
    other key must find a slot, and every slot a key. An AST model has no
    counterpart in the JAX package and is refused by name."""
    refuse_ast(exp)
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in state_dict.items()}
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    used = set()
    for coll, path, rkey, kind in build_mapping(_skeleton(sd, exp)):
        if rkey not in sd:
            raise KeyError(f"the state_dict is missing {rkey!r} (for {coll}/{'/'.join(path)})")
        _set(out[coll], path, _to_flax(np.asarray(sd[rkey], np.float32), kind))
        used.add(rkey)
    stray = sorted(k for k in sd if k not in used and not k.endswith(_DEAD_SUFFIXES)
                   and not k.startswith(_DEAD_PREFIXES))
    if stray:
        raise ValueError(f"state_dict keys with no slot in the flax tree: {stray}")
    return _sorted(out)
