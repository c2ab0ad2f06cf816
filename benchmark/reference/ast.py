"""Plain PyTorch reference of the prototypical network with the Audio
Spectrogram Transformer as its backbone, written from the paper (Gong, Chung
and Glass, Interspeech 2021, arXiv:2104.01778) and its code
(github.com/YuanGongND/ast, ``src/models/ast_models.py::ASTModel``, which
runs timm's ``vit_deit_base_distilled_patch16_384``). It imports no module of
the port or of the JAX package; the view fusion, the projection, CPL, Adam,
the schedule and the float8 control are ``reference/model.py``'s, unchanged.

The encoder, per map ``[F, T]`` (AST's ``[T, F]`` input after its
transpose):

* ``Conv2d(1, D, patch, stride=(fstride, tstride))``, its ``f_dim x t_dim``
  outputs flattened frequency-major into tokens;
* a ``[CLS]`` and a distillation token before them, plus a learned position
  embedding of ``f_dim * t_dim + 2`` tokens;
* ``depth`` pre-LN blocks, ``x + Attn(LN(x))`` then ``x + MLP(LN(x))``:
  ``num_heads`` heads, ``qkv`` with a bias, ``softmax(q k^T / sqrt(dh)) v``
  written out, the exact GELU, LayerNorm eps ``ln_eps``;
* the final LayerNorm, ``(x[:, 0] + x[:, 1]) / 2``, then ``mlp_head``:
  LayerNorm (eps 1e-5, torch's default) and ``Linear(D, out_dim)``.

Departures from ``ASTModel``: timm's unused classifier heads (``v.head``,
``v.head_dist``) are not made; no dropout or drop-path (AST's defaults are
0); weights are random from a seed (``param_specs``), not the ImageNet or
AudioSet checkpoints; ``label_dim`` is ``out_dim``, the features the view
fusion takes.

Everything computes in float32 with TF32 off (the caller's ``tf32_off``).
``precision="float8"`` rounds where the configuration's bfloat16 would:
each linear's and the patch embedding's operands and outputs, the attention
products' operands (``reference/model.py::quantizer``).

Training (``train_steps``): AST mixes no maps (it has no BatchNorm), so a
map's features depend on that map alone. Each step takes every map's
features without a graph, in chunks of ``chunk`` maps, then the loss and
its gradient with respect to the features and to the fusion and projection,
then runs each chunk's forward again and its backward against that
gradient: the gradients are the whole step's, exactly, in a fraction of the
memory.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref

Weights = Dict[str, torch.Tensor]
HEAD_LN_EPS = 1e-5  # mlp_head's nn.LayerNorm default
CHUNK = 16  # maps a reference pass takes at a time


@contextmanager
def tf32_off():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def grid(model: dict, feat_shape: Sequence[int]) -> Tuple[int, int]:
    a = model["AST"]
    f, t = feat_shape
    return (f - a["patch"]) // a["fstride"] + 1, (t - a["patch"]) // a["tstride"] + 1


def param_specs(model: dict, feat_shape: Sequence[int], views: int) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """``(name, shape, offset, scale)`` of every tensor, in order, as
    ``reference/model.py::param_specs`` gives them: ``offset + scale * u``,
    u uniform on [-1, 1]. Linears and the patch embedding take the bound
    ``1/sqrt(fan_in)``, norms weights near 1 and biases near 0, the tokens
    and the position embedding ``0.02``."""
    a, att, proj = model["AST"], model["Attention"], model["Projection"]
    d, hid = a["embed_dim"], a["mlp_dim"]
    f_dim, t_dim = grid(model, feat_shape)
    specs: List[Tuple[str, Tuple[int, ...], float, float]] = []

    def linear(name, fan_out, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        specs.append((f"{name}.weight", (fan_out, fan_in), 0.0, b))
        specs.append((f"{name}.bias", (fan_out,), 0.0, b))

    def norm(name, width):
        specs.append((f"{name}.weight", (width,), 1.0, 0.1))
        specs.append((f"{name}.bias", (width,), 0.0, 0.1))

    v = "backbone.encoder.v"
    p = a["patch"]
    specs.append((f"{v}.patch_embed.proj.weight", (d, 1, p, p), 0.0, 1.0 / p))
    specs.append((f"{v}.patch_embed.proj.bias", (d,), 0.0, 1.0 / p))
    specs.append((f"{v}.cls_token", (1, 1, d), 0.0, 0.02))
    specs.append((f"{v}.dist_token", (1, 1, d), 0.0, 0.02))
    specs.append((f"{v}.pos_embed", (1, f_dim * t_dim + 2, d), 0.0, 0.02))
    for i in range(a["depth"]):
        b = f"{v}.blocks.{i}"
        norm(f"{b}.norm1", d)
        linear(f"{b}.attn.qkv", 3 * d, d)
        linear(f"{b}.attn.proj", d, d)
        norm(f"{b}.norm2", d)
        linear(f"{b}.mlp.fc1", hid, d)
        linear(f"{b}.mlp.fc2", d, hid)
    norm(f"{v}.norm", d)
    norm("backbone.encoder.mlp_head.0", d)
    linear("backbone.encoder.mlp_head.1", a["out_dim"], d)
    # the view fusion and the projection, as reference/model.py makes them
    e, ffn = att["embed_dim"], att["ffn_dim"]
    at = "attention_model.encoder_layer"
    specs.append((f"{at}.self_attn.in_proj_weight", (3 * e, e), 0.0, math.sqrt(6.0 / (4 * e))))
    specs.append((f"{at}.self_attn.in_proj_bias", (3 * e,), 0.0, 1.0 / math.sqrt(e)))
    linear(f"{at}.self_attn.out_proj", e, e)
    linear(f"{at}.linear1", ffn, e)
    linear(f"{at}.linear2", e, ffn)
    norm(f"{at}.norm1", e)
    norm(f"{at}.norm2", e)
    linear("projection_head.fc1", proj["hidden_dim"], views * e)
    linear("projection_head.fc2", proj["output_dim"], proj["hidden_dim"])
    norm("projection_head.ln1", proj["hidden_dim"])  # defined by the published model, never applied
    norm("projection_head.ln2", proj["output_dim"])
    return specs


def _layer_norm(x: torch.Tensor, w: Weights, name: str, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"] + w[f"{name}.bias"]


def encode(x: torch.Tensor, w: Weights, model: dict, precision: str = "float32") -> torch.Tensor:
    """Spectrograms ``[B, F, T]`` -> features ``[B, out_dim]``."""
    q = ref.quantizer(precision)
    a = model["AST"]
    d, heads, eps = a["embed_dim"], a["num_heads"], a["ln_eps"]
    dh = d // heads
    v = "backbone.encoder.v"

    def linear(h, name):
        return q(q(h) @ q(w[f"{name}.weight"]).t() + q(w[f"{name}.bias"]))

    pw, pb = w[f"{v}.patch_embed.proj.weight"], w[f"{v}.patch_embed.proj.bias"]
    h = q(F.conv2d(q(x[:, None].to(torch.float32)), q(pw), q(pb), stride=(a["fstride"], a["tstride"])))
    b = h.shape[0]
    tokens = h.flatten(2).transpose(1, 2)  # [B, f_dim * t_dim, D], frequency-major
    lead = torch.cat([w[f"{v}.cls_token"], w[f"{v}.dist_token"]], dim=1).expand(b, 2, d)
    h = torch.cat([lead, tokens], dim=1) + w[f"{v}.pos_embed"]
    n = h.shape[1]
    for i in range(a["depth"]):
        blk = f"{v}.blocks.{i}"
        qkv = linear(_layer_norm(h, w, f"{blk}.norm1", eps), f"{blk}.attn.qkv")
        qh, kh, vh = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        attn = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(dh), dim=-1)
        ctx = (q(attn) @ q(vh)).transpose(1, 2).reshape(b, n, d)
        h = h + linear(ctx, f"{blk}.attn.proj")
        hidden = F.gelu(linear(_layer_norm(h, w, f"{blk}.norm2", eps), f"{blk}.mlp.fc1"))
        h = h + linear(hidden, f"{blk}.mlp.fc2")
    h = _layer_norm(h, w, f"{v}.norm", eps)
    pooled = (h[:, 0] + h[:, 1]) / 2
    head = "backbone.encoder.mlp_head"
    y = _layer_norm(pooled, w, f"{head}.0", HEAD_LN_EPS)
    return y @ w[f"{head}.1.weight"].t() + w[f"{head}.1.bias"]


def encode_chunks(x: torch.Tensor, w: Weights, model: dict, precision: str, chunk: int = CHUNK) -> torch.Tensor:
    """``encode`` of ``[B, F, T]`` in chunks of ``chunk`` maps, without a graph."""
    with torch.no_grad():
        return torch.cat([encode(x[i: i + chunk], w, model, precision) for i in range(0, x.shape[0], chunk)])


def _fuse(feats: torch.Tensor, e: int, s: int, qn: int, v: int, w: Weights, model: dict,
          gen: Optional[torch.Generator]):
    """Features ``[E*(S+Q)*V, D]`` (support then queries, item-major) ->
    fused support ``[E, S, V*D]``, queries ``[E, Q, V*D]`` and the queries'
    per-view features ``[E, Q, V, D]``."""
    d = feats.shape[-1]
    sup_f = feats[: e * s * v].reshape(e, s, v, d)
    qry_f = feats[e * s * v:].reshape(e, qn, v, d)
    att = model["Attention"]
    fused = ref.attend(torch.cat([sup_f, qry_f], dim=1).reshape(-1, v, d), w, att["num_heads"], att["dropout"],
                       gen).reshape(e, s + qn, v * d)
    return fused[:, :s], fused[:, s:], qry_f


def eval_scores(sup_views: torch.Tensor, qry_views: torch.Tensor, support_labels: torch.Tensor, n_way: int,
                w: Weights, model: dict, precision: str = "float32") -> torch.Tensor:
    """Eval-mode scores ``[E, Q, N]`` of view batches ``[E, S|Q, V, F, T]``."""
    e, s, v = sup_views.shape[:3]
    flat = torch.cat([sup_views.reshape(-1, *sup_views.shape[-2:]), qry_views.reshape(-1, *qry_views.shape[-2:])])
    with tf32_off():
        sup, qry, _ = _fuse(encode_chunks(flat, w, model, precision), e, s, qry_views.shape[1], v, w, model, None)
        return ref.neg_distances(qry, ref.prototypes(sup, support_labels, n_way))


def episode_views(episode: dict, exp: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    mv = float(exp["specaug_params"]["mask_value"])
    return (ref.views(episode["support"], *episode["sup_draws"], mv),
            ref.views(episode["query"], *episode["qry_draws"], mv))


def head_loss(feats: torch.Tensor, episode: dict, shape: Tuple[int, int, int, int], w: Weights, exp: dict,
              model: dict, gen: torch.Generator) -> torch.Tensor:
    """``reference/model.py::train_loss`` from the encoder's features on:
    the fusion, FSL and ``l_param`` x CPL over projected prototypes, with the
    dropout masks from ``gen`` in the model's order."""
    e, s, qn, v = shape
    sup, qry, qry_f = _fuse(feats, e, s, qn, v, w, model, gen)
    protos = ref.prototypes(sup, episode["support_labels"], exp["n_way_train"])
    labels = episode["query_labels"]
    fsl = -torch.log_softmax(ref.neg_distances(qry, protos), dim=-1).gather(-1, labels[..., None]).squeeze(-1).mean(-1)
    d = qry_f.shape[-1]
    order = torch.cat([torch.zeros(e, 1, dtype=torch.long, device=labels.device), episode["perms"]], dim=1)
    shuffled = qry_f.gather(2, order[:, None, :, None].expand(e, qn, v, d))
    att = model["Attention"]
    cpl_in = ref.attend(shuffled.reshape(-1, v, d), w, att["num_heads"], att["dropout"], gen).reshape(e, qn, -1)
    loss = exp["loss"]
    cpl = ref.cpl_loss(ref.project(protos, w), ref.project(cpl_in, w), labels, loss["cpl"]["m_param"],
                       loss["cpl"]["t_param"], episode["gumbel"])
    return (fsl + loss["l_param"] * cpl).mean()


def train_steps(episodes: List[dict], w: Weights, exp: dict, model: dict, dropout_seed: int, steps_per_epoch: int,
                precision: str = "float32", mutate: Optional[Callable[[int, dict], dict]] = None,
                chunk: int = CHUNK) -> dict:
    """Follow the program's first ``len(episodes)`` train steps from weights
    ``w`` (not modified), as ``reference/model.py::train_steps`` does: each
    step's loss, every leaf's first gradient and every leaf's change over
    all the steps. The encoder's part of each gradient is taken chunk by
    chunk against the loss's gradient with respect to its features."""
    device = next(iter(w.values())).device
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    params = {k: t.clone() for k, t in w.items()}
    encoder = [k for k in params if k.startswith("backbone.")]
    head = [k for k in params if k not in encoder]
    opt = ref.Adam()
    losses, first_grads = [], None
    with tf32_off():
        for i, ep in enumerate(episodes):
            if mutate is not None:
                ep = mutate(i, ep)
            sv, qv = episode_views(ep, exp)
            e, s, v = sv.shape[:3]
            flat = torch.cat([sv.reshape(-1, *sv.shape[-2:]), qv.reshape(-1, *qv.shape[-2:])])
            feats = encode_chunks(flat, params, model, precision, chunk).requires_grad_(True)
            leaves = {k: params[k].detach().requires_grad_(True) for k in head}
            loss = head_loss(feats, ep, (e, s, qv.shape[1], v), {**params, **leaves}, exp, model, gen)
            g = torch.autograd.grad(loss, [feats] + [leaves[k] for k in head], allow_unused=True)
            grads = {k: t for k, t in zip(head, g[1:]) if t is not None}
            enc = {k: params[k].detach().requires_grad_(True) for k in encoder}
            acc = {k: torch.zeros_like(t) for k, t in enc.items()}
            for j in range(0, flat.shape[0], chunk):
                out = encode(flat[j: j + chunk], {**params, **enc}, model, precision)
                for k, t in zip(encoder, torch.autograd.grad(out, [enc[k] for k in encoder], g[0][j: j + chunk])):
                    acc[k] += t
            grads.update(acc)
            if first_grads is None:
                first_grads = {k: t.detach().clone() for k, t in grads.items()}
            opt.step(params, grads, ref.scheduled_lr(i, exp, steps_per_epoch))
            losses.append(float(loss.detach()))
    return dict(losses=losses, first_grads=first_grads, change={k: params[k] - w[k] for k in first_grads})
