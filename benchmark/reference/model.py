"""Plain PyTorch reference of the prototypical network the benchmark's
configurations run, written from the published model and owing nothing to
the program: it imports no module of the port or of the JAX package.

The model (magcil/audio-few-shot-learning, ``models/main_modules.py`` and
the configs' ``Hybrid``, ``Attention`` and ``Projection`` blocks):

* four conv blocks, each a 3x3 convolution (padding 1), BatchNorm, a
  floor-mode max-pool and ReLU; train mode normalizes with the batch's
  biased variance, eval mode with the running statistics;
* the Hybrid head: the ``[B, C, F', T']`` map read as ``T'`` steps of
  ``F' * C`` features, a tanh RNN whose output is added to its input, the
  last step, Dropout(0.3), BatchNorm1d and a Linear;
* a post-norm transformer encoder layer over each item's views, the views'
  outputs concatenated;
* prototypes as class means, scores ``-||q - p||``; in training FSL plus
  ``l_param`` x the contrastive prototypical loss over projected features;
  Adam under a multi-step schedule.

Weights are a dict of tensors under the published checkpoint's names
(``param_specs``), made by ``make_weights`` from a seed. Every function
computes in float32; ``precision="float8"`` puts a per-tensor scaled
float8 rounding wherever the configuration's compute dtype would round
(the convolutions' operands and outputs and the activations between them;
e4m3 forward, e5m2 for the gradients flowing back through them): the
benchmark's control, one precision below the configurations' bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
BN_EPS, LN_EPS = 1e-5, 1e-5
BLOCKS = 4


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A per-tensor scaled round trip through ``dtype`` (float8)."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Float8(torch.autograd.Function):
    """Rounds its input to float8 e4m3 and, in the backward pass, the
    gradient to float8 e5m2: the common float8 training recipe."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def quantizer(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Identity for ``"float32"``; for ``"float8"`` a per-tensor scaled round
    trip through float8, e4m3 for values and e5m2 for their gradients."""
    if precision == "float32":
        return lambda x: x
    if precision != "float8":
        raise ValueError(f"unknown precision {precision!r}")
    return _Float8.apply


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def conv_shape(feat_shape: Sequence[int], pool: Sequence[int]) -> Tuple[int, int]:
    f, t = feat_shape
    for _ in range(BLOCKS):
        f, t = f // pool[0], t // pool[1]
    return f, t


def param_specs(model: dict, feat_shape: Sequence[int], views: int) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """``(name, shape, offset, scale)`` of every tensor of the model's
    checkpoint, in order: a tensor is ``offset + scale * u``, u uniform on
    [-1, 1]. Convolutions and linears take the default init's bound
    ``1/sqrt(fan_in)``; norms weights near 1, biases and running means near
    0, running variances in [0.5, 1.5]."""
    hyb, att, proj = model["Hybrid"], model["Attention"], model["Projection"]
    c = hyb["hidden_channels"]
    fp, _ = conv_shape(feat_shape, hyb["pool_dim"])
    hidden = fp * c
    d, ffn = att["embed_dim"], att["ffn_dim"]
    specs: List[Tuple[str, Tuple[int, ...], float, float]] = []

    def linear(name, fan_out, fan_in, bound=None):
        b = 1.0 / math.sqrt(fan_in) if bound is None else bound
        specs.append((f"{name}.weight", (fan_out, fan_in), 0.0, b))
        specs.append((f"{name}.bias", (fan_out,), 0.0, 1.0 / math.sqrt(fan_in)))

    def norm(name, width, running):
        specs.append((f"{name}.weight", (width,), 1.0, 0.1))
        specs.append((f"{name}.bias", (width,), 0.0, 0.1))
        if running:
            specs.append((f"{name}.running_mean", (width,), 0.0, 0.1))
            specs.append((f"{name}.running_var", (width,), 1.0, 0.5))

    enc = "backbone.encoder"
    for i in range(BLOCKS):
        cin = hyb["in_channels"] if i == 0 else c
        specs.append((f"{enc}.conv_encoder.{i}.0.weight", (c, cin, 3, 3), 0.0, 1.0 / math.sqrt(cin * 9)))
        specs.append((f"{enc}.conv_encoder.{i}.0.bias", (c,), 0.0, 1.0 / math.sqrt(cin * 9)))
        norm(f"{enc}.conv_encoder.{i}.1", c, True)
    rb = 1.0 / math.sqrt(hidden)
    for n in ("weight_ih_l0", "weight_hh_l0"):
        specs.append((f"{enc}.seq_layers.{n}", (hidden, hidden), 0.0, rb))
    for n in ("bias_ih_l0", "bias_hh_l0"):
        specs.append((f"{enc}.seq_layers.{n}", (hidden,), 0.0, rb))
    norm(f"{enc}.logits.1", hidden, True)
    linear(f"{enc}.logits.2", hyb["out_dim"], hidden)
    a = "attention_model.encoder_layer"
    specs.append((f"{a}.self_attn.in_proj_weight", (3 * d, d), 0.0, math.sqrt(6.0 / (4 * d))))
    specs.append((f"{a}.self_attn.in_proj_bias", (3 * d,), 0.0, 1.0 / math.sqrt(d)))
    linear(f"{a}.self_attn.out_proj", d, d)
    linear(f"{a}.linear1", ffn, d)
    linear(f"{a}.linear2", d, ffn)
    norm(f"{a}.norm1", d, False)
    norm(f"{a}.norm2", d, False)
    width = views * d
    linear("projection_head.fc1", proj["hidden_dim"], width)
    linear("projection_head.fc2", proj["output_dim"], proj["hidden_dim"])
    norm("projection_head.ln1", proj["hidden_dim"], False)  # defined by the published model, never applied
    norm("projection_head.ln2", proj["output_dim"], False)
    return specs


def make_weights(specs, seed: int, device) -> Weights:
    """Every tensor of ``specs`` in float32 on ``device`` from one uniform
    draw of a generator seeded with ``seed``; BatchNorm counters 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    u = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    out: Weights = {}
    at = 0
    for name, shape, offset, scale in specs:
        n = math.prod(shape)
        out[name] = (u[at: at + n] * scale + offset).reshape(shape)
        at += n
        if name.endswith(".running_var"):
            out[name[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose keep mask is ``rand >= p`` from ``gen``; the
    identity without a generator (eval)."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _batch_norm(x: torch.Tensor, w: Weights, name: str, train: bool) -> torch.Tensor:
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    else:
        mean = w[f"{name}.running_mean"].reshape(shape)
        var = w[f"{name}.running_var"].reshape(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[f"{name}.weight"].reshape(shape) + w[f"{name}.bias"].reshape(shape)


def _layer_norm(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w[f"{name}.weight"] + w[f"{name}.bias"]


def _linear(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    return x @ w[f"{name}.weight"].t() + w[f"{name}.bias"]


def encode(x: torch.Tensor, w: Weights, model: dict, train: bool, gen: Optional[torch.Generator] = None,
           precision: str = "float32") -> torch.Tensor:
    """Spectrograms ``[B, F, T]`` -> embeddings ``[B, out_dim]``. Train mode
    normalizes with the batch's statistics and draws the head's dropout
    mask from ``gen``."""
    q = quantizer(precision)
    hyb = model["Hybrid"]
    pool = tuple(hyb["pool_dim"])
    h = x[:, None].to(torch.float32)
    enc = "backbone.encoder"
    for i in range(BLOCKS):
        cw, cb = w[f"{enc}.conv_encoder.{i}.0.weight"], w[f"{enc}.conv_encoder.{i}.0.bias"]
        h = q(F.conv2d(q(h), q(cw), q(cb), padding=1))
        h = q(_batch_norm(h, w, f"{enc}.conv_encoder.{i}.1", train))
        h = F.relu(F.max_pool2d(h, pool))
    b, c, fp, tp = h.shape
    seq = h.permute(0, 3, 2, 1).reshape(b, tp, fp * c)  # T' steps of (F', C) features
    wih, whh = w[f"{enc}.seq_layers.weight_ih_l0"], w[f"{enc}.seq_layers.weight_hh_l0"]
    bih, bhh = w[f"{enc}.seq_layers.bias_ih_l0"], w[f"{enc}.seq_layers.bias_hh_l0"]
    state = torch.zeros(b, whh.shape[0], device=x.device)
    for t in range(tp):
        state = torch.tanh(seq[:, t] @ wih.t() + bih + state @ whh.t() + bhh)
    last = state + seq[:, -1]  # the last step of output + input
    last = _dropout(last, 0.3, gen if train else None)
    return _linear(_batch_norm(last, w, f"{enc}.logits.1", train), w, f"{enc}.logits.2")


def attend(x: torch.Tensor, w: Weights, heads: int, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Post-norm transformer encoder layer over ``[B, V, D]`` view tokens ->
    ``[B, V*D]``; dropout from ``gen`` in the published order (the attention
    weights, after the attention, after the FFN's ReLU, after the FFN)."""
    a = "attention_model.encoder_layer"
    b, v, d = x.shape
    dh = d // heads
    qkv = x @ w[f"{a}.self_attn.in_proj_weight"].t() + w[f"{a}.self_attn.in_proj_bias"]
    qh, kh, vh = (t.reshape(b, v, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    attn = _dropout(torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dh), dim=-1), p, gen)
    ctx = _linear((attn @ vh).transpose(1, 2).reshape(b, v, d), w, f"{a}.self_attn.out_proj")
    x = _layer_norm(x + _dropout(ctx, p, gen), w, f"{a}.norm1")
    y = _linear(_dropout(F.relu(_linear(x, w, f"{a}.linear1")), p, gen), w, f"{a}.linear2")
    return _layer_norm(x + _dropout(y, p, gen), w, f"{a}.norm2").reshape(b, v * d)


def project(x: torch.Tensor, w: Weights) -> torch.Tensor:
    y = _linear(F.relu(_linear(x, w, "projection_head.fc1")), w, "projection_head.fc2")
    return y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def prototypes(features: torch.Tensor, labels: torch.Tensor, n_way: int) -> torch.Tensor:
    """Class means ``[E, S, D] -> [E, N, D]``."""
    onehot = (labels[..., None] == torch.arange(n_way, device=labels.device)).to(features.dtype)
    return onehot.transpose(-1, -2) @ features / onehot.sum(dim=-2)[..., None]


def neg_distances(queries: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """``-||q - p||``: ``[E, Q, D]``, ``[E, N, D]`` -> ``[E, Q, N]``."""
    diff = queries[:, :, None, :] - protos[:, None, :, :]
    return -torch.sqrt((diff * diff).sum(dim=-1) + 1e-24)


def warp(spec: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Time warp: ``spec [..., F, T]`` sampled along T at the normalized
    positions ``ys [..., T]`` by ``grid_sample`` (bilinear, align_corners,
    zero padding), one row at a time."""
    *lead, f, t = spec.shape
    rows = spec.reshape(-1, 1, 1, t)
    n = rows.shape[0] // f
    x = ys.reshape(n, 1, t).expand(n, f, t).reshape(-1, 1, t)
    grid = torch.stack([x, torch.zeros_like(x)], dim=-1)
    with torch.backends.cudnn.flags(enabled=False):  # cuDNN's sampler refuses batches this large
        out = F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.reshape(spec.shape)


def views(spec: torch.Tensor, ys: torch.Tensor, tmask: torch.Tensor, fmask: torch.Tensor,
          mask_value: float) -> torch.Tensor:
    """SpecAugment's four views ``[E, B, F, T] -> [E, B, 4, F, T]``: the
    original, the time warp, the time-masked and the frequency-masked."""
    tview = torch.where(tmask[:, None, None, :], mask_value, spec)
    fview = torch.where(fmask[:, None, :, None], mask_value, spec)
    return torch.stack([spec, warp(spec, ys), tview, fview], dim=2)


def fused_features(sup_views: torch.Tensor, qry_views: torch.Tensor, w: Weights, model: dict, train: bool,
                   gen: Optional[torch.Generator], precision: str, chunk: int = 0):
    """Encode every view of support ``[E, S, V, F, T]`` and queries, then fuse
    each item's views by attention: ``([E, S, V*D], [E, Q, V*D], [E, Q, V, D])``
    (the last: the queries' per-view embeddings). ``chunk`` (eval only)
    encodes that many maps at a time."""
    e, s, v = sup_views.shape[:3]
    qn = qry_views.shape[1]
    flat = torch.cat([sup_views.reshape(-1, *sup_views.shape[-2:]), qry_views.reshape(-1, *qry_views.shape[-2:])])
    if chunk and not train:
        feats = torch.cat([encode(flat[i: i + chunk], w, model, False, None, precision)
                           for i in range(0, flat.shape[0], chunk)])
    else:
        feats = encode(flat, w, model, train, gen, precision)
    d = feats.shape[-1]
    sup_f = feats[: e * s * v].reshape(e, s, v, d)
    qry_f = feats[e * s * v:].reshape(e, qn, v, d)
    att = model["Attention"]
    fused = attend(torch.cat([sup_f, qry_f], dim=1).reshape(-1, v, d), w, att["num_heads"], att["dropout"],
                   gen if train else None).reshape(e, s + qn, v * d)
    return fused[:, :s], fused[:, s:], qry_f


def eval_scores(sup_views, qry_views, support_labels, n_way: int, w: Weights, model: dict,
                precision: str = "float32", chunk: int = 2048) -> torch.Tensor:
    """Eval-mode scores ``[E, Q, N]`` of view batches ``[E, S|Q, V, F, T]``."""
    sup, qry, _ = fused_features(sup_views, qry_views, w, model, False, None, precision, chunk)
    return neg_distances(qry, prototypes(sup, support_labels, n_way))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def cpl_loss(protos: torch.Tensor, queries: torch.Tensor, labels: torch.Tensor, m: int, t: float,
             gumbel: torch.Tensor) -> torch.Tensor:
    """Contrastive prototypical loss per episode ``[E]``. For query i and
    class c, the M members of c with the largest ``gumbel[i, c, :]`` are
    drawn; the logits are the cosine of i's own prototype with those of the
    other classes and with i itself, over t; the loss is the mean NLL of
    i itself, divided by the number of queries once more."""
    e, n, _ = protos.shape
    b = queries.shape[1]
    ways = torch.arange(n, device=labels.device)
    member = labels[:, None, :] == ways[None, :, None]  # [E, N, B]
    g = torch.where(member[:, None], gumbel, float("-inf"))
    idx = g.topk(m, dim=-1).indices  # [E, B, N, M]
    valid = member[:, None].expand(e, b, n, b).gather(-1, idx)
    own = protos.gather(1, labels[..., None].expand(e, b, protos.shape[-1]))  # [E, B, D]
    ep = torch.arange(e, device=labels.device)[:, None, None, None]
    sampled = queries[ep, idx]  # [E, B, N, M, D]
    cos = lambda a, c: (a * c).sum(-1) / (a.norm(dim=-1) * c.norm(dim=-1)).clamp_min(1e-8)  # noqa: E731
    sims = cos(own[:, :, None, None, :], sampled) / t
    keep = valid & (ways[None, None, :] != labels[..., None])[..., None]
    logits = torch.cat([torch.where(keep, sims, float("-inf")).reshape(e, b, n * m),
                        (cos(own, queries) / t)[..., None]], dim=-1)
    return -(logits[..., -1] - torch.logsumexp(logits, dim=-1)).mean(dim=-1) / b


def train_loss(episode: dict, w: Weights, exp: dict, model: dict, gen: torch.Generator,
               precision: str = "float32") -> torch.Tensor:
    """Mean over the episodes of FSL + ``l_param`` x CPL for one train step.
    ``episode``: ``support``/``query`` ``[E, S|Q, F, T]``, ``support_labels``,
    ``query_labels``, the SpecAugment draws ``sup_draws``/``qry_draws``
    ``(ys, tmask, fmask)``, ``perms [E, V-1]`` and ``gumbel [E, Q, N, Q]``;
    ``gen`` gives the dropout masks in the forward's order."""
    n_way = exp["n_way_train"]
    mv = float(exp["specaug_params"]["mask_value"])
    sv = views(episode["support"], *episode["sup_draws"], mv)
    qv = views(episode["query"], *episode["qry_draws"], mv)
    sup, qry, qry_f = fused_features(sv, qv, w, model, True, gen, precision)
    protos = prototypes(sup, episode["support_labels"], n_way)
    scores = neg_distances(qry, protos)
    labels = episode["query_labels"]
    fsl = -torch.log_softmax(scores, dim=-1).gather(-1, labels[..., None]).squeeze(-1).mean(-1)
    e, qn, v, d = qry_f.shape
    order = torch.cat([torch.zeros(e, 1, dtype=torch.long, device=labels.device), episode["perms"]], dim=1)
    shuffled = qry_f.gather(2, order[:, None, :, None].expand(e, qn, v, d))
    att = model["Attention"]
    cpl_in = attend(shuffled.reshape(-1, v, d), w, att["num_heads"], att["dropout"], gen).reshape(e, qn, -1)
    loss = exp["loss"]
    cpl = cpl_loss(project(protos, w), project(cpl_in, w), labels, loss["cpl"]["m_param"], loss["cpl"]["t_param"],
                   episode["gumbel"])
    return (fsl + loss["l_param"] * cpl).mean()


def scheduled_lr(step: int, exp: dict, steps_per_epoch: int) -> float:
    """Learning rate of update ``step`` (from 0): ``lr`` x gamma once per
    milestone epoch completed."""
    passed = sum(1 for m in set(exp["scheduler_milestones"]) if step >= m * steps_per_epoch)
    return exp["lr"] * exp["scheduler_gamma"] ** passed


class Adam:
    """Adam (betas 0.9, 0.999; eps 1e-8) over the tensors that get a gradient."""

    def __init__(self, betas=(0.9, 0.999), eps: float = 1e-8):
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m: Weights = {}
        self.v: Weights = {}

    def step(self, params: Weights, grads: Weights, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for name, g in grads.items():
                m = self.m.setdefault(name, torch.zeros_like(g)).mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v = self.v.setdefault(name, torch.zeros_like(g)).mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                params[name].sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def train_steps(episodes: List[dict], w: Weights, exp: dict, model: dict, dropout_seed: int, steps_per_epoch: int,
                precision: str = "float32", mutate: Optional[Callable[[int, dict], dict]] = None) -> dict:
    """Follow the program's first ``len(episodes)`` train steps from weights
    ``w`` (not modified): each step's loss, every leaf's first gradient, and
    every leaf's change over all the steps. ``dropout_seed`` seeds the
    generator the dropout masks come from (on the weights' device).
    ``mutate(step, episode)`` plants a fault."""
    device = next(iter(w.values())).device
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    trainable = [k for k in w if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    params = {k: w[k].clone() for k in trainable}
    rest = {k: v for k, v in w.items() if k not in params}
    opt = Adam()
    losses, first_grads = [], None
    for i, ep in enumerate(episodes):
        if mutate is not None:
            ep = mutate(i, ep)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = train_loss(ep, {**leaves, **rest}, exp, model, gen, precision)
        used = [k for k in leaves]
        grads = torch.autograd.grad(loss, [leaves[k] for k in used], allow_unused=True)
        grads = {k: g for k, g in zip(used, grads) if g is not None}
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads, scheduled_lr(i, exp, steps_per_epoch))
        losses.append(float(loss.detach()))
    return dict(losses=losses, first_grads=first_grads,
                change={k: params[k] - w[k] for k in first_grads})
