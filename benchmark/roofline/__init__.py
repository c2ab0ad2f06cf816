"""The yardstick: the card's peaks, and the operations and bytes of each
step and kernel reckoned from shapes alone, whatever implements them.

FLOPs count what a matmul or convolution computes (2 per multiply-add),
forward and backward, as ``torch.utils.flop_counter.FlopCounterMode``
counts them; elementwise work (BatchNorm, pooling, activations, softmax,
the optimizer) counts 0. A kernel's bytes are each input read once and each
output written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989.4e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BLOCKS = 4


def conv_maps(feat_shape: Sequence[int], pool: Sequence[int]) -> list:
    """``(H, W)`` at the input of each conv block."""
    f, t = feat_shape
    out = []
    for _ in range(BLOCKS):
        out.append((f, t))
        f, t = f // pool[0], t // pool[1]
    return out


def conv_out(feat_shape: Sequence[int], pool: Sequence[int]) -> Tuple[int, int]:
    f, t = conv_maps(feat_shape, pool)[-1]
    return f // pool[0], t // pool[1]


def conv_block_flops(feat_shape, channels: int, pool, in_channels: int = 1) -> list:
    """Forward FLOPs of each 3x3 conv block on one map."""
    return [2 * (in_channels if i == 0 else channels) * channels * 9 * h * w
            for i, (h, w) in enumerate(conv_maps(feat_shape, pool))]


def encoder_forward_flops(maps: int, model: dict, feat_shape) -> int:
    """The Hybrid encoder's forward on ``maps`` spectrograms: the conv stack,
    the RNN (T' steps of F'*C features) and the head's Linear."""
    hyb = model["Hybrid"]
    c, pool = hyb["hidden_channels"], hyb["pool_dim"]
    fp, tp = conv_out(feat_shape, pool)
    hidden = fp * c
    conv = sum(conv_block_flops(feat_shape, c, pool, hyb["in_channels"]))
    rnn = 2 * tp * hidden * (hidden + hidden)
    head = 2 * hidden * hyb["out_dim"]
    return maps * (conv + rnn + head)


def attention_forward_flops(sequences: int, views: int, model: dict) -> int:
    """The transformer layer over ``sequences`` of ``views`` tokens: the
    four projections and the two attention products."""
    att = model["Attention"]
    d, ffn = att["embed_dim"], att["ffn_dim"]
    per_token = 2 * d * 3 * d + 2 * d * d + 2 * 2 * d * ffn + 2 * 2 * views * d
    return sequences * views * per_token


def head_forward_flops(n_way: int, support: int, queries: int, d: int) -> int:
    """Prototypes (a one-hot matmul) and the distances in matmul form."""
    return 2 * n_way * support * d + 2 * queries * n_way * d


def eval_forward_flops(model: dict, feat_shape, views: int, support: int, query_rows: int, n_way: int) -> int:
    """One eval episode's forward: every view of every support and query row
    through the encoder, the attention over each row's views, the head."""
    maps = (support + query_rows) * views
    d = views * model["Attention"]["embed_dim"]
    return (encoder_forward_flops(maps, model, feat_shape) + attention_forward_flops(support + query_rows, views, model)
            + head_forward_flops(n_way, support, query_rows, d))


def train_step_flops(model: dict, feat_shape, views: int, support: int, queries: int, n_way: int) -> int:
    """One train episode, forward and backward: the encoder over every view,
    the attention over each item's views and again over the queries'
    shuffled views (CPL), the projection of the queries' CPL features and
    of the prototypes, the head and the losses. A backward is twice its
    forward, less the first conv block's input gradient and the RNN's
    gradient through its zero initial state."""
    hyb = model["Hybrid"]
    c, pool = hyb["hidden_channels"], hyb["pool_dim"]
    fp, tp = conv_out(feat_shape, pool)
    hidden = fp * c
    maps = (support + queries) * views
    blocks = conv_block_flops(feat_shape, c, pool, hyb["in_channels"])
    conv = maps * (3 * sum(blocks) - blocks[0])
    rnn = maps * (2 * tp * hidden * 2 * hidden + 2 * tp * hidden * (2 * hidden + hidden)
                  + 2 * (tp - 1) * hidden * hidden)
    head = 3 * maps * 2 * hidden * hyb["out_dim"]
    attention = 3 * attention_forward_flops(support + queries + queries, views, model)
    proj = model["Projection"]
    width = views * model["Attention"]["embed_dim"]
    projection = 3 * (queries + n_way) * (2 * width * proj["hidden_dim"] + 2 * proj["hidden_dim"] * proj["output_dim"])
    losses = 4 * head_forward_flops(n_way, support, queries, width)
    return conv + rnn + head + attention + projection + losses


def k1_bytes(episodes: int, items: int, f: int, t: int, elem: int = 4) -> int:
    """SpecAugment's four views of ``[E, B, F, T]``: the input read once, the
    four views written once, the warp positions (float32) and the two masks
    (a byte an entry) read once."""
    return episodes * items * f * t * elem * (1 + 4) + episodes * items * t * 4 + episodes * (t + f)


def k2_cost(episodes: int, support: int, queries: int, d: int, n_way: int) -> Tuple[int, int]:
    """The fused episode head on float32 features: ``(bytes, flops)``. Bytes:
    support and query features, the labels (int32) read once, the scores
    written once; FLOPs: the class sums and the distances."""
    nbytes = 4 * episodes * (support * d + queries * d + queries * n_way + support)
    flops = episodes * (support * d + 3 * queries * n_way * d)
    return nbytes, flops


def bound_seconds(nbytes: float, flops: float = 0.0, peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time the card could take: the larger of the bytes over its
    bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)
