"""The yardstick of an AST configuration's train step, reckoned from shapes
alone as ``roofline/__init__.py`` reckons the Hybrid's: FLOPs of matmuls and
convolutions (2 per multiply-add), forward and backward, as
``torch.utils.flop_counter.FlopCounterMode`` counts them over the written-out
attention; elementwise work counts 0. And the kernels that do each part on
the card, by name: ``trace.FAMILIES`` files GEMMs under ``conv``, so the
AST readers name their own.

Per map of N tokens (``f_dim * t_dim`` patches and 2 prepended), width D,
MLP width M, ``depth`` blocks: the blocks' linears ``2 N (3D^2 + D^2 + 2DM)``
a block and the head's ``2 D out_dim`` (``gemm``); attention's two products
``2 x 2 N^2 D`` a block (``attention``); the patch embedding
``2 (N - 2) D p^2`` (``patch``). A backward is twice its forward, but the
patch embedding's, whose input (the spectrogram) takes no gradient: once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from benchmark import roofline

# kernel names on sm_90 (lower case): PyTorch's flash attention, the
# memory-efficient (CUTLASS fmha) and cuDNN's SDPA kernels, forward and
# backward, with the backward's helpers (cuDNN's ``compute_dot_do_o``,
# ``convert_dq_to_16bits``)
ATTENTION_WORDS = ("flash", "fmha", "sdpa", "dot_do_o", "convert_dq")
# cuBLAS / cuBLASLt GEMMs; cuDNN's convolutions (the patch embedding) are not GEMMs here
GEMM_WORDS = ("gemm", "nvjet")
CONV_WORDS = ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn")


def tokens(model: dict, feat_shape: Sequence[int]) -> int:
    a = model["AST"]
    f, t = feat_shape
    return ((f - a["patch"]) // a["fstride"] + 1) * ((t - a["patch"]) // a["tstride"] + 1) + 2


def encoder_forward_flops(model: dict, feat_shape: Sequence[int]) -> Dict[str, int]:
    """One map through the encoder, forward: ``gemm``, ``attention``, ``patch``."""
    a = model["AST"]
    n, d, m = tokens(model, feat_shape), a["embed_dim"], a["mlp_dim"]
    return dict(gemm=a["depth"] * 2 * n * (4 * d * d + 2 * d * m) + 2 * d * a["out_dim"],
                attention=a["depth"] * 2 * 2 * n * n * d,
                patch=2 * (n - 2) * d * a["patch"] ** 2)


def head_train_flops(model: dict, views: int, support: int, queries: int, n_way: int) -> int:
    """The fusion over each item's views and again over the queries' shuffled
    views (CPL), the projection and the losses, forward and backward, as
    ``roofline.train_step_flops`` counts them."""
    proj = model["Projection"]
    width = views * model["Attention"]["embed_dim"]
    attention = 3 * roofline.attention_forward_flops(support + queries + queries, views, model)
    projection = 3 * (queries + n_way) * (2 * width * proj["hidden_dim"] + 2 * proj["hidden_dim"] * proj["output_dim"])
    return attention + projection + 4 * roofline.head_forward_flops(n_way, support, queries, width)


def train_step_flops(model: dict, feat_shape: Sequence[int], views: int, support: int, queries: int,
                     n_way: int) -> Dict[str, int]:
    """One train episode, forward and backward: ``total``, and the encoder's
    ``attention`` and ``gemm`` parts."""
    maps = (support + queries) * views
    enc = encoder_forward_flops(model, feat_shape)
    out = dict(attention=3 * maps * enc["attention"], gemm=3 * maps * enc["gemm"])
    out["total"] = out["attention"] + out["gemm"] + 2 * maps * enc["patch"] + head_train_flops(
        model, views, support, queries, n_way)
    return out


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in ATTENTION_WORDS)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return (any(w in low for w in GEMM_WORDS) and not is_attention(name)
            and not any(w in low for w in CONV_WORDS))


def kernel_seconds(trace: Optional[dict], pick) -> float:
    """Device seconds of the traced kernels whose name ``pick`` takes; 0.0
    without a device trace."""
    if not trace or not trace.get("kernels"):
        return 0.0
    return sum(s for name, s in trace["kernels"].items() if pick(name))


def share(record: dict, flops_key: str, pick) -> Optional[float]:
    """The traced units' ``flops_key`` FLOPs at the bf16 peak over the
    seconds of the kernels ``pick`` takes, in percent; None where the record
    has no such FLOPs or the trace no such kernels."""
    trace = record.get("trace")
    seconds = kernel_seconds(trace, pick)
    if flops_key not in record or not seconds:
        return None
    episodes = trace["units"] * record["episodes_per_unit"]
    return 100.0 * record[flops_key] * episodes / record["peak_flops"] / seconds
