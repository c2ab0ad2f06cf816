"""The AST encoder's attention kernels' share of their roofline in a train
step, in percent: the two attention products' FLOPs, forward and backward,
reckoned from the shapes (``roofline/ast.py``), at the card's dense bf16
peak, over the device seconds of the fused attention kernels in the traced
stretch. None where the trace holds no such kernel."""

from benchmark.roofline import ast as roofline_ast


def read(record):
    return roofline_ast.share(record, "ast_attention_flops_per_episode", roofline_ast.is_attention)
