"""The AST encoder's GEMMs' share of their roofline in a train step, in
percent: the blocks' and the head's linear FLOPs, forward and backward,
reckoned from the shapes (``roofline/ast.py``), at the card's dense bf16
peak, over the device seconds of the traced stretch's GEMM kernels
(``roofline/ast.py::is_gemm``: cuBLAS by name, neither attention nor
cuDNN's convolutions). None where the trace holds no such kernel."""

from benchmark.roofline import ast as roofline_ast


def read(record):
    return roofline_ast.share(record, "ast_gemm_flops_per_episode", roofline_ast.is_gemm)
