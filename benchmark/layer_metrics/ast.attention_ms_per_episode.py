"""Device milliseconds an episode in the AST encoder's fused attention
kernels, forward and backward (``roofline/ast.py::is_attention``: flash,
memory-efficient or cuDNN SDPA by name), over the traced stretch. None
where the trace holds no such kernel."""

from benchmark.roofline import ast as roofline_ast


def read(record):
    seconds = roofline_ast.kernel_seconds(record.get("trace"), roofline_ast.is_attention)
    if not seconds:
        return None
    return 1e3 * seconds / (record["trace"]["units"] * record["episodes_per_unit"])
